// Depthwise (grouped) split contraction of the N3H-Core heterogeneous
// layer (paper Eq. 12) for Hopper (sm_90a).
//
// Two C entry points, one kernel with two ways of addressing its input:
//
//   depthwise_conv_gemm  the spatial form: the unpadded NHWC int8 block
//                        [H, W, C]; the kernel gathers each output
//                        pixel's kh x kw taps itself and reads a tap
//                        outside the image as 0 (the padding), so no
//                        im2col stack is staged.
//   grouped_gemm         the staged form: a [M, K, N] int8 stack, one
//                        im2col slice per channel (the staged path and
//                        the per-partition path).
//
// What it replaces. The reference has no Pallas kernel for this
// contraction: repro/kernels/ops.py:256 fused_grouped_matmul (and :274
// fused_depthwise_matmul, :93 / :108 on one side) runs it as an exact
// int32 einsum on every backend (oracle repro/kernels/ref.py:193
// fused_hetero_grouped_gemm_ref). On the card it needs a kernel of its
// own: torch's CUDA matmul and einsum have no int32 path.
//
// What it computes. out[m, c] = (sum_k x[m, k, c] * w[k, c]) * scale[c],
// fp32 [M, N] in split order. Channels c < n_lut are the LUT core's: the
// weights arrive as `bits` binary planes [bits, K, n_lut] (int8 0/1),
// and the plain version accumulates sum_b s_b * (x . plane_b), s_b = 2^b
// with the MSB plane weighted -2^(bits-1) (Eq. 1). Channels c >= n_lut
// are the DSP core's: int4 codes packed two to a byte [K, ceil(n_dsp /
// 2)], even column in the low nibble. Either side may be empty.
//
// The kernel folds a LUT channel's planes into its signed taps, w_k =
// sum_b s_b * plane_b[k] in [-2^(bits-1), 2^(bits-1) - 1], and then runs
// one sum of K integer products on both sides. That is the plain
// version's sum, bit for bit: every term is an integer, |sum| <= 32 taps
// x 128 x 128 < 2^31, and integer addition is associative. The epilogue
// converts to fp32 and multiplies by the channel's scale, the same two
// IEEE operations as the plain version, so every output is bitwise equal
// to it.
//
// What bounds it on an H100. K = 9 taps for mobilenet_v2's 3x3 layers:
// 18 operations per output against 4 bytes of fp32 output and about one
// byte of input, so the bound is bytes. A full-width image's 17 layers
// move ~13 MB (inputs, outputs, weights): ~3.9 us at 3.35 TB/s, spread
// over 17 launches of 0.1-0.7 us each, so a launch's fixed cost (the
// `empty` variant of kernel_parts.py) and one trip to memory are what a
// layer can approach.
//
// Design. The layers are latency-bound: a full-width layer takes 2.8-4.1
// us, 0.9-1.8 above a 1.9-2.4 us launch floor, and each trip to memory
// on a thread's chain costs ~0.3 us. So the design keeps one trip on the chain and
// many threads in flight:
//   * a thread owns V = 4 consecutive channels (1 where C is not a
//     multiple of 4, a pointer not aligned, or the map has fewer than 4
//     pixels) and loads one 4-byte word a tap, storing one float4 a
//     pixel. Threads of 8 and 16 channels (wider loads, fewer threads)
//     were 0-1.3 us a layer slower at every full-width layer (the
//     variants `v8` and `v4`, PERF.md §6);
//   * the weights once a block: the block folds its channels' taps into
//     shared memory, a byte a (tap, channel), a task a tap of 4 channels
//     (one 32-bit load a plane row, folded in SIMD; a task a channel
//     where C or n_lut is not a multiple of 4), a short chain spread over
//     the block's threads; after the barrier each thread reads its
//     channels' taps and transposes them into its weight words, one a
//     (channel, column of the window, group of 4 rows);
//   * the products by __dp4a: a loaded column of the window (3 rows x 4
//     channels) is transposed by byte permutes into one word a channel
//     (its 3 vertical taps), and one dp4a against the channel's weight
//     word adds 3 products; LUT and DSP channels run the same code (no
//     divergence at the split boundary, which may fall inside a vector);
//   * no input reuse across a thread's pixels: a thread computes one
//     pixel, and the threads of neighbouring pixels, adjacent in the
//     block, share their windows' lines through L1 (kernel_parts.py's
//     `no_reuse` loads past it). Runs of 2-4 output columns a thread,
//     each input column loaded and transposed once for every output
//     whose window holds it, were no faster (56.34 us an image without
//     them, 56.60 with them, on an H100 80GB HBM3 at 700 W), so they
//     went;
//   * every input and scale load of a thread is issued before the block
//     decodes its weights, so that the two trips to memory overlap;
//   * the grid: a block of tv channel vectors (x, fastest: the loads of
//     adjacent lanes are adjacent) x tw pixels of an output row (y) x th
//     output rows (z), so that a thread finds its channels and pixel
//     without a division; tv a divisor of the vector count (no idle
//     lane at the channel edge), tw x th up to TILE_PIX pixels so that
//     the weights a block decodes serve many pixels, up to 128 threads,
//     falling to 32 until the grid has SLOTS (132, one an SM) blocks;
//   * K = 9 (3x3, or a staged stack of 9) is compiled; other kernel
//     sizes (up to 5x5, K up to 32) are read at run time, at V = 4 in
//     the spatial form and V = 1 in the staged one (whose 32 rows at V =
//     4 spilled).
// kernels/depthwise_gemm.py::depthwise_plan mirrors the launch plan.
//
// Times (kernel_parts.py --only depthwise on an NVIDIA H100 80GB HBM3
// at 700 W): 53.5 us a full-width mobilenet_v2 image, its 17 launches
// over a 33.7 us floor (93.0 us in the first design, timed in
// turns); the filter x 2 shards 98.4 us (142.9). PERF.md has each
// layer's time beside the floor and the bound.
//
// Launches go on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;              // taps a channel, at most
constexpr int MAX_KS = 5;              // spatial kernel size, at most
constexpr int VEC = 4;                 // channels a thread, where they fit
constexpr int MAX_THREADS = 128;       // threads a block, at most
constexpr int SLOTS = 132;             // blocks the grid aims at: one an SM
constexpr int TILE_PIX = 32;           // pixels a block, preferred

struct Params {
  const int8_t* x;       // spatial: [H, W, C]; staged: [M, K, N]
  const int8_t* planes;  // [bits, K, n_lut] in {0, 1}
  const int8_t* packed;  // [K, ceil(n_dsp / 2)] int4 pairs
  const float* scale;    // [N]
  float* out;            // [M, N]
  int M, K, N;
  int bits, n_lut, n_dsp;
  int H, W, ks, stride, pad, out_hw;  // spatial form (C == N)
  int nv;                             // channel vectors
};

// channel c's tap k, folded: a LUT channel's sum_b s_b * plane_b[k], a
// DSP channel's sign-extended int4 code
__device__ __forceinline__ int tap1(const Params& p, int k, int c) {
  if (c < p.n_lut) {
    const int8_t* q = p.planes + (size_t)k * p.n_lut + c;
    const size_t plane = (size_t)p.K * p.n_lut;
    int w = 0;
#pragma unroll 4
    for (int b = 0; b < p.bits; ++b) {
      const int bit = __ldg(q + b * plane) & 1;
      w += (b == p.bits - 1 ? -bit : bit) * (1 << b);
    }
    return w;
  }
  const int j = c - p.n_lut;
  const uint32_t byte = (uint8_t)__ldg(p.packed + (size_t)k * ((p.n_dsp + 1) / 2) + j / 2);
  return (int)(((j & 1 ? byte >> 4 : byte) & 0xFu) ^ 8u) - 8;
}

// tap k of the 4 channels c..c+3 (c a multiple of 4, plane rows 4-byte),
// folded, as the bytes of a word: a LUT group's 4 plane bytes a bit by
// one 32-bit load, folded in SIMD (each byte is 0 or 1, so the shifted
// planes OR together, and the MSB plane's byte times its two's-complement
// weight carries into no other byte); a DSP group's 4 nibbles from two
// bytes, sign-extended in SIMD; a group across the split boundary a
// channel at a time
__device__ __forceinline__ uint32_t tap4(const Params& p, int k, int c) {
  if (c + 4 <= p.n_lut) {
    const int8_t* q = p.planes + (size_t)k * p.n_lut + c;
    const size_t plane = (size_t)p.K * p.n_lut;
    const uint32_t msb = (0xFFu << (p.bits - 1)) & 0xFFu;
    uint32_t w = 0;
#pragma unroll 4
    for (int b = 0; b < p.bits; ++b) {
      const uint32_t pl = __ldg(reinterpret_cast<const unsigned*>(q + b * plane)) & 0x01010101u;
      w |= b == p.bits - 1 ? pl * msb : pl << b;
    }
    return w;
  }
  if (c >= p.n_lut) {
    const uint8_t* r = reinterpret_cast<const uint8_t*>(p.packed) +
                       (size_t)k * ((p.n_dsp + 1) / 2) + (c - p.n_lut) / 2;
    const uint32_t x = __byte_perm(__ldg(r), __ldg(r + 1), 0x4400);  // b0 b0 b1 b1
    const uint32_t y = (x & 0x000F000Fu) | ((x >> 4) & 0x0F000F00u);
    return y | (y & 0x08080808u) * 0x1Eu;
  }
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) w |= (uint32_t)(uint8_t)tap1(p, k, c + j) << (8 * j);
  return w;
}

// t[j], byte i = byte j of a[i]: four words of 4 channels (one tap each)
// to a word a channel (its 4 taps)
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4], uint32_t* t) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140), t1 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140), t3 = __byte_perm(a[2], a[3], 0x7362);
  t[0] = __byte_perm(t0, t2, 0x5410);
  t[1] = __byte_perm(t0, t2, 0x7632);
  t[2] = __byte_perm(t1, t3, 0x5410);
  t[3] = __byte_perm(t1, t3, 0x7632);
}

// V channels' bytes at p (zeros where !ok) as NQ words of 4 channels;
// V = 1: the byte, zero-extended
template <int V>
__device__ __forceinline__ void load_vec(uint32_t (&w)[V >= 4 ? V / 4 : 1], const int8_t* p,
                                         bool ok) {
  if constexpr (V == 4)
    w[0] = ok ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
  else
    w[0] = ok ? (uint32_t)(uint8_t)__ldg(p) : 0u;
}

// acc += the 4 byte products of x and w (signed)
__device__ __forceinline__ int mac(uint32_t x, uint32_t w, int acc) {
  return __dp4a((int)x, (int)w, acc);
}

// SPATIAL: KT = 3 (3x3, the stride at run time) or 0 (kernel size and
// stride at run time, up to MAX_KS); staged: KT = 9 or 0 (K at run time,
// up to MAX_K). A window "column" is the KH vertical taps of one kw
// (staged: the K taps, one column), in GH words of 4 rows.
template <bool SPATIAL, int KT, int V>
__global__ void __launch_bounds__(MAX_THREADS) depthwise_kernel(const Params p) {
  constexpr int KHM = KT ? KT : (SPATIAL ? MAX_KS : MAX_K);  // rows, at most
  constexpr int KWM = SPATIAL ? KHM : 1;                      // columns, at most
  constexpr int GHM = (KHM + 3) / 4;                          // row groups
  constexpr int NQ = V >= 4 ? V / 4 : 1;                      // words a vector
  extern __shared__ uint4 wb4[];  // [K][tv * V] the block's folded taps
  uint8_t* wb = reinterpret_cast<uint8_t*>(wb4);
  const int KH = KT ? KT : (SPATIAL ? p.ks : p.K), KW = SPATIAL ? KH : 1;
  const int CB = blockDim.x * V;
  // thread (x, y, z): channel vector x of the block's, pixel y of output
  // row z (staged: pixel y)
  const int v = blockIdx.x * blockDim.x + threadIdx.x, c = v * V;
  int m, oh = 0, ow = 0;
  bool active;
  if constexpr (SPATIAL) {
    ow = blockIdx.y * blockDim.y + threadIdx.y;
    oh = blockIdx.z * blockDim.z + threadIdx.z;
    active = v < p.nv && ow < p.out_hw && oh < p.out_hw;
    m = oh * p.out_hw + ow;
  } else {
    m = blockIdx.y * blockDim.y + threadIdx.y;
    active = v < p.nv && m < p.M;
  }

  // the window's columns, loaded before anything else
  uint32_t raw[KWM][KHM][NQ];
  if constexpr (SPATIAL) {
    const int ih0 = oh * p.stride - p.pad, iw0 = ow * p.stride - p.pad;
#pragma unroll
    for (int col = 0; col < KWM; ++col)
#pragma unroll
      for (int kh = 0; kh < KHM; ++kh) {
        const int ih = ih0 + kh, iw = iw0 + col;
        const bool ok = active && (KT || (kh < KH && col < KW)) && (unsigned)ih < (unsigned)p.H &&
                        (unsigned)iw < (unsigned)p.W;
        load_vec<V>(raw[col][kh], p.x + ((size_t)(ok ? ih * p.W + iw : 0) * p.N + (ok ? c : 0)),
                    ok);
      }
  } else {
#pragma unroll
    for (int kh = 0; kh < KHM; ++kh) {
      const bool ok = active && (KT || kh < KH);
      load_vec<V>(raw[0][kh], p.x + (ok ? ((size_t)m * p.K + kh) * p.N + c : 0), ok);
    }
  }

  // and the channels' scales
  float s[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = active ? __ldg(p.scale + c + j) : 0.f;

  // the block's taps, tap-major: byte (k, channel); a task a tap of 4
  // channels where they are vectors and the plane rows 4-byte (else of
  // one), its tap and channels by a float reciprocal, exact here (e <
  // 2^20), not an integer division
  const int c0 = blockIdx.x * CB, bt = blockDim.x * blockDim.y * blockDim.z;
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int K = KH * KW;
  if (V >= 4 && p.n_lut % 4 == 0 && ((uintptr_t)p.planes & 3) == 0) {
    const int G4 = CB / 4;
    const float inv = 1.f / G4;
    for (int e = tid; e < K * G4; e += bt) {
      const int k = (int)((e + 0.5f) * inv), q = e - k * G4;
      *reinterpret_cast<uint32_t*>(wb + k * CB + 4 * q) = tap4(p, k, c0 + 4 * q);
    }
  } else {
    const float inv = 1.f / CB;
    for (int e = tid; e < K * CB; e += bt) {
      const int k = (int)((e + 0.5f) * inv), q = e - k * CB;
      wb[k * CB + q] = c0 + q < p.N ? (uint8_t)tap1(p, k, c0 + q) : 0;
    }
  }
  __syncthreads();
  if (!active) return;

  // the thread's weights: word (kw, g, channel) = taps (4 g + i, kw), i < 4
  uint32_t w[KWM][GHM][V];
  const uint8_t* wc = wb + threadIdx.x * V;
#pragma unroll
  for (int kw = 0; kw < KWM; ++kw)
#pragma unroll
    for (int g = 0; g < GHM; ++g)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kh = 4 * g + i;
          const bool ok = kh < KHM && (KT || (kh < KH && kw < KW));
          const uint8_t* src = wc + (kh * KW + kw) * CB + 4 * q;
          a[i] = !ok ? 0u : V >= 4 ? *reinterpret_cast<const uint32_t*>(src) : *src;
        }
        if constexpr (V >= 4)
          transpose4(a, &w[kw][g][4 * q]);
        else
          w[kw][g][0] = a[0] | a[1] << 8 | a[2] << 16 | a[3] << 24;
      }

  // each column: its taps a channel, then one dp4a a channel and row group
  int acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0;
#pragma unroll
  for (int col = 0; col < KWM; ++col)
#pragma unroll
    for (int g = 0; g < GHM; ++g) {
      uint32_t t[V];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = 4 * g + i < KHM ? raw[col][4 * g + i][q] : 0u;
        if constexpr (V >= 4)
          transpose4(a, t + 4 * q);
        else
          t[0] = a[0] | a[1] << 8 | a[2] << 16 | a[3] << 24;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = mac(t[j], w[col][g][j], acc[j]);
    }

  float* o = p.out + (size_t)m * p.N + c;
  if constexpr (V >= 4) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      reinterpret_cast<float4*>(o)[q] =
          make_float4(__int2float_rn(acc[4 * q]) * s[4 * q],
                      __int2float_rn(acc[4 * q + 1]) * s[4 * q + 1],
                      __int2float_rn(acc[4 * q + 2]) * s[4 * q + 2],
                      __int2float_rn(acc[4 * q + 3]) * s[4 * q + 3]);
  } else {
    o[0] = __int2float_rn(acc[0]) * s[0];
  }
}

// The launch plan (see the header); kernels/depthwise_gemm.py mirrors it:
// a block of tv channel vectors x tw pixels of a row x th output rows
struct Plan {
  int v;
  dim3 block, grid;
  int smem;
};

template <bool SPATIAL>
Plan plan_of(const Params& p) {
  const bool fast = SPATIAL ? p.ks == 3 : p.K == 9;
  const uintptr_t x = (uintptr_t)p.x, out = (uintptr_t)p.out;
  auto fits = [&](int v) { return p.N % v == 0 && x % v == 0 && out % 16 == 0; };
  Plan pl{};
  pl.v = (fast || SPATIAL) && fits(VEC) && VEC <= p.M ? VEC : 1;
  const int nv = p.N / pl.v;
  // pixels a row and rows (staged: the pixels one row)
  const int cols = SPATIAL ? p.out_hw : p.M, rows = SPATIAL ? p.out_hw : 1;
  const int pix = cols * rows;
  for (int bt = MAX_THREADS; bt >= 32; bt /= 2) {
    const int cap = bt / (pix < TILE_PIX ? pix : TILE_PIX);
    int tv = 1;
    for (int d = cap < nv ? cap : nv; d > 1; --d)
      if (nv % d == 0) {
        tv = d;
        break;
      }
    const int tp = bt / tv < pix ? bt / tv : pix;
    const int tw = tp < cols ? tp : cols;
    const int th = tp / tw < rows ? tp / tw : rows;
    pl.block = dim3(tv, tw, th);
    pl.grid = dim3((nv + tv - 1) / tv, (cols + tw - 1) / tw, (rows + th - 1) / th);
    if ((long long)pl.grid.x * pl.grid.y * pl.grid.z >= SLOTS) break;
  }
  const int kh = SPATIAL ? p.ks : p.K, kw = SPATIAL ? p.ks : 1;
  pl.smem = (kh * kw * pl.block.x * pl.v + 15) / 16 * 16;
  return pl;
}

template <bool SPATIAL, int KT, int V>
int go(const Params& p, const Plan& pl, cudaStream_t s) {
  depthwise_kernel<SPATIAL, KT, V><<<pl.grid, pl.block, pl.smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool SPATIAL>
int launch(Params p, void* stream) {
  if (p.N <= 0 || p.n_lut < 0 || p.n_dsp < 0 || p.n_lut + p.n_dsp != p.N || p.K <= 0 ||
      p.K > MAX_K || (p.n_lut && (p.bits < 1 || p.bits > 8)) ||
      (SPATIAL && p.ks > MAX_KS))
    return (int)cudaErrorInvalidValue;
  if (p.M == 0) return (int)cudaSuccess;
  const Plan pl = plan_of<SPATIAL>(p);
  if (pl.grid.y > 65535 || pl.grid.z > 65535) return (int)cudaErrorInvalidValue;
  p.nv = p.N / pl.v;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool fast = SPATIAL ? p.ks == 3 : p.K == 9;
  constexpr int KF = SPATIAL ? 3 : 9;
  if (fast) return pl.v == VEC ? go<SPATIAL, KF, VEC>(p, pl, s) : go<SPATIAL, KF, 1>(p, pl, s);
  if constexpr (SPATIAL)
    if (pl.v == VEC) return go<SPATIAL, 0, VEC>(p, pl, s);
  return go<SPATIAL, 0, 1>(p, pl, s);
}

Params base_params(const void* x, const void* planes, int bits, int n_lut, const void* packed,
                   int n_dsp, const void* scale, void* out) {
  Params p{};
  p.x = (const int8_t*)x;
  p.planes = (const int8_t*)planes;
  p.packed = (const int8_t*)packed;
  p.scale = (const float*)scale;
  p.out = (float*)out;
  p.N = n_lut + n_dsp;
  p.bits = bits;
  p.n_lut = n_lut;
  p.n_dsp = n_dsp;
  return p;
}

}  // namespace

extern "C" {

// x [H, W, C] int8, unpadded, C = n_lut + n_dsp; planes [bits, K,
// n_lut], packed [K, ceil(n_dsp/2)] with K = ksize^2 taps in (kh, kw)
// order; scale [C] fp32 -> out [out_hw^2, C] fp32.
int depthwise_conv_gemm(const void* x, int H, int W, int C, int ksize, int stride, int pad,
                        int out_hw, const void* planes, int bits, int n_lut, const void* packed,
                        int n_dsp, const void* scale, void* out, void* stream) {
  Params p = base_params(x, planes, bits, n_lut, packed, n_dsp, scale, out);
  if (C != p.N || ksize <= 0 || stride <= 0 || out_hw < 0) return (int)cudaErrorInvalidValue;
  p.M = out_hw * out_hw;
  p.K = ksize * ksize;
  p.H = H;
  p.W = W;
  p.ks = ksize;
  p.stride = stride;
  p.pad = pad;
  p.out_hw = out_hw;
  return launch<true>(p, stream);
}

// x [M, K, N] int8 staged, N = n_lut + n_dsp; weights as above -> out
// [M, N] fp32.
int grouped_gemm(const void* x, int M, int K, const void* planes, int bits, int n_lut,
                 const void* packed, int n_dsp, const void* scale, void* out, void* stream) {
  Params p = base_params(x, planes, bits, n_lut, packed, n_dsp, scale, out);
  p.M = M;
  p.K = K;
  return launch<false>(p, stream);
}

}  // extern "C"
