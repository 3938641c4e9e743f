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
// weights arrive as `bits` binary planes [bits, K, n_lut] (int8 0/1) and
// a channel accumulates sum_b s_b * (x . plane_b), s_b = 2^b with the MSB
// plane weighted -2^(bits-1) (Eq. 1), one partial sum per plane. Channels
// c >= n_lut are the DSP core's: int4 codes packed two to a byte
// [K, ceil(n_dsp / 2)], even column in the low nibble. Either side may be
// empty. Both sides accumulate exactly in int32 (|x| <= 128, |w| <= 128,
// K <= 32 taps); the epilogue converts to fp32 and multiplies by the
// channel's scale, the same two IEEE operations as the plain version, so
// every output is bitwise equal to it.
//
// What bounds it on an H100. K = 9 taps for mobilenet_v2's 3x3 layers:
// 18 operations per output against 4 bytes of fp32 output and about one
// byte of input, so the bound is bytes. A full-width image's 17 layers
// move ~13 MB (inputs, outputs, weights): ~3.9 us at 3.35 TB/s, spread
// over 17 launches, so a launch costs more than its bytes. Tensor cores
// would buy nothing at K = 9.
//
// Design. One thread per (channel, output pixel), a block of 32 channels
// x 8 pixel rows, each thread walking `rows` pixels 8 apart:
//   * channels fastest: the 32 lanes of a warp read 32 consecutive input
//     bytes per tap and write 128 consecutive output bytes;
//   * a channel's weights stay in registers for all its pixels: a LUT
//     channel keeps one K-bit mask per plane, a DSP channel its K codes
//     as nibbles, 8 to a word;
//   * a pixel's taps are loaded into registers before any is used, and
//     for K = 9 (3x3, every depthwise layer of mobilenet_v2) the tap
//     count is a template constant, so the 9 loads issue together; a
//     first version read them one after another in a loop bounded at run
//     time, and each layer then took the sum of 9 load latencies per
//     pixel (0.252 ms per full-width image against 0.120 for
//     F.conv2d(groups=C); this version 0.096);
//   * the spatial form computes each pixel's window origin once and
//     tests each tap against the image;
//   * the C entry point sizes the grid at ~528 blocks, four for each
//     SM: `rows` grows with M / (8 x channel tiles), up to 16.
//
// Resources and times (chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W): ptxas gives 38-114 registers over the four instantiations, no
// spills, no shared memory; a launch takes 4.1-10 us at mobilenet_v2's
// 17 depthwise layers, against bytes bounds of 0.1-0.7 us.
//
// Launches go on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;        // channels of a block (one warp's lanes)
constexpr int TR = 8;         // pixel rows of a block (warps)
constexpr int MAX_K = 32;     // taps a channel's registers hold
constexpr int MAX_ROWS = 16;  // pixels a thread walks
constexpr int TARGET_BLOCKS = 528;

struct Params {
  const int8_t* x;       // spatial: [H, W, C]; staged: [M, K, N]
  const int8_t* planes;  // [bits, K, n_lut] in {0, 1}
  const int8_t* packed;  // [K, ceil(n_dsp / 2)] int4 pairs
  const float* scale;    // [N]
  float* out;            // [M, N]
  int M, K, N;
  int bits, n_lut, n_dsp;
  int rows;              // pixels a thread walks
  int H, W, ksize, stride, pad, out_hw;  // spatial form (C == N)
};

// KT > 0: K == KT taps known at compile time (3x3: KT = 9), every tap
// loop fully unrolled, so a pixel's KT input loads issue together rather
// than one after another; KT == 0: any K <= MAX_K, read from p.K.
template <bool SPATIAL, int KT>
__global__ void __launch_bounds__(TC* TR) depthwise_kernel(const Params p) {
  constexpr int KMAX = KT ? KT : MAX_K;
  const int K = KT ? KT : p.K;
  const int ks = KT == 9 ? 3 : p.ksize;
  const int c = blockIdx.x * TC + threadIdx.x;
  if (c >= p.N) return;
  const bool lut = c < p.n_lut;

  // the channel's weights: LUT, bit k of w[b] is plane b's tap k; DSP,
  // nibble k % 8 of w[k / 8] is tap k's code. Loops over the register
  // arrays are unrolled so that every index is a constant and the arrays
  // stay in registers.
  uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (lut) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b >= p.bits) break;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!KT && k >= K) break;
        w[b] |= (uint32_t)(p.planes[((size_t)b * K + k) * p.n_lut + c] & 1) << k;
      }
    }
  } else {
    const int j = c - p.n_lut, ld = (p.n_dsp + 1) / 2;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (!KT && k >= K) break;
      const uint32_t byte = (uint8_t)p.packed[(size_t)k * ld + j / 2];
      w[k / 8] |= ((j & 1 ? byte >> 4 : byte) & 0xFu) << (4 * (k % 8));
    }
  }
  const float s = p.scale[c];

  const int m0 = blockIdx.y * (TR * p.rows) + threadIdx.y;
  for (int r = 0; r < p.rows; ++r) {
    const int m = m0 + r * TR;
    if (m >= p.M) break;
    // the pixel's taps, all loads issued before any is used
    int v[KMAX];
    if constexpr (SPATIAL) {
      const int oh = m / p.out_hw, ow = m - oh * p.out_hw;
      const int ih0 = oh * p.stride - p.pad, iw0 = ow * p.stride - p.pad;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!KT && k >= K) break;
        const int ih = ih0 + k / ks, iw = iw0 + k % ks;  // (kh, kw) order
        v[k] = (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W
                   ? p.x[((size_t)ih * p.W + iw) * p.N + c]
                   : 0;
      }
    } else {
      const int8_t* xm = p.x + (size_t)m * K * p.N + c;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!KT && k >= K) break;
        v[k] = xm[(size_t)k * p.N];
      }
    }
    int acc = 0;
    if (lut) {  // sum_b s_b * (x . plane_b), the MSB plane negative
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (b >= p.bits) break;
        int part = 0;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (!KT && k >= K) break;
          if ((w[b] >> k) & 1u) part += v[k];
        }
        acc += (b == p.bits - 1 ? -(1 << b) : (1 << b)) * part;
      }
    } else {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (!KT && k >= K) break;
        acc += v[k] * ((int)(w[k / 8] << (28 - 4 * (k % 8))) >> 28);  // sign-extended
      }
    }
    p.out[(size_t)m * p.N + c] = __int2float_rn(acc) * s;
  }
}

template <bool SPATIAL>
int launch(Params p, void* stream) {
  if (p.N <= 0 || p.n_lut < 0 || p.n_dsp < 0 || p.n_lut + p.n_dsp != p.N ||
      p.K <= 0 || p.K > MAX_K || (p.n_lut && (p.bits < 1 || p.bits > 8)))
    return (int)cudaErrorInvalidValue;
  if (p.M == 0) return (int)cudaSuccess;
  const int ctiles = (p.N + TC - 1) / TC;
  const int groups = (p.M + TR - 1) / TR;  // pixel groups at one row a thread
  const long long per = (long long)ctiles * groups / TARGET_BLOCKS;
  p.rows = (int)(per < 1 ? 1 : per > MAX_ROWS ? MAX_ROWS : per);
  const dim3 grid(ctiles, (p.M + TR * p.rows - 1) / (TR * p.rows), 1);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool k9 = p.K == 9 && (!SPATIAL || p.ksize == 3);
  if (k9)
    depthwise_kernel<SPATIAL, 9><<<grid, dim3(TC, TR, 1), 0, s>>>(p);
  else
    depthwise_kernel<SPATIAL, 0><<<grid, dim3(TC, TR, 1), 0, s>>>(p);
  return (int)cudaGetLastError();
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
  p.ksize = ksize;
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
