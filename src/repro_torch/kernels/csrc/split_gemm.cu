// Single-path split GEMM kernels of the N3H-Core heterogeneous layer
// (paper Eq. 12) for Hopper (sm_90a): int8 tensor cores with B built in
// registers from bit-packed, K-major weight words, a cp.async pipeline
// and split-K over a thread-block cluster.
//
// One template, two C entry points, one for each TPU kernel of the JAX
// package (both sides of the split in one launch, with and without
// im2col, are fused_split_gemm.cu's):
//
//   bitserial_gemm     replaces repro/kernels/bitserial_gemm.py:62
//                      bitserial_gemm (_bitserial_kernel): LUT side only.
//   int4_gemm          replaces repro/kernels/int4_gemm.py:55 int4_gemm
//                      (_int4_kernel): DSP side only.
//
// What it computes. bitserial_gemm: out[m, n] = (sum_b s_b * (x @
// plane_b))[m, n] * scale[n], s_b = 2^b with the MSB plane weighted
// -2^(bits-1), bits in 1..8. int4_gemm: out[m, n] = (x @ w)[m, n] *
// scale[n] with w int4 codes in [-8, 7]. Both accumulate exactly in
// int32; the epilogue converts to fp32 and multiplies by the per-column
// scale, the same two IEEE operations as the plain version, so every
// output is bitwise equal to it.
//
// The weights come in the port's private K-major layout, made once at
// bind (ops.prepare_split; ref.pack_bits_kmajor / pack_int4_kmajor),
// every row zero-padded to a multiple of 16 bytes:
//   LUT  int32 [bits, N, lut_row_words(K)]: bit k % 32 of word k / 32 of
//        row (b, n) is plane b's bit of weight (k, n);
//   DSP  int32 [N, dsp_row_words(K)]: nibble k % 8 of word k / 8 of row n
//        is the two's-complement code (k, n), lowest nibble first.
// A zero bit or code adds 0 to every plane, so the padding needs no mask.
//
// What bounds it on an H100. At batch 1 resnet18's LUT side reads ~4 MB
// of weights at 1 bit a plane and the DSP side ~1.5 MB at 4 bits, plus
// the activations (2.2 MB) and the fp32 output: a few us a side at
// 3.35 TB/s; the integer product is ~1.8 G ops a side, ~1 us at the
// 1,979 TOP/s int8 peak. So the floor is set by bytes; at M = 49 or 196
// (10 of the 21 layers) the card fills only by splitting K.
//
// Design.
//   * Tiles and split-K over a cluster, as fused_split_gemm.cu. A block
//     of 256 threads (8 warps) owns a BM x BN output tile, BM in {16, 64},
//     BN in {32, 64}; up to 8 warps run the mma on 32 x 16, 32 x 8 or
//     16 x 8 sub-tiles (4 warps at 16 x 32), all warps copy. The grid is
//     (column tiles x S, row tiles); the S blocks of one tile form one
//     cluster (S in {1, 2, 4, 8}); block r walks K steps [r * steps / S,
//     (r + 1) * steps / S) of BK = 64, writes its int32 partial tile to
//     its shared memory, and after cluster.sync() reduces a disjoint 1/S
//     of the tile over distributed shared memory, dequantizes and stores.
//     int32 addition is exact in any order: every S gives the same bits.
//     The wrappers choose (BM, BN, S) with fused_hetero_gemm.split_plan
//     on the one-sided shape.
//   * Tensor cores: mma.sync.m16n8k32.row.col.s32.s8.s8.s32, A from
//     ldmatrix on K-contiguous shared rows (80-byte rows: 8 ldmatrix
//     rows hit 32 distinct banks).
//   * B built in registers, no transpose. In an m16n8k32 B fragment lane
//     l holds column l / 4 and k (l % 4) * 4 + 0..3 (register 0) and
//     + 16 (register 1), so both registers come from one weight word:
//       LUT  a lane takes two nibbles of one word (32 k) and spreads each
//            to four 0/1 bytes, (nib * 0x00204081) & 0x01010101 (the
//            shifted copies do not overlap: no carries), then multiplies
//            by the plane weight as an unsigned byte: 2^b <= 64, the
//            MSB's 256 - 2^(bits-1) is -2^(bits-1) as int8, and a 0/1
//            byte times it has no carry either;
//       DSP  a lane takes 16 bits (four codes) of a word, spreads them to
//            bytes and sign-extends them with __vsub4((v ^ 0x08) - 0x08).
//   * The plane loop stays: a LUT tile runs one mma pass per bit plane
//     into the one accumulator, the A fragments loaded once per step, so
//     its cost grows with the bit width as the LUT core's does. Overflow
//     margin: |x| <= 128, |s_b * bit| <= 128 and K <= 4608 bound every
//     partial and total sum by 128 * 128 * 4608 = 75.5e6, 28x below 2^31.
//   * cp.async pipeline, NST = 3 stages, one __syncthreads per step: the
//     A tile ([BM, BK] rows, 16-byte copies; 8 or 4 bytes when K is not a
//     multiple of 16; a byte gather when it is not a multiple of 4, as at
//     K = 147) and the weight words of step t + 2 are in flight while
//     step t is multiplied. Per column and step the words are 8 bytes a
//     plane (LUT) or 32 bytes (DSP): 1/8 and 1/2 of A's bytes a row.
//     Zero fill (src-size 0) at every masked edge. Shared memory is at
//     most 27 KB a block (bits = 8, BM = BN = 64), under the 48 KB a
//     launch gets without an attribute.
//
// Launches go on the caller's stream (cudaLaunchKernelEx with a cluster
// dimension), allocate nothing, do not synchronise, and return
// cudaGetLastError() (or the launch's own error).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;          // K bytes per pipeline step
constexpr int NST = 3;          // pipeline stages
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LDA = BK + 16;    // A stage row stride (bytes)
constexpr int LUT_WPS = BK / 32;  // LUT words of one (plane, column) per step
constexpr int DSP_WPS = BK / 8;   // DSP words of one column per step
constexpr int LDD = DSP_WPS + 4;  // shared DSP row stride (words): conflict-free reads

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Words of one weight row: K bits (LUT) or K nibbles (DSP), padded to 16 bytes.
// A LUT row always holds the 2 * ceil(K / 64) words the K steps read; a
// DSP row may end inside the last step (the copy then zero-fills).
__host__ __device__ constexpr int lut_row_words(int K) { return (K + 127) / 128 * 4; }
__host__ __device__ constexpr int dsp_row_words(int K) { return (K + 31) / 32 * 4; }

struct Params {
  const int8_t* x;         // [M, K]
  const uint32_t* words;   // LUT [bits, N, row_words]; DSP [N, row_words]
  const float* scale;      // [N]
  float* out;              // [M, N]
  int M, K, N, bits;
  int row_words;
  int split;               // blocks of one cluster along K
  int k_steps;             // ceil(K / BK)
  int a_vec;               // copy width of A: 16/8/4, 1 = scalar
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of V bytes, zero-filled when !ok (src-size 0).
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int n = ok ? V : 0;
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(V), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment registers of lane quad q from a LUT word (32 k of one plane
// and column), each 0/1 byte times the plane weight `sc` (an unsigned byte).
__device__ __forceinline__ void lut_frag(uint32_t w, int q, uint32_t sc, uint32_t& b0,
                                         uint32_t& b1) {
  b0 = (((w >> (4 * q)) & 0xFu) * 0x00204081u & 0x01010101u) * sc;
  b1 = (((w >> (16 + 4 * q)) & 0xFu) * 0x00204081u & 0x01010101u) * sc;
}

// Four int4 codes (the low 16 bits of u, lowest nibble first) -> four int8.
__device__ __forceinline__ uint32_t spread_int4(uint32_t u) {
  const uint32_t w = (u & 0xFu) | ((u & 0xF0u) << 4) | ((u & 0xF00u) << 8) |
                     ((u & 0xF000u) << 12);
  return __vsub4(w ^ 0x08080808u, 0x08080808u);  // (v ^ 8) - 8 per byte
}

// B fragment registers of lane quad q from a DSP shared row (32 k = 4 words).
__device__ __forceinline__ void dsp_frag(const uint32_t* row, int q, uint32_t& b0,
                                         uint32_t& b1) {
  const int sh = 16 * (q & 1);
  b0 = spread_int4(row[q >> 1] >> sh);
  b1 = spread_int4(row[2 + (q >> 1)] >> sh);
}

template <int BM, int BN, bool LUT>
struct Tile {
  static constexpr int WM = BM >= 32 ? BM / 32 : 1;             // mma warps along M
  static constexpr int WN = imax(1, imin(WARPS / WM, BN / 8));  // ... along N
  static constexpr int MMA_WARPS = WM * WN;
  static constexpr int MI = BM / (16 * WM);  // m16 tiles per warp
  static constexpr int NI = BN / (8 * WN);   // n8 tiles per warp
  static constexpr int RS = BN + 8;          // partial tile row stride (int32)

  // words of one B stage
  __host__ __device__ static int b_stage(int bits) {
    return LUT ? bits * BN * LUT_WPS : BN * LDD;
  }
  // dynamic shared memory: A stages | B stages; the int32 partial tile of
  // the split-K reduction reuses it once the K loop is done
  __host__ __device__ static int smem_bytes(int bits) {
    return imax(NST * BM * LDA + NST * b_stage(bits) * 4, BM * RS * 4);
  }
};

template <int BM, int BN, bool LUT>
struct Loader {
  const Params& p;
  int8_t* As;
  uint32_t* Bs;
  int bstage;
  int tid, m0, j0, k_end;

  // A of the K step starting at k0 into stage buffer `as`, V-byte copies.
  template <int V>
  __device__ __forceinline__ void load_a_vec(int8_t* as, int k0) const {
    constexpr int CH = BK / V;
#pragma unroll 1
    for (int e = tid; e < BM * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      const int k = k0 + c * V, m = m0 + r;
      const bool ok = k < k_end && m < p.M;
      cp_async<V>(as + r * LDA + c * V, ok ? p.x + (size_t)m * p.K + k : p.x, ok);
    }
  }

  // A by bytes, for rows that are not 4-byte aligned.
  __device__ __forceinline__ void load_a_scalar(int8_t* as, int k0) const {
    const int kk = tid % BK, k = k0 + kk;
    for (int r = tid / BK; r < BM; r += THREADS / BK) {
      const int m = m0 + r;
      as[r * LDA + kk] = (k < k_end && m < p.M) ? p.x[(size_t)m * p.K + k] : 0;
    }
  }

  __device__ __forceinline__ void load_stage(int step, int buf) const {
    const int k0 = step * BK;
    int8_t* as = As + buf * BM * LDA;
    if (p.a_vec == 16)
      load_a_vec<16>(as, k0);
    else if (p.a_vec == 8)
      load_a_vec<8>(as, k0);
    else if (p.a_vec == 4)
      load_a_vec<4>(as, k0);
    else
      load_a_scalar(as, k0);
    load_words(Bs + buf * bstage, step);
  }

  // The weight words of one K step into a B stage: LUT [plane][column]
  // [LUT_WPS words], 8 bytes a (plane, column); DSP [column][LDD words],
  // DSP_WPS of them filled by two 16-byte copies.
  __device__ __forceinline__ void load_words(uint32_t* bs, int step) const {
    if constexpr (LUT) {
#pragma unroll 1
      for (int e = tid; e < p.bits * BN; e += THREADS) {
        const int b = e / BN, col = j0 + e % BN;
        const bool ok = col < p.N;
        const uint32_t* src =
            ok ? p.words + (size_t)(b * p.N + col) * p.row_words + step * LUT_WPS : p.words;
        cp_async<8>(bs + e * LUT_WPS, src, ok);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < BN * 2; e += THREADS) {
        const int n = e / 2, c = e % 2;
        const int col = j0 + n, w = step * DSP_WPS + 4 * c;
        const bool ok = col < p.N && w < p.row_words;
        cp_async<16>(bs + n * LDD + 4 * c, ok ? p.words + (size_t)col * p.row_words + w : p.words,
                     ok);
      }
    }
  }
};

template <int BM, int BN, bool LUT>
__global__ void __launch_bounds__(THREADS) split_gemm_kernel(const Params p) {
  static_assert(BK == 64, "two k32 halves a step: a LUT (plane, column) is one uint2");
  using T = Tile<BM, BN, LUT>;
  constexpr int MI = T::MI, NI = T::NI, WN = T::WN, RS = T::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / p.split;
  Loader<BM, BN, LUT> ld{p};
  ld.As = reinterpret_cast<int8_t*>(smem);
  ld.Bs = reinterpret_cast<uint32_t*>(smem + NST * BM * LDA);
  ld.bstage = T::b_stage(p.bits);
  ld.tid = threadIdx.x;
  ld.m0 = blockIdx.y * BM;
  ld.j0 = tile * BN;
  const int nplanes = LUT ? p.bits : 1;

  // this block's K steps
  const int s_begin = rank * p.k_steps / p.split;
  const int s_end = (rank + 1) * p.k_steps / p.split;
  const int nsteps = s_end - s_begin;
  ld.k_end = min(p.K, s_end * BK);

  const int warp = ld.tid / 32, lane = ld.tid % 32;
  const bool mma_warp = warp < T::MMA_WARPS;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, q = lane % 4;
  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nsteps) ld.load_stage(s_begin + s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage st landed; step st - 1 is done with its buffers
    if (st + NST - 1 < nsteps) ld.load_stage(s_begin + st + NST - 1, (st + NST - 1) % NST);
    cp_async_commit();
    if (!mma_warp) continue;

    // A fragments once per step; B fragments from the words, one mma pass
    // per (scaled) bit plane
    const int8_t* as = ld.As + (st % NST) * BM * LDA;
    const uint32_t* bs = ld.Bs + (st % NST) * ld.bstage;
    uint32_t a[BK / 32][MI][4];
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = (wm * MI + i) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(a[kk][i], as + row * LDA + 32 * kk + 16 * (lane >> 4));
      }
    for (int b = 0; b < nplanes; ++b) {
      uint32_t bf[BK / 32][NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = (wn * NI + j) * 8 + g;
        if constexpr (LUT) {
          const uint32_t sc = (uint32_t)((b == p.bits - 1 ? -(1 << b) : (1 << b)) & 0xFF);
          const uint2 w = *reinterpret_cast<const uint2*>(bs + (b * BN + n) * LUT_WPS);
          lut_frag(w.x, q, sc, bf[0][j][0], bf[0][j][1]);
          lut_frag(w.y, q, sc, bf[1][j][0], bf[1][j][1]);
        } else {
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            dsp_frag(bs + n * LDD + 4 * kk, q, bf[kk][j][0], bf[kk][j][1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[kk][i], bf[kk][j][0], bf[kk][j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers are free: the partial tile reuses them

  int* red = reinterpret_cast<int*>(smem);
  if (mma_warp) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int row = (wm * MI + i) * 16 + g, col = (wn * NI + j) * 8 + 2 * q;
        *reinterpret_cast<int2*>(red + row * RS + col) = make_int2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<int2*>(red + (row + 8) * RS + col) =
            make_int2(acc[i][j][2], acc[i][j][3]);
      }
  }
  cluster.sync();  // every partial tile of the cluster is in place

  // this block's 1/S of the tile: sum the S partial tiles, dequantize, store
  constexpr int VECS = BM * BN / 4;
  const int per = VECS / p.split;
  for (int v = rank * per + ld.tid; v < (rank + 1) * per; v += THREADS) {
    const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int src = 0; src < p.split; ++src) {
      const int4 part = *cluster.map_shared_rank(reinterpret_cast<int4*>(red + r * RS + c), src);
      sum.x += part.x;
      sum.y += part.y;
      sum.z += part.z;
      sum.w += part.w;
    }
    const int m = ld.m0 + r;
    if (m >= p.M) continue;
    const int vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = ld.j0 + c + e;
      if (col >= p.N) break;
      p.out[(size_t)m * p.N + col] = __int2float_rn(vals[e]) * p.scale[col];
    }
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

int vec_of(const void* ptr, int ld) {
  for (int v = 16; v >= 4; v /= 2)
    if (ld % v == 0 && (uintptr_t)ptr % v == 0) return v;
  return 1;
}

template <int BM, int BN, bool LUT>
int launch_tile(const Params& p, cudaStream_t stream) {
  using T = Tile<BM, BN, LUT>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + BN - 1) / BN * p.split, (p.M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::smem_bytes(p.bits);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, split_gemm_kernel<BM, BN, LUT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled tiles: (bm, bn) in {16, 64} x {32, 64}; split in {1, 2, 4, 8}.
template <bool LUT>
int launch(Params p, int bm, int bn, int split, void* stream) {
  if (split != 1 && split != 2 && split != 4 && split != 8) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)p.words % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (p.M == 0 || p.N == 0) return (int)cudaSuccess;
  p.split = split;
  p.k_steps = (p.K + BK - 1) / BK;
  p.a_vec = vec_of(p.x, p.K);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64) return launch_tile<64, 64, LUT>(p, s);
  if (bm == 64 && bn == 32) return launch_tile<64, 32, LUT>(p, s);
  if (bm == 16 && bn == 64) return launch_tile<16, 64, LUT>(p, s);
  if (bm == 16 && bn == 32) return launch_tile<16, 32, LUT>(p, s);
  return (int)cudaErrorInvalidValue;
}

Params base_params(const void* x, int M, int K, const void* words, int N, const void* scale,
                   void* out) {
  Params p{};
  p.x = (const int8_t*)x;
  p.words = (const uint32_t*)words;
  p.scale = (const float*)scale;
  p.out = (float*)out;
  p.M = M;
  p.K = K;
  p.N = N;
  return p;
}

}  // namespace

extern "C" {

// x [M, K] int8; lut_words [bits, N, lut_row_words(K)] int32; scale [N]
// fp32 -> out [M, N] fp32; (bm, bn, split) from
// fused_hetero_gemm.py::split_plan(M, K, N, 0).
int bitserial_gemm(const void* x, int M, int K, const void* lut_words, int bits, int N,
                   const void* scale, void* out, int bm, int bn, int split, void* stream) {
  if (bits < 1 || bits > 8) return (int)cudaErrorInvalidValue;
  Params p = base_params(x, M, K, lut_words, N, scale, out);
  p.bits = bits;
  p.row_words = lut_row_words(K);
  return launch<true>(p, bm, bn, split, stream);
}

// x [M, K] int8; dsp_words [N, dsp_row_words(K)] int32; scale [N] fp32
// -> out [M, N] fp32; (bm, bn, split) from split_plan(M, K, 0, N).
int int4_gemm(const void* x, int M, int K, const void* dsp_words, int N, const void* scale,
              void* out, int bm, int bn, int split, void* stream) {
  Params p = base_params(x, M, K, dsp_words, N, scale, out);
  p.bits = 0;
  p.row_words = dsp_row_words(K);
  return launch<false>(p, bm, bn, split, stream);
}

}  // extern "C"
