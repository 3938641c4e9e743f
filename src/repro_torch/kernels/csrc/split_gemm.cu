// Single-path split GEMM kernels of the N3H-Core heterogeneous layer
// (paper Eq. 12) for Hopper (sm_90a).
//
// One templated kernel, two C entry points, one for each TPU kernel of
// the JAX package (both sides of the split in one launch, with and
// without im2col, are fused_split_gemm.cu's):
//
//   bitserial_gemm     replaces repro/kernels/bitserial_gemm.py
//                      bitserial_gemm (_bitserial_kernel): LUT side only.
//   int4_gemm          replaces repro/kernels/int4_gemm.py int4_gemm
//                      (_int4_kernel): DSP side only.
//
// What it computes. Output columns [0, n_lut) are the LUT core's: the
// weights arrive as `bits` binary planes [bits, K, n_lut] (int8 0/1) and
// a column accumulates sum_b s_b * (x @ plane_b), s_b = 2^b with the MSB
// plane weighted -2^(bits-1). Columns [n_lut, n_lut + n_dsp) are the DSP
// core's: int4 codes packed two to a byte [K, ceil(n_dsp / 2)], even
// column in the low nibble. Both sides accumulate exactly in int32; the
// epilogue converts to fp32 and multiplies by the per-column scale,
// the same two IEEE operations as the plain version, so the outputs
// are bitwise equal to it.
//
// What bounds it on an H100. At batch 1 resnet18's split GEMMs need
// about 5.8 MB of weights at their code width (4 bits each), 2.2 MB of
// activations and 9.9 MB of fp32 output per image: ~5.4 us at
// 3.35 TB/s. The integer product is ~3.6 G ops: ~1.8 us at the
// 1,979 TOP/s int8 tensor-core peak. So the batch-1 floor is set by
// bytes. The int8 bit planes read here hold each LUT weight in 8x its
// bits (~39 MB per image), which a bit-packed layout would avoid.
//
// Design (simple and right first; wgmma/TMA is later work):
//   * one block of 256 threads per (64-row tile x 64-column tile); each
//     thread owns a 4x4 int32 accumulator;
//   * the K loop stages a 64x32 activation tile and a 32x64 weight tile
//     (stored column-major, so four consecutive k of one column form one
//     32-bit word) in shared memory and contracts them with __dp4a;
//   * a LUT column tile loops over the bit planes inside each K step and
//     adds s_b * partial: its cost grows with the bit width, as the LUT
//     core's does; a DSP column tile unpacks sign-extended nibbles in
//     registers while staging;
//   * ragged M, K and N edges are masked.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BK + 4;  // shared row stride in bytes: 4-byte aligned, conflict-free

struct Params {
  const int8_t* x;       // [M, K]
  const int8_t* planes;  // [bits, K, n_lut] in {0, 1}
  const int8_t* packed;  // [K, ceil(n_dsp / 2)] int4 pairs
  const float* scale;    // [n_lut + n_dsp]
  float* out;            // [M, n_lut + n_dsp]
  int M, K;
  int bits, n_lut, n_dsp;
  int lut_tiles;         // ceil(n_lut / BN): column tiles before the DSP region
};

// acc[i][j] += dot(As row (ty + 16 i), Bs column (tx + 16 j)) over one K tile.
__device__ __forceinline__ void dot_tile(const int8_t* As, const int8_t* Bs,
                                         int tx, int ty, int (&acc)[4][4]) {
#pragma unroll
  for (int kq = 0; kq < BK; kq += 4) {
    int a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const int*>(As + (ty + 16 * i) * LDS + kq);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const int*>(Bs + (tx + 16 * j) * LDS + kq);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(THREADS) split_gemm_kernel(Params p) {
  __shared__ __align__(16) int8_t As[BM * LDS];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // [n][k]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const bool lut = (int)blockIdx.x < p.lut_tiles;
  const int j0 = ((int)blockIdx.x - (lut ? 0 : p.lut_tiles)) * BN;  // inside the region
  const int n_region = lut ? p.n_lut : p.n_dsp;
  const int col0 = lut ? j0 : p.n_lut + j0;                           // output column
  const int n_out = p.n_lut + p.n_dsp;
  const int packed_ld = (p.n_dsp + 1) / 2;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    __syncthreads();  // the previous K step is done with As and Bs
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      As[r * LDS + c] = (m < p.M && k < p.K) ? p.x[(size_t)m * p.K + k] : 0;
    }
    if (lut) {
      for (int b = 0; b < p.bits; ++b) {
        if (b > 0) __syncthreads();  // the previous plane is consumed
        const int8_t* plane = p.planes + (size_t)b * p.K * p.n_lut;
        for (int e = tid; e < BK * BN; e += THREADS) {
          const int c = e / BN, n = e % BN;  // neighbouring threads, neighbouring columns
          const int k = k0 + c, j = j0 + n;
          Bs[n * LDS + c] =
              (k < p.K && j < p.n_lut) ? plane[(size_t)k * p.n_lut + j] : 0;
        }
        __syncthreads();
        int part[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = 0;
        dot_tile(As, Bs, tx, ty, part);
        const int s = (b == p.bits - 1) ? -(1 << b) : (1 << b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += s * part[i][j];
      }
    } else {
      for (int e = tid; e < BK * (BN / 2); e += THREADS) {
        const int c = e / (BN / 2), q = e % (BN / 2);
        const int k = k0 + c, jb = j0 / 2 + q;  // byte column; j0 is even
        const unsigned u = (k < p.K && jb < packed_ld)
                               ? (uint8_t)p.packed[(size_t)k * packed_ld + jb]
                               : 0u;
        const int lo = (int)((u & 0xFu) ^ 8u) - 8;  // sign-extended nibbles
        const int hi = (int)((u >> 4) ^ 8u) - 8;
        const int j = j0 + 2 * q;
        Bs[(2 * q) * LDS + c] = (int8_t)(j < p.n_dsp ? lo : 0);
        Bs[(2 * q + 1) * LDS + c] = (int8_t)(j + 1 < p.n_dsp ? hi : 0);
      }
      __syncthreads();
      dot_tile(As, Bs, tx, ty, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = j0 + tx + 16 * j;
      if (n >= n_region) continue;
      const int col = col0 + tx + 16 * j;
      p.out[(size_t)m * n_out + col] = __int2float_rn(acc[i][j]) * p.scale[col];
    }
  }
}

int launch(Params p, void* stream) {
  p.lut_tiles = (p.n_lut + BN - 1) / BN;
  const int dsp_tiles = (p.n_dsp + BN - 1) / BN;
  const dim3 grid(p.lut_tiles + dsp_tiles, (p.M + BM - 1) / BM);
  split_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

Params base_params(const void* x, int M, int K, const void* planes, int bits,
                   int n_lut, const void* packed, int n_dsp, const void* scale,
                   void* out) {
  Params p{};
  p.x = (const int8_t*)x;
  p.planes = (const int8_t*)planes;
  p.packed = (const int8_t*)packed;
  p.scale = (const float*)scale;
  p.out = (float*)out;
  p.M = M;
  p.K = K;
  p.bits = bits;
  p.n_lut = n_lut;
  p.n_dsp = n_dsp;
  return p;
}

}  // namespace

extern "C" {

// x [M, K] int8; planes [bits, K, N]; scale [N] -> out [M, N].
int bitserial_gemm(const void* x, int M, int K, const void* planes, int bits,
                   int N, const void* scale, void* out, void* stream) {
  return launch(
      base_params(x, M, K, planes, bits, N, nullptr, 0, scale, out), stream);
}

// x [M, K] int8; packed [K, ceil(N/2)]; scale [N] -> out [M, N].
int int4_gemm(const void* x, int M, int K, const void* packed, int N,
              const void* scale, void* out, void* stream) {
  return launch(
      base_params(x, M, K, nullptr, 0, 0, packed, N, scale, out), stream);
}

}  // extern "C"
