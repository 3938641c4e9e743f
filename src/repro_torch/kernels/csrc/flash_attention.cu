// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py flash_attention (Pallas body
// _flash_kernel, GQA repeat in repro/kernels/ops.py attention), and
// computes what repro/models/layers.py blockwise_attention computes on
// the serving path's prefill: online-softmax attention with an fp32
// running max m, normaliser l and accumulator, a causal mask offset by
// kv_offset, and ragged Sq / Skv masked in the kernel.
//
// Layout. q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], out [B, Sq, Hq, D],
// all bf16, D in {64, 128}, given by element strides (batch, sequence,
// head) with the last dimension contiguous, so blockwise_attention's
// [B, S, H, D] and ops.attention's [B, H, S, D] both arrive without a
// copy. Query head h reads KV head
// h / (Hq / Hkv): grouped-query attention with no repeated K or V.
//
// Numerics, as blockwise_attention:
//   s   = (q . k) * scale in fp32, the scale applied after the dot;
//   s   = -1e30 where kpos >= Skv or (causal and kpos > qpos + kv_offset);
//   l  += sum of the fp32 p = exp(s - m);
//   acc = acc * alpha + (p rounded to bf16) . v, in fp32;
//   out = acc / max(l, 1e-30), rounded to bf16.
// A kv tile that lies wholly above the causal diagonal is not visited:
// it would add exp(-1e30 - m) = 0 to l and acc with alpha = 1, so the
// skip is exact. The first tile always holds key 0, which every query
// row may see, so m is finite from the first tile on.
//
// What bounds it on an H100. At the serving prefill (B=8, S=64, Hq=32,
// Hkv=8, D=64, bf16) the work is 4*B*Hq*D*(S(S+1)/2) = 136 MFLOP and the
// bytes are q, k, v and out once, 3.1 MB: ~1 us of HBM at 3.35 TB/s
// against ~0.14 us of bf16 tensor-core time, so bytes bound it. At
// S=2048 the 17 GFLOP of the causal product bound it (~17 us at
// 989 TFLOP/s).
//
// Design (simple and right first; mma/wgmma and TMA are later work):
//   * one block of 256 threads per (64-row q tile, query head, batch);
//     the kv loop runs inside the block, where the TPU's sequential grid
//     axis carried the running statistics from step to step;
//   * each 64-row K and V tile is staged in shared memory as fp32; the
//     threads form a 16x16 grid, each owning 4 query rows and 4 key
//     columns of the score tile (s = q . k by FMA from shared memory),
//     then the same 4 rows and D/16 output columns of the accumulator;
//   * the 16 lanes that own a row sit in one half-warp, so the row max
//     and row sum are four shuffles, and p passes to the p . v product
//     through shared memory with a warp barrier only;
//   * fp32 FMA runs at 67 TFLOP/s, 1/15 of the bf16 tensor cores, and
//     each FMA reads half a float from shared memory: far from the bound
//     at long sequences, near it at the serving prefill.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per staged tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDP = BKV + 1;  // padded row stride of the p tile
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal, kv_offset;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}

// Sum / max over the 16 lanes of a half-warp (one row group).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles [64][D + 1], V tile [64][D], p tile [64][BKV + 1]
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * LDP);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  constexpr int LD = D + 1;   // padded row stride: conflict-free columns
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* Ps = Vs + BKV * D;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * LD + c] = q0 + r < a.Sq ? to_f(q[(q0 + r) * a.q_ss + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // kv tiles up to the last key the tile's last query row may see
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, min(q0 + BQ, a.Sq) + a.kv_offset);
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // Q staged; the previous tile's K, V, p read
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < a.Skv;
      Ks[r * LD + c] = in ? to_f(k[(k0 + r) * a.k_ss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(v[(k0 + r) * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + a.kv_offset;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < a.Skv && (!a.causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      alpha[i] = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = to_f(to_bf16(p));
      }
      l[i] = l[i] * alpha[i] + group_sum(ps);
      m[i] = m_new;
    }
    __syncwarp();  // a row group reads only the p its own 16 lanes wrote

    float pv[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pr[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) pv[i][j] = fmaf(pr[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
    const float norm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[r * a.o_ss + tx + 16 * j] = to_bf16(acc[i][j] / norm);
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  flash_kernel<D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D] -> out [B, Sq, Hq, D], all
// bf16, given by element strides (batch, sequence, head) with the last
// dimension contiguous. D in {64, 128}; Hq a multiple of Hkv;
// kv_offset >= 0.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int Hq, int Hkv, int D,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh,
                    float scale, int causal, int kv_offset, void* stream) {
  const Args a{q,    k,    v,    out,  Sq,   Skv,  Hq,   Hkv,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               o_sb, o_ss, o_sh, scale, causal, kv_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
