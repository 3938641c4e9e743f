// Flash attention in fp32 (forward and backward) for Hopper (sm_90a), on
// the CUDA cores.
//
// Replaces src/repro/kernels/flash_attention.py flash_attention (its
// Pallas body, which the reference runs in the array's own dtype) and the
// gradient of src/repro/models/layers.py blockwise_attention (XLA
// autodiff of that schedule; the Pallas kernel has none) for fp32
// tensors: what the smoke configs of every attention arch send (fp32
// params, head sizes 8-32, MLA's 24 over 16), and an encoder-decoder's
// fp32 decode queries over its bf16 cross cache. The bf16 kernels
// (flash_attention.cu, flash_attention_bwd.cu) keep the published
// configs.
//
// Why CUDA C++ on fp32 FMA and not tensor cores or Triton. TF32 keeps
// about 3 decimal digits, and the reference's fp32 attention is IEEE
// fp32; the kernel keeps every product and sum in fp32. It is a
// reduction-and-product kernel with two backward launches (dq with delta,
// then dkdv) that share the bf16 backward's block plan and its order of
// sums, which a hand-written kernel states exactly.
//
// Layout. q [B, Sq, Hq, D] fp32; k [B, Skv, Hkv, D] and v [B, Skv, Hkv,
// DV] fp32, or bf16 in the forward (widened in the kernel, exactly); out
// [B, Sq, Hq, DV] in v's dtype, contiguous; lse and delta [B, Hq, Sq]
// fp32, contiguous; dq, dk, dv fp32, contiguous in their inputs' shapes;
// the backward's out and dout fp32 by element strides.
// Inputs by element strides (batch, sequence, head) that are multiples of
// 4, the last dimension contiguous, the data aligned to 4 elements. D and
// DV multiples of 4, at most 64. Query head h reads KV head h / (Hq /
// Hkv).
//
// Numerics, as blockwise_attention in fp32:
//   s     = (q . k) * scale, fp32, masked where kpos >= Skv or (causal and
//           kpos > qpos + kv_offset);
//   p     = exp(s - m) by expf, l += sum of p, acc = acc * alpha + p . v,
//           with p rounded to bf16 before p . v where v is bf16 (as the
//           reference rounds p to the value dtype); out = acc / l;
//   lse   = m + log(l);
//   delta = rowsum(dout * out); ds = p * (dp - delta), dp = dout . v;
//   dq    = scale ds . k, dk = scale ds^T . q, dv = p^T . dout.
// Every sum is taken in one fixed order (no atomics), so each result is
// bitwise repeatable.
//
// What bounds it on an H100. The smoke configs' attentions are tiny (B 2,
// S 8-16, a few heads): a launch's latency bounds them. At a realistic
// fp32 size (S 1024, 16 heads of 16) the products, 2 Sq Skv (D + DV)
// FLOP a head, run on the 67 TFLOP/s fp32 FMA pipes; the bytes are few.
//
// Design (one plan for the three entry points):
//   * rows: a block's query rows are (position, head of the KV group)
//     pairs in position-major order, r = pos * rep + j for query head
//     hk * rep + j, BR = 32 of them; so the query heads that share a KV
//     head read each K and V tile once, and the decode form (Sq = 1)
//     packs its rep heads into one block;
//   * forward and dq: one block per (32 rows, KV head, batch) walks the
//     64-key tiles up to the last key its rows may see. Thread (ty, tx)
//     of 8 x 16 holds rows 4 ty + i and keys tx + 16 j (i, j < 4) of the
//     score tile, and rows 4 ty + i, columns tx + 16 c of the output or
//     dq: a row's max and sum reduce over its 16 lanes by shuffles. p (or
//     ds) goes through shared memory to the product over keys;
//   * dq first computes its rows' delta from dout (in shared memory) and
//     out, and writes it for dkdv;
//   * dkdv: one block per (64 keys, KV head, batch) walks the row tiles
//     of its KV head's query heads from the first position that sees its
//     first key, and keeps dk and dv in registers (thread (ty, tx): keys
//     8 ty + i, columns tx + 16 c), so no two blocks add into one row;
//     each row tile's sums are taken apart and then added;
//   * shared tiles are fp32 rows padded to an odd stride (D + 1), so the
//     16 lanes of a half warp that read a column down the rows hit 16
//     banks.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TX = 16;          // lanes along keys or columns
constexpr int BR = 32;          // query rows of a block or a row tile
constexpr int BK = 64;          // keys of a tile
constexpr int MAXD = 64;        // largest D and DV
constexpr int CD = MAXD / TX;   // output columns a thread, at most
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* out;   // backward: the forward's output (dq's delta)
  const float* dout;
  void* o;            // forward: the output
  float* lse;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int Sq, Skv, Hq, Hkv, D, DV, rep;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  float scale;
  int causal, kv_offset;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows [0, n) of an R x W tile (row i at g + i * ld) into shared memory
// with row stride W + 1, zeros past n; row i of the tile comes from
// `src(i)`, 4 elements at a time
template <typename T, typename F>
__device__ __forceinline__ void load_rows(float* s, int R, int W, int n,
                                          F src) {
  const int per = W / 4;
  for (int e = threadIdx.x; e < R * per; e += THREADS) {
    const int i = e / per, c = 4 * (e % per);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) x = load4(static_cast<const T*>(src(i)) + c);
    float* d = s + i * (W + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// the sum (or max) of a value over a half warp's 16 lanes, in a fixed
// order, on every lane
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The block's rows: r -> (position, query head); the KV tiles it visits
__device__ __forceinline__ int row_pos(const Args& a, int r) {
  return r / a.rep;
}
__device__ __forceinline__ const float* q_row(const Args& a, int b, int hk,
                                              int r) {
  return a.q + b * a.q_sb + (long long)row_pos(a, r) * a.q_ss +
         (hk * a.rep + r % a.rep) * a.q_sh;
}
__device__ __forceinline__ long long stat_row(const Args& a, int b, int hk,
                                              int r) {
  return ((long long)b * a.Hq + hk * a.rep + r % a.rep) * a.Sq +
         row_pos(a, r);
}
__device__ __forceinline__ int kv_end_of(const Args& a, int r0, int nrows) {
  if (!a.causal) return a.Skv;
  const int last = row_pos(a, min(r0 + BR, nrows) - 1);
  return min(a.Skv, last + a.kv_offset + 1);
}
__device__ __forceinline__ bool masked(const Args& a, int pos, int key) {
  return key >= a.Skv || (a.causal && key > pos + a.kv_offset);
}

// ------------------------------------------------------------ forward ---

template <typename T>
__global__ void __launch_bounds__(THREADS) fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DV = a.DV;
  float* Qs = smem;                    // [BR][D + 1]
  float* Ks = Qs + BR * (D + 1);       // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][DV + 1]
  float* Ps = Vs + BK * (DV + 1);      // [BR][BK + 1]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int hk = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * BR;
  const int nrows = a.Sq * a.rep;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_rows<float>(Qs, BR, D, nrows - r0,
                   [&](int i) { return q_row(a, b, hk, r0 + i); });
  float m[4], l[4], acc[4][CD];
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    pos[i] = row_pos(a, min(r0 + 4 * ty + i, nrows - 1));
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
  const int kv_end = kv_end_of(a, r0, nrows);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's K, V and P read by all
    load_rows<T>(Ks, BK, D, a.Skv - k0,
                 [&](int i) { return kg + (k0 + i) * a.k_ss; });
    load_rows<T>(Vs, BK, DV, a.Skv - k0,
                 [&](int i) { return vg + (k0 + i) * a.v_ss; });
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + TX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(a, pos[i], k0 + tx + TX * j) ? NEG_INF
                                                       : s[i][j] * a.scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        // p . v takes p in v's dtype
        Ps[(4 * ty + i) * (BK + 1) + tx + TX * j] =
            sizeof(T) == 2 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_sum(sum);
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    const int n = min(BK, kv_end - k0);
    for (int j = 0; j < n; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tx + TX * c;
        if (col < DV) {
          const float vv = Vs[j * (DV + 1) + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= nrows) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const long long orow =
        (((long long)b * a.Sq + row_pos(a, r)) * a.Hq + hk * a.rep +
         r % a.rep) * DV;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + TX * c;
      if (col >= DV) continue;
      const float o = acc[i][c] / lc;
      if (sizeof(T) == 2)
        static_cast<bf16*>(a.o)[orow + col] = __float2bfloat16_rn(o);
      else
        static_cast<float*>(a.o)[orow + col] = o;
    }
    if (a.lse != nullptr && tx == 0)
      a.lse[stat_row(a, b, hk, r)] = m[i] + logf(lc);
  }
}

// ----------------------------------------------------------------- dq ---

__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DV = a.DV;
  float* Qs = smem;                    // [BR][D + 1]
  float* dOs = Qs + BR * (D + 1);      // [BR][DV + 1]
  float* Ks = dOs + BR * (DV + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][DV + 1]
  float* Ps = Vs + BK * (DV + 1);      // [BR][BK + 1]: ds
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int hk = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * BR;
  const int nrows = a.Sq * a.rep;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto row_of = [&](const float* base, long long sb, long long ss,
                    long long sh, int r) {
    return base + b * sb + (long long)row_pos(a, r) * ss +
           (hk * a.rep + r % a.rep) * sh;
  };
  load_rows<float>(Qs, BR, D, nrows - r0,
                   [&](int i) { return q_row(a, b, hk, r0 + i); });
  load_rows<float>(dOs, BR, DV, nrows - r0, [&](int i) {
    return row_of(a.dout, a.do_sb, a.do_ss, a.do_sh, r0 + i);
  });
  __syncthreads();
  // each row's lse and delta = rowsum(dout * out): columns tx + 16 c,
  // then the half warp's sum
  float l2[4], dl[4];
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = min(r0 + 4 * ty + i, nrows - 1);
    pos[i] = row_pos(a, r);
    const float* orow = row_of(a.out, a.o_sb, a.o_ss, a.o_sh, r);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + TX * c;
      if (col < DV)
        sum = fmaf(dOs[(4 * ty + i) * (DV + 1) + col], orow[col], sum);
    }
    dl[i] = half_sum(sum);
    l2[i] = a.lse[stat_row(a, b, hk, r)];
    if (tx == 0 && r0 + 4 * ty + i < nrows)
      a.delta[stat_row(a, b, hk, r)] = dl[i];
  }
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  const int kv_end = kv_end_of(a, r0, nrows);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_rows<float>(Ks, BK, D, a.Skv - k0,
                     [&](int i) { return kg + (k0 + i) * a.k_ss; });
    load_rows<float>(Vs, BK, DV, a.Skv - k0,
                     [&](int i) { return vg + (k0 + i) * a.v_ss; });
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + TX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    for (int d = 0; d < DV; ++d) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = dOs[(4 * ty + i) * (DV + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + TX * j) * (DV + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = masked(a, pos[i], k0 + tx + TX * j)
                            ? 0.f
                            : expf(s[i][j] * a.scale - l2[i]);
        Ps[(4 * ty + i) * (BK + 1) + tx + TX * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    const int n = min(BK, kv_end - k0);
    for (int j = 0; j < n; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ps[(4 * ty + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tx + TX * c;
        if (col < D) {
          const float kv = Ks[j * (D + 1) + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= nrows) continue;
    const long long row =
        (((long long)b * a.Sq + row_pos(a, r)) * a.Hq + hk * a.rep +
         r % a.rep) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + TX * c;
      if (col < D) a.dq[row + col] = acc[i][c] * a.scale;
    }
  }
}

// --------------------------------------------------------------- dkdv ---

__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D, DV = a.DV;
  float* Ks = smem;                    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][DV + 1]
  float* Qs = Vs + BK * (DV + 1);      // [BR][D + 1]
  float* dOs = Qs + BR * (D + 1);      // [BR][DV + 1]
  float* Ls = dOs + BR * (DV + 1);     // [BR] lse
  float* Dl = Ls + BR;                 // [BR] delta
  float* Pt = Dl + BR;                 // [BK][BR + 1]: p^T
  float* St = Pt + BK * (BR + 1);      // [BK][BR + 1]: ds^T
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BK;
  const int nrows = a.Sq * a.rep;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  load_rows<float>(Ks, BK, D, a.Skv - k0,
                   [&](int i) { return kg + (k0 + i) * a.k_ss; });
  load_rows<float>(Vs, BK, DV, a.Skv - k0,
                   [&](int i) { return vg + (k0 + i) * a.v_ss; });
  // the row tiles: from the first position that sees key k0
  const int first = a.causal ? max(0, k0 - a.kv_offset) * a.rep : 0;
  float dk[8][CD], dv[8][CD];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[i][c] = dv[i][c] = 0.f;
  for (int r0 = first - first % BR; r0 < nrows; r0 += BR) {
    __syncthreads();  // the last tile's Q, dO, p^T and ds^T read by all
    load_rows<float>(Qs, BR, D, nrows - r0,
                     [&](int i) { return q_row(a, b, hk, r0 + i); });
    load_rows<float>(dOs, BR, DV, nrows - r0, [&](int i) {
      const int r = r0 + i;
      return a.dout + b * a.do_sb + (long long)row_pos(a, r) * a.do_ss +
             (hk * a.rep + r % a.rep) * a.do_sh;
    });
    if (threadIdx.x < BR) {
      const int r = r0 + threadIdx.x;
      const long long st = stat_row(a, b, hk, min(r, nrows - 1));
      Ls[threadIdx.x] = r < nrows ? a.lse[st] : 0.f;
      Dl[threadIdx.x] = r < nrows ? a.delta[st] : 0.f;
    }
    __syncthreads();
    // s^T and dp^T: keys 8 ty + i, rows tx + 16 j
    float s[8][2], dp[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float q0 = Qs[tx * (D + 1) + d], q1 = Qs[(tx + TX) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float kv = Ks[(8 * ty + i) * (D + 1) + d];
        s[i][0] = fmaf(kv, q0, s[i][0]);
        s[i][1] = fmaf(kv, q1, s[i][1]);
      }
    }
    for (int d = 0; d < DV; ++d) {
      const float o0 = dOs[tx * (DV + 1) + d],
                  o1 = dOs[(tx + TX) * (DV + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float vv = Vs[(8 * ty + i) * (DV + 1) + d];
        dp[i][0] = fmaf(vv, o0, dp[i][0]);
        dp[i][1] = fmaf(vv, o1, dp[i][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rr = tx + TX * j, r = r0 + rr;
      const int pos = row_pos(a, min(r, nrows - 1));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = k0 + 8 * ty + i;
        const float p = (r >= nrows || masked(a, pos, key))
                            ? 0.f
                            : expf(s[i][j] * a.scale - Ls[rr]);
        Pt[(8 * ty + i) * (BR + 1) + rr] = p;
        St[(8 * ty + i) * (BR + 1) + rr] = p * (dp[i][j] - Dl[rr]);
      }
    }
    __syncthreads();
    // dv += p^T . dout, dk += ds^T . q: keys 8 ty + i, columns tx + 16 c;
    // the tile's 32 rows summed apart and then added, so a sum over
    // thousands of rows drifts by the tiles' count, not the rows'
    float tk[8][CD], tv[8][CD];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) tk[i][c] = tv[i][c] = 0.f;
    for (int r = 0; r < BR; ++r) {
      float pt[8], st[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pt[i] = Pt[(8 * ty + i) * (BR + 1) + r];
        st[i] = St[(8 * ty + i) * (BR + 1) + r];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tx + TX * c;
        if (col < DV) {
          const float o = dOs[r * (DV + 1) + col];
#pragma unroll
          for (int i = 0; i < 8; ++i) tv[i][c] = fmaf(pt[i], o, tv[i][c]);
        }
        if (col < D) {
          const float q = Qs[r * (D + 1) + col];
#pragma unroll
          for (int i = 0; i < 8; ++i) tk[i][c] = fmaf(st[i], q, tk[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dk[i][c] += tk[i][c];
        dv[i][c] += tv[i][c];
      }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 8 * ty + i;
    if (key >= a.Skv) continue;
    const long long row = ((long long)b * a.Skv + key) * a.Hkv + hk;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + TX * c;
      if (col < D) a.dk[row * D + col] = dk[i][c] * a.scale;
      if (col < DV) a.dv[row * DV + col] = dv[i][c];
    }
  }
}

// ------------------------------------------------------------- host ---

bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv, int D, int DV) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         D <= 0 || DV <= 0 || D % 4 || DV % 4 || D > MAXD || DV > MAXD ||
         B > 65535 || Hkv > 65535;
}

Args make_args(const void* q, const void* k, const void* v, int Sq, int Skv,
               int Hq, int Hkv, int D, int DV, long long q_sb,
               long long q_ss, long long q_sh, long long k_sb, long long k_ss,
               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
               float scale, int causal, int kv_offset) {
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.DV = DV;
  a.rep = Hq / Hkv;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.scale = scale;
  a.causal = causal;
  a.kv_offset = kv_offset;
  return a;
}

template <typename K>
int launch(K kernel, dim3 grid, int smem_floats, const Args& a,
           void* stream) {
  const int smem = 4 * smem_floats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

dim3 row_grid(int B, int Sq, int Hq, int Hkv) {
  return dim3((Sq * (Hq / Hkv) + BR - 1) / BR, Hkv, B);
}

}  // namespace

extern "C" {

// out [B, Sq, Hq, DV] (v's dtype, contiguous) from q [B, Sq, Hq, D] fp32
// and k, v [B, Skv, Hkv, D / DV] (fp32, or bf16 when kv_bf16), element
// strides; lse [B, Hq, Sq] (fp32, contiguous) when not null. Grid
// (ceil(Sq Hq / Hkv / 32), Hkv, B).
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                        int D, int DV, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, void* lse, float scale, int causal,
                        int kv_offset, int kv_bf16, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, DV) || kv_offset < 0)
    return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, Sq, Skv, Hq, Hkv, D, DV, q_sb, q_ss, q_sh,
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                     kv_offset);
  a.o = out;
  a.lse = static_cast<float*>(lse);
  const int smem =
      BR * (D + 1) + BK * (D + 1) + BK * (DV + 1) + BR * (BK + 1);
  const dim3 grid = row_grid(B, Sq, Hq, Hkv);
  return kv_bf16 ? launch(fwd_kernel<bf16>, grid, smem, a, stream)
                 : launch(fwd_kernel<float>, grid, smem, a, stream);
}

// dq [B, Sq, Hq, D] and delta [B, Hq, Sq] = rowsum(dout * out) (fp32,
// contiguous) from q, out, dout [B, Sq, Hq, D / DV / DV], k, v [B, Skv,
// Hkv, D / DV] (fp32, element strides) and the forward's lse (fp32,
// contiguous). Grid (ceil(Sq Hq / Hkv / 32), Hkv, B).
int flash_attention_f32_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int DV, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, int causal, int kv_offset, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, DV) || kv_offset < 0)
    return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, Sq, Skv, Hq, Hkv, D, DV, q_sb, q_ss, q_sh,
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                     kv_offset);
  a.out = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.do_sb = do_sb;
  a.do_ss = do_ss;
  a.do_sh = do_sh;
  const int smem = BR * (D + 1) + BR * (DV + 1) + BK * (D + 1) +
                   BK * (DV + 1) + BR * (BK + 1);
  return launch(dq_kernel, row_grid(B, Sq, Hq, Hkv), smem, a, stream);
}

// dk, dv [B, Skv, Hkv, D / DV] (fp32, contiguous) from q, dout, k, v
// (fp32, element strides), lse and the dq launch's delta [B, Hq, Sq]
// (fp32, contiguous). Grid (ceil(Skv / 64), Hkv, B).
int flash_attention_f32_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int DV, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, int causal, int kv_offset,
    void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, DV) || kv_offset < 0)
    return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, Sq, Skv, Hq, Hkv, D, DV, q_sb, q_ss, q_sh,
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                     kv_offset);
  a.dout = static_cast<const float*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.do_sb = do_sb;
  a.do_ss = do_ss;
  a.do_sh = do_sh;
  const int smem = BK * (D + 1) + BK * (DV + 1) + BR * (D + 1) +
                   BR * (DV + 1) + 2 * BR + 2 * BK * (BR + 1);
  return launch(dkdv_kernel, dim3((Skv + BK - 1) / BK, Hkv, B), smem, a,
                stream);
}

}  // extern "C"
