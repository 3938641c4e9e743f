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
// then dkdv) whose order of sums a hand-written kernel states exactly.
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
// A product's operands come from shared memory, which serves 128 bytes a
// clock to an SM's 128 FMA lanes: a kernel that loads 4 bytes for every
// FMA or two is bound by the loads, not the FMA.
//
// Design:
//   * rows: a block's query rows are (position, head of the KV group)
//     pairs in position-major order, r = pos * rep + j for query head
//     hk * rep + j, BR = 32 of them (a row tile); so the query heads that
//     share a KV head read each K and V tile once, and the decode form
//     (Sq = 1) packs its rep heads into one block;
//   * forward: one block per (row tile, KV head, batch) walks the 64-key
//     tiles up to the last key its rows may see. Thread (ty, tx) of 8 x
//     16 holds rows 4 ty + i and keys tx + 16 j (i, j < 4) of the score
//     tile, and rows 4 ty + i, columns tx + 16 c of the output: a row's
//     max and sum reduce over its 16 lanes by shuffles; p goes through
//     shared memory (rows padded to an odd stride, D + 1) to p . v;
//   * backward, two launches: dq (with delta), then dkdv. Both are
//     templated on (D, DV): the smoke configs' pairs (8, 8), (12, 12),
//     (16, 16), (24, 16) and (32, 32), whose columns a thread and product
//     loops are fixed at compile time, and (0, 0), which reads any other
//     pair at run time. 128 threads a block; launch bounds of 4 blocks an
//     SM (128 registers a thread), 3 for dkdv where a thread holds two dv
//     / dk tasks, none at (0, 0): no instance spills;
//   * the score products (s = q . k and dp = dout . v, 64 keys x 32
//     rows): thread (lane, warp) holds keys kb + 8 i and rows rb + 4 j
//     (i, j < 4) and takes 4 columns a step by 16-byte loads of the K and
//     Q (V and dO) rows: 8 loads for 64 FMA, one step at a time (dkdv
//     writes p to shared memory before dp, so s and dp are never live
//     together, and reads it back for ds). Shared rows have a stride of
//     D or D + 4 floats, whichever is an odd number of 16-byte units, so
//     the 8 rows a quarter warp reads lie in 8 bank groups;
//   * the tiles a block streams (dq: K and V; dkdv: Q, dO, lse, delta)
//     come by cp.async (16 bytes; 4 for lse and delta, whose rows are not
//     contiguous) into a ring of NST = 2 stages, zero-filled past the end:
//     one barrier a tile for the ring, one between the scores and the
//     products that read them;
//   * dq: one block per (row tile, KV head, batch), the row tile the
//     slowest grid index and, under a causal mask, the last (heaviest)
//     first. It computes its rows' delta from dout and out first and
//     writes it for dkdv. ds^T goes through shared memory; dq's 32 x D
//     is cut into 4-row x 4-column tasks over KS key slices of each tile
//     (KS chosen so that all 128 threads have a task at D >= 8), and the
//     slices' sums are added in slice order at the end;
//   * dkdv: one cluster of S blocks (S in {1, 2, 4, 8}) per (64-key
//     tile, KV head, batch), the key tile the slowest grid index, in
//     ascending order: under a causal mask the first key tile is seen by
//     the most rows, so the heaviest clusters start first. Of the nt row
//     tiles that see the key tile (from the first position that sees its
//     first key), rank r walks [r nt / S, (r + 1) nt / S), each tile's
//     sums taken apart and then added; dv and dk are tasks of 4 keys x 4
//     columns over the tile's 32 rows (p and ds from shared memory).
//     After a cluster barrier rank r sums a disjoint 1/S of the 64 x (D +
//     DV) partials of every rank's shared memory (PTX mapa and
//     ld.shared::cluster; no cooperative_groups header, which changes the
//     forward's SASS), in rank order, scales
//     dk and stores, so no two blocks add into one row and no float
//     atomic is used. S is the smallest power of two with heavy / S <=
//     total / SLOTS (heavy: the row tiles of the most-seen key tile;
//     total: all (key tile, row tile) pairs; SLOTS = 132 SMs x 8 blocks),
//     at most 8 and at most heavy rounded up to a power of two.
//     kernels/flash_attention_bwd.py::f32_bwd_plan mirrors the choice.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError(); the dkdv
// launch is a cluster launch (cudaLaunchKernelEx), and a refused one
// returns its error.

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

// ------------------------------------------------------------ backward ---

constexpr int NST = 2;          // ring stages of the streamed tiles
constexpr int PS = BK + 8;      // dkdv: row stride of p and ds, [BR][BK]
constexpr int PT = BR + 4;      // dq: row stride of ds^T, [BK][BR]
constexpr int MAX_SPLIT = 8;    // dkdv: blocks of one cluster, at most
constexpr int SLOTS = 132 * 8;  // dkdv's split: 132 SMs x 8 blocks

// a shared row's stride: n or n + 4 floats, an odd number of 16 bytes
__host__ __device__ constexpr int pad4(int n) {
  return (n / 4) % 2 ? n : n + 4;
}
// dq's key slices: the largest power of two up to 8 with 8 row groups x
// nq column quads x slices <= THREADS
__host__ __device__ constexpr int key_slices(int nq) {
  int ks = 8;
  while (ks > 1 && 8 * nq * ks > THREADS) ks /= 2;
  return ks;
}
// tasks a thread: dkdv's 16 key quads x (D + DV) / 4 column quads, dq's 8
// row quads x D / 4 column quads x key slices
__host__ __device__ constexpr int dkdv_tasks(int d, int dv) {
  return 16 * (d / 4 + dv / 4);
}
__host__ __device__ constexpr int dq_tasks(int d, int ks) {
  return 8 * (d / 4) * ks;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// cp.async of 16 (or 4) bytes, zero-filled when !ok (src-size 0)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the thread-block cluster: this block's rank, a barrier of all its
// blocks (their shared-memory writes before it seen by all after it), and
// a 16-byte load from the shared memory of the block of rank `rank`
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float4 cluster_load(const float4* p, int rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// rows [0, R) of an R x W tile (row i at src(i)) into shared rows of
// stride SW by 16-byte cp.async, zeros from row n on
template <typename F>
__device__ __forceinline__ void copy_rows(float* s, int R, int W, int SW,
                                          int n, F src) {
  const int per = W / 4;
  for (int e = threadIdx.x; e < R * per; e += THREADS) {
    const int i = e / per, c = 4 * (e % per);
    cp16(s + i * SW + c, src(min(i, n - 1)) + c, i < n);
  }
}

// s[i][j] += A row 8 i . B row 4 j over w columns, 4 at a time in column
// order (A and B point at the thread's first key and row); one step at a
// time, so that its 8 float4 are the only loads live
__device__ __forceinline__ void scores(float (&s)[4][4], const float* A,
                                       int SA, const float* B, int SB,
                                       int w) {
#pragma unroll 1
  for (int d = 0; d < w; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + 8 * i * SA + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(B + 4 * j * SB + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// t[i][c] += x[i] * y[c]: one row of a 4 x 4 task
__device__ __forceinline__ void outer4(float (&t)[4][4], float4 x, float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) t[i][c] = fmaf(xs[i], ys[c], t[i][c]);
}

// The backward's arguments: Args and its grid
struct Bwd : Args {
  int B;      // batch
  int split;  // dkdv: blocks of one cluster
};

// The head sizes of one instance: compile-time, or (0, 0) read from the
// arguments
template <int D_, int DV_>
struct Dims {
  static constexpr bool GEN = D_ == 0;
  static constexpr int KS = GEN ? 1 : key_slices(D_ / 4);
  static constexpr int DQ_TPT =
      (dq_tasks(GEN ? MAXD : D_, KS) + THREADS - 1) / THREADS;
  static constexpr int DKDV_TPT =
      (dkdv_tasks(GEN ? MAXD : D_, GEN ? MAXD : DV_) + THREADS - 1) / THREADS;
  // dkdv's launch bounds and rows unrolled: 4 blocks an SM (128
  // registers) where a thread has one task, 3 (168) where it has two
  static constexpr int DKDV_BLOCKS = GEN ? 1 : DKDV_TPT == 1 ? 4 : 3;
  static constexpr int ROW_UNROLL = DKDV_TPT == 1 ? 8 : 4;
  int D, DV, SD, SDV;
  __device__ explicit Dims(const Args& a)
      : D(GEN ? a.D : D_), DV(GEN ? a.DV : DV_), SD(pad4(D)),
        SDV(pad4(DV)) {}
};

// ----------------------------------------------------------------- dq ---

// one key tile of a dq block: ds^T from s and dp, then its tasks' sums
template <int D_, int DV_>
__device__ __forceinline__ void dq_tile(
    const Args& a, const Dims<D_, DV_>& n, const float* Qs, const float* dOs,
    const float* Ls, const float* Dl, const float* Ks, const float* Vs,
    float* St, float (&acc)[Dims<D_, DV_>::DQ_TPT][4][4], int r0, int k0,
    int nrows, int kb, int rb) {
  using Dm = Dims<D_, DV_>;
  float s[4][4] = {}, dp[4][4] = {};
  scores(s, Ks + kb * n.SD, n.SD, Qs + rb * n.SD, n.SD, n.D);
  scores(dp, Vs + kb * n.SDV, n.SDV, dOs + rb * n.SDV, n.SDV, n.DV);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rr = rb + 4 * j;
    const int pos = row_pos(a, min(r0 + rr, nrows - 1));
    const float l = Ls[rr], dl = Dl[rr];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kb + 8 * i;
      const float p = masked(a, pos, k0 + key)
                          ? 0.f
                          : expf(s[i][j] * a.scale - l);
      St[key * PT + rr] = p * (dp[i][j] - dl);
    }
  }
  __syncthreads();  // ds^T in place
  // dq += ds . k: rows 4 rg + i, columns 4 qd + c, the keys of slice ks
  constexpr int SL = BK / Dm::KS;
  const int nq = n.D / 4;
#pragma unroll
  for (int u = 0; u < Dm::DQ_TPT; ++u) {
    const int task = threadIdx.x + THREADS * u;
    if (task >= dq_tasks(n.D, Dm::KS)) continue;
    const int rg = task % 8, qd = (task / 8) % nq, ks = task / (8 * nq);
    const float* sp = St + ks * SL * PT + 4 * rg;
    const float* kp = Ks + ks * SL * n.SD + 4 * qd;
#pragma unroll 8
    for (int key = 0; key < SL; ++key)
      outer4(acc[u], *reinterpret_cast<const float4*>(sp + key * PT),
             *reinterpret_cast<const float4*>(kp + key * n.SD));
  }
}

template <int D_, int DV_>
__global__ void __launch_bounds__(THREADS, D_ ? 4 : 1) dq_kernel(const Bwd a) {
  using Dm = Dims<D_, DV_>;
  const Dm n(a);
  extern __shared__ float4 bwd_smem[];
  float* smem = reinterpret_cast<float*>(bwd_smem);
  float* Qs = smem;                        // [BR][SD]
  float* dOs = Qs + BR * n.SD;             // [BR][SDV]
  float* Ls = dOs + BR * n.SDV;            // [BR] lse
  float* Dl = Ls + BR;                     // [BR] delta
  float* St = Dl + BR;                     // [BK][PT]: ds^T
  float* ring = St + BK * PT;              // NST x {K [BK][SD], V [BK][SDV]}
  const int stage = BK * (n.SD + n.SDV);
  const int nrows = a.Sq * a.rep, nrt = (nrows + BR - 1) / BR;
  // the row tile slowest, the heaviest first
  const int bh = blockIdx.x % (a.B * a.Hkv), order = blockIdx.x / (a.B * a.Hkv);
  const int hk = bh % a.Hkv, b = bh / a.Hkv;
  const int r0 = (a.causal ? nrt - 1 - order : order) * BR;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto row_of = [&](const float* base, long long sb, long long ss,
                    long long sh, int r) {
    return base + b * sb + (long long)row_pos(a, r) * ss +
           (hk * a.rep + r % a.rep) * sh;
  };
  auto load_kv = [&](int k0, int st) {
    float* Ks = ring + st * stage;
    copy_rows(Ks, BK, n.D, n.SD, a.Skv - k0,
              [&](int i) { return kg + (k0 + i) * a.k_ss; });
    copy_rows(Ks + BK * n.SD, BK, n.DV, n.SDV, a.Skv - k0,
              [&](int i) { return vg + (k0 + i) * a.v_ss; });
  };
  copy_rows(Qs, BR, n.D, n.SD, nrows - r0,
            [&](int i) { return q_row(a, b, hk, r0 + i); });
  copy_rows(dOs, BR, n.DV, n.SDV, nrows - r0, [&](int i) {
    return row_of(a.dout, a.do_sb, a.do_ss, a.do_sh, r0 + i);
  });
  cp_commit();
  const int kv_end = kv_end_of(a, r0, nrows);
  const int nk = (kv_end + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nk) load_kv(s * BK, s);
    cp_commit();
  }
  cp_wait<NST - 1>();
  __syncthreads();  // Q and dO in place
  // each row's lse and delta = rowsum(dout * out): 4 threads a row, column
  // quads sub + 4 c in order, then summed over the 4 lanes
  {
    const int rr = threadIdx.x / 4, sub = threadIdx.x % 4;
    const int r = min(r0 + rr, nrows - 1);
    const float* orow = row_of(a.out, a.o_sb, a.o_ss, a.o_sh, r);
    float sum = 0.f;
    for (int c = 4 * sub; c < n.DV; c += 16) {
      const float4 o = *reinterpret_cast<const float4*>(orow + c);
      const float4 g = *reinterpret_cast<const float4*>(dOs + rr * n.SDV + c);
      sum = fmaf(g.x, o.x, sum);
      sum = fmaf(g.y, o.y, sum);
      sum = fmaf(g.z, o.z, sum);
      sum = fmaf(g.w, o.w, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (sub == 0) {
      const long long st = stat_row(a, b, hk, r);
      Dl[rr] = sum;
      Ls[rr] = a.lse[st];
      if (r0 + rr < nrows) a.delta[st] = sum;
    }
  }
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kb = (w & 1) * 32 + (lane & 7), rb = (w >> 1) * 16 + (lane >> 3);
  float acc[Dm::DQ_TPT][4][4] = {};
  for (int it = 0; it < nk; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();  // tile it landed; tile it - 1 and its ds^T are read
    const float* Ks = ring + (it % NST) * stage;
    if (it + NST - 1 < nk) load_kv((it + NST - 1) * BK, (it + NST - 1) % NST);
    cp_commit();
    dq_tile<D_, DV_>(a, n, Qs, dOs, Ls, Dl, Ks, Ks + BK * n.SD, St, acc,
                     r0, it * BK, nrows, kb, rb);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the slices' sums go there
  float* part = ring;  // [KS][BR][D]
  const int nq = n.D / 4;
#pragma unroll
  for (int u = 0; u < Dm::DQ_TPT; ++u) {
    const int task = threadIdx.x + THREADS * u;
    if (task >= dq_tasks(n.D, Dm::KS)) continue;
    const int rg = task % 8, qd = (task / 8) % nq, ks = task / (8 * nq);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(part + (ks * BR + 4 * rg + i) * n.D +
                                 4 * qd) =
          make_float4(acc[u][i][0], acc[u][i][1], acc[u][i][2], acc[u][i][3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BR * nq; e += THREADS) {
    const int rr = e / nq, c = 4 * (e % nq), r = r0 + rr;
    if (r >= nrows) continue;
    float4 sum = *reinterpret_cast<const float4*>(part + rr * n.D + c);
#pragma unroll
    for (int ks = 1; ks < Dm::KS; ++ks) {
      const float4 x =
          *reinterpret_cast<const float4*>(part + (ks * BR + rr) * n.D + c);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const long long row =
        (((long long)b * a.Sq + row_pos(a, r)) * a.Hq + hk * a.rep +
         r % a.rep) * n.D;
    *reinterpret_cast<float4*>(a.dq + row + c) =
        make_float4(sum.x * a.scale, sum.y * a.scale, sum.z * a.scale,
                    sum.w * a.scale);
  }
}

// --------------------------------------------------------------- dkdv ---

// one row tile of a dkdv block: p and ds from s and dp, then each task's
// sums over the tile's rows, taken apart and added to its running sums
template <int D_, int DV_>
__device__ __forceinline__ void dkdv_tile(
    const Args& a, const Dims<D_, DV_>& n, const float* Ks, const float* Vs,
    const float* Qs, float* Ps, float* Ss,
    float (&acc)[Dims<D_, DV_>::DKDV_TPT][4][4], int r0, int k0, int nrows,
    int kb, int rb) {
  using Dm = Dims<D_, DV_>;
  const float* dOs = Qs + BR * n.SD;
  const float* Ls = dOs + BR * n.SDV;
  const float* Dl = Ls + BR;
  // p first, to shared memory, so that s and dp are never live together
  {
    float s[4][4] = {};
    scores(s, Ks + kb * n.SD, n.SD, Qs + rb * n.SD, n.SD, n.D);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = rb + 4 * j, r = r0 + rr;
      const int pos = row_pos(a, min(r, nrows - 1));
      const float l = Ls[rr];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + 8 * i;
        Ps[rr * PS + key] = (r >= nrows || masked(a, pos, k0 + key))
                                ? 0.f
                                : expf(s[i][j] * a.scale - l);
      }
    }
  }
  float dp[4][4] = {};
  scores(dp, Vs + kb * n.SDV, n.SDV, dOs + rb * n.SDV, n.SDV, n.DV);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rr = rb + 4 * j;
    const float dl = Dl[rr];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kb + 8 * i;
      Ss[rr * PS + key] = Ps[rr * PS + key] * (dp[i][j] - dl);
    }
  }
  __syncthreads();  // p and ds in place
  // dv += p^T . dout (tasks below 16 DV / 4), dk += ds^T . q: keys 4 kq +
  // i, columns 4 qd + c, the tile's 32 rows in order
  const int nqv = n.DV / 4;
#pragma unroll
  for (int u = 0; u < Dm::DKDV_TPT; ++u) {
    const int task = threadIdx.x + THREADS * u;
    if (task >= dkdv_tasks(n.D, n.DV)) continue;
    const int kq = task % 16, qi = task / 16;
    const bool is_v = qi < nqv;
    const float* xp = (is_v ? Ps : Ss) + 4 * kq;
    const float* yp = is_v ? dOs + 4 * qi : Qs + 4 * (qi - nqv);
    const int sy = is_v ? n.SDV : n.SD;
    float t[4][4] = {};
#pragma unroll (Dm::ROW_UNROLL)
    for (int r = 0; r < BR; ++r)
      outer4(t, *reinterpret_cast<const float4*>(xp + r * PS),
             *reinterpret_cast<const float4*>(yp + r * sy));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][i][c] += t[i][c];
  }
}

template <int D_, int DV_>
__global__ void __launch_bounds__(THREADS, Dims<D_, DV_>::DKDV_BLOCKS)
    dkdv_kernel(const Bwd a) {
  using Dm = Dims<D_, DV_>;
  const Dm n(a);
  extern __shared__ float4 bwd_smem[];
  float* smem = reinterpret_cast<float*>(bwd_smem);
  float* Ks = smem;                        // [BK][SD]
  float* Vs = Ks + BK * n.SD;              // [BK][SDV]
  float* ring = Vs + BK * n.SDV;           // NST x {Q, dO, lse, delta}
  const int stage = BR * (n.SD + n.SDV) + 2 * BR;
  float* Ps = ring + NST * stage;          // [BR][PS]: p
  float* Ss = Ps + BR * PS;                // [BR][PS]: ds
  const int S = a.split, rank = cluster_rank();
  // the key tile slowest, ascending: the heaviest first
  const int cl = blockIdx.x / S;
  const int hk = cl % a.Hkv, b = (cl / a.Hkv) % a.B;
  const int k0 = cl / (a.Hkv * a.B) * BK;
  const int nrows = a.Sq * a.rep, nrt = (nrows + BR - 1) / BR;
  // the row tiles that see key k0 (from the first position that sees it),
  // and this rank's share of them
  const int first = a.causal ? max(0, k0 - a.kv_offset) * a.rep : 0;
  const int t0 = min(first / BR, nrt), nt = nrt - t0;
  const int t_begin = t0 + rank * nt / S, t_end = t0 + (rank + 1) * nt / S;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto load_tile = [&](int t, int st) {
    float* Qs = ring + st * stage;
    const int r0 = t * BR;
    copy_rows(Qs, BR, n.D, n.SD, nrows - r0,
              [&](int i) { return q_row(a, b, hk, r0 + i); });
    copy_rows(Qs + BR * n.SD, BR, n.DV, n.SDV, nrows - r0, [&](int i) {
      const int r = r0 + i;
      return a.dout + b * a.do_sb + (long long)row_pos(a, r) * a.do_ss +
             (hk * a.rep + r % a.rep) * a.do_sh;
    });
    if (threadIdx.x < 2 * BR) {
      const int r = r0 + threadIdx.x % BR;
      cp4(Qs + BR * (n.SD + n.SDV) + threadIdx.x,
          (threadIdx.x < BR ? a.lse : a.delta) +
              stat_row(a, b, hk, min(r, nrows - 1)),
          r < nrows);
    }
  };
  copy_rows(Ks, BK, n.D, n.SD, a.Skv - k0,
            [&](int i) { return kg + (k0 + i) * a.k_ss; });
  copy_rows(Vs, BK, n.DV, n.SDV, a.Skv - k0,
            [&](int i) { return vg + (k0 + i) * a.v_ss; });
  const int nmine = t_end - t_begin;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nmine) load_tile(t_begin + s, s);
    cp_commit();
  }
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kb = (w & 1) * 32 + (lane & 7), rb = (w >> 1) * 16 + (lane >> 3);
  float acc[Dm::DKDV_TPT][4][4] = {};
  for (int it = 0; it < nmine; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();  // tile it landed; tile it - 1, p and ds are read
    if (it + NST - 1 < nmine)
      load_tile(t_begin + it + NST - 1, (it + NST - 1) % NST);
    cp_commit();
    dkdv_tile<D_, DV_>(a, n, Ks, Vs, ring + (it % NST) * stage, Ps, Ss, acc,
                       (t_begin + it) * BR, k0, nrows, kb, rb);
  }
  cp_wait<0>();
  __syncthreads();  // shared memory is free: the partials go to its start
  // this rank's partial sums: dk [BK][D], then dv [BK][DV]
  float* part = smem;
  const int nqv = n.DV / 4;
#pragma unroll
  for (int u = 0; u < Dm::DKDV_TPT; ++u) {
    const int task = threadIdx.x + THREADS * u;
    if (task >= dkdv_tasks(n.D, n.DV)) continue;
    const int kq = task % 16, qi = task / 16;
    const bool is_v = qi < nqv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 4 * kq + i;
      float* dst = is_v ? part + BK * n.D + key * n.DV + 4 * qi
                        : part + key * n.D + 4 * (qi - nqv);
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[u][i][0], acc[u][i][1], acc[u][i][2], acc[u][i][3]);
    }
  }
  cluster_sync();  // every rank's partials in place
  // this rank's 1/S of the float4s: the ranks' partials in rank order
  const float4* part4 = reinterpret_cast<const float4*>(part);
  auto part4_of = [&](int e, int src) { return cluster_load(part4 + e, src); };
  const int nv = BK * (n.D + n.DV) / 4;
  for (int e = rank * nv / S + threadIdx.x; e < (rank + 1) * nv / S;
       e += THREADS) {
    float4 sum = part4_of(e, 0);
    for (int src = 1; src < S; ++src) {
      const float4 x = part4_of(e, src);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int f = 4 * e;
    const bool is_k = f < BK * n.D;
    const int width = is_k ? n.D : n.DV, g = is_k ? f : f - BK * n.D;
    const int key = k0 + g / width, col = g % width;
    if (key >= a.Skv) continue;
    const long long row = ((long long)b * a.Skv + key) * a.Hkv + hk;
    if (is_k)
      *reinterpret_cast<float4*>(a.dk + row * n.D + col) =
          make_float4(sum.x * a.scale, sum.y * a.scale, sum.z * a.scale,
                      sum.w * a.scale);
    else
      *reinterpret_cast<float4*>(a.dv + row * n.DV + col) = sum;
  }
  cluster_sync();  // no block leaves while another still reads its partials
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

template <typename K, typename A>
int launch(K kernel, dim3 grid, int smem_floats, const A& a, void* stream) {
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

// The backward's instances: the smoke configs' (D, DV) pairs, and (0, 0)
// for every other one
template <int D_, int DV_>
struct Pair {
  static constexpr int D = D_, DV = DV_;
};
template <typename F>
int with_pair(int D, int DV, F f) {
  if (D == 8 && DV == 8) return f(Pair<8, 8>{});
  if (D == 12 && DV == 12) return f(Pair<12, 12>{});
  if (D == 16 && DV == 16) return f(Pair<16, 16>{});
  if (D == 24 && DV == 16) return f(Pair<24, 16>{});
  if (D == 32 && DV == 32) return f(Pair<32, 32>{});
  return f(Pair<0, 0>{});
}

// shared memory, in floats: dq's Q, dO, lse, delta, ds^T and K / V ring
// (whose room takes the KS slices' sums at the end); dkdv's K, V, Q / dO
// / lse / delta ring and p, ds (whose room takes the partials)
int dq_smem_floats(int D, int DV, int ks) {
  const int ring = NST * BK * (pad4(D) + pad4(DV));
  return BR * (pad4(D) + pad4(DV)) + 2 * BR + BK * PT +
         (ring > ks * BR * D ? ring : ks * BR * D);
}
int dkdv_smem_floats(int D, int DV) {
  const int all = BK * (pad4(D) + pad4(DV)) +
                  NST * (BR * (pad4(D) + pad4(DV)) + 2 * BR) + 2 * BR * PS;
  return all > BK * (D + DV) ? all : BK * (D + DV);
}

// dkdv's blocks a cluster (see the header)
int dkdv_split(const Args& a) {
  const int nrows = a.Sq * a.rep, nrt = (nrows + BR - 1) / BR;
  long long total = 0;
  int heavy = 0;
  for (int k0 = 0; k0 < a.Skv; k0 += BK) {
    const int first = a.causal ? max(0, k0 - a.kv_offset) * a.rep : 0;
    const int nt = nrt - min(first / BR, nrt);
    total += nt;
    heavy = max(heavy, nt);
  }
  int s = 1;
  while (s < MAX_SPLIT && s < heavy && (long long)heavy * SLOTS > s * total)
    s *= 2;
  return s;
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
// contiguous). Grid ceil(Sq Hq / Hkv / 32) x Hkv x B, one dimension.
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
  Bwd a;
  static_cast<Args&>(a) =
      make_args(q, k, v, Sq, Skv, Hq, Hkv, D, DV, q_sb, q_ss, q_sh, k_sb,
                k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, kv_offset);
  a.B = B;
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
  const dim3 grid((Sq * (Hq / Hkv) + BR - 1) / BR * Hkv * B);
  return with_pair(D, DV, [&](auto p) {
    using P = decltype(p);
    const int ks = P::D ? key_slices(P::D / 4) : 1;
    return launch(dq_kernel<P::D, P::DV>, grid, dq_smem_floats(D, DV, ks),
                  a, stream);
  });
}

// dk, dv [B, Skv, Hkv, D / DV] (fp32, contiguous) from q, dout, k, v
// (fp32, element strides), lse and the dq launch's delta [B, Hq, Sq]
// (fp32, contiguous). Grid ceil(Skv / 64) x Hkv x B clusters of
// dkdv_split blocks, one dimension.
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
  Bwd a;
  static_cast<Args&>(a) =
      make_args(q, k, v, Sq, Skv, Hq, Hkv, D, DV, q_sb, q_ss, q_sh, k_sb,
                k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, kv_offset);
  a.B = B;
  a.dout = static_cast<const float*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.do_sb = do_sb;
  a.do_ss = do_ss;
  a.do_sh = do_sh;
  a.split = dkdv_split(a);
  return with_pair(D, DV, [&](auto p) {
    using P = decltype(p);
    auto kernel = dkdv_kernel<P::D, P::DV>;
    const int smem = 4 * dkdv_smem_floats(D, DV);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((Skv + BK - 1) / BK * Hkv * B * a.split);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
