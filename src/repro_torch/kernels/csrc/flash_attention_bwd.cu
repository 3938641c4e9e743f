// Flash attention (backward) for Hopper (sm_90a), on bf16 tensor cores.
//
// Replaces the gradient of src/repro/models/layers.py blockwise_attention,
// which the reference's training takes by XLA autodiff of that pure-JAX
// schedule (its Pallas kernel, src/repro/kernels/flash_attention.py, has
// no backward). In the port the forward of that schedule is
// flash_attention.cu, so its gradient is a kernel too: these three entry
// points, called by kernels/flash_attention.py's autograd Function.
//
// Layout. q [B, Sq, Hq, D], k / v [B, Skv, Hkv, D], o / dout [B, Sq, Hq,
// D], bf16, given by element strides (batch, sequence, head) that are
// multiples of 8 with the last dimension contiguous and 16-byte aligned
// rows; dq [B, Sq, Hq, D] and dk / dv [B, Skv, Hkv, D] bf16, contiguous;
// lse (the forward's m + log l) and delta [B, Hq, Sq] fp32, contiguous.
// D in {64, 128}, keys and values of one size. Query head h reads KV head
// h / (Hq / Hkv).
//
// Numerics (FlashAttention-2's backward): with s = (q . k) * scale masked
// as the forward masks it (-inf past Skv, and where causal, key > query +
// kv_offset),
//   p     = exp(s - lse), fp32, by ex2.approx (the forward's exponent);
//   delta = rowsum(dout * o), fp32 (entry point flash_attention_bwd_prep);
//   dv   += p^T . dout with p rounded to bf16, as the forward rounds p
//           before p . v (that cast's gradient is the identity);
//   dp    = dout . v^T, fp32;
//   ds    = p * (dp - delta), rounded to bf16 for the two products below;
//   dk   += ds^T . q, dq += ds . k, both times scale at the end;
// fp32 accumulators, bf16 outputs.
//
// What bounds it on an H100. Five products of 2 Sq Skv D a (batch, query
// head) (s twice, dp twice, dv, dk, dq: the two kernels each recompute s
// and dp), halved when causal, against the bytes of q, k, v, o, dout, lse,
// delta, dq, dk and dv. At seamless-m4t's training shape (B 8, S 256, 16
// heads of 64) that is 1.4 GFLOP (~1.4 us at 989 TFLOP/s) against 25 MB
// (~7.5 us at 3.35 TB/s): bytes bound it, and with them a launch's
// latency. At S 2048 with 32 query heads the 69 GFLOP bound it (~70 us).
//
// Design (the simple form; wgmma and TMA are later work):
//   * prep: one thread per 16-byte chunk of a row of o and dout, the
//     row's chunks reduced by shuffles within the warp;
//   * dkdv: one block of 4 warps per (64-key tile, KV head, batch); each
//     warp owns 16 keys and keeps their dk and dv in fp32 registers while
//     the block walks every query tile of every query head of its group,
//     so no two blocks write one dk or dv row and no atomics are needed.
//     The K and V tiles are loaded once; the query and dout tiles (QT rows:
//     64 at D 64, 32 at D 128, which keeps the score and dp tiles to 16
//     registers each beside the 128 of dk and dv) and their lse and delta
//     stream through a 2-stage cp.async ring. Query tiles wholly below the
//     causal diagonal's first key are not visited; a tile past the last
//     query a key can be seen by is not reached;
//   * dq: one block of 4 warps per (64-row query tile, query head, batch),
//     each warp 16 rows, as the forward's prefill form: the Q and dout
//     tiles are loaded once and the K and V tiles stream through a 2-stage
//     ring, tiles wholly above the diagonal skipped;
//   * every product is mma.sync m16n8k16 bf16 -> fp32. A fragments come
//     from ldmatrix.x4 on a tile's rows (or from the C fragments of p and
//     ds, packed by cvt.rn.bf16x2.f32), B fragments from ldmatrix.x4 where
//     the tile is [n][k] and ldmatrix.x4.trans where it is [k][n]. Rows are
//     16-byte chunks swizzled by (row & 7), as in the forward.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 64;    // dq: query rows per block (4 warps x 16)
constexpr int BKV = 64;   // keys per tile (dkdv: per block, 4 warps x 16)
constexpr int NST = 2;    // ring stages
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Sq, Skv, Hq, Hkv, rep;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  float scale, scale_log2;
  int causal, kv_offset;
};

// Element offset of 16-byte chunk `chunk` of row `row` in a [rows][D]
// tile whose chunks are swizzled by (row & 7) (D a multiple of 64).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// The offset within a row of chunk 2 i + c0, z = c0 ^ (row & 7) (see
// flash_attention.cu).
__device__ __forceinline__ int swz_step(int i, int z) {
  return (((2 * i) & ~7) + (((2 * i) & 7) ^ z)) << 3;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += a . b on one m16n8k16 tile (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, n) of an NROWS x D tile from g (row stride ld) into its
// swizzled shared tile by 16-byte cp.async; rows from n on are zeros.
template <int D, int NROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long ld, int n, int tid) {
  constexpr int CH = D / 8;
  static_assert(NROWS * CH % THREADS == 0, "tile chunks per thread");
#pragma unroll
  for (int it = 0; it < NROWS * CH / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i / CH, c = i % CH;
    const bool ok = r < n;
    cp_async16(s + swz<D>(r, c), g + (ok ? r * ld : 0) + c * 8, ok);
  }
}

// The C tile [16 rows][NB * 8 cols] += A . B^T where A is the warp's 16
// rows of a swizzled [.][D] tile (a_lane points at the lane's row) and B
// the rows [0, NB * 8) of another swizzled [.][D] tile: a product over D.
template <int D, int NB>
__device__ __forceinline__ void mma_abt(float (&c)[NB][4], const bf16* a_lane,
                                        const bf16* b, int brow, int za,
                                        int zb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_lane + swz_step(kk, za));
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (brow + 16 * jj) * D + swz_step(kk, zb));
      mma_bf16(c[2 * jj], af, bf[0], bf[1]);
      mma_bf16(c[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc [16 rows][D] += P . T where P is [16 rows][NB * 8] in C fragments
// (rounded to bf16 here) and T the rows [0, NB * 8) of a swizzled [.][D]
// tile: a product over P's columns.
template <int D, int NB>
__device__ __forceinline__ void mma_pt(float (&acc)[D / 8][4],
                                       const float (&p)[NB][4], const bf16* t,
                                       int trow, int zt) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t tf[4];
      ldsm_x4_trans(tf, t + (trow + 16 * kk) * D + swz_step(jj, zt));
      mma_bf16(acc[2 * jj], pa, tf[0], tf[1]);
      mma_bf16(acc[2 * jj + 1], pa, tf[2], tf[3]);
    }
  }
}

// delta[b, h, s] = sum_d dout[b, s, h, d] * o[b, s, h, d] in fp32; one
// thread per 16-byte chunk, a row's D / 8 chunks on neighbouring lanes.
template <int D>
__global__ void __launch_bounds__(THREADS)
    prep_kernel(const bf16* o, const bf16* dout, float* delta, int Sq, int Hq,
                long long rows, long long o_sb, long long o_ss, long long o_sh,
                long long do_sb, long long do_ss, long long do_sh) {
  constexpr int CH = D / 8;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = i / CH;  // (b * Hq + h) * Sq + s
  const int c = (int)(i % CH);
  float sum = 0.f;
  if (row < rows) {
    const int s = (int)(row % Sq);
    const long long bh = row / Sq;
    const int h = (int)(bh % Hq);
    const long long b = bh / Hq;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * o_sb + s * o_ss + h * o_sh + c * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * do_sb + s * do_ss + h * do_sh + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 df = __bfloat1622float2(d2[e]);
      sum += of.x * df.x + of.y * df.y;
    }
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && c == 0) delta[row] = sum;
}

// dk and dv of one 64-key tile of one KV head of one batch.
template <int D, int QT>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Args a) {
  constexpr int NB = QT / 8;       // n-blocks of a score tile (queries)
  constexpr int DN = D / 8;        // n-blocks of dk / dv
  constexpr int TILE = QT * D;     // elements of a Q or dout tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * D;
  bf16* ring = Vs + BKV * D;                                 // [NST][Q, dO]
  float* Ls = reinterpret_cast<float*>(ring + NST * 2 * TILE);  // [NST][QT]
  float* Ds = Ls + NST * QT;                                     // [NST][QT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;

  // query tiles: from the first that can see key k0, over the rep heads
  int qt0 = 0;
  if (a.causal) qt0 = max(0, k0 - a.kv_offset) / QT;
  const int n_qt = (a.Sq + QT - 1) / QT;
  const int nq = max(0, n_qt - qt0);
  const int n_tiles = a.rep * nq;

  auto tile_head = [&](int t) { return hk * a.rep + t / nq; };
  auto tile_q0 = [&](int t) { return (qt0 + t % nq) * QT; };
  auto issue_tile = [&](int t) {
    const int h = tile_head(t), q0 = tile_q0(t);
    bf16* qs = ring + (t % NST) * 2 * TILE;
    load_tile<D, QT>(qs, a.q + b * a.q_sb + h * a.q_sh + q0 * a.q_ss,
                     a.q_ss, a.Sq - q0, tid);
    load_tile<D, QT>(qs + TILE,
                     a.dout + b * a.do_sb + h * a.do_sh + q0 * a.do_ss,
                     a.do_ss, a.Sq - q0, tid);
    if (tid < QT) {
      const int r = q0 + tid;
      const long long row = ((long long)b * a.Hq + h) * a.Sq + r;
      Ls[(t % NST) * QT + tid] = r < a.Sq ? a.lse[row] * LOG2E : 0.f;
      Ds[(t % NST) * QT + tid] = r < a.Sq ? a.delta[row] : 0.f;
    }
  };

  load_tile<D, BKV>(Ks, a.k + b * a.k_sb + hk * a.k_sh + k0 * a.k_ss,
                    a.k_ss, a.Skv - k0, tid);
  load_tile<D, BKV>(Vs, a.v + b * a.v_sb + hk * a.v_sh + k0 * a.v_ss,
                    a.v_ss, a.Skv - k0, tid);
  if (n_tiles > 0) issue_tile(0);
  cp_async_commit();

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the lane's ldmatrix rows: A rows 16 warp + (lane & 15) of K / V; B rows
  // (lane & 7) + 8 (lane >> 4) of a [queries][D] tile, non-transposed; T
  // rows (lane & 15) of it, transposed
  const int arow = 16 * warp + (lane & 15);
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int trow = lane & 15;
  const int za = (lane >> 4) ^ (lane & 7);
  const int zb = ((lane >> 3) & 1) ^ (lane & 7);
  // the thread's keys: rows g and g + 8 of the warp's 16
  const int kw0 = k0 + 16 * warp;
  const int kpos[2] = {kw0 + g, kw0 + g + 8};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t (and K, V) landed; tile t - 1 read by all
    if (t + 1 < n_tiles) issue_tile(t + 1);
    cp_async_commit();
    const bf16* qs = ring + (t % NST) * 2 * TILE;
    const bf16* dos = qs + TILE;
    const float* ls = Ls + (t % NST) * QT;
    const float* ds = Ds + (t % NST) * QT;
    const int q0 = tile_q0(t);
    // the warp's keys are all past Skv, or all above every query of the
    // tile: nothing to add
    if (kw0 >= a.Skv ||
        (a.causal && kw0 > min(q0 + QT, a.Sq) - 1 + a.kv_offset))
      continue;
    const bool edge = kw0 + 16 > a.Skv || q0 + QT > a.Sq ||
                      (a.causal && kw0 + 15 > q0 + a.kv_offset);

    // s^T = K Q^T and dp^T = V dout^T over the warp's 16 keys x QT queries
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D, NB>(s, Ks + arow * D, qs, brow, za, zb);
    mma_abt<D, NB>(dp, Vs + arow * D, dos, brow, za, zb);

    // element e of n-block j: key kpos[e / 2], query q0 + 8 j + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        float p = fast_exp2(s[j][e] * a.scale_log2 - ls[c]);
        if (edge) {
          const int qpos = q0 + c, key = kpos[e >> 1];
          if (qpos >= a.Sq || key >= a.Skv ||
              (a.causal && key > qpos + a.kv_offset))
            p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ds[c]);
      }
    }
    mma_pt<D, NB>(dv, s, dos, trow, za);   // dv += p^T . dout
    mma_pt<D, NB>(dk, dp, qs, trow, za);   // dk += ds^T . q
  }
  cp_async_wait<0>();  // a block with no query tile issued K and V only

  // rows g and g + 8 of the warp's keys
  const long long base = ((long long)b * a.Skv) * a.Hkv + hk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kpos[i];
    if (key >= a.Skv) continue;
    const long long off = (base + (long long)key * a.Hkv) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * n) =
          __floats2bfloat162_rn(dk[n][2 * i] * a.scale,
                                dk[n][2 * i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * n) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// dq of one 64-row query tile of one query head of one batch.
template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  constexpr int NB = BKV / 8;      // n-blocks of a score tile (keys)
  constexpr int DN = D / 8;        // n-blocks of dq
  constexpr int TILE = BKV * D;    // elements of a K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * D;
  bf16* ring = dOs + BQ * D;  // [NST][K, V]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.rep;
  const int n_qb = gridDim.z;
  // causal: the query tiles with the most KV tiles start first
  const int q0 = BQ * (a.causal ? n_qb - 1 - (int)blockIdx.z
                                : (int)blockIdx.z);
  const bf16* kg = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vg = a.v + b * a.v_sb + hk * a.v_sh;

  const int r0 = q0 + 16 * warp;
  const int qpos[2] = {r0 + g + a.kv_offset, r0 + g + 8 + a.kv_offset};
  const int qlo = r0 + a.kv_offset;
  const int qhi = min(r0 + 16, a.Sq) - 1 + a.kv_offset;
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, min(q0 + BQ, a.Sq) + a.kv_offset);
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  auto issue_tile = [&](int t) {
    bf16* ks = ring + (t % NST) * 2 * TILE;
    const int kt = t * BKV;
    load_tile<D, BKV>(ks, kg + kt * a.k_ss, a.k_ss, a.Skv - kt, tid);
    load_tile<D, BKV>(ks + TILE, vg + kt * a.v_ss, a.v_ss, a.Skv - kt, tid);
  };
  load_tile<D, BQ>(Qs, a.q + b * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss,
                   a.Sq - q0, tid);
  load_tile<D, BQ>(dOs, a.dout + b * a.do_sb + h * a.do_sh + q0 * a.do_ss,
                   a.do_ss, a.Sq - q0, tid);
  if (n_tiles > 0) issue_tile(0);
  cp_async_commit();

  // the thread's rows g and g + 8: lse in base 2 and delta
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    const long long row = ((long long)b * a.Hq + h) * a.Sq + r;
    l2[i] = r < a.Sq ? a.lse[row] * LOG2E : 0.f;
    dl[i] = r < a.Sq ? a.delta[row] : 0.f;
  }

  float dq[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int arow = 16 * warp + (lane & 15);
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int trow = lane & 15;
  const int za = (lane >> 4) ^ (lane & 7);
  const int zb = ((lane >> 3) & 1) ^ (lane & 7);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; tile t - 1 read by all
    if (t + 1 < n_tiles) issue_tile(t + 1);
    cp_async_commit();
    const bf16* ks = ring + (t % NST) * 2 * TILE;
    const bf16* vs = ks + TILE;
    const int kt = t * BKV;
    if (qhi < qlo || (a.causal && kt > qhi)) continue;
    const bool edge = kt + BKV > a.Skv || (a.causal && kt + BKV - 1 > qlo);

    // s = Q K^T and dp = dout V^T over the warp's 16 rows x 64 keys
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D, NB>(s, Qs + arow * D, ks, brow, za, zb);
    mma_abt<D, NB>(dp, dOs + arow * D, vs, brow, za, zb);

    // element e of n-block j: row g + 8 (e / 2), key kt + 8 j + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = fast_exp2(s[j][e] * a.scale_log2 - l2[i]);
        if (edge) {
          const int key = kt + 8 * j + 2 * t4 + (e & 1);
          if (key >= a.Skv || (a.causal && key > qpos[i])) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl[i]);
      }
    }
    mma_pt<D, NB>(dq, dp, ks, trow, za);   // dq += ds . k
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= a.Sq) continue;
    const long long off =
        (((long long)b * a.Sq + r) * a.Hq + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(a.dq + off + 8 * n) =
          __floats2bfloat162_rn(dq[n][2 * i] * a.scale,
                                dq[n][2 * i + 1] * a.scale);
  }
}

template <int D>
constexpr int qt_of() {
  return D == 64 ? 64 : 32;
}

// K and V tiles, the ring of Q and dout tiles, and its lse and delta
template <int D>
constexpr int dkdv_smem() {
  return 2 * (2 * BKV * D + NST * 2 * qt_of<D>() * D) +
         4 * 2 * NST * qt_of<D>();
}

// Q and dout tiles, and the ring of K and V tiles
template <int D>
constexpr int dq_smem() {
  return 2 * (2 * BQ * D + NST * 2 * BKV * D);
}
static_assert(dkdv_smem<128>() <= 232448 && dq_smem<128>() <= 232448,
              "a block may take 227 KiB of shared memory");

template <typename K>
int launch(K kernel, int smem, dim3 grid, const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int Sq, int Skv, int Hq, int Hkv, long long q_sb,
               long long q_ss, long long q_sh, long long k_sb, long long k_ss,
               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
               long long do_sb, long long do_ss, long long do_sh, float scale,
               int causal, int kv_offset) {
  return Args{static_cast<const bf16*>(q),
              static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),
              static_cast<const bf16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<bf16*>(dq),
              static_cast<bf16*>(dk),
              static_cast<bf16*>(dv),
              Sq, Skv, Hq, Hkv, Hq / Hkv,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              do_sb, do_ss, do_sh,
              scale, scale * LOG2E, causal, kv_offset};
}

bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv, int D) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         (D != 64 && D != 128);
}

}  // namespace

extern "C" {

// delta [B, Hq, Sq] (fp32, contiguous) = rowsum(dout * o) over D, with o
// and dout [B, Sq, Hq, D] bf16 by element strides (multiples of 8, the last
// dimension contiguous). D in {64, 128}.
int flash_attention_bwd_prep(const void* o, const void* dout, void* delta,
                             int B, int Sq, int Hq, int D, long long o_sb,
                             long long o_ss, long long o_sh, long long do_sb,
                             long long do_ss, long long do_sh, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * Hq * Sq;
  const long long threads = rows * (D / 8);
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* op = static_cast<const bf16*>(o);
  const bf16* dp = static_cast<const bf16*>(dout);
  float* out = static_cast<float*>(delta);
  if (D == 64)
    prep_kernel<64><<<grid, THREADS, 0, s>>>(op, dp, out, Sq, Hq, rows, o_sb,
                                             o_ss, o_sh, do_sb, do_ss, do_sh);
  else
    prep_kernel<128><<<grid, THREADS, 0, s>>>(op, dp, out, Sq, Hq, rows,
                                              o_sb, o_ss, o_sh, do_sb, do_ss,
                                              do_sh);
  return cudaGetLastError();
}

// dk, dv [B, Skv, Hkv, D] (bf16, contiguous) from q [B, Sq, Hq, D], k, v
// [B, Skv, Hkv, D], dout [B, Sq, Hq, D] (bf16, element strides) and the
// forward's lse and prep's delta [B, Hq, Sq] (fp32, contiguous). Grid
// (ceil(Skv / 64), Hkv, B).
int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, int causal, int kv_offset,
    void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, Sq,
                           Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, scale,
                           causal, kv_offset);
  const dim3 grid((Skv + BKV - 1) / BKV, Hkv, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch(dkdv_kernel<64, qt_of<64>()>, dkdv_smem<64>(), grid, a, s);
  return launch(dkdv_kernel<128, qt_of<128>()>, dkdv_smem<128>(), grid, a, s);
}

// dq [B, Sq, Hq, D] (bf16, contiguous) from the same inputs. Grid (Hq, B,
// ceil(Sq / 64)).
int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, int causal, int kv_offset, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                           Sq, Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss,
                           k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, scale,
                           causal, kv_offset);
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch(dq_kernel<64>, dq_smem<64>(), grid, a, s);
  return launch(dq_kernel<128>, dq_smem<128>(), grid, a, s);
}

}  // extern "C"
