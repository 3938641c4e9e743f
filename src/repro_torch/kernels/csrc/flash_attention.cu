// Flash attention (forward) for Hopper (sm_90a), on bf16 tensor cores.
//
// Replaces src/repro/kernels/flash_attention.py flash_attention (Pallas
// body _flash_kernel; GQA repeat in src/repro/kernels/ops.py attention),
// and computes what src/repro/models/layers.py blockwise_attention
// computes on the serving path's prefill: online-softmax attention with
// an fp32 running max m, normaliser l and accumulator, a causal mask
// offset by kv_offset, and ragged Sq / Skv masked in the kernel.
//
// Layout. q [B, Sq, Hq, DQK], k [B, Skv, Hkv, DQK], v [B, Skv, Hkv, DV],
// out [B, Sq, Hq, DV], all bf16, (DQK, DV) in {(64, 64), (128, 128),
// (256, 256), (192, 128)} (the last is DeepSeek-V2's MLA: 128 + 64 rotary
// key columns over 128 value columns), given by element strides (batch,
// sequence, head) that are multiples of 8 with the last dimension
// contiguous and 16-byte aligned rows, so blockwise_attention's
// [B, S, H, D] and ops.attention's [B, H, S, D] both arrive without a
// copy. Query head h reads KV head h / (Hq / Hkv): grouped-query
// attention with no repeated K or V.
//
// Numerics, as blockwise_attention:
//   s   = (q . k) * scale in fp32, the scale applied after the dot (bf16
//         products are exact in the mma's fp32 accumulator, so only the
//         order of the sum differs); the kernel keeps s, m in base 2:
//         s2 = (q . k) * (scale * log2 e), one multiply after the dot;
//   s   = -1e30 where kpos >= Skv or (causal and kpos > qpos + kv_offset);
//   p   = 2^(s2 - m2) = exp(s - m), in fp32, by ex2.approx.ftz (2 ulp;
//         a p below 2^-126 flushes to 0, which l >= 1 cannot see);
//   l  += sum of the fp32 p;
//   acc = acc * alpha + (p rounded to bf16) . v, in fp32;
//   out = acc / max(l, 1e-30), rounded to bf16;
//   lse = m + log(l) in fp32 (natural log, [B, Hq, Sq]), written only
//         when the caller passes a buffer for it: the training path's
//         backward (flash_attention_bwd.cu) recomputes p = exp(s - lse)
//         from it; serving passes null.
// A kv tile that lies wholly above the causal diagonal (or past Skv) is
// not visited: it would add exp(-1e30 - m) = 0 to l and acc with
// alpha = 1, so the skip is exact. A row whose keys so far are all
// masked keeps m = -1e30 and takes its exponents against 0, so its p,
// l and acc stay 0 (only the decode form's later warps meet such rows;
// key 0, which every row may see, lies in every prefill block's first
// tile and in the decode form's warp 0).
//
// What bounds it on an H100. At the serving prefill (B=8, S=64, Hq=32,
// Hkv=8, D=64) the work is 4*B*Hq*D*(S(S+1)/2) = 136 MFLOP against 3.1
// MB of q, k, v and out: ~1 us of HBM at 3.35 TB/s, ~0.14 us of bf16
// tensor-core time, so bytes bound it, and a launch and one tile's
// latency are what it costs. At S=2048 the 17 GFLOP of the causal
// product bound it (~17 us at 989 TFLOP/s). At decode (Sq=1, Skv=1024)
// the KV bytes bound it (~5 us). At gemma-7b's prefill (B=8, S=64, 16
// heads of D=256) the 16.8 MB bound it (~5 us), and at DeepSeek-V2's
// (B=8, S=64, 128 heads, DQK 192, DV 128) its 84 MB (~25 us).
//
// Design (FlashAttention-2 shape on mma.sync; wgmma and TMA are later
// work):
//   * prefill form: one block of 4 warps per (64-row query tile, query
//     head, batch). Each warp owns 16 query rows; at DQK <= 128 their Q
//     fragments are read once by ldmatrix and stay in registers for the
//     whole KV loop (acc and Q take 16 * DV / 32 + 16 * DQK / 64
//     registers a thread). At DV = 256 acc alone would take 128 and Q 64
//     more, and with the score tile the kernel spilled. So past DQK = 128
//     Q stays in shared memory, each k-step of q . k reading its A
//     fragment by ldmatrix (QREG false), and at DV = 256 the block makes
//     two passes over the KV tiles (NPASS), each accumulating 128 of the
//     256 output columns: q . k and the softmax are done twice and K is
//     read twice, for no spill (kernel_parts.py's one_pass variant keeps
//     the single pass). At (192, 128) q . k takes 12 k-steps from shared
//     memory and one pass accumulates the 128 value columns;
//     S = Q K^T is mma.sync m16n8k16 bf16 -> fp32 with K's B fragments
//     from ldmatrix.x4 on the row-major [64][DQK] K tile; the row max and
//     row sum take two quad shuffles (l is summed per thread and reduced
//     once at the end); P goes from the C fragments to A fragments in
//     registers (cvt.rn.bf16x2.f32) and P V is the same mma with V's B
//     fragments from ldmatrix.x4.trans on the row-major V tile;
//   * copies: K and V tiles arrive by 16-byte cp.async (zero-filled past
//     Skv, Q past Sq: p is 0 there but 0 * NaN of stale shared memory is
//     not) into a ring of stages, tile t + 1 in flight while tile t
//     computes, one __syncthreads a tile. Rows are 16-byte chunks
//     swizzled by (row & 7), so ldmatrix and cp.async hit no bank twice;
//   * masks are compared per element only on tiles that cross the
//     diagonal or the end of Skv; interior tiles take the unmasked path;
//   * causal load balance: the query tile is the slowest grid dimension,
//     walked in reverse, so the tiles with the most KV tiles start first;
//   * decode form (Sq * Hq/Hkv <= 16): one block per (KV head, batch)
//     packs the Hq/Hkv query heads x Sq positions that share the KV head
//     into the 16 rows of one mma tile (row r: position r / rep, head
//     hk * rep + r % rep), so each K and V tile is read once for all of
//     them, and a 4-stage ring keeps three tiles in flight (3 stages at
//     (256, 256), whose 4 would need 264 KiB of shared memory; two
//     passes of 128 columns there too; (192, 128) keeps 4, 166 KiB).
//     Each warp
//     takes a quarter of every 64-key tile (16 keys); the four (m, l,
//     acc) merge through shared memory at the end with the usual
//     rescaling, and each row goes back to its (position, head) by
//     stride.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;             // query rows of one mma tile
constexpr int BQ = ROWS * WARPS;     // prefill: query rows per block
constexpr int BKV = 64;              // keys per staged K or V tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;  // [B, Hq, Sq] or null
  int Sq, Skv, rep;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;
  int causal, kv_offset;
};

// K / V ring stages: 2 in the prefill form; 4 in the decode form, 3 at
// (256, 256), where 4 stages and the Q tile would take 264 KiB of the 227
// KiB a block may have (kernels/flash_attention.py stages).
template <int DQK, int DV, bool DEC>
__host__ __device__ constexpr int stages() {
  return DEC ? (DQK + DV > 384 ? 3 : 4) : 2;
}

// Q tile [rows][DQK], then the ring of [K tile [64][DQK], V tile [64][DV]]
// stages, all bf16.
template <int DQK, int DV, bool DEC>
constexpr int smem_bytes() {
  return 2 * ((DEC ? ROWS : BQ) * DQK +
              stages<DQK, DV, DEC>() * BKV * (DQK + DV));
}
static_assert(smem_bytes<256, 256, false>() <= 232448 &&
                  smem_bytes<256, 256, true>() <= 232448 &&
                  smem_bytes<192, 128, true>() <= 232448,
              "a block may take 227 KiB of shared memory");

// Element offset of 16-byte chunk `chunk` of row `row` in a [rows][D]
// tile whose chunks are swizzled by (row & 7). Every D here is a multiple
// of 64, so a row starts on bank 0 and the swizzle stays within the row.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// The same offset within a row for chunk 2 i + c0 (c0 in {0, 1}), with
// z = c0 ^ (row & 7) the lane's constant: (2 i + c0) ^ (row & 7) =
// ((2 i) & ~7) + (((2 i) & 7) ^ z). In a loop unrolled over i the first
// term is an immediate and the second one of four values, so the
// ldmatrix addresses of a whole tile take four registers rather than
// one per step held across the KV loop.
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

// c += a . b on one m16n8k16 tile: a the 16x16 bf16 A fragment, (b0, b1)
// the 16x8 bf16 B fragment, c the 16x8 fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in fp32 (MUFU.EX2: 2 ulp, subnormal results flushed to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed, lo in the low half
// (cvt.rn.bf16x2.f32).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, n) of an NROWS x D tile from g (row stride ld elements) into
// its swizzled shared tile by 16-byte cp.async; rows from n on are zeros.
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

// The decode form's 16 packed query rows: row r < Sq * rep is position
// r / rep of query head hk * rep + r % rep; the rest are zeros.
template <int D>
__device__ __forceinline__ void load_q_packed(bf16* s, const Args& a, int b,
                                              int hk, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i / CH, c = i % CH;
    const bool ok = r < a.Sq * a.rep;
    const bf16* g = a.q + b * a.q_sb;
    if (ok) g += (r / a.rep) * a.q_ss + (hk * a.rep + r % a.rep) * a.q_sh;
    cp_async16(s + swz<D>(r, c), g + c * 8, ok);
  }
}

template <int DQK, int DV, bool DEC>
__global__ void __launch_bounds__(THREADS) flash_kernel(const Args a) {
  constexpr int NST = stages<DQK, DV, DEC>();
  constexpr bool QREG = DQK <= 128;            // Q fragments in registers
  constexpr int KW = DEC ? BKV / WARPS : BKV;  // keys of a tile per warp
  constexpr int NB = KW / 8;                   // n-blocks of a score tile
  constexpr int DK = DQK / 16;                 // k-steps of q . k
  // output columns in NPASS passes: at DV = 256 acc for all 256 would take
  // 128 registers a thread, so each pass accumulates 128 of them
  constexpr int NPASS = DV >= 256 ? 2 : 1;
  constexpr int PW = DV / NPASS;               // output columns of a pass
  constexpr int DN = PW / 8;                   // n-blocks of a pass's output
  constexpr int KTILE = BKV * DQK;             // elements of a K tile
  constexpr int STAGE = KTILE + BKV * DV;      // ... of a [K, V] stage
  static_assert(!DEC || 4 * (2 * WARPS * ROWS + WARPS * ROWS * PW) <=
                            2 * NST * STAGE,
                "the decode merge reuses the ring");
  static_assert(PW % 64 == 0 || NPASS == 1,
                "a pass's columns start on a whole swizzle period");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + (DEC ? ROWS : BQ) * DQK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y;
  int h = 0, hk, q0 = 0;
  if (DEC) {
    hk = blockIdx.x;
  } else {
    h = blockIdx.x;
    hk = h / a.rep;
    const int n_q = gridDim.z;
    q0 = BQ * (a.causal ? n_q - 1 - (int)blockIdx.z : (int)blockIdx.z);
  }
  const bf16* kg = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vg = a.v + b * a.v_sb + hk * a.v_sh;

  // Query positions plus kv_offset: the thread's rows g and g + 8, and
  // the warp's first and last row that is real.
  int qpos[2], qlo, qhi;
  if (DEC) {
    qpos[0] = g / a.rep + a.kv_offset;
    qpos[1] = (g + 8) / a.rep + a.kv_offset;
    qlo = a.kv_offset;
    qhi = a.Sq - 1 + a.kv_offset;
  } else {
    const int r0 = q0 + ROWS * warp;
    qpos[0] = r0 + g + a.kv_offset;
    qpos[1] = qpos[0] + 8;
    qlo = r0 + a.kv_offset;
    qhi = min(r0 + ROWS, a.Sq) - 1 + a.kv_offset;
  }
  // keys up to the last one a real query row of the block may see
  int kv_end = a.Skv;
  if (a.causal)
    kv_end = min(kv_end, (DEC ? a.Sq : min(q0 + BQ, a.Sq)) + a.kv_offset);
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int key0 = DEC ? KW * warp : 0;  // the warp's first key of a tile

  auto issue_q = [&]() {
    if (DEC)
      load_q_packed<DQK>(Qs, a, b, hk, tid);
    else
      load_tile<DQK, BQ>(Qs, a.q + b * a.q_sb + h * a.q_sh + q0 * a.q_ss,
                         a.q_ss, a.Sq - q0, tid);
  };
  auto issue_tile = [&](int t) {
    bf16* ks = ring + (t % NST) * STAGE;
    const int k0 = t * BKV;
    load_tile<DQK, BKV>(ks, kg + k0 * a.k_ss, a.k_ss, a.Skv - k0, tid);
    load_tile<DV, BKV>(ks + KTILE, vg + k0 * a.v_ss, a.v_ss, a.Skv - k0, tid);
  };

  // the lane's ldmatrix rows: its Q row, K rows krow + 16 jj, V rows
  // vrow + 16 kk; each is lane & 7 modulo 8, so one swizzle constant zq
  // (chunk 2 kk + (lane >> 4), as V's chunks) and zk (chunk 2 kk +
  // ((lane >> 3) & 1)) serve all of them
  const bf16* qs_lane = Qs + ((DEC ? 0 : ROWS * warp) + (lane & 15)) * DQK;
  const int krow = key0 + (lane & 7) + ((lane >> 4) << 3);
  const int vrow = key0 + (lane & 15);
  const int zq = (lane >> 4) ^ (lane & 7);
  const int zk = ((lane >> 3) & 1) ^ (lane & 7);
  uint32_t qf[QREG ? DK : 1][4];

#pragma unroll 1
  for (int pass = 0; pass < NPASS; ++pass) {
    // output columns [c0, c0 + PW) of this pass; a later pass walks the KV
    // tiles again, so the ring (and the decode merge's use of it) must be
    // free first
    const int c0 = pass * PW;
    if (pass == 0) {
      issue_q();
    } else {
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < NST - 1; ++t) {
      if (t < n_tiles) issue_tile(t);
      cp_async_commit();
    }

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[DN][4];
#pragma unroll
    for (int n = 0; n < DN; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<NST - 2>();
      __syncthreads();  // tile t landed for all threads; tile t - 1 read
      if (t + NST - 1 < n_tiles) issue_tile(t + NST - 1);
      cp_async_commit();
      if constexpr (QREG) {
        if (t == 0) {
#pragma unroll
          for (int kk = 0; kk < DK; ++kk)
            ldsm_x4(qf[kk], qs_lane + swz_step(kk, zq));
        }
      }
      const bf16* ks = ring + (t % NST) * STAGE;
      const bf16* vs = ks + KTILE;
      const int kw0 = t * BKV + key0;
      const bool skip =
          qhi < qlo || kw0 >= a.Skv || (a.causal && kw0 > qhi);
      if (skip) continue;
      const bool edge = kw0 + KW > a.Skv || (a.causal && kw0 + KW - 1 > qlo);

      // S = Q K^T over the warp's KW keys
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t qa[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          ldsm_x4(qa, qs_lane + swz_step(kk, zq));
        }
#pragma unroll
        for (int jj = 0; jj < NB / 2; ++jj) {
          uint32_t kf[4];
          ldsm_x4(kf, ks + (krow + 16 * jj) * DQK + swz_step(kk, zk));
          mma_bf16(s[2 * jj], qa, kf[0], kf[1]);
          mma_bf16(s[2 * jj + 1], qa, kf[2], kf[3]);
        }
      }

      // online softmax in base 2; element e of n-block j is row g + 8 (e/2),
      // key kw0 + 8 j + 2 t4 + e % 2
      float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale_log2;
          if (edge) {
            const int kpos = kw0 + 8 * j + 2 * t4 + (e & 1);
            if (kpos >= a.Skv || (a.causal && kpos > qpos[e >> 1])) x = NEG_INF;
          }
          s[j][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      }
      float alpha[2], mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m[i], mt[i]);
        mu[i] = m_new == NEG_INF ? 0.f : m_new;
        alpha[i] = fast_exp2(m[i] - mu[i]);
        m[i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(s[j][e] - mu[e >> 1]);
          rs[e >> 1] += p;  // l sums the fp32 p
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // acc += (P rounded to bf16) . V; P's C fragments are its A fragments
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jj = 0; jj < DN / 2; ++jj) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, vs + c0 + (vrow + 16 * kk) * DV +
                                swz_step(jj, zq));
          mma_bf16(acc[2 * jj], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * jj + 1], pa, vf[2], vf[3]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }

    if (!DEC) {
      bf16* og = a.out + b * a.o_sb + h * a.o_sh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + ROWS * warp + g + 8 * i;
        if (r >= a.Sq) continue;
        const float norm = fmaxf(l[i], 1e-30f);
        if (a.lse != nullptr && pass == 0 && t4 == 0)
          a.lse[((long long)b * gridDim.x + h) * a.Sq + r] =
              (m[i] + log2f(norm)) * LN2;
        bf16* orow = og + r * a.o_ss + c0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < DN; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
              __floats2bfloat162_rn(acc[n][2 * i] / norm,
                                    acc[n][2 * i + 1] / norm);
      }
      continue;
    }

    // decode form: merge the four warps' (m, l, acc) of each row
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    float* ms = reinterpret_cast<float*>(ring);
    float* ls = ms + WARPS * ROWS;
    float* as = ls + WARPS * ROWS;  // [WARPS][ROWS][PW]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * ROWS + g + 8 * i;
      if (t4 == 0) {
        ms[r] = m[i];
        ls[r] = l[i];
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        as[r * PW + 8 * n + 2 * t4] = acc[n][2 * i];
        as[r * PW + 8 * n + 2 * t4 + 1] = acc[n][2 * i + 1];
      }
    }
    __syncthreads();
    constexpr int TPR = THREADS / ROWS;  // threads per output row
    const int r = tid / TPR;
    if (r >= a.Sq * a.rep) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w * ROWS + r]);
    float sc[WARPS], lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sc[w] = fast_exp2(ms[w * ROWS + r] - mx);
      lsum += ls[w * ROWS + r] * sc[w];
    }
    const float norm = fmaxf(lsum, 1e-30f);
    if (a.lse != nullptr && pass == 0 && tid % TPR == 0)
      a.lse[((long long)b * gridDim.x * a.rep + hk * a.rep + r % a.rep) *
                a.Sq + r / a.rep] = (mx + log2f(norm)) * LN2;
    bf16* orow = a.out + b * a.o_sb + (r / a.rep) * a.o_ss +
                 (hk * a.rep + r % a.rep) * a.o_sh + c0;
    for (int c = tid % TPR; c < DN; c += TPR) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[e] = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          o[e] += as[(w * ROWS + r) * PW + 8 * c + e] * sc[w];
      }
      uint4 pk;
      pk.x = pack_bf16(o[0] / norm, o[1] / norm);
      pk.y = pack_bf16(o[2] / norm, o[3] / norm);
      pk.z = pack_bf16(o[4] / norm, o[5] / norm);
      pk.w = pack_bf16(o[6] / norm, o[7] / norm);
      *reinterpret_cast<uint4*>(orow + 8 * c) = pk;
    }
  }
}

template <int DQK, int DV, bool DEC>
int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DQK, DV, DEC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DQK, DV, DEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_kernel<DQK, DV, DEC><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Both forms of the (DQK, DV) instantiation.
template <int DQK, int DV>
int launch_form(const Args& a, dim3 grid, bool dec, cudaStream_t stream) {
  return dec ? launch<DQK, DV, true>(a, grid, stream)
             : launch<DQK, DV, false>(a, grid, stream);
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, DV] -> out
// [B, Sq, Hq, DV], all bf16, given by element strides (batch, sequence,
// head), multiples of 8, with the last dimension contiguous and 16-byte
// aligned bases. (D, DV) in {(64, 64), (128, 128), (256, 256), (192, 128)};
// Hq a multiple of Hkv; kv_offset >= 0; lse, when not null, receives the
// fp32 log-sum-exp [B, Hq, Sq] (contiguous) of every row. Form 0 (prefill) runs
// on a grid (Hq, B, ceil(Sq / 64)), form 1 (decode, only where
// Sq * Hq / Hkv <= 16) on a grid (Hkv, B, 1); kernels/flash_attention.py
// flash_plan picks the form and describes the same launch.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int Hq, int Hkv, int D, int DV,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh,
                    void* lse, float scale, int causal, int kv_offset,
                    int form, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || B <= 0)
    return cudaErrorInvalidValue;
  const int rep = Hq / Hkv;
  const bool dec = form == 1;
  if ((form != 0 && form != 1) || (dec && Sq * rep > ROWS))
    return cudaErrorInvalidValue;
  const dim3 grid = dec ? dim3(Hkv, B, 1) : dim3(Hq, B, (Sq + BQ - 1) / BQ);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(out),
               static_cast<float*>(lse),
               Sq,   Skv,  rep,  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale * LOG2E,
               causal, kv_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && DV == 64) return launch_form<64, 64>(a, grid, dec, s);
  if (D == 128 && DV == 128) return launch_form<128, 128>(a, grid, dec, s);
  if (D == 256 && DV == 256) return launch_form<256, 256>(a, grid, dec, s);
  if (D == 192 && DV == 128) return launch_form<192, 128>(a, grid, dec, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
