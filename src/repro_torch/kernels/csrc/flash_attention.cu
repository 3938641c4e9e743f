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
// (B=8, S=64, 128 heads, DQK 192, DV 128) its 84 MB (~25 us). At the
// wide pairs' training shapes the products bound it: gemma-7b's S 8448
// (16 heads of 256) 585 GFLOP, 0.59 ms at the bf16 peak, DeepSeek-V2's
// S 1024 (B 2, 128 heads) 86 GFLOP, 0.087 ms.
//
// Design. (64, 64) and (128, 128) in both forms, and the wide pairs'
// decode form, are FlashAttention-2's shape on mma.sync; the wide
// pairs' prefill form is a wgmma + TMA instance of its own, described
// where it begins (flash_wide_kernel).
//   * prefill form: one block of 4 warps per (64-row query tile, query
//     head, batch). Each warp owns 16 query rows; at DQK <= 128 their Q
//     fragments are read once by ldmatrix and stay in registers for the
//     whole KV loop (acc and Q take 16 * DV / 32 + 16 * DQK / 64
//     registers a thread). Past DQK = 128 (the decode form's wide pairs)
//     Q stays in shared memory, each k-step of q . k reading its A
//     fragment by ldmatrix (QREG false), and at DV = 256 the block makes
//     two passes over the KV tiles (NPASS), each accumulating 128 of the
//     256 output columns, for no spill;
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

#include <cuda.h>
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

// K / V ring stages: 2 in the prefill form (the wide pairs' is
// WideSmem's); 4 in the decode form, 3 at (256, 256), where 4 stages and
// the Q tile would take 264 KiB of the 227 KiB a block may have
// (kernels/flash_attention.py stages).
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
static_assert(smem_bytes<256, 256, true>() <= 232448 &&
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

// ------------------------------- wide pairs, prefill form (wgmma + TMA) ---
//
// (256, 256), gemma's, and (192, 128), DeepSeek-V2's MLA, in the prefill
// form: FlashAttention-3's block layout. The mma.sync kernel above holds
// them only by keeping Q in shared memory (an ldmatrix of each k-step's A
// fragment, every tile) and, at DV = 256, by two passes of 128 output
// columns (q . k and the softmax twice, K read twice); its 160 KiB of
// shared memory leave one 4-warp block an SM. Here:
//   * one block per (128 query rows, query head, batch), in groups of
//     query heads whose K and V fit 24 MiB of L2: the blocks streaming
//     the same K and V tiles run together and read them from L2, and
//     where causal a group's heaviest query tiles start first, so the
//     lightest blocks fill the last wave;
//   * one producer warp loads the block's two 64-row Q tiles once and the
//     K [64, DQK] and V [64, DV] tiles into a ring of stages (2 at (256,
//     256), 4 at (192, 128)) by TMA (4-D tensor maps over [B, S, H, D],
//     boxes of 64 columns by 64 rows, 128-byte swizzle: the layout wgmma
//     reads; zeros past Sq and Skv), on mbarriers (full: the bytes
//     landed; empty: the 8 consumer warps are done with the stage);
//     setmaxnreg gives each of the two consumer warpgroups' threads 240
//     registers and leaves the producer's 24;
//   * each consumer warpgroup owns 64 query rows and keeps their whole
//     DV-wide fp32 accumulator in registers (128 a thread at DV 256):
//     one pass, each product once. s = q . k is wgmma m64n64k16 with K
//     K-major from shared memory and Q from shared memory at (256, 256),
//     from registers at (192, 128), where its 48 A fragments fit beside
//     the 64 accumulators (QA: half the shared-memory reads of s); the
//     online softmax takes two quad shuffles a row; p goes from the C
//     fragments to bf16 A fragments in registers, and acc += p . v is
//     wgmma m64n128k16 with V as an MN-major B (the transpose bit). Each
//     warpgroup drains its products within the tile; the two warpgroups
//     fill each other's gaps on the tensor cores;
//   * a warpgroup whose rows see fewer KV tiles than the block's (below
//     the diagonal, or past Sq) releases the rest unread;
//   * the output leaves through shared memory: each warpgroup writes its
//     rows of acc / l in bf16 into its own Q tile, in the output tensor
//     map's swizzled boxes, and one thread stores them by TMA (one bulk
//     copy a 64 x 64 box, rows past Sq clipped): 9% off gemma-7b's
//     training forward against each thread's 4-byte stores to global
//     memory.
// The numerics are the header's: the same fp32 s2, masks, ex2.approx and
// per-thread order of l's sum; only the products' summation order differs.

constexpr int WG = 128;                // threads of a warpgroup
constexpr int WROWS = 64;              // query rows of a warpgroup (wgmma M)
constexpr int NW = 2;                  // consumer warpgroups a block
constexpr int WIDE_BQ = NW * WROWS;    // query rows a block
constexpr int BOX = 64;                // bf16 columns of a TMA box (128 B)
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
static_assert(WG * (NW * CONSUMER_REGS + PRODUCER_REGS) <= 65536,
              "the registers of a wide block");

// Shared memory of the wide instance: NW Q tiles [64, DQK], then ST ring
// stages of [K [64, DQK], V [64, DV]] (as many as fit, at most 4, beside
// 1 KiB for alignment and 1 for the barriers), then the barriers.
template <int DQK, int DV>
struct WideSmem {
  static constexpr int Q = WROWS * DQK;           // a warpgroup's Q tile
  static constexpr int STAGE = BKV * (DQK + DV);  // a K and a V tile
  static constexpr int FREE = 232448 - 2048 - 2 * NW * Q;
  static constexpr int ST = FREE / (2 * STAGE) < 4 ? FREE / (2 * STAGE) : 4;
  static constexpr int RING = NW * Q;             // the stages start here
  static constexpr int BARS = 2 * (RING + ST * STAGE);  // bytes
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8;
  // Q as the register A operand of s where its fragments and acc take at
  // most 128 of a consumer thread's 240 registers
  static constexpr bool QA = DV / 2 + DQK / 4 <= 128;
};
static_assert(WideSmem<256, 256>::ST == 2 && WideSmem<192, 128>::ST == 4,
              "the wide instances' rings (kernels/flash_attention.py "
              "wide_stages)");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a consumer warp is done with a stage: one arrival on its empty barrier
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// A 64 x D tile (rows s0.. of head h, batch b) of a [B, S, H, D] tensor
// map as D / 64 TMA boxes of 64 x 64, box e at dst + e 64 64.
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int s0,
                                         int b) {
#pragma unroll
  for (int e = 0; e < D / BOX; ++e)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            smem_u32(dst + e * 64 * BOX)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(e * BOX), "r"(h), "r"(s0), "r"(b)
        : "memory");
}

// A 64 x D tile (rows s0.. of head h, batch b) from shared memory, D / 64
// boxes of 64 x 64 as tma_tile lays them out, to a [B, S, H, D] tensor
// map by TMA (rows past S are not written), committed as one bulk group.
template <int D>
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const bf16* src, int h, int s0,
                                          int b) {
#pragma unroll
  for (int e = 0; e < D / BOX; ++e)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src + e * 64 * BOX)), "r"(e * BOX), "r"(h), "r"(s0),
        "r"(b)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wgmma's descriptor of a 128-byte-swizzled operand in shared memory:
// start address, leading and stride byte offsets, swizzle mode 1. K-major
// (a tile's rows, columns along the product's depth): the stride offset is
// the 1024 bytes of 8 rows, a 16-column step is 32 bytes on. MN-major (the
// tile's rows along the depth): the stride offset is 8 rows, the leading
// offset the next box of 64 columns, a 16-row step is 2048 bytes on.
__device__ __forceinline__ uint64_t desc(const bf16* p, uint32_t lbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// k-step kk (16 columns) of a K-major 64 x D tile of D / 64 boxes
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return desc(tile + (kk >> 2) * 64 * BOX + (kk & 3) * 16, 16);
}
// k-step kk (16 rows) of an MN-major 64 x D tile of D / 64 boxes
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return desc(tile + kk * 16 * BOX, 64 * BOX * 2);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching an accumulator across wgmma's async
// window: reads after the wait, writes before the fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[32] (+)= A . B over k16, A and B from shared memory (descriptors),
// both K-major; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[32] (+)= A . B over k16, A from registers (four bf16x2 a thread, the
// accumulator layout of a 64 x 16 slice), B from shared memory, K-major;
// acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36,"
      " p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[64] += A . B over k16, A from registers, B from shared memory,
// MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128_mn(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68,"
      " p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A thread's place in a warpgroup's accumulator: element i of a 64 x N
// tile is row 16 warp + g + 8 ((i / 2) & 1), column 8 (i / 4) + 2 t4 +
// (i & 1).
struct Frag {
  int warp, g, t4;
  __device__ explicit Frag(int t)
      : warp(t >> 5), g((t & 31) >> 2), t4(t & 3) {}
};

// The register A fragments (wgmma's layout: the accumulator's, in bf16
// pairs) of the warpgroup's rows of every k-step of a 64-row K-major tile
// of N / 64 boxes of 128-byte swizzled rows: ldmatrix.x4 of each 16 x 16
// slice, lanes 0-15 giving rows of its first 8 columns, 16-31 of its last.
template <int N>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const bf16* tile,
                                       int warp, int lane) {
  const int row = 16 * warp + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int c = 2 * kk + (lane >> 4);  // the row's 16-byte chunk
    ldsm_x4(a[kk], tile + (c >> 3) * 64 * BOX + row * BOX +
                       (((c & 7) ^ (row & 7)) << 3));
  }
}

// s = q . k over DQK for one KV tile (K at `Ks`), issued and committed:
// Q from shared memory, or from registers (`qa`) where QA.
template <int DQK, int DV>
__device__ __forceinline__ void issue_s(float (&s)[32], const bf16* Qs,
                                        const uint32_t (*qa)[4],
                                        const bf16* Ks) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk)
    if constexpr (WideSmem<DQK, DV>::QA)
      wgmma_rs_n64_k(s, qa[kk], desc_k(Ks, kk), kk);
    else
      wgmma_ss_n64(s, desc_k(Qs, kk), desc_k(Ks, kk), kk);
  wg_commit();
}

// The online softmax of one tile's s (keys from kt) for the warpgroup
// whose rows start at qw: s becomes p (fp32), m and l move on, and alpha
// is the factor acc must be rescaled by before the tile's p . v. Element
// i is row 16 warp + g + 8 ((i >> 1) & 1), key kt + 8 (i >> 2) + 2 t4 +
// (i & 1); masks only on tiles that cross the diagonal or Skv.
__device__ __forceinline__ void softmax(float (&s)[32], int kt, int qw,
                                        const Args& a, float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const Frag& f) {
  const int r0 = qw + 16 * f.warp;  // the warp's first row
  const bool edge =
      kt + BKV > a.Skv || (a.causal && kt + BKV - 1 > r0 + a.kv_offset);
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hr = (i >> 1) & 1;
    float x = s[i] * a.scale_log2;
    if (edge) {
      const int kpos = kt + 8 * (i >> 2) + 2 * f.t4 + (i & 1);
      if (kpos >= a.Skv ||
          (a.causal && kpos > r0 + f.g + 8 * hr + a.kv_offset))
        x = NEG_INF;
    }
    s[i] = x;
    mt[hr] = fmaxf(mt[hr], x);
  }
  float mu[2];
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
  for (int i = 0; i < 32; ++i) {
    const float p = fast_exp2(s[i] - mu[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += p;  // l sums the fp32 p
    s[i] = p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// acc *= alpha, then p rounded to bf16 as A fragments (p's C fragments
// are its A fragments)
template <int DV>
__device__ __forceinline__ void rescale_pack(float (&acc)[DV / 2],
                                             const float (&alpha)[2],
                                             const float (&s)[32],
                                             uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// acc += p . v over the tile's 64 keys (V at `Vs`), issued and committed
template <int DV>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2],
                                         const uint32_t (&pa)[BKV / 16][4],
                                         const bf16* Vs) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int c = 0; c < DV; c += 128)
      wgmma_rs_n128_mn(*reinterpret_cast<float(*)[64]>(acc + c / 2), pa[kk],
                       desc_mn(Vs + c * 64, kk));
  wg_commit();
}

// The prefill form at a wide pair: 128 query rows of one query head of
// one batch a block, over a one-dimensional grid in groups of `group`
// (batch, query head) pairs (whole KV heads' query heads, as many as
// keep their K and V within a share of L2): a group's blocks run
// together, its pairs side by side, the query tiles with the most KV
// tiles first where causal, so that the blocks streaming the same tiles
// meet in L2 and the lightest blocks come last. Consumer warpgroup w
// takes rows [64 w, 64 w + 64) of the block's; warpgroup NW's first
// thread loads.
template <int DQK, int DV>
__global__ void __launch_bounds__((NW + 1) * WG, 1)
    flash_wide_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, const Args a,
                      int hq, int group) {
  using L = WideSmem<DQK, DV>;
  constexpr int ST = L::ST;
  static_assert(DV % 128 == 0, "p . v as n128 wgmmas");
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle's period: the launch asks for 1024 bytes more
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // NW Q tiles
  bf16* ring = qs + L::RING;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int n_q = (a.Sq + WIDE_BQ - 1) / WIDE_BQ;
  const int pairs = gridDim.x / n_q, g = blockIdx.x / (group * n_q);
  const int in_g = blockIdx.x - g * group * n_q;
  const int size = min(group, pairs - g * group);  // the last may be short
  const int pair = g * group + in_g % size, qt = in_g / size;
  const int h = pair % hq, b = pair / hq, hk = h / a.rep;
  const int q0 = WIDE_BQ * (a.causal ? n_q - 1 - qt : qt);
  // the KV tiles that query rows [r0, r0 + 64) see
  auto kv_tiles = [&](int r0) {
    if (r0 >= a.Sq) return 0;
    int kv_end = a.Skv;
    if (a.causal) kv_end = min(kv_end, min(r0 + WROWS, a.Sq) + a.kv_offset);
    return (kv_end + BKV - 1) / BKV;
  };
  int n_tiles = 0;
  for (int w = 0; w < NW; ++w)
    n_tiles = max(n_tiles, kv_tiles(q0 + w * WROWS));

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NW * WG) {  // the producer warpgroup: its first thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (tid == NW * WG) {
      mbar_expect(q_full, 2 * L::RING);
      for (int w = 0; w < NW; ++w)
        tma_tile<DQK>(qs + w * L::Q, &tq, q_full, h, q0 + w * WROWS, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        bf16* ks = ring + s * L::STAGE;
        mbar_expect(&full[s], 2 * L::STAGE);
        tma_tile<DQK>(ks, &tk, &full[s], hk, t * BKV, b);
        tma_tile<DV>(ks + BKV * DQK, &tv, &full[s], hk, t * BKV, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    const int lane = tid & 31, w = tid / WG, qw = q0 + w * WROWS;
    const Frag f(tid & (WG - 1));
    const int mine = kv_tiles(qw);  // this warpgroup's KV tiles
    bf16* Qs = qs + w * L::Q;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    uint32_t qa[L::QA ? DQK / 16 : 1][4];
    mbar_wait(q_full, 0);
    if constexpr (L::QA) load_a<DQK>(qa, Qs, f.warp, lane);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % ST;
      mbar_wait(&full[st], (t / ST) & 1);
      // a tile past this warpgroup's last is only released
      if (t < mine) {
        const bf16* ks = ring + st * L::STAGE;
        float s[32], alpha[2];
        uint32_t pa[BKV / 16][4];
        issue_s<DQK, DV>(s, Qs, qa, ks);
        wg_wait<0>();
        fence_regs(s);
        softmax(s, t * BKV, qw, a, m, l, alpha, f);
        rescale_pack<DV>(acc, alpha, s, pa);
        issue_pv<DV>(acc, pa, ks + BKV * DQK);
        wg_wait<0>();
        fence_regs(acc);
      }
      release(&empty[st], lane);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    if (qw >= a.Sq) return;  // no rows
    // acc / l rounded to bf16 into the warpgroup's own Q tile (its
    // products are done), in the swizzled 64 x 64 boxes of the output's
    // tensor map, which one thread then stores by TMA; rows past Sq are
    // not written
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rr = 16 * f.warp + f.g + 8 * hr, r = qw + rr;
      const float norm = fmaxf(l[hr], 1e-30f);
      if (a.lse != nullptr && f.t4 == 0 && r < a.Sq)
        a.lse[((long long)b * hq + h) * a.Sq + r] =
            (m[hr] + log2f(norm)) * LN2;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(
            Qs + (n >> 3) * 64 * BOX + rr * BOX +
            (((n & 7) ^ (rr & 7)) << 3) + 2 * f.t4) =
            __floats2bfloat162_rn(acc[4 * n + 2 * hr] / norm,
                                  acc[4 * n + 2 * hr + 1] / norm);
    }
    // the tile's generic writes before the TMA's reads, all 128 threads'
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(WG) : "memory");
    if ((tid & (WG - 1)) == 0) {
      tma_store<DV>(&to, Qs, h, qw, b);
      // the block's shared memory must outlive the store's reads
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library links nothing but the runtime
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a [B, S, H, D] bf16 tensor (element strides sb, ss,
// sh; a dimension of one takes any stride, so it gets the row's) in
// boxes of 64 rows by 64 columns, 128-byte swizzled: loads read zeros
// past S, stores write nothing there.
int make_map(CUtensorMap* m, const void* p, int B, int S, int H, int D,
             long long sb, long long ss, long long sh) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  auto st = [&](int n, long long s) {
    return static_cast<cuuint64_t>(n == 1 ? D : s) * 2;
  };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {st(H, sh), st(S, ss), st(B, sb)};
  const cuuint32_t box[4] = {BOX, 1, WROWS, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// The wide instance's launch; `grid` is the prefill form's (Hq, B, ...).
// It encodes tensor maps through the driver, which needs a current
// context, and a thread whose first CUDA call this is (a serving or rank
// thread) has none: any runtime call makes the device's primary context
// current, and cudaFree(nullptr) does nothing else.
template <int DQK, int DV>
int launch_wide(const Args& a, dim3 grid, cudaStream_t stream) {
  using L = WideSmem<DQK, DV>;
  const int Hq = grid.x, B = grid.y, Hkv = Hq / a.rep;
  int err;
  if ((err = cudaFree(nullptr))) return err;
  CUtensorMap m[4];
  if ((err = make_map(&m[0], a.q, B, a.Sq, Hq, DQK, a.q_sb, a.q_ss,
                      a.q_sh)) ||
      (err = make_map(&m[1], a.k, B, a.Skv, Hkv, DQK, a.k_sb, a.k_ss,
                      a.k_sh)) ||
      (err = make_map(&m[2], a.v, B, a.Skv, Hkv, DV, a.v_sb, a.v_ss,
                      a.v_sh)) ||
      (err = make_map(&m[3], a.out, B, a.Sq, Hq, DV, a.o_sb, a.o_ss,
                      a.o_sh)))
    return err;
  constexpr int smem = L::BYTES + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wide_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // a group: the query heads of as many KV heads as one wave of blocks
  // covers, and at most as many as keep their K and V within 24 MiB of the
  // H100's 50 MB L2; at least one
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  const int n_q = (a.Sq + WIDE_BQ - 1) / WIDE_BQ;
  const long long kv_head = 2LL * a.Skv * (DQK + DV);
  const int by_l2 = (int)max(1LL, (24LL << 20) / kv_head);
  const int by_wave = (sms + n_q * a.rep - 1) / (n_q * a.rep);
  const int group = min(B * Hq, max(1, min(by_l2, by_wave)) * a.rep);
  const int n_blocks = n_q * Hq * B;
  flash_wide_kernel<DQK, DV><<<n_blocks, (NW + 1) * WG, smem, stream>>>(
      m[0], m[1], m[2], m[3], a, Hq, group);
  return cudaGetLastError();
}

// Both forms of the (DQK, DV) instantiation. At the wide pairs the prefill
// form is the wgmma instance, but for (192, 128) over at most 64 queries:
// there its block's second warpgroup would idle, and the mma.sync kernel's
// 104 KiB of shared memory fit two blocks an SM (the wgmma instance's 209
// KiB one), which made it the faster of the two at DeepSeek-V2's serving
// prefill (kernels/flash_attention.py flash_plan).
template <int DQK, int DV>
int launch_form(const Args& a, dim3 grid, bool dec, cudaStream_t stream) {
  if (dec) return launch<DQK, DV, true>(a, grid, stream);
  if constexpr (DQK == 256) {
    return launch_wide<DQK, DV>(a, grid, stream);
  } else {
    if constexpr (DQK == 192)
      if (a.Sq > BQ) return launch_wide<DQK, DV>(a, grid, stream);
    return launch<DQK, DV, false>(a, grid, stream);
  }
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, DV] -> out
// [B, Sq, Hq, DV], all bf16, given by element strides (batch, sequence,
// head), multiples of 8, with the last dimension contiguous and 16-byte
// aligned bases. (D, DV) in {(64, 64), (128, 128), (256, 256), (192, 128)};
// Hq a multiple of Hkv; kv_offset >= 0; lse, when not null, receives the
// fp32 log-sum-exp [B, Hq, Sq] (contiguous) of every row. Form 0 (prefill)
// runs on a grid (Hq, B, ceil(Sq / 64)) of 128 threads, at (256, 256) and
// at (192, 128) past Sq 64 (the wgmma instance) on ceil(Sq / 128) Hq B
// blocks of 384; form 1 (decode, only where Sq * Hq / Hkv <= 16) on a
// grid (Hkv, B, 1) of 128; kernels/flash_attention.py flash_plan picks
// the form and describes the same launch. A tensor map the wgmma
// instance cannot encode is returned as its error, as a refused launch.
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
