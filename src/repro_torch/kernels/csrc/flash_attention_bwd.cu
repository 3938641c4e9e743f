// Flash attention (backward) for Hopper (sm_90a): wgmma and TMA.
//
// Replaces the gradient of src/repro/models/layers.py blockwise_attention,
// which the reference's training takes by XLA autodiff of that pure-JAX
// schedule (its Pallas kernel, src/repro/kernels/flash_attention.py, has
// no backward). In the port the forward of that schedule is
// flash_attention.cu, so its gradient is a kernel too: these two entry
// points, called by kernels/flash_attention.py's autograd Function, dq
// first, then dkdv.
//
// Layout. q [B, Sq, Hq, D], k [B, Skv, Hkv, D], v [B, Skv, Hkv, DV], o /
// dout [B, Sq, Hq, DV], bf16, given by element strides (batch, sequence,
// head) that are multiples of 8 with the last dimension contiguous and
// 16-byte aligned rows (what a TMA tensor map takes); dq [B, Sq, Hq, D],
// dk [B, Skv, Hkv, D] and dv [B, Skv, Hkv, DV] bf16, contiguous; lse (the
// forward's m + log l) and delta [B, Hq, Sq] fp32, contiguous. (D, DV) in
// {(64, 64), (128, 128)}, the plan below, and {(192, 128), (256, 256)},
// its "wide pairs" instance (one block an SM, dkdv's products split over
// two warpgroups). Query head h reads KV head h / (Hq / Hkv).
//
// Numerics (FlashAttention-2's backward): with s = (q . k) * scale masked
// as the forward masks it (-inf past Skv, and where causal, key > query +
// kv_offset),
//   p     = exp(s - lse), fp32, by ex2.approx (the forward's exponent);
//   delta = rowsum(dout * o), fp32 (the dq launch computes it and writes
//           it for the dkdv launch);
//   dv   += p^T . dout with p rounded to bf16, as the forward rounds p
//           before p . v (that cast's gradient is the identity);
//   dp    = dout . v^T, fp32;
//   ds    = p * (dp - delta), rounded to bf16 for the two products below;
//   dk   += ds^T . q, dq += ds . k, both times scale at the end;
// fp32 accumulators, bf16 outputs. Every sum is taken in one fixed order
// (no floating-point atomics), so the gradients are bitwise repeatable.
//
// What bounds it on an H100. Five products of 2 Sq Skv D a (batch, query
// head) are needed (s, dp, dv, dk, dq); the kernels take seven, as dq and
// dkdv each recompute s and dp. Causal masks halve them. Against them
// stand the bytes of q, k, v, o, dout, lse, delta, dq, dk and dv. At
// seamless-m4t's training shapes (B 8, S 256, 16 heads of 64) the bytes
// bound it (~10 us), and each launch's fixed costs take most of the time:
// a launch of either kernel that copies and computes nothing takes 8-11 us
// at those grids. At llama's GQA 32/8 over S 2048 and at the D 128 shapes
// the operations bound it (69 GFLOP, ~87 us at S 2048); there dkdv's
// products run at about 40% of the bf16 peak and dq's at about a third.
// Where a few KV heads meet short sequences (qwen2-vl's 12/2 at S 512:
// 32 dkdv blocks), dkdv's grid leaves most SMs idle: each block walks
// its whole group of query heads so that no two blocks add into one dk
// or dv. No training path of the port sends such a shape (LMs reach this
// kernel only above 8192 tokens, where the key tiles fill the card), so
// the group is not split over blocks. At the wide pairs (MLA's 128 heads
// at S 1024, gemma's S 8448) the operations bound it, 0.31 and 2.07 ms at
// the bf16 peak; their instance is described where it begins.
//
// Design.
//   * Both kernels are warp-specialised: one producer warp loads tiles by
//     TMA (4-D tensor maps over [B, S, H, D], boxes of 64 columns by the
//     tile's rows, 128-byte swizzle: the layout wgmma reads) into a ring
//     of stages guarded by mbarriers (full: the bytes landed; empty: every
//     consumer warp is done with the stage), and gives up its registers
//     (setmaxnreg) to the consumer warpgroup, which issues wgmma m64nNk16
//     bf16 -> fp32. Products over D read both operands from shared memory
//     (K-major); products over a tile's rows take A from registers (p or
//     ds: the fp32 accumulator packed to bf16 pairs is the A fragment's
//     layout) and B from shared memory with the transpose bit (MN-major).
//     Rows past S come from TMA as zeros and are masked.
//   * Two blocks an SM, one consumer warpgroup each: a warpgroup waits on
//     its own products at each step of a tile (s and dp, the softmax, the
//     row products), and the other block's warpgroup keeps the tensor
//     cores busy meanwhile. (Two consumer warpgroups in one block, sharing
//     each streamed tile, ran in lockstep and were slower; so was keeping
//     a tile's row products in flight over the next tile's s and dp.)
//   * dq (launched first): one block per (64-row query tile, query head,
//     batch); the Q and dout tiles are loaded once, the K and V tiles
//     stream through the ring (3 stages at D 64, 2 at D 128). Before its
//     loop the block computes its rows' delta = rowsum(dout * o) from the
//     dout tile and o (read while the tiles land), uses it, and writes it
//     for dkdv: the prep launch is folded in. Causal query tiles with the
//     most KV tiles start first.
//   * dkdv (a programmatic dependent of dq: its launch, setup and K and V
//     loads overlap dq's last blocks, and it waits for dq only where it
//     reads delta): one block per (64-key tile, KV head, batch), which
//     keeps dk and dv in fp32 registers while the Q and dout tiles (64
//     rows) of its query heads stream through the ring (3 stages at D 64,
//     2 at D 128) with their lse and delta rows (the producer warp's
//     cp.async copies, which arrive on the stage's barrier as they land).
//     Query tiles wholly below the causal diagonal's first key are not
//     visited, and the key tiles with the most work start first.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError() (or the error
// of encoding a tensor map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;    // threads of a warpgroup
constexpr int ROWS = 64;   // rows of a warpgroup's tile (wgmma's M)
constexpr int BOX = 64;    // bf16 columns of a TMA box: one 128-byte row
constexpr int QT = 64;     // dkdv: query rows of a streamed tile
// A block is one consumer warpgroup and one producer warpgroup, two blocks
// an SM: by setmaxnreg a consumer thread takes 232 registers and a
// producer thread keeps 24, which fill the SM's 64K
constexpr int BLOCKS_SM = 2, CONSUMER_REGS = 232, PRODUCER_REGS = 24;
static_assert(BLOCKS_SM * (CONSUMER_REGS + PRODUCER_REGS) * WG <= 65536,
              "the registers of the blocks an SM");
constexpr int SMEM_SM = 233472;  // shared memory an SM (228 KiB)
// ring stages, at most 3, that fit beside `fixed` bytes in a block's share
// of the SM (each block is also given 1 KiB for alignment and reserved 1)
constexpr int stages_of(int fixed, int stage) {
  return (SMEM_SM / BLOCKS_SM - 2048 - fixed - 64) / stage < 3
             ? (SMEM_SM / BLOCKS_SM - 2048 - fixed - 64) / stage
             : 3;
}
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* out;   // dq: the forward's output, for delta
  const float* lse;
  float* delta;      // written by dq, read by dkdv
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, Sq, Skv, Hq, Hkv, rep;
  long long o_sb, o_ss, o_sh;
  float scale, scale_log2;
  int causal, kv_offset;
};

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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// 4 bytes from global to shared memory, asynchronously (zeros where not
// `valid`), and an arrival on `bar` once this thread's copies landed
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
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
  if (lane == 0) mbar_arrive(bar);
}

// One TMA box of a [B, S, H, D] tensor map: columns c0.., head h, rows
// s0.., batch b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// An R x D tile (R rows from s0 of head h, batch b) as D / 64 boxes of
// R x 64, box e at dst + e R 64.
template <int D, int R>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int s0,
                                         int b) {
#pragma unroll
  for (int e = 0; e < D / BOX; ++e)
    tma_load(dst + e * R * BOX, map, bar, e * BOX, h, s0, b);
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
// k-step kk (16 columns) of a K-major R x D tile of D / 64 boxes
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return desc(tile + (kk >> 2) * R * BOX + (kk & 3) * 16, 16);
}
// k-step kk (16 rows) of an MN-major R x D tile of D / 64 boxes
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return desc(tile + kk * 16 * BOX, R * BOX * 2);
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

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
// dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle's
// period; the launch asks for 1024 more)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}
// Programmatic dependent launch: the dq launch lets the dkdv launch that
// follows it on the stream start while its last blocks run; dkdv waits for
// dq's results (all of dq done, its writes visible) only where it reads
// them
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// d[32] += A . B over k16, A from registers (four bf16x2 a thread,
// the accumulator layout of a 64 x 16 slice), B from shared memory,
// MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_mn(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36,"
      " p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A . B over k16, A from registers (four bf16x2 a thread,
// the accumulator layout of a 64 x 16 slice), B from shared memory,
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

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64_mn(d, a, db);
  else
    wgmma_rs_n128_mn(d, a, db);
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

// The A fragments of the N / 16 slices (64 x 16) of a 64 x N fp32
// accumulator, rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// The rows [r0, r0 + 64) of a [B, S, H, D] output (contiguous, bf16) from
// a warpgroup's 64 x D fp32 accumulator times `mul`.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&c)[D / 2],
                                           float mul, const Frag& f, int b,
                                           int r0, int S, int H, int h) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 16 * f.warp + f.g + 8 * hr;
    if (r >= S) continue;
    bf16* row = out + (((long long)b * S + r) * H + h) * D + 2 * f.t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
          c[4 * n + 2 * hr] * mul, c[4 * n + 2 * hr + 1] * mul);
  }
}

// ---------------------------------------------------------------- dq ---

// dq: one consumer warpgroup of 64 query rows, two blocks an SM
template <int D>
struct DqSmem {
  static constexpr int TILE = ROWS * D;  // elements of a Q, dO, K or V tile
  static constexpr int ST = stages_of(4 * TILE, 4 * TILE);
  static constexpr int RING = 2 * TILE;  // ST x [K, V] after Q and dO
  static constexpr int BARS = 2 * (RING + ST * 2 * TILE);  // bytes
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8;
};

// One KV tile of a dq block: s and dp over D, p and ds, and dq += ds . k.
template <int D>
__device__ __forceinline__ void dq_tile(const bf16* Qs, const bf16* dOs,
                                        const bf16* Ks, const bf16* Vs,
                                        int kt, int q0, const Args& a,
                                        const float (&l2)[2],
                                        const float (&dl)[2],
                                        float (&dq)[D / 2], const Frag& f) {
  float s[32], dp[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k<ROWS>(Qs, kk), desc_k<ROWS>(Ks, kk), kk);
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dp, desc_k<ROWS>(dOs, kk), desc_k<ROWS>(Vs, kk), kk);
  wg_commit();
  wg_wait<1>();
  fence_regs(s);
  const bool edge = kt + ROWS > a.Skv || q0 + ROWS > a.Sq ||
                    (a.causal && kt + ROWS - 1 > q0 + a.kv_offset);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hr = (i >> 1) & 1;
    float p = fast_exp2(s[i] * a.scale_log2 - l2[hr]);
    if (edge) {
      const int key = kt + 8 * (i >> 2) + 2 * f.t4 + (i & 1);
      const int q = q0 + 16 * f.warp + f.g + 8 * hr;
      if (q >= a.Sq || key >= a.Skv || (a.causal && key > q + a.kv_offset))
        p = 0.f;
    }
    s[i] = p;
  }
  wg_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
  uint32_t da[4][4];
  to_a<ROWS>(da, dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(dq, da[kk], desc_mn<ROWS>(Ks, kk));
  wg_commit();
  wg_wait<0>();
  fence_regs(dq);
}

// dq of one 64-row query tile of one query head of one batch, and its
// rows' delta. Warpgroup 0 computes, warpgroup 1's first thread loads.
template <int D>
__global__ void __launch_bounds__(2 * WG, BLOCKS_SM)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = DqSmem<D>;
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + L::TILE;
  bf16* ring = Qs + L::RING;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.rep;
  // causal: the query tiles with the most KV tiles start first
  const int q0 = ROWS * (a.causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                                  : (int)blockIdx.z);
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, min(q0 + ROWS, a.Sq) + a.kv_offset);
  const int n_tiles = (kv_end + ROWS - 1) / ROWS;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  launch_dependents();

  if (tid >= WG) {  // the producer warpgroup: its first thread loads
    reg_dealloc<PRODUCER_REGS>();
    if (tid == WG) {
      mbar_expect(qd_full, 2 * L::TILE * 2);
      tma_tile<D, ROWS>(Qs, &tq, qd_full, h, q0, b);
      tma_tile<D, ROWS>(dOs, &tdo, qd_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        bf16* ks = ring + s * 2 * L::TILE;
        mbar_expect(&full[s], 2 * L::TILE * 2);
        tma_tile<D, ROWS>(ks, &tk, &full[s], hk, t * ROWS, b);
        tma_tile<D, ROWS>(ks + L::TILE, &tv, &full[s], hk, t * ROWS, b);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const Frag f(tid);
    const int lane = tid & 31;
    const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
    float l2[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + 16 * f.warp + f.g + 8 * hr;
      l2[hr] = r < a.Sq ? a.lse[row0 + r] * LOG2E : 0.f;
    }
    // delta = rowsum(dout * o) in fp32: each of a quad's four threads
    // takes every fourth 16-byte chunk of the row (o from global memory,
    // loaded while the tiles land; dout from the swizzled tile), then the
    // quad sums its four parts
    uint4 ov[2][D / 32];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + 16 * f.warp + f.g + 8 * hr;
      const bf16* orow = a.out + b * a.o_sb + r * a.o_ss + h * a.o_sh;
#pragma unroll
      for (int m = 0; m < D / 32; ++m)
        ov[hr][m] = r < a.Sq ? *reinterpret_cast<const uint4*>(
                                   orow + 8 * (f.t4 + 4 * m))
                             : make_uint4(0, 0, 0, 0);
    }
    mbar_wait(qd_full, 0);
    float dl[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rr = 16 * f.warp + f.g + 8 * hr, r = q0 + rr;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        const int c = f.t4 + 4 * m, e = c >> 3, cc = c & 7;
        const uint4 dv = *reinterpret_cast<const uint4*>(
            dOs + e * ROWS * BOX + rr * BOX + ((cc ^ (rr & 7)) << 3));
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov[hr][m]);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 of = __bfloat1622float2(o2[k]);
          const float2 df = __bfloat1622float2(d2[k]);
          sum += of.x * df.x + of.y * df.y;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dl[hr] = sum;
      if (f.t4 == 0 && r < a.Sq) a.delta[row0 + r] = sum;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      const bf16* ks = ring + s * 2 * L::TILE;
      dq_tile<D>(Qs, dOs, ks, ks + L::TILE, t * ROWS, q0, a, l2, dl, dq, f);
      release(&empty[s], lane);
    }
    store_rows<D>(a.dq, dq, a.scale, f, b, q0, a.Sq, a.Hq, h);
  }
}

// -------------------------------------------------------------- dkdv ---

template <int D>
struct DkdvSmem {
  static constexpr int KV = ROWS * D;        // elements of the K or V tile
  static constexpr int TILE = QT * D;        // elements of a Q or dO tile
  static constexpr int ST = stages_of(4 * KV, 4 * TILE + 8 * QT);
  static constexpr int RING = 2 * KV;        // ST x [Q, dO] after K and V
  static constexpr int STATS = 2 * (RING + ST * 2 * TILE);  // bytes
  static constexpr int BARS = STATS + ST * 2 * QT * 4;
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8;
};

// One (query head, query tile) of a dkdv block's warpgroup: s^T and dp^T
// over D, p and ds, dv += p^T . dout and dk += ds^T . q. `ls` and `dl` are
// the tile's lse and delta.
template <int D>
__device__ __forceinline__ void dkdv_tile(
    const bf16* Ks, const bf16* Vs, const bf16* Qs, const bf16* dOs,
    const float* ls, const float* dl, int kc, int q0, const Args& a,
    float (&dk)[D / 2], float (&dv)[D / 2], const Frag& f) {
  float s[QT / 2], dp[QT / 2];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k<ROWS>(Ks, kk), desc_k<QT>(Qs, kk), kk);
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dp, desc_k<ROWS>(Vs, kk), desc_k<QT>(dOs, kk), kk);
  wg_commit();
  wg_wait<1>();
  fence_regs(s);
  const bool edge = kc + ROWS > a.Skv || q0 + QT > a.Sq ||
                    (a.causal && kc + ROWS - 1 > q0 + a.kv_offset);
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) {
    const int c = 8 * (i >> 2) + 2 * f.t4 + (i & 1);
    float p = fast_exp2(s[i] * a.scale_log2 - ls[c] * LOG2E);
    if (edge) {
      const int key = kc + 16 * f.warp + f.g + 8 * ((i >> 1) & 1);
      const int q = q0 + c;
      if (q >= a.Sq || key >= a.Skv || (a.causal && key > q + a.kv_offset))
        p = 0.f;
    }
    s[i] = p;
  }
  wg_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) {
    const int c = 8 * (i >> 2) + 2 * f.t4 + (i & 1);
    dp[i] = s[i] * (dp[i] - dl[c]);
  }
  uint32_t pa[QT / 16][4], da[QT / 16][4];
  to_a<QT>(pa, s);
  to_a<QT>(da, dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk)
    wgmma_rs<D>(dv, pa[kk], desc_mn<QT>(dOs, kk));
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk)
    wgmma_rs<D>(dk, da[kk], desc_mn<QT>(Qs, kk));
  wg_commit();
  wg_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
}

// dk and dv of 64 keys (blockIdx.z) of one KV head (blockIdx.x) of one
// batch (blockIdx.y), over the query tiles of the KV head's query heads.
// Warpgroup 0 computes, warpgroup 1's first warp loads.
template <int D>
__global__ void __launch_bounds__(2 * WG, BLOCKS_SM)
    dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = DkdvSmem<D>;
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::KV;
  bf16* ring = Ks + L::RING;
  float* stats = reinterpret_cast<float*>(smem + L::STATS);  // ST x [l, d]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * ROWS;
  // the block's (query head, query tile) pairs: the group's heads [h0, h0
  // + rep), each over query tiles [qt0, n_qt)
  const int nh = a.rep, h0 = hk * a.rep;
  const int qt0 = a.causal ? max(0, k0 - a.kv_offset) / QT : 0;
  const int nq = max(0, (a.Sq + QT - 1) / QT - qt0);
  const int n_tiles = nh * nq;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA bytes; each lane's stats
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {  // the producer warpgroup: its first warp loads
    reg_dealloc<PRODUCER_REGS>();
    if (tid < WG + 32 && n_tiles > 0) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_expect(kv_full, 2 * L::KV * 2);
        tma_tile<D, ROWS>(Ks, &tk, kv_full, hk, k0, b);
        tma_tile<D, ROWS>(Vs, &tv, kv_full, hk, k0, b);
      }
      wait_prerequisite();  // the dq launch's delta
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        const int h = h0 + t / nq, q0 = (qt0 + t % nq) * QT;
        bf16* qs = ring + s * 2 * L::TILE;
        if (lane == 0) {
          mbar_expect(&full[s], 2 * L::TILE * 2);
          tma_tile<D, QT>(qs, &tq, &full[s], h, q0, b);
          tma_tile<D, QT>(qs + L::TILE, &tdo, &full[s], h, q0, b);
        }
        // the tile's lse and delta rows, zeros past Sq, by each lane's
        // asynchronous copies, which arrive on the stage when they land
        const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
        float* st = stats + s * 2 * QT;
#pragma unroll
        for (int i = lane; i < QT; i += 32) {
          const int q = q0 + i;
          const long long r = row0 + min(q, a.Sq - 1);
          cp_async4(st + i, a.lse + r, q < a.Sq);
          cp_async4(st + QT + i, a.delta + r, q < a.Sq);
        }
        mbar_arrive_copies(&full[s]);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int lane = tid & 31;
    const Frag f(tid);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (n_tiles > 0) mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      const int q0 = (qt0 + t % nq) * QT;
      const bf16* qs = ring + s * 2 * L::TILE;
      const float* st = stats + s * 2 * QT;
      dkdv_tile<D>(Ks, Vs, qs, qs + L::TILE, st, st + QT, k0, q0, a, dk, dv,
                   f);
      release(&empty[s], lane);
    }

    store_rows<D>(a.dk, dk, a.scale, f, b, k0, a.Skv, a.Hkv, hk);
    store_rows<D>(a.dv, dv, 1.f, f, b, k0, a.Skv, a.Hkv, hk);
  }
}

// ------------------------------------------------ wide pairs (wgmma) ---
//
// (192, 128), MLA's keys over values, and (256, 256), gemma's, on the same
// wgmma + TMA machinery as the plan above. That plan does not hold them as
// it stands: its dkdv warpgroup keeps dK and dV in fp32 registers (160 a
// thread at (192, 128), 256 at (256, 256)) beside s and dp, and at D 256
// the K and V tiles and one Q + dO ring stage take 128 KiB, past a block's
// share at two blocks an SM. So the wide instances run one block an SM:
//   * dkdv: one block per (64-key tile, KV head, batch), three
//     warpgroups. The producer warp loads K [64 x D] and V [64 x DV] once
//     and a ring of Q [64 x D] and dO [64 x DV] tiles (2 stages at D 256,
//     4 at (192, 128)) with their lse and delta rows. The two consumer
//     warpgroups split the work by product, so that each product is
//     computed once: WG-V computes s^T = K Q^T (depth D) and p, puts p
//     (fp32, 16 KiB) in shared memory for WG-K and adds dv += p^T . dO;
//     WG-K computes dp^T = V dO^T (depth DV), takes p on a named barrier,
//     forms ds = p (dp - delta) and adds dk += ds^T . Q. Both take the
//     same depth (D + DV) a tile and hold one accumulator (DV / 2 and D / 2
//     fp32 a thread, at most 128) beside their 32 score values: with
//     setmaxnreg a consumer thread takes 240 registers and the producer
//     24. WG-K starts dp once WG-V's s is done (a third named barrier,
//     S_DONE): s then has the tensor cores and shared memory to itself,
//     and dp runs while WG-V turns s into p. At (192, 128) K and V also
//     fit in the registers, as the A operands of s and dp (A_REGS), which
//     then read only Q and dO from shared memory.
//   * dq: one block per (NW x 64 query rows, query head, batch), one
//     consumer warpgroup per 64 rows (dq takes D / 2 fp32 a thread, 128 at
//     D 256), the Q and dO tiles loaded once, the K and V tiles through a
//     ring shared by the warpgroups (2 stages at D 256, 3 at (192, 128));
//     delta as in dq_kernel. Two warpgroups (at (192, 128); at D 256 their
//     tiles leave no room for two stages) halve the K and V bytes a query
//     row and fill each other's gaps on the tensor cores.
// The products over a tile's rows (N = D or DV, past wgmma's 64-row A
// tile) are n128 and n64 wgmmas over the tile's 64-column boxes. Every
// warpgroup waits for its products within the tile: keeping one in flight
// into the next tile (dq's or WG-V's next s behind the last product) made
// ptxas serialise every wgmma of the kernel, and WG-K issuing the next
// tile's dp before it waits for p was slower. Causal tiles with the most
// work start first, the tiles of one head run side by side (their blocks
// stream the same tiles, from L2), and dkdv is a programmatic dependent of
// dq, as in the plan above.

// ring stages, at most 4, that fit beside `fixed` bytes in the 227 KiB a
// block may take at one block an SM (1 KiB for alignment, 1 for barriers)
constexpr int wide_stages(int fixed, int stage) {
  return (232448 - 2048 - fixed) / stage < 4
             ? (232448 - 2048 - fixed) / stage
             : 4;
}
// a wide block of two consumer warpgroups and a producer warpgroup (dkdv,
// and dq with NW 2): its threads' registers under setmaxnreg
constexpr int WIDE_CONSUMER_REGS = 240, WIDE_PRODUCER_REGS = 24;
static_assert(WG * (2 * WIDE_CONSUMER_REGS + WIDE_PRODUCER_REGS) <= 65536,
              "the registers of a wide block");
// named barriers between dkdv's consumer warpgroups: p is in shared
// memory; WG-K has read it; WG-V's s is done
constexpr int BAR_P_FULL = 1, BAR_P_FREE = 2, BAR_S_DONE = 3;

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d[64 x N] += A . B over k16 (N a multiple of 64): A from registers, B
// k-step kk of an MN-major R x N tile of N / 64 boxes, as n128 wgmmas over
// box pairs and an n64 over a last odd box
template <int N, int R>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              const bf16* tile, int kk) {
#pragma unroll
  for (int c = 0; c + 128 <= N; c += 128)
    wgmma_rs_n128_mn(*reinterpret_cast<float(*)[64]>(d + c / 2), a,
                     desc_mn<R>(tile + c * R, kk));
  if constexpr (N % 128 != 0)
    wgmma_rs_n64_mn(*reinterpret_cast<float(*)[32]>(d + N / 2 - 32), a,
                    desc_mn<R>(tile + (N - 64) * R, kk));
}

// d[32] (+)= A . B over k16, A from registers, B from shared memory,
// K-major; acc = 0 overwrites d.
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
    const bf16* p = tile + (c >> 3) * ROWS * BOX + row * BOX +
                    (((c & 7) ^ (row & 7)) << 3);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(smem_u32(p))
        : "memory");
  }
}

template <int D, int DV>
struct WideDqSmem {
  static constexpr int Q = ROWS * D, O = ROWS * DV;  // a Q and a dO tile
  static constexpr int STAGE = ROWS * (D + DV);      // a K and a V tile
  // consumer warpgroups, each with its own 64 query rows on one stream of
  // K and V tiles: two where two ring stages still fit beside their Q and
  // dO tiles, else one
  static constexpr int NW = wide_stages(4 * (Q + O), 2 * STAGE) >= 2 ? 2 : 1;
  static constexpr int ST = wide_stages(2 * NW * (Q + O), 2 * STAGE);
  static constexpr int RING = NW * (Q + O);          // ST stages after them
  static constexpr int BARS = 2 * (RING + ST * STAGE);  // bytes
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8;
};

// One KV tile of a wide dq block (`Ks`, V after it): s over D and dp over
// DV, p and ds, and dq += ds . k.
template <int D, int DV>
__device__ __forceinline__ void dq_wide_tile(
    const bf16* Qs, const bf16* dOs, const bf16* Ks, int kt, int q0,
    const Args& a, const float (&l2)[2], const float (&dl)[2],
    float (&dq)[D / 2], const Frag& f) {
  float s[32], dp[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k<ROWS>(Qs, kk), desc_k<ROWS>(Ks, kk), kk);
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk)
    wgmma_ss_n64(dp, desc_k<ROWS>(dOs, kk), desc_k<ROWS>(Ks + ROWS * D, kk),
                 kk);
  wg_commit();
  wg_wait<1>();
  fence_regs(s);
  const bool edge = kt + ROWS > a.Skv || q0 + ROWS > a.Sq ||
                    (a.causal && kt + ROWS - 1 > q0 + a.kv_offset);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hr = (i >> 1) & 1;
    float p = fast_exp2(s[i] * a.scale_log2 - l2[hr]);
    if (edge) {
      const int key = kt + 8 * (i >> 2) + 2 * f.t4 + (i & 1);
      const int q = q0 + 16 * f.warp + f.g + 8 * hr;
      if (q >= a.Sq || key >= a.Skv || (a.causal && key > q + a.kv_offset))
        p = 0.f;
    }
    s[i] = p;
  }
  wg_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
  uint32_t da[4][4];
  to_a<ROWS>(da, dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_cols<D, ROWS>(dq, da[kk], Ks, kk);
  wg_commit();
  wg_wait<0>();
  fence_regs(dq);
}

// dq, and the rows' delta, of NW x 64 query rows (blockIdx.x) of one query
// head (blockIdx.y) of one batch (blockIdx.z): consumer warpgroup w takes
// rows [64 w, 64 w + 64) of the block's and the KV tiles they see; the
// last warpgroup's first thread loads. The query tiles of a head are
// neighbours in the grid (the last first where causal), so the blocks
// that stream the same K and V tiles run together and read them from L2.
template <int D, int DV>
__global__ void __launch_bounds__((WideDqSmem<D, DV>::NW + 1) * WG, 1)
    dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = WideDqSmem<D, DV>;
  constexpr int ST = L::ST, NW = L::NW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* qd = reinterpret_cast<bf16*>(smem);  // NW x [Q, dO]
  bf16* ring = qd + L::RING;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.rep;
  // causal: the query rows with the most KV tiles start first
  const int q0 = NW * ROWS *
                 (a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x
                           : (int)blockIdx.x);
  // the KV tiles of query rows [r0, r0 + 64), and of the block's
  auto kv_tiles = [&](int r0) {
    if (r0 >= a.Sq) return 0;
    int kv_end = a.Skv;
    if (a.causal) kv_end = min(kv_end, min(r0 + ROWS, a.Sq) + a.kv_offset);
    return (kv_end + ROWS - 1) / ROWS;
  };
  int n_tiles = 0;
  for (int w = 0; w < NW; ++w) n_tiles = max(n_tiles, kv_tiles(q0 + w * ROWS));

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  launch_dependents();

  if (tid >= NW * WG) {  // the producer warpgroup: its first thread loads
    if constexpr (NW > 1) reg_dealloc<WIDE_PRODUCER_REGS>();
    if (tid == NW * WG) {
      mbar_expect(qd_full, 2 * NW * (L::Q + L::O));
      for (int w = 0; w < NW; ++w) {
        bf16* qs = qd + w * (L::Q + L::O);
        tma_tile<D, ROWS>(qs, &tq, qd_full, h, q0 + w * ROWS, b);
        tma_tile<DV, ROWS>(qs + L::Q, &tdo, qd_full, h, q0 + w * ROWS, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        bf16* ks = ring + s * L::STAGE;
        mbar_expect(&full[s], 2 * L::STAGE);
        tma_tile<D, ROWS>(ks, &tk, &full[s], hk, t * ROWS, b);
        tma_tile<DV, ROWS>(ks + ROWS * D, &tv, &full[s], hk, t * ROWS, b);
      }
    }
  } else {
    if constexpr (NW > 1) reg_alloc<WIDE_CONSUMER_REGS>();
    const Frag f(tid & (WG - 1));
    const int lane = tid & 31, w = tid / WG, qw = q0 + w * ROWS;
    const int mine = kv_tiles(qw);  // this warpgroup's KV tiles
    const bf16* Qs = qd + w * (L::Q + L::O);
    const bf16* dOs = Qs + L::Q;
    const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
    float l2[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = qw + 16 * f.warp + f.g + 8 * hr;
      l2[hr] = r < a.Sq ? a.lse[row0 + r] * LOG2E : 0.f;
    }
    // delta = rowsum(dout * o) over DV in fp32, as dq_kernel takes it
    uint4 ov[2][DV / 32];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = qw + 16 * f.warp + f.g + 8 * hr;
      const bf16* orow = a.out + b * a.o_sb + r * a.o_ss + h * a.o_sh;
#pragma unroll
      for (int m = 0; m < DV / 32; ++m)
        ov[hr][m] = r < a.Sq ? *reinterpret_cast<const uint4*>(
                                   orow + 8 * (f.t4 + 4 * m))
                             : make_uint4(0, 0, 0, 0);
    }
    mbar_wait(qd_full, 0);
    float dl[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rr = 16 * f.warp + f.g + 8 * hr, r = qw + rr;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < DV / 32; ++m) {
        const int c = f.t4 + 4 * m, e = c >> 3, cc = c & 7;
        const uint4 dv = *reinterpret_cast<const uint4*>(
            dOs + e * ROWS * BOX + rr * BOX + ((cc ^ (rr & 7)) << 3));
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov[hr][m]);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 of = __bfloat1622float2(o2[k]);
          const float2 df = __bfloat1622float2(d2[k]);
          sum += of.x * df.x + of.y * df.y;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dl[hr] = sum;
      if (f.t4 == 0 && r < a.Sq) a.delta[row0 + r] = sum;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      // a tile past this warpgroup's last is only released
      if (t < mine)
        dq_wide_tile<D, DV>(Qs, dOs, ring + s * L::STAGE, t * ROWS, qw, a,
                            l2, dl, dq, f);
      release(&empty[s], lane);
    }
    store_rows<D>(a.dq, dq, a.scale, f, b, qw, a.Sq, a.Hq, h);
  }
}

template <int D, int DV>
struct WideDkdvSmem {
  static constexpr int K = ROWS * D, V = ROWS * DV;  // the K and V tiles
  static constexpr int STAGE = QT * (D + DV);        // a Q and a dO tile
  static constexpr int P = ROWS * QT;                // p, fp32
  static constexpr int ST =
      wide_stages(2 * (K + V) + 4 * P, 2 * STAGE + 8 * QT);
  static constexpr int RING = K + V;                 // ST stages after V
  static constexpr int PS = 2 * (RING + ST * STAGE);  // bytes
  static constexpr int STATS = PS + 4 * P;
  static constexpr int BARS = STATS + ST * 2 * QT * 4;
  static constexpr int BYTES = BARS + (1 + 2 * ST) * 8;
  // K in WG-V's and V in WG-K's registers as the A operands of s and dp
  // (so those products read only Q and dO from shared memory), where each
  // warpgroup's accumulator and fragments take at most 128 of its 240
  static constexpr bool A_REGS = DV / 2 + D / 4 <= 128 && D / 2 + DV / 4 <= 128;
};

// WG-V on tile t, (query head, query tile) from q0, of a wide dkdv block:
// s^T = K Q^T over D, p (into shared memory for WG-K, once WG-K has read
// the last tile's), dv += p^T . dO. `ls` is the tile's lse. WG-K starts
// its dp only once s is done (S_DONE), so that s has the tensor cores
// alone and dp runs while WG-V turns s into p.
template <int D, int DV>
__device__ __forceinline__ void dv_tile(const bf16* Ks,
                                        const uint32_t (*ka)[4],
                                        const bf16* Qs, const bf16* dOs,
                                        float4* ps, const float* ls, int kc,
                                        int q0, int t, const Args& a,
                                        float (&dv)[DV / 2], const Frag& f,
                                        int ltid) {
  float s[QT / 2];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    if constexpr (WideDkdvSmem<D, DV>::A_REGS)
      wgmma_rs_n64_k(s, ka[kk], desc_k<QT>(Qs, kk), kk);
    else
      wgmma_ss_n64(s, desc_k<ROWS>(Ks, kk), desc_k<QT>(Qs, kk), kk);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  // WG-K has read the last tile's p (and so has passed its S_DONE)
  if (t > 0) bar_sync(BAR_P_FREE, 2 * WG);
  bar_arrive(BAR_S_DONE, 2 * WG);
  const bool edge = kc + ROWS > a.Skv || q0 + QT > a.Sq ||
                    (a.causal && kc + ROWS - 1 > q0 + a.kv_offset);
#pragma unroll
  for (int i = 0; i < QT / 2; ++i) {
    const int c = 8 * (i >> 2) + 2 * f.t4 + (i & 1);
    float p = fast_exp2(s[i] * a.scale_log2 - ls[c] * LOG2E);
    if (edge) {
      const int key = kc + 16 * f.warp + f.g + 8 * ((i >> 1) & 1);
      const int q = q0 + c;
      if (q >= a.Sq || key >= a.Skv || (a.causal && key > q + a.kv_offset))
        p = 0.f;
    }
    s[i] = p;
  }
#pragma unroll
  for (int i = 0; i < QT / 8; ++i)
    ps[i * WG + ltid] =
        make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
  bar_arrive(BAR_P_FULL, 2 * WG);
  uint32_t pa[QT / 16][4];
  to_a<QT>(pa, s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk)
    wgmma_rs_cols<DV, QT>(dv, pa[kk], dOs, kk);
  wg_commit();
  wg_wait<0>();
  fence_regs(dv);
}

// WG-K on one tile of a wide dkdv block: dp^T = V dO^T over DV once WG-V's
// s is done, then p from WG-V, ds = p (dp - delta) and dk += ds^T . Q.
// `dl` is the tile's delta; `last` the block's last tile (WG-V waits for
// no P_FREE after it).
template <int D, int DV>
__device__ __forceinline__ void dk_tile(const bf16* Vs,
                                        const uint32_t (*va)[4],
                                        const bf16* Qs, const bf16* dOs,
                                        const float4* ps, const float* dl,
                                        bool last, float (&dk)[D / 2],
                                        const Frag& f, int ltid) {
  float dp[QT / 2];
  bar_sync(BAR_S_DONE, 2 * WG);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk)
    if constexpr (WideDkdvSmem<D, DV>::A_REGS)
      wgmma_rs_n64_k(dp, va[kk], desc_k<QT>(dOs, kk), kk);
    else
      wgmma_ss_n64(dp, desc_k<ROWS>(Vs, kk), desc_k<QT>(dOs, kk), kk);
  wg_commit();
  wg_wait<0>();
  fence_regs(dp);
  bar_sync(BAR_P_FULL, 2 * WG);
#pragma unroll
  for (int i4 = 0; i4 < QT / 8; ++i4) {
    const float4 p4 = ps[i4 * WG + ltid];
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * i4 + j, c = 8 * (i >> 2) + 2 * f.t4 + (i & 1);
      dp[i] = p[j] * (dp[i] - dl[c]);
    }
  }
  if (!last) bar_arrive(BAR_P_FREE, 2 * WG);
  uint32_t da[QT / 16][4];
  to_a<QT>(da, dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk)
    wgmma_rs_cols<D, QT>(dk, da[kk], Qs, kk);
  wg_commit();
  wg_wait<0>();
  fence_regs(dk);
}

// dk and dv of 64 keys (blockIdx.x) of one KV head (blockIdx.y) of one
// batch (blockIdx.z), over the query tiles of the KV head's query heads.
// The key tiles of a head are neighbours in the grid (the first, with the
// most query tiles where causal, first), so the blocks that stream the
// same Q and dO tiles run together and read them from L2. Warpgroup 0
// (WG-V) computes s, p and dv, warpgroup 1 (WG-K) dp, ds and dk;
// warpgroup 2's first warp loads.
template <int D, int DV>
__global__ void __launch_bounds__(3 * WG, 1)
    dkdv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = WideDkdvSmem<D, DV>;
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::K;
  bf16* ring = Ks + L::RING;
  float4* ps = reinterpret_cast<float4*>(smem + L::PS);
  float* stats = reinterpret_cast<float*>(smem + L::STATS);  // ST x [l, d]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * ROWS, hk = blockIdx.y, b = blockIdx.z;
  // the block's (query head, query tile) pairs: the group's heads [h0, h0
  // + rep), each over query tiles [qt0, n_qt)
  const int nh = a.rep, h0 = hk * a.rep;
  const int qt0 = a.causal ? max(0, k0 - a.kv_offset) / QT : 0;
  const int nq = max(0, (a.Sq + QT - 1) / QT - qt0);
  const int n_tiles = nh * nq;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA bytes; each lane's stats
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * WG) {  // the producer warpgroup: its first warp loads
    reg_dealloc<WIDE_PRODUCER_REGS>();
    if (tid < 2 * WG + 32 && n_tiles > 0) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_expect(kv_full, 2 * (L::K + L::V));
        tma_tile<D, ROWS>(Ks, &tk, kv_full, hk, k0, b);
        tma_tile<DV, ROWS>(Vs, &tv, kv_full, hk, k0, b);
      }
      wait_prerequisite();  // the dq launch's delta
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        const int h = h0 + t / nq, q0 = (qt0 + t % nq) * QT;
        bf16* qs = ring + s * L::STAGE;
        if (lane == 0) {
          mbar_expect(&full[s], 2 * L::STAGE);
          tma_tile<D, QT>(qs, &tq, &full[s], h, q0, b);
          tma_tile<DV, QT>(qs + QT * D, &tdo, &full[s], h, q0, b);
        }
        const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
        float* st = stats + s * 2 * QT;
#pragma unroll
        for (int i = lane; i < QT; i += 32) {
          const int q = q0 + i;
          const long long r = row0 + min(q, a.Sq - 1);
          cp_async4(st + i, a.lse + r, q < a.Sq);
          cp_async4(st + QT + i, a.delta + r, q < a.Sq);
        }
        mbar_arrive_copies(&full[s]);
      }
    }
  } else {
    reg_alloc<WIDE_CONSUMER_REGS>();
    const int lane = tid & 31, ltid = tid & (WG - 1);
    const Frag f(ltid);
    if (n_tiles > 0) mbar_wait(kv_full, 0);
    constexpr bool A_REGS = L::A_REGS;
    if (tid < WG) {  // WG-V
      float dv[DV / 2];
      uint32_t ka[A_REGS ? D / 16 : 1][4];
      if constexpr (A_REGS) load_a<D>(ka, Ks, f.warp, lane);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(&full[s], (t / ST) & 1);
        const int q0 = (qt0 + t % nq) * QT;
        const bf16* qs = ring + s * L::STAGE;
        dv_tile<D, DV>(Ks, ka, qs, qs + QT * D, ps, stats + s * 2 * QT, k0,
                       q0, t, a, dv, f, ltid);
        release(&empty[s], lane);
      }
      store_rows<DV>(a.dv, dv, 1.f, f, b, k0, a.Skv, a.Hkv, hk);
    } else {  // WG-K
      float dk[D / 2];
      uint32_t va[A_REGS ? DV / 16 : 1][4];
      if constexpr (A_REGS) load_a<DV>(va, Vs, f.warp, lane);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(&full[s], (t / ST) & 1);
        const bf16* qs = ring + s * L::STAGE;
        dk_tile<D, DV>(Vs, va, qs, qs + QT * D, ps, stats + s * 2 * QT + QT,
                       t + 1 == n_tiles, dk, f, ltid);
        release(&empty[s], lane);
      }
      store_rows<D>(a.dk, dk, a.scale, f, b, k0, a.Skv, a.Hkv, hk);
    }
  }
}

// ------------------------------------------------------------- host ---

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

// Make the device's primary context current on the calling thread.
// cuTensorMapEncodeTiled needs one, and a thread whose first CUDA call
// this is has none: autograd's device thread, when this backward is the
// first work it runs (on device 0 torch makes no runtime call there
// first). Any runtime call makes it current; cudaFree(nullptr) does
// nothing else.
int current_context() { return cudaFree(nullptr); }

// The tensor map of a [B, S, H, D] bf16 tensor (element strides sb, ss,
// sh; a dimension of one takes any stride, so it gets the row's) in
// boxes of `rows` rows by 64 columns, 128-byte swizzled, zeros past S.
int make_map(CUtensorMap* m, const void* p, int B, int S, int H, int D,
             long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  auto st = [&](int n, long long s) {
    return static_cast<cuuint64_t>(n == 1 ? D : s) * 2;
  };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {st(H, sh), st(S, ss), st(B, sb)};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// `dependent`: launched as a programmatic dependent of the kernel before it
// on the stream (which must then not read that kernel's results before
// wait_prerequisite())
template <typename K>
int launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
           const CUtensorMap (&m)[4], const Args& a, bool dependent) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], m[3], a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

static_assert(DqSmem<128>::ST >= 2 && DkdvSmem<128>::ST >= 2 &&
                  WideDqSmem<256, 256>::ST >= 2 &&
                  WideDkdvSmem<256, 256>::ST >= 2 &&
                  WideDqSmem<192, 128>::NW == 2 &&
                  WideDkdvSmem<192, 128>::A_REGS,
              "two ring stages fit; at (192, 128) two dq warpgroups, and K and "
              "V in registers");

// the (key, value) head sizes: the wgmma plan's (64, 64) and (128, 128),
// the wide instances' (192, 128) and (256, 256)
bool wgmma_pair(int D, int DV) { return D == DV && (D == 64 || D == 128); }
bool wide_pair(int D, int DV) {
  return (D == 192 && DV == 128) || (D == 256 && DV == 256);
}

bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv, int D, int DV) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         !(wgmma_pair(D, DV) || wide_pair(D, DV));
}

}  // namespace

extern "C" {

// dq [B, Sq, Hq, D] (bf16, contiguous) and delta [B, Hq, Sq] (fp32,
// contiguous) = rowsum(dout * out), from q [B, Sq, Hq, D], out, dout [B,
// Sq, Hq, DV], k [B, Skv, Hkv, D], v [B, Skv, Hkv, DV] (bf16, element
// strides) and the forward's lse [B, Hq, Sq] (fp32, contiguous). Grid
// (Hq, B, ceil(Sq / 64)); at the wide pairs (ceil(Sq / (64 NW)), Hq, B).
int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int DV,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, float scale,
    int causal, int kv_offset, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, DV)) return cudaErrorInvalidValue;
  int err;
  if ((err = current_context())) return err;
  CUtensorMap m[4];
  if ((err = make_map(&m[0], q, B, Sq, Hq, D, q_sb, q_ss, q_sh, ROWS)) ||
      (err = make_map(&m[1], k, B, Skv, Hkv, D, k_sb, k_ss, k_sh, ROWS)) ||
      (err = make_map(&m[2], v, B, Skv, Hkv, DV, v_sb, v_ss, v_sh, ROWS)) ||
      (err = make_map(&m[3], dout, B, Sq, Hq, DV, do_sb, do_ss, do_sh,
                      ROWS)))
    return err;
  const Args a{static_cast<const bf16*>(out), static_cast<const float*>(lse),
               static_cast<float*>(delta), static_cast<bf16*>(dq),
               nullptr, nullptr, B, Sq, Skv, Hq, Hkv, Hq / Hkv,
               o_sb, o_ss, o_sh, scale, scale * LOG2E, causal, kv_offset};
  const int n_qt = (Sq + ROWS - 1) / ROWS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch(dq_kernel<64>, dim3(Hq, B, n_qt), 2 * WG,
                  DqSmem<64>::BYTES + 1024, s, m, a, false);
  if (D == 128)
    return launch(dq_kernel<128>, dim3(Hq, B, n_qt), 2 * WG,
                  DqSmem<128>::BYTES + 1024, s, m, a, false);
  using M = WideDqSmem<192, 128>;
  using G = WideDqSmem<256, 256>;
  if (D == 192)
    return launch(dq_wide_kernel<192, 128>,
                  dim3((Sq + M::NW * ROWS - 1) / (M::NW * ROWS), Hq, B),
                  (M::NW + 1) * WG, M::BYTES + 1024, s, m, a, false);
  return launch(dq_wide_kernel<256, 256>,
                dim3((Sq + G::NW * ROWS - 1) / (G::NW * ROWS), Hq, B),
                (G::NW + 1) * WG, G::BYTES + 1024, s, m, a, false);
}

// dk [B, Skv, Hkv, D], dv [B, Skv, Hkv, DV] (bf16, contiguous) from q [B,
// Sq, Hq, D], dout [B, Sq, Hq, DV], k, v (bf16, element strides), lse and
// the dq launch's delta [B, Hq, Sq] (fp32, contiguous). Grid (Hkv, B,
// ceil(Skv / 64)); at the wide pairs (ceil(Skv / 64), Hkv, B).
int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int DV,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int kv_offset, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv, D, DV)) return cudaErrorInvalidValue;
  int err;
  if ((err = current_context())) return err;
  CUtensorMap m[4];
  if ((err = make_map(&m[0], q, B, Sq, Hq, D, q_sb, q_ss, q_sh, QT)) ||
      (err = make_map(&m[1], k, B, Skv, Hkv, D, k_sb, k_ss, k_sh, ROWS)) ||
      (err = make_map(&m[2], v, B, Skv, Hkv, DV, v_sb, v_ss, v_sh, ROWS)) ||
      (err = make_map(&m[3], dout, B, Sq, Hq, DV, do_sb, do_ss, do_sh, QT)))
    return err;
  const Args a{nullptr, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)),
               nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               B, Sq, Skv, Hq, Hkv, Hq / Hkv, 0, 0, 0,
               scale, scale * LOG2E, causal, kv_offset};
  // key blocks slowest, so that where causal the first (most query tiles)
  // start first
  const int n_kt = (Skv + ROWS - 1) / ROWS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch(dkdv_kernel<64>, dim3(Hkv, B, n_kt), 2 * WG,
                  DkdvSmem<64>::BYTES + 1024, s, m, a, true);
  if (D == 128)
    return launch(dkdv_kernel<128>, dim3(Hkv, B, n_kt), 2 * WG,
                  DkdvSmem<128>::BYTES + 1024, s, m, a, true);
  const dim3 wide_grid(n_kt, Hkv, B);
  if (D == 192)
    return launch(dkdv_wide_kernel<192, 128>, wide_grid, 3 * WG,
                  WideDkdvSmem<192, 128>::BYTES + 1024, s, m, a, true);
  return launch(dkdv_wide_kernel<256, 256>, wide_grid, 3 * WG,
                WideDkdvSmem<256, 256>::BYTES + 1024, s, m, a, true);
}

}  // extern "C"
