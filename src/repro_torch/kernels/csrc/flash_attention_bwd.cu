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
// {(64, 64), (128, 128)}, the wgmma plan below, and {(192, 128), (256,
// 256)}, the mma.sync instance of "wide pairs". Query head h reads KV head
// h / (Hq / Hkv).
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
// the group is not split over blocks.
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

// -------------------------------------------- wide pairs (mma.sync) ---
//
// (192, 128), MLA's keys over values, and (256, 256), gemma's. The wgmma
// plan above does not hold them: dkdv's warpgroup would keep dK and dV in
// fp32 registers, 160 a thread at (192, 128) and 256 at (256, 256), beside
// the s and dp fragments; and at D 256 the K and V tiles and one Q + dO
// ring stage take 128 KiB, past a block's share at two blocks an SM. So
// these pairs have an instance of their own, FlashAttention-2's backward
// on mma.sync m16n8k16 (bf16 -> fp32), one block an SM, cp.async rings:
//   * dq: one block of 4 warps per (64-row query tile, query head, batch),
//     each warp 16 rows, the Q and dout tiles loaded once, the K and V
//     tiles through a 2-stage ring; it computes its rows' delta from the
//     dout tile and o and writes it for dkdv, as the wgmma dq does. dq
//     takes D / 2 fp32 registers a thread (128 at D 256);
//   * dkdv: one block of 8 warps per (64-key tile, KV head, batch) over
//     the query tiles of the KV head's query heads (no two blocks add into
//     one row, no atomics). Warps 0-3 own dV and warps 4-7 dK, each warp
//     16 keys: both compute s^T = K Q^T for their keys, the dV warps then
//     p and dv += p^T . dout, the dK warps dp^T = V dout^T, ds and dk +=
//     ds^T . q. So each warp holds one accumulator (DV / 2 or D / 2
//     registers, at most 128) and s is computed twice, one product of the
//     six: the separate dV and dK passes of the forward's D 256, in one
//     launch that streams each Q and dout tile once.
// Tiles are bf16 rows of 16-byte chunks swizzled by (row & 7); A fragments
// by ldmatrix.x4 on a tile's rows (or p and ds packed from C fragments), B
// fragments by ldmatrix.x4 ([n][k] tiles) or ldmatrix.x4.trans ([k][n]).
// The numerics are those of the wgmma kernels: p by ex2.approx from the
// forward's lse, p and ds rounded to bf16 for their products, fp32
// accumulators, every sum in one fixed order.

namespace wide {

constexpr int BQ = 64;    // dq: query rows of a block (4 warps x 16)
constexpr int BKV = 64;   // keys of a tile (dkdv: of a block)
constexpr int QT = 64;    // dkdv: query rows of a streamed tile
constexpr int NST = 2;    // ring stages
constexpr int DQ_THREADS = 128, DKDV_THREADS = 256;

struct WArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* out;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Sq, Skv, Hq, Hkv, rep;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  float scale, scale_log2;
  int causal, kv_offset;
};

// element offset of 16-byte chunk `chunk` of row `row` in a [.][W] tile
// whose chunks are swizzled by (row & 7) (W a multiple of 64)
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * W + ((chunk ^ (row & 7)) << 3);
}
// the offset within a row of chunk 2 i + c0, z = c0 ^ (row & 7)
__device__ __forceinline__ int swz_step(int i, int z) {
  return (((2 * i) & ~7) + (((2 * i) & 7) ^ z)) << 3;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b on one m16n8k16 tile (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, n) of an NROWS x W tile from g (row stride ld) into its
// swizzled shared tile by 16-byte cp.async, NT threads; zeros from row n
template <int W, int NROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long ld, int n, int tid) {
  constexpr int CH = W / 8;
  static_assert(NROWS * CH % NT == 0, "tile chunks per thread");
#pragma unroll
  for (int it = 0; it < NROWS * CH / NT; ++it) {
    const int i = tid + it * NT, r = i / CH, c = i % CH;
    const bool ok = r < n;
    cp_async16(s + swz<W>(r, c), g + (ok ? r * ld : 0) + c * 8, ok);
  }
}

// C [16 rows][NB * 8 cols] += A . B^T over W: A the warp's 16 rows of a
// swizzled [.][W] tile (a_lane at the lane's row), B the rows [0, NB * 8)
// of another
template <int W, int NB>
__device__ __forceinline__ void mma_abt(float (&c)[NB][4], const bf16* a_lane,
                                        const bf16* b, int brow, int za,
                                        int zb) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_lane + swz_step(kk, za));
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (brow + 16 * jj) * W + swz_step(kk, zb));
      mma_bf16(c[2 * jj], af, bf[0], bf[1]);
      mma_bf16(c[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc [16 rows][W] += P . T: P [16][NB * 8] in C fragments (rounded to
// bf16 here), T the rows [0, NB * 8) of a swizzled [.][W] tile
template <int W, int NB>
__device__ __forceinline__ void mma_pt(float (*acc)[4],
                                       const float (&p)[NB][4], const bf16* t,
                                       int trow, int zt) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jj = 0; jj < W / 16; ++jj) {
      uint32_t tf[4];
      ldsm_x4_trans(tf, t + (trow + 16 * kk) * W + swz_step(jj, zt));
      mma_bf16(acc[2 * jj], pa, tf[0], tf[1]);
      mma_bf16(acc[2 * jj + 1], pa, tf[2], tf[3]);
    }
  }
}

// rows r and r + 8 of a [B, S, H, W] output (contiguous) from a warp's C
// fragments acc [W / 8][4] times `mul`; row i of the pair is `rows[i]`
template <int W>
__device__ __forceinline__ void store_pair(bf16* out, float (*acc)[4],
                                           float mul, const int (&rows)[2],
                                           int S, int H, int b, int h,
                                           int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    bf16* row = out + (((long long)b * S + rows[i]) * H + h) * W + 2 * t4;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// dq and delta of one 64-row query tile of one query head of one batch
template <int D, int DV>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    dq_wide_kernel(const WArgs a) {
  constexpr int NB = BKV / 8;               // n-blocks of a score tile
  constexpr int STAGE = BKV * (D + DV);     // a K and a V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][D]
  bf16* dOs = Qs + BQ * D;                   // [BQ][DV]
  bf16* ring = dOs + BQ * DV;                // [NST][K [BKV][D], V [BKV][DV]]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.rep;
  // causal: the query tiles with the most KV tiles start first
  const int q0 = BQ * (a.causal ? (int)gridDim.z - 1 - (int)blockIdx.z
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
    bf16* ks = ring + (t % NST) * STAGE;
    const int kt = t * BKV;
    load_tile<D, BKV, DQ_THREADS>(ks, kg + kt * a.k_ss, a.k_ss, a.Skv - kt,
                                  tid);
    load_tile<DV, BKV, DQ_THREADS>(ks + BKV * D, vg + kt * a.v_ss, a.v_ss,
                                   a.Skv - kt, tid);
  };
  load_tile<D, BQ, DQ_THREADS>(Qs, a.q + b * a.q_sb + h * a.q_sh +
                                       q0 * a.q_ss,
                               a.q_ss, a.Sq - q0, tid);
  load_tile<DV, BQ, DQ_THREADS>(dOs, a.dout + b * a.do_sb + h * a.do_sh +
                                         q0 * a.do_ss,
                                a.do_ss, a.Sq - q0, tid);
  if (n_tiles > 0) issue_tile(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // rows g and g + 8 of the warp: lse in base 2, and delta = rowsum(dout
  // * o) in fp32 (each of a quad's threads takes every fourth 16-byte
  // chunk of the row, then the quad sums its four parts), written for dkdv
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = 16 * warp + g + 8 * i, r = q0 + rr;
    float sum = 0.f;
    if (r < a.Sq) {
      const bf16* orow = a.out + b * a.o_sb + r * a.o_ss + h * a.o_sh;
#pragma unroll
      for (int m = 0; m < DV / 32; ++m) {
        const int c = t4 + 4 * m;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dOs + swz<DV>(rr, c));
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          sum += of.x * df.x + of.y * df.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[i] = sum;
    const long long row = ((long long)b * a.Hq + h) * a.Sq + r;
    l2[i] = r < a.Sq ? a.lse[row] * LOG2E : 0.f;
    if (t4 == 0 && r < a.Sq) a.delta[row] = sum;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const int arow = 16 * warp + (lane & 15);
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int trow = lane & 15;
  const int za = (lane >> 4) ^ (lane & 7);
  const int zb = ((lane >> 3) & 1) ^ (lane & 7);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t - 1 read by all
    if (t + 1 < n_tiles) issue_tile(t + 1);
    cp_async_commit();
    const bf16* ks = ring + (t % NST) * STAGE;
    const bf16* vs = ks + BKV * D;
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
    mma_abt<DV, NB>(dp, dOs + arow * DV, vs, brow, za, zb);
    // element e of n-block j: row g + 8 (e / 2), key kt + 8 j + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < NB; ++j)
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
    mma_pt<D, NB>(dq, dp, ks, trow, za);  // dq += ds . k
  }
  cp_async_wait_all();
  const int rows[2] = {r0 + g, r0 + g + 8};
  store_pair<D>(a.dq, dq, a.scale, rows, a.Sq, a.Hq, b, h, t4);
}

// dk and dv of 64 keys of one KV head of one batch: warps 0-3 dv, 4-7 dk
template <int D, int DV>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
    dkdv_wide_kernel(const WArgs a) {
  constexpr int NB = QT / 8;                 // n-blocks of a score tile
  constexpr int STAGE = QT * (D + DV);       // a Q and a dout tile
  constexpr int AW = D > DV ? D : DV;        // the wider accumulator
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BKV][D]
  bf16* Vs = Ks + BKV * D;                   // [BKV][DV]
  bf16* ring = Vs + BKV * DV;                // [NST][Q [QT][D], dO [QT][DV]]
  float* Ls = reinterpret_cast<float*>(ring + NST * STAGE);  // [NST][QT]
  float* Ds = Ls + NST * QT;                                 // [NST][QT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool dv_warp = warp < 4;
  const int kw0 = blockIdx.x * BKV + 16 * (warp & 3);
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  // query tiles: from the first that can see key k0, over the rep heads
  const int qt0 = a.causal ? max(0, k0 - a.kv_offset) / QT : 0;
  const int nq = max(0, (a.Sq + QT - 1) / QT - qt0);
  const int n_tiles = a.rep * nq;

  auto tile_q0 = [&](int t) { return (qt0 + t % nq) * QT; };
  auto issue_tile = [&](int t) {
    const int h = hk * a.rep + t / nq, q0 = tile_q0(t);
    bf16* qs = ring + (t % NST) * STAGE;
    load_tile<D, QT, DKDV_THREADS>(
        qs, a.q + b * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss, a.Sq - q0,
        tid);
    load_tile<DV, QT, DKDV_THREADS>(
        qs + QT * D, a.dout + b * a.do_sb + h * a.do_sh + q0 * a.do_ss,
        a.do_ss, a.Sq - q0, tid);
    if (tid < QT) {
      const int r = q0 + tid;
      const long long row = ((long long)b * a.Hq + h) * a.Sq + r;
      Ls[(t % NST) * QT + tid] = r < a.Sq ? a.lse[row] * LOG2E : 0.f;
      Ds[(t % NST) * QT + tid] = r < a.Sq ? a.delta[row] : 0.f;
    }
  };
  load_tile<D, BKV, DKDV_THREADS>(Ks, a.k + b * a.k_sb + hk * a.k_sh +
                                          k0 * a.k_ss,
                                  a.k_ss, a.Skv - k0, tid);
  load_tile<DV, BKV, DKDV_THREADS>(Vs, a.v + b * a.v_sb + hk * a.v_sh +
                                           k0 * a.v_ss,
                                   a.v_ss, a.Skv - k0, tid);
  if (n_tiles > 0) issue_tile(0);
  cp_async_commit();

  float acc[AW / 8][4];  // dv (DV / 8 blocks) or dk (D / 8)
#pragma unroll
  for (int n = 0; n < AW / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // the lane's ldmatrix rows: A rows of K / V, B rows of a [queries][.]
  // tile, non-transposed; T rows of it, transposed
  const int arow = 16 * (warp & 3) + (lane & 15);
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int trow = lane & 15;
  const int za = (lane >> 4) ^ (lane & 7);
  const int zb = ((lane >> 3) & 1) ^ (lane & 7);
  const int kpos[2] = {kw0 + g, kw0 + g + 8};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t (and K, V) landed; tile t - 1 read by all
    if (t + 1 < n_tiles) issue_tile(t + 1);
    cp_async_commit();
    const bf16* qs = ring + (t % NST) * STAGE;
    const bf16* dos = qs + QT * D;
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
    // s^T = K Q^T over the warp's 16 keys x QT queries; element e of
    // n-block j: key kpos[e / 2], query q0 + 8 j + 2 t4 + e % 2
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_abt<D, NB>(s, Ks + arow * D, qs, brow, za, zb);
#pragma unroll
    for (int j = 0; j < NB; ++j)
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
      }
    if (dv_warp) {
      mma_pt<DV, NB>(acc, s, dos, trow, za);  // dv += p^T . dout
    } else {
      // dp^T = V dout^T, ds = p (dp - delta), dk += ds^T . q
      float dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
      mma_abt<DV, NB>(dp, Vs + arow * DV, dos, brow, za, zb);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - ds[8 * j + 2 * t4 + (e & 1)]);
      mma_pt<D, NB>(acc, dp, qs, trow, za);
    }
  }
  cp_async_wait_all();  // a block with no query tile issued K and V only
  if (dv_warp)
    store_pair<DV>(a.dv, acc, 1.f, kpos, a.Skv, a.Hkv, b, hk, t4);
  else
    store_pair<D>(a.dk, acc, a.scale, kpos, a.Skv, a.Hkv, b, hk, t4);
}

// Q, dout and the ring of K and V tiles; K, V and the ring of Q and dout
// tiles with their lse and delta rows
template <int D, int DV>
constexpr int dq_smem() {
  return 2 * (BQ * (D + DV) + NST * BKV * (D + DV));
}
template <int D, int DV>
constexpr int dkdv_smem() {
  return 2 * (BKV * (D + DV) + NST * QT * (D + DV)) + 4 * 2 * NST * QT;
}
static_assert(dq_smem<256, 256>() <= 232448 &&
                  dkdv_smem<256, 256>() <= 232448,
              "a block may take 227 KiB of shared memory");

template <typename K>
int launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
           const WArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace wide

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

static_assert(DqSmem<128>::ST >= 2 && DkdvSmem<128>::ST >= 2,
              "two ring stages fit");

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

wide::WArgs wide_args(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, int Sq, int Skv,
                      int Hq, int Hkv, long long q_sb, long long q_ss,
                      long long q_sh, long long k_sb, long long k_ss,
                      long long k_sh, long long v_sb, long long v_ss,
                      long long v_sh, long long do_sb, long long do_ss,
                      long long do_sh, float scale, int causal,
                      int kv_offset) {
  wide::WArgs a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
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
  a.do_sb = do_sb;
  a.do_ss = do_ss;
  a.do_sh = do_sh;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  a.kv_offset = kv_offset;
  return a;
}

}  // namespace

extern "C" {

// dq [B, Sq, Hq, D] (bf16, contiguous) and delta [B, Hq, Sq] (fp32,
// contiguous) = rowsum(dout * out), from q [B, Sq, Hq, D], out, dout [B,
// Sq, Hq, DV], k [B, Skv, Hkv, D], v [B, Skv, Hkv, DV] (bf16, element
// strides) and the forward's lse [B, Hq, Sq] (fp32, contiguous). Grid
// (Hq, B, ceil(Sq / 64)).
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
  if (wide_pair(D, DV)) {
    wide::WArgs a = wide_args(q, k, v, dout, lse, Sq, Skv, Hq, Hkv, q_sb,
                              q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                              v_sh, do_sb, do_ss, do_sh, scale, causal,
                              kv_offset);
    a.out = static_cast<const bf16*>(out);
    a.o_sb = o_sb;
    a.o_ss = o_ss;
    a.o_sh = o_sh;
    a.delta = static_cast<float*>(delta);
    a.dq = static_cast<bf16*>(dq);
    const dim3 grid(Hq, B, (Sq + wide::BQ - 1) / wide::BQ);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 192)
      return wide::launch(wide::dq_wide_kernel<192, 128>, grid,
                          wide::DQ_THREADS, wide::dq_smem<192, 128>(), s, a);
    return wide::launch(wide::dq_wide_kernel<256, 256>, grid,
                        wide::DQ_THREADS, wide::dq_smem<256, 256>(), s, a);
  }
  CUtensorMap m[4];
  if ((err = make_map(&m[0], q, B, Sq, Hq, D, q_sb, q_ss, q_sh, ROWS)) ||
      (err = make_map(&m[1], k, B, Skv, Hkv, D, k_sb, k_ss, k_sh, ROWS)) ||
      (err = make_map(&m[2], v, B, Skv, Hkv, D, v_sb, v_ss, v_sh, ROWS)) ||
      (err = make_map(&m[3], dout, B, Sq, Hq, D, do_sb, do_ss, do_sh, ROWS)))
    return err;
  const Args a{static_cast<const bf16*>(out), static_cast<const float*>(lse),
               static_cast<float*>(delta), static_cast<bf16*>(dq),
               nullptr, nullptr, B, Sq, Skv, Hq, Hkv, Hq / Hkv,
               o_sb, o_ss, o_sh, scale, scale * LOG2E, causal, kv_offset};
  const dim3 grid(Hq, B, (Sq + ROWS - 1) / ROWS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch(dq_kernel<64>, grid, 2 * WG, DqSmem<64>::BYTES + 1024, s,
                  m, a, false);
  return launch(dq_kernel<128>, grid, 2 * WG, DqSmem<128>::BYTES + 1024, s,
                m, a, false);
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
  if (wide_pair(D, DV)) {
    wide::WArgs a = wide_args(q, k, v, dout, lse, Sq, Skv, Hq, Hkv, q_sb,
                              q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                              v_sh, do_sb, do_ss, do_sh, scale, causal,
                              kv_offset);
    a.delta = const_cast<float*>(static_cast<const float*>(delta));
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    const dim3 grid((Skv + wide::BKV - 1) / wide::BKV, Hkv, B);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 192)
      return wide::launch(wide::dkdv_wide_kernel<192, 128>, grid,
                          wide::DKDV_THREADS, wide::dkdv_smem<192, 128>(), s,
                          a);
    return wide::launch(wide::dkdv_wide_kernel<256, 256>, grid,
                        wide::DKDV_THREADS, wide::dkdv_smem<256, 256>(), s,
                        a);
  }
  CUtensorMap m[4];
  if ((err = make_map(&m[0], q, B, Sq, Hq, D, q_sb, q_ss, q_sh, QT)) ||
      (err = make_map(&m[1], k, B, Skv, Hkv, D, k_sb, k_ss, k_sh, ROWS)) ||
      (err = make_map(&m[2], v, B, Skv, Hkv, D, v_sb, v_ss, v_sh, ROWS)) ||
      (err = make_map(&m[3], dout, B, Sq, Hq, D, do_sb, do_ss, do_sh, QT)))
    return err;
  const Args a{nullptr, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)),
               nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               B, Sq, Skv, Hq, Hkv, Hq / Hkv, 0, 0, 0,
               scale, scale * LOG2E, causal, kv_offset};
  // key blocks slowest: where causal, the first (most query tiles) start
  // first
  const dim3 grid(Hkv, B, (Skv + ROWS - 1) / ROWS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch(dkdv_kernel<64>, grid, 2 * WG, DkdvSmem<64>::BYTES + 1024,
                  s, m, a, true);
  return launch(dkdv_kernel<128>, grid, 2 * WG, DkdvSmem<128>::BYTES + 1024,
                s, m, a, true);
}

}  // extern "C"
