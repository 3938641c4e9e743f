// Fused split GEMM of the N3H-Core heterogeneous layer (paper Eq. 12)
// for Hopper (sm_90a): wgmma with the weights as the register operand,
// built from bit-packed K-major words; a producer warpgroup's cp.async
// ring on mbarriers; split-K over a thread-block cluster.
//
// Two C entry points, one for each TPU kernel it replaces:
//
//   fused_hetero_gemm  replaces repro/kernels/fused_hetero_gemm.py:106
//                      fused_hetero_gemm (_fused_kernel): [M, K] int8
//                      against both sides of the split in one launch.
//   fused_conv_gemm    replaces repro/kernels/fused_hetero_gemm.py:232
//                      fused_conv_gemm (_fused_conv_kernel): the same
//                      GEMM with im2col gathered inside the kernel from
//                      the unpadded NHWC block.
//
// What it computes. Output columns [0, n_lut) are the LUT core's:
// out = (sum_b s_b * (x @ plane_b)) * scale, s_b = 2^b with the MSB plane
// weighted -2^(bits-1). Columns [n_lut, n_lut + n_dsp) are the DSP core's:
// out = (x @ w) * scale, w int4 codes in [-8, 7]. Both accumulate exactly
// in int32; the epilogue converts to fp32 and multiplies by the
// per-column scale, the same two IEEE operations as the plain version, so
// every output is bitwise equal to it.
//
// The weights come in the port's K-major layout, made once at bind
// (ops.prepare_split; ref.pack_bits_kmajor / pack_int4_kmajor), every row
// zero-padded to a multiple of 16 bytes, so every row of every shard
// width starts 16-byte aligned:
//   LUT  int32 [bits, n_lut, ceil(K / 128) * 4]: bit k % 32 of word k / 32
//        of row (b, n) is plane b's bit of weight (k, n);
//   DSP  int32 [n_dsp, ceil(K / 32) * 4]: nibble k % 8 of word k / 8 of
//        row n is the two's-complement code (k, n), lowest nibble first.
// A zero bit or code adds 0, so the padding needs no mask.
//
// What bounds it on an H100. At code width resnet18's weights are ~5.8
// MB an image and llama3.2-1b's decode layers ~0.6 GB a step: at M of a few
// tokens the kernel is a stream of weight bytes (3.35 TB/s). At M in the
// thousands (the co-design loop's M = 4096, resnet18's first layers) the
// int8 product is 2·M·K·N operations at 1,979 TOP/s and the activations
// are re-read from L2 by every column tile.
//
// Design.
//   * Swapped operands: out^T = W^T . x^T. The weights are the A operand,
//     from registers: a consumer warpgroup owns 64 output columns. The
//     activations are the B operand, K-major in shared memory (x rows are
//     K-contiguous). The token tile T, a compile-time 8, 16, 32, 64, 128
//     or 256 that kernels/fused_hetero_gemm.py::fused_plan picks with the
//     rest of the launch, is wgmma m64nTk32's N (.s32.s8.s8) at T >= 64.
//     Below 64 tokens a wgmma costs its fixed latency, not its work, so
//     each warp runs its 16 rows by mma.sync m16n8k32 on the same A
//     registers (wgmma's A layout is mma.sync's, a warp a 16-row slice)
//     into NACC accumulators of the same layout, so that k32 slices do
//     not wait on each other: decode's 8 tokens fill N = 8 exactly.
//   * A block: two consumer warpgroups and one producer warpgroup (384
//     threads). The consumers take either 2 x 64 columns of one token
//     tile (wc = 2) or 64 columns of two token tiles (wc = 1). The column
//     tiles of the LUT and DSP regions are numbered separately; the DSP
//     tile writes at column offset n_lut. A warpgroup whose columns or
//     tokens lie wholly past the edge skips its products. The rank and
//     the warpgroup index are broadcast from lane 0 (__shfl_sync), so
//     ptxas sees the branches on them as warp-uniform and does not
//     serialise the wgmmas.
//   * A fragments built in registers, no transpose. wgmma's A layout gives
//     lane (g, q) of warp w the rows (columns of W) 16 w + g and + 8 and
//     k 4 q + 0..3 (registers 0, 1) and 16 + 4 q + 0..3 (registers 2, 3)
//     of each k32 step, so each register comes from one weight word:
//       LUT  a nibble of a plane's word spread to four 0/1 bytes,
//            (nib * 0x00204081) & 0x01010101, times the plane weight as
//            an unsigned byte (2^b, the MSB's 256 - 2^(bits-1));
//       DSP  16 bits (four codes) of a word to four bytes (a byte_perm and
//            one shift-or), sign-extended by or-ing 0xF0 where bit 3 is set.
//   * Planes folded into one int8 operand. Per (k, n) the plane terms
//     s_b·bit_b, added byte-wise, are the int8 code itself in
//     [-2^(bits-1), 2^(bits-1) - 1]: the low planes' sum is at most
//     2^(bits-1) - 1 and the MSB's byte 256 - 2^(bits-1), so no byte
//     carries into the next and a 32-bit add is __vadd4. A LUT column
//     costs one tensor pass whatever its bit width; this fold replaces
//     the plane loop of the kernel's earlier design (one mma pass per
//     bit plane). The integers, and so the outputs, are the same bits;
//     the bit width's cost is the cost model's business
//     (core/latency_model.py), not the kernel's. Overflow margin: |x| <=
//     128, |w| <= 128 and K <= 4608 bound every sum by 75.5e6, 28x below
//     2^31.
//   * The ring. Each K step is 128 bytes of K: one 128-byte row a token,
//     stored in the 128-byte swizzle the wgmma descriptor reads (16-byte
//     chunk c of row r at chunk c ^ (r % 8)), and the step's words (LUT
//     16 bytes a (plane, column); DSP 64 bytes a column in 80-byte rows,
//     conflict-free for the fragment loads). The producer warpgroup
//     copies a stage by cp.async (16-byte pieces; 8 or 4 where K or the
//     conv's C is not a multiple of 16), zero-filled at every edge, which
//     for the conv is exactly the padding (a piece lies inside one tap;
//     each row's window origin comes from a table built at the start).
//     Where neither is a multiple of 4 (conv1's C = 3) a thread gathers
//     4 bytes of a row with four independent loads, their taps decoded
//     once, into one 4-byte store. Each producer thread then arrives on
//     the stage's full barrier (cp.async.mbarrier.arrive, and a plain
//     arrive for its stores); each consumer warp arrives on its empty
//     barrier once its products no longer read it. The ring holds 2 to
//     8 stages (fused_plan sizes it to the shared memory and the steps),
//     so at M = 8 a block keeps tens of KB of weight words in flight.
//   * The consumers overlap: the A fragments of step t + 1 are built while
//     step t's wgmmas run (two register sets), then the warpgroup waits
//     for them and frees the stage. setmaxnreg gives a consumer thread
//     208 registers and the producer 88 at T >= 64; at T <= 16 two blocks
//     share an SM.
//   * Split-K over a cluster. The grid is (column tiles x S, token tiles)
//     and the S blocks of one tile form one cluster (S in {1, 2, 4, 8}).
//     Block r walks K steps [r * steps / S, (r + 1) * steps / S), writes
//     its int32 partial tile to its shared memory, and after a cluster
//     barrier reduces a disjoint 1/S of the tile over distributed shared
//     memory in rank order (the S loads issued together), dequantizes it
//     and stores fp32. Integer addition is exact in any order, so every S
//     gives the same bits. Unsplit (S = 1), each consumer dequantizes and
//     stores its accumulator straight from registers.

// Resources and times: chip_smoke.py prints ptxas's report of the twelve
// instances and each launch's plan; kernel_parts.py (repo root) times
// variants of this source with parts taken out (no products, copies only,
// nothing, and one tensor pass per plane to price the fold); PERF.md
// keeps their numbers.
//
// Launches go on the caller's stream (cudaLaunchKernelEx with a cluster
// dimension), allocate nothing, do not synchronise, and return
// cudaGetLastError() (or the launch's own error).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 128;           // K bytes a step: one swizzled row a token
constexpr int WG = 128;           // threads of a warpgroup
constexpr int NWG = 2;            // consumer warpgroups a block
constexpr int THREADS = (NWG + 1) * WG;
constexpr int WCOLS = 64;         // output columns of a warpgroup (wgmma M)
constexpr int LUT_CB = 16;        // bytes of a (plane, column) a step
constexpr int DSP_LD = 80;        // bytes of a DSP column a step (64 + 16)
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 232448;
constexpr int LAUNCH_REGS = 168;  // 65536 / THREADS, in steps of 8
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;
static_assert(PRODUCER_REGS + NWG * CONSUMER_REGS <= (NWG + 1) * LAUNCH_REGS,
              "setmaxnreg moves registers within the block's launch allotment");

struct Params {
  const int8_t* x;        // dense: [M, K]; conv: [H, W, C], unpadded
  const uint32_t* lut;    // [bits, n_lut, lut_rw]
  const uint32_t* dsp;    // [n_dsp, dsp_rw]
  const float* scale;     // [n_lut + n_dsp]
  float* out;             // [M, n_lut + n_dsp]
  int M, K, bits, n_lut, n_dsp;
  int lut_rw, dsp_rw;     // words of a weight row
  int wc;                 // consumer warpgroups along the columns: 2 or 1
  int lut_tiles;          // column tiles of the LUT region
  int split, stages, k_steps;
  int a_vec;              // copy width of x: 16/8/4, 1 = bytes
  int H, W, C, ksize, stride, pad, out_hw;  // conv geometry
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory from a 1024-byte aligned base: the ring of
// `stages` stages (each the token tile [tt][128] swizzled, then the
// words, 1024-aligned), which the int32 partial tile [tt][cc + 4] reuses
// once the K loop is done; then the full and empty barriers and the
// conv's row table. fused_hetero_gemm.py::fused_layout computes the same.
struct Layout {
  int tt, cc, stage, bars, rowtab, total;
};

__host__ __device__ inline Layout layout_of(int t, int wc, int bits, int n_lut, int n_dsp,
                                            int stages) {
  Layout L;
  L.tt = t * (NWG / wc);
  L.cc = WCOLS * wc;
  const int words = imax(n_lut ? bits * L.cc * LUT_CB : 0, n_dsp ? L.cc * DSP_LD : 0);
  L.stage = (L.tt * BK + words + 1023) / 1024 * 1024;
  L.bars = imax(stages * L.stage, L.tt * (L.cc + 4) * 4);
  L.rowtab = L.bars + 16 * stages;
  L.total = 1024 + L.rowtab + 8 * L.tt;
  return L;
}

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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
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
// a producer thread's stage is issued: its cp.async copies arrive when
// they land (no net count), its own arrival covers its byte stores
__device__ __forceinline__ void arrive_full(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// a consumer warp is done with a stage: one arrival on its empty barrier
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the thread-block cluster: this block's rank, a barrier of all its
// threads (shared-memory writes before it seen by all after it), and a
// 16-byte load from the shared memory of the block of rank `rank`
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
__device__ __forceinline__ int4 cluster_load(const int4* p, int rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// wgmma's descriptor of a K-major operand in 128-byte-swizzled rows: start
// address, leading offset (unused by the swizzle), stride offset 1024
// bytes (8 rows), swizzle mode 1
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching registers that a wgmma in flight reads
// or writes: they stay live, unmoved, until after the wait
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d += A . B over k32 on one warp's 16 x 8 tile: A (16 x 32 int8) and B
// (32 x 8, K-major by column) from registers
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[T / 2] += A . B over k32: A (64 x 32 int8) from registers in wgmma's
// fragment layout, B (T tokens x 32 int8, K-major) from shared memory.
template <int T>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(int (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// The B fragment words of the LUT planes: a nibble of a word -> four 0/1
// bytes (the shifted copies of the multiply do not overlap: no carries)
__device__ __forceinline__ uint32_t spread_bits(uint32_t w) {
  return ((w & 0xFu) * 0x00204081u) & 0x01010101u;
}
// 16 bits of a DSP word (four codes, the low or high half by `sel`) ->
// four sign-extended int8: nibbles to bytes, then 0xF0 or-ed where bit 3
// is set ((v & 8) * 0x1E is 0xF0 or 0, no carry)
__device__ __forceinline__ uint32_t spread_int4(uint32_t w, uint32_t sel) {
  uint32_t t = __byte_perm(w, 0u, sel);
  t = (t | (t << 4)) & 0x0F0F0F0Fu;
  return t | ((t & 0x08080808u) * 0x1Eu);
}

template <int T, bool CONV>
struct Block {
  const Params& p;
  const Layout& L;
  int2* rowtab;
  int m0, j0;
  bool lut;

  // ---- producer -----------------------------------------------------------

  // The token tile of step `step` into the swizzled rows at `xs`, V-byte
  // pieces: a thread keeps one piece of the row (so its k and, for the
  // conv, its tap are decoded once) and every (WG / pieces)-th row.
  template <int V>
  __device__ __forceinline__ void load_x(unsigned char* xs, int step, int ptid) const {
    constexpr int PIECES = BK / V;
    const int kk = (ptid % PIECES) * V, k = step * BK + kk;
    const bool kin = k < p.K;
    int ch = 0, dh = 0, dw = 0;
    if (CONV && kin) {
      const int tap = k / p.C;
      ch = k - tap * p.C;
      dh = tap / p.ksize;
      dw = tap - dh * p.ksize;
    }
#pragma unroll 4
    for (int r = ptid / PIECES; r < L.tt; r += WG / PIECES) {
      const int8_t* src = p.x;
      bool ok = false;
      if (kin) {
        if constexpr (CONV) {
          const int2 o = rowtab[r];
          const int ih = o.x + dh, iw = o.y + dw;
          if ((unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W) {
            ok = true;
            src = p.x + ((size_t)ih * p.W + iw) * p.C + ch;
          }
        } else if (m0 + r < p.M) {
          ok = true;
          src = p.x + (size_t)(m0 + r) * p.K + k;
        }
      }
      cp_async<V>(xs + r * BK + ((((kk >> 4) ^ (r & 7)) << 4) | (kk & 15)), src, ok);
    }
  }

  // The same where the rows are not 4-byte aligned (conv1's C = 3): a
  // thread keeps 4 bytes of the row, decodes their taps once, and per row
  // gathers them with four independent loads into one 4-byte store.
  __device__ __forceinline__ void load_x_bytes(unsigned char* xs, int step, int ptid) const {
    const int kk = (ptid % 32) * 4, k0 = step * BK + kk;
    int ch[4], dh[4], dw[4];
    bool kin[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + e;
      kin[e] = k < p.K;
      ch[e] = k;
      dh[e] = dw[e] = 0;
      if (CONV) {
        const int tap = k / p.C;
        ch[e] = k - tap * p.C;
        dh[e] = tap / p.ksize;
        dw[e] = tap - dh[e] * p.ksize;
      }
    }
#pragma unroll 4
    for (int r = ptid / 32; r < L.tt; r += WG / 32) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t b = 0;
        if (kin[e]) {
          if constexpr (CONV) {
            const int2 o = rowtab[r];
            const int ih = o.x + dh[e], iw = o.y + dw[e];
            if ((unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W)
              b = (uint8_t)__ldg(p.x + ((size_t)ih * p.W + iw) * p.C + ch[e]);
          } else if (m0 + r < p.M) {
            b = (uint8_t)__ldg(p.x + (size_t)(m0 + r) * p.K + ch[e]);
          }
        }
        v |= b << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(xs + r * BK + ((((kk >> 4) ^ (r & 7)) << 4) | (kk & 15))) = v;
    }
  }

  // The step's weight words into `ws`: LUT [plane][column][16 bytes];
  // DSP [column][80 bytes], 64 of them filled. Columns past the region and
  // words past a DSP row read as zero.
  __device__ __forceinline__ void load_words(unsigned char* ws, int step, int ptid) const {
    if (lut) {
#pragma unroll 1
      for (int e = ptid; e < p.bits * L.cc; e += WG) {
        const int b = e / L.cc, col = j0 + e % L.cc;
        const bool ok = col < p.n_lut;
        const uint32_t* src =
            ok ? p.lut + ((size_t)b * p.n_lut + col) * p.lut_rw + 4 * step : p.lut;
        cp_async<16>(ws + e * LUT_CB, src, ok);
      }
    } else {
#pragma unroll 1
      for (int e = ptid; e < L.cc * 4; e += WG) {
        const int c = e >> 2, h = e & 3, col = j0 + c, w = 16 * step + 4 * h;
        const bool ok = col < p.n_dsp && w < p.dsp_rw;
        cp_async<16>(ws + c * DSP_LD + 16 * h, ok ? p.dsp + (size_t)col * p.dsp_rw + w : p.dsp,
                     ok);
      }
    }
  }

  __device__ __forceinline__ void load_stage(unsigned char* st, int step, int ptid) const {
    if (p.a_vec == 16)
      load_x<16>(st, step, ptid);
    else if (p.a_vec == 8)
      load_x<8>(st, step, ptid);
    else if (p.a_vec == 4)
      load_x<4>(st, step, ptid);
    else
      load_x_bytes(st, step, ptid);
    load_words(st + L.tt * BK, step, ptid);
  }

  // ---- consumers ----------------------------------------------------------

  // The A fragments of one step (4 k32 slices x 4 registers) for the
  // warpgroup's rows n0 = cb + 16 warp + g and n0 + 8, from the words at
  // `ws`: the LUT planes folded into the int8 codes, or the DSP codes.
  __device__ __forceinline__ void build(uint32_t (&a)[4][4], const unsigned char* ws, int n0,
                                        int q) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = 0u;
    if (lut) {
#pragma unroll 1
      for (int b = 0; b < p.bits; ++b) {
        const uint32_t sc = b == p.bits - 1 ? 256u - (1u << b) : 1u << b;
        const uint4 w0 = *reinterpret_cast<const uint4*>(ws + (b * L.cc + n0) * LUT_CB);
        const uint4 w1 = *reinterpret_cast<const uint4*>(ws + (b * L.cc + n0 + 8) * LUT_CB);
        const uint32_t lo[4] = {w0.x, w0.y, w0.z, w0.w}, hi[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          a[kk][0] += spread_bits(lo[kk] >> (4 * q)) * sc;
          a[kk][1] += spread_bits(hi[kk] >> (4 * q)) * sc;
          a[kk][2] += spread_bits(lo[kk] >> (16 + 4 * q)) * sc;
          a[kk][3] += spread_bits(hi[kk] >> (16 + 4 * q)) * sc;
        }
      }
    } else {
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(ws + n0 * DSP_LD) + (q >> 1);
      const uint32_t* r1 = reinterpret_cast<const uint32_t*>(ws + (n0 + 8) * DSP_LD) + (q >> 1);
      const uint32_t sel = q & 1 ? 0x4342u : 0x4140u;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = spread_int4(r0[4 * kk], sel);
        a[kk][1] = spread_int4(r1[4 * kk], sel);
        a[kk][2] = spread_int4(r0[4 * kk + 2], sel);
        a[kk][3] = spread_int4(r1[4 * kk + 2], sel);
      }
    }
  }
};

// One launch: blockIdx.x = column tile * split + rank, blockIdx.y = token
// tile. Threads [0, 256) are the consumer warpgroups, [256, 384) the
// producer.
template <int T, bool CONV>
__global__ void __launch_bounds__(THREADS, T <= 16 ? 2 : 1) fused_split_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle's period: the launch asks for 1024 bytes more
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout_of(T, p.wc, p.bits, p.n_lut, p.n_dsp, p.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;

  // the rank and the warpgroup broadcast from lane 0: values the compiler
  // sees are warp-uniform, so no branch on them makes it serialise wgmma
  const int rank = __shfl_sync(0xffffffffu, cluster_rank(), 0);
  const int tile = (int)blockIdx.x / p.split;
  Block<T, CONV> blk{p, L, reinterpret_cast<int2*>(smem + L.rowtab)};
  blk.lut = tile < p.lut_tiles;
  blk.j0 = (tile - (blk.lut ? 0 : p.lut_tiles)) * L.cc;  // inside the region
  blk.m0 = blockIdx.y * L.tt;
  const int n_region = blk.lut ? p.n_lut : p.n_dsp;
  const int col0 = blk.lut ? blk.j0 : p.n_lut + blk.j0;  // output column
  const int s_begin = rank * p.k_steps / p.split;
  const int nsteps = (rank + 1) * p.k_steps / p.split - s_begin;
  const int ST = p.stages;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], WG);
      mbar_init(&empty[s], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * WG) {  // the producer warpgroup
    if constexpr (T >= 64)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int ptid = tid - NWG * WG;
    if constexpr (CONV) {
      for (int r = ptid; r < L.tt; r += WG) {
        const int m = blk.m0 + r;
        int2 o = make_int2(-(1 << 28), -(1 << 28));  // a row past M is outside the image
        if (m < p.M) {
          const int oh = m / p.out_hw, ow = m - oh * p.out_hw;
          o = make_int2(oh * p.stride - p.pad, ow * p.stride - p.pad);
        }
        blk.rowtab[r] = o;
      }
      bar_sync(1, WG);
    }
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % ST;
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
      blk.load_stage(smem + s * L.stage, s_begin + i, ptid);
      arrive_full(&full[s]);
    }
    if (p.split > 1) {
      cluster_sync();  // the partial tiles are written
      cluster_sync();  // and reduced
    }
    return;
  }

  if constexpr (T >= 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int cb = p.wc == 2 ? wg * WCOLS : 0;  // the warpgroup's columns and tokens
  const int tb = p.wc == 2 ? 0 : wg * T;
  const int n0 = cb + 16 * warp + g;
  const bool active = blk.j0 + cb < n_region && blk.m0 + tb < p.M;
  // NACC accumulators, k32 slice kk into acc[kk % NACC]: below T = 64 the
  // products are mma.sync, whose chain on one accumulator would wait out
  // each one's latency
  constexpr int NACC = T == 16 ? 2 : T <= 32 ? 4 : 1;
  int acc[NACC][T / 2];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[a][i] = 0;
  uint32_t a0[4][4], a1[4][4];

  // wait for step i's stage, then build its fragments
  auto prepare = [&](uint32_t(&a)[4][4], int i) {
    mbar_wait(&full[i % ST], (i / ST) & 1);
    // the copies' generic-proxy writes before wgmma's async-proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (active) blk.build(a, smem + (i % ST) * L.stage + L.tt * BK, n0, q);
  };
  // a step's products on the fragments `a` and the token tile at `xs`: at
  // T >= 64 wgmma m64nTk32 (issued, not waited for); below, where a
  // wgmma's fixed cost outweighs its work, each warp's 16 rows by
  // mma.sync m16n8k32 on the same A fragments (wgmma's A layout is
  // mma.sync's, a warp a 16-row slice), the B fragments of token g's
  // row read from the swizzled tile, the accumulator in the same layout
  auto products = [&](uint32_t(&a)[4][4], const unsigned char* xs) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (T >= 64) {
        Wgmma<T>::mma(acc[kk % NACC], a[kk], desc(xs + 32 * kk));
      } else {
#pragma unroll
        for (int j = 0; j < T / 8; ++j) {
          const unsigned char* row = xs + (8 * j + g) * BK + 4 * q;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + ((2 * kk) ^ g) * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + ((2 * kk + 1) ^ g) * 16);
          mma_s8(*reinterpret_cast<int(*)[4]>(&acc[kk % NACC][4 * j]), a[kk], b0, b1);
        }
      }
    }
  };
  // step i's products on `cur`, the next step's fragments built into `nxt`
  // meanwhile, then (wgmma) the wait and the stage's release
  auto step = [&](uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4], int i) {
    const unsigned char* xs = smem + (i % ST) * L.stage + tb * BK;
    if (active) {
      if constexpr (T >= 64) wg_fence();
      products(cur, xs);
      if constexpr (T >= 64) wg_commit();
    }
    if constexpr (T < 64) release(&empty[i % ST], lane);
    if (i + 1 < nsteps) prepare(nxt, i + 1);
    if constexpr (T >= 64) {
      if (active) {
        wg_wait0();
        fence_regs(acc[0]);
        fence_frags(cur);
      }
      release(&empty[i % ST], lane);
    }
  };
  if (nsteps > 0) prepare(a0, 0);
  for (int i = 0; i < nsteps; i += 2) {
    step(a0, a1, i);
    if (i + 1 < nsteps) step(a1, a0, i + 1);
  }
#pragma unroll
  for (int a = 1; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[0][i] += acc[a][i];

  // element i of the accumulator is column n0 + 8 ((i >> 1) & 1), token
  // tb + 8 (i >> 2) + 2 q + (i & 1) of the block's
  const int n_out = p.n_lut + p.n_dsp;
  if (p.split == 1) {  // dequantize and store straight from the accumulator
    if (!active) return;
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 8 * h;
      sc[h] = blk.j0 + c < n_region ? p.scale[col0 + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const int m = blk.m0 + tb + 8 * (i >> 2) + 2 * q + (i & 1);
      const int c = n0 + 8 * ((i >> 1) & 1);
      if (m < p.M && blk.j0 + c < n_region)
        p.out[(size_t)m * n_out + col0 + c] = __int2float_rn(acc[0][i]) * sc[(i >> 1) & 1];
    }
    return;
  }

  // the partial tile [tt][cc + 4] int32 over the ring, once both
  // warpgroups are done with it
  bar_sync(2, NWG * WG);
  const int rs = L.cc + 4;
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < T / 2; ++i)
    red[(tb + 8 * (i >> 2) + 2 * q + (i & 1)) * rs + n0 + 8 * ((i >> 1) & 1)] = acc[0][i];
  cluster_sync();  // every partial tile of the cluster is in place

  // this block's 1/S of the tile: sum the S partial tiles in rank order
  // (their loads issued together), dequantize, store
  const int vecs = L.tt * L.cc / 4, per = vecs / p.split, qc = L.cc / 4;
#pragma unroll 2
  for (int v = rank * per + tid; v < (rank + 1) * per; v += NWG * WG) {
    const int r = v / qc, c = (v - r * qc) * 4, m = blk.m0 + r;
    const int4* src = reinterpret_cast<const int4*>(red + r * rs + c);
    int4 part[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < p.split) part[k] = cluster_load(src, k);
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[e] = m < p.M && blk.j0 + c + e < n_region ? __ldg(p.scale + col0 + c + e) : 0.f;
    int4 sum = part[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
      if (k < p.split) {
        sum.x += part[k].x;
        sum.y += part[k].y;
        sum.z += part[k].z;
        sum.w += part[k].w;
      }
    if (m >= p.M) continue;
    const int vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (blk.j0 + c + e >= n_region) break;
      p.out[(size_t)m * n_out + col0 + c + e] = __int2float_rn(vals[e]) * sc[e];
    }
  }
  cluster_sync();  // no block leaves while another still reads its tile
}

int vec_of(const void* ptr, int ld) {
  for (int v = 16; v >= 4; v /= 2)
    if (ld % v == 0 && (uintptr_t)ptr % v == 0) return v;
  return 1;
}

template <int T, bool CONV>
int launch_tile(Params p, cudaStream_t stream) {
  const Layout L = layout_of(T, p.wc, p.bits, p.n_lut, p.n_dsp, p.stages);
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  p.lut_tiles = (p.n_lut + L.cc - 1) / L.cc;
  const int dsp_tiles = (p.n_dsp + L.cc - 1) / L.cc;
  auto kern = fused_split_kernel<T, CONV>;
  // The shared-memory limit is an attribute of the kernel on each device:
  // raise it to the most any launch needs, once per device, and keep the
  // runtime call out of the launch path.
  static unsigned long long raised = 0;  // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((raised >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.lut_tiles + dsp_tiles) * p.split, (p.M + L.tt - 1) / L.tt, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled token tiles t in {8, 16, 32, 64, 128, 256}; wc in {1, 2};
// split in {1, 2, 4, 8}; stages in 2..MAX_STAGES (a consumer holds one
// stage while it waits for the next).
template <bool CONV>
int launch(Params p, int t, int wc, int split, int stages, void* stream) {
  if (split != 1 && split != 2 && split != 4 && split != 8) return (int)cudaErrorInvalidValue;
  if ((wc != 1 && wc != 2) || stages < 2 || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  if (p.n_lut && (p.bits < 1 || p.bits > 8)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)p.lut % 16 != 0 || (uintptr_t)p.dsp % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (p.M == 0) return (int)cudaSuccess;
  p.wc = wc;
  p.split = split;
  p.stages = stages;
  p.k_steps = (p.K + BK - 1) / BK;
  p.lut_rw = (p.K + 127) / 128 * 4;
  p.dsp_rw = (p.K + 31) / 32 * 4;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 8: return launch_tile<8, CONV>(p, s);
    case 16: return launch_tile<16, CONV>(p, s);
    case 32: return launch_tile<32, CONV>(p, s);
    case 64: return launch_tile<64, CONV>(p, s);
    case 128: return launch_tile<128, CONV>(p, s);
    case 256: return launch_tile<256, CONV>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

Params base_params(const void* x, int M, int K, const void* lut_words, int bits, int n_lut,
                   const void* dsp_words, int n_dsp, const void* scale, void* out) {
  Params p{};
  p.x = (const int8_t*)x;
  p.lut = (const uint32_t*)lut_words;
  p.dsp = (const uint32_t*)dsp_words;
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

// x [M, K] int8; lut_words [bits, n_lut, ceil(K/128)*4] int32; dsp_words
// [n_dsp, ceil(K/32)*4] int32; scale [n_lut + n_dsp] fp32 -> out [M,
// n_lut + n_dsp] fp32; (t, wc, split, stages) from
// fused_hetero_gemm.py::fused_plan.
int fused_hetero_gemm(const void* x, int M, int K, const void* lut_words, int bits, int n_lut,
                      const void* dsp_words, int n_dsp, const void* scale, void* out, int t,
                      int wc, int split, int stages, void* stream) {
  Params p = base_params(x, M, K, lut_words, bits, n_lut, dsp_words, n_dsp, scale, out);
  p.a_vec = vec_of(x, K);
  return launch<false>(p, t, wc, split, stages, stream);
}

// x [H, W, C] int8, unpadded; weights in (kh, kw, c) row order with
// K = ksize^2 * C; out [out_hw^2, n_lut + n_dsp] fp32.
int fused_conv_gemm(const void* x, int H, int W, int C, int ksize, int stride, int pad,
                    int out_hw, const void* lut_words, int bits, int n_lut,
                    const void* dsp_words, int n_dsp, const void* scale, void* out, int t,
                    int wc, int split, int stages, void* stream) {
  Params p = base_params(x, out_hw * out_hw, ksize * ksize * C, lut_words, bits, n_lut,
                         dsp_words, n_dsp, scale, out);
  p.H = H;
  p.W = W;
  p.C = C;
  p.ksize = ksize;
  p.stride = stride;
  p.pad = pad;
  p.out_hw = out_hw;
  p.a_vec = vec_of(x, C);
  return launch<true>(p, t, wc, split, stages, stream);
}

}  // extern "C"
