// Fused split GEMM of the N3H-Core heterogeneous layer (paper Eq. 12)
// for Hopper (sm_90a): int8 tensor cores, cp.async pipeline, split-K
// over a thread-block cluster.
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
// What it computes. Output columns [0, n_lut) are the LUT core's: the
// weights arrive as `bits` binary planes [bits, K, n_lut] (int8 0/1) and
// a column accumulates sum_b s_b * (x @ plane_b), s_b = 2^b with the MSB
// plane weighted -2^(bits-1). Columns [n_lut, n_lut + n_dsp) are the DSP
// core's: int4 codes packed two to a byte [K, ceil(n_dsp / 2)], even
// column in the low nibble. Both sides accumulate exactly in int32; the
// epilogue converts to fp32 and multiplies by the per-column scale, the
// same two IEEE operations as the plain version, so every output is
// bitwise equal to it.
//
// What bounds it on an H100. At batch 1 resnet18's split GEMMs need
// ~5.8 MB of weights at their code width, 2.2 MB of activations and
// 9.9 MB of fp32 output per image: ~5.4 us at 3.35 TB/s. The integer
// product is ~3.6 G ops: ~1.8 us at the 1,979 TOP/s int8 peak. So the
// floor is set by bytes, and the int8 planes read here hold each LUT
// weight in 8x its bits (~39 MB per image, ~12 us at 3.35 TB/s). On 10
// of the 21 layers M is 49 or 196: the card fills only by splitting K.
//
// Design.
//   * Tiles. A block of 256 threads (8 warps) owns a BM x BN output tile
//     of one split region, BM in {16, 64}, BN in {32, 64}; every warp
//     copies and transposes, and up to 8 warps run the mma on 32 x 16,
//     32 x 8 or 16 x 8 sub-tiles (4 at 16 x 32). The column
//     tiles of the LUT and DSP regions are numbered separately, so the
//     split boundary may fall inside a tile (48 of 64 on conv1); the DSP
//     tile writes at column offset n_lut. Ragged M, K and N are masked.
//   * Split-K over a cluster. The grid is (column tiles x S, row tiles)
//     and the S blocks of one tile form one cluster (S in {1, 2, 4, 8},
//     portable sizes). Block r of the cluster walks K steps
//     [r * steps / S, (r + 1) * steps / S) of BK = 64, keeps its partial
//     tile in int32 registers, writes it to its own shared memory, and
//     after cluster.sync() reduces a disjoint 1/S of the tile over
//     distributed shared memory (cluster.map_shared_rank), dequantizes
//     it and stores fp32. Integer addition is exact in any order, so the
//     result is bitwise the same for every S: no workspace, no atomics,
//     no second launch. The Python wrapper chooses (BM, BN, S) so that a
//     layer launches ~132-264 blocks (fused_hetero_gemm.py::split_plan).
//   * Tensor cores. mma.sync.m16n8k32.row.col.s32.s8.s8.s32 with A and B
//     fragments from ldmatrix on K-contiguous shared tiles (80-byte rows:
//     8 ldmatrix rows hit 32 distinct banks). mma.sync rather than wgmma:
//     these GEMMs are bytes-bound and M is 49 or 196 on half the layers,
//     where wgmma's 64-row tiles and asynchrony buy nothing yet.
//   * The plane loop stays: a LUT tile runs one mma pass per bit plane,
//     so its cost grows with the bit width as the LUT core's does. The
//     plane's weight s_b is folded into its transposed tile (a 0/1 byte
//     times s_b fits int8 for bits <= 8: at most 64, the MSB's
//     -2^(bits-1) at least -128), so every pass accumulates straight
//     into the one int32 accumulator and the A fragments of a step are
//     loaded once for all planes. The integers are the same as
//     sum_b s_b * (x @ plane_b). Overflow margin: |x| <= 128,
//     |w| <= 128 and K <= 4608 bound every partial and total sum by
//     128 * 128 * 4608 = 75.5e6, 28x below 2^31.
//   * K-major B without a new global layout. The planes and packed bytes
//     are N-contiguous; mma wants B K-contiguous per column. Each stage
//     copies the raw [BK, BN] tiles to shared memory with cp.async; then
//     each thread reads a 4 (k) x 4 (n) byte block as four 32-bit words,
//     transposes it in registers with __byte_perm (DSP: spreads the
//     nibbles of four columns and sign-extends them with __vsub4 first)
//     and stores four words into the [n][k] tile. The thread-to-block
//     map and the rotated word order make the reads and the writes free
//     of bank conflicts (raw rows of 96 bytes at BN = 64).
//   * cp.async pipeline, NST = 3 stages: the A tile and the raw B tiles
//     of step t + 2 are in flight while step t is transposed and
//     multiplied; two __syncthreads per step (one before the transpose,
//     one before the mma), zero-fill (src-size 0) at every masked edge.
//       - dense A: 16-byte copies of [BM, BK] rows (8 or 4 bytes when K
//         is not a multiple of 16);
//       - conv A with C % 16 == 0 (every resnet18 layer but conv1): a
//         16-byte chunk of K lies inside one tap, so it is 16 contiguous
//         bytes of the NHWC block: each chunk computes its tap once and
//         each row's (ih, iw) origin comes from a table built at the
//         start; a chunk outside the image is zero-filled, which is
//         exactly the padding (8 and 4 bytes for C % 8, C % 4);
//       - conv A with other C (conv1: C = 3, K = 147): a scalar gather
//         into the same shared tile; each thread keeps one k column per
//         step, so its tap is decoded once per step, not per byte.
//
// Resources and times (chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W): ptxas gives 96-119 registers, no spills, no static shared
// memory for the eight instantiations; the dynamic shared memory is
// layout_of() (110 KB at BM = BN = 64 and bits = 4, two blocks an SM).
// Per resnet18 image the conv kernel takes 0.34 ms of device time and
// the dense one 0.30 ms, against 7.1 and 4.8 ms for the __dp4a kernel
// they replace, and 1.6x and 1.3x the device time of torch._int_mm on
// the same integers. kernel_parts.py (repo root) times variants of this source
// with parts of the K loop taken out; its split of a layer's time into
// the fixed cost, the copies, the transpose and the mma is in PERF.md.
// Unrolled copy and transpose loops cost registers and time on the
// card, hence the `#pragma unroll 1` on them.
//
// Launches go on the caller's stream (cudaLaunchKernelEx with a cluster
// dimension), allocate nothing, do not synchronise, and return
// cudaGetLastError() (or the launch's own error).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;        // K bytes per pipeline step
constexpr int NST = 3;        // pipeline stages
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LDA = BK + 16;  // A stage row stride (bytes)
constexpr int LDT = BK + 16;  // transposed B row stride (bytes)
constexpr int MAX_SMEM = 232448;

struct Params {
  const int8_t* x;       // dense: [M, K]; conv: [H, W, C], unpadded
  const int8_t* planes;  // [bits, K, n_lut] in {0, 1}
  const int8_t* packed;  // [K, ceil(n_dsp / 2)] int4 pairs
  const float* scale;    // [n_lut + n_dsp]
  float* out;            // [M, n_lut + n_dsp]
  int M, K;
  int bits, n_lut, n_dsp;
  int lut_tiles;         // column tiles of the LUT region
  int split;             // blocks of one cluster along K
  int k_steps;           // ceil(K / BK)
  int a_vec, b_vec, d_vec;  // copy widths of A, planes, packed: 16/8/4, 1 = scalar
  int H, W, C, ksize, stride, pad, out_hw;  // conv geometry
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

template <int BN>
__host__ __device__ constexpr int raw_ld() { return BN == 64 ? 96 : 32; }  // LUT raw row
template <int BN>
__host__ __device__ constexpr int dsp_ld() { return BN / 2 + 16; }        // DSP raw row

// Dynamic shared memory: row table | A stages | raw B stages | B^T
// planes; the int32 partial tile of the split-K reduction reuses the
// space from the A stages on, once the K loop is done.
struct Layout {
  int a, raw, bt, total;
};

template <int BM, int BN>
__host__ __device__ Layout layout_of(int bits_eff) {
  Layout L;
  const int raw_stage = imax(bits_eff * BK * raw_ld<BN>(), BK * dsp_ld<BN>());
  L.a = (BM * 8 + 15) / 16 * 16;
  L.raw = L.a + NST * BM * LDA;
  L.bt = L.raw + NST * raw_stage;
  const int end = L.bt + imax(bits_eff, 1) * BN * LDT;
  L.total = imax(end, L.a + BM * (BN + 8) * 4);
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: word j of the result holds byte j of w0..w3.
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// Four packed int4 codes (two bytes, even column low) -> four int8.
__device__ __forceinline__ uint32_t spread_int4(uint32_t u) {
  const uint32_t w = (u & 0xFu) | ((u & 0xF0u) << 4) | ((u & 0xF00u) << 8) |
                     ((u & 0xF000u) << 12);
  return __vsub4(w ^ 0x08080808u, 0x08080808u);  // (v ^ 8) - 8 per byte
}

template <int BM, int BN, bool CONV>
struct Tile {
  static constexpr int WM = BM >= 32 ? BM / 32 : 1;        // mma warps along M
  static constexpr int WN = imax(1, imin(WARPS / WM, BN / 8));  // ... along N
  static constexpr int MMA_WARPS = WM * WN;
  static constexpr int MI = BM / (16 * WM);                // m16 tiles per warp
  static constexpr int NI = BN / (8 * WN);                 // n8 tiles per warp
  static constexpr int NQ = BN / 4;                        // column quads
  static constexpr int IPP = 16 * NQ;                      // 4x4 blocks per plane
  static constexpr int LDR = raw_ld<BN>();
  static constexpr int LDD = dsp_ld<BN>();
  static constexpr int RS = BN + 8;                        // partial tile row stride (int32)
  static_assert(THREADS % IPP == 0 && THREADS % BK == 0, "fixed per-thread roles");

  const Params& p;
  int2* rowtab;
  int8_t *As, *Braw, *Bt;
  int raw_stage;
  int tid, m0, j0, k_end;
  bool lut;

  // A of the K step starting at k0 into stage buffer `as`, V-byte copies.
  template <int V>
  __device__ __forceinline__ void load_a_vec(int8_t* as, int k0) const {
    constexpr int CH = BK / V;
#pragma unroll 1
    for (int e = tid; e < BM * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      const int k = k0 + c * V;
      const int8_t* src = p.x;
      bool ok = false;
      if (k < k_end) {
        if constexpr (CONV) {
          const int tap = k / p.C, ch = k - tap * p.C;
          const int dh = tap / p.ksize, dw = tap - dh * p.ksize;
          const int2 o = rowtab[r];
          const int ih = o.x + dh, iw = o.y + dw;
          if ((unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W) {
            ok = true;
            src = p.x + ((size_t)ih * p.W + iw) * p.C + ch;
          }
        } else {
          const int m = m0 + r;
          if (m < p.M) {
            ok = true;
            src = p.x + (size_t)m * p.K + k;
          }
        }
      }
      cp_async<V>(as + r * LDA + c * V, src, ok);
    }
  }

  // A by bytes: each thread keeps one k column, so a conv tap is decoded
  // once per step and each row's window origin comes from the row table.
  __device__ __forceinline__ void load_a_scalar(int8_t* as, int k0) const {
    const int kk = tid % BK, k = k0 + kk;
    const bool kin = k < k_end;
    int dh = 0, dw = 0, ch = 0;
    if (CONV && kin) {
      const int tap = k / p.C;
      ch = k - tap * p.C;
      dh = tap / p.ksize;
      dw = tap - dh * p.ksize;
    }
    for (int r = tid / BK; r < BM; r += THREADS / BK) {
      int8_t v = 0;
      if (kin) {
        if constexpr (CONV) {
          const int2 o = rowtab[r];
          const int ih = o.x + dh, iw = o.y + dw;
          if ((unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W)
            v = p.x[((size_t)ih * p.W + iw) * p.C + ch];
        } else if (m0 + r < p.M) {
          v = p.x[(size_t)(m0 + r) * p.K + k];
        }
      }
      as[r * LDA + kk] = v;
    }
  }

  // Raw [BK][WIDTH]-byte tiles of `nplanes` stacked planes of a row-major
  // array with row stride `ld` bytes (and `plane_rows` rows a plane),
  // from row k0 and byte column c0, V bytes a copy; columns at or past
  // `ld` and rows at or past k_end read as zero (V divides ld).
  template <int WIDTH, int V>
  __device__ __forceinline__ void load_raw_vec(int8_t* dst, int dst_ld, const int8_t* src, int ld,
                                               int plane_rows, int nplanes, int k0, int c0) const {
    constexpr int CH = WIDTH / V;
#pragma unroll 1
    for (int e = tid; e < nplanes * BK * CH; e += THREADS) {
      const int b = e / (BK * CH), f = e % (BK * CH);
      const int kk = f / CH, c = f % CH;
      const int k = k0 + kk, col = c0 + c * V;
      const bool ok = k < k_end && col < ld;
      const int8_t* s = ok ? src + ((size_t)b * plane_rows + k) * ld + col : src;
      cp_async<V>(dst + (b * BK + kk) * dst_ld + c * V, s, ok);
    }
  }

  template <int WIDTH>
  __device__ __forceinline__ void load_raw_scalar(int8_t* dst, int dst_ld, const int8_t* src,
                                                  int ld, int plane_rows, int nplanes, int k0,
                                                  int c0) const {
    for (int e = tid; e < nplanes * BK * WIDTH; e += THREADS) {
      const int b = e / (BK * WIDTH), f = e % (BK * WIDTH);
      const int kk = f / WIDTH, c = f % WIDTH;
      const int k = k0 + kk, col = c0 + c;
      dst[(b * BK + kk) * dst_ld + c] =
          (k < k_end && col < ld) ? src[((size_t)b * plane_rows + k) * ld + col] : 0;
    }
  }

  template <int WIDTH>
  __device__ __forceinline__ void load_raw(int vec, int8_t* dst, int dst_ld, const int8_t* src,
                                           int ld, int plane_rows, int nplanes, int k0,
                                           int c0) const {
    if (vec == 16)
      load_raw_vec<WIDTH, 16>(dst, dst_ld, src, ld, plane_rows, nplanes, k0, c0);
    else if (vec == 8)
      load_raw_vec<WIDTH, 8>(dst, dst_ld, src, ld, plane_rows, nplanes, k0, c0);
    else if (vec == 4)
      load_raw_vec<WIDTH, 4>(dst, dst_ld, src, ld, plane_rows, nplanes, k0, c0);
    else
      load_raw_scalar<WIDTH>(dst, dst_ld, src, ld, plane_rows, nplanes, k0, c0);
  }

  __device__ __forceinline__ void load_stage(int step, int buf) const {
    const int k0 = step * BK;
    int8_t* as = As + buf * BM * LDA;
    if (p.a_vec == 16)
      load_a_vec<16>(as, k0);
    else if (p.a_vec == 8)
      load_a_vec<8>(as, k0);
    else if (p.a_vec == 4)
      load_a_vec<4>(as, k0);
    else
      load_a_scalar(as, k0);
    int8_t* raw = Braw + buf * raw_stage;
    if (lut)
      load_raw<BN>(p.b_vec, raw, LDR, p.planes, p.n_lut, p.K, p.bits, k0, j0);
    else
      load_raw<BN / 2>(p.d_vec, raw, LDD, p.packed, (p.n_dsp + 1) / 2, p.K, 1, k0, j0 / 2);
  }

  // Raw stage `buf` -> Bt[plane][n][k], the LUT planes scaled by s_b
  // (0/1 times s_b fits int8 for every bits <= 8: at most 64, and the
  // MSB's -2^(bits-1) >= -128). A thread owns one 4 (k) x 4 (n) block
  // (kq, n4) of each plane it visits; lanes take 4 consecutive kq of
  // each n4, read the rows rotated by kq and the columns rotated by
  // n4 / 2, which makes both the reads and the writes conflict-free.
  __device__ __forceinline__ void transpose_stage(int buf) const {
    const int f = tid % IPP;
    const int kq = (f & 3) + 4 * (f / (4 * NQ)), n4 = (f >> 2) % NQ;
    const int rot = kq & 3, rot2 = (n4 >> 1) & 3;
    const int8_t* raw = Braw + buf * raw_stage;
    int8_t* dst = Bt + 4 * n4 * LDT + 4 * kq;
    const int nplanes = lut ? p.bits : 1;
#pragma unroll 1
    for (int b = tid / IPP; b < nplanes; b += THREADS / IPP) {
      uint32_t w[4];
      if (lut) {
        const int8_t* src = raw + (b * BK + 4 * kq) * LDR + 4 * n4;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          w[s] = *reinterpret_cast<const uint32_t*>(src + ((s + rot) & 3) * LDR);
      } else {
        const int8_t* src = raw + 4 * kq * LDD + 2 * n4;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          w[s] = spread_int4(*reinterpret_cast<const uint16_t*>(src + ((s + rot) & 3) * LDD));
      }
      // byte t of each w now holds column (t + rot2) & 3
#pragma unroll
      for (int s = 0; s < 4; ++s) w[s] = __funnelshift_r(w[s], w[s], 8 * rot2);
      uint32_t o[4];
      transpose4(w[0], w[1], w[2], w[3], o);
      const uint32_t scale =
          lut ? (uint32_t)((b == p.bits - 1 ? -(1 << b) : (1 << b)) & 0xFF) : 1u;
      // o[s] is column (s + rot2) & 3, its byte t row (t + rot) & 3
#pragma unroll
      for (int s = 0; s < 4; ++s)
        *reinterpret_cast<uint32_t*>(dst + (b * BN + ((s + rot2) & 3)) * LDT) =
            __funnelshift_l(o[s], o[s], 8 * rot) * scale;
    }
  }
};

template <int BM, int BN, bool CONV>
__global__ void __launch_bounds__(THREADS) fused_split_kernel(const Params p) {
  using T = Tile<BM, BN, CONV>;
  constexpr int MI = T::MI, NI = T::NI, WN = T::WN, RS = T::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const Layout L = layout_of<BM, BN>(p.n_lut ? p.bits : 0);
  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / p.split;

  T t{p};
  t.rowtab = reinterpret_cast<int2*>(smem);
  t.As = reinterpret_cast<int8_t*>(smem + L.a);
  t.Braw = reinterpret_cast<int8_t*>(smem + L.raw);
  t.Bt = reinterpret_cast<int8_t*>(smem + L.bt);
  t.raw_stage = (L.bt - L.raw) / NST;
  t.tid = threadIdx.x;
  t.m0 = blockIdx.y * BM;
  t.lut = tile < p.lut_tiles;
  t.j0 = (tile - (t.lut ? 0 : p.lut_tiles)) * BN;  // inside the region
  const int n_region = t.lut ? p.n_lut : p.n_dsp;
  const int col0 = t.lut ? t.j0 : p.n_lut + t.j0;  // output column
  const int nplanes = t.lut ? p.bits : 1;

  // this block's K steps
  const int s_begin = rank * p.k_steps / p.split;
  const int s_end = (rank + 1) * p.k_steps / p.split;
  const int nsteps = s_end - s_begin;
  t.k_end = min(p.K, s_end * BK);

  if constexpr (CONV) {
    for (int r = t.tid; r < BM; r += THREADS) {
      const int m = t.m0 + r;
      int2 o = make_int2(-(1 << 28), -(1 << 28));  // a row past M is outside the image
      if (m < p.M) {
        const int oh = m / p.out_hw, ow = m - oh * p.out_hw;
        o = make_int2(oh * p.stride - p.pad, ow * p.stride - p.pad);
      }
      t.rowtab[r] = o;
    }
    __syncthreads();
  }

  const int warp = t.tid / 32, lane = t.tid % 32;
  const bool mma_warp = warp < T::MMA_WARPS;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, q = lane % 4;
  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nsteps) t.load_stage(s_begin + s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage st landed; step st - 1 is done with its buffers
    if (st + NST - 1 < nsteps) t.load_stage(s_begin + st + NST - 1, (st + NST - 1) % NST);
    cp_async_commit();
    t.transpose_stage(st % NST);
    __syncthreads();
    if (!mma_warp) continue;

    // A fragments once per step; one mma pass per (scaled) bit plane
    const int8_t* as = t.As + (st % NST) * BM * LDA;
    uint32_t a[BK / 32][MI][4];
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = (wm * MI + i) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(a[kk][i], as + row * LDA + 32 * kk + 16 * (lane >> 4));
      }
    for (int b = 0; b < nplanes; ++b) {
      const int8_t* bt = t.Bt + b * BN * LDT;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        uint32_t bf[NI][2];
        if constexpr (NI == 1) {
          const int n = wn * 8 + (lane & 7);
          ldmatrix_x2(bf[0][0], bf[0][1], bt + n * LDT + 32 * kk + 16 * ((lane >> 3) & 1));
        } else {
#pragma unroll
          for (int j = 0; j < NI; j += 2) {
            const int n = (wn * NI + j) * 8 + (lane & 7) + 8 * (lane >> 4);
            uint32_t r[4];
            ldmatrix_x4(r, bt + n * LDT + 32 * kk + 16 * ((lane >> 3) & 1));
            bf[j][0] = r[0];
            bf[j][1] = r[1];
            bf[j + 1][0] = r[2];
            bf[j + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[kk][i], bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers are free: the partial tile reuses them

  int* red = reinterpret_cast<int*>(smem + L.a);
  if (mma_warp) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int row = (wm * MI + i) * 16 + g, col = (wn * NI + j) * 8 + 2 * q;
        *reinterpret_cast<int2*>(red + row * RS + col) = make_int2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<int2*>(red + (row + 8) * RS + col) =
            make_int2(acc[i][j][2], acc[i][j][3]);
      }
  }
  cluster.sync();  // every partial tile of the cluster is in place

  // this block's 1/S of the tile: sum the S partial tiles, dequantize, store
  const int n_out = p.n_lut + p.n_dsp;
  constexpr int VECS = BM * BN / 4;
  const int per = VECS / p.split;
  for (int v = rank * per + t.tid; v < (rank + 1) * per; v += THREADS) {
    const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int src = 0; src < p.split; ++src) {
      const int4 part = *cluster.map_shared_rank(reinterpret_cast<int4*>(red + r * RS + c), src);
      sum.x += part.x;
      sum.y += part.y;
      sum.z += part.z;
      sum.w += part.w;
    }
    const int m = t.m0 + r;
    if (m >= p.M) continue;
    const int vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (t.j0 + c + e >= n_region) break;
      const int col = col0 + c + e;
      p.out[(size_t)m * n_out + col] = __int2float_rn(vals[e]) * p.scale[col];
    }
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

int vec_of(const void* ptr, int ld) {
  for (int v = 16; v >= 4; v /= 2)
    if (ld % v == 0 && (uintptr_t)ptr % v == 0) return v;
  return 1;
}

template <int BM, int BN, bool CONV>
int launch_tile(Params p, cudaStream_t stream) {
  p.lut_tiles = (p.n_lut + BN - 1) / BN;
  const int dsp_tiles = (p.n_dsp + BN - 1) / BN;
  const Layout L = layout_of<BM, BN>(p.n_lut ? p.bits : 0);
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = fused_split_kernel<BM, BN, CONV>;
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
  cfg.gridDim = dim3((p.lut_tiles + dsp_tiles) * p.split, (p.M + BM - 1) / BM, 1);
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

// The compiled tiles: (bm, bn) in {16, 64} x {32, 64}; split in {1, 2, 4, 8}.
template <bool CONV>
int launch(Params p, int bm, int bn, int split, void* stream) {
  if (split != 1 && split != 2 && split != 4 && split != 8) return (int)cudaErrorInvalidValue;
  if (p.M == 0) return (int)cudaSuccess;
  p.split = split;
  p.k_steps = (p.K + BK - 1) / BK;
  p.b_vec = vec_of(p.planes, p.n_lut);
  p.d_vec = vec_of(p.packed, (p.n_dsp + 1) / 2);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64) return launch_tile<64, 64, CONV>(p, s);
  if (bm == 64 && bn == 32) return launch_tile<64, 32, CONV>(p, s);
  if (bm == 16 && bn == 64) return launch_tile<16, 64, CONV>(p, s);
  if (bm == 16 && bn == 32) return launch_tile<16, 32, CONV>(p, s);
  return (int)cudaErrorInvalidValue;
}

Params base_params(const void* x, int M, int K, const void* planes, int bits, int n_lut,
                   const void* packed, int n_dsp, const void* scale, void* out) {
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

// x [M, K] int8; planes [bits, K, n_lut]; packed [K, ceil(n_dsp/2)];
// scale [n_lut + n_dsp] fp32 -> out [M, n_lut + n_dsp] fp32; (bm, bn,
// split) from fused_hetero_gemm.py::split_plan.
int fused_hetero_gemm(const void* x, int M, int K, const void* planes, int bits, int n_lut,
                      const void* packed, int n_dsp, const void* scale, void* out, int bm,
                      int bn, int split, void* stream) {
  Params p = base_params(x, M, K, planes, bits, n_lut, packed, n_dsp, scale, out);
  p.a_vec = vec_of(x, K);
  return launch<false>(p, bm, bn, split, stream);
}

// x [H, W, C] int8, unpadded; weights in (kh, kw, c) row order with
// K = ksize^2 * C; out [out_hw^2, n_lut + n_dsp] fp32.
int fused_conv_gemm(const void* x, int H, int W, int C, int ksize, int stride, int pad,
                    int out_hw, const void* planes, int bits, int n_lut, const void* packed,
                    int n_dsp, const void* scale, void* out, int bm, int bn, int split,
                    void* stream) {
  Params p = base_params(x, out_hw * out_hw, ksize * ksize * C, planes, bits, n_lut, packed,
                         n_dsp, scale, out);
  p.H = H;
  p.W = W;
  p.C = C;
  p.ksize = ksize;
  p.stride = stride;
  p.pad = pad;
  p.out_hw = out_hw;
  p.a_vec = vec_of(x, C);
  return launch<true>(p, bm, bn, split, stream);
}

}  // extern "C"
