// Grouped matmul over expert-sorted rows with int8 / fp8 expert weights,
// for sm_90a: out[rows_e] = (lhs[rows_e] @ w_q[e]) * w_s[e].
//
// Replaces the Pallas TPU kernel
// dynamo_tpu/ops/moe_gmm_pallas.py::ragged_int8_gmm (_kernel, with its
// scalar-prefetched step metadata _step_metadata): there a sequential grid of
// (row tile, expert) steps accumulates each output tile in VMEM, widening the
// quantized weight tile to the lhs dtype in VMEM and applying the expert's
// per-column scale after the dot. Here the blocks run in parallel. Codes
// widen to the lhs dtype exactly (int8 and e4m3 both fit bf16), products
// accumulate in f32, the scale multiplies after the K loop, as there. Each
// block finds its expert's rows from group_sizes itself, with a warp scan
// over the experts (one launch per call, no host sync, no cumsum launch).
//
// One launch, several kinds of block in one linear grid, chosen by the
// expert's row count and the lhs dtype (explicit dispatches, never a
// fallback of one body to another):
//
// 1. Tiled blocks (bf16 lhs, experts with more than FEW rows: a prompt's
//    rows). What bounds them on an H100: the code bytes and the operations
//    (DeepSeek-V2-Lite, 1201 tokens: 184 MB of codes and 42 GFLOP, ~55 us
//    and ~42 us at the card's peaks). The design, a tiled M x N x K GEMM on
//    mma.sync for Hopper's shared memory and asynchronous copies:
//    * an output tile is BM = 128 rows of ONE expert x BN = 128 columns; 8
//      warps as 2 x 4, each 64 x 32 (16 m16n8k16 products per 16-deep step
//      against 4 A and 2 B fragment loads);
//    * the tile list lives on the device: row tiles are expert-local
//      (expert e's rows [start, end) cut every BM rows from start), counted
//      by a warp scan over group_sizes in each block, as the reference's
//      _step_metadata counts its (expert, row tile) steps; the grid is sized
//      by the host's upper bound N / BN x (ceil(R / BM) + min(X, R / (FEW +
//      1))) and surplus blocks exit; the N tiles of one row tile are
//      consecutive blocks, so the expert's rows are reused from L2;
//    * the K loop streams both operands in 64-deep chunks: the tile's rows
//      (128 x 64 bf16, 16 KB) and codes (64 x 128 bytes, 8 KB) land with
//      16-byte cp.async.cg in a 3-stage ring, one barrier per chunk; the
//      copying thread widens its own 16 bytes of codes to bf16 in the ring
//      before the barrier (int8: byte permutes and adds; e4m3: the fp8x2 ->
//      half2 conversion, both exact), so nothing of the expert's code tile
//      is held whole and any K (a multiple of 8) is taken;
//    * A fragments by ldmatrix of XOR-swizzled rows, B by ldmatrix.trans of
//      the widened [k][n] tile; the epilogue multiplies the column scales in
//      f32 and stores f32 rows, masking rows past the expert's end.
// 2. Few-rows blocks (bf16 lhs, experts of 1 to FEW = 16 rows: decode, where
//    B = 8 tokens top-6 over 64 experts give 0-4 rows each). What bounds
//    them: the code bytes of the experts that own a row (V2-Lite's gate
//    shape, 34 such experts x 2048 x 1408: 98 MB, 29 us at 3.35 TB/s); the
//    products are at most 32 flops per code byte. The design keeps the card's
//    memory busy with copies in flight in every warp and the products on the
//    tensor cores:
//    * a block owns one slot (the 1-16 rows of one expert) x FTN = 128
//      columns x one K split. Slots are found on the device by the same
//      warp scan as the tiled blocks; the grid is sized by the host's bound
//      on slots, min(X, R), and surplus blocks, all at the end of the grid,
//      exit;
//    * each of the 8 warps takes every 8th 16-deep K step of the block's
//      split and streams it through its own 4-stage ring, three steps in
//      flight while one computes, no block barrier in the K loop. A stage
//      is two TMA tile loads issued by one lane and completing on the
//      stage's mbarrier: the step's codes (16 K rows x 128 columns, one box
//      of a 3-D tensor map over [X][K][N], 128-byte swizzle) and the slot's
//      rows (16 x 16 bf16, a 2-D map over [R][K], 32-byte swizzle), zeros
//      past K, N and R. A first design moved the same stages with 16-byte
//      cp.async.cg, each lane copying its own chunks: on the card it ran at
//      a third of the bytes bound however deep the ring (2 stages as fast
//      as 4), and as fast without its products, so what one SM keeps in
//      flight through cp.async set its time; TMA's copies are not held by
//      the issuing threads;
//    * products on mma.sync m16n8k16 with the operands swapped, out^T =
//      codes^T rows^T: the A fragment is a pair of columns x the step's 16
//      K rows, built in registers from a lane's four 16-byte code chunks (K
//      rows 2q, 2q + 1, 2q + 8, 2q + 9 at columns 16g, q and g the lane's
//      fragment coordinates) by a byte permute of two K rows' code words and
//      the exact widening to bf16 (int8: magic-number adds; e4m3: the fp8x2
//      -> half2 conversion), so no code is staged widened; the B fragment is
//      the slot's rows by ldmatrix (rows 8-15 only when the slot has more
//      than 8). 8 products per step cover the warp's 128 columns;
//    * the 8 warps' f32 partials meet in shared memory in warp order; a
//      launch whose grid would not fill the card once also splits K across
//      blocks (the host's n_split), each split writing its partial to
//      scratch, and the last split of the (slot, column tile) to take the
//      unit's atomic ticket sums the partials in split order: no float
//      atomics, the same bits on every run. The column scale multiplies
//      after the sum.
//    Occupancy: the 64 f32 accumulators of a lane (16 rows x 128 columns a
//    warp) hold a block to 128 registers, so 2 blocks (16 warps) share an
//    SM whatever the launch's shared memory (a decode launch asks for the
//    tiled blocks' 112 KB too; an instantiation with the few-rows mode's
//    81 KB alone timed the same on the card); the TMA rings, not the warp
//    count, keep the bytes in flight (~120 KB an SM). A decode launch's
//    tiled blocks find no tile and exit at once.
// 3. Per-expert CUDA-core blocks (f32 lhs: the tiny f32 models, held token
//    for token to the CPU; grid: expert x 32-column tile): the block copies
//    its whole K x 32 code tile once and walks the rows in passes of RP,
//    each thread owning RR rows x 4 columns.
// 4. Zero blocks: the rows at or past sum(group_sizes), which no expert
//    owns, come out as exact zeros.
//
// Later work: the tiled blocks' time is set by their K-chunk pipeline more
// than by their products (PERF.md); wgmma with TMA loads and a producer
// warp is the next design.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 8;         // warps per block
constexpr int NT = NW * 32;   // threads per block
constexpr int FEW = 16;       // few-rows mode: rows of a slot
// f32 per-expert blocks and the zero blocks
constexpr int TN = 32;        // output columns per block
constexpr int CG = TN / 4;    // column groups of 4
constexpr int RG = NT / CG;   // row groups
constexpr int RR = 2;         // rows per thread per pass
constexpr int RP = RG * RR;   // rows per pass
constexpr int KC = 64;        // K per lhs staging chunk
constexpr int XS = RP + 2;    // padded row stride of the staged lhs
static_assert(RR == 2, "the inner loop reads one float2 of rows");
// few-rows blocks
constexpr int FTN = 128;                     // output columns per block
constexpr int FST = 4;                       // stages of a warp's ring
constexpr int FCODES = 16 * FTN;             // a step's codes: 16 K rows
constexpr int FROWS = FEW * 16 * 2;          // the slot's 16 rows x 16 bf16
constexpr int FROWS_AT = NW * FST * FCODES;  // the rows' stages, after the codes'
constexpr int FBAR_AT = FROWS_AT + NW * FST * FROWS;  // the stages' mbarriers
constexpr size_t FEW_SMEM = FBAR_AT + NW * FST * 8
                            + 1024;  // the slack that aligns the ring to 1 KB
static_assert((size_t)NW * FEW * FTN * 4 <= FBAR_AT,
              "the warps' partials reuse the rings");
constexpr int MAX_FSPLIT = 16;               // most K splits across blocks
// tiled blocks
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int TSTAGES = 3;                       // K chunks in the ring
constexpr int WM = BM / 2, WN = BN / 4;          // one warp's output tile
constexpr int MT = WM / 16, NTW = WN / 8;        // its m16 and n8 tiles
constexpr int ACH = BK / 8;                      // 16-byte chunks per row chunk
constexpr int CCH = BN / 16;                     // 16-byte chunks per code row
static_assert(BM * ACH % NT == 0 && BK * CCH % NT == 0 && NT % ACH == 0 &&
              NT % CCH == 0 && NTW % 2 == 0, "copy and fragment split");
constexpr int A_TILE = BM * BK;                  // bf16 elements of a row chunk
constexpr int B_TILE = BK * BN;                  // bf16 elements of a code chunk
constexpr size_t TILED_SMEM =
    (size_t)TSTAGES * (A_TILE + B_TILE) * 2      // the bf16 ring
    + (size_t)(TSTAGES - 1) * B_TILE;            // codes of the chunks in flight

__host__ __device__ constexpr size_t w_bytes(int K) {
  return ((size_t)K * TN + 15) / 16 * 16;
}
// the f32 CUDA-core body: the whole K x TN code tile plus the lhs staging
__host__ __device__ constexpr size_t core_smem(int K) {
  return w_bytes(K) + (size_t)KC * XS * 4;
}


// four codes of one 32-bit word, widened to f32
template <typename TW>
__device__ __forceinline__ void widen4f(uint32_t w, float (&out)[4]);
template <>
__device__ __forceinline__ void widen4f<int8_t>(uint32_t w, float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = (float)(int8_t)((w >> (8 * j)) & 0xff);
}
template <>
__device__ __forceinline__ void widen4f<__nv_fp8_e4m3>(uint32_t w,
                                                       float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_fp8_e4m3 v;
    v.__x = (__nv_fp8_storage_t)((w >> (8 * j)) & 0xff);
    out[j] = (float)v;
  }
}

// int8: each code + 128 goes into the low mantissa byte of 2^23 (byte
// permutes and adds, no int-to-float conversion); an integer below 2^8 in
// f32 is its bf16 in the top 16 bits. Four codes -> two bf16x2 (bytes 0-1,
// bytes 2-3)
__device__ __forceinline__ uint2 widen4_int8(uint32_t codes) {
  const uint32_t u = codes ^ 0x80808080u;  // code + 128, as unsigned bytes
  uint32_t f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) -
        8388736.0f);  // 2^23 + 128
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}
// e4m3: two codes -> half2 (exact: e4m3 fits half), -> bf16x2 (exact:
// three mantissa bits)
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw hr =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two & 0xffff), __NV_E4M3);
  const float2 f = __half22float2(__half2(hr));
  __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<uint32_t*>(&b);
}
// four codes -> two bf16x2 (bytes 0-1, bytes 2-3), exact
template <typename TW>
__device__ __forceinline__ uint2 widen4(uint32_t codes);
template <>
__device__ __forceinline__ uint2 widen4<int8_t>(uint32_t codes) {
  return widen4_int8(codes);
}
template <>
__device__ __forceinline__ uint2 widen4<__nv_fp8_e4m3>(uint32_t codes) {
  return make_uint2(e4m3x2_to_bf16x2(codes), e4m3x2_to_bf16x2(codes >> 16));
}
// 16 codes -> 16 bf16 (two 16-byte halves), exact
template <typename TW>
__device__ __forceinline__ void widen16(uint4 raw, uint4& lo, uint4& hi) {
  const uint2 w0 = widen4<TW>(raw.x), w1 = widen4<TW>(raw.y);
  const uint2 w2 = widen4<TW>(raw.z), w3 = widen4<TW>(raw.w);
  lo = make_uint4(w0.x, w0.y, w1.x, w1.y);
  hi = make_uint4(w2.x, w2.y, w3.x, w3.y);
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// mbarriers and TMA tile loads (the few-rows ring)
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// a copy that never lands faults the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    if (spin == (1ll << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// box {c0, c1, c2} of a 3-D tensor map -> shared memory, completing on bar
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled bf16
// tile of W columns: the chunk index XOR (row % 8), so the 8 rows an
// ldmatrix reads at one logical chunk hit 8 different bank groups
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  return (row * (W / 8) + (chunk ^ (row & 7))) * 8;
}

// Tile t of a list that walks the experts in order, an expert of n rows
// giving ceil(n / TM) tiles when lo <= n <= hi and none otherwise: its
// expert, first row and row count, found by warp 0 with a running warp scan
// over group_sizes (tiles and rows). Returns false past the last tile (a
// surplus block). Every thread of the block calls it once.
template <int TM>
__device__ __forceinline__ bool find_tile(const long long* __restrict__ gs,
                                          int X, int t, int lo, int hi,
                                          int& e_out, int& r0_out,
                                          int& nr_out) {
  __shared__ int s_e, s_r0, s_nr;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) s_e = -1;
    __syncwarp();
    int carry = 0, rows = 0;
    for (int base = 0; base < X; base += 32) {
      const int e = base + lane;
      const int n = e < X ? (int)gs[e] : 0;
      const int tiles = n >= lo && n <= hi ? (n + TM - 1) / TM : 0;
      int incl = tiles, incl_rows = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        const int w = __shfl_up_sync(0xffffffffu, incl_rows, o);
        if (lane >= o) {
          incl += v;
          incl_rows += w;
        }
      }
      const int first = carry + incl - tiles;
      if (tiles > 0 && t >= first && t < first + tiles) {
        const int st = rows + incl_rows - n;
        s_e = e;
        s_r0 = st + (t - first) * TM;
        s_nr = min(TM, st + n - s_r0);
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
      rows += __shfl_sync(0xffffffffu, incl_rows, 31);
      if (carry > t) break;  // carry is the same in every lane
    }
  }
  __syncthreads();
  e_out = s_e;
  r0_out = s_r0;
  nr_out = s_nr;
  return s_e >= 0;
}

// ---------------- tiled blocks (bf16 lhs, more than FEW rows) ----------------

// One BM x BN output tile: rows [r0, r0 + nr) of expert e, columns
// [n0, n0 + BN), streamed over K in BK-deep chunks through the ring.
template <typename TW>
__device__ __forceinline__ void tiled_tile(const bf16* __restrict__ lhs,
                                           const uint8_t* __restrict__ wq,
                                           const float* __restrict__ ws,
                                           float* __restrict__ out, int K,
                                           int N, int e, int r0, int nr,
                                           int n0, unsigned char* smem) {
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [stage][A | B]
  uint8_t* codes = smem + (size_t)TSTAGES * (A_TILE + B_TILE) * 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of WM x WN
  const int nsteps = (K + BK - 1) / BK;
  const bf16* xsrc = lhs + (size_t)r0 * K;
  const uint8_t* wsrc = wq + (size_t)e * K * N + n0;
  // this thread's copies: A rows arow + (NT / ACH) j at 16-byte chunk ac,
  // code rows crow + (NT / CCH) j at chunk cc
  const int arow = tid / ACH, ac = tid % ACH;
  const int crow = tid / CCH, cc = tid % CCH;

  auto copy_step = [&](int s) {
    const int k0 = s * BK;
    bf16* A = ring + (s % TSTAGES) * (A_TILE + B_TILE);
#pragma unroll
    for (int j = 0; j < BM * ACH / NT; ++j) {
      const int row = arow + (NT / ACH) * j;
      const bool ok = row < nr && k0 + ac * 8 < K;
      cp_async16(A + swz<BK>(row, ac),
                 ok ? xsrc + (size_t)row * K + k0 + ac * 8 : lhs, ok ? 16 : 0);
    }
    uint8_t* cs = codes + (s % (TSTAGES - 1)) * B_TILE;
#pragma unroll
    for (int j = 0; j < BK * CCH / NT; ++j) {
      const int kr = crow + (NT / CCH) * j;
      const bool ok = k0 + kr < K && n0 + cc * 16 < N;
      cp_async16(cs + kr * BN + cc * 16,
                 ok ? wsrc + (size_t)(k0 + kr) * N + cc * 16 : wq, ok ? 16 : 0);
    }
  };
  // the copying thread widens its own code chunks into the ring's B tile
  auto widen = [&](int s) {
    bf16* B = ring + (s % TSTAGES) * (A_TILE + B_TILE) + A_TILE;
    const uint8_t* cs = codes + (s % (TSTAGES - 1)) * B_TILE;
#pragma unroll
    for (int j = 0; j < BK * CCH / NT; ++j) {
      const int kr = crow + (NT / CCH) * j;
      uint4 lo, hi;
      widen16<TW>(*reinterpret_cast<const uint4*>(cs + kr * BN + cc * 16), lo,
                  hi);
      *reinterpret_cast<uint4*>(B + swz<BN>(kr, 2 * cc)) = lo;
      *reinterpret_cast<uint4*>(B + swz<BN>(kr, 2 * cc + 1)) = hi;
    }
  };

  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // the first TSTAGES - 1 chunks in flight, one commit group each
#pragma unroll
  for (int i = 0; i < TSTAGES - 1; ++i) {
    if (i < nsteps) copy_step(i);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<TSTAGES - 2>();  // this thread's copies of chunk s landed
    widen(s);
    // chunk s is complete, and every warp is done with chunk s - 1 (whose
    // stage the next copy overwrites)
    __syncthreads();
    if (s + TSTAGES - 1 < nsteps) copy_step(s + TSTAGES - 1);
    cp_async_commit();

    const bf16* A = ring + (s % TSTAGES) * (A_TILE + B_TILE);
    const bf16* B = A + A_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * WM + mt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4(smem_u32(A + swz<BK>(r, kk * 2 + (lane >> 4))), a[mt]);
      }
#pragma unroll
      for (int nn = 0; nn < NTW / 2; ++nn) {
        uint32_t b[4];
        const int r = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(smem_u32(B + swz<BN>(r, wn * (WN / 8) + nn * 2 + (lane >> 4))),
                  b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * nn], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nn + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: (row g, cols 2q, 2q+1) and (row g + 8, the same columns)
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int col = n0 + wn * WN + nt * 8 + 2 * q;
    if (col >= N) continue;
    const float s0 = ws[(size_t)e * N + col], s1 = ws[(size_t)e * N + col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * WM + mt * 16 + g + h * 8;
        if (row < nr)
          *reinterpret_cast<float2*>(out + (size_t)(r0 + row) * N + col) =
              make_float2(acc[mt][nt][2 * h] * s0, acc[mt][nt][2 * h + 1] * s1);
      }
    }
  }
}

// ---------------- few-rows blocks (bf16 lhs, 1 to FEW rows) ----------------

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One slot: rows [r0, r0 + nr) (nr <= FEW) of expert e x columns [n0, n0 +
// FTN), over split z of n_split of K; `unit` numbers the (slot, column
// tile) for the split merge. Each warp's ring stage is one TMA box of codes
// (16 K rows x 128 columns of expert e: the 3-D map over [X][K][N], 128-byte
// swizzle: 16-byte chunk g of row j at g ^ (j % 8)) and one of rows (16
// rows x 16 K of the 2-D map over [R][K], 32-byte swizzle: k half h of row
// r at h ^ (r / 4 % 2)), both zero-filled past K, N and R, completing on
// the stage's mbarrier.
template <typename TW>
__device__ __forceinline__ void few_rows_tile(
    const CUtensorMap* codes_map, const CUtensorMap* rows_map,
    const float* __restrict__ ws, float* __restrict__ out, int K, int N,
    int e, int r0, int nr, int n0, int z, int n_split, int unit,
    float* __restrict__ part, int* __restrict__ tickets, unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // this block's K steps (16 deep) and, of them, this warp's: every NW-th
  const int nk = (K + 15) / 16;
  const int per = (nk + n_split - 1) / n_split;
  const int live = (nk + per - 1) / per;  // splits that hold a step
  if (z >= live) return;
  const int s0 = z * per + warp, s_end = min(nk, (z + 1) * per);
  const int n = s0 < s_end ? (s_end - s0 + NW - 1) / NW : 0;
  const unsigned codes0 = smem_u32(smem) + warp * FST * FCODES;
  const unsigned rows0 = smem_u32(smem) + FROWS_AT + warp * FST * FROWS;
  const unsigned bar0 = smem_u32(smem) + FBAR_AT + warp * FST * 8;
  if (lane == 0) {
    for (int st = 0; st < FST; ++st) mbar_init(bar0 + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto copy_step = [&](int i) {  // lane 0
    const int st = i % FST, k0 = (s0 + i * NW) * 16;
    mbar_expect_tx(bar0 + st * 8, FCODES + FROWS);
    tma_load_3d(codes0 + st * FCODES, codes_map, n0, k0, e, bar0 + st * 8);
    tma_load_2d(rows0 + st * FROWS, rows_map, k0, r0, bar0 + st * 8);
  };

  // acc[h][j]: columns 16g + 2j (m = g) and 16g + 2j + 1 (m = g + 8) x
  // rows 8h + 2q, 8h + 2q + 1 (the mma's n)
  float acc[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;
  const bool upper = nr > 8;  // rows 8-15 hold anything
  // this lane's code chunks: K rows 2q, 2q+1, 2q+8, 2q+9, columns 16g..+15
  int a_src[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = 2 * q + (c & 1) + 8 * (c >> 1);
    a_src[c] = j * FTN + ((g ^ (j & 7)) << 4);
  }
  // ldmatrix: lane -> row (lane / 16) * 8 + lane % 8, k half lane / 8 % 2
  const int br = ((lane >> 4) << 3) + (lane & 7), bh = (lane >> 3) & 1;
  const int b_src = br * 32 + ((bh ^ ((br >> 2) & 1)) << 4);

  if (lane == 0)
    for (int i = 0; i < FST - 1 && i < n; ++i) copy_step(i);
  for (int i = 0; i < n; ++i) {
    const int st = i % FST;
    mbar_wait(bar0 + st * 8, (i / FST) & 1);  // step i landed
    // every lane is done with step i - 1, whose stage the next copy fills
    __syncwarp();
    if (lane == 0 && i + FST - 1 < n) copy_step(i + FST - 1);
    const unsigned char* cs = smem + warp * FST * FCODES + st * FCODES;
    uint4 raw[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      raw[c] = *reinterpret_cast<const uint4*>(cs + a_src[c]);
    uint32_t b[4];  // rows 0-7: b[0], b[1]; rows 8-15: b[2], b[3]
    ldsm_x4(rows0 + st * FROWS + b_src, b);
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {  // columns 16g + 4wd .. + 3
#pragma unroll
      for (int hj = 0; hj < 2; ++hj) {
        // (K row 2q, 2q+1) pairs of columns 4wd + 2hj and + 1, then of K
        // rows 2q+8, 2q+9: the A fragment of product j = 2wd + hj
        const uint32_t sel = hj ? 0x7362u : 0x5140u;
        const uint2 lo =
            widen4<TW>(__byte_perm(word(raw[0], wd), word(raw[1], wd), sel));
        const uint2 hi =
            widen4<TW>(__byte_perm(word(raw[2], wd), word(raw[3], wd), sel));
        const uint32_t a[4] = {lo.x, lo.y, hi.x, hi.y};
        mma_bf16(acc[0][2 * wd + hj], a, b[0], b[1]);
        if (upper) mma_bf16(acc[1][2 * wd + hj], a, b[2], b[3]);
      }
    }
  }

  // the warps' partials meet in shared memory, summed in warp order
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(smem);  // [NW][FEW][FTN]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 16 * g + 2 * j, row = 8 * h + 2 * q;
      float* d = red + ((size_t)warp * FEW + row) * FTN + col;
      if (row < nr)
        *reinterpret_cast<float2*>(d) = make_float2(acc[h][j][0], acc[h][j][2]);
      if (row + 1 < nr)
        *reinterpret_cast<float2*>(d + FTN) =
            make_float2(acc[h][j][1], acc[h][j][3]);
    }
  }
  __syncthreads();
  const int ncol = min(FTN, N - n0);
  const float* scale = ws + (size_t)e * N + n0;
  if (n_split == 1) {
    for (int i = tid; i < nr * ncol; i += NT) {
      const int row = i / ncol, col = i % ncol;
      float s = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < NW; ++w2) s += red[((size_t)w2 * FEW + row) * FTN + col];
      out[(size_t)(r0 + row) * N + n0 + col] = s * scale[col];
    }
    return;
  }
  // K split across blocks: this split's partial to scratch, and the unit's
  // last split sums every split's partial in split order
  float* mine = part + ((size_t)unit * n_split + z) * FEW * FTN;
  for (int i = tid; i < nr * ncol; i += NT) {
    const int row = i / ncol, col = i % ncol;
    float s = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < NW; ++w2) s += red[((size_t)w2 * FEW + row) * FTN + col];
    mine[row * FTN + col] = s;
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  __shared__ int s_last;
  if (tid == 0) s_last = atomicAdd(tickets + unit, 1) == live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = part + (size_t)unit * n_split * FEW * FTN;
  for (int i = tid; i < nr * ncol; i += NT) {
    const int row = i / ncol, col = i % ncol;
    float s = 0.f;
    for (int zz = 0; zz < live; ++zz)
      s += __ldcg(all + ((size_t)zz * FEW + row) * FTN + col);
    out[(size_t)(r0 + row) * N + n0 + col] = s * scale[col];
  }
  if (tid == 0) tickets[unit] = 0;  // ready for the next launch
}

// ---------------- f32 rows: per-expert CUDA-core blocks ----------------

// The whole K x TN code tile once, then the rows in passes of RP on CUDA
// cores.
template <typename TW>
__device__ __forceinline__ void core_rows(const float* __restrict__ lhs,
                                          const uint8_t* __restrict__ wq,
                                          const float* __restrict__ ws,
                                          float* __restrict__ out, int start,
                                          int end, int K, int N, int n0, int e,
                                          unsigned char* smem) {
  unsigned char* w_s = smem;                                // [K][TN] codes
  float* x_s = reinterpret_cast<float*>(smem + w_bytes(K));  // [KC][XS]
  const uint8_t* src = wq + (size_t)e * K * N + n0;
  for (int i = threadIdx.x; i < K * (TN / 16); i += NT) {
    const int k = i / (TN / 16), part = i % (TN / 16);
    cp_async16(w_s + k * TN + part * 16, src + (size_t)k * N + part * 16);
  }
  cp_async_commit();
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const float4 sc =
      *reinterpret_cast<const float4*>(ws + (size_t)e * N + n0 + cg * 4);
  for (int r0 = start; r0 < end; r0 += RP) {
    const int nr = min(RP, end - r0);
    const bool mine = rg * RR < nr;
    float acc[RR][4];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      for (int i = threadIdx.x; i < nr * kc; i += NT) {
        const int r = i / kc, kk = i % kc;
        x_s[kk * XS + r] = lhs[(size_t)(r0 + r) * K + k0 + kk];
      }
      cp_async_wait<0>();  // the codes landed (a no-op after the first)
      __syncthreads();
      if (mine) {
        for (int kk = 0; kk < kc; ++kk) {
          const uint32_t w4 =
              *reinterpret_cast<const uint32_t*>(w_s + (k0 + kk) * TN + cg * 4);
          float wf[4];
          widen4f<TW>(w4, wf);
          const float2 xv =
              *reinterpret_cast<const float2*>(x_s + kk * XS + rg * RR);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[0][j] = fmaf(xv.x, wf[j], acc[0][j]);
            acc[1][j] = fmaf(xv.y, wf[j], acc[1][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int r = rg * RR + i;
      if (r >= nr) continue;
      *reinterpret_cast<float4*>(out + (size_t)(r0 + r) * N + n0 + cg * 4) =
          make_float4(acc[i][0] * sc.x, acc[i][1] * sc.y, acc[i][2] * sc.z,
                      acc[i][3] * sc.w);
    }
  }
}

// The linear grid: bf16 rows: n_tiled tiled blocks (row tile major, its N
// tiles together), then n_few few-rows blocks; f32 rows: X x N/TN
// per-expert blocks. Then N/TN zero blocks. Few-rows block b: slot b /
// (ntn * n_split), column tile b / n_split % ntn, K split b % n_split.
template <typename TX, typename TW>
__global__ void __launch_bounds__(NT, 2)
ragged_gmm_kernel(const TX* __restrict__ lhs, const uint8_t* __restrict__ wq,
                  const float* __restrict__ ws,
                  const long long* __restrict__ gs, float* __restrict__ out,
                  int R, int K, int N,
                  int X, int n_tiled, int n_few, int n_split,
                  float* __restrict__ part, int* __restrict__ tickets,
                  const __grid_constant__ CUtensorMap codes_map,
                  const __grid_constant__ CUtensorMap rows_map) {
  extern __shared__ __align__(128) unsigned char smem[];
  int b = blockIdx.x;
  if constexpr (std::is_same<TX, float>::value) {
    const int ntn = N / TN;
    if (b < X * ntn) {
      const int e = b / ntn, n0 = (b % ntn) * TN;
      int start = 0;  // every thread sums the sizes before e (X is small)
      for (int i = 0; i < e; ++i) start += (int)gs[i];
      const int nr = (int)gs[e];
      if (nr > 0) core_rows<TW>(lhs, wq, ws, out, start, start + nr, K, N, n0,
                                e, smem);
      return;
    }
    b -= X * ntn;
  } else {
    if (b < n_tiled) {
      const int nb = (N + BN - 1) / BN;
      int e, r0, nr;
      if (find_tile<BM>(gs, X, b / nb, FEW + 1, R, e, r0, nr))
        tiled_tile<TW>(lhs, wq, ws, out, K, N, e, r0, nr, (b % nb) * BN, smem);
      return;
    }
    b -= n_tiled;
    if (b < n_few) {
      const int ntn = (N + FTN - 1) / FTN;
      const int z = b % n_split, ct = b / n_split % ntn;
      const int slot = b / (n_split * ntn);
      int e, r0, nr;
      if (find_tile<FEW>(gs, X, slot, 1, FEW, e, r0,
                         nr))  // the ring's TMA boxes want 1 KB alignment
        few_rows_tile<TW>(&codes_map, &rows_map, ws, out, K, N, e, r0, nr,
                          ct * FTN, z, n_split, slot * ntn + ct, part, tickets,
                          smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
      return;
    }
    b -= n_few;
  }
  // the rows no expert owns come out as exact zeros
  __shared__ int s_total;
  if (threadIdx.x < 32) {
    int t = 0;
    for (int e = threadIdx.x; e < X; e += 32) t += (int)gs[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) s_total = t;
  }
  __syncthreads();
  const int n0 = b * TN;
  const long long n_rows = R - s_total;
  for (long long i = threadIdx.x; i < n_rows * CG; i += NT) {
    const long long r = s_total + i / CG;
    *reinterpret_cast<float4*>(out + r * N + n0 + (i % CG) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The few-rows ring's two tensor maps: the codes [X][K][N] (bytes) in boxes
// of 1 x 16 x FTN, 128-byte swizzle; the rows [R][K] (bf16) in boxes of 16
// x 16, 32-byte swizzle; zeros past every edge.
bool few_rows_maps(const void* lhs, const void* wq, int R, int K, int N,
                   int X, CUtensorMap* codes, CUtensorMap* rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t c_dim[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)X};
  const cuuint64_t c_stride[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t c_box[3] = {FTN, 16, 1};
  const cuuint64_t r_dim[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t r_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t r_box[2] = {16, FEW};
  return enc(codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wq),
             c_dim, c_stride, c_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         enc(rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(lhs),
             r_dim, r_stride, r_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TX, typename TW>
cudaError_t launch_typed(const void* lhs, const void* wq, const float* ws,
                         const long long* gs, float* out, int R, int K, int N,
                         int X, int n_split, float* part, int* tickets,
                         cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<TX, float>::value;
  auto kern = ragged_gmm_kernel<TX, TW>;
  const size_t smem = kF32                     ? core_smem(K)
                      : TILED_SMEM > FEW_SMEM ? TILED_SMEM
                                              : FEW_SMEM;
  static size_t attr = 0;  // the dynamic shared memory opted in so far
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr = smem;
  }
  CUtensorMap codes_map = {}, rows_map = {};
  int n_tiled = 0, n_few = 0;
  long long blocks = N / TN;  // the zero blocks
  if (kF32) {
    blocks += (long long)X * (N / TN);
  } else {
    if (!few_rows_maps(lhs, wq, R, K, N, X, &codes_map, &rows_map))
      return cudaErrorInvalidValue;
    // row tiles of the experts with more than FEW rows: at most one partial
    // tile per such expert beyond ceil(R / BM), and at most R / (FEW + 1)
    // such experts
    const int nb = (N + BN - 1) / BN;
    n_tiled = nb * ((R + BM - 1) / BM + min(X, R / (FEW + 1)));
    // slots: at most min(X, R) experts own a row
    n_few = min(X, R) * ((N + FTN - 1) / FTN) * n_split;
    blocks += (long long)n_tiled + n_few;
  }
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const TX*>(lhs), static_cast<const uint8_t*>(wq), ws, gs,
      out, R, K, N, X, n_tiled, n_few, n_split, part, tickets,
      codes_map, rows_map);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. lhs_dtype: 0 = float32,
// 1 = bfloat16; w_dtype: 0 = int8, 1 = float8_e4m3fn. ``gs`` holds the
// group sizes ([X] int64). N must be a multiple of 32;
// bf16 lhs takes any K that is a multiple of 8, f32 lhs a K whose K x 32 code
// tile fits a block's shared memory beside its staging (the wrapper checks
// both). bf16 only: n_split (1..16) splits K across the few-rows blocks,
// and with n_split > 1 ``part`` holds min(X, R) * ceil(N / 128) * n_split *
// 16 * 128 floats and ``tickets`` min(X, R) * ceil(N / 128) ints, zero
// before the launch and zero after it. Returns the launch's cudaError_t.
extern "C" int ragged_int8_gmm_launch(const void* lhs, const void* wq,
                                      const float* ws, const long long* gs,
                                      float* out, int R, int K, int N, int X,
                                      int n_split,
                                      float* part, int* tickets,
                                      int lhs_dtype, int w_dtype,
                                      void* stream) {
  if (R == 0 || N == 0) return 0;
  if (N % TN != 0 || X < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lhs_dtype == 0 && w_dtype == 0)
    return (int)launch_typed<float, int8_t>(lhs, wq, ws, gs, out, R, K, N, X,
                                            1, nullptr, nullptr, st);
  if (lhs_dtype == 0 && w_dtype == 1)
    return (int)launch_typed<float, __nv_fp8_e4m3>(
        lhs, wq, ws, gs, out, R, K, N, X, 1, nullptr, nullptr, st);
  if (lhs_dtype != 1 || K % 8 != 0 || n_split < 1 || n_split > MAX_FSPLIT ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (w_dtype == 0)
    return (int)launch_typed<bf16, int8_t>(lhs, wq, ws, gs, out, R, K, N, X,
                                           n_split, part, tickets, st);
  if (w_dtype == 1)
    return (int)launch_typed<bf16, __nv_fp8_e4m3>(lhs, wq, ws, gs, out, R, K,
                                                  N, X, n_split, part,
                                                  tickets, st);
  return (int)cudaErrorInvalidValue;
}
