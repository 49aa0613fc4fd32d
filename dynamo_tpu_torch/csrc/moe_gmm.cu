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
// accumulate in f32, the scale multiplies after the K loop, as there. Expert
// offsets come from the device cumsum of group_sizes (`ends`); no host sync.
//
// One launch, three kinds of block in one linear grid, chosen by the
// expert's row count and the lhs dtype (explicit dispatches, never a
// fallback of one body to another):
//
// 1. Tiled blocks (bf16 lhs, experts with more than RS rows: a prompt's
//    rows). What bounds them on an H100: the code bytes and the operations
//    (DeepSeek-V2-Lite, 1201 tokens: 184 MB of codes and 42 GFLOP, ~55 us
//    and ~42 us at the card's peaks). The design, a tiled M x N x K GEMM on
//    mma.sync for Hopper's shared memory and asynchronous copies:
//    * an output tile is BM = 128 rows of ONE expert x BN = 128 columns; 8
//      warps as 2 x 4, each 64 x 32 (16 m16n8k16 products per 16-deep step
//      against 4 A and 2 B fragment loads);
//    * the tile list lives on the device: row tiles are expert-local
//      (expert e's rows [start, end) cut every BM rows from start), counted
//      from `ends` by a warp scan in each block, as the reference's
//      _step_metadata counts its (expert, row tile) steps; the grid is sized
//      by the host's upper bound N / BN x (ceil(R / BM) + min(X, R / (RS +
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
// 2. Per-expert blocks (grid: expert x 32-column tile). An expert with 1 to
//    RS rows (decode: B = 8 tokens top-6 over 64 experts gives 0-3 rows
//    each) is bound by its code bytes, ~2 flops per code byte per row: the
//    few-rows mode streams the expert's K x 32 codes in KCF-deep chunks with
//    cp.async (two chunks in flight: at K <= 2048 all of them), stages the
//    rows' chunk as f32, and the block's row groups split K, each thread
//    summing its K-slice for every row; the partial sums meet in shared
//    memory. With f32 lhs (the tiny f32 models, held token for token to the
//    CPU) an expert with more rows runs the CUDA-core body here: the block
//    copies its whole K x 32 code tile once and walks the rows in passes of
//    RP, each thread owning RR rows x 4 columns.
// 3. Zero blocks: the rows at or past sum(group_sizes), which no expert
//    owns, come out as exact zeros.
//
// Later work: the tiled blocks' time is set by their K-chunk pipeline more
// than by their products (PERF.md); wgmma with TMA loads and a producer
// warp is the next design.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;       // threads per block
// per-expert blocks
constexpr int TN = 32;        // output columns per block
constexpr int CG = TN / 4;    // column groups of 4
constexpr int RG = NT / CG;   // row groups
constexpr int RR = 2;         // CUDA-core body: rows per thread per pass
constexpr int RP = RG * RR;   // CUDA-core body: rows per pass
constexpr int KC = 64;        // CUDA-core body: K per lhs staging chunk
constexpr int XS = RP + 2;    // CUDA-core body: padded row stride of the staged lhs
static_assert(RR == 2, "the inner loop reads one float2 of rows");
constexpr int RS = 4;         // few-rows mode: at most this many rows
constexpr int KG = NT / CG;   // few-rows mode: K groups
constexpr int KCF = 1024;     // few-rows mode: K per chunk of codes and rows
static_assert(KG * RS * TN <= RS * KCF, "partial sums reuse the row staging");
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
constexpr size_t FEW_SMEM = (size_t)2 * KCF * TN + (size_t)RS * KCF * 4;

__host__ __device__ constexpr size_t w_bytes(int K) {
  return ((size_t)K * TN + 15) / 16 * 16;
}
// the f32 CUDA-core body: the whole K x TN code tile plus the lhs staging
__host__ __device__ constexpr size_t core_smem(int K) {
  return w_bytes(K) + (size_t)KC * XS * 4;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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

// 16 codes -> 16 bf16 (two 16-byte halves), exact
template <typename TW>
__device__ __forceinline__ void widen16(uint4 raw, uint4& lo, uint4& hi);
// int8: each code + 128 goes into the low mantissa byte of 2^23 (byte
// permutes and adds, no int-to-float conversion); an integer below 2^8 in
// f32 is its bf16 in the top 16 bits
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
template <>
__device__ __forceinline__ void widen16<int8_t>(uint4 raw, uint4& lo,
                                                uint4& hi) {
  const uint2 w0 = widen4_int8(raw.x), w1 = widen4_int8(raw.y);
  const uint2 w2 = widen4_int8(raw.z), w3 = widen4_int8(raw.w);
  lo = make_uint4(w0.x, w0.y, w1.x, w1.y);
  hi = make_uint4(w2.x, w2.y, w3.x, w3.y);
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
template <>
__device__ __forceinline__ void widen16<__nv_fp8_e4m3>(uint4 raw, uint4& lo,
                                                       uint4& hi) {
  lo = make_uint4(e4m3x2_to_bf16x2(raw.x), e4m3x2_to_bf16x2(raw.x >> 16),
                  e4m3x2_to_bf16x2(raw.y), e4m3x2_to_bf16x2(raw.y >> 16));
  hi = make_uint4(e4m3x2_to_bf16x2(raw.z), e4m3x2_to_bf16x2(raw.z >> 16),
                  e4m3x2_to_bf16x2(raw.w), e4m3x2_to_bf16x2(raw.w >> 16));
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

// ---------------- tiled blocks (bf16 lhs, more than RS rows) ----------------

// Row tile t of the experts with more than RS rows (expert-local tiles of
// BM rows, experts in order): its expert, first row and row count, found by
// warp 0 with a running warp scan over the experts. Returns false when t is
// past the last tile (a surplus block).
__device__ __forceinline__ bool find_row_tile(const int* __restrict__ ends,
                                              int X, int t, int& e_out,
                                              int& r0_out, int& nr_out) {
  __shared__ int s_e, s_r0, s_nr;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) s_e = -1;
    __syncwarp();
    int carry = 0;
    for (int base = 0; base < X; base += 32) {
      const int e = base + lane;
      int n = 0, st = 0;
      if (e < X) {
        st = e > 0 ? ends[e - 1] : 0;
        n = ends[e] - st;
      }
      const int tiles = n > RS ? (n + BM - 1) / BM : 0;
      int incl = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int lo = carry + incl - tiles;
      if (tiles > 0 && t >= lo && t < lo + tiles) {
        s_e = e;
        s_r0 = st + (t - lo) * BM;
        s_nr = min(BM, st + n - s_r0);
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
      if (carry > t) break;  // carry is the same in every lane
    }
  }
  __syncthreads();
  e_out = s_e;
  r0_out = s_r0;
  nr_out = s_nr;
  return s_e >= 0;
}

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

// ---------------- per-expert blocks ----------------

// Few rows (1..RS): the row groups split K. Codes stream in KCF-deep
// chunks, two in flight.
template <typename TX, typename TW>
__device__ __forceinline__ void few_rows(const TX* __restrict__ lhs,
                                         const uint8_t* __restrict__ wq,
                                         const float* __restrict__ ws,
                                         float* __restrict__ out, int start,
                                         int nr, int K, int N, int n0, int e,
                                         unsigned char* smem) {
  unsigned char* wring = smem;  // [2][KCF][TN] codes
  float* x_s = reinterpret_cast<float*>(smem + 2 * KCF * TN);  // [RS][KCF]
  const int cg = threadIdx.x % CG, kg = threadIdx.x / CG;
  const uint8_t* src = wq + (size_t)e * K * N + n0;
  const int n_chunks = (K + KCF - 1) / KCF;
  auto copy_chunk = [&](int c) {
    const int k0 = c * KCF, kc = min(KCF, K - k0);
    unsigned char* dst = wring + (c & 1) * KCF * TN;
    for (int i = threadIdx.x; i < kc * (TN / 16); i += NT) {
      const int k = i / (TN / 16), part = i % (TN / 16);
      cp_async16(dst + k * TN + part * 16, src + (size_t)(k0 + k) * N + part * 16);
    }
    cp_async_commit();
  };
  copy_chunk(0);
  if (n_chunks > 1) copy_chunk(1);
  float acc[RS][4];
#pragma unroll
  for (int r = 0; r < RS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * KCF, kc = min(KCF, K - k0);
    for (int i = threadIdx.x; i < nr * kc; i += NT) {
      const int r = i / kc, kk = i % kc;
      x_s[r * KCF + kk] = to_f(lhs[(size_t)(start + r) * K + k0 + kk]);
    }
    if (c + 1 < n_chunks)
      cp_async_wait<1>();  // chunk c landed (c + 1 may be in flight)
    else
      cp_async_wait<0>();
    __syncthreads();
    const unsigned char* w_s = wring + (c & 1) * KCF * TN;
    for (int kk = kg; kk < kc; kk += KG) {
      const uint32_t w4 =
          *reinterpret_cast<const uint32_t*>(w_s + kk * TN + cg * 4);
      float wf[4];
      widen4f<TW>(w4, wf);
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        if (r < nr) {
          const float xv = x_s[r * KCF + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
        }
      }
    }
    __syncthreads();
    if (c + 2 < n_chunks) copy_chunk(c + 2);
  }
  float* red = x_s;  // [KG][RS][TN] partial sums
#pragma unroll
  for (int r = 0; r < RS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(kg * RS + r) * TN + cg * 4 + j] = acc[r][j];
  __syncthreads();
  for (int i = threadIdx.x; i < nr * TN; i += NT) {
    const int r = i / TN, col = i % TN;
    float sum = 0.f;
    for (int g2 = 0; g2 < KG; ++g2) sum += red[(g2 * RS + r) * TN + col];
    out[(size_t)(start + r) * N + n0 + col] = sum * ws[(size_t)e * N + n0 + col];
  }
}

// f32 lhs, more than RS rows: the whole K x TN code tile once, then the
// rows in passes of RP on CUDA cores.
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

// The linear grid: n_tiled tiled blocks (bf16 only; row tile major, its N
// tiles together), then X x N/TN per-expert blocks, then N/TN zero blocks.
template <typename TX, typename TW>
__global__ void __launch_bounds__(NT, 2)
ragged_gmm_kernel(const TX* __restrict__ lhs, const uint8_t* __restrict__ wq,
                  const float* __restrict__ ws, const int* __restrict__ ends,
                  float* __restrict__ out, int R, int K, int N, int X,
                  int n_tiled) {
  extern __shared__ __align__(128) unsigned char smem[];
  int b = blockIdx.x;
  const int ntn = N / TN;
  if (b < n_tiled) {
    if constexpr (std::is_same<TX, bf16>::value) {
      const int nb = (N + BN - 1) / BN;
      int e, r0, nr;
      if (find_row_tile(ends, X, b / nb, e, r0, nr))
        tiled_tile<TW>(lhs, wq, ws, out, K, N, e, r0, nr, (b % nb) * BN, smem);
    }
    return;
  }
  b -= n_tiled;
  if (b < X * ntn) {
    const int e = b / ntn, n0 = (b % ntn) * TN;
    const int end = ends[e];
    const int start = e > 0 ? ends[e - 1] : 0;
    const int nr = end - start;
    if (nr <= 0) return;
    if (nr <= RS) {
      few_rows<TX, TW>(lhs, wq, ws, out, start, nr, K, N, n0, e, smem);
    } else if constexpr (std::is_same<TX, float>::value) {
      core_rows<TW>(lhs, wq, ws, out, start, end, K, N, n0, e, smem);
    }  // bf16 with more rows: the tiled blocks own them
    return;
  }
  b -= X * ntn;  // the rows no expert owns come out as exact zeros
  const int n0 = b * TN;
  const int total = ends[X - 1];
  const long long n_rows = R - total;
  for (long long i = threadIdx.x; i < n_rows * CG; i += NT) {
    const long long r = total + i / CG;
    *reinterpret_cast<float4*>(out + r * N + n0 + (i % CG) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename TX, typename TW>
cudaError_t launch_typed(const void* lhs, const void* wq, const float* ws,
                         const int* ends, float* out, int R, int K, int N,
                         int X, cudaStream_t stream) {
  constexpr bool kTiled = std::is_same<TX, bf16>::value;
  auto kern = ragged_gmm_kernel<TX, TW>;
  const size_t smem = kTiled ? (TILED_SMEM > FEW_SMEM ? TILED_SMEM : FEW_SMEM)
                             : (core_smem(K) > FEW_SMEM ? core_smem(K) : FEW_SMEM);
  static size_t attr = 0;  // the dynamic shared memory opted in so far
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr = smem;
  }
  // row tiles of the experts with more than RS rows: at most one partial
  // tile per such expert beyond ceil(R / BM), and at most R / (RS + 1) such
  // experts
  const int nb = (N + BN - 1) / BN;
  const int n_tiled =
      kTiled ? nb * ((R + BM - 1) / BM + min(X, R / (RS + 1))) : 0;
  const long long blocks = (long long)n_tiled + (long long)X * (N / TN) + N / TN;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(static_cast<const TX*>(lhs),
                                               static_cast<const uint8_t*>(wq),
                                               ws, ends, out, R, K, N, X,
                                               n_tiled);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. lhs_dtype: 0 = float32,
// 1 = bfloat16; w_dtype: 0 = int8, 1 = float8_e4m3fn. ``ends`` is the
// inclusive cumsum of group_sizes (int32, [X]). N must be a multiple of 32;
// bf16 lhs takes any K that is a multiple of 8, f32 lhs a K whose K x 32 code
// tile fits a block's shared memory beside its staging (the wrapper checks
// both). Returns the launch's cudaError_t.
extern "C" int ragged_int8_gmm_launch(const void* lhs, const void* wq,
                                      const float* ws, const int* ends,
                                      float* out, int R, int K, int N, int X,
                                      int lhs_dtype, int w_dtype,
                                      void* stream) {
  if (R == 0 || N == 0) return 0;
  if (N % TN != 0 || X < 1) return (int)cudaErrorInvalidValue;
  if (lhs_dtype == 1 && K % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lhs_dtype == 0 && w_dtype == 0)
    return (int)launch_typed<float, int8_t>(lhs, wq, ws, ends, out, R, K, N,
                                            X, st);
  if (lhs_dtype == 1 && w_dtype == 0)
    return (int)launch_typed<bf16, int8_t>(lhs, wq, ws, ends, out, R, K, N, X,
                                           st);
  if (lhs_dtype == 0 && w_dtype == 1)
    return (int)launch_typed<float, __nv_fp8_e4m3>(lhs, wq, ws, ends, out, R,
                                                   K, N, X, st);
  if (lhs_dtype == 1 && w_dtype == 1)
    return (int)launch_typed<bf16, __nv_fp8_e4m3>(lhs, wq, ws, ends, out, R, K,
                                                  N, X, st);
  return (int)cudaErrorInvalidValue;
}
