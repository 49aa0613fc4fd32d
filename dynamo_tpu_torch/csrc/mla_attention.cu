// Paged LATENT attention for Multi-Latent Attention (DeepSeek), for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * dynamo_tpu/ops/mla_attention_pallas.py::mla_paged_decode_attention
//     (_mla_decode_kernel; with return_stats, the (m, l) statistics the
//     flash merge of mla_decode_attention_merged / mla_verify_attention
//     needs),
//   * dynamo_tpu/ops/mla_attention_pallas.py::mla_paged_prefill_attention
//     (_mla_prefill_kernel: a chunk over history + the already-written
//     chunk, causal at absolute positions).
// The cache holds ONE latent stream per token (c [N, bs, C] and the rotated
// pe [N, bs, R]) shared by all query rows: attention is MQA-shaped. A query
// row (token, head) scores position s as scale * (q_eff . c[s] + q_pe .
// pe[s]), and the VALUES are the latents c themselves; f32 online softmax
// over every kv_pos <= q_pos. Rows that attend nothing (an empty decode
// slot, prefill padding past valid_len) emit o = 0, m = -1e30, l = 0, the
// Pallas kernel's empty row. Widths: any kv_lora_rank C with C % 128 == 0
// and any rope width R >= 1 (the reference engine's gate), as far as a
// row's f32 query and one warp's accumulators (2C + R values) fit a block's
// shared memory (C up to ~28900).
//
// Two bodies, chosen by dtype and width (an explicit dispatch, never a
// fallback after a failure):
//
// 1. bf16 launches whose padded latent row (C + R rounded up to 64) is at
//    most DP_MAX = 768 values and R <= 128 (C <= 640 at any such R; every
//    published MLA width): the tensor-core body, mla_tc_kernel, for both
//    functions. What bounds it on an H100: a prefill chunk is operations
//    (2 * rows * positions * (C + R + C) flops: 22 GFLOP for T = 512 on
//    1000 cached at H = 16, the latents staying in L2); decode is
//    device-memory bytes (each position's C + R latents read once per
//    sequence). The design, an FA2-style tile on mma.sync m16n8k16 built
//    from the GQA bodies' parts (csrc/paged_attention.cu tc_segment_tile,
//    tc_decode_tile):
//    * a block owns a tile of query rows, token-major: 64 rows (4 groups
//      of 16; H = 16 -> 4 tokens) for a prefill chunk and for decode
//      launches with more than 16 rows per sequence (the verify's T * H),
//      16 rows (one group) for a plain decode launch. A sequence with more
//      rows than a tile spans several tiles (272 rows at spec_gamma = 16:
//      5), so any row count works;
//    * the horizon is walked in steps of KVT positions (32 with 64-row
//      tiles, 64 with 16-row tiles). Each step's c | pe rows land ONCE,
//      in bf16, in an XOR-swizzled ring of 2 or 3 stages (16-byte
//      cp.async.cg; the pe tail zero-filled up to a multiple of 16 values,
//      element by element when a pe row is not whole 16-byte chunks), the
//      next steps' copies in flight during this step's products; page
//      slots are looked up a step ahead, one per copying thread;
//    * the f32 O accumulator [rows, C] is split by output column: each
//      row group's WPG warps (2 for 64-row tiles, 8 for 16-row tiles) own
//      C / WPG columns each (C = 512: 256 columns, 128 registers). A C
//      wider than 512 takes a grid dimension of column slabs of at most
//      512; every slab recomputes the scores (at C = 640, 2 slabs of 384
//      and 256: the score work of the chunk is done twice);
//    * S is computed ONCE per row group: each of the group's WPG warps
//      computes S = Q [c|pe]^T for its KVT / WPG positions of the step (Q
//      fragments by ldmatrix from the resident Q tile, K fragments from
//      the ring), scales it into the log2 domain and masks it where the
//      step crosses a row's causal limit; the group exchanges its S tiles
//      through shared memory (f32, one named barrier per group and step),
//      and every warp of the group runs the same online softmax over the
//      whole step, so (m, l) agree across the group with no more traffic;
//    * O += P V with P rounded to bf16 as the A fragment (l sums the f32
//      p) and V fragments by ldmatrix.trans from the SAME stage the K
//      fragments came from: one load serves both products;
//    * prefill tiles run longest horizon first and take no split. Decode
//      tiles split their horizon across blocks only as far as fills the
//      card once (the wrapper's n_split, no host read of seq_lens; on the
//      device a split never takes fewer than min_steps steps, so short
//      sequences use fewer splits and the others exit at once). Each live
//      split writes its normalized partial o (bf16: the output is bf16)
//      and its (m, l) (f32) to scratch; the last block of a (sequence, row
//      tile, slab) to take the ticket (an atomic add after __threadfence)
//      merges them with the flash rule, every split's chunk of a column
//      range loaded before any is summed, and zeroes the ticket for the
//      next launch: one launch, no combine kernel, no host sync. That
//      merge is one block's work (a verify's 64 rows x 512 columns from
//      up to 16 splits: 1 MB) and the largest share of a verify's time; a
//      pairwise merge tree (log2(splits) levels of one partial each) was
//      slower on the card, each level paying a write, a fence and a read.
//
// 2. f32 launches (the tiny f32 models, held token for token to the CPU),
//    and bf16 launches of the widths the tensor-core tiles cannot hold
//    (C >= 768 or R > 128: a 64-row query tile and two stages of whole
//    rows outgrow 227 KB): the CUDA-core body, mla_core_kernel, f32 or bf16
//    loads. One block per query row; each of its warps walks every nw-th
//    position of the row's horizon (warp-wide dot product over C + R, f32
//    online softmax, its C accumulators in shared memory), and the warps
//    merge with the flash rule; any C and R. A block holds as many warps
//    (at most 8) as their C f32 accumulators let into its shared memory
//    beside the row's query. bf16 lanes load 8 latents per 16-byte load.
//    It is a correctness body for widths no published model has: it reads
//    the latents once per query row (L2 serves the repeats), a position
//    per warp step (PERF.md has its times).
//
// float8_e4m3fn latent pages (the scale-free fp8 cache): bf16 queries over
// e4m3 codes, in both bodies, for both functions. The pages carry no
// scale, and a code widens EXACTLY (e4m3 -> f16 -> f32 -> bf16 loses
// nothing), as the reference's XLA path widens them with astype(float32)
// (dynamo_tpu/models/mla.py mla_prefill_attention_xla,
// mla_decode_attention_xla). The tensor-core body stages each step's codes
// in shared memory (16-byte cp.async, half a bf16 step's bytes; the ring
// keeps its bf16 stages, so a 64-row tile at C + R = 576 fills the 227 KB
// with three stages) and the copying thread widens its own chunks into the
// bf16 ring at the top of the step, as csrc/paged_attention.cuh's segment
// tiles do: the products then read bf16 fragments as before. A 16-row
// decode tile whose two stages and codes outgrow a block runs as a 64-row
// tile (the wrapper's plan). The CUDA-core body widens on load. f32 queries
// over fp8 pages are not taken.
//
// Later work: wgmma with TMA page loads and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF, not -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int NW = 8;              // warps per block (both bodies)
constexpr int NT = NW * 32;
constexpr int SLAB = 512;          // most output columns per block
constexpr int DP_MAX = 768;        // widest padded latent row (values)
constexpr int MAX_SPLITS = 16;     // most decode splits (the merge's table)
constexpr int SMEM_MAX = 231424;   // dynamic shared memory a block takes
                                   // (227 KB less 1 KB for the static)

using bf16 = __nv_bfloat16;
using e4m3 = uint8_t;  // a float8_e4m3fn code (the pages' bytes)

struct Params {
  const void* q_eff;    // [rows, C] query rows (token-major, heads inner)
  const void* q_pe;     // [rows, R]
  void* o;              // [rows, C] in the input dtype, or f32 (out_f32)
  float* m_out;         // [rows] or null
  float* l_out;         // [rows] or null
  const void* cc;       // [N, bs, C] latent cache layer (queries' type or e4m3)
  const void* pc;       // [N, bs, R] rope-key cache layer (likewise)
  const int* tables;    // decode: [B, M]; prefill: [M]
  const int* seq_lens;  // decode [B]: row attends kv_pos < seq_len
  const int* hist;      // prefill [1]: tokens cached before the chunk
  const int* valid;     // prefill [1]: real tokens, or null (= T)
  int B;                // decode sequences (0: prefill)
  int T;                // prefill chunk tokens
  int H;                // query rows per token (prefill) / sequence (decode)
  int N, bs, M, C, R;
  float scale;
  int out_f32;
  // the tensor-core body's plan
  int DP;         // padded shared-memory row: C + R rounded up to 64
  int KD;         // score depth: C + R rounded up to 16
  int stages;     // ring stages (2 or 3)
  int slab_w;     // output columns per slab (a multiple of 128)
  int n_slabs;
  int n_rt;       // row tiles per sequence (decode) / of the chunk
  int n_split;    // decode: horizon splits per (sequence, row tile, slab)
  int min_steps;  // decode: least steps per split
  float* part;    // decode partials when n_split > 1
  int* tickets;   // decode: [B, n_rt, n_slabs] split counters, zero
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------- the CUDA-core body (f32, and the widths the tiles cannot hold) -------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
// an e4m3 code, exactly (e4m3 -> f16 -> f32 widen without rounding)
__device__ __forceinline__ float to_f(e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

// two e4m3 codes (the low 16 bits) -> two floats, exactly
__device__ __forceinline__ float2 e4m3x2_f(uint32_t codes) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(codes & 0xffffu), __NV_E4M3)));
}

// 8 consecutive latents of a row as floats: one 16-byte load of bf16, one
// 8-byte load of e4m3 codes
__device__ __forceinline__ void load8(const bf16* src, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 x = __bfloat1622float2(h[u]);
    f[2 * u] = x.x;
    f[2 * u + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const e4m3* src, float (&f)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const uint32_t w[2] = {v.x, v.y};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float2 lo = e4m3x2_f(w[u]), hi = e4m3x2_f(w[u] >> 16);
    f[4 * u] = lo.x;
    f[4 * u + 1] = lo.y;
    f[4 * u + 2] = hi.x;
    f[4 * u + 3] = hi.y;
  }
}

// One block per query row: its scaled query in shared memory, and each of
// its warps walking every nw-th position of the row's horizon with its own
// online softmax and C accumulators in shared memory; the warps' (m, l, o)
// merge at the end with the flash rule. Any width fits. T: the element type
// of the queries, TP that of the pages (T, or e4m3 codes under bf16
// queries); f32 lanes take C elements lane, lane + 32, ..., bf16 and e4m3
// lanes 8 consecutive ones per load (16 and 8 bytes), widened on load.
template <typename T, typename TP>
__global__ void __launch_bounds__(NT) mla_core_kernel(const Params p) {
  extern __shared__ __align__(16) float fsm[];
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr bool kVec = !std::is_same<TP, float>::value;  // 8 per lane
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.C, R = p.R;
  const long long g = blockIdx.x;
  // [C + R] scaled query (rounded up to 4: 16-byte aligned), nw x [C]
  // accumulators, nw (m, l)
  float* qv = fsm;
  float* ov = fsm + ((C + R + 3) & ~3) + (size_t)warp * C;
  float* ml = fsm + ((C + R + 3) & ~3) + (size_t)nw * C;
  int lim;
  const int* table;
  if (p.B > 0) {
    const int b = (int)(g / p.H);
    lim = min(p.seq_lens[b], p.M * p.bs) - 1;  // -1: an empty slot
    table = p.tables + (size_t)b * p.M;
  } else {
    const int t = (int)(g / p.H);
    const int valid = p.valid ? p.valid[0] : p.T;
    lim = t < valid ? min(p.hist[0] + t, p.M * p.bs - 1) : -1;
    table = p.tables;
  }
  const T* qe = static_cast<const T*>(p.q_eff) + g * C;
  const T* qp = static_cast<const T*>(p.q_pe) + g * R;
  for (int k = threadIdx.x; k < C; k += blockDim.x) qv[k] = to_f(qe[k]) * p.scale;
  for (int k = threadIdx.x; k < R; k += blockDim.x)
    qv[C + k] = to_f(qp[k]) * p.scale;
  for (int k = lane; k < C; k += 32) ov[k] = 0.f;
  __syncthreads();
  const TP* cc = static_cast<const TP*>(p.cc);
  const TP* pc = static_cast<const TP*>(p.pc);
  float m = kNegInf, l = 0.f;
  for (int pos = warp; pos <= lim; pos += nw) {
    const long long slot = (long long)table[pos / p.bs] * p.bs + pos % p.bs;
    const TP* cr = cc + slot * C;
    const TP* pr = pc + slot * R;
    float s = 0.f;
    if constexpr (kVec) {
      for (int k = 8 * lane; k < C; k += 256) {
        float f[8];
        load8(cr + k, f);
        const float4 q0 = *reinterpret_cast<const float4*>(qv + k);
        const float4 q1 = *reinterpret_cast<const float4*>(qv + k + 4);
        const float qf[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) s = fmaf(qf[u], f[u], s);
      }
    } else {
      for (int k = lane; k < C; k += 32) s = fmaf(qv[k], to_f(cr[k]), s);
    }
    for (int k = lane; k < R; k += 32) s = fmaf(qv[C + k], to_f(pr[k]), s);
    s = warp_sum(s);
    const float mn = fmaxf(m, s);
    const float alpha = expf(m - mn), pe = expf(s - mn);
    l = l * alpha + pe;
    m = mn;
    if constexpr (kVec) {
      for (int k = 8 * lane; k < C; k += 256) {
        float f[8];
        load8(cr + k, f);
        float4* o4 = reinterpret_cast<float4*>(ov + k);
        float4 a = o4[0], b = o4[1];
        o4[0] = make_float4(fmaf(pe, f[0], a.x * alpha), fmaf(pe, f[1], a.y * alpha),
                            fmaf(pe, f[2], a.z * alpha), fmaf(pe, f[3], a.w * alpha));
        o4[1] = make_float4(fmaf(pe, f[4], b.x * alpha), fmaf(pe, f[5], b.y * alpha),
                            fmaf(pe, f[6], b.z * alpha), fmaf(pe, f[7], b.w * alpha));
      }
    } else {
      for (int k = lane; k < C; k += 32)
        ov[k] = fmaf(pe, to_f(cr[k]), ov[k] * alpha);
    }
  }
  if (lane == 0) {
    ml[2 * warp] = m;
    ml[2 * warp + 1] = l;
  }
  __syncthreads();
  // the flash merge of the warps, in warp order
  float M = kNegInf, L = 0.f;
  for (int w = 0; w < nw; ++w) M = fmaxf(M, ml[2 * w]);
  for (int w = 0; w < nw; ++w) L += ml[2 * w + 1] * expf(ml[2 * w] - M);
  const float inv = 1.f / fmaxf(L, 1e-20f);  // 0 / 1e-20 = 0 when dead
  const float* ov0 = fsm + ((C + R + 3) & ~3);
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += ov0[(size_t)w * C + k] * expf(ml[2 * w] - M);
    if (kBf16 && !p.out_f32)
      static_cast<bf16*>(p.o)[g * C + k] = __float2bfloat16(v * inv);
    else
      static_cast<float*>(p.o)[g * C + k] = v * inv;
  }
  if (p.m_out != nullptr && threadIdx.x == 0) {
    p.m_out[g] = M;
    p.l_out[g] = L;
  }
}

// ---------------- the tensor-core body (bf16 launches) ----------------

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
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
__device__ __forceinline__ void ldsm_x2(unsigned addr, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a group's named barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// of cpr chunks per row (a multiple of 8): the chunk index XOR (row % 8),
// so the 8 rows an ldmatrix reads at one logical chunk hit 8 bank groups
__device__ __forceinline__ int swz(int row, int chunk, int cpr) {
  return (row * cpr + (chunk ^ (row & 7))) * 8;
}

// the shapes of a tensor-core tile: WPG warps per 16-row group, KVT
// positions per step
template <int WPG, int KVT>
struct Tile {
  static constexpr int RG = NW / WPG;        // row groups
  static constexpr int RT = RG * 16;         // query rows per tile
  static constexpr int SPW = KVT / WPG;      // score positions per warp
  static constexpr int NS8 = SPW / 8;        // their n8 tiles
  static constexpr int NC8 = SLAB / WPG / 8; // most output n8 tiles per warp
  static constexpr int TPR = NT / KVT;       // copying threads per kv row
  static constexpr int SXS = KVT + 8;        // S exchange row (floats)
  static_assert(SXS >= 2 * MAX_SPLITS, "the merge's statistics fit the S area");
  static_assert(SPW % 8 == 0 && NC8 % 2 == 0 && NT % KVT == 0, "tiling");
};

// bf16 copy of one 16-byte chunk of a pe row that is not whole 16-byte
// chunks: element loads (widened from e4m3 codes), zeros past R (a
// synchronous shared store)
template <typename TP>
__device__ __forceinline__ void pe_chunk_elems(bf16* dst, const TP* row,
                                               int j0, int R, bool ok) {
  uint4 v;
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if constexpr (std::is_same<TP, bf16>::value)
      e[u] = (ok && j0 + u < R) ? row[j0 + u] : __float2bfloat16(0.f);
    else
      e[u] = __float2bfloat16((ok && j0 + u < R) ? to_f(row[j0 + u]) : 0.f);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// four e4m3 codes (one word) -> four bf16 (two words), exactly
__device__ __forceinline__ uint2 widen4_e4m3(uint32_t codes) {
  const float2 lo = e4m3x2_f(codes), hi = e4m3x2_f(codes >> 16);
  return make_uint2(pack_bf16(lo.x, lo.y), pack_bf16(hi.x, hi.y));
}

// TP: the pages' element type, bf16, or e4m3 codes staged and widened into
// the bf16 ring by the thread that copied them
template <int WPG, int KVT, typename TP>
__global__ void __launch_bounds__(NT, 1) mla_tc_kernel(const Params p) {
  using TL = Tile<WPG, KVT>;
  constexpr int RT = TL::RT, SXS = TL::SXS, NS8 = TL::NS8, NC8 = TL::NC8;
  constexpr int TPR = TL::TPR;
  constexpr bool kFp8 = std::is_same<TP, e4m3>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int DP = p.DP, CPR = DP / 8, KC = p.KD / 8, C8 = p.C / 8;
  const int C = p.C, R = p.R, ST = p.stages;
  bf16* qs = reinterpret_cast<bf16*>(smem);               // [RT][DP]
  bf16* ring = qs + RT * DP;                              // [ST][KVT][DP]
  float* sx = reinterpret_cast<float*>(ring + ST * KVT * DP);  // [RT][SXS]
  // e4m3 pages: the codes of the steps in flight, [ST - 1][KVT][KD] bytes
  // (each thread reads back only the chunks it copied)
  e4m3* stg = reinterpret_cast<e4m3*>(sx + RT * SXS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / WPG, part = warp % WPG;
  const int blk = blockIdx.x;

  // ---- the tile: rows g0 .. g0 + nrows - 1, slab, split, horizon ----
  int z = 0, slab, g0, nrows, last, hist = 0, valid = 0, unit = 0;
  const int* table;
  if (p.B > 0) {
    z = blk % p.n_split;
    int rest = blk / p.n_split;
    slab = rest % p.n_slabs;
    rest /= p.n_slabs;
    const int rt = rest % p.n_rt, b = rest / p.n_rt;
    unit = (b * p.n_rt + rt) * p.n_slabs + slab;
    g0 = b * p.H + rt * RT;
    nrows = min(RT, p.H - rt * RT);
    last = min(p.seq_lens[b], p.M * p.bs) - 1;  // -1: an empty slot
    table = p.tables + (size_t)b * p.M;
  } else {
    slab = blk % p.n_slabs;
    const int tile = p.n_rt - 1 - blk / p.n_slabs;  // longest horizon first
    g0 = tile * RT;
    nrows = min(RT, p.T * p.H - g0);
    hist = p.hist[0];
    valid = p.valid ? min(p.valid[0], p.T) : p.T;
    const int t_first = g0 / p.H, t_last = (g0 + nrows - 1) / p.H;
    last = t_first < valid ? min(hist + min(t_last, valid - 1), p.M * p.bs - 1)
                           : -1;
    table = p.tables;
  }
  const int steps = (last + KVT) / KVT;
  int s_begin = 0, s_end = steps, n_live = 1;
  if (p.B > 0) {
    const int per = max((steps + p.n_split - 1) / p.n_split, p.min_steps);
    n_live = max(1, (steps + per - 1) / per);
    if (z >= n_live) return;  // a split past this sequence's horizon
    s_begin = z * per;
    s_end = min(steps, s_begin + per);
  }
  const int c_end = min(last + 1, s_end * KVT);  // positions of this block

  // this thread's two rows (lane / 4 and lane / 4 + 8 of its group) and
  // their causal limits, clamped to this block's positions
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = grp * 16 + (lane >> 2) + 8 * i;
    int l = -1;
    if (r < nrows) {
      if (p.B > 0) {
        l = last;
      } else {
        const int t = (g0 + r) / p.H;
        l = t < valid ? hist + t : -1;
      }
    }
    lim[i] = min(l, c_end - 1);
  }
  int qmin = min(lim[0], lim[1]), qmax = max(lim[0], lim[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }

  // this warp's output columns: wn of them from wc0 (a multiple of 16)
  const int col0 = slab * p.slab_w;
  const int wc0 = col0 + part * (p.slab_w / WPG);
  const int wn = max(0, min(p.slab_w / WPG, C - wc0));

  const bf16* qe = static_cast<const bf16*>(p.q_eff);
  const bf16* qp = static_cast<const bf16*>(p.q_pe);
  const TP* cc = static_cast<const TP*>(p.cc);
  const TP* pc = static_cast<const TP*>(p.pc);
  const bool pe16 = (R & 7) == 0;  // pe rows are whole 16-byte chunks
  // e4m3 pages: a 16-byte copy carries 16 codes (two bf16 ring chunks);
  // C16 of them per c row, KC1 per padded c | pe row
  const int C16 = C / 16, KC1 = p.KD / 16;
  const bool pe16c = (R & 15) == 0;  // pe code rows are whole copies

  // ---- Q: the tile's rows (zeros past nrows and past C + R) ----
  for (int e = tid; e < RT * KC; e += NT) {
    const int r = e / KC, k = e % KC;
    bf16* dst = qs + swz(r, k, CPR);
    const bool ok = r < nrows;
    const size_t g = (size_t)g0 + r;
    if (k < C8) {
      cp_async16(smem_u32(dst), ok ? qe + g * C + k * 8 : qe, ok ? 16 : 0);
    } else {
      const int j0 = (k - C8) * 8;
      if (pe16)
        cp_async16(smem_u32(dst), ok && j0 < R ? qp + g * R + j0 : qp,
                   ok && j0 < R ? 16 : 0);
      else
        pe_chunk_elems(dst, qp + g * R, j0, R, ok);
    }
  }
  cp_async_commit();

  // ---- the ring: thread -> (row j of the step, chunks kq, kq + TPR, ..),
  // the row's slot looked up a step before its copies ----
  const int j = tid / TPR, kq = tid % TPR;
  int slot = -1;
  auto fetch = [&](int n) {
    const int pos = n * KVT + j;
    slot = pos < c_end ? table[pos / p.bs] * p.bs + pos % p.bs : -1;
  };
  auto copy_step = [&](int n) {
    bf16* st = ring + (n % ST) * KVT * DP;
    const bool ok = slot >= 0;
    const TP* cr = cc + (size_t)(ok ? slot : 0) * C;
    const TP* pr = pc + (size_t)(ok ? slot : 0) * R;
    if constexpr (kFp8) {
      // codes into the staging slot; a pe row that is not whole copies
      // widens element by element straight into the ring (zeros past R)
      e4m3* sg = stg + (size_t)((n % (ST - 1)) * KVT + j) * p.KD;
      for (int k = kq; k < KC1; k += TPR) {
        if (k < C16) {
          cp_async16(smem_u32(sg + k * 16), cr + k * 16, ok ? 16 : 0);
        } else if (pe16c) {
          cp_async16(smem_u32(sg + k * 16), pr + (k - C16) * 16, ok ? 16 : 0);
        } else {
          const int j0 = (k - C16) * 16;
          pe_chunk_elems(st + swz(j, 2 * k, CPR), pr, j0, R, ok);
          pe_chunk_elems(st + swz(j, 2 * k + 1, CPR), pr, j0 + 8, R, ok);
        }
      }
    } else {
      for (int k = kq; k < KC; k += TPR) {
        bf16* dst = st + swz(j, k, CPR);
        if (k < C8) {
          cp_async16(smem_u32(dst), cr + k * 8, ok ? 16 : 0);
        } else {
          const int j0 = (k - C8) * 8;
          if (pe16)
            cp_async16(smem_u32(dst), j0 < R ? pr + j0 : pr,
                       ok && j0 < R ? 16 : 0);
          else
            pe_chunk_elems(dst, pr, j0, R, ok);
        }
      }
    }
  };
  // e4m3 pages: this thread widens the codes it copied for step n into the
  // ring (exact; its copies of step n have landed)
  auto widen = [&](int n) {
    bf16* st = ring + (n % ST) * KVT * DP;
    const e4m3* sg = stg + (size_t)((n % (ST - 1)) * KVT + j) * p.KD;
    const int kc_end = pe16c ? KC1 : C16;
    for (int k = kq; k < kc_end; k += TPR) {
      const uint4 raw = *reinterpret_cast<const uint4*>(sg + k * 16);
      const uint2 w0 = widen4_e4m3(raw.x), w1 = widen4_e4m3(raw.y);
      const uint2 w2 = widen4_e4m3(raw.z), w3 = widen4_e4m3(raw.w);
      *reinterpret_cast<uint4*>(st + swz(j, 2 * k, CPR)) =
          make_uint4(w0.x, w0.y, w1.x, w1.y);
      *reinterpret_cast<uint4*>(st + swz(j, 2 * k + 1, CPR)) =
          make_uint4(w2.x, w2.y, w3.x, w3.y);
    }
  };

  // the first ST - 1 steps in flight, one commit group each (after Q's)
  if (s_begin < s_end) fetch(s_begin);
  for (int i = 0; i < ST - 1; ++i) {
    if (s_begin + i < s_end) copy_step(s_begin + i);
    cp_async_commit();
    if (s_begin + i + 1 < s_end) fetch(s_begin + i + 1);
  }

  float acc[NC8][4];
#pragma unroll
  for (int i = 0; i < NC8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  const float qk_scale = p.scale * kLog2e;
  const float masked_out = __int_as_float(0xff800000);  // -inf
  const int qrow = grp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
  float* sxg = sx + grp * 16 * SXS;  // this group's S rows

  for (int n = s_begin; n < s_end; ++n) {
    if (ST == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    // e4m3 pages: step n's codes into its bf16 stage (last read by step
    // n - ST, which every warp finished before the previous barrier)
    if constexpr (kFp8) widen(n);
    // step n's stage is complete, and every warp is done with step n - 1
    // (whose stage the next copy overwrites, and the S exchange)
    __syncthreads();
    if (n + ST - 1 < s_end) copy_step(n + ST - 1);
    cp_async_commit();
    if (n + ST < s_end) fetch(n + ST);

    const int c = n * KVT;
    if (c > qmax) continue;  // no row of this group reaches this step
    const bf16* kt = ring + (n % ST) * KVT * DP;

    // ---- S = Q [c|pe]^T for this warp's SPW positions of the step ----
    float sacc[NS8][4];
#pragma unroll
    for (int i = 0; i < NS8; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
    const int pbase = part * TL::SPW;
#pragma unroll 4
    for (int kk = 0; kk < KC / 2; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(qs + swz(qrow, kk * 2 + (lane >> 4), CPR)), a);
      if constexpr (NS8 % 2 == 0) {
#pragma unroll
        for (int nn = 0; nn < NS8 / 2; ++nn) {
          uint32_t b[4];
          const int r = pbase + nn * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(smem_u32(kt + swz(r, kk * 2 + ((lane >> 3) & 1), CPR)), b);
          mma_bf16(sacc[2 * nn], a, b[0], b[1]);
          mma_bf16(sacc[2 * nn + 1], a, b[2], b[3]);
        }
      } else {
        uint32_t b[2];
        const int r = pbase + (lane & 7);
        ldsm_x2(smem_u32(kt + swz(r, kk * 2 + ((lane >> 3) & 1), CPR)), b);
        mma_bf16(sacc[0], a, b[0], b[1]);
      }
    }

    // ---- scale (log2 domain), mask where the step crosses a limit, and
    // share with the group ----
    const bool masked = c + KVT - 1 > qmin;
#pragma unroll
    for (int nn = 0; nn < NS8; ++nn) {
      const int col = pbase + nn * 8 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v0 = sacc[nn][2 * i] * qk_scale;
        float v1 = sacc[nn][2 * i + 1] * qk_scale;
        if (masked && c + col > lim[i]) v0 = masked_out;
        if (masked && c + col + 1 > lim[i]) v1 = masked_out;
        *reinterpret_cast<float2*>(sxg + ((lane >> 2) + 8 * i) * SXS + col) =
            make_float2(v0, v1);
      }
    }
    group_sync(1 + grp, WPG * 32);

    // ---- online softmax over the whole step (every warp of the group) ----
    float sf[KVT / 8][4];
#pragma unroll
    for (int nn = 0; nn < KVT / 8; ++nn) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(
            sxg + ((lane >> 2) + 8 * i) * SXS + nn * 8 + 2 * (lane & 3));
        sf[nn][2 * i] = v.x;
        sf[nn][2 * i + 1] = v.y;
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = mrow[i];
#pragma unroll
      for (int nn = 0; nn < KVT / 8; ++nn)
        mx = fmaxf(mx, fmaxf(sf[nn][2 * i], sf[nn][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2f(mrow[i] - mx);
      mrow[i] = mx;
      lrow[i] *= alpha[i];
    }
#pragma unroll
    for (int nn = 0; nn < KVT / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sf[nn][e] - mrow[e >> 1]);
        lrow[e >> 1] += pe;  // l sums the f32 p, before any rounding
        sf[nn][e] = pe;
      }
    }
#pragma unroll
    for (int d = 0; d < NC8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // ---- O += P V: P in bf16 registers, V from the K stage (c part) ----
#pragma unroll
    for (int kk = 0; kk < KVT / 16; ++kk) {
      const float* p0 = sf[2 * kk];
      const float* p1 = sf[2 * kk + 1];
      const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                             pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
      const int r = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dd = 0; dd < NC8 / 2; ++dd) {
        if (dd * 16 < wn) {
          uint32_t b[4];
          ldsm_x4_t(smem_u32(kt + swz(r, wc0 / 8 + dd * 2 + (lane >> 4), CPR)), b);
          mma_bf16(acc[2 * dd], a, b[0], b[1]);
          mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
  }

  // ---- emit: o normalized (0 where nothing is attended) and (m, l); or
  // this split's partial, merged by the last split of the unit ----
  const size_t rows_all = p.B > 0 ? (size_t)p.B * p.H : (size_t)p.T * p.H;
  const bool split = n_live > 1;
  // scratch: (m, l) f32 [n_split][n_slabs][rows_all][2], then the
  // normalized partial o in bf16 [n_split][rows_all][C] (the output is
  // bf16: the merge rounds once more, well inside a bf16 output's error)
  const size_t ml_floats =
      ((size_t)p.n_split * p.n_slabs * rows_all * 2 + 3) & ~(size_t)3;
  bf16* po = split ? reinterpret_cast<bf16*>(p.part + ml_floats) +
                         (size_t)z * rows_all * C
                   : nullptr;
  float* pm = split ? p.part + ((size_t)z * p.n_slabs + slab) * rows_all * 2
                    : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = grp * 16 + (lane >> 2) + 8 * i;
    if (r >= nrows) continue;
    const size_t g = (size_t)g0 + r;
    const bool live = lrow[i] > 0.f;
    const float inv = live ? 1.f / lrow[i] : 0.f;
    const float m_nat = live ? mrow[i] * kLn2 : kNegInf;
    const int cq = wc0 + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < NC8; ++d) {
      if (d * 8 >= wn) continue;
      const float v0 = acc[d][2 * i] * inv, v1 = acc[d][2 * i + 1] * inv;
      const size_t idx = g * C + cq + d * 8;
      if (split) {
        *reinterpret_cast<uint32_t*>(po + idx) = pack_bf16(v0, v1);
      } else if (p.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.o) + idx) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.o) + idx) =
            pack_bf16(v0, v1);
      }
    }
    if (part == 0 && (lane & 3) == 0) {
      if (split) {
        *reinterpret_cast<float2*>(pm + g * 2) =
            make_float2(m_nat, live ? lrow[i] : 0.f);
      } else if (p.m_out != nullptr && slab == 0) {
        p.m_out[g] = m_nat;
        p.l_out[g] = live ? lrow[i] : 0.f;
      }
    }
  }
  if (!split) return;

  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  __shared__ int s_last;
  int* ticket = p.tickets + unit;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the merge. Every (row, split) statistic is loaded at once into the S
  // area, then each row's weights w_z = l_z exp(m_z - M) / L, then the
  // slab's columns, 8 per chunk, every split's chunk of EPT chunks loaded
  // before any is summed (a chain of loads would each wait a round trip)
  float* wts = sx;  // [RT][SXS]: m_z (then w_z) at z, l_z at MAX_SPLITS + z
  for (int e = tid; e < nrows * n_live; e += NT) {
    const int r = e / n_live, zz = e % n_live;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(
        p.part + ((size_t)zz * p.n_slabs + slab) * rows_all * 2 +
        ((size_t)g0 + r) * 2));
    wts[r * SXS + zz] = ml.x;
    wts[r * SXS + MAX_SPLITS + zz] = ml.y;
  }
  __syncthreads();
  if (tid < nrows) {
    float* w = wts + tid * SXS;
    float M = kNegInf, L = 0.f;
    for (int zz = 0; zz < n_live; ++zz) M = fmaxf(M, w[zz]);
    for (int zz = 0; zz < n_live; ++zz) {
      w[zz] = w[MAX_SPLITS + zz] * __expf(w[zz] - M);
      L += w[zz];
    }
    const float iz = 1.f / fmaxf(L, 1e-20f);
    for (int zz = 0; zz < n_live; ++zz) w[zz] *= iz;
    if (p.m_out != nullptr && slab == 0) {
      p.m_out[(size_t)g0 + tid] = M;
      p.l_out[(size_t)g0 + tid] = L;
    }
  }
  __syncthreads();
  const bf16* pb = reinterpret_cast<const bf16*>(p.part + ml_floats);
  const int q8 = min(p.slab_w, C - col0) / 8;
  constexpr int EPT = 2;  // chunks per thread and round
  for (int e0 = tid; e0 < nrows * q8; e0 += NT * EPT) {
    uint4 v[EPT][MAX_SPLITS];
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = e0 + u * NT;
      if (e >= nrows * q8) break;
      const bf16* src = pb + ((size_t)g0 + e / q8) * C + col0 + (e % q8) * 8;
#pragma unroll
      for (int zz = 0; zz < MAX_SPLITS; ++zz)
        if (zz < n_live)
          v[u][zz] = __ldcg(reinterpret_cast<const uint4*>(
              src + (size_t)zz * rows_all * C));
    }
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = e0 + u * NT;
      if (e >= nrows * q8) break;
      const int r = e / q8;
      float sum[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) sum[k] = 0.f;
#pragma unroll
      for (int zz = 0; zz < MAX_SPLITS; ++zz) {
        if (zz >= n_live) break;
        const float w = wts[r * SXS + zz];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[u][zz]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h[k]);
          sum[2 * k] = fmaf(w, f.x, sum[2 * k]);
          sum[2 * k + 1] = fmaf(w, f.y, sum[2 * k + 1]);
        }
      }
      const size_t idx = ((size_t)g0 + r) * C + col0 + (e % q8) * 8;
      if (p.out_f32) {
        float4* d = reinterpret_cast<float4*>(static_cast<float*>(p.o) + idx);
        d[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
        d[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(p.o) + idx) = make_uint4(
            pack_bf16(sum[0], sum[1]), pack_bf16(sum[2], sum[3]),
            pack_bf16(sum[4], sum[5]), pack_bf16(sum[6], sum[7]));
      }
    }
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

// the tensor-core body's shared memory: the Q tile, the ring, the S
// exchange, and with e4m3 pages the codes of the steps in flight
template <int WPG, int KVT, typename TP>
int tc_smem(int DP, int KD, int stages) {
  using TL = Tile<WPG, KVT>;
  return TL::RT * DP * 2 + stages * KVT * DP * 2 + TL::RT * TL::SXS * 4 +
         (std::is_same<TP, e4m3>::value ? (stages - 1) * KVT * KD : 0);
}

template <int WPG, int KVT, typename TP>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  static bool attr_set = false;  // above 48 KB needs the opt-in, once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_tc_kernel<WPG, KVT, TP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return cudaGetLastError();
    attr_set = true;
  }
  const int smem = tc_smem<WPG, KVT, TP>(p.DP, p.KD, p.stages);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const int blocks = p.B > 0 ? p.B * p.n_rt * p.n_slabs * p.n_split
                             : p.n_rt * p.n_slabs;
  mla_tc_kernel<WPG, KVT, TP><<<blocks, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// the CUDA-core body: one block per query row, as many warps (at most NW)
// as their f32 accumulators let into shared memory beside the query
template <typename T, typename TP>
cudaError_t launch_core(const Params& p, size_t rows, cudaStream_t stream) {
  const long long fixed = 4ll * ((p.C + p.R + 3) & ~3);
  const long long per_warp = 4ll * p.C + 8;
  const long long fit = (SMEM_MAX - fixed) / per_warp;
  const int nw = fit < NW ? (int)fit : NW;
  if (nw < 1) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_core_kernel<T, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return cudaGetLastError();
    attr_set = true;
  }
  mla_core_kernel<T, TP>
      <<<(unsigned)rows, nw * 32, fixed + nw * per_warp, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (queries and caches share it), 2 = bfloat16 queries over float8_e4m3fn
// latent pages (scale-free codes, widened exactly); the output is the
// queries' dtype, or float32 with out_f32. f32 queries over e4m3 pages are
// not taken (cudaErrorInvalidValue). Decode: B > 0 sequences of H query
// rows each, tables [B, M], seq_lens [B]. Prefill: B == 0, one chunk of T tokens x H heads, tables
// [M], hist [1], valid [1] or null. C % 128 == 0, R >= 1. Bodies: bf16
// with C + R rounded up to 64 at most 768 and R <= 128 runs the tensor-core
// body; f32, and bf16 at wider latents, the CUDA-core one. The tensor-core
// plan (the Python wrapper's tile_plan; ignored by the CUDA-core body): wpg
// warps per 16-row group (2: 64-row tiles, 32-position steps; 8: 16-row
// tiles, 64-position steps), stages of the ring, slab_w output columns per
// block, n_split decode splits of at least min_steps steps. With n_split >
// 1, ``scratch`` holds n_split * rows * (2 * ceil(C / slab_w) + C / 2) + 4
// floats and ``tickets`` B * ceil(H / rows per tile) * ceil(C / slab_w)
// ints, zero before the launch and zero after it. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int mla_attention_launch(
    const void* q_eff, const void* q_pe, void* o, float* m_out, float* l_out,
    const void* cc, const void* pc, const int* tables, const int* seq_lens,
    const int* hist, const int* valid, int B, int T, int H, int N, int bs,
    int M, int C, int R, float scale, int out_f32, int wpg, int stages,
    int slab_w, int n_split, int min_steps, float* scratch, int* tickets,
    int dtype, void* stream) {
  Params p;
  p.q_eff = q_eff;
  p.q_pe = q_pe;
  p.o = o;
  p.m_out = m_out;
  p.l_out = l_out;
  p.cc = cc;
  p.pc = pc;
  p.tables = tables;
  p.seq_lens = seq_lens;
  p.hist = hist;
  p.valid = valid;
  p.B = B;
  p.T = T;
  p.H = H;
  p.N = N;
  p.bs = bs;
  p.M = M;
  p.C = C;
  p.R = R;
  p.scale = scale;
  p.out_f32 = out_f32;
  const size_t rows = B > 0 ? (size_t)B * H : (size_t)T * H;
  if (rows == 0) return 0;
  if (B == 0 && (hist == nullptr || tables == nullptr))
    return (int)cudaErrorInvalidValue;
  if (C <= 0 || C % 128 != 0 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_core<float, float>(p, rows, st);
  // the page-type dispatch: bf16 pages (1) or e4m3 codes (2), bf16 queries
  if (dtype != 1 && dtype != 2) return (int)cudaErrorInvalidValue;
  const bool fp8 = dtype == 2;
  p.DP = C + (R + 63) / 64 * 64;
  p.KD = C + (R + 15) / 16 * 16;
  // the width dispatch: what the tensor-core tiles cannot hold (C.8)
  if (p.DP > DP_MAX || R > 128)
    return fp8 ? (int)launch_core<bf16, e4m3>(p, rows, st)
               : (int)launch_core<bf16, bf16>(p, rows, st);
  if ((stages != 2 && stages != 3) || slab_w <= 0 ||
      slab_w % 128 != 0 || slab_w > SLAB)
    return (int)cudaErrorInvalidValue;
  p.stages = stages;
  p.slab_w = slab_w;
  p.n_slabs = (C + slab_w - 1) / slab_w;
  p.n_split = B > 0 && n_split > 1 ? n_split : 1;
  p.min_steps = min_steps > 0 ? min_steps : 1;
  p.part = scratch;
  p.tickets = tickets;
  if (p.n_split > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if (p.n_split > 1 && (scratch == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  if (wpg == 2) {
    p.n_rt = B > 0 ? (H + 63) / 64 : (int)((rows + 63) / 64);
    return fp8 ? (int)launch_tc<2, 32, e4m3>(p, st)
               : (int)launch_tc<2, 32, bf16>(p, st);
  }
  if (wpg == 8) {
    p.n_rt = B > 0 ? (H + 15) / 16 : (int)((rows + 15) / 16);
    return fp8 ? (int)launch_tc<8, 64, e4m3>(p, st)
               : (int)launch_tc<8, 64, bf16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
