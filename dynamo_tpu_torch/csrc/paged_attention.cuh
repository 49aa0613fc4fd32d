// Paged attention over the block-table-indirect KV cache, for sm_90a.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * dynamo_tpu/ops/paged_attention_pallas.py::paged_decode_attention
//     (_decode_kernel; with return_stats, the (m, l) softmax statistics),
//   * dynamo_tpu/ops/paged_attention_pallas.py::paged_prefill_attention
//     (_prefill_kernel: a chunk over history + the already-written chunk),
//   * dynamo_tpu/ops/ragged_paged_attention_pallas.py::ragged_mixed_attention
//     (_mixed_kernel: B decode rows + MP prefill segments in one call).
// All three compute the same thing: each query row attends, through its
// sequence's block table, to every cached position kv_pos <= q_pos, with an
// fp32 online softmax. Decode is the ragged case with one token per tile and
// no segments; prefill is the ragged case with no decode rows and one
// segment. Rows that attend nothing (inactive decode slots, dead segments,
// padded rows past p_valids) write o = 0, m = -1e30, l = 0, exactly what the
// TPU kernel emits and what the flash merge in verify_attention relies on.
//
// Three tile bodies, chosen by tile type and dtype (an explicit dispatch,
// not a fallback):
//
// 1. Segment tiles of a bf16 launch (the query bf16, the cache bf16, int8
//    with per-page scales or float8_e4m3fn): the tensor-core body,
//    tc_segment_tile. What
//    bounds it on an H100: operations. Every query row of a chunk's T x G
//    rows per kv head reads the same K/V rows, 4*D flops per position
//    against 4*D bytes of K and V, so the chunk does about T*G/2 flops per
//    byte (T = 512, G = 4: ~1000), above the card's ~295 flops/byte ridge;
//    a tile of 128 rows re-reads its horizon from L2 at ~128 flops per
//    byte. The design, an FA2-style tile on mma.sync for Hopper's shared
//    memory and asynchronous copies:
//    * a block (8 warps) owns TC_ROWS = 128 query rows of one kv head,
//      Tq = 128 / G tokens x all G heads, row r -> (t = r / G, g = r % G);
//      each warp owns 16 rows; the ragged last row group is masked;
//    * the horizon is walked in steps of TC_KV = 64 positions aligned to
//      absolute multiples of 64; each position's row is addressed through
//      the block table (one page id per row per step, fetched a step
//      ahead), so any block size works; when bs divides 64 (bs = 16: a step
//      is 4 whole pages) a row's page and offset within the step are worked
//      out once per tile, not divided out per step;
//    * page rows land with 16-byte cp.async.cg (zero-filled past the
//      horizon) in a 2-stage ring of XOR-swizzled bf16 tiles (dynamic
//      shared memory, 64 KB at D = 128): one barrier per step, the next
//      step's copy in flight during this step's products. int8 and fp8
//      codes land in a staging area and the copying thread widens its own
//      chunks to bf16 in the ring before the step's barrier, both exactly
//      (int8: |code| <= 127, byte permutes and adds, no int-to-float
//      conversion; fp8: e4m3 -> f16 on the card's cvt, then bf16: 4
//      significant bits and an exponent range inside both), so the
//      products see the reference's f32 page values (no scale for fp8);
//    * Q is loaded once per tile into registers (ldmatrix); S = Q K^T with
//      mma.m16n8k16 bf16 -> f32; the softmax scale and log2(e) multiply the
//      f32 accumulator (with int8 pages also the K page scale: each S column
//      is one position of one page) and exp2f takes it; masks apply only on
//      steps that cross a row's causal limit;
//    * O += P V with P rounded to bf16 in registers and reused directly as
//      the A fragment; V fragments by ldmatrix.trans; l sums the f32 p before
//      rounding; with int8 pages the V page scale multiplies p in f32 before
//      the rounding, so no int8 row is rounded through code x scale;
//    * segment blocks come first in the grid, longest horizon first (the
//      last tile of every segment, then the one before), so the last wave
//      is short; they take no horizon split and no combine.
//
// 2. Decode tiles of a bf16 launch (paged_decode_attention's tiles, the
//    verify's T*G rows per kv head, and the decode rows of
//    ragged_mixed_attention): the tensor-core decode body, tc_decode_tile.
//    What bounds it on an H100: device-memory bytes. Every cached K/V row is
//    read once per (tile, kv head), and at one query token per sequence the
//    arithmetic is ~2*G flops per byte, far below the ridge; the kernel has
//    to keep enough bytes in flight. The design:
//    * a block owns one row group of 16 query rows of one (tile, kv head)
//      (G = 4 pads to 16; verify rows of T*G fill them); a tile with more
//      than 16 rows spans several blocks, one per row group, so any number
//      of rows per kv head is taken;
//    * S = Q K^T and O += P V on mma.m16n8k16 with the fragment code of the
//      segment tiles; P rounds to bf16 in registers, l sums the f32 p; with
//      int8 pages the K page scale multiplies S columns and the V page scale
//      folds into p before the rounding. The padded rows cost tensor-core
//      work this kernel has to spare; what it saves is the CUDA-core body's
//      per-position warp-wide dot products and shuffles;
//    * the block's horizon is cut into 8 runs of DKT = 16-position steps,
//      one per warp. Each warp walks its run alone with its own (m, l, O)
//      and its own 3-stage ring of K/V rows in shared memory (16-byte
//      cp.async.cg, zero-filled past the horizon; page ids, and with int8
//      the page scales, fetched a step ahead; int8 and fp8 codes widened,
//      exactly, by the copying lane into one bf16 tile per warp, as in the
//      segment tiles; an fp8 step moves half a bf16 step's bytes, 8 KB at
//      D = 128): no block barrier per step, and 2 steps (16 KB of bf16 at
//      D = 128) in flight per warp, ~128 KB per SM. The warps merge
//      through shared memory with the flash rule;
//    * the 16 query rows land with cp.async while each warp's first page
//      loads are in flight, and are held in registers (ldmatrix);
//    * across blocks the horizon splits only as far as fills the card (the
//      wrapper's n_split: one block per SM, this body's occupancy), and a
//      split never takes fewer than DMIN_STEPS steps of a horizon that has
//      them. The splits merge in the same launch: each writes its
//      normalized partial (o, m, l) to f32 scratch, and the last block of a
//      (tile, kv head, row group) to take the ticket (an atomic add after
//      __threadfence) combines them and zeroes the ticket for the next
//      launch. No second launch, no host sync.
//
// 3. Every tile of an f32 launch (the tiny f32 models, whose greedy tokens
//    must match the CPU's exactly): the CUDA-core body, core_tile. A block
//    owns one (tile, kv head, split, chunk of up to 64 rows) and loops over
//    its share of the horizon in KT-position steps: the step's K/V rows are
//    loaded ONCE into shared memory as fp32 and reused by every query row of
//    the chunk; one warp owns up to RPW rows, a row's score is a warp-wide
//    dot product. Every tile's horizon is split into n_split parts
//    (flash-decoding) and combine_splits_kernel merges the partials in a
//    second launch. With int8 pages each row is widened and multiplied by
//    its page's scale as it lands; fp8 pages are widened (exact) alone.
//
// Two options of the TPU kernels hold for all three bodies:
//
// * A sliding window (Params::window > 0): row r keeps q_pos - kv_pos <
//   window (paged_attention_pallas.py:391, ragged_paged_attention_pallas.py
//   :176). A tile's walk STARTS at its lowest row's floor, aligned down to
//   the body's step, so pages wholly below it are never read (a decode at
//   2048 cached tokens with window 128 reads ~9 pages, not 128); the score
//   mask fires on the steps that hold a row's floor as on those that cross
//   its causal limit. A segment tile's floor is its first token's
//   (q0 - window + 1); a decode row's is seq_len + q_off - window, plus
//   r / group for the verify's packed rows (row r of a kv head is in-flight
//   token r / group), so a row group's first row has the lowest floor. The
//   decode body cuts [floor, seq_len) into its splits and warp runs, not
//   [0, seq_len). Rows the window leaves empty write o = 0, m = -1e30,
//   l = 0. With a window every segment tile's horizon is at most
//   window + Tq - 1, so the longest-horizon-first order stays a
//   non-increasing one. A bf16 launch with a window runs its own
//   instantiation of the tensor-core kernel (kWin), so an unwindowed
//   launch keeps the registers and instruction schedule it had: the
//   floors checked at run time slowed the unwindowed segment tiles.
// * Attention sinks (Params::sinks, [Hkv * Gq] f32, gpt-oss): each head's
//   sink logit s joins the normalizer at the emit, with no value row:
//   m_f = max(m, s), l' = l e^(m - m_f) + e^(s - m_f), o' = o l e^(m - m_f)
//   / l' (paged_attention_pallas.py:408-424). The row's head is its index
//   modulo Hkv * Gq. A launch that emits (m, l) takes no sinks: the decode
//   merge folds them beside the in-flight tokens (ops/attention.py).
//
// Head widths: D = 64, 128, 192 and 256 (Gemma-3's 256; the TPU kernels
// take any D % 64 == 0, ROADMAP B.7 holds the rest). Each width is its own
// instantiation of every body; paged_attention.cu builds 64 and 128,
// paged_attention_wide.cu 192 and 256, so the two build in parallel. Above
// 128 the tensor-core bodies change in two ways, both compile-time:
// * Q stays in shared memory (kQs): each step reads its A fragments with
//   ldmatrix where the narrower widths hold them in registers, since at D =
//   256 a thread's O fragments alone take 128 registers. The segment body
//   gives Q its own region past the ring (64 KB at D = 256: 192 KB in all
//   over bf16 pages, 225 KB over 1-byte pages);
// * the decode body walks with 4 warps, not 8 (dec_warps): 8 warps of
//   3-stage rings need 392 KB at D = 256. Each warp's ring is twice as
//   wide, so the block keeps the same bytes in flight as at D = 128 (4
//   warps x 2 steps x 16 KB = 128 KB) and fits (200 KB; 170 KB over 1-byte
//   pages). The other 4 warps wait through the walk and share the merge.
// A row of 192 is 24 16-byte chunks, so a step's copies go to the threads
// as a flat list (copy e -> row e / chunks, chunk e % chunks) rather than
// a fixed chunk per thread; swz keeps each 8-chunk group conflict-free.
//
// Later work: wgmma with TMA page loads and warp specialisation for the
// segment tiles; TMA bulk page copies for the decode body, which stays well
// above its bytes bound (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF, not -inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int KT = 16;             // CUDA-core body: kv positions per step
constexpr int NW = 8;              // warps per block (both bodies)
constexpr int RPW = 8;             // CUDA-core body: query rows per warp
constexpr int TC_ROWS = NW * 16;   // tensor-core body: query rows per tile
constexpr int TC_KV = 64;          // tensor-core body: kv positions per step
constexpr int TC_STAGES = 2;       // tensor-core body: steps in the ring
constexpr int DROWS = 16;          // decode body: query rows per block
constexpr int DKT = 16;            // decode body: kv positions per warp step
constexpr int DST = 3;             // decode body: steps in a warp's ring
constexpr int DMIN_STEPS = 8;      // decode body: least steps per split

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;     // [Ntok, Hkv, Gq, D]
  void* o;           // [Ntok, Hkv, Gq, D]
  float* m_out;      // [Ntok, Hkv, Gq] or null
  float* l_out;      // [Ntok, Hkv, Gq] or null
  const void* kc;    // [Hkv, N, bs, D]
  const void* vc;    // [Hkv, N, bs, D]
  const float* k_scales;  // [N] per-page K scales (int8 cache) or null
  const float* v_scales;  // [N] per-page V scales (int8 cache) or null
  const int* d_tables;    // [B, M]
  const int* d_seq_lens;  // [B]: decode row b attends kv_pos < seq_len
  int B;
  const int* p_tables;  // [MP, M]
  const int* p_hists;   // [MP]: tokens cached before each segment
  const int* p_valids;  // [MP] real tokens per segment, or null (= T)
  int MP, T, Tq, nT;
  int Hkv, Gq, N, bs, M;
  float scale;
  int n_split;     // horizon splits per split tile
  size_t R_part;   // rows the partials cover (the split tiles' rows first)
  int n_seg_blocks;  // tensor-core launch: segment blocks before decode ones
  float* part_o;   // [n_split, R_part, D] f32 partials when n_split > 1
  float* part_m;   // [n_split, R_part]
  float* part_l;   // [n_split, R_part]
  int* tickets;    // decode body: [B, Hkv, row groups] split counters, zero
  int window;      // sliding window (0 = full): keep q_pos - kv_pos < window
  int q_off;       // decode rows: query position seq_len - 1 + q_off ...
  int group;       // ... + r / group when group > 0 (the verify's rows)
  const float* sinks;  // [Hkv * Gq] per-head sink logits, or null
};

// the lowest position decode row r (of its kv head's Gq rows) keeps under a
// window: the query sits at seq_len - 1 + q_off (+ r / group)
__device__ __forceinline__ int decode_floor(const Params& p, int seq_len,
                                            int r) {
  return seq_len + p.q_off - p.window + (p.group > 0 ? r / p.group : 0);
}

// the factor that turns a row's unnormalized sum into its output: 1 / l,
// or with a sink logit s (natural units) e^(m - m_f) / (l e^(m - m_f) +
// e^(s - m_f)), m_f = max(m, s); 0 for a row that attends nothing
__device__ __forceinline__ float emit_scale(const Params& p, size_t row,
                                            float m, float l) {
  if (p.sinks == nullptr) return l > 0.f ? 1.f / l : 0.f;
  const float s = p.sinks[row % ((size_t)p.Hkv * p.Gq)];
  const float mf = fmaxf(m, s);
  const float a = __expf(m - mf);
  return a / (l * a + __expf(s - mf));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);  // exact
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL consecutive floats of a shared-memory row, as vector loads (16-byte
// ones where DPL is a multiple of 4, else 8-byte ones: D = 192 gives each
// lane 6 floats at 24-byte offsets).
template <int DPL>
__device__ __forceinline__ void load_lane(const float* p, float (&out)[DPL]) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int k = 0; k < DPL; k += 4) {
      float4 v = *reinterpret_cast<const float4*>(p + k);
      out[k] = v.x; out[k + 1] = v.y; out[k + 2] = v.z; out[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < DPL; k += 2) {
      float2 v = *reinterpret_cast<const float2*>(p + k);
      out[k] = v.x; out[k + 1] = v.y;
    }
  }
}

// ---------------- the CUDA-core body ----------------

// One (tile s, kv head h, split z, rows rbase .. rbase + NW * RPW - 1) on
// CUDA cores. T: the q/o type; TC: the cache type (T itself, or int8_t with
// per-page scales). Tiles s < B are decode rows (more than NW * RPW of them
// span several blocks); the others are Tq-token slices of the segments.
template <typename T, typename TC, int D>
__device__ __forceinline__ void core_tile(const Params& p, const int s,
                                          const int h, const int z,
                                          const int rbase) {
  constexpr int DPL = D / 32;
  constexpr bool kScaled = std::is_same<TC, int8_t>::value;
  constexpr bool kByte = sizeof(TC) == 1;  // int8 or fp8 codes
  // elements per load: 16 bytes of bf16/f32, 8 bytes of int8 / fp8
  constexpr int VEC = kByte ? 8 : 16 / sizeof(TC);
  using Load = typename std::conditional<kByte, uint2, uint4>::type;
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];
  __shared__ long long row_base[KT];  // element offset of a position's row
  __shared__ float row_ks[KT], row_vs[KT];  // its page's scales (int8 cache)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // ---- tile metadata (the ragged wrapper's tile_seq / tile_q0 /
  // tile_last, derived per block: decode tiles first, then segment-major
  // Tq-token slices of every segment) ----
  int tok0, ntok, q0, real;
  const int* table;
  if (s < p.B) {
    tok0 = s;
    ntok = 1;
    q0 = p.d_seq_lens[s] - 1;  // -1 for an inactive slot
    real = q0 >= 0 ? 1 : 0;
    table = p.d_tables + (size_t)s * p.M;
  } else {
    const int t = s - p.B;
    const int m = t / p.nT;
    const int j = t % p.nT;
    tok0 = p.B + m * p.T + j * p.Tq;
    ntok = min(p.Tq, p.T - j * p.Tq);
    q0 = p.p_hists[m] + j * p.Tq;
    const int valid = p.p_valids ? p.p_valids[m] : p.T;
    real = max(0, min(valid - j * p.Tq, ntok));
    table = p.p_tables + (size_t)m * p.M;
  }
  const int last = real > 0 ? q0 + real - 1 : -1;  // causal horizon
  const int rows = ntok * p.Gq;
  const int real_rows = real * p.Gq;
  const bool dec = s < p.B;

  const T* q = static_cast<const T*>(p.q);
  const TC* kc = static_cast<const TC*>(p.kc);
  const TC* vc = static_cast<const TC*>(p.vc);

  float qr[RPW][DPL], acc[RPW][DPL], mr[RPW], lr[RPW];
  int qpos[RPW], qlo[RPW];  // each row's causal limit and window floor
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = rbase + warp + i * NW;
    mr[i] = kNegInf;
    lr[i] = 0.f;
    qpos[i] = -1;  // never attends: padded / unreal rows
    qlo[i] = 0;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      acc[i][d] = 0.f;
      qr[i][d] = 0.f;
    }
    if (r < real_rows) {
      const int t = r / p.Gq, g = r % p.Gq;
      qpos[i] = q0 + t;
      if (p.window > 0)
        qlo[i] = dec ? decode_floor(p, q0 + 1, r) : qpos[i] - p.window + 1;
      const T* qp =
          q + (((size_t)(tok0 + t) * p.Hkv + h) * p.Gq + g) * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) qr[i][d] = to_f(qp[d]) * p.scale;
    }
  }

  // this split's share of the horizon [lo, last] in whole KT steps, lo the
  // block's lowest row's window floor (its first row's)
  const int lo =
      p.window > 0
          ? max(0, dec ? decode_floor(p, q0 + 1, rbase) : q0 - p.window + 1)
          : 0;
  const int s0 = lo / KT;
  const int steps = last >= lo ? last / KT + 1 - s0 : 0;
  const int per = (steps + p.n_split - 1) / p.n_split;
  const int c_begin = (s0 + z * per) * KT;
  const int c_end = min(last + 1, (s0 + (z + 1) * per) * KT);
  // clamp each row's causal limit to the end of this split
#pragma unroll
  for (int i = 0; i < RPW; ++i) qpos[i] = min(qpos[i], c_end - 1);

  for (int c = c_begin; c < c_end; c += KT) {
    // ---- one step of KT positions: K/V rows into shared memory ----
    if (threadIdx.x < KT) {
      const int pos = c + threadIdx.x;
      const int page = pos < c_end ? table[pos / p.bs] : 0;
      row_base[threadIdx.x] =
          pos < c_end ? (((long long)h * p.N + page) * p.bs + pos % p.bs) * D
                      : -1;
      if constexpr (kScaled) {
        row_ks[threadIdx.x] = p.k_scales[page];
        row_vs[threadIdx.x] = p.v_scales[page];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x * VEC; e < KT * D; e += NW * 32 * VEC) {
      const int j = e / D, d = e % D;
      const long long base = row_base[j];
      float kv[VEC], vv[VEC];
      if (base >= 0) {
        const Load kraw = *reinterpret_cast<const Load*>(kc + base + d);
        const Load vraw = *reinterpret_cast<const Load*>(vc + base + d);
        const TC* kt = reinterpret_cast<const TC*>(&kraw);
        const TC* vt = reinterpret_cast<const TC*>(&vraw);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          kv[u] = to_f(kt[u]);
          vv[u] = to_f(vt[u]);
        }
        if constexpr (kScaled) {  // per-page dequant as the row lands
          const float sk = row_ks[j], sv = row_vs[j];
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            kv[u] *= sk;
            vv[u] *= sv;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < VEC; ++u) kv[u] = vv[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VEC; u += 4) {
        *reinterpret_cast<float4*>(&ks[j][d + u]) =
            make_float4(kv[u], kv[u + 1], kv[u + 2], kv[u + 3]);
        *reinterpret_cast<float4*>(&vs[j][d + u]) =
            make_float4(vv[u], vv[u + 1], vv[u + 2], vv[u + 3]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      // uniform across the warp: does the row keep a position of this step?
      if (max(c, qlo[i]) > min(c + KT - 1, qpos[i])) continue;
      float sc[KT];
      float mx = mr[i];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float kv[DPL];
        load_lane<DPL>(&ks[j][lane * DPL], kv);
        float part = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) part = fmaf(qr[i][d], kv[d], part);
        part = warp_sum(part);
        sc[j] = (c + j <= qpos[i] && c + j >= qlo[i]) ? part : kNegInf;
        mx = fmaxf(mx, sc[j]);
      }
      // the row keeps a position of this step, so mx is a real score
      const float alpha = __expf(mr[i] - mx);
      float lsum = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float pj = __expf(sc[j] - mx);
        lsum += pj;
        float vv[DPL];
        load_lane<DPL>(&vs[j][lane * DPL], vv);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(pj, vv[d], acc[i][d]);
      }
      lr[i] = lr[i] * alpha + lsum;
      mr[i] = mx;
    }
    __syncthreads();
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = rbase + warp + i * NW;
    if (r >= rows) continue;
    const int t = r / p.Gq, g = r % p.Gq;
    const size_t row = ((size_t)(tok0 + t) * p.Hkv + h) * p.Gq + g;
    if (p.n_split > 1) {  // normalized partial for the combine kernel
      const size_t prow = (size_t)z * p.R_part + row;
      const float inv = 1.f / fmaxf(lr[i], 1e-20f);
      float* op = p.part_o + prow * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) op[d] = acc[i][d] * inv;
      if (lane == 0) {
        p.part_m[prow] = mr[i];
        p.part_l[prow] = lr[i];
      }
      continue;
    }
    const float inv = emit_scale(p, row, mr[i], lr[i]);
    T* op = o + row * D + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) op[d] = from_f<T>(acc[i][d] * inv);
    if (p.m_out != nullptr && lane == 0) {
      p.m_out[row] = mr[i];
      p.l_out[row] = lr[i];
    }
  }
}

// Every tile on CUDA cores: grid (B x rchunks decode pieces + segment
// tiles, Hkv, n_split), every tile split.
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(NW * 32)
paged_attention_kernel(const Params p) {
  const int rchunks = (p.Gq + NW * RPW - 1) / (NW * RPW);
  const int bx = blockIdx.x;
  if (bx < p.B * rchunks)
    core_tile<T, TC, D>(p, bx / rchunks, blockIdx.y, blockIdx.z,
                        (bx % rchunks) * NW * RPW);
  else
    core_tile<T, TC, D>(p, bx - p.B * rchunks + p.B, blockIdx.y, blockIdx.z, 0);
}

// ---------------- the tensor-core body ----------------

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

// four int8 codes (one word) -> four bf16, exact (|code| <= 127): each
// code + 128 goes into the low mantissa byte of 2^23 (full-rate byte
// permutes and adds, no int-to-float conversion), and an integer below 2^8
// in f32 is its bf16 in the top 16 bits
__device__ __forceinline__ uint2 widen4(uint32_t codes) {
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

// four float8_e4m3fn codes (one word) -> four bf16, exact: e4m3 holds 4
// significant bits and exponents inside f16's, so the card's e4m3x2 -> f16x2
// conversion (cvt.rn.f16x2.e4m3x2) and f16 -> f32 -> bf16 lose nothing
__device__ __forceinline__ uint2 widen4_e4m3(uint32_t codes) {
  const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(codes & 0xffffu), __NV_E4M3)));
  const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(codes >> 16), __NV_E4M3)));
  return make_uint2(pack_bf16(lo.x, lo.y), pack_bf16(hi.x, hi.y));
}

// four 1-byte page codes -> four bf16 (int8 codes without their scale)
template <typename TC>
__device__ __forceinline__ uint2 widen_codes(uint32_t codes) {
  if constexpr (std::is_same<TC, int8_t>::value)
    return widen4(codes);
  else
    return widen4_e4m3(codes);
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// with D / 8 chunks per row: the chunk index XOR (row % 8), so the 8 rows
// an ldmatrix reads at one logical chunk hit 8 different bank groups
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return (row * (D / 8) + (chunk ^ (row & 7))) * 8;
}

// the largest dynamic shared memory a block can opt into on sm_90
constexpr int kMaxSmem = 232448;

// Q held in shared memory, not registers, by both tensor-core bodies
template <int D>
__host__ __device__ constexpr bool q_in_smem() {
  return D > 128;
}

// dynamic shared memory of a tensor-core segment block: the K/V ring
// (bf16), then with 1-byte pages (int8, fp8) the code staging of the steps
// in flight and the ring's page scales (read with int8 pages only)
template <typename TC, int D>
__host__ __device__ constexpr int tc_ring_bytes() {
  return TC_STAGES * 2 * TC_KV * D * 2 +
         (sizeof(TC) == 1
              ? (TC_STAGES - 1) * 2 * TC_KV * D + TC_STAGES * 2 * TC_KV * 4
              : 0);
}
// ... then, where Q stays in shared memory, its own TC_ROWS x D region
// (narrower widths stage Q through the ring's last stage)
template <typename TC, int D>
__host__ __device__ constexpr int tc_smem_bytes() {
  return tc_ring_bytes<TC, D>() + (q_in_smem<D>() ? TC_ROWS * D * 2 : 0);
}

// One segment tile (TC_ROWS query rows of one kv head) on the tensor cores.
// blk: this block's index among the segment blocks. kWin: the launch has a
// window (its own instantiation: the floors' masks and skips cost the
// unwindowed tiles nothing)
template <typename TC, int D, bool kWin>
__device__ __forceinline__ void tc_segment_tile(const Params& p, const int blk,
                                                unsigned char* smem) {
  constexpr bool kScaled = std::is_same<TC, int8_t>::value;
  constexpr bool kByte = sizeof(TC) == 1;   // int8 or fp8 codes, staged
  constexpr bool kQs = q_in_smem<D>();      // Q read from shared memory
  constexpr int NT = NW * 32;
  constexpr int CPR = D / 8;                // bf16 chunks per tile row
  constexpr int EB = (int)sizeof(TC);       // cache bytes per element
  constexpr int LCPR = D * EB / 16;         // 16-byte copies per cache row
  constexpr int U = TC_KV * LCPR / NT;      // copies per thread per K tile
  // every copy of a thread lands in the same chunk of its rows (no D = 192)
  constexpr bool kEven = NT % LCPR == 0;
  constexpr int TILE = TC_KV * D;           // elements of one K or V tile
  static_assert(TC_KV * LCPR % NT == 0, "copy split");
  static_assert(TC_ROWS * D == 2 * TILE, "Q staging fits one stage");
  static_assert(tc_smem_bytes<TC, D>() <= kMaxSmem, "segment block fits");

  constexpr int S = TC_STAGES;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [stage][K|V][TC_KV][D]
  int8_t* codes =  // [step in flight][K|V][TC_KV][D] int8
      reinterpret_cast<int8_t*>(smem + S * 2 * TILE * 2);
  float* pscl = reinterpret_cast<float*>(  // [stage][K|V][TC_KV]
      smem + S * 2 * TILE * 2 + (S - 1) * 2 * TILE);

  const int h = blk % p.Hkv;
  const int item = blk / p.Hkv;
  const int m = item % p.MP;
  const int j = p.nT - 1 - item / p.MP;  // longest horizon first
  const int G = p.Gq;
  const int tok0 = p.B + m * p.T + j * p.Tq;
  const int ntok = min(p.Tq, p.T - j * p.Tq);
  const int q0 = p.p_hists[m] + j * p.Tq;
  const int valid = p.p_valids ? p.p_valids[m] : p.T;
  const int real = max(0, min(valid - j * p.Tq, ntok));
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  bf16* o = static_cast<bf16*>(p.o);

  if (real == 0) {  // a dead tile: zeros, m = -1e30, l = 0
    for (int e = tid; e < ntok * G * CPR; e += NT) {
      const int r = e / CPR, t = r / G, g = r % G;
      const size_t row = ((size_t)(tok0 + t) * p.Hkv + h) * G + g;
      reinterpret_cast<uint4*>(o + row * D)[e % CPR] = make_uint4(0, 0, 0, 0);
      if (p.m_out != nullptr && e % CPR == 0) {
        p.m_out[row] = kNegInf;
        p.l_out[row] = 0.f;
      }
    }
    return;
  }
  const int last = q0 + real - 1;  // the tile's causal horizon
  // the walk starts at the step that holds the first token's window floor
  const int sf = kWin ? max(0, q0 - p.window + 1) / TC_KV : 0;
  const int nsteps = last / TC_KV + 1 - sf;
  const int lim = min(last + 1, p.M * p.bs);  // positions loaded
  const int* table = p.p_tables + (size_t)m * p.M;
  const TC* kc = static_cast<const TC*>(p.kc);
  const TC* vc = static_cast<const TC*>(p.vc);

  // this thread's two rows (lane / 4 and lane / 4 + 8 of its warp's 16)
  const int live_rows = real * G;
  // causal limits and window floors (a row's floor is its limit - window
  // + 1). Wider rows hold no floors: they test limit - position >= window
  // (at D = 256 the windowed body needs every register)
  constexpr bool kFloors = kWin && !kQs;
  int qpos[2], qlo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + i * 8;
    qpos[i] = r < live_rows ? q0 + r / G : -1;
    qlo[i] = kFloors ? qpos[i] - p.window + 1 : 0;
  }
  const int w0 = warp * 16;
  const int qmin = q0 + w0 / G;  // the warp's first row's limit
  const int qmax = w0 < live_rows ? q0 + min(w0 + 15, live_rows - 1) / G : -1;
  // the warp's lowest and highest window floors (its first and last rows')
  const int flo = kFloors ? qmin - p.window + 1 : 0;
  const int fhi = kFloors ? qmax - p.window + 1 : 0;

  // ---- Q: staged through the ring's last stage, then held in registers;
  // wider rows keep it in a region of its own and read it every step ----
  bf16* qs = kQs ? reinterpret_cast<bf16*>(smem + tc_ring_bytes<TC, D>())
                 : ring + (S - 1) * 2 * TILE;
  {
    const bf16* q = static_cast<const bf16*>(p.q);
    for (int e = tid; e < TC_ROWS * CPR; e += NT) {
      const int r = e / CPR, c = e % CPR, t = r / G, g = r % G;
      const bool ok = r < live_rows;
      const bf16* src =
          ok ? q + (((size_t)(tok0 + t) * p.Hkv + h) * G + g) * D + c * 8 : q;
      cp_async16(smem_u32(qs + swz<D>(r, c)), src, ok ? 16 : 0);
    }
    cp_async_commit();
  }

  // ---- the K/V ring: page ids fetched a step before their copies ----
  // copy u of this thread: the 16-byte chunk ccol(u) of tile row crow(u)
  // (the step's copies listed row-major; with kEven a thread keeps one
  // chunk and steps NT / LCPR rows)
  auto crow = [&](int u) {
    return kEven ? tid / LCPR + u * (NT / LCPR) : (tid + u * NT) / LCPR;
  };
  auto ccol = [&](int u) {
    return kEven ? tid % LCPR : (tid + u * NT) % LCPR;
  };
  // when bs divides a step (bs = 16: 4 whole pages; a power of two), a
  // row's page within the step and its offset in the page are the same
  // every step: held per copy up to D = 128, a shift and a mask of the
  // row above it (no registers of their own)
  const bool aligned = TC_KV % p.bs == 0;
  const int step_pages = aligned ? TC_KV / p.bs : 0;
  const int bs_shift = __ffs(p.bs) - 1;
  int rpage[kQs ? 1 : U], roff[kQs ? 1 : U];
  if constexpr (!kQs) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rpage[u] = crow(u) / p.bs;
      roff[u] = crow(u) % p.bs;
    }
  }
  const TC* kch = kc + (size_t)h * p.N * p.bs * D;
  const TC* vch = vc + (size_t)h * p.N * p.bs * D;
  int pg[U];
  float psk[U], psv[U];
  // step i of the walk is the horizon's step sf + i; stage i % S
  auto fetch = [&](int i) {
    const int step = sf + i;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = step * TC_KV + crow(u);
      const int idx =
          aligned ? step * step_pages +
                        (kQs ? crow(u) >> bs_shift : rpage[kQs ? 0 : u])
                  : pos / p.bs;
      pg[u] = pos < lim ? table[idx] : -1;
      if constexpr (kScaled) {
        if (ccol(u) == 0) {
          psk[u] = pg[u] >= 0 ? p.k_scales[pg[u]] : 0.f;
          psv[u] = pg[u] >= 0 ? p.v_scales[pg[u]] : 0.f;
        }
      }
    }
  };
  auto copy_step = [&](int i) {
    const int st = i % S;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = crow(u), cc = ccol(u);
      const int off_in_page =
          aligned ? (kQs ? row & (p.bs - 1) : roff[kQs ? 0 : u])
                  : ((sf + i) * TC_KV + row) % p.bs;
      const bool ok = pg[u] >= 0;
      const size_t off =
          ok ? ((size_t)pg[u] * p.bs + off_in_page) * D + cc * (16 / EB) : 0;
      if constexpr (kByte) {
        int8_t* ct = codes + (i % (S - 1)) * 2 * TILE + row * D + cc * 16;
        cp_async16(smem_u32(ct), kch + off, ok ? 16 : 0);
        cp_async16(smem_u32(ct + TILE), vch + off, ok ? 16 : 0);
        if (kScaled && cc == 0) {
          pscl[(st * 2) * TC_KV + row] = psk[u];
          pscl[(st * 2 + 1) * TC_KV + row] = psv[u];
        }
      } else {
        bf16* kt = ring + st * 2 * TILE;
        cp_async16(smem_u32(kt + swz<D>(row, cc)), kch + off, ok ? 16 : 0);
        cp_async16(smem_u32(kt + TILE + swz<D>(row, cc)), vch + off,
                   ok ? 16 : 0);
      }
    }
  };
  // 1-byte codes: the copying thread widens its own chunks into the ring
  // (exact; int8 codes without their scale)
  auto widen = [&](int i) {
    const int st = i % S;
    bf16* kt = ring + st * 2 * TILE;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = crow(u), cc = ccol(u);
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            codes + ((i % (S - 1)) * 2 + kv) * TILE + row * D + cc * 16);
        const uint2 w0 = widen_codes<TC>(raw.x), w1 = widen_codes<TC>(raw.y);
        const uint2 w2 = widen_codes<TC>(raw.z), w3 = widen_codes<TC>(raw.w);
        bf16* dst = kt + kv * TILE;
        *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * cc)) =
            make_uint4(w0.x, w0.y, w1.x, w1.y);
        *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * cc + 1)) =
            make_uint4(w2.x, w2.y, w3.x, w3.y);
      }
    }
  };

  // the first S - 1 steps in flight, one commit group each (after Q's)
  fetch(0);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nsteps) copy_step(i);
    cp_async_commit();
    if (i + 1 < nsteps) fetch(i + 1);
  }

  uint32_t qf[kQs ? 1 : D / 16][4];
  const int qrow = w0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  cp_async_wait<S - 1>();  // Q landed (the steps may still be in flight)
  __syncthreads();
  if constexpr (!kQs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(smem_u32(qs + swz<D>(qrow, kk * 2 + (lane >> 4))), qf[kk]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  const float qk_scale = p.scale * kLog2e;
  const float masked_out = __int_as_float(0xff800000);  // -inf

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<S - 2>();  // this thread's copies of step s landed
    if constexpr (kByte) widen(s);
    // the step's tiles are complete, and every warp is done with step s-1
    // (whose stage the next copy overwrites; the first time, Q's)
    __syncthreads();
    if (s + S - 1 < nsteps) copy_step(s + S - 1);
    cp_async_commit();
    if (s + S < nsteps) fetch(s + S);

    const int c = (sf + s) * TC_KV;
    // no row of this warp keeps a position of this step
    if (c > qmax || (kWin && (kQs ? qmin - (c + TC_KV - 1) >= p.window
                                  : c + TC_KV - 1 < flo)))
      continue;
    const bf16* kt = ring + (s % S) * 2 * TILE;
    const bf16* vt = kt + TILE;
    const float* ksc = pscl + (s % S) * 2 * TC_KV;
    const float* vsc = ksc + TC_KV;

    // ---- S = Q K^T: 16 rows x 64 positions per warp ----
    float sacc[TC_KV / 8][4];
#pragma unroll
    for (int n = 0; n < TC_KV / 8; ++n)
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQs) {
        ldsm_x4(smem_u32(qs + swz<D>(qrow, kk * 2 + (lane >> 4))), a);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      }
#pragma unroll
      for (int nn = 0; nn < TC_KV / 16; ++nn) {
        uint32_t b[4];
        const int r = nn * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_u32(kt + swz<D>(r, kk * 2 + ((lane >> 3) & 1))), b);
        mma_bf16(sacc[2 * nn], a, b[0], b[1]);
        mma_bf16(sacc[2 * nn + 1], a, b[2], b[3]);
      }
    }

    // ---- scale (log2 domain), mask where the step crosses a limit or
    // holds a window floor ----
    const bool masked =
        c + TC_KV - 1 > qmin ||
        (kWin && (kQs ? qmax - c >= p.window : c < fhi));
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int n = 0; n < TC_KV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + e;
        float f = qk_scale;
        if constexpr (kScaled) f *= ksc[col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = sacc[n][2 * i + e] * f;
          if (masked && (c + col > qpos[i] ||
                         (kWin && (kQs ? qpos[i] - (c + col) >= p.window
                                       : c + col < qlo[i]))))
            v = masked_out;
          sacc[n][2 * i + e] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(mrow[i] - mx[i]);
      mrow[i] = mx[i];
      lrow[i] *= alpha[i];
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < TC_KV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sacc[n][e] - mrow[e >> 1]);
        lrow[e >> 1] += pe;  // l sums the f32 p, before any rounding
        sacc[n][e] = pe;
      }
    }

    // ---- O += P V: P rounded to bf16 in registers (A fragments) ----
#pragma unroll
    for (int kk = 0; kk < TC_KV / 16; ++kk) {
      float v0 = 1.f, v1 = 1.f, v2 = 1.f, v3 = 1.f;
      if constexpr (kScaled) {  // V page scales fold into p, in f32
        const int col = kk * 16 + 2 * (lane & 3);
        v0 = vsc[col];
        v1 = vsc[col + 1];
        v2 = vsc[col + 8];
        v3 = vsc[col + 9];
      }
      const float* p0 = sacc[2 * kk];
      const float* p1 = sacc[2 * kk + 1];
      const uint32_t a[4] = {
          pack_bf16(p0[0] * v0, p0[1] * v1), pack_bf16(p0[2] * v0, p0[3] * v1),
          pack_bf16(p1[0] * v2, p1[1] * v3), pack_bf16(p1[2] * v2, p1[3] * v3)};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        const int r = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(smem_u32(vt + swz<D>(r, dd * 2 + (lane >> 4))), b);
        mma_bf16(acc[2 * dd], a, b[0], b[1]);
        mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // ---- write: o normalized (zeros for rows that attend nothing), (m, l) ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    const int r = w0 + (lane >> 2) + i * 8;
    if (r >= ntok * G) continue;
    const int t = r / G, g = r % G;
    const size_t row = ((size_t)(tok0 + t) * p.Hkv + h) * G + g;
    const bool live = qpos[i] >= 0;
    const float inv = live ? emit_scale(p, row, mrow[i] * kLn2, lrow[i]) : 0.f;
    uint32_t* op = reinterpret_cast<uint32_t*>(o + row * D) + (lane & 3);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      op[d * 4] = pack_bf16(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
    if (p.m_out != nullptr && (lane & 3) == 0) {
      p.m_out[row] = live ? mrow[i] * kLn2 : kNegInf;
      p.l_out[row] = live ? lrow[i] : 0.f;
    }
  }
}

// ---------------- the tensor-core decode body ----------------

// one warp's shared memory in the decode body: its K/V ring (bf16), or with
// 1-byte pages (int8, fp8) its ring of codes, one widened bf16 K|V tile and
// the ring's page scales (read with int8 pages only)
template <typename TC, int D>
__host__ __device__ constexpr int dec_warp_bytes() {
  return sizeof(TC) == 1
             ? DST * 2 * DKT * D + 2 * DKT * D * 2 + DST * 2 * DKT * 4
             : DST * 2 * DKT * D * 2;
}
// warps of a decode block that walk the horizon: all 8 up to D = 128; 4
// above it, whose rings (twice as wide) keep the block's bytes in flight
// and fit the SM
template <int D>
__host__ __device__ constexpr int dec_warps() {
  return D > 128 ? 4 : NW;
}
// dynamic shared memory of a decode block: the 16 query rows (bf16), then
// the walking warps' rings; the warps' merge (16 x D f32 partial O and 16
// (m, l) each) reuses the rings
template <typename TC, int D>
__host__ __device__ constexpr int dec_smem_bytes() {
  return DROWS * D * 2 + dec_warps<D>() * dec_warp_bytes<TC, D>();
}

// One decode block: row group rg (16 query rows) of decode tile s, kv head
// h, horizon split z. blk: this block's index among the decode blocks.
// kWin: as for tc_segment_tile
template <typename TC, int D, bool kWin>
__device__ __forceinline__ void tc_decode_tile(const Params& p, const int blk,
                                               unsigned char* smem) {
  constexpr bool kScaled = std::is_same<TC, int8_t>::value;
  constexpr bool kByte = sizeof(TC) == 1;  // int8 or fp8 codes, staged
  constexpr bool kQs = q_in_smem<D>();     // Q read from shared memory
  constexpr int NWD = dec_warps<D>();      // warps that walk
  constexpr int NT = NW * 32;
  constexpr int CPR = D / 8;            // bf16 chunks per tile row
  constexpr int EB = (int)sizeof(TC);   // cache bytes per element
  constexpr int LCPR = D * EB / 16;     // 16-byte copies per cache row
  constexpr int U = DKT * LCPR / 32;    // copies per lane per K (or V) tile
  // every copy of a lane lands in the same chunk of its rows (no D = 192)
  constexpr bool kEven = 32 % LCPR == 0;
  constexpr int TILE = DKT * D;         // elements of one K or V tile
  constexpr int CPT = D * DROWS / NT;   // output columns per thread
  static_assert(DKT * LCPR % 32 == 0, "copy split");
  static_assert(dec_smem_bytes<TC, D>() <= kMaxSmem, "decode block fits");

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int G = p.Gq;
  const int rgs = (G + DROWS - 1) / DROWS;
  const int z = blk % p.n_split;
  int rest = blk / p.n_split;
  const int h = rest % p.Hkv;
  rest /= p.Hkv;
  const int rg = rest % rgs;
  const int s = rest / rgs;
  const int r0 = rg * DROWS;
  const int nrows = min(DROWS, G - r0);
  const int seq_len = p.d_seq_lens[s];
  const int last = min(seq_len, p.M * p.bs) - 1;  // -1: inactive
  const int* table = p.d_tables + (size_t)s * p.M;
  const TC* kc = static_cast<const TC*>(p.kc);
  const TC* vc = static_cast<const TC*>(p.vc);
  // window floors: the row group's first row's (the lowest) starts the
  // walk; its last real row's is the highest
  const int sf = kWin ? max(0, decode_floor(p, seq_len, r0)) / DKT : 0;
  const int fhi = kWin ? decode_floor(p, seq_len, r0 + nrows - 1) : 0;

  // ---- this block's split of [floor, last], then this warp's run ----
  const int steps = last >= sf * DKT ? last / DKT + 1 - sf : 0;
  const int per = max((steps + p.n_split - 1) / p.n_split, DMIN_STEPS);
  const int b0 = min(steps, z * per), b1 = min(steps, b0 + per);
  const int wper = (b1 - b0 + NWD - 1) / NWD;
  const int w0s = min(b1, b0 + warp * wper);
  // this warp's steps (none for the warps past the walking ones)
  const int n = warp < NWD ? min(b1, w0s + wper) - w0s : 0;
  const int first = sf + w0s;  // the horizon's step of this warp's first

  // ---- Q: the 16 rows (zeros past the tile's rows), copies in flight ----
  bf16* qs = reinterpret_cast<bf16*>(smem);
  {
    const bf16* q = static_cast<const bf16*>(p.q);
    const size_t qrow0 = ((size_t)s * p.Hkv + h) * G + r0;
    for (int e = tid; e < DROWS * CPR; e += NT) {
      const int r = e / CPR, c = e % CPR;
      const bool ok = r < nrows;
      cp_async16(smem_u32(qs + swz<D>(r, c)), ok ? q + (qrow0 + r) * D + c * 8 : q,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }

  // ---- this warp's ring (the warps past NWD have none and never copy) ----
  unsigned char* wb = smem + DROWS * D * 2 + warp * dec_warp_bytes<TC, D>();
  static_assert(DROWS * (D + 2) * 4 <= dec_warp_bytes<TC, D>(),
                "the warps' merge fits in their rings");
  bf16* ring = reinterpret_cast<bf16*>(wb);   // bf16: [DST][K|V][DKT][D]
  int8_t* codes = reinterpret_cast<int8_t*>(wb);  // int8: [DST][K|V][DKT][D]
  bf16* wide = reinterpret_cast<bf16*>(wb + DST * 2 * TILE);  // int8: [K|V][DKT][D]
  float* pscl = reinterpret_cast<float*>(  // int8: [DST][K|V][DKT]
      wb + DST * 2 * TILE + 2 * TILE * 2);

  // copy u of this lane: the 16-byte chunk ccol(u) of tile row crow(u) (as
  // in the segment tiles, per warp)
  auto crow = [&](int u) {
    return kEven ? lane / LCPR + u * (32 / LCPR) : (lane + u * 32) / LCPR;
  };
  auto ccol = [&](int u) {
    return kEven ? lane % LCPR : (lane + u * 32) % LCPR;
  };
  const TC* kch = kc + (size_t)h * p.N * p.bs * D;
  const TC* vch = vc + (size_t)h * p.N * p.bs * D;
  const bool page_steps = p.bs % DKT == 0;  // a step lies in one page
  int pg[U], poff[U];
  float psk[U], psv[U];
  auto fetch = [&](int step) {
    const int p0 = step * DKT;
    const int pi = page_steps ? p0 / p.bs : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = p0 + crow(u);
      int idx, off;
      if (page_steps) {
        idx = pi;
        off = p0 - pi * p.bs + crow(u);
      } else {
        idx = pos / p.bs;
        off = pos - idx * p.bs;
      }
      pg[u] = pos <= last ? table[idx] : -1;
      poff[u] = off;
      if constexpr (kScaled) {
        if (ccol(u) == 0) {
          psk[u] = pg[u] >= 0 ? p.k_scales[pg[u]] : 0.f;
          psv[u] = pg[u] >= 0 ? p.v_scales[pg[u]] : 0.f;
        }
      }
    }
  };
  auto copy_step = [&](int i) {  // the warp's i-th step, into stage i % DST
    const int st = i % DST;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = crow(u), cc = ccol(u);
      const bool ok = pg[u] >= 0;
      const size_t off =
          ok ? ((size_t)pg[u] * p.bs + poff[u]) * D + cc * (16 / EB) : 0;
      if constexpr (kByte) {
        int8_t* ct = codes + st * 2 * TILE + row * D + cc * 16;
        cp_async16(smem_u32(ct), kch + off, ok ? 16 : 0);
        cp_async16(smem_u32(ct + TILE), vch + off, ok ? 16 : 0);
        if (kScaled && cc == 0) {
          pscl[(st * 2) * DKT + row] = psk[u];
          pscl[(st * 2 + 1) * DKT + row] = psv[u];
        }
      } else {
        bf16* kt = ring + st * 2 * TILE;
        cp_async16(smem_u32(kt + swz<D>(row, cc)), kch + off, ok ? 16 : 0);
        cp_async16(smem_u32(kt + TILE + swz<D>(row, cc)), vch + off,
                   ok ? 16 : 0);
      }
    }
  };
  // 1-byte codes: the copying lane widens its own chunks into the warp's
  // bf16 tile (exact; int8 codes without their scale)
  auto widen = [&](int i) {
    const int st = i % DST;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = crow(u), cc = ccol(u);
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            codes + (st * 2 + kv) * TILE + row * D + cc * 16);
        const uint2 w0 = widen_codes<TC>(raw.x), w1 = widen_codes<TC>(raw.y);
        const uint2 w2 = widen_codes<TC>(raw.z), w3 = widen_codes<TC>(raw.w);
        bf16* dst = wide + kv * TILE;
        *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * cc)) =
            make_uint4(w0.x, w0.y, w1.x, w1.y);
        *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * cc + 1)) =
            make_uint4(w2.x, w2.y, w3.x, w3.y);
      }
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  const float qk_scale = p.scale * kLog2e;
  const float masked_out = __int_as_float(0xff800000);  // -inf
  int rfl[2];  // this thread's two rows' window floors
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rfl[r] = kWin ? decode_floor(p, seq_len, r0 + (lane >> 2) + 8 * r) : 0;

  // the warp's first DST - 1 steps in flight (one commit group each, after
  // Q's), then Q into registers while they land
  if (n > 0) {
    fetch(first);
#pragma unroll
    for (int i = 0; i < DST - 1; ++i) {
      if (i < n) copy_step(i);
      cp_async_commit();
      if (i + 1 < n) fetch(first + i + 1);
    }
    cp_async_wait<DST - 1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // every thread's Q copies landed
  uint32_t qf[kQs ? 1 : D / 16][4];
  const int qrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  if constexpr (!kQs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(smem_u32(qs + swz<D>(qrow, kk * 2 + (lane >> 4))), qf[kk]);
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<DST - 2>();  // this lane's copies of step i landed
    // every lane's copies of step i are visible, and every lane is done
    // with step i - 1 (whose stage, or bf16 tile, is overwritten next)
    __syncwarp();
    if constexpr (kByte) {
      widen(i);
      __syncwarp();
    }
    if (i + DST - 1 < n) copy_step(i + DST - 1);
    cp_async_commit();
    if (i + DST < n) fetch(first + i + DST);

    const int c = (first + i) * DKT;
    const bf16* kt = kByte ? wide : ring + (i % DST) * 2 * TILE;
    const bf16* vt = kt + TILE;
    const float* ksc = pscl + (i % DST) * 2 * DKT;
    const float* vsc = ksc + DKT;

    // ---- S = Q K^T: 16 rows x 16 positions ----
    float sacc[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
      sacc[nn][0] = sacc[nn][1] = sacc[nn][2] = sacc[nn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      if constexpr (kQs) {
        ldsm_x4(smem_u32(qs + swz<D>(qrow, kk * 2 + (lane >> 4))), a);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      }
      const int r = (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(smem_u32(kt + swz<D>(r, kk * 2 + ((lane >> 3) & 1))), b);
      mma_bf16(sacc[0], a, b[0], b[1]);
      mma_bf16(sacc[1], a, b[2], b[3]);
    }

    // ---- scale (log2 domain), mask the positions past the horizon and
    // below a row's window floor ----
    const bool masked = c + DKT - 1 > last || (kWin && c < fhi);
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nn * 8 + 2 * (lane & 3) + e;
        float f = qk_scale;
        if constexpr (kScaled) f *= ksc[col];
        const bool cut = masked && c + col > last;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = cut || (kWin && masked && c + col < rfl[r])
                              ? masked_out
                              : sacc[nn][2 * r + e] * f;
          sacc[nn][2 * r + e] = v;
          mx[r] = fmaxf(mx[r], v);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f(mrow[r] - mx[r]);
      mrow[r] = mx[r];
      lrow[r] *= alpha;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sacc[nn][e] - mrow[e >> 1]);
        lrow[e >> 1] += pe;  // l sums the f32 p, before any rounding
        sacc[nn][e] = pe;
      }
    }

    // ---- O += P V: P rounded to bf16 in registers (the A fragment) ----
    float v0 = 1.f, v1 = 1.f, v2 = 1.f, v3 = 1.f;
    if constexpr (kScaled) {  // V page scales fold into p, in f32
      const int col = 2 * (lane & 3);
      v0 = vsc[col];
      v1 = vsc[col + 1];
      v2 = vsc[col + 8];
      v3 = vsc[col + 9];
    }
    const uint32_t a[4] = {
        pack_bf16(sacc[0][0] * v0, sacc[0][1] * v1),
        pack_bf16(sacc[0][2] * v0, sacc[0][3] * v1),
        pack_bf16(sacc[1][0] * v2, sacc[1][1] * v3),
        pack_bf16(sacc[1][2] * v2, sacc[1][3] * v3)};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t b[4];
      const int r = (lane & 7) + (((lane >> 3) & 1) << 3);
      ldsm_x4_t(smem_u32(vt + swz<D>(r, dd * 2 + (lane >> 4))), b);
      mma_bf16(acc[2 * dd], a, b[0], b[1]);
      mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }

  // ---- the warps merge through shared memory (flash rule, log2) ----
  __syncthreads();  // every warp is done with its ring
  float* mo = reinterpret_cast<float*>(smem + DROWS * D * 2);  // [NWD][16][D]
  float* mm = mo + NWD * DROWS * D;                             // [NWD][16]
  float* ml = mm + NWD * DROWS;                                 // [NWD][16]
  if (warp < NWD) {
    const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* orow = mo + (warp * DROWS + g + 8 * r) * D + q2;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        *reinterpret_cast<float2*>(orow + d * 8) =
            make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
      if ((lane & 3) == 0) {
        mm[warp * DROWS + g + 8 * r] = mrow[r];
        ml[warp * DROWS + g + 8 * r] = lrow[r];
      }
    }
  }
  __syncthreads();
  const int row = tid / (NT / DROWS);          // NT / 16 threads per row
  const int col0 = (tid % (NT / DROWS)) * CPT;  // CPT columns each
  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < NWD; ++w) M = fmaxf(M, mm[w * DROWS + row]);
  float L = 0.f, o[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) o[j] = 0.f;
#pragma unroll
  for (int w = 0; w < NWD; ++w) {
    const float wt = exp2f(mm[w * DROWS + row] - M);
    L += ml[w * DROWS + row] * wt;
    const float* src = mo + (w * DROWS + row) * D + col0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[j] = fmaf(wt, src[j], o[j]);
  }
  const bool live = L > 0.f;  // something of this split is attended
  const float m_nat = live ? M * kLn2 : kNegInf;
  const size_t grow = ((size_t)s * p.Hkv + h) * G + r0 + row;
  const bool mine = row < nrows;
  bf16* out = static_cast<bf16*>(p.o);

  if (p.n_split == 1) {
    if (mine) {
      const float inv = emit_scale(p, grow, m_nat, L);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        out[grow * D + col0 + j] = __float2bfloat16(o[j] * inv);
      if (p.m_out != nullptr && col0 == 0) {
        p.m_out[grow] = m_nat;
        p.l_out[grow] = live ? L : 0.f;
      }
    }
    return;
  }
  // ---- a split's partial, then the last split of the row group combines
  if (mine) {
    const float inv = live ? 1.f / L : 0.f;
    const size_t prow = (size_t)z * p.R_part + grow;
#pragma unroll
    for (int j = 0; j < CPT; ++j) p.part_o[prow * D + col0 + j] = o[j] * inv;
    if (col0 == 0) {
      p.part_m[prow] = m_nat;
      p.part_l[prow] = live ? L : 0.f;
    }
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  __shared__ int s_last;
  int* ticket = p.tickets + ((size_t)s * p.Hkv + h) * rgs + rg;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == p.n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (mine) {
    const size_t R = p.R_part;
    float Mz = kNegInf;
    for (int zz = 0; zz < p.n_split; ++zz)
      Mz = fmaxf(Mz, __ldcg(p.part_m + zz * R + grow));
    float Lz = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[j] = 0.f;
    for (int zz = 0; zz < p.n_split; ++zz) {
      const size_t prow = zz * R + grow;
      const float wt = __ldcg(p.part_l + prow) * __expf(__ldcg(p.part_m + prow) - Mz);
      Lz += wt;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        o[j] = fmaf(wt, __ldcg(p.part_o + prow * D + col0 + j), o[j]);
    }
    const float iz = emit_scale(p, grow, Mz, Lz);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      out[grow * D + col0 + j] = __float2bfloat16(o[j] * iz);
    if (p.m_out != nullptr && col0 == 0) {
      p.m_out[grow] = Mz;
      p.l_out[grow] = Lz;
    }
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

// A bf16 launch: the segment tiles on the tensor cores (blocks 0 ..
// n_seg_blocks-1, longest horizon first), then the decode tiles on the
// tensor-core decode body (B x row groups x Hkv x n_split blocks, the
// splits of one row group adjacent, merged in the launch).
template <typename TC, int D, bool kWin>
__global__ void __launch_bounds__(NW * 32, 1)
tc_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = blockIdx.x;
  if (blk < p.n_seg_blocks) {
    tc_segment_tile<TC, D, kWin>(p, blk, smem);
    return;
  }
  tc_decode_tile<TC, D, kWin>(p, blk - p.n_seg_blocks, smem);
}

// Merge the n_split partials of every row (one warp per row):
// m = max m_z, l = sum l_z exp(m_z - m), o = sum l_z exp(m_z - m) o_z / l.
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
combine_splits_kernel(const Params p) {
  constexpr int DPL = D / 32;
  const size_t R = p.R_part;
  const size_t row = (size_t)blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  float m = kNegInf;
  for (int z = 0; z < p.n_split; ++z) m = fmaxf(m, p.part_m[z * R + row]);
  float l = 0.f, acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  for (int z = 0; z < p.n_split; ++z) {
    const size_t prow = z * R + row;
    const float w = p.part_l[prow] * __expf(p.part_m[prow] - m);
    l += w;
    const float* op = p.part_o + prow * D + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = fmaf(w, op[d], acc[d]);
  }
  const float inv = emit_scale(p, row, m, l);
  T* o = static_cast<T*>(p.o) + row * D + lane * DPL;
#pragma unroll
  for (int d = 0; d < DPL; ++d) o[d] = from_f<T>(acc[d] * inv);
  if (p.m_out != nullptr && lane == 0) {
    p.m_out[row] = m;
    p.l_out[row] = l;
  }
}

template <typename T, int D>
void launch_combine(const Params& p, cudaStream_t stream) {
  if (p.n_split > 1 && p.R_part > 0) {
    const unsigned blocks = (unsigned)((p.R_part + NW - 1) / NW);
    combine_splits_kernel<T, D><<<blocks, NW * 32, 0, stream>>>(p);
  }
}

template <typename T, typename TC, int D>
cudaError_t launch_core(const Params& p, int n_tiles, cudaStream_t stream) {
  dim3 grid(n_tiles, p.Hkv, p.n_split);
  paged_attention_kernel<T, TC, D><<<grid, NW * 32, 0, stream>>>(p);
  launch_combine<T, D>(p, stream);
  return cudaGetLastError();
}

template <typename TC, int D, bool kWin>
cudaError_t launch_tc_as(const Params& p, cudaStream_t stream) {
  constexpr int seg = tc_smem_bytes<TC, D>();
  constexpr int dec = dec_smem_bytes<TC, D>();
  static bool attr_set = false;  // above 48 KB needs the opt-in, once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_attention_kernel<TC, D, kWin>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, seg > dec ? seg : dec);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int rgs = (p.Gq + DROWS - 1) / DROWS;
  const int dec_blocks = p.B * rgs * p.Hkv * p.n_split;
  const int smem = p.B == 0 ? seg : (p.n_seg_blocks == 0 ? dec : (seg > dec ? seg : dec));
  tc_attention_kernel<TC, D, kWin><<<p.n_seg_blocks + dec_blocks, NW * 32,
                                     smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TC, int D>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  return p.window > 0 ? launch_tc_as<TC, D, true>(p, stream)
                      : launch_tc_as<TC, D, false>(p, stream);
}

// bf16 launches on the tensor-core bodies, f32 launches on the CUDA-core
// one; a translation unit instantiates its two widths, D0 and D1
template <int D0, int D1, typename T, typename TC>
cudaError_t launch_typed(const Params& p, int D, int n_tiles,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (D == D1) return launch_tc<TC, D1>(p, stream);
    if (D == D0) return launch_tc<TC, D0>(p, stream);
  } else {
    if (D == D1) return launch_core<T, TC, D1>(p, n_tiles, stream);
    if (D == D0) return launch_core<T, TC, D0>(p, n_tiles, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The plain C interface of both libraries (paged_attention_launch for D =
// 64 and 128, paged_attention_wide_launch for 192 and 256), loaded with
// ctypes. dtype (q and o): 0 = float32, 1 = bfloat16. kv_dtype: the same
// code as dtype for a cache of the q type, 2 = int8 with per-page f32
// scales k_scales / v_scales ([N] each), 3 = float8_e4m3fn with no scales
// (both null). Returns the cudaError_t of the launch (0 = success;
// cudaErrorInvalidValue for a width the library does not build).
//
// A bf16 launch (q bf16 over bf16, int8 or fp8 pages) runs its segment
// tiles on the tensor-core segment body, Tq * Gq <= TC_ROWS (128) rows per
// tile, and its decode tiles on the tensor-core decode body, any Gq (16
// rows per block), n_split splitting only the decode tiles and merged in
// the launch through ``tickets`` (B * Hkv * ceil(Gq / 16) ints, zero
// before the launch and zero after it). An f32 launch runs every tile on
// the CUDA-core body, Tq * Gq <= 64 rows per segment tile and decode tiles
// in chunks of 64 rows, n_split splitting every tile, merged by a second
// kernel. The Python
// wrapper checks both. With n_split > 1, ``scratch`` holds
// n_split * R * (D + 2) floats, R = the split tiles' query rows
// (tokens * Hkv * Gq) for the partials. window (0 = full), q_off and group
// place the decode rows' window floors (Params); sinks ([Hkv * Gq] f32, or
// null) fold into every row's normalizer and come without m_out / l_out.
#define PAGED_ATTENTION_PARAMS                                                \
  const void *q, void *o, float *m_out, float *l_out, const void *kc,         \
      const void *vc, const int *d_tables, const int *d_seq_lens, int B,      \
      const int *p_tables, const int *p_hists, const int *p_valids, int MP,   \
      int T, int Tq, int Hkv, int Gq, int N, int bs, int M, int D,            \
      float scale, int n_split, float *scratch, int dtype,                    \
      const float *k_scales, const float *v_scales, int kv_dtype,             \
      int *tickets, int window, int q_off, int group, const float *sinks,     \
      void *stream
#define PAGED_ATTENTION_ARGS                                                  \
  q, o, m_out, l_out, kc, vc, d_tables, d_seq_lens, B, p_tables, p_hists,     \
      p_valids, MP, T, Tq, Hkv, Gq, N, bs, M, D, scale, n_split, scratch,     \
      dtype, k_scales, v_scales, kv_dtype, tickets, window, q_off, group,     \
      sinks, stream

template <int D0, int D1>
static int paged_attention_entry(PAGED_ATTENTION_PARAMS) {
  if (Tq < 1) Tq = 1;
  Params p;
  p.q = q;
  p.o = o;
  p.m_out = m_out;
  p.l_out = l_out;
  p.kc = kc;
  p.vc = vc;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.d_tables = d_tables;
  p.d_seq_lens = d_seq_lens;
  p.B = B;
  p.p_tables = p_tables;
  p.p_hists = p_hists;
  p.p_valids = p_valids;
  p.MP = MP;
  p.T = T;
  p.Tq = Tq;
  p.nT = MP > 0 ? (T + Tq - 1) / Tq : 0;
  p.Hkv = Hkv;
  p.Gq = Gq;
  p.N = N;
  p.bs = bs;
  p.M = M;
  p.scale = scale;
  p.tickets = tickets;
  p.window = window > 0 ? window : 0;
  p.q_off = q_off;
  p.group = group;
  p.sinks = sinks;
  if (sinks != nullptr && m_out != nullptr) return (int)cudaErrorInvalidValue;
  const bool tc = dtype == 1;
  const int rchunks = (Gq + NW * RPW - 1) / (NW * RPW);
  const int n_tiles = B * rchunks + MP * p.nT;  // the CUDA-core grid's x
  if (B + MP * p.nT == 0) return 0;
  if (MP > 0 && Tq * Gq > (tc ? TC_ROWS : NW * RPW))
    return (int)cudaErrorInvalidValue;
  p.n_seg_blocks = tc ? MP * p.nT * Hkv : 0;
  p.R_part = (size_t)(tc ? B : B + MP * T) * Hkv * Gq;
  p.n_split = n_split > 1 ? n_split : 1;
  p.part_o = scratch;
  p.part_m = scratch + (size_t)p.n_split * p.R_part * D;
  p.part_l = p.part_m + (size_t)p.n_split * p.R_part;
  if (p.n_split > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (tc && B > 0 && p.n_split > 1 && tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2) {
    if (k_scales == nullptr || v_scales == nullptr)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)launch_typed<D0, D1, float, int8_t>(p, D, n_tiles, st);
    if (dtype == 1)
      return (int)launch_typed<D0, D1, bf16, int8_t>(p, D, n_tiles, st);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype == 3) {
    if (k_scales != nullptr || v_scales != nullptr)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)launch_typed<D0, D1, float, __nv_fp8_e4m3>(p, D, n_tiles, st);
    if (dtype == 1)
      return (int)launch_typed<D0, D1, bf16, __nv_fp8_e4m3>(p, D, n_tiles, st);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_typed<D0, D1, float, float>(p, D, n_tiles, st);
  if (dtype == 1) return (int)launch_typed<D0, D1, bf16, bf16>(p, D, n_tiles, st);
  return (int)cudaErrorInvalidValue;
}
