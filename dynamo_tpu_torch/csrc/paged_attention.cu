// Paged attention over the block-table-indirect KV cache, for sm_90a.
//
// Replaces three Pallas TPU kernels of the JAX package with ONE kernel body:
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
// segment.
//
// What bounds it on an H100: device-memory bytes. Every cached K/V row a
// tile needs is read once per (tile, kv head); at decode (one query token
// per sequence) the arithmetic per byte read is ~G*2 flops, far below the
// card's ~295 flops/byte ridge. Prefill tiles of Tq tokens raise that to
// Tq*G*2 flops/byte, still memory-side for the tile sizes used here.
//
// What the design does about it: a block owns one (tile, kv head, split)
// and loops over its share of the tile's causal horizon in KT-position
// steps. Each step looks up the KT positions' pages once (through the block
// table, so any block size works) and loads their K/V rows ONCE into shared
// memory with 16-byte vector loads, converted to fp32; every query row of
// the tile (all G query heads of the kv head, times Tq tokens) reuses them
// from shared memory: GQA and the query tile both divide the device-memory
// traffic. One warp owns up to RPW query rows and keeps each row's scaled
// query, output accumulator and (m, l) in registers; a row's score is a
// warp-wide dot product (each lane holds D/32 dimensions). Decode has only
// B x Hkv tiles, too few blocks for the card, so the wrapper splits every
// tile's horizon into n_split equal parts (flash-decoding): each split
// writes its normalized partial (o, m, l) to f32 scratch and a small
// combine kernel merges them with the flash rule. Tiles whose horizon is
// empty (inactive decode slots, dead segments) attend nothing and write
// zeros, m = -1e30, l = 0, exactly what the TPU kernel emits and what the
// flash merge in verify_attention relies on. Not done yet (later work):
// tensor-core (wgmma) score tiles, TMA page loads, double buffering.
//
// The int8-with-scales device cache (the Pallas kernels' k_scales /
// v_scales option, paged_attention_pallas.py:197 and :451,
// ragged_paged_attention_pallas.py:240): the cache element type is a
// template parameter apart from the q/o type. An int8 page carries one f32
// scale per physical page for K and one for V; the step's page lookup reads
// them beside the row offsets, and each int8 row is widened and multiplied
// by its page's scale as it lands in shared memory (8 codes per 8-byte load:
// a thread converts as many elements as in the bf16 kernel, which keeps the
// register count, and one pass still covers a KT x D step), so everything
// after the load is the bf16/f32 kernel unchanged and the bytes read from
// the cache halve against bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF, not -inf
constexpr int KT = 16;             // kv positions per shared-memory step
constexpr int NW = 8;              // warps per block
constexpr int RPW = 8;             // query rows per warp (max)

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
  int n_split;     // horizon splits per tile (grid.z)
  float* part_o;   // [n_split, R, D] f32 partials when n_split > 1
  float* part_m;   // [n_split, R]
  float* part_l;   // [n_split, R]
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL consecutive floats of a shared-memory row, as one vector load.
template <int DPL>
__device__ __forceinline__ void load_lane(const float* p, float (&out)[DPL]) {
  if constexpr (DPL == 4) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// T: the q/o type; TC: the cache type (T itself, or int8_t with per-page
// scales)
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(NW * 32)
paged_attention_kernel(const Params p) {
  constexpr int DPL = D / 32;
  constexpr bool kScaled = std::is_same<TC, int8_t>::value;
  // elements per load: 16 bytes of bf16/f32, 8 bytes of int8
  constexpr int VEC = kScaled ? 8 : 16 / sizeof(TC);
  using Load = typename std::conditional<kScaled, uint2, uint4>::type;
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];
  __shared__ long long row_base[KT];  // element offset of a position's row
  __shared__ float row_ks[KT], row_vs[KT];  // its page's scales (int8 cache)

  const int s = blockIdx.x;  // tile
  const int h = blockIdx.y;  // kv head
  const int z = blockIdx.z;  // horizon split
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

  const T* q = static_cast<const T*>(p.q);
  const TC* kc = static_cast<const TC*>(p.kc);
  const TC* vc = static_cast<const TC*>(p.vc);

  float qr[RPW][DPL], acc[RPW][DPL], mr[RPW], lr[RPW];
  int qpos[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * NW;
    mr[i] = kNegInf;
    lr[i] = 0.f;
    qpos[i] = -1;  // never attends: padded / unreal rows
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      acc[i][d] = 0.f;
      qr[i][d] = 0.f;
    }
    if (r < real_rows) {
      const int t = r / p.Gq, g = r % p.Gq;
      qpos[i] = q0 + t;
      const T* qp =
          q + (((size_t)(tok0 + t) * p.Hkv + h) * p.Gq + g) * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) qr[i][d] = to_f(qp[d]) * p.scale;
    }
  }

  // this split's share of the horizon [0, last], in whole KT steps
  const int steps = (last + KT) / KT;
  const int per = (steps + p.n_split - 1) / p.n_split;
  const int c_begin = z * per * KT;
  const int c_end = min(last + 1, (z + 1) * per * KT);
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
      if (qpos[i] < c) continue;  // uniform across the warp
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
        sc[j] = (c + j <= qpos[i]) ? part : kNegInf;
        mx = fmaxf(mx, sc[j]);
      }
      // position c <= qpos is in this step, so mx is a real score
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
  const size_t R = (size_t)(p.B + p.MP * p.T) * p.Hkv * p.Gq;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * NW;
    if (r >= rows) continue;
    const int t = r / p.Gq, g = r % p.Gq;
    const size_t row = ((size_t)(tok0 + t) * p.Hkv + h) * p.Gq + g;
    const float inv = 1.f / fmaxf(lr[i], 1e-20f);
    if (p.n_split > 1) {  // normalized partial for the combine kernel
      const size_t prow = (size_t)z * R + row;
      float* op = p.part_o + prow * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) op[d] = acc[i][d] * inv;
      if (lane == 0) {
        p.part_m[prow] = mr[i];
        p.part_l[prow] = lr[i];
      }
      continue;
    }
    T* op = o + row * D + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) op[d] = from_f<T>(acc[i][d] * inv);
    if (p.m_out != nullptr && lane == 0) {
      p.m_out[row] = mr[i];
      p.l_out[row] = lr[i];
    }
  }
}

// Merge the n_split partials of every row (one warp per row):
// m = max m_z, l = sum l_z exp(m_z - m), o = sum l_z exp(m_z - m) o_z / l.
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
combine_splits_kernel(const Params p, size_t R) {
  constexpr int DPL = D / 32;
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
  const float inv = 1.f / fmaxf(l, 1e-20f);
  T* o = static_cast<T*>(p.o) + row * D + lane * DPL;
#pragma unroll
  for (int d = 0; d < DPL; ++d) o[d] = from_f<T>(acc[d] * inv);
  if (p.m_out != nullptr && lane == 0) {
    p.m_out[row] = m;
    p.l_out[row] = l;
  }
}

template <typename T, typename TC, int D>
cudaError_t launch_d(const Params& p, int n_tiles, cudaStream_t stream) {
  dim3 grid(n_tiles, p.Hkv, p.n_split);
  paged_attention_kernel<T, TC, D><<<grid, NW * 32, 0, stream>>>(p);
  if (p.n_split > 1) {
    const size_t R = (size_t)(p.B + p.MP * p.T) * p.Hkv * p.Gq;
    const unsigned blocks = (unsigned)((R + NW - 1) / NW);
    combine_splits_kernel<T, D><<<blocks, NW * 32, 0, stream>>>(p, R);
  }
  return cudaGetLastError();
}

template <typename T, typename TC>
cudaError_t launch_typed(const Params& p, int D, int n_tiles,
                         cudaStream_t stream) {
  if (D == 128) return launch_d<T, TC, 128>(p, n_tiles, stream);
  if (D == 64) return launch_d<T, TC, 64>(p, n_tiles, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype (q and o): 0 = float32,
// 1 = bfloat16. kv_dtype: the same code as dtype for a cache of the q type,
// 2 = int8 with per-page f32 scales k_scales / v_scales ([N] each).
// Returns the cudaError_t of the launch (0 = success). Rows per tile
// (tokens * Gq) must not exceed NW * RPW; the Python wrapper checks it.
// With n_split > 1, ``scratch`` holds n_split * R * (D + 2) floats (R =
// query tokens * Hkv * Gq) for the partials.
extern "C" int paged_attention_launch(
    const void* q, void* o, float* m_out, float* l_out, const void* kc,
    const void* vc, const int* d_tables, const int* d_seq_lens, int B,
    const int* p_tables, const int* p_hists, const int* p_valids, int MP,
    int T, int Tq, int Hkv, int Gq, int N, int bs, int M, int D, float scale,
    int n_split, float* scratch, int dtype, const float* k_scales,
    const float* v_scales, int kv_dtype, void* stream) {
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
  const int n_tiles = B + MP * p.nT;
  if (n_tiles == 0) return 0;
  const size_t R = (size_t)(B + MP * T) * Hkv * Gq;
  p.n_split = n_split > 1 ? n_split : 1;
  p.part_o = scratch;
  p.part_m = scratch + (size_t)p.n_split * R * D;
  p.part_l = p.part_m + (size_t)p.n_split * R;
  if (p.n_split > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2) {
    if (k_scales == nullptr || v_scales == nullptr)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0) return (int)launch_typed<float, int8_t>(p, D, n_tiles, st);
    if (dtype == 1)
      return (int)launch_typed<__nv_bfloat16, int8_t>(p, D, n_tiles, st);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_typed<float, float>(p, D, n_tiles, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16, __nv_bfloat16>(p, D, n_tiles, st);
  return (int)cudaErrorInvalidValue;
}
