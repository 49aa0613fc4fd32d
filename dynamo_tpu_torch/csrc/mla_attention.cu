// Paged LATENT attention for Multi-Latent Attention (DeepSeek), for sm_90a.
//
// Replaces two Pallas TPU kernels of the JAX package with ONE kernel body:
//   * dynamo_tpu/ops/mla_attention_pallas.py::mla_paged_decode_attention
//     (_mla_decode_kernel; with return_stats, the (m, l) statistics the
//     flash merge of mla_decode_attention_merged needs),
//   * dynamo_tpu/ops/mla_attention_pallas.py::mla_paged_prefill_attention
//     (_mla_prefill_kernel: a chunk over history + the already-written
//     chunk, causal at absolute positions).
// Both compute the same thing, at the latent widths the column tiling takes:
// kv_lora_rank C in {128, 256, 512} and rope width R in {32, 64}, each a
// template instance. The cache holds ONE latent stream per token
// (c [N, bs, C] and the rotated pe [N, bs, R]) shared by all H query heads:
// attention is MQA-shaped. A query row (token, head) scores position s as
// q_eff . c[s] + q_pe . pe[s] (scaled), and the VALUES are the latents c
// themselves; fp32 online softmax over every kv_pos <= q_pos.
//
// What bounds it on an H100: decode is device-memory bytes (each position's
// 576 latent values are read once per sequence: ~9 MB for 8 sequences at up
// to 2k tokens); prefill is operations (a T-token chunk does 2 * T * H *
// positions * (C + R + C) flops against a cache that stays in L2).
//
// What the design does about it: a block owns a tile of RMAX query rows
// (the H heads of one decode token, or RMAX/H prefill tokens x H heads) and
// walks its share of the tile's causal horizon in KT-position steps. Each
// step looks the KT positions' pages up once through the block table and
// loads their c and pe rows ONCE into shared memory (16-byte loads,
// converted to fp32); every row of the tile scores them from there, so the
// H heads (and the tile's tokens) divide the device-memory traffic by RMAX.
// The [RMAX, C] fp32 accumulator is split across the block's 256 threads by
// output column (C = 512: each thread owns two columns of every row, 64
// registers), so no thread holds a whole row; the scaled queries live in
// shared memory, the step's probabilities too (float4 broadcast reads).
// Decode has few tiles (B sequences), so the wrapper splits every tile's
// horizon into n_split parts (flash-decoding): each split writes its
// normalized partial (o, m, l) to fp32 scratch and a combine kernel merges
// them. Rows that attend nothing (an empty decode slot, prefill padding
// past valid_len) emit o = 0, m = -1e30, l = 0, the Pallas kernel's empty
// row. Scores and the PV product run on CUDA cores; tensor-core (mma /
// wgmma) tiles, TMA page loads and double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF, not -inf
constexpr int NT = 256;            // threads per block
constexpr int KT = 16;             // kv positions per shared-memory step
constexpr int PAD = 4;             // fp32 padding per shared row (banks)

struct Params {
  const void* q_eff;  // [R_total, C] query rows (token-major, heads inner)
  const void* q_pe;   // [R_total, R]
  void* o;            // [R_total, C] in the input dtype, or f32 (out_f32)
  float* m_out;       // [R_total] or null
  float* l_out;       // [R_total] or null
  const void* cc;     // [N, bs, C] latent cache layer
  const void* pc;     // [N, bs, R] rope-key cache layer
  const int* tables;  // decode: [B, M]; prefill: [M]
  const int* seq_lens;  // decode [B]: row attends kv_pos < seq_len
  const int* hist;      // prefill [1]: tokens cached before the chunk
  const int* valid;     // prefill [1]: real tokens, or null (= T)
  int B;                // decode sequences (0: prefill)
  int T;                // prefill chunk tokens
  int H, N, bs, M;
  int tiles_per_seq;    // decode: ceil(H / RMAX)
  float scale;
  int out_f32;
  int n_split;          // horizon splits per tile (grid.y)
  float* part_o;        // [n_split, R_total, C] when n_split > 1
  float* part_m;        // [n_split, R_total]
  float* part_l;        // [n_split, R_total]
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements (16 bytes) as fp32 times `mul`.
template <typename T, int VEC>
__device__ __forceinline__ void load16(const T* src, float mul, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < VEC; u += 4) {
    *reinterpret_cast<float4*>(dst + u) =
        make_float4(to_f(v[u]) * mul, to_f(v[u + 1]) * mul,
                    to_f(v[u + 2]) * mul, to_f(v[u + 3]) * mul);
  }
}

template <int VEC>
__device__ __forceinline__ void zero16(float* dst) {
#pragma unroll
  for (int u = 0; u < VEC; u += 4)
    *reinterpret_cast<float4*>(dst + u) = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int C, int R, int RMAX>
constexpr size_t smem_bytes() {
  return (size_t)(RMAX + KT) * (C + R + PAD) * 4  // queries, kv step
         + (size_t)RMAX * KT * 4                 // scores / probabilities
         + (size_t)RMAX * 4 * 4                  // m, l, alpha, limit
         + (size_t)KT * 8 * 2;                   // page offsets
}

template <typename T, int C, int R, int RMAX>
__global__ void __launch_bounds__(NT, 2)
mla_attention_kernel(const Params p) {
  constexpr int D = C + R;
  constexpr int DP = D + PAD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;  // 16-byte chunks per query / kv row
  constexpr int CPT = C >= NT ? C / NT : 1;  // output columns per thread
  constexpr int RG = C >= NT ? 1 : NT / C;   // row groups
  constexpr int RPT = RMAX / RG;             // rows per thread
  constexpr int SPT = RMAX * KT / NT;        // scores per thread per step
  static_assert(C % VEC == 0 && R % VEC == 0, "16-byte rows");
  static_assert(SPT >= 1 && (RMAX * KT) % NT == 0, "score tiling");
  static_assert(C % NT == 0 || NT % C == 0, "column tiling");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [RMAX][DP] scaled queries
  float* kvs = qs + RMAX * DP;      // [KT][DP] this step's c | pe rows
  float* ps = kvs + KT * DP;        // [RMAX][KT] scores, then probabilities
  float* m_s = ps + RMAX * KT;      // [RMAX] running max
  float* l_s = m_s + RMAX;          // [RMAX] running normalizer
  float* a_s = l_s + RMAX;          // [RMAX] this step's rescale
  int* lim_s = reinterpret_cast<int*>(a_s + RMAX);  // [RMAX] causal limit
  long long* cbase = reinterpret_cast<long long*>(lim_s + RMAX);  // [KT]
  long long* pbase = cbase + KT;                                  // [KT]

  const int t = threadIdx.x;
  const int s = blockIdx.x;  // tile
  const int z = blockIdx.y;  // horizon split

  // ---- tile metadata: rows g0 .. g0+nrows-1 and their causal horizon ----
  int g0, nrows, last, hist = 0, valid = 0;
  const int* table;
  if (p.B > 0) {
    const int b = s / p.tiles_per_seq, rt = s % p.tiles_per_seq;
    g0 = b * p.H + rt * RMAX;
    nrows = min(RMAX, p.H - rt * RMAX);
    last = p.seq_lens[b] - 1;  // -1: an empty slot attends nothing
    table = p.tables + (size_t)b * p.M;
  } else {
    g0 = s * RMAX;
    nrows = min(RMAX, p.T * p.H - g0);
    hist = p.hist[0];
    valid = p.valid ? p.valid[0] : p.T;
    const int t_first = g0 / p.H, t_last = (g0 + nrows - 1) / p.H;
    last = t_first < valid ? hist + min(t_last, valid - 1) : -1;
    table = p.tables;
  }
  if (t < RMAX) {
    int lim = -1;
    if (t < nrows) {
      if (p.B > 0) {
        lim = last;
      } else {
        const int tok = (g0 + t) / p.H;
        lim = tok < valid ? hist + tok : -1;
      }
    }
    lim_s[t] = lim;
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
  }

  // ---- the tile's queries, scaled, into shared memory ----
  const T* qe = static_cast<const T*>(p.q_eff);
  const T* qp = static_cast<const T*>(p.q_pe);
  for (int idx = t; idx < RMAX * CH; idx += NT) {
    const int r = idx / CH, k = (idx % CH) * VEC;
    float* dst = qs + r * DP + k;
    if (r < nrows) {
      const size_t g = (size_t)g0 + r;
      load16<T, VEC>(k < C ? qe + g * C + k : qp + g * R + (k - C), p.scale,
                     dst);
    } else {
      zero16<VEC>(dst);
    }
  }

  // this split's share of the horizon [0, last], in whole KT steps
  const int steps = (last + KT) / KT;
  const int per = (steps + p.n_split - 1) / p.n_split;
  const int c_begin = z * per * KT;
  const int c_end = min(last + 1, (z + 1) * per * KT);

  const int col0 = C >= NT ? t : t % C;
  const int row0 = C >= NT ? 0 : t / C;
  float acc[RPT][CPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[k][i] = 0.f;

  const T* cc = static_cast<const T*>(p.cc);
  const T* pc = static_cast<const T*>(p.pc);
  __syncthreads();

  for (int c = c_begin; c < c_end; c += KT) {
    // ---- one step: the KT positions' c | pe rows into shared memory ----
    if (t < KT) {
      const int pos = c + t;
      if (pos < c_end) {
        const long long slot =
            (long long)table[pos / p.bs] * p.bs + pos % p.bs;
        cbase[t] = slot * C;
        pbase[t] = slot * R;
      } else {
        cbase[t] = -1;
        pbase[t] = -1;
      }
    }
    __syncthreads();
    for (int idx = t; idx < KT * CH; idx += NT) {
      const int j = idx / CH, k = (idx % CH) * VEC;
      float* dst = kvs + j * DP + k;
      if (cbase[j] >= 0) {
        load16<T, VEC>(k < C ? cc + cbase[j] + k : pc + pbase[j] + (k - C),
                       1.f, dst);
      } else {
        zero16<VEC>(dst);
      }
    }
    __syncthreads();

    // ---- scores: thread (j, rows t/KT + i*NT/KT), masked causally ----
    {
      const int j = t % KT;
      float sc[SPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i) sc[i] = 0.f;
      const float* kr = kvs + j * DP;
#pragma unroll 4
      for (int k = 0; k < D; k += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + k);
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const float4 q = *reinterpret_cast<const float4*>(
              qs + (t / KT + i * (NT / KT)) * DP + k);
          sc[i] = fmaf(q.x, kv.x, sc[i]);
          sc[i] = fmaf(q.y, kv.y, sc[i]);
          sc[i] = fmaf(q.z, kv.z, sc[i]);
          sc[i] = fmaf(q.w, kv.w, sc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int r = t / KT + i * (NT / KT);
        const int pos = c + j;
        ps[r * KT + j] = (pos <= lim_s[r] && pos < c_end) ? sc[i] : kNegInf;
      }
    }
    __syncthreads();

    // ---- online softmax, one thread per row ----
    if (t < RMAX) {
      float* sr = ps + t * KT;
      const int lim = min(lim_s[t], c_end - 1);
      if (lim >= c) {  // position c is attended: the max is a real score
        const float m_old = m_s[t];
        float mx = m_old;
#pragma unroll
        for (int j = 0; j < KT; ++j) mx = fmaxf(mx, sr[j]);
        const float alpha = __expf(m_old - mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const float e = (c + j <= lim) ? __expf(sr[j] - mx) : 0.f;
          sr[j] = e;
          sum += e;
        }
        l_s[t] = l_s[t] * alpha + sum;
        m_s[t] = mx;
        a_s[t] = alpha;
      } else {
#pragma unroll
        for (int j = 0; j < KT; ++j) sr[j] = 0.f;
        a_s[t] = 1.f;
      }
    }
    __syncthreads();

    // ---- rescale, then acc += P [rows, KT] x c [KT, C] ----
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const float a = a_s[row0 + k * RG];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[k][i] *= a;
    }
#pragma unroll
    for (int j0 = 0; j0 < KT; j0 += 4) {
      float v[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < CPT; ++i) v[u][i] = kvs[(j0 + u) * DP + col0 + i * NT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float4 pp =
            *reinterpret_cast<const float4*>(ps + (row0 + k * RG) * KT + j0);
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          float a = acc[k][i];
          a = fmaf(pp.x, v[0][i], a);
          a = fmaf(pp.y, v[1][i], a);
          a = fmaf(pp.z, v[2][i], a);
          a = fmaf(pp.w, v[3][i], a);
          acc[k][i] = a;
        }
      }
    }
    __syncthreads();
  }

  // ---- emit: normalized rows (or this split's partial) and (m, l) ----
  const size_t Rtot = p.B > 0 ? (size_t)p.B * p.H : (size_t)p.T * p.H;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = row0 + k * RG;
    if (r >= nrows) continue;
    const size_t g = (size_t)g0 + r;
    const float inv = 1.f / fmaxf(l_s[r], 1e-20f);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int col = col0 + i * NT;
      const float val = acc[k][i] * inv;
      if (p.n_split > 1) {
        p.part_o[((size_t)z * Rtot + g) * C + col] = val;
      } else if (p.out_f32) {
        static_cast<float*>(p.o)[g * C + col] = val;
      } else {
        static_cast<T*>(p.o)[g * C + col] = from_f<T>(val);
      }
    }
  }
  if (t < nrows) {
    const size_t g = (size_t)g0 + t;
    if (p.n_split > 1) {
      p.part_m[(size_t)z * Rtot + g] = m_s[t];
      p.part_l[(size_t)z * Rtot + g] = l_s[t];
    } else if (p.m_out != nullptr) {
      p.m_out[g] = m_s[t];
      p.l_out[g] = l_s[t];
    }
  }
}

// Merge the n_split partials of every row (one warp per row):
// m = max m_z, l = sum l_z exp(m_z - m), o = sum l_z exp(m_z - m) o_z / l.
template <typename T, int C>
__global__ void __launch_bounds__(256)
mla_combine_kernel(const Params p, size_t Rtot) {
  constexpr int CPL = C / 32;
  const size_t row = (size_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= Rtot) return;
  float m = kNegInf;
  for (int z = 0; z < p.n_split; ++z) m = fmaxf(m, p.part_m[z * Rtot + row]);
  float l = 0.f, acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
  for (int z = 0; z < p.n_split; ++z) {
    const size_t prow = z * Rtot + row;
    const float w = p.part_l[prow] * __expf(p.part_m[prow] - m);
    l += w;
    const float* op = p.part_o + prow * C + lane;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = fmaf(w, op[i * 32], acc[i]);
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const size_t idx = row * C + lane + i * 32;
    if (p.out_f32) {
      static_cast<float*>(p.o)[idx] = acc[i] * inv;
    } else {
      static_cast<T*>(p.o)[idx] = from_f<T>(acc[i] * inv);
    }
  }
  if (p.m_out != nullptr && lane == 0) {
    p.m_out[row] = m;
    p.l_out[row] = l;
  }
}

template <typename T, int C, int R, int RMAX>
cudaError_t launch_cfg(const Params& p, int n_tiles, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C, R, RMAX>();
  static bool attr_set = false;  // above 48 KB needs the opt-in, once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_attention_kernel<T, C, R, RMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(n_tiles, p.n_split);
  mla_attention_kernel<T, C, R, RMAX><<<grid, NT, smem, stream>>>(p);
  if (p.n_split > 1) {
    const size_t Rtot = p.B > 0 ? (size_t)p.B * p.H : (size_t)p.T * p.H;
    const unsigned blocks = (unsigned)((Rtot + 7) / 8);
    mla_combine_kernel<T, C><<<blocks, 256, 0, stream>>>(p, Rtot);
  }
  return cudaGetLastError();
}

template <typename T, int R, int RMAX>
cudaError_t launch_c(const Params& p, int C, int n_tiles, cudaStream_t st) {
  if (C == 512) return launch_cfg<T, 512, R, RMAX>(p, n_tiles, st);
  if (C == 256) return launch_cfg<T, 256, R, RMAX>(p, n_tiles, st);
  if (C == 128) return launch_cfg<T, 128, R, RMAX>(p, n_tiles, st);
  return cudaErrorInvalidValue;
}

// the rope widths: 64 (DeepSeek-V2/V3), 32 (MiniCPM3)
template <typename T, int RMAX>
cudaError_t launch_r(const Params& p, int C, int R, int n_tiles,
                     cudaStream_t st) {
  if (R == 64) return launch_c<T, 64, RMAX>(p, C, n_tiles, st);
  if (R == 32) return launch_c<T, 32, RMAX>(p, C, n_tiles, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_typed(const Params& p, int C, int R, int rmax, int n_tiles,
                         cudaStream_t st) {
  if (rmax == 16) return launch_r<T, 16>(p, C, R, n_tiles, st);
  if (rmax == 32) return launch_r<T, 32>(p, C, R, n_tiles, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (queries and caches share it; the output is that dtype, or float32 with
// out_f32). Decode: B > 0 sequences, one token each, tables [B, M],
// seq_lens [B]. Prefill: B == 0, one sequence of T tokens, tables [M],
// hist [1], valid [1] or null. C in {128, 256, 512}, R in {32, 64}, rmax in
// {16, 32} query rows per block. With n_split > 1, ``scratch`` holds
// n_split * R_total * (C + 2) floats (R_total = query rows). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int mla_attention_launch(
    const void* q_eff, const void* q_pe, void* o, float* m_out, float* l_out,
    const void* cc, const void* pc, const int* tables, const int* seq_lens,
    const int* hist, const int* valid, int B, int T, int H, int N, int bs,
    int M, int C, int R, float scale, int out_f32, int rmax, int n_split,
    float* scratch, int dtype, void* stream) {
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
  p.tiles_per_seq = (H + rmax - 1) / rmax;
  p.scale = scale;
  p.out_f32 = out_f32;
  const size_t Rtot = B > 0 ? (size_t)B * H : (size_t)T * H;
  if (Rtot == 0) return 0;
  if (B == 0 && (hist == nullptr || tables == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_tiles =
      B > 0 ? B * p.tiles_per_seq : (int)((Rtot + rmax - 1) / rmax);
  p.n_split = n_split > 1 ? n_split : 1;
  p.part_o = scratch;
  p.part_m = scratch + (size_t)p.n_split * Rtot * C;
  p.part_l = p.part_m + (size_t)p.n_split * Rtot;
  if (p.n_split > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_typed<float>(p, C, R, rmax, n_tiles, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(p, C, R, rmax, n_tiles, st);
  return (int)cudaErrorInvalidValue;
}
