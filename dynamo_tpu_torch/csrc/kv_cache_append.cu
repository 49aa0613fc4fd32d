// In-place KV-cache appends, all layers in one launch per call, for sm_90a.
//
// 1. The row store: T consecutive rows per sequence (T = 1 for decode).
//
// Replaces two Pallas TPU kernels of the JAX package with ONE kernel body:
//   * dynamo_tpu/ops/kv_cache_update_pallas.py::kv_cache_append
//     (_append_call / _append_kernel): one new token per sequence;
//   * dynamo_tpu/ops/kv_cache_update_pallas.py::kv_cache_append_tokens
//     (_append_tokens_kernel): T <= bs consecutive rows per sequence, the
//     speculative verify's in-flight window.
// There, input_output_aliases pin the cache and every grid step
// read-modify-writes a whole page tile, so the multi-token version chains
// two pallas_calls (the window's first page, then the spill into the next)
// with a trash-page passthrough for windows that do not cross. Here a row
// is simply stored where it lands: the wrapper hands the kernel the
// caches' own pointers and the kernel writes one [Hkv, Dk] K row and one
// [Hkv, Dv] V row per (layer, sequence, token) at (blk, off) of that
// token. The two widths differ for MLA, whose k cache holds the latent
// c_kv (Dk = kv_lora_rank) and whose v cache holds the rotated rope key
// (Dv = qk_rope_head_dim), one "head" each; GQA has Dk == Dv.
//
// What bounds it on an H100: bytes, and at these sizes the launch. It
// reads L * B * T * Hkv * (Dk + Dv) new values and writes as many into the
// caches (2 MB for Llama-3-8B at B = 8, T = 1; 8.4 MB at T = 4); at
// 3.35 TB/s that is 0.6-2.5 us, about what an empty launch takes.
//
// What the design does about it: one launch for all layers (the merged
// decode and the verify batch every layer's new rows into one call), and
// one HBM round trip per block. A block owns one (sequence, token) row of
// one layer (grid (B * T, L)): its threads are laid out as the row group,
// x over the words of one head's K row then its V row (Dk + Dv words), y
// over the heads, so each thread loads its one word and stores it, every
// load of the block in flight at once, no index division. The block reads
// its (blk, off) once. 16-byte words where every row and pointer allows
// them, element stores otherwise (an explicit choice of the launch). Padded
// batch rows all point at trash page 0; their writes race there harmlessly
// (page 0 is never read). Live rows never race: the allocator gives every
// sequence its own pages, and a sequence's T rows sit at T distinct
// consecutive positions.
//
// Into a float8_e4m3fn cache (the scale-free fp8 cache) the row store
// casts on store, kv_rows_e4m3_kernel: f32 or bf16 rows, one byte per value
// written, the same grid and thread layout over units of 16 input bytes (8
// bf16 or 4 f32 values, written as 8 or 4 bytes) or single values. The
// cast is the reference's (_append_kernel's .astype(k_out_ref.dtype), XLA's
// convert): round to nearest even, and NaN (0x7F, 0xFF with the sign) for
// |x| > 464, +-inf and NaN. The card's cvt.rn.satfinite.e4m3x2.f32 gives
// the same bytes below that and saturates above it (to +-448), so the
// kernel writes the NaN bytes itself there (e4m3_byte).
//
// 2. The quantized append, kv_cache_append_quantized_launch: the whole
// function in one launch.
//
// Replaces the Pallas TPU kernel
// dynamo_tpu/ops/kv_cache_update_pallas.py::kv_cache_append_quantized
// (_append_quant_call / _append_quant_kernel, with quant_scale_update and
// n_requants fused around it by XLA into one dispatch) for the
// int8-with-scales cache. For K and for V it computes, per layer l and row b:
// amax = max |x[l, b]| * f32(1/127); each written page's scale grows to
// new = max(old, max over its rows of max(amax, 1e-12)); the resident page
// is requantized by r = old / new (rint(code * r), clipped to +-127); the
// row lands as rint(x / new), clipped; n_requants counts the (layer, page)
// entries with new > old, K and V summed. IEEE division, rintf, no fast
// math: bit-exact with the reference's jitted arithmetic.
//
// What bounds it: bytes, one read of the new rows, one read and one write
// of every page whose scale grew, the int8 rows and the plane entries
// written (at Llama-3-8B's widths, B = 8, 32 layers: 1 MB of bf16 rows and
// 16 KB per grown page and cache), so at decode sizes the launch and the
// latency of the two dependent HBM round trips (rows, then the pages).
//
// The design: blocks own pages. Block (b, l, c) takes row b of layer l for
// cache c (K or V); it owns page p = blk[b] when b is the first row of the
// batch on p, found by a scan of blk. Live rows own distinct pages (the
// allocator's invariant), so a live block reads its row, reduces the amax
// in the block, reads its old scale and writes the new one: no atomics, no
// order between blocks. Padded rows all share the trash page 0, whose one
// owner per layer (the first padded row) reduces over every padded row,
// sets page 0's scale and flag and stores their rows (never read); the
// other blocks on a page write nothing but their flag, 0. The rows of a
// page are listed by a ballot over blk in batch order. A page whose scale grew (and
// is not page 0) is read-modify-written in 16-byte words, each thread
// loading all of its words before it stores any (16 KB per page and cache
// at Llama widths: 8 words per thread, one round trip); a page that did not
// grow (r == 1 would round-trip every code exactly) stores only its row.
// The page walk carries (head, word) from word to word, so no word pays a
// division. n_requants in the same launch: each block writes a 0/1 flag as
// soon as its scale is known and takes a ticket (an integer atomic) before
// it stores any code, so its fence waits for the flag alone; the last block
// to take one sums the flags in a fixed order at its end, writes the scalar
// and resets the ticket. Head dims that are multiples of 16 take the
// 16-byte path; others an explicit element path (one value, one code byte
// at a time).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------- 1. the row store ----------------

// k_new [L, B * T, Hkv, kw], v_new [L, B * T, Hkv, vw] in words of W; the
// caches [L, Hkv, N, bs, kw | vw]; blk/off [B * T]
template <typename W>
__global__ void kv_rows_kernel(const W* __restrict__ k_new,
                               const W* __restrict__ v_new,
                               W* __restrict__ k_cache,
                               W* __restrict__ v_cache,
                               const int* __restrict__ blk,
                               const int* __restrict__ off, int BT, int Hkv,
                               int N, int bs, int kw, int vw) {
  const int bt = blockIdx.x;
  const size_t l = blockIdx.y;
  const size_t slot = (size_t)blk[bt] * bs + off[bt];
  const size_t src = (l * BT + bt) * Hkv;  // first head row of the row group
  const int w = kw + vw;
  for (int h = threadIdx.y; h < Hkv; h += blockDim.y) {
    const size_t dst = (l * Hkv + h) * N * bs + slot;  // head h's cache row
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
      if (x < kw)
        k_cache[dst * kw + x] = k_new[(src + h) * kw + x];
      else
        v_cache[dst * vw + (x - kw)] = v_new[(src + h) * vw + (x - kw)];
    }
  }
}

template <typename W>
cudaError_t launch_rows(const void* k_new, const void* v_new, void* k_cache,
                        void* v_cache, const int* blk, const int* off, int L,
                        int BT, int Hkv, int N, int bs, int kw, int vw,
                        cudaStream_t stream) {
  const int bx = kw + vw < 1024 ? kw + vw : 1024;
  const int by = 1024 / bx < Hkv ? 1024 / bx : Hkv;
  kv_rows_kernel<W><<<dim3(BT, L), dim3(bx, by), 0, stream>>>(
      static_cast<const W*>(k_new), static_cast<const W*>(v_new),
      static_cast<W*>(k_cache), static_cast<W*>(v_cache), blk, off, BT, Hkv,
      N, bs, kw, vw);
  return cudaGetLastError();
}

// ---------------- 2. the quantized append ----------------

constexpr int kThreads = 128;   // per block
constexpr int kWarps = kThreads / 32;
constexpr int kPageWords = 8;   // page words a thread holds in flight
constexpr float kInvQmax = 1.0f / 127.0f;  // the reference's f32 reciprocal
constexpr float kEps = 1e-12f;

__device__ __forceinline__ signed char code(float v) {
  return (signed char)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack4(const signed char* q) {
  return (uint32_t)(uint8_t)q[0] | (uint32_t)(uint8_t)q[1] << 8 |
         (uint32_t)(uint8_t)q[2] << 16 | (uint32_t)(uint8_t)q[3] << 24;
}

__device__ __forceinline__ uint32_t requant4(uint32_t w, float r) {
  signed char q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = code((float)(int8_t)(w >> (8 * k)) * r);
  return pack4(q);
}

__device__ __forceinline__ uint4 requant(uint4 v, float r) {
  return make_uint4(requant4(v.x, r), requant4(v.y, r), requant4(v.z, r),
                    requant4(v.w, r));
}

__device__ __forceinline__ int8_t requant(int8_t v, float r) {
  return code((float)v * r);
}

// U consecutive values of a new row, widened to f32: one 16-byte word
// (U = 16 / sizeof(T)) or one value (U = 1)
template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* p, float (&f)[U]) {
  if constexpr (U == 1) {
    if constexpr (sizeof(T) == 2)
      f[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
    else
      f[0] = *reinterpret_cast<const float*>(p);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h2[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
}

// the U codes of f / s at dst (aligned to U bytes)
template <int U>
__device__ __forceinline__ void store_codes(int8_t* dst, const float (&f)[U],
                                            float s) {
  signed char q[U];
#pragma unroll
  for (int i = 0; i < U; ++i) q[i] = code(f[i] / s);
  if constexpr (U == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(q), pack4(q + 4));
  else if constexpr (U == 4)
    *reinterpret_cast<uint32_t*>(dst) = pack4(q);
  else
    *dst = q[0];
}

// (head, index) of a thread's item in a [heads, per] walk that moves by
// kThreads items a step: carried from step to step, never divided
struct Walk {
  int h, i;
  __device__ __forceinline__ Walk(int start, int per) : h(0), i(start) {
    while (i >= per) i -= per, ++h;
  }
  __device__ __forceinline__ void step(int per) {
    i += kThreads;
    while (i >= per) i -= per, ++h;
  }
};

// The rows j0 <= j < min(j0 + kThreads, B) of the batch on page p, listed
// in s_rows in batch order (a ballot per warp); returns how many.
__device__ __forceinline__ int page_rows(const int* __restrict__ blk, int j0,
                                         int B, int p, int* s_rows,
                                         int* s_cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = j0 + tid;
  const bool mine = j < B && blk[j] == p;
  const unsigned bal = __ballot_sync(0xffffffffu, mine);
  if (lane == 0) s_cnt[warp] = __popc(bal);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_cnt[w] : 0;
    total += s_cnt[w];
  }
  if (mine) s_rows[base + __popc(bal & ((1u << lane) - 1u))] = j;
  __syncthreads();
  return total;
}

// Requantize by r the Hkv slices of one page (head h's at page + h *
// stride bytes, wph words of PW each), skipping the words [skip, skip +
// wpr) of the row that the new row replaces. Each thread loads its
// kPageWords words before it stores any.
template <typename PW>
__device__ __forceinline__ void requant_page(int8_t* __restrict__ page,
                                             size_t stride, int Hkv, int wph,
                                             int wpr, int skip, float r) {
  Walk w(threadIdx.x, wph);
  for (int done = 0; done < Hkv * wph; done += kThreads * kPageWords) {
    PW v[kPageWords];
    PW* at[kPageWords];
    bool ok[kPageWords];
#pragma unroll
    for (int k = 0; k < kPageWords; ++k) {
      ok[k] = w.h < Hkv && (unsigned)(w.i - skip) >= (unsigned)wpr;
      at[k] = reinterpret_cast<PW*>(page + w.h * stride) + w.i;
      if (ok[k]) v[k] = *at[k];
      w.step(wph);
    }
#pragma unroll
    for (int k = 0; k < kPageWords; ++k)
      if (ok[k]) *at[k] = requant(v[k], r);
  }
}

// Grid (B, L, 2): block (b, l, c) takes row b of layer l for cache c (0 =
// K, 1 = V). x_new [L, B, Hkv, D] rows of T, caches [L, Hkv, N, bs, D]
// int8, scales [L, N] f32 grown in place; flags [2 * L * B] scratch.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) kv_append_quant_kernel(
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    float* __restrict__ k_scales, float* __restrict__ v_scales,
    const int* __restrict__ blk, const int* __restrict__ off,
    int* __restrict__ flags, int* __restrict__ ticket,
    int* __restrict__ n_requants, int B, int Hkv, int N, int bs, int Dk,
    int Dv) {
  constexpr int U = VEC ? 16 / (int)sizeof(T) : 1;  // values per row unit
  __shared__ int s_rows[kThreads];
  __shared__ int s_cnt[kWarps];
  __shared__ float s_red[kWarps];
  __shared__ bool s_last;
  const int tid = threadIdx.x, b = blockIdx.x, c = blockIdx.z;
  const int l = blockIdx.y, L = gridDim.y;
  const int D = c ? Dv : Dk;
  const int uph = D / U, units = Hkv * uph;
  const T* x = (c ? v_new : k_new) + (size_t)l * B * Hkv * D;
  int8_t* cache = c ? v_cache : k_cache;
  float* scale = (c ? v_scales : k_scales) + (size_t)l * N;
  const int p = blk[b];
  const float old = scale[p];
  bool dup = false;
  for (int j = tid; j < b; j += kThreads) dup |= blk[j] == p;
  const bool owner = !__syncthreads_or(dup);  // of page p in layer l
  float s = old, r = 1.f;
  if (owner) {
    float m = 0.f;
    for (int j0 = b; j0 < B; j0 += kThreads) {
      const int n = page_rows(blk, j0, B, p, s_rows, s_cnt);
      for (int u = tid; u < units; u += kThreads) {
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          float f[U];
          load_unit<T, U>(x + ((size_t)s_rows[k] * units + u) * U, f);
#pragma unroll
          for (int i = 0; i < U; ++i) m = fmaxf(m, fabsf(f[i]));
        }
      }
      __syncthreads();  // s_rows is listed again
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 31) == 0) s_red[tid >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_red[w]);
    s = fmaxf(old, fmaxf(m * kInvQmax, kEps));
    r = old / s;
  }
  // n_requants: this block's flag and its ticket, taken before any code is
  // stored, so the fence waits for the flag alone
  const int nblocks = 2 * L * B;
  if (tid == 0) {
    flags[((size_t)c * L + l) * B + b] = s > old;
    __threadfence();  // the flag is visible device-wide before the ticket
    s_last = atomicAdd(ticket, 1) == nblocks - 1;
  }
  if (owner) {
    if (tid == 0 && s > old) scale[p] = s;
    int8_t* page = cache + ((size_t)l * Hkv * N + p) * bs * D;
    const size_t stride = (size_t)N * bs * D;  // head to head
    if (p != 0 && r != 1.f) {
      if constexpr (VEC)
        requant_page<uint4>(page, stride, Hkv, bs * D / 16, D / 16,
                            off[b] * (D / 16), r);
      else
        requant_page<int8_t>(page, stride, Hkv, bs * D, D, off[b] * D, r);
      __syncthreads();  // a page with several rows: theirs land after it
    }
    for (int j0 = b; j0 < B; j0 += kThreads) {
      const int n = page_rows(blk, j0, B, p, s_rows, s_cnt);
      Walk v(tid, uph);
      for (int u = tid; u < units; u += kThreads, v.step(uph)) {
        int8_t* head = page + v.h * stride + v.i * U;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const int row = s_rows[k];
          float f[U];
          load_unit<T, U>(x + ((size_t)row * units + u) * U, f);
          store_codes<U>(head + (size_t)off[row] * D, f, s);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();  // s_last
  if (!s_last) return;
  __threadfence();
  int sum = 0;
  for (int i = tid; i < nblocks; i += kThreads) sum += __ldcg(flags + i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if ((tid & 31) == 0) s_cnt[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
    *n_requants = total;
    *ticket = 0;  // ready for the next launch
  }
}

template <typename T>
cudaError_t launch_quant(bool vec, const void* k_new, const void* v_new,
                         void* k_cache, void* v_cache, void* k_scales,
                         void* v_scales, const int* blk, const int* off,
                         void* flags, void* ticket, void* n_requants, int L,
                         int B, int Hkv, int N, int bs, int Dk, int Dv,
                         cudaStream_t st) {
  auto kernel = vec ? kv_append_quant_kernel<T, true>
                    : kv_append_quant_kernel<T, false>;
  kernel<<<dim3(B, L, 2), kThreads, 0, st>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scales), static_cast<float*>(v_scales), blk, off,
      static_cast<int*>(flags), static_cast<int*>(ticket),
      static_cast<int*>(n_requants), B, Hkv, N, bs, Dk, Dv);
  return cudaGetLastError();
}

// ---------------- 3. the row store into an fp8 cache ----------------

// float -> the float8_e4m3fn byte the reference stores
__device__ __forceinline__ uint32_t e4m3_byte(float x) {
  const uint32_t code = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return fabsf(x) <= 464.f ? code : 0x7Fu | (__float_as_uint(x) >> 24 & 0x80u);
}

// k_new [L, B * T, Hkv, Dk] rows of T, v_new [..., Dv]; the caches [L,
// Hkv, N, bs, Dk | Dv] of bytes; kw / vw: units of U values per head row
template <typename T, int U>
__global__ void kv_rows_e4m3_kernel(const T* __restrict__ k_new,
                                    const T* __restrict__ v_new,
                                    uint8_t* __restrict__ k_cache,
                                    uint8_t* __restrict__ v_cache,
                                    const int* __restrict__ blk,
                                    const int* __restrict__ off, int BT,
                                    int Hkv, int N, int bs, int kw, int vw) {
  const int bt = blockIdx.x;
  const size_t l = blockIdx.y;
  const size_t slot = (size_t)blk[bt] * bs + off[bt];
  const size_t src = (l * BT + bt) * Hkv;
  const int w = kw + vw;
  for (int h = threadIdx.y; h < Hkv; h += blockDim.y) {
    const size_t dst = (l * Hkv + h) * N * bs + slot;
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
      const bool k = x < kw;
      const int u = k ? x : x - kw, uw = k ? kw : vw;
      float f[U];
      load_unit<T, U>((k ? k_new : v_new) + ((src + h) * uw + u) * U, f);
      uint8_t* out = (k ? k_cache : v_cache) + (dst * uw + u) * U;
      uint32_t b[U];
#pragma unroll
      for (int i = 0; i < U; ++i) b[i] = e4m3_byte(f[i]);
      if constexpr (U == 8)
        *reinterpret_cast<uint2*>(out) =
            make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                       b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
      else if constexpr (U == 4)
        *reinterpret_cast<uint32_t*>(out) =
            b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
      else
        *out = (uint8_t)b[0];
    }
  }
}

template <typename T, int U>
cudaError_t launch_rows_e4m3(const void* k_new, const void* v_new,
                             void* k_cache, void* v_cache, const int* blk,
                             const int* off, int L, int BT, int Hkv, int N,
                             int bs, int Dk, int Dv, cudaStream_t stream) {
  const int kw = Dk / U, vw = Dv / U;
  const int bx = kw + vw < 1024 ? kw + vw : 1024;
  const int by = 1024 / bx < Hkv ? 1024 / bx : Hkv;
  kv_rows_e4m3_kernel<T, U><<<dim3(BT, L), dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<uint8_t*>(k_cache), static_cast<uint8_t*>(v_cache), blk,
      off, BT, Hkv, N, bs, kw, vw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_e4m3(const void* k_new, const void* v_new, void* k_cache,
                        void* v_cache, const int* blk, const int* off, int L,
                        int BT, int Hkv, int N, int bs, int Dk, int Dv,
                        cudaStream_t st) {
  constexpr int U = 16 / sizeof(T);  // values per 16 input bytes
  const uintptr_t in = (uintptr_t)k_new | (uintptr_t)v_new;
  const uintptr_t out = (uintptr_t)k_cache | (uintptr_t)v_cache;
  if (Dk % U == 0 && Dv % U == 0 && in % 16 == 0 && out % U == 0)
    return launch_rows_e4m3<T, U>(k_new, v_new, k_cache, v_cache, blk, off,
                                  L, BT, Hkv, N, bs, Dk, Dv, st);
  return launch_rows_e4m3<T, 1>(k_new, v_new, k_cache, v_cache, blk, off, L,
                                BT, Hkv, N, bs, Dk, Dv, st);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// the rows' type; the caches share it, or with cache_fp8 = 1 they are
// float8_e4m3fn (cast on store). k_new [L, B, T, Hkv, Dk], v_new [L, B, T,
// Hkv, Dv], blk/off [B, T]; the wrapper checks T <= bs. Returns the
// launch's cudaError_t.
extern "C" int kv_cache_append_tokens_launch(
    const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const int* blk, const int* off, int L, int B, int T, int Hkv, int N,
    int bs, int Dk, int Dv, int dtype, int cache_fp8, void* stream) {
  if (L == 0 || B == 0 || T == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_fp8) {
    if (dtype == 0)
      return (int)launch_e4m3<float>(k_new, v_new, k_cache, v_cache, blk, off,
                                     L, B * T, Hkv, N, bs, Dk, Dv, st);
    return (int)launch_e4m3<__nv_bfloat16>(k_new, v_new, k_cache, v_cache,
                                           blk, off, L, B * T, Hkv, N, bs,
                                           Dk, Dv, st);
  }
  const int elem = dtype == 0 ? 4 : 2;
  const size_t kb = (size_t)Dk * elem, vb = (size_t)Dv * elem;
  const uintptr_t ptrs = (uintptr_t)k_new | (uintptr_t)v_new |
                         (uintptr_t)k_cache | (uintptr_t)v_cache;
  if (kb % 16 == 0 && vb % 16 == 0 && ptrs % 16 == 0)
    return (int)launch_rows<uint4>(k_new, v_new, k_cache, v_cache, blk, off,
                                   L, B * T, Hkv, N, bs, (int)(kb / 16),
                                   (int)(vb / 16), st);
  if (dtype == 0)
    return (int)launch_rows<float>(k_new, v_new, k_cache, v_cache, blk, off,
                                   L, B * T, Hkv, N, bs, Dk, Dv, st);
  return (int)launch_rows<__nv_bfloat16>(k_new, v_new, k_cache, v_cache, blk,
                                         off, L, B * T, Hkv, N, bs, Dk, Dv,
                                         st);
}

// The quantized append: k_new [L, B, Hkv, Dk] / v_new [L, B, Hkv, Dv] rows
// of dtype (0 = float32, 1 = bfloat16), caches [L, Hkv, N, bs, D] int8 and
// planes k_scales / v_scales [L, N] f32, all updated in place; blk/off [B];
// flags: 2 * L * B ints of scratch; ticket: one int, 0 before and after
// the launch; n_requants: the int32 count written. Returns the launch's
// cudaError_t.
extern "C" int kv_cache_append_quantized_launch(
    const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    void* k_scales, void* v_scales, const int* blk, const int* off,
    void* flags, void* ticket, void* n_requants, int L, int B, int Hkv,
    int N, int bs, int Dk, int Dv, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 0 || B == 0)
    return (int)cudaMemsetAsync(n_requants, 0, sizeof(int), st);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)k_new | (uintptr_t)v_new |
                         (uintptr_t)k_cache | (uintptr_t)v_cache;
  const bool vec = Dk % 16 == 0 && Dv % 16 == 0 && ptrs % 16 == 0;
  if (dtype == 0)
    return (int)launch_quant<float>(vec, k_new, v_new, k_cache, v_cache,
                                    k_scales, v_scales, blk, off, flags,
                                    ticket, n_requants, L, B, Hkv, N, bs, Dk,
                                    Dv, st);
  return (int)launch_quant<__nv_bfloat16>(vec, k_new, v_new, k_cache, v_cache,
                                          k_scales, v_scales, blk, off, flags,
                                          ticket, n_requants, L, B, Hkv, N, bs,
                                          Dk, Dv, st);
}
