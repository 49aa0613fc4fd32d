// In-place append of new tokens' K/V, all layers at once: T consecutive
// rows per sequence (T = 1 for decode).
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
// What bounds it on an H100: bytes, and at these sizes launch latency. It
// reads L * B * T * Hkv * (Dk + Dv) new values and writes as many into the
// caches (2 MB for Llama-3-8B at B = 8, T = 1; 8.4 MB at T = 4); at
// 3.35 TB/s that is 0.6-2.5 us, under the few microseconds of a launch.
//
// What the design does about it: one launch for all layers (the merged
// decode and the verify batch every layer's new rows into one call instead
// of 2L scatters), grid (L, B), a block's threads striding over its
// sequence's T x Hkv head rows in 16-byte stores (neighbouring threads on
// neighbouring bytes of a row) when every row is a whole number of 16-byte
// words, element stores otherwise. Padded batch rows all point at trash
// page 0; their writes race there harmlessly (page 0 is never read). Live
// rows never race: the allocator gives every sequence its own pages, and
// a sequence's T rows sit at T distinct consecutive positions.
//
// kv_cache_append_quantized_launch replaces the Pallas TPU kernel
// dynamo_tpu/ops/kv_cache_update_pallas.py::kv_cache_append_quantized
// (_append_quant_call / _append_quant_kernel) for the int8-with-scales cache.
// The scale math (each written page's running absmax, the old/new ratio r,
// the new rows quantized against the new scale) runs before it in PyTorch
// (ops/kv_cache_update.quant_scale_update), as it does outside the Pallas
// call. The kernel is the page read-modify-write: one block per (layer,
// sequence) requantizes that page [Hkv, bs, D] in place by r (int8 -> f32,
// times r, rintf = round half to even, clip to +-127) and lands the
// pre-quantized row at `off`, for K and for V. What bounds it: bytes, one
// read and one write of every page whose scale grew (r < 1); a page whose
// scale did not grow (r == 1) would round-trip bit-exactly, so the kernel
// skips its read-modify-write and writes the row alone. Padded batch rows
// all target the trash page 0, and blocks that read-modify-write one page
// in parallel would race, so page 0 is never read-modify-written (its rows
// are still stored; page 0 is never read). Live rows own distinct pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The T rows of one (layer, sequence) into one cache: rows of `w` words
// of type W per head, source [T, Hkv, w] contiguous, destination row of
// head h at slot s: ((l * Hkv + h) * N * bs + s) * w.
template <typename W>
__device__ __forceinline__ void store_rows(const W* __restrict__ src,
                                           W* __restrict__ cache,
                                           const int* __restrict__ blk,
                                           const int* __restrict__ off,
                                           size_t l, int T, int Hkv, int N,
                                           int bs, int w) {
  const int hw = Hkv * w;
  for (int e = threadIdx.x; e < T * hw; e += blockDim.x) {
    const int t = e / hw, r = e % hw;
    const int h = r / w, d = r % w;
    const size_t slot = (size_t)blk[t] * bs + off[t];
    cache[((l * Hkv + h) * N * bs + slot) * w + d] = src[e];
  }
}

// k_new [L, B, T, Hkv, kw], v_new [L, B, T, Hkv, vw] in words of W;
// blk/off [B, T]
template <typename W>
__global__ void kv_cache_append_kernel(const W* __restrict__ k_new,
                                       const W* __restrict__ v_new,
                                       W* __restrict__ k_cache,
                                       W* __restrict__ v_cache,
                                       const int* __restrict__ blk,
                                       const int* __restrict__ off, int B,
                                       int T, int Hkv, int N, int bs, int kw,
                                       int vw) {
  const size_t l = blockIdx.x;
  const int b = blockIdx.y;
  const size_t src = (l * B + b) * T * Hkv;  // first head row of (l, b)
  store_rows(k_new + src * kw, k_cache, blk + b * T, off + b * T, l, T, Hkv,
             N, bs, kw);
  store_rows(v_new + src * vw, v_cache, blk + b * T, off + b * T, l, T, Hkv,
             N, bs, vw);
}

template <typename W>
cudaError_t launch_words(const void* k_new, const void* v_new, void* k_cache,
                         void* v_cache, const int* blk, const int* off, int L,
                         int B, int T, int Hkv, int N, int bs, int kw, int vw,
                         cudaStream_t stream) {
  dim3 grid(L, B);
  kv_cache_append_kernel<W><<<grid, 256, 0, stream>>>(
      static_cast<const W*>(k_new), static_cast<const W*>(v_new),
      static_cast<W*>(k_cache), static_cast<W*>(v_cache), blk, off, B, T,
      Hkv, N, bs, kw, vw);
  return cudaGetLastError();
}

// One (layer, sequence) page: requantize by r unless r == 1 or the page is
// the trash page 0, then store the new row. Bytes of 4 at a time: the
// wrapper checks that D % 4 == 0, so a group never straddles two rows.
__device__ __forceinline__ void requant_page(int8_t* __restrict__ cache,
                                             const int8_t* __restrict__ row,
                                             float r, size_t l, int page,
                                             int off, int Hkv, int N, int bs,
                                             int D) {
  const int per_head = bs * D / 4;  // 4-byte groups per head's page slice
  const bool rmw = page != 0 && r != 1.f;
  for (int e = threadIdx.x; e < Hkv * per_head; e += blockDim.x) {
    const int h = e / per_head, g = e % per_head;
    const int s = g * 4 / D, d = g * 4 % D;
    char4* p = reinterpret_cast<char4*>(
        cache + (((l * Hkv + h) * N + page) * bs + s) * (size_t)D + d);
    if (s == off) {
      *p = *reinterpret_cast<const char4*>(row + (size_t)h * D + d);
    } else if (rmw) {
      const char4 v = *p;
      *p = make_char4(
          (signed char)fminf(fmaxf(rintf((float)v.x * r), -127.f), 127.f),
          (signed char)fminf(fmaxf(rintf((float)v.y * r), -127.f), 127.f),
          (signed char)fminf(fmaxf(rintf((float)v.z * r), -127.f), 127.f),
          (signed char)fminf(fmaxf(rintf((float)v.w * r), -127.f), 127.f));
    }
  }
}

__global__ void kv_cache_append_quant_kernel(
    const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    const float* __restrict__ rk, const float* __restrict__ rv,
    const int* __restrict__ blk, const int* __restrict__ off, int B, int Hkv,
    int N, int bs, int Dk, int Dv) {
  const size_t l = blockIdx.x;
  const int b = blockIdx.y;
  const size_t src = l * B + b;
  requant_page(k_cache, kq + src * Hkv * Dk, rk[src], l, blk[b], off[b], Hkv,
               N, bs, Dk);
  requant_page(v_cache, vq + src * Hkv * Dv, rv[src], l, blk[b], off[b], Hkv,
               N, bs, Dv);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (k_new/v_new and the caches share it). k_new [L, B, T, Hkv, Dk], v_new
// [L, B, T, Hkv, Dv], blk/off [B, T]; the wrapper checks T <= bs. Returns
// the launch's cudaError_t.
extern "C" int kv_cache_append_tokens_launch(
    const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const int* blk, const int* off, int L, int B, int T, int Hkv, int N,
    int bs, int Dk, int Dv, int dtype, void* stream) {
  if (L == 0 || B == 0 || T == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const size_t kb = (size_t)Dk * elem, vb = (size_t)Dv * elem;
  const uintptr_t ptrs = (uintptr_t)k_new | (uintptr_t)v_new |
                         (uintptr_t)k_cache | (uintptr_t)v_cache;
  if (kb % 16 == 0 && vb % 16 == 0 && ptrs % 16 == 0)
    return (int)launch_words<uint4>(k_new, v_new, k_cache, v_cache, blk, off,
                                    L, B, T, Hkv, N, bs, (int)(kb / 16),
                                    (int)(vb / 16), st);
  if (dtype == 0)
    return (int)launch_words<float>(k_new, v_new, k_cache, v_cache, blk, off,
                                    L, B, T, Hkv, N, bs, Dk, Dv, st);
  return (int)launch_words<__nv_bfloat16>(k_new, v_new, k_cache, v_cache,
                                          blk, off, L, B, T, Hkv, N, bs, Dk,
                                          Dv, st);
}

// The quantized append: kq/vq [L, B, Hkv, D] int8 rows already quantized
// against the new scales, rk/rv [L, B] f32 old/new scale ratios, caches
// [L, Hkv, N, bs, D] int8 updated in place. D % 4 == 0 (the wrapper
// checks). Returns the launch's cudaError_t.
extern "C" int kv_cache_append_quantized_launch(
    const void* kq, const void* vq, void* k_cache, void* v_cache,
    const float* rk, const float* rv, const int* blk, const int* off, int L,
    int B, int Hkv, int N, int bs, int Dk, int Dv, void* stream) {
  if (L == 0 || B == 0) return 0;
  if (Dk % 4 || Dv % 4) return (int)cudaErrorInvalidValue;
  dim3 grid(L, B);
  kv_cache_append_quant_kernel<<<grid, 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache), rk, rv,
      blk, off, B, Hkv, N, bs, Dk, Dv);
  return (int)cudaGetLastError();
}
