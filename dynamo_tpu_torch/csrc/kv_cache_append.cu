// In-place append of one new token's K/V per sequence, all layers at once.
//
// Replaces the Pallas TPU kernel
// dynamo_tpu/ops/kv_cache_update_pallas.py::kv_cache_append (_append_call /
// _append_kernel): there, input_output_aliases pin the cache so only the
// touched page tiles move (a read-modify-write of each page). Here the cache
// is simply written in place: the wrapper hands the kernel the cache's own
// pointers and the kernel stores one [Hkv, Dk] K row and one [Hkv, Dv] V row
// per (layer, sequence). The two widths differ for MLA, whose k cache holds
// the latent c_kv (Dk = kv_lora_rank) and whose v cache holds the rotated
// rope key (Dv = qk_rope_head_dim), one "head" each; GQA has Dk == Dv.
//
// What bounds it on an H100: bytes, and at decode sizes launch latency. It
// reads L * B * Hkv * (Dk + Dv) new values and writes as many into the
// caches (about 1 MB per step for Llama-3-8B at B = 8, 0.25 MB for
// DeepSeek-V2-Lite); at 3.35 TB/s that is well under the few microseconds
// one launch costs.
//
// What the design does about it: one launch for all layers (the merged
// decode path batches every layer's new K/V into one call instead of 2L
// scatters), grid (L, B), threads striding over Hkv * max(Dk, Dv) so
// neighbouring threads store neighbouring elements of one cache row. Padded
// batch rows all point at trash page 0; their writes race there harmlessly
// (page 0 is never read). Live rows have distinct pages (the allocator gives
// every sequence its own tail page), so they never race.
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

template <typename T>
__global__ void kv_cache_append_kernel(const T* __restrict__ k_new,
                                       const T* __restrict__ v_new,
                                       T* __restrict__ k_cache,
                                       T* __restrict__ v_cache,
                                       const int* __restrict__ blk,
                                       const int* __restrict__ off, int B,
                                       int Hkv, int N, int bs, int Dk,
                                       int Dv) {
  const int l = blockIdx.x;
  const int b = blockIdx.y;
  const size_t slot = (size_t)blk[b] * bs + off[b];
  const int kw = Hkv * Dk, vw = Hkv * Dv;
  const size_t src = (size_t)l * B + b;
  for (int e = threadIdx.x; e < kw; e += blockDim.x) {
    const int h = e / Dk, d = e % Dk;
    k_cache[(((size_t)l * Hkv + h) * N * bs + slot) * Dk + d] =
        k_new[src * kw + e];
  }
  for (int e = threadIdx.x; e < vw; e += blockDim.x) {
    const int h = e / Dv, d = e % Dv;
    v_cache[(((size_t)l * Hkv + h) * N * bs + slot) * Dv + d] =
        v_new[src * vw + e];
  }
}

template <typename T>
cudaError_t launch_typed(const void* k_new, const void* v_new, void* k_cache,
                         void* v_cache, const int* blk, const int* off, int L,
                         int B, int Hkv, int N, int bs, int Dk, int Dv,
                         cudaStream_t stream) {
  dim3 grid(L, B);
  kv_cache_append_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), blk, off, B, Hkv,
      N, bs, Dk, Dv);
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
// (k_new/v_new and the caches share it). k rows are Dk wide, v rows Dv.
// Returns the launch's cudaError_t.
extern "C" int kv_cache_append_launch(const void* k_new, const void* v_new,
                                      void* k_cache, void* v_cache,
                                      const int* blk, const int* off, int L,
                                      int B, int Hkv, int N, int bs, int Dk,
                                      int Dv, int dtype, void* stream) {
  if (L == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(k_new, v_new, k_cache, v_cache, blk, off,
                                    L, B, Hkv, N, bs, Dk, Dv, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(k_new, v_new, k_cache, v_cache,
                                            blk, off, L, B, Hkv, N, bs, Dk,
                                            Dv, st);
  return (int)cudaErrorInvalidValue;
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
