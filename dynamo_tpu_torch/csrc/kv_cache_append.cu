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
