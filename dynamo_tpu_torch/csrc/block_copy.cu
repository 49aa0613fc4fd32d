// Block copies between the paged KV cache and contiguous block stacks, for
// sm_90a: the device half of the host-DRAM and disk KV tiers.
//
// Replaces no Pallas kernel. The JAX package moves tier blocks with XLA
// gathers and scatters under jax.jit, outside any Pallas kernel
// (dynamo_tpu/engine/offload.py: gather_blocks_core :125,
// gather_blocks_s_core :185, scatter_blocks_core :132,
// scatter_blocks_q_core :163, scatter_blocks_adopt_core :209,
// scatter_blocks_requant_core :231); the system it models does the same
// work with a hand-written CUDA copy kernel (block_copy.cu). Four entry
// points, one per core family:
//
//   * block_gather_launch: pages [L, H, N, bs, D] at n indices -> a
//     contiguous [L, H, n, bs, D] stack, for K and V (their H and D may
//     differ: MLA's latent c_kv and rope key), with the int8 cache's
//     [L, N] f32 scale planes riding along as [L, n] stacks. It moves
//     bytes, so one body serves f32, bf16, int8, e4m3 and any D.
//   * block_scatter_launch: the inverse, in place. m <= n stack rows land
//     at the first m indices; the n - m pad indices (the trash page 0) get
//     zeros, as the reference's device-side jnp.pad lands them. With the
//     planes it is the adopt core: codes land verbatim and the carried
//     scales are written clamped to 1e-12 (pad rows: 1e-12).
//   * block_scatter_dequant_launch: int8 or e4m3 codes times the
//     per-(layer, block) f32 scale, cast to the cache's f32, bf16 or e4m3
//     (round to nearest even; into e4m3 the reference's bytes, NaN above
//     464, as csrc/kv_cache_append.cu's e4m3_byte).
//   * block_scatter_requant_launch: into the int8 cache, dequantize with
//     the carried scales (ones for a full-width payload), take a fresh
//     absmax per (layer, block) over H x bs x D, scale = max(amax *
//     f32(1/127), 1e-12) (XLA's form of the reference's amax / 127), codes
//     = clip(rint(x / scale), +-127); codes and plane scales land
//     together. IEEE division, rintf, no fast math: bit-equal to the plain
//     twin and to the reference's jitted arithmetic.
//
// What bounds it on an H100: bytes. A gather or scatter of n pages reads
// and writes n * L * (Hk * page_k + Hv * page_v) bytes each way (64 pages
// of Llama-3-8B at bf16: 128 MiB read, 128 MiB written, 80 us at
// 3.35 TB/s).
//
// The design: one block per (index i, layer l, cache c), grid (n, L, 2).
// The block owns the H page rows of its (i, l, c), each bs * D * size
// contiguous bytes at both ends, so it streams H * page bytes with no
// index arithmetic beyond one load of idx[i]; the copy and dequantize
// bodies lay threads out as (x over the units of a head's page, y over
// heads). The copies move 16 bytes a thread at a time where every page
// size and pointer allows (8, 4, 2 or 1 bytes otherwise; the launch picks
// the widest). The dequantize and requantize bodies take units of 8
// elements (one 8-byte code load, one 16- or 32-byte store) where a page
// holds a multiple of 8 elements, else single elements. The requant block
// (256 threads in one dimension, every warp full for its shuffles)
// reduces its absmax (NaN propagates, as jnp.max does), then quantizes in
// a second pass over the same bytes (an L2 hit at these sizes). Pad
// indices all point at page 0 and race there harmlessly (page 0 is never
// read).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;
constexpr float kQmax = 127.0f;
// amax / 127 as the reference's jitted core computes it: XLA turns the
// division by a constant into a product with its f32 reciprocal
constexpr float kInvQmax = 1.0f / 127.0f;

struct Geometry {
  int H, w;  // heads, units (words or element groups) per head page
};

__host__ __device__ __forceinline__ Geometry geometry(int c, int Hk, int Hv,
                                                      int kw, int vw) {
  return c ? Geometry{Hv, vw} : Geometry{Hk, kw};
}

dim3 block_dims(int Hk, int Hv, int kw, int vw) {
  const int w = kw > vw ? kw : vw;
  const int H = Hk > Hv ? Hk : Hv;
  const int bx = w < kThreads ? w : kThreads;
  int by = kThreads / bx;
  if (by > H) by = H;
  return dim3(bx, by < 1 ? 1 : by);
}

// ---------------- gather / scatter: bytes ----------------

// grid (n, L, 2); caches [L, H, N, w] words, stacks [L, H, rows, w]
template <typename W>
__global__ void gather_kernel(const W* __restrict__ k_cache,
                              const W* __restrict__ v_cache,
                              W* __restrict__ kg, W* __restrict__ vg,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales,
                              float* __restrict__ ksg, float* __restrict__ vsg,
                              const int* __restrict__ idxs, int n, int N,
                              int Hk, int Hv, int kw, int vw) {
  const int i = blockIdx.x, c = blockIdx.z;
  const size_t l = blockIdx.y;
  const Geometry g = geometry(c, Hk, Hv, kw, vw);
  const W* src = c ? v_cache : k_cache;
  W* dst = c ? vg : kg;
  const size_t page = idxs[i];
  for (int h = threadIdx.y; h < g.H; h += blockDim.y) {
    const W* s = src + ((l * g.H + h) * N + page) * g.w;
    W* d = dst + ((l * g.H + h) * n + i) * g.w;
#pragma unroll 4
    for (int x = threadIdx.x; x < g.w; x += blockDim.x) d[x] = s[x];
  }
  if (k_scales != nullptr && threadIdx.x == 0 && threadIdx.y == 0) {
    const float* plane = c ? v_scales : k_scales;
    (c ? vsg : ksg)[l * n + i] = plane[l * N + page];
  }
}

// grid (n, L, 2); stacks [L, H, m, w]; rows i >= m land zeros
template <typename W>
__global__ void scatter_kernel(W* __restrict__ k_cache, W* __restrict__ v_cache,
                               const W* __restrict__ kd,
                               const W* __restrict__ vd,
                               float* __restrict__ k_scales,
                               float* __restrict__ v_scales,
                               const float* __restrict__ ks,
                               const float* __restrict__ vs,
                               const int* __restrict__ idxs, int m, int N,
                               int Hk, int Hv, int kw, int vw) {
  const int i = blockIdx.x, c = blockIdx.z;
  const size_t l = blockIdx.y;
  const Geometry g = geometry(c, Hk, Hv, kw, vw);
  W* dst = c ? v_cache : k_cache;
  const W* src = c ? vd : kd;
  const size_t page = idxs[i];
  const W zero{};
  for (int h = threadIdx.y; h < g.H; h += blockDim.y) {
    W* d = dst + ((l * g.H + h) * N + page) * g.w;
    if (i < m) {
      const W* s = src + ((l * g.H + h) * m + i) * g.w;
#pragma unroll 4
      for (int x = threadIdx.x; x < g.w; x += blockDim.x) d[x] = s[x];
    } else {
      for (int x = threadIdx.x; x < g.w; x += blockDim.x) d[x] = zero;
    }
  }
  if (k_scales != nullptr && threadIdx.x == 0 && threadIdx.y == 0) {
    const float s = i < m ? (c ? vs : ks)[l * m + i] : 0.f;
    (c ? v_scales : k_scales)[l * N + page] = isnan(s) ? s : fmaxf(s, kEps);
  }
}

template <typename W>
cudaError_t launch_gather(const void* k_cache, const void* v_cache,
                          const void* k_scales, const void* v_scales,
                          const int* idxs, void* kg, void* vg, void* ksg,
                          void* vsg, int L, int Hk, int Hv, int N, int n,
                          int kb, int vb, cudaStream_t st) {
  const int kw = kb / (int)sizeof(W), vw = vb / (int)sizeof(W);
  gather_kernel<W><<<dim3(n, L, 2), block_dims(Hk, Hv, kw, vw), 0, st>>>(
      static_cast<const W*>(k_cache), static_cast<const W*>(v_cache),
      static_cast<W*>(kg), static_cast<W*>(vg),
      static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
      static_cast<float*>(ksg), static_cast<float*>(vsg), idxs, n, N, Hk, Hv,
      kw, vw);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_scatter(void* k_cache, void* v_cache, void* k_scales,
                           void* v_scales, const int* idxs, const void* kd,
                           const void* vd, const void* ks, const void* vs,
                           int L, int Hk, int Hv, int N, int n, int m, int kb,
                           int vb, cudaStream_t st) {
  const int kw = kb / (int)sizeof(W), vw = vb / (int)sizeof(W);
  scatter_kernel<W><<<dim3(n, L, 2), block_dims(Hk, Hv, kw, vw), 0, st>>>(
      static_cast<W*>(k_cache), static_cast<W*>(v_cache),
      static_cast<const W*>(kd), static_cast<const W*>(vd),
      static_cast<float*>(k_scales), static_cast<float*>(v_scales),
      static_cast<const float*>(ks), static_cast<const float*>(vs), idxs, m, N,
      Hk, Hv, kw, vw);
  return cudaGetLastError();
}

// the widest word every page size and pointer is a multiple of
int word_bytes(int kb, int vb, uintptr_t ptrs) {
  for (int w = 16; w > 1; w /= 2)
    if (kb % w == 0 && vb % w == 0 && ptrs % w == 0) return w;
  return 1;
}

// ---------------- dequantize / requantize: elements ----------------

enum Fmt { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3 };

__device__ __forceinline__ float e4m3_to_float(uint8_t b) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(b, __NV_E4M3);
  return __half2float(__half(h));
}

// float -> the float8_e4m3fn byte the reference stores (kv_cache_append.cu)
__device__ __forceinline__ uint8_t e4m3_byte(float x) {
  const uint32_t code = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return (uint8_t)(fabsf(x) <= 464.f
                       ? code
                       : 0x7Fu | (__float_as_uint(x) >> 24 & 0x80u));
}

template <int F>
struct Elem;
template <>
struct Elem<kF32> { using T = float; };
template <>
struct Elem<kBF16> { using T = __nv_bfloat16; };
template <>
struct Elem<kI8> { using T = int8_t; };
template <>
struct Elem<kE4M3> { using T = uint8_t; };

// U consecutive elements of format F at p, widened to f32 (exactly)
template <int F, int U>
__device__ __forceinline__ void load_elems(const typename Elem<F>::T* p,
                                           float (&f)[U]) {
  using T = typename Elem<F>::T;
  T v[U];
  if constexpr (U * sizeof(T) == 32) {
    reinterpret_cast<uint4*>(v)[0] = reinterpret_cast<const uint4*>(p)[0];
    reinterpret_cast<uint4*>(v)[1] = reinterpret_cast<const uint4*>(p)[1];
  } else if constexpr (U * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (U * sizeof(T) == 8) {
    *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < U; ++k) v[k] = p[k];
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if constexpr (F == kF32) f[k] = v[k];
    else if constexpr (F == kBF16) f[k] = __bfloat162float(v[k]);
    else if constexpr (F == kI8) f[k] = (float)v[k];
    else f[k] = e4m3_to_float(v[k]);
  }
}

// U f32 values stored at p in format F (f32, bf16 round to nearest even,
// e4m3 the reference's bytes; int8 takes codes already rounded)
template <int F, int U>
__device__ __forceinline__ void store_elems(typename Elem<F>::T* p,
                                            const float (&f)[U]) {
  using T = typename Elem<F>::T;
  T v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if constexpr (F == kF32) v[k] = f[k];
    else if constexpr (F == kBF16) v[k] = __float2bfloat16_rn(f[k]);
    else if constexpr (F == kI8) v[k] = (int8_t)f[k];
    else v[k] = e4m3_byte(f[k]);
  }
  if constexpr (U * sizeof(T) == 32) {
    reinterpret_cast<uint4*>(p)[0] = reinterpret_cast<const uint4*>(v)[0];
    reinterpret_cast<uint4*>(p)[1] = reinterpret_cast<const uint4*>(v)[1];
  } else if constexpr (U * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else if constexpr (U * sizeof(T) == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
  } else {
#pragma unroll
    for (int k = 0; k < U; ++k) p[k] = v[k];
  }
}

// grid (n, L, 2): codes [L, H, m, e] (e elements per head page, w = e / U
// units) times scale [L, m] -> the cache [L, H, N, e] in format CF
template <int QF, int CF, int U>
__global__ void dequant_kernel(typename Elem<CF>::T* __restrict__ k_cache,
                               typename Elem<CF>::T* __restrict__ v_cache,
                               const typename Elem<QF>::T* __restrict__ kd,
                               const typename Elem<QF>::T* __restrict__ vd,
                               const float* __restrict__ ks,
                               const float* __restrict__ vs,
                               const int* __restrict__ idxs, int m, int N,
                               int Hk, int Hv, int kw, int vw) {
  const int i = blockIdx.x, c = blockIdx.z;
  const size_t l = blockIdx.y;
  const Geometry g = geometry(c, Hk, Hv, kw, vw);
  auto* dst = c ? v_cache : k_cache;
  const auto* src = c ? vd : kd;
  const size_t page = idxs[i];
  const float s = i < m ? (c ? vs : ks)[l * m + i] : 0.f;
  for (int h = threadIdx.y; h < g.H; h += blockDim.y) {
    auto* d = dst + ((l * g.H + h) * N + page) * g.w * U;
    const auto* q = src + ((l * g.H + h) * m + i) * g.w * U;
    for (int x = threadIdx.x; x < g.w; x += blockDim.x) {
      float f[U];
      if (i < m) {
        load_elems<QF, U>(q + x * U, f);
#pragma unroll
        for (int k = 0; k < U; ++k) f[k] *= s;
      } else {
#pragma unroll
        for (int k = 0; k < U; ++k) f[k] = 0.f;
      }
      store_elems<CF, U>(d + x * U, f);
    }
  }
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// clip(rint(v), +-127); NaN -> 0, as XLA's and PyTorch's casts store it
__device__ __forceinline__ float int8_code(float v) {
  return isnan(v) ? 0.f : fminf(fmaxf(rintf(v), -kQmax), kQmax);
}

// grid (n, L, 2), kThreads threads in one dimension (every warp full for
// the shuffles): payload [L, H, m, e] of format F times scale [L, m], a
// fresh absmax scale per (l, block) over its H * e values, int8 codes and
// plane scales landed at idx[i]
template <int F, int U>
__global__ void requant_kernel(int8_t* __restrict__ k_cache,
                               int8_t* __restrict__ v_cache,
                               float* __restrict__ k_scales,
                               float* __restrict__ v_scales,
                               const typename Elem<F>::T* __restrict__ kd,
                               const typename Elem<F>::T* __restrict__ vd,
                               const float* __restrict__ ks,
                               const float* __restrict__ vs,
                               const int* __restrict__ idxs, int m, int N,
                               int Hk, int Hv, int kw, int vw) {
  __shared__ float s_max[kThreads / 32];
  __shared__ float s_scale;
  const int i = blockIdx.x, c = blockIdx.z;
  const size_t l = blockIdx.y;
  const Geometry g = geometry(c, Hk, Hv, kw, vw);
  int8_t* dst = c ? v_cache : k_cache;
  const auto* src = c ? vd : kd;
  const size_t page = idxs[i];
  const float s = i < m ? (c ? vs : ks)[l * m + i] : 0.f;
  const int tid = threadIdx.x;
  const int units = g.H * g.w;
  float amax = 0.f;
  if (i < m) {
    for (int u = tid; u < units; u += kThreads) {
      const int h = u / g.w, x = u - h * g.w;
      float f[U];
      load_elems<F, U>(src + (((l * g.H + h) * m + i) * g.w + x) * U, f);
#pragma unroll
      for (int k = 0; k < U; ++k) amax = nan_max(fabsf(f[k] * s), amax);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (tid % 32 == 0) s_max[tid / 32] = amax;
  __syncthreads();
  if (tid == 0) {
    float a = s_max[0];
    for (int wi = 1; wi < kThreads / 32; ++wi) a = nan_max(s_max[wi], a);
    const float sc = a * kInvQmax;
    s_scale = isnan(sc) ? sc : fmaxf(sc, kEps);
    (c ? v_scales : k_scales)[l * N + page] = s_scale;
  }
  __syncthreads();
  const float scale = s_scale;
  for (int u = tid; u < units; u += kThreads) {
    const int h = u / g.w, x = u - h * g.w;
    float f[U];
    if (i < m) {
      load_elems<F, U>(src + (((l * g.H + h) * m + i) * g.w + x) * U, f);
#pragma unroll
      for (int k = 0; k < U; ++k) f[k] = int8_code((f[k] * s) / scale);
    } else {
#pragma unroll
      for (int k = 0; k < U; ++k) f[k] = 0.f;
    }
    store_elems<kI8, U>(dst + (((l * g.H + h) * N + page) * g.w + x) * U, f);
  }
}

template <int QF, int CF, int U>
cudaError_t launch_dequant(void* k_cache, void* v_cache, const int* idxs,
                           const void* kd, const void* vd, const void* ks,
                           const void* vs, int L, int Hk, int Hv, int N,
                           int n, int m, int ke, int ve, cudaStream_t st) {
  const int kw = ke / U, vw = ve / U;
  dequant_kernel<QF, CF, U>
      <<<dim3(n, L, 2), block_dims(Hk, Hv, kw, vw), 0, st>>>(
          static_cast<typename Elem<CF>::T*>(k_cache),
          static_cast<typename Elem<CF>::T*>(v_cache),
          static_cast<const typename Elem<QF>::T*>(kd),
          static_cast<const typename Elem<QF>::T*>(vd),
          static_cast<const float*>(ks), static_cast<const float*>(vs), idxs,
          m, N, Hk, Hv, kw, vw);
  return cudaGetLastError();
}

template <int QF, int U>
cudaError_t dequant_into(int cache_fmt, void* k_cache, void* v_cache,
                         const int* idxs, const void* kd, const void* vd,
                         const void* ks, const void* vs, int L, int Hk,
                         int Hv, int N, int n, int m, int ke, int ve,
                         cudaStream_t st) {
  switch (cache_fmt) {
    case kF32:
      return launch_dequant<QF, kF32, U>(k_cache, v_cache, idxs, kd, vd, ks,
                                         vs, L, Hk, Hv, N, n, m, ke, ve, st);
    case kBF16:
      return launch_dequant<QF, kBF16, U>(k_cache, v_cache, idxs, kd, vd, ks,
                                          vs, L, Hk, Hv, N, n, m, ke, ve, st);
    case kE4M3:
      return launch_dequant<QF, kE4M3, U>(k_cache, v_cache, idxs, kd, vd, ks,
                                          vs, L, Hk, Hv, N, n, m, ke, ve, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int F, int U>
cudaError_t launch_requant(void* k_cache, void* v_cache, void* k_scales,
                           void* v_scales, const int* idxs, const void* kd,
                           const void* vd, const void* ks, const void* vs,
                           int L, int Hk, int Hv, int N, int n, int m, int ke,
                           int ve, cudaStream_t st) {
  const int kw = ke / U, vw = ve / U;
  requant_kernel<F, U><<<dim3(n, L, 2), kThreads, 0, st>>>(
      static_cast<int8_t*>(k_cache), static_cast<int8_t*>(v_cache),
      static_cast<float*>(k_scales), static_cast<float*>(v_scales),
      static_cast<const typename Elem<F>::T*>(kd),
      static_cast<const typename Elem<F>::T*>(vd),
      static_cast<const float*>(ks), static_cast<const float*>(vs), idxs, m,
      N, Hk, Hv, kw, vw);
  return cudaGetLastError();
}

template <int U>
cudaError_t requant_from(int data_fmt, void* k_cache, void* v_cache,
                         void* k_scales, void* v_scales, const int* idxs,
                         const void* kd, const void* vd, const void* ks,
                         const void* vs, int L, int Hk, int Hv, int N, int n,
                         int m, int ke, int ve, cudaStream_t st) {
  switch (data_fmt) {
    case kF32:
      return launch_requant<kF32, U>(k_cache, v_cache, k_scales, v_scales,
                                     idxs, kd, vd, ks, vs, L, Hk, Hv, N, n, m,
                                     ke, ve, st);
    case kBF16:
      return launch_requant<kBF16, U>(k_cache, v_cache, k_scales, v_scales,
                                      idxs, kd, vd, ks, vs, L, Hk, Hv, N, n,
                                      m, ke, ve, st);
    case kI8:
      return launch_requant<kI8, U>(k_cache, v_cache, k_scales, v_scales,
                                    idxs, kd, vd, ks, vs, L, Hk, Hv, N, n, m,
                                    ke, ve, st);
    case kE4M3:
      return launch_requant<kE4M3, U>(k_cache, v_cache, k_scales, v_scales,
                                      idxs, kd, vd, ks, vs, L, Hk, Hv, N, n,
                                      m, ke, ve, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// 8-element units where every page and pointer allows them
bool units_of_8(int ke, int ve, uintptr_t ptrs, int max_elem_bytes) {
  return ke % 8 == 0 && ve % 8 == 0 && ptrs % (8 * max_elem_bytes) == 0;
}

int fmt_bytes(int f) { return f == kF32 ? 4 : f == kBF16 ? 2 : 1; }

}  // namespace

// Plain C interface, loaded with ctypes; every entry returns the launch's
// cudaError_t and launches nothing for n == 0. Caches [L, H, N, bs, D]
// (k and v may differ in H and D), idxs [n] int32, stacks [L, H, m, bs, D]
// with m <= n (gather: m == n), scale planes [L, N] f32 and scale stacks
// [L, m] f32, all contiguous. kb / vb: bytes of one head's page; ke / ve:
// its elements. Formats: 0 = f32, 1 = bf16, 2 = int8, 3 = float8_e4m3fn.

// k_scales == nullptr: no planes
extern "C" int block_gather_launch(const void* k_cache, const void* v_cache,
                                   const void* k_scales, const void* v_scales,
                                   const int* idxs, void* kg, void* vg,
                                   void* ksg, void* vsg, int L, int Hk, int Hv,
                                   int N, int n, int kb, int vb,
                                   void* stream) {
  if (n == 0 || L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = (uintptr_t)k_cache | (uintptr_t)v_cache |
                         (uintptr_t)kg | (uintptr_t)vg;
  switch (word_bytes(kb, vb, ptrs)) {
    case 16:
      return (int)launch_gather<uint4>(k_cache, v_cache, k_scales, v_scales,
                                       idxs, kg, vg, ksg, vsg, L, Hk, Hv, N,
                                       n, kb, vb, st);
    case 8:
      return (int)launch_gather<uint2>(k_cache, v_cache, k_scales, v_scales,
                                       idxs, kg, vg, ksg, vsg, L, Hk, Hv, N,
                                       n, kb, vb, st);
    case 4:
      return (int)launch_gather<uint32_t>(k_cache, v_cache, k_scales,
                                          v_scales, idxs, kg, vg, ksg, vsg, L,
                                          Hk, Hv, N, n, kb, vb, st);
    case 2:
      return (int)launch_gather<uint16_t>(k_cache, v_cache, k_scales,
                                          v_scales, idxs, kg, vg, ksg, vsg, L,
                                          Hk, Hv, N, n, kb, vb, st);
    default:
      return (int)launch_gather<uint8_t>(k_cache, v_cache, k_scales, v_scales,
                                         idxs, kg, vg, ksg, vsg, L, Hk, Hv, N,
                                         n, kb, vb, st);
  }
}

// k_scales == nullptr: a plain scatter; else the adopt core (ks / vs [L, m])
extern "C" int block_scatter_launch(void* k_cache, void* v_cache,
                                    void* k_scales, void* v_scales,
                                    const int* idxs, const void* kd,
                                    const void* vd, const void* ks,
                                    const void* vs, int L, int Hk, int Hv,
                                    int N, int n, int m, int kb, int vb,
                                    void* stream) {
  if (n == 0 || L == 0) return 0;
  if (m > n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = (uintptr_t)k_cache | (uintptr_t)v_cache |
                         (uintptr_t)kd | (uintptr_t)vd;
  switch (word_bytes(kb, vb, ptrs)) {
    case 16:
      return (int)launch_scatter<uint4>(k_cache, v_cache, k_scales, v_scales,
                                        idxs, kd, vd, ks, vs, L, Hk, Hv, N, n,
                                        m, kb, vb, st);
    case 8:
      return (int)launch_scatter<uint2>(k_cache, v_cache, k_scales, v_scales,
                                        idxs, kd, vd, ks, vs, L, Hk, Hv, N, n,
                                        m, kb, vb, st);
    case 4:
      return (int)launch_scatter<uint32_t>(k_cache, v_cache, k_scales,
                                           v_scales, idxs, kd, vd, ks, vs, L,
                                           Hk, Hv, N, n, m, kb, vb, st);
    case 2:
      return (int)launch_scatter<uint16_t>(k_cache, v_cache, k_scales,
                                           v_scales, idxs, kd, vd, ks, vs, L,
                                           Hk, Hv, N, n, m, kb, vb, st);
    default:
      return (int)launch_scatter<uint8_t>(k_cache, v_cache, k_scales,
                                          v_scales, idxs, kd, vd, ks, vs, L,
                                          Hk, Hv, N, n, m, kb, vb, st);
  }
}

// codes of code_fmt (2 int8, 3 e4m3) into a cache of cache_fmt (0, 1, 3)
extern "C" int block_scatter_dequant_launch(
    void* k_cache, void* v_cache, const int* idxs, const void* kd,
    const void* vd, const void* ks, const void* vs, int L, int Hk, int Hv,
    int N, int n, int m, int ke, int ve, int code_fmt, int cache_fmt,
    void* stream) {
  if (n == 0 || L == 0) return 0;
  if (m > n || (code_fmt != kI8 && code_fmt != kE4M3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = (uintptr_t)k_cache | (uintptr_t)v_cache |
                         (uintptr_t)kd | (uintptr_t)vd;
  const bool u8 = units_of_8(ke, ve, ptrs, fmt_bytes(cache_fmt));
  if (code_fmt == kI8)
    return (int)(u8 ? dequant_into<kI8, 8>(cache_fmt, k_cache, v_cache, idxs,
                                           kd, vd, ks, vs, L, Hk, Hv, N, n, m,
                                           ke, ve, st)
                    : dequant_into<kI8, 1>(cache_fmt, k_cache, v_cache, idxs,
                                           kd, vd, ks, vs, L, Hk, Hv, N, n, m,
                                           ke, ve, st));
  return (int)(u8 ? dequant_into<kE4M3, 8>(cache_fmt, k_cache, v_cache, idxs,
                                           kd, vd, ks, vs, L, Hk, Hv, N, n, m,
                                           ke, ve, st)
                  : dequant_into<kE4M3, 1>(cache_fmt, k_cache, v_cache, idxs,
                                           kd, vd, ks, vs, L, Hk, Hv, N, n, m,
                                           ke, ve, st));
}

// a payload of data_fmt (0-3) into the int8 cache and its planes
extern "C" int block_scatter_requant_launch(
    void* k_cache, void* v_cache, void* k_scales, void* v_scales,
    const int* idxs, const void* kd, const void* vd, const void* ks,
    const void* vs, int L, int Hk, int Hv, int N, int n, int m, int ke, int ve,
    int data_fmt, void* stream) {
  if (n == 0 || L == 0) return 0;
  if (m > n || data_fmt < kF32 || data_fmt > kE4M3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = (uintptr_t)k_cache | (uintptr_t)v_cache |
                         (uintptr_t)kd | (uintptr_t)vd;
  if (units_of_8(ke, ve, ptrs, fmt_bytes(data_fmt)))
    return (int)requant_from<8>(data_fmt, k_cache, v_cache, k_scales,
                                v_scales, idxs, kd, vd, ks, vs, L, Hk, Hv, N,
                                n, m, ke, ve, st);
  return (int)requant_from<1>(data_fmt, k_cache, v_cache, k_scales, v_scales,
                              idxs, kd, vd, ks, vs, L, Hk, Hv, N, n, m, ke, ve,
                              st);
}
