// Grouped matmul over expert-sorted rows with int8 / fp8 expert weights,
// for sm_90a: out[rows_e] = (lhs[rows_e] @ w_q[e]) * w_s[e].
//
// Replaces the Pallas TPU kernel
// dynamo_tpu/ops/moe_gmm_pallas.py::ragged_int8_gmm (_kernel, with its
// scalar-prefetched step metadata _step_metadata): there a sequential grid of
// (row tile, expert) steps accumulates each output tile in VMEM, widening the
// quantized weight tile to the lhs dtype in VMEM and applying the expert's
// per-column scale after the dot. Here the blocks run in parallel, so the
// grid is (N tile, expert): one block owns one expert's K x TN weight tile
// and ALL of that expert's rows.
//
// What bounds it on an H100: at decode (a few rows per expert) the weight
// bytes: every expert that owns a row streams its K x N codes once per
// projection (DeepSeek-V2-Lite: ~34 of 64 experts x 2.9 MB per projection
// per layer at B = 8); the rows are L2-resident and the arithmetic is ~2
// flops per weight byte per row, far below the card's ridge. At prefill
// (thousands of rows) it is operations, and this kernel runs them on CUDA
// cores (a tensor-core tile is later work).
//
// What the design does about it: the block copies its whole K x TN tile of
// codes into shared memory ONCE with cp.async (all 16-byte copies in flight
// together, so a block keeps 64 KB of loads outstanding), then walks its
// expert's rows in passes of RP rows, staging each pass's lhs rows in
// K-chunks as f32; the codes are never read from device memory twice,
// whatever the row count. Each thread owns RR rows x 4 columns: per k it
// reads one 32-bit word of four codes and one float2 of lhs values, eight
// FMAs. An expert with at most RS rows (decode: B = 8 tokens top-6 over 64
// experts gives 0-3 rows each) would leave all but one row group idle, so
// there the row groups split K instead: each thread sums its K-slice for
// every row, and the partial sums meet in shared memory. An expert with more
// rows and bf16 lhs (prefill: ~110 rows per expert for 1201 tokens) runs on
// the tensor cores instead: the pass's rows stream in 64-deep K-chunks with
// cp.async, double-buffered, the chunk's codes widen to a bf16 tile in
// shared memory, and each warp multiplies 16 of the pass's 128 rows by the
// 32 columns with mma.sync m16n8k16 (bf16 in, f32 accumulate). Codes widen
// to f32 (or bf16) exactly (int8 and e4m3 both fit bf16, so this is
// the Pallas body's widen-to-lhs-dtype with an f32 accumulator), and the
// scale multiplies after the K loop, as there. Expert offsets come from the
// device cumsum of group_sizes (`ends`); an expert with no rows exits at
// once. One extra grid row (blockIdx.y == X) writes zeros to the rows at or
// beyond sum(group_sizes), which no expert owns. No host sync anywhere.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TN = 32;        // output columns per block
constexpr int NT = 256;       // threads per block
constexpr int CG = TN / 4;    // column groups of 4
constexpr int RG = NT / CG;   // row groups
constexpr int RR = 2;         // rows per thread per pass
constexpr int RP = RG * RR;   // rows per pass
constexpr int KC = 64;        // K per lhs staging chunk
constexpr int XS = RP + 2;    // padded row stride of the staged lhs
static_assert(RR == 2, "the inner loop reads one float2 of rows");
constexpr int RS = 4;         // few-rows mode: at most this many rows
constexpr int KG = NT / CG;   // K groups of the few-rows mode
constexpr int KCF = 1024;     // K per lhs staging chunk, few-rows mode
static_assert(RS * KCF <= KC * XS && KG * RS * TN <= KC * XS,
              "the few-rows mode reuses the lhs staging buffer");

// tensor-core path (bf16 lhs, more than RS rows)
constexpr int MR = 16 * (NT / 32);  // rows per pass: one m16 tile per warp
constexpr int MKC = 64;             // K per staging chunk
constexpr int MST = MKC + 8;        // padded bf16 row stride (conflict-free)
// the staging buffer after the codes, shared by the three modes (the
// tensor-core path double-buffers its rows: two [MR][MST] chunks plus the
// widened codes [TN][MST])
constexpr size_t STAGE_BYTES =
    (size_t)KC * XS * 4 > (size_t)(2 * MR + TN) * MST * 2
        ? (size_t)KC * XS * 4 : (size_t)(2 * MR + TN) * MST * 2;

__host__ __device__ constexpr size_t w_bytes(int K) {
  return ((size_t)K * TN + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t smem_bytes(int K) {
  return w_bytes(K) + STAGE_BYTES;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four codes of one 32-bit word, widened to f32
template <typename TW>
__device__ __forceinline__ void widen4(uint32_t w, float (&out)[4]);
template <>
__device__ __forceinline__ void widen4<int8_t>(uint32_t w, float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = (float)(int8_t)((w >> (8 * j)) & 0xff);
}
template <>
__device__ __forceinline__ void widen4<__nv_fp8_e4m3>(uint32_t w,
                                                      float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_fp8_e4m3 v;
    v.__x = (__nv_fp8_storage_t)((w >> (8 * j)) & 0xff);
    out[j] = (float)v;
  }
}

// ---- tensor-core path ----

template <typename TW>
__device__ __forceinline__ __nv_bfloat16 widen_bf16(uint8_t c);
template <>
__device__ __forceinline__ __nv_bfloat16 widen_bf16<int8_t>(uint8_t c) {
  return __float2bfloat16((float)(int8_t)c);  // exact: |code| <= 127
}
template <>
__device__ __forceinline__ __nv_bfloat16 widen_bf16<__nv_fp8_e4m3>(uint8_t c) {
  __nv_fp8_e4m3 v;
  v.__x = (__nv_fp8_storage_t)c;
  return __float2bfloat16((float)v);  // exact: e4m3 fits bf16
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}
// 16 bytes, or 16 zero bytes when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One K-chunk of a pass's rows into a staging buffer with cp.async (zeros
// past the pass's nr rows and past K). K % 8 == 0, so a 16-byte copy never
// straddles the end of a row.
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ lhs,
                                           __nv_bfloat16* x_buf, int r0,
                                           int nr, int k0, int K) {
  for (int i = threadIdx.x; i < MR * (MKC / 8); i += NT) {
    const int r = i / (MKC / 8), c = (i % (MKC / 8)) * 8;
    const bool valid = r < nr && k0 + c < K;
    cp_async16_zfill(x_buf + r * MST + c,
                     valid ? lhs + (size_t)(r0 + r) * K + k0 + c : lhs, valid);
  }
}

// All of one expert's rows [start, end) x the block's TN columns on the
// tensor cores; the codes are already (being) copied into w_s. The rows of
// K-chunk c + 1 are in flight while chunk c multiplies.
template <typename TW>
__device__ void expert_rows_mma(const __nv_bfloat16* __restrict__ lhs,
                                const unsigned char* w_s, void* stage,
                                const float* __restrict__ ws,
                                float* __restrict__ out, int start, int end,
                                int K, int N, int n0, int e) {
  __nv_bfloat16* x_bufs = static_cast<__nv_bfloat16*>(stage);  // 2 x [MR][MST]
  __nv_bfloat16* b_s = x_bufs + 2 * MR * MST;                  // [TN][MST]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_chunks = (K + MKC - 1) / MKC;
  for (int r0 = start; r0 < end; r0 += MR) {
    const int nr = min(MR, end - r0);
    float acc[TN / 8][4];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    stage_rows(lhs, x_bufs, r0, nr, 0, K);
    cp_async_commit();  // (the first pass's group also holds the codes)
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int k0 = ci * MKC;
      const int kc = min(MKC, K - k0);
      const __nv_bfloat16* x_s = x_bufs + (ci & 1) * MR * MST;
      if (ci + 1 < n_chunks)
        stage_rows(lhs, x_bufs + ((ci + 1) & 1) * MR * MST, r0, nr, k0 + MKC, K);
      cp_async_commit();
      cp_async_wait_prior();  // chunk ci (and the codes) landed
      __syncthreads();
      // the chunk's codes widened to bf16, transposed to [n][k]
      for (int i = threadIdx.x; i < TN * MKC; i += NT) {
        const int n = i % TN, k = i / TN;
        b_s[n * MST + k] = k < kc ? widen_bf16<TW>(w_s[(k0 + k) * TN + n])
                                  : __float2bfloat16(0.f);
      }
      __syncthreads();
      const __nv_bfloat16* xa = x_s + (warp * 16) * MST;
      for (int kk = 0; kk < kc; kk += 16) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xa + g * MST + kk + 2 * t);
        a[1] = *reinterpret_cast<const uint32_t*>(xa + (g + 8) * MST + kk + 2 * t);
        a[2] = *reinterpret_cast<const uint32_t*>(xa + g * MST + kk + 2 * t + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xa + (g + 8) * MST + kk + 2 * t + 8);
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const __nv_bfloat16* bp = b_s + (j * 8 + g) * MST + kk + 2 * t;
          mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(bp),
                   *reinterpret_cast<const uint32_t*>(bp + 8));
        }
      }
      __syncthreads();
    }
    // C fragment: (row g, cols 2t, 2t+1) and (row g+8, same cols)
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = n0 + j * 8 + 2 * t;
      const float s0 = ws[(size_t)e * N + c], s1 = ws[(size_t)e * N + c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + h * 8;
        if (r < nr)
          *reinterpret_cast<float2*>(out + (size_t)(r0 + r) * N + c) =
              make_float2(acc[j][2 * h] * s0, acc[j][2 * h + 1] * s1);
      }
    }
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(NT)
ragged_gmm_kernel(const TX* __restrict__ lhs, const uint8_t* __restrict__ wq,
                  const float* __restrict__ ws, const int* __restrict__ ends,
                  float* __restrict__ out, int R, int K, int N, int X) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* w_s = smem;                            // [K][TN] codes
  float* x_s = reinterpret_cast<float*>(smem + w_bytes(K));  // STAGE_BYTES
  const int n0 = blockIdx.x * TN;
  const int e = blockIdx.y;
  const int total = ends[X - 1];
  if (e == X) {  // the rows no expert owns come out as exact zeros
    const long long n_rows = R - total;
    for (long long i = threadIdx.x; i < n_rows * CG; i += NT) {
      const long long r = total + i / CG;
      *reinterpret_cast<float4*>(out + r * N + n0 + (i % CG) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int end = ends[e];
  const int start = e > 0 ? ends[e - 1] : 0;
  if (end <= start) return;

  // the expert's K x TN codes, once, all copies in flight together
  const uint8_t* src = wq + (size_t)e * K * N + n0;
  for (int i = threadIdx.x; i < K * (TN / 16); i += NT) {
    const int k = i / (TN / 16), part = i % (TN / 16);
    cp_async16(w_s + k * TN + part * 16, src + (size_t)k * N + part * 16);
  }

  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  if (end - start <= RS) {  // few rows: the row groups split K
    const int nr = end - start;
    const int kg = rg;
    float acc[RS][4];
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KCF) {
      const int kc = min(KCF, K - k0);
      for (int i = threadIdx.x; i < nr * kc; i += NT) {
        const int r = i / kc, kk = i % kc;
        x_s[r * KCF + kk] = to_f(lhs[(size_t)(start + r) * K + k0 + kk]);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int kk = kg; kk < kc; kk += KG) {
        const uint32_t w4 =
            *reinterpret_cast<const uint32_t*>(w_s + (k0 + kk) * TN + cg * 4);
        float wf[4];
        widen4<TW>(w4, wf);
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
    }
    float* red = x_s;  // [KG][RS][TN] partial sums
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(kg * RS + r) * TN + cg * 4 + j] = acc[r][j];
    __syncthreads();
    for (int i = threadIdx.x; i < nr * TN; i += NT) {
      const int r = i / TN, c = i % TN;
      float sum = 0.f;
      for (int g2 = 0; g2 < KG; ++g2) sum += red[(g2 * RS + r) * TN + c];
      out[(size_t)(start + r) * N + n0 + c] = sum * ws[(size_t)e * N + n0 + c];
    }
    return;
  }
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (K % 16 == 0) {  // many rows, bf16: the tensor cores
      expert_rows_mma<TW>(lhs, w_s, x_s, ws, out, start, end, K, N, n0, e);
      return;
    }
  }
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
        x_s[kk * XS + r] = to_f(lhs[(size_t)(r0 + r) * K + k0 + kk]);
      }
      cp_async_wait_all();  // the codes landed (a no-op after the first)
      __syncthreads();
      if (mine) {
        for (int kk = 0; kk < kc; ++kk) {
          const uint32_t w4 =
              *reinterpret_cast<const uint32_t*>(w_s + (k0 + kk) * TN + cg * 4);
          float wf[4];
          widen4<TW>(w4, wf);
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

template <typename TX, typename TW>
cudaError_t launch_typed(const void* lhs, const void* wq, const float* ws,
                         const int* ends, float* out, int R, int K, int N,
                         int X, cudaStream_t stream) {
  auto kern = ragged_gmm_kernel<TX, TW>;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / TN, X + 1);
  kern<<<grid, NT, smem, stream>>>(static_cast<const TX*>(lhs),
                                   static_cast<const uint8_t*>(wq), ws, ends,
                                   out, R, K, N, X);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. lhs_dtype: 0 = float32,
// 1 = bfloat16; w_dtype: 0 = int8, 1 = float8_e4m3fn. ``ends`` is the
// inclusive cumsum of group_sizes (int32, [X]). N must be a multiple of 32
// and K * 32 + STAGE_BYTES must fit a block's shared memory (the wrapper checks
// both). Returns the launch's cudaError_t.
extern "C" int ragged_int8_gmm_launch(const void* lhs, const void* wq,
                                      const float* ws, const int* ends,
                                      float* out, int R, int K, int N, int X,
                                      int lhs_dtype, int w_dtype,
                                      void* stream) {
  if (R == 0 || N == 0) return 0;
  if (N % TN != 0 || X < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lhs_dtype == 0 && w_dtype == 0)
    return (int)launch_typed<float, int8_t>(lhs, wq, ws, ends, out, R, K, N,
                                            X, st);
  if (lhs_dtype == 1 && w_dtype == 0)
    return (int)launch_typed<__nv_bfloat16, int8_t>(lhs, wq, ws, ends, out, R,
                                                    K, N, X, st);
  if (lhs_dtype == 0 && w_dtype == 1)
    return (int)launch_typed<float, __nv_fp8_e4m3>(lhs, wq, ws, ends, out, R,
                                                   K, N, X, st);
  if (lhs_dtype == 1 && w_dtype == 1)
    return (int)launch_typed<__nv_bfloat16, __nv_fp8_e4m3>(
        lhs, wq, ws, ends, out, R, K, N, X, st);
  return (int)cudaErrorInvalidValue;
}
