// Fused RMSNorm (+ optional residual add) for Hopper (sm_90a).
//
// Replaces the TPU kernel rmsnorm_pallas (src/repro/kernels/rmsnorm/kernel.py,
// bodies _rmsnorm_kernel and _rmsnorm_res_kernel):
//
//   y = x * rsqrt(mean(x^2) + eps) * scale (+ residual)
//
// with fp32 statistics, the residual added after scaling, output in x's type.
//
// What bounds it: bytes.  Each row is read once for the sum of squares and
// once more for the output (the second read hits L1/L2: a qwen2-7b bf16 row
// of 3584 is 7 KiB), and written once, so the floor is one read of x (and of
// the residual) plus one write of y over the card's 3.35 TB/s.  The design
// goes after that floor only: one CTA per row, 16-byte vector loads and
// stores wherever the row allows them (any D whose row is a multiple of 16
// bytes, e.g. 3584 = 448 vectors of 8 bf16), a scalar loop otherwise, and a
// warp-shuffle reduction of the fp32 sum.  Any D and any row count: there is
// no padding to a block of rows as on the TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum of v over the CTA; every thread gets the same total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               const T* __restrict__ residual, T* __restrict__ y, int D, float eps) {
  const int64_t off = static_cast<int64_t>(blockIdx.x) * D;
  const T* xr = x + off;
  const T* rr = residual ? residual + off : nullptr;
  T* yr = y + off;
  constexpr int N = kVec ? Vec<T>::N : 1;

  float ss = 0.f;
  for (int c = threadIdx.x * N; c < D; c += kThreads * N) {
    float v[N];
    if constexpr (kVec) load_vec(xr + c, v); else v[0] = to_f(xr[c]);
#pragma unroll
    for (int i = 0; i < N; ++i) ss += v[i] * v[i];
  }
  const float inv = rsqrtf(block_sum(ss) / D + eps);

  for (int c = threadIdx.x * N; c < D; c += kThreads * N) {
    float v[N], r[N];
    if constexpr (kVec) load_vec(xr + c, v); else v[0] = to_f(xr[c]);
    if (rr) { if constexpr (kVec) load_vec(rr + c, r); else r[0] = to_f(rr[c]); }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = v[i] * inv * to_f(scale[c + i]);
      if (rr) v[i] += r[i];
    }
    if constexpr (kVec) store_vec(yr + c, v); else yr[c] = from_f<T>(v[0]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename S>
int launch(const void* x, const void* scale, const void* residual, void* y,
           long long rows, int D, float eps, cudaStream_t stream) {
  const bool vec = (D * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(y) &&
                   (residual == nullptr || aligned16(residual));
  const dim3 grid(static_cast<unsigned>(rows));
  const T* xt = static_cast<const T*>(x);
  const S* st = static_cast<const S*>(scale);
  const T* rt = static_cast<const T*>(residual);
  T* yt = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, S, true><<<grid, kThreads, 0, stream>>>(xt, st, rt, yt, D, eps);
  else
    rmsnorm_kernel<T, S, false><<<grid, kThreads, 0, stream>>>(xt, st, rt, yt, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x, residual and y share x_dtype;
// residual may be null.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, const void* residual,
                           void* y, long long rows, int D, float eps, int x_dtype,
                           int scale_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, residual, y, rows, D, eps, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, residual, y, rows, D, eps, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, residual, y, rows, D, eps, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, residual, y, rows, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
