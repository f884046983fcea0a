// Fused RMSNorm (+ optional residual add) for Hopper (sm_90a).
//
// Replaces the TPU kernel rmsnorm_pallas (src/repro/kernels/rmsnorm/kernel.py,
// bodies _rmsnorm_kernel and _rmsnorm_res_kernel):
//
//   y = x * rsqrt(mean(x^2) + eps) * scale (+ residual)
//
// with fp32 statistics, the residual added after scaling, output in x's type.
//
// What bounds it: bytes: one read of x (and of the residual) and one write
// of y over the card's 3.35 TB/s.  Any D and any row count: there is no
// padding to a block of rows as on the TPU.  Two bodies; the wrapper picks
// one by shape (kernels/rmsnorm/kernel.py:select_body):
//
//   * one-read (every row of 16-byte vectors, at most 32 a lane: the served
//     widths 768, 1536, 3584 and 4096 in fp32 and bf16).  A warp owns a row
//     and a CTA owns 4 rows (1 below 512 rows, so that a decode step's few
//     rows spread over as many SMs).  Each lane loads its VPL 16-byte
//     vectors of the row into registers at once (VPL a template parameter:
//     the row's vectors over 32 lanes, rounded up to a power of two), so the
//     row is read from device memory once and all its loads are in flight
//     together; the sum of squares is reduced by shuffles inside the warp;
//     the output is computed from the registers.  `scale` is copied once per
//     CTA into shared memory with cp.async (16 bytes at a time, while the
//     rows load) and read from there for each of the CTA's rows; one
//     __syncthreads, after the reduction, waits for it.
//   * generic (any other row): one 256-thread CTA per row, 16-byte vectors
//     where the row allows them and a scalar loop otherwise; it reads the
//     row twice (the second read hits L1/L2) and reduces through shared
//     memory.
//
// Backward (rmsnorm_bwd; the TPU kernel has none: JAX differentiates the
// jnp reference).  With x^ = x * rstd and g = dy * scale:
//
//   dx     = rstd * (g - x^ * mean(g * x^))
//   dscale = sum over rows of dy * x^
//
// rstd is recomputed from x (the forward stores nothing).  A 256-thread CTA
// owns a contiguous run of rows: for each it reduces sum(x^2) and sum(g*x)
// through shared memory, writes the row of dx, and adds dy * x^ into its own
// row of an fp32 partial-sum buffer, each column owned by one thread.  A
// second kernel sums the CTAs' partial rows in CTA order, so dscale is
// deterministic: no atomics, the same bits on every run.  Both sums are
// compensated (Kahan; the partial buffer keeps each sum's compensation
// beside it): a plain running sum over 4096 rows erred by 7.5e-5 at |dscale|
// ~ 190 on the H100, twice the error of PyTorch's tree reduction.  What
// bounds it: bytes (x and dy read twice, the second read from L1/L2; dx
// written once).
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

// One 16-byte vector of T as floats, and back.  `raw` is taken by value: a
// reference into device memory would let the compiler load it an element
// at a time.
template <typename T>
__device__ __forceinline__ void unpack(uint4 raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  return raw;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  unpack<T>(raw, out);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  *reinterpret_cast<uint4*>(p) = pack<T>(in);
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

// ---------------------------------------------------------------------------
// one-read body: a warp per row
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 4;         // rows per CTA, or 1 below kFewRows rows
constexpr long long kFewRows = 512;  // so that a decode step's rows spread over SMs

// N scale values of type S from shared memory as 8-, 16- or 32-byte vectors.
template <typename S, int N>
__device__ __forceinline__ void load_scale(const S* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(S));
  static_assert(kBytes == 8 || kBytes == 16 || kBytes == 32, "scale vector");
  if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int h = 0; h < kBytes / 16; ++h) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + h * (16 / sizeof(S)));
      const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
      for (int i = 0; i < 16 / static_cast<int>(sizeof(S)); ++i)
        out[h * (16 / sizeof(S)) + i] = to_f(e[i]);
    }
  }
}

template <typename T, typename S, int VPL>
__global__ void __launch_bounds__(kRowWarps * 32)
rmsnorm_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    const T* __restrict__ residual, T* __restrict__ y, long long rows, int D,
                    float eps) {
  extern __shared__ uint4 s_scale[];  // D values of S
  constexpr int N = Vec<T>::N;
  const int nvec = D / N;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * warps + warp;
  const bool live = row < rows;
  const long long off = live ? row * D : 0;

  // scale, once for the CTA's rows: cp.async copies it into shared memory
  // without registers, all of it in flight while the rows load.
  const int n_scale = D * static_cast<int>(sizeof(S)) / 16;
  const uint4* sg = reinterpret_cast<const uint4*>(scale);
  for (int i = threadIdx.x; i < n_scale; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(s_scale + i))),
                 "l"(sg + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // The row, into registers, all loads issued together.
  const uint4* xr = reinterpret_cast<const uint4*>(x + off);
  uint4 xv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    xv[i] = live && c < nvec ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }

  float ss = 0.f;  // a partial sum a vector, so the chain of adds is N + VPL long
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    float v[N], part = 0.f;
    unpack<T>(xv[i], v);
#pragma unroll
    for (int e = 0; e < N; ++e) part = fmaf(v[e], v[e], part);
    ss += part;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / D + eps);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!live) return;

  const S* sc = reinterpret_cast<const S*>(s_scale);
  const uint4* rr = residual ? reinterpret_cast<const uint4*>(residual + off) : nullptr;
  uint4* yr = reinterpret_cast<uint4*>(y + off);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c >= nvec) break;
    float v[N], s[N];
    unpack<T>(xv[i], v);
    load_scale<S, N>(sc + c * N, s);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = v[e] * inv * s[e];
    if (rr) {
      float r[N];
      unpack<T>(__ldg(rr + c), r);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] += r[e];
    }
    yr[c] = pack<T>(v);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename S>
int launch_generic(const void* x, const void* scale, const void* residual, void* y,
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

template <typename T, typename S, int VPL>
int launch_rows(const void* x, const void* scale, const void* residual, void* y,
                long long rows, int D, float eps, cudaStream_t stream) {
  const int warps = rows < kFewRows ? 1 : kRowWarps;
  const long long blocks = (rows + warps - 1) / warps;
  rmsnorm_rows_kernel<T, S, VPL><<<static_cast<unsigned>(blocks), warps * 32,
                                   D * sizeof(S), stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(residual),
      static_cast<T*>(y), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// vpl 0: the generic body; else the one-read body with vpl vectors a lane,
// which must cover the row and take its 16-byte vectors.
template <typename T, typename S>
int launch(const void* x, const void* scale, const void* residual, void* y, long long rows,
           int D, float eps, int vpl, cudaStream_t stream) {
  if (vpl == 0) return launch_generic<T, S>(x, scale, residual, y, rows, D, eps, stream);
  const int nvec = D / Vec<T>::N;
  const bool ok = (D * sizeof(T)) % 16 == 0 && (D * sizeof(S)) % 16 == 0 &&
                  (nvec + 31) / 32 <= vpl && aligned16(x) && aligned16(y) &&
                  aligned16(scale) && (residual == nullptr || aligned16(residual)) &&
                  rows / kRowWarps < 0x7fffffffLL;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (vpl) {
    case 1: return launch_rows<T, S, 1>(x, scale, residual, y, rows, D, eps, stream);
    case 2: return launch_rows<T, S, 2>(x, scale, residual, y, rows, D, eps, stream);
    case 4: return launch_rows<T, S, 4>(x, scale, residual, y, rows, D, eps, stream);
    case 8: return launch_rows<T, S, 8>(x, scale, residual, y, rows, D, eps, stream);
    case 16: return launch_rows<T, S, 16>(x, scale, residual, y, rows, D, eps, stream);
    case 32: return launch_rows<T, S, 32>(x, scale, residual, y, rows, D, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// (sum a, sum b) over the CTA; every thread gets both.  Ends with a barrier,
// so it can be called again at once.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    total.x += warp_sums[w].x;
    total.y += warp_sums[w].y;
  }
  __syncthreads();
  return total;
}

// s += y, compensated: c carries the low-order bits the sum lost (s - c is
// the better sum).
__device__ __forceinline__ void kahan_add(float& s, float& c, float y) {
  y -= c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Rows [blockIdx.x * rows_per_block, +rows_per_block) of dx, and this CTA's
// row of `partial` (D floats, their compensations D floats further on, in
// the second half of the buffer): sum over its rows of dy * x^.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int D, float eps, long long rows_per_block) {
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  float* part = partial + static_cast<long long>(blockIdx.x) * D;
  float* comp = part + static_cast<long long>(gridDim.x) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) part[c] = comp[c] = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * D;
    const T* dyr = dy + r * D;
    T* dxr = dx + r * D;
    float ss = 0.f, sgx = 0.f;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const float xv = to_f(xr[c]);
      ss = fmaf(xv, xv, ss);
      sgx = fmaf(to_f(dyr[c]) * to_f(scale[c]), xv, sgx);
    }
    const float2 tot = block_sum2(ss, sgx);
    const float rstd = rsqrtf(tot.x / D + eps);
    const float mean_gx = tot.y * rstd / D;  // mean(g * x^)
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const float dyv = to_f(dyr[c]);
      const float xh = to_f(xr[c]) * rstd;
      dxr[c] = from_f<T>(rstd * (dyv * to_f(scale[c]) - xh * mean_gx));
      kahan_add(part[c], comp[c], dyv * xh);
    }
  }
}

// dscale[c] = sum over the `blocks` partial rows, in order, compensated.
template <typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale, int blocks,
                      int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  const float* comp = partial + static_cast<long long>(blocks) * D;
  float s = 0.f, err = 0.f;
  for (int b = 0; b < blocks; ++b) {
    const long long i = static_cast<long long>(b) * D + c;
    kahan_add(s, err, partial[i] - comp[i]);
  }
  dscale[c] = from_f<S>(s - err);
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               void* partial, long long rows, int D, float eps, int max_blocks,
               cudaStream_t stream) {
  if (rows <= 0 || D <= 0 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long per = (rows + max_blocks - 1) / max_blocks;
  const int blocks = static_cast<int>((rows + per - 1) / per);
  rmsnorm_bwd_kernel<T, S><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, D, eps, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_kernel<S><<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<S*>(dscale), blocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x, residual and y share x_dtype;
// residual may be null.  vectors_per_lane: 0 for the generic body, else one
// of 1, 2, 4, 8, 16, 32 for the one-read body.  Returns cudaGetLastError()
// after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, const void* residual,
                           void* y, long long rows, int D, float eps, int x_dtype,
                           int scale_dtype, int vectors_per_lane, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vpl = vectors_per_lane;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, residual, y, rows, D, eps, vpl, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, residual, y, rows, D, eps, vpl, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, residual, y, rows, D, eps, vpl, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, residual, y, rows, D, eps, vpl, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: dx (like x) and dscale (like scale) from x, scale and dy
// (like x), all contiguous, rows x D.  `partial` is fp32 scratch of
// 2 x max_blocks x D; the rows are split over at most max_blocks CTAs.  Returns
// cudaGetLastError() after the launches.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, void* partial, long long rows, int D, float eps,
                           int x_dtype, int scale_dtype, int max_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mb = max_blocks;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch_bwd<float, float>(x, scale, dy, dx, dscale, partial, rows, D, eps, mb, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows, D, eps,
                                            mb, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, scale, dy, dx, dscale, partial, rows, D, eps,
                                            mb, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows,
                                                    D, eps, mb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
