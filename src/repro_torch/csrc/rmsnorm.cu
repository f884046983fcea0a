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
// Backward (the TPU kernel has none: JAX differentiates the jnp reference).
// With x^ = x * rstd and g = dy * scale:
//
//   dx     = rstd * (g - x^ * mean(g * x^))
//   dscale = sum over rows of dy * x^
//
// rstd is recomputed from x (the forward stores nothing).  What bounds it:
// bytes (x and dy read once, dx written once).  Three bodies; the wrapper
// picks one by shape (kernels/rmsnorm/kernel.py:select_bwd_body):
//
//   * warp_rows (rows of 16-byte vectors of at most 1024 elements: every
//     train width and the smaller served ones).  The forward's one-read
//     layout: a warp owns a row at a time, its x and dy in registers (VPL
//     16-byte vectors a lane, all loads issued together), both sums reduced
//     by shuffles, no barrier in the row loop, `scale` in shared memory
//     (cp.async, once a CTA), dx written from the registers.  Each warp
//     owns a run of rows_per_warp rows (the wrapper sizes the grid from the
//     SM count: about 8 warps an SM) and each lane keeps its columns'
//     dscale sums in registers across them; at the end the CTA adds its 4
//     warps' sums as a pairwise tree and writes one partial row.  A second
//     kernel, one CTA of 32 warps per 32-column slab, sums the partial
//     rows: warp j takes rows j, j + 32, ... in turn, then a pairwise tree
//     over the 32 warps.  Every sum has a fixed order (no atomics, the same
//     bits on every run) and is taken in fp64 (each term dy * x^ of two
//     floats is exact there), rounded once at the end: in fp32 that order
//     kept dscale within 2e-5 at 4096 rows but not at 8192, the mamba2-130m
//     step's rows (kernels/rmsnorm/ref.py: rmsnorm_dscale_ordered models
//     the order).
//   * cta_rows (rows of 16-byte vectors of 1025 to 8192 elements, fp32 and
//     bf16: the wider train widths, 1280-5120).  warp_rows generalised from
//     a warp to a CTA of 1-8 warps a row, as many as keep a lane at 32
//     floats of x and of dy: the CTA walks a run of rows (the wrapper sizes
//     the grid from the SM count), x and dy read once into registers, the
//     row's two sums reduced by shuffles and then across the warps through
//     shared memory with one barrier a row (two buffers in turn), dx
//     written once.  Each thread owns the columns of its vectors and keeps
//     their dscale sums in fp64 registers over the CTA's rows, so the CTA's
//     partial row needs no tree; rmsnorm_dscale_tree_kernel then sums the
//     partial rows in its fixed order (ref.py:rmsnorm_dscale_ordered with
//     one warp a CTA).  No atomics.  The generic body, which it replaces at
//     these widths, read each row twice, took two barriers a row and
//     read-modify-wrote two fp32 partial rows for every row in device
//     memory; at (8192, 1536) fp32 it lost to F.rms_norm's backward.
//   * generic (any other row): a 256-thread CTA owns a contiguous run of
//     rows: for each it reduces sum(x^2) and sum(g*x) through shared memory,
//     writes the row of dx, and adds dy * x^ into its own row of an fp32
//     partial-sum buffer, each column owned by one thread.  A second kernel
//     sums the CTAs' partial rows in CTA order.  Both sums are compensated
//     (Kahan; the partial buffer keeps each sum's compensation beside it):
//     the running sums are long here.
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

// 16 bytes from device to shared memory without registers, and the wait for
// all such copies this thread issued.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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
  for (int i = threadIdx.x; i < n_scale; i += blockDim.x) cp_async16(s_scale + i, sg + i);

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
  cp_async_wait_all();
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

// ---- warp_rows body

constexpr int kBwdRowWarps = 4;    // warps a CTA of rmsnorm_bwd_rows_kernel
constexpr int kReduceWarps = 32;   // warps a column slab of rmsnorm_dscale_tree_kernel

// Bytes of shared memory before the warps' dscale sums: scale, rounded up
// to 16.
__host__ __device__ __forceinline__ int scale_bytes(int D, int size) {
  return (D * size + 15) / 16 * 16;
}

// Rows [w * rows_per_warp, (w + 1) * rows_per_warp) of dx for each warp w
// of the grid, and this CTA's row of `partial` (D doubles): the pairwise
// sum of its warps' sums of dy * x^ over their rows, all in fp64.
template <typename T, typename S, int VPL>
__global__ void __launch_bounds__(kBwdRowWarps * 32)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        double* __restrict__ partial, long long rows, int D, float eps,
                        int rows_per_warp) {
  extern __shared__ uint4 s_bwd[];  // scale (D values of S), then 4 x D doubles
  constexpr int N = Vec<T>::N;
  const int nvec = D / N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = (static_cast<long long>(blockIdx.x) * kBwdRowWarps + warp) * rows_per_warp;
  const long long r1 = r0 + rows_per_warp < rows ? r0 + rows_per_warp : rows;

  const int n_scale = D * static_cast<int>(sizeof(S)) / 16;
  for (int i = threadIdx.x; i < n_scale; i += blockDim.x)
    cp_async16(s_bwd + i, reinterpret_cast<const uint4*>(scale) + i);
  cp_async_wait_all();
  __syncthreads();
  const S* sc = reinterpret_cast<const S*>(s_bwd);

  double part[VPL][N];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) part[i][e] = 0.0;

  for (long long r = r0; r < r1; ++r) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * D);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + r * D);
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      const bool in = c < nvec;
      xv[i] = in ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
      dv[i] = in ? __ldg(dyr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c >= nvec) break;
      float xf[N], df[N], s[N];
      unpack<T>(xv[i], xf);
      unpack<T>(dv[i], df);
      load_scale<S, N>(sc + c * N, s);
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        a = fmaf(xf[e], xf[e], a);
        b = fmaf(df[e] * s[e], xf[e], b);
      }
      ss += a;
      sgx += b;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    const float rstd = rsqrtf(ss / D + eps);
    const float mean_gx = sgx * rstd / D;  // mean(g * x^)
    uint4* dxr = reinterpret_cast<uint4*>(dx + r * D);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c >= nvec) break;
      float xf[N], df[N], s[N], out[N];
      unpack<T>(xv[i], xf);
      unpack<T>(dv[i], df);
      load_scale<S, N>(sc + c * N, s);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xh = xf[e] * rstd;
        out[e] = rstd * (df[e] * s[e] - xh * mean_gx);
        part[i][e] = fma(static_cast<double>(df[e]), static_cast<double>(xh), part[i][e]);
      }
      dxr[c] = pack<T>(out);
    }
  }

  // the CTA's 4 warps' sums, added as a pairwise tree: (w0 + w2) + (w1 + w3)
  double* s_part = reinterpret_cast<double*>(reinterpret_cast<char*>(s_bwd) +
                                             scale_bytes(D, sizeof(S)));
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c >= nvec) break;
#pragma unroll
    for (int e = 0; e < N; ++e) s_part[warp * D + c * N + e] = part[i][e];
  }
  __syncthreads();
  double* out = partial + static_cast<long long>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x)
    out[c] = (s_part[c] + s_part[2 * D + c]) + (s_part[D + c] + s_part[3 * D + c]);
}

// dscale[c] = the sum of the `ctas` partial rows, in fp64, rounded once:
// warp j of the CTA of column slab c / 32 adds rows j, j + 32, ... in turn,
// then the 32 warps' sums are added as a pairwise tree.
template <typename S>
__global__ void __launch_bounds__(kReduceWarps * 32)
rmsnorm_dscale_tree_kernel(const double* __restrict__ partial, S* __restrict__ dscale, int ctas,
                           int D) {
  __shared__ double sums[kReduceWarps][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (c < D)
    for (int i = warp; i < ctas; i += kReduceWarps) s += partial[static_cast<long long>(i) * D + c];
  sums[warp][lane] = s;
  __syncthreads();
  // the tree in shared memory, a level a barrier: sums[w] += sums[w + half]
#pragma unroll
  for (int half = kReduceWarps / 2; half > 0; half >>= 1) {
    if (warp < half) sums[warp][lane] += sums[warp + half][lane];
    __syncthreads();
  }
  if (warp == 0 && c < D) dscale[c] = from_f<S>(static_cast<float>(sums[0][lane]));
}

template <typename T, typename S, int VPL>
int launch_bwd_rows(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                    void* partial, long long rows, int D, float eps, int rows_per_warp,
                    int ctas, cudaStream_t stream) {
  const size_t smem = scale_bytes(D, sizeof(S)) + sizeof(double) * kBwdRowWarps * D;
  rmsnorm_bwd_rows_kernel<T, S, VPL><<<ctas, kBwdRowWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<double*>(partial), rows, D, eps, rows_per_warp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_tree_kernel<S><<<(D + 31) / 32, kReduceWarps * 32, 0, stream>>>(
      static_cast<const double*>(partial), static_cast<S*>(dscale), ctas, D);
  return static_cast<int>(cudaGetLastError());
}

// vpl 16-byte vectors a lane, at most 32 floats of dscale sums a lane.
template <typename T, typename S>
int launch_bwd_vpl(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                   void* partial, long long rows, int D, float eps, int vpl, int rows_per_warp,
                   int ctas, cudaStream_t stream) {
  const int nvec = D / Vec<T>::N;
  const bool ok = rows > 0 && D > 0 && (D * sizeof(T)) % 16 == 0 &&
                  (D * sizeof(S)) % 16 == 0 && (nvec + 31) / 32 <= vpl &&
                  vpl * Vec<T>::N <= 32 && rows_per_warp > 0 && ctas > 0 &&
                  static_cast<long long>(ctas) * kBwdRowWarps * rows_per_warp >= rows &&
                  aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(scale);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
#define RMS_BWD_ROWS(V)                                                                   \
  return launch_bwd_rows<T, S, V>(x, scale, dy, dx, dscale, partial, rows, D, eps,       \
                                  rows_per_warp, ctas, stream)
  switch (vpl) {
    case 1: RMS_BWD_ROWS(1);
    case 2: RMS_BWD_ROWS(2);
    case 4: RMS_BWD_ROWS(4);
    case 8:
      if constexpr (Vec<T>::N * 8 <= 32) RMS_BWD_ROWS(8);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RMS_BWD_ROWS
}

// ---- cta_rows body

constexpr int kBwdCtaMaxWarps = 8;  // warps a row of rmsnorm_bwd_cta_kernel at most

// Rows [blockIdx.x * rows_per_cta, +rows_per_cta) of dx, the CTA's warps on
// one row at a time, and this CTA's row of `partial` (D doubles): each
// thread owns the columns of its vectors and sums dy * x^ over the rows in
// fp64.  Thread k's vectors of a row are k, k + blockDim.x, ... (VPL of
// them), x and dy read once into registers; the row's two sums are reduced
// by shuffles in each warp and across the warps through shared memory, one
// barrier a row (the warps' sums alternate between two buffers).
template <typename T, typename S, int VPL>
__global__ void __launch_bounds__(kBwdCtaMaxWarps * 32)
rmsnorm_bwd_cta_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       double* __restrict__ partial, long long rows, int D, float eps,
                       int rows_per_cta) {
  extern __shared__ uint4 s_bwd[];  // scale (D values of S), then 2 x warps float2
  constexpr int N = Vec<T>::N;
  const int nvec = D / N, nt = blockDim.x, warps = nt / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < rows ? r0 + rows_per_cta : rows;

  const int n_scale = D * static_cast<int>(sizeof(S)) / 16;
  for (int i = threadIdx.x; i < n_scale; i += nt)
    cp_async16(s_bwd + i, reinterpret_cast<const uint4*>(scale) + i);
  cp_async_wait_all();
  __syncthreads();
  const S* sc = reinterpret_cast<const S*>(s_bwd);
  float2* sums = reinterpret_cast<float2*>(reinterpret_cast<char*>(s_bwd) +
                                           scale_bytes(D, sizeof(S)));

  double part[VPL][N];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) part[i][e] = 0.0;

  int buf = 0;
  for (long long r = r0; r < r1; ++r, buf ^= 1) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * D);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + r * D);
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = threadIdx.x + nt * i;
      const bool in = c < nvec;
      xv[i] = in ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
      dv[i] = in ? __ldg(dyr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = threadIdx.x + nt * i;
      if (c >= nvec) break;
      float xf[N], df[N], s[N];
      unpack<T>(xv[i], xf);
      unpack<T>(dv[i], df);
      load_scale<S, N>(sc + c * N, s);
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        a = fmaf(xf[e], xf[e], a);
        b = fmaf(df[e] * s[e], xf[e], b);
      }
      ss += a;
      sgx += b;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    if (lane == 0) sums[buf * kBwdCtaMaxWarps + warp] = make_float2(ss, sgx);
    __syncthreads();
    // the warps' sums in warp order: every thread gets the same bits
    ss = 0.f;
    sgx = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float2 v = sums[buf * kBwdCtaMaxWarps + w];
      ss += v.x;
      sgx += v.y;
    }
    const float rstd = rsqrtf(ss / D + eps);
    const float mean_gx = sgx * rstd / D;  // mean(g * x^)
    uint4* dxr = reinterpret_cast<uint4*>(dx + r * D);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = threadIdx.x + nt * i;
      if (c >= nvec) break;
      float xf[N], df[N], s[N], out[N];
      unpack<T>(xv[i], xf);
      unpack<T>(dv[i], df);
      load_scale<S, N>(sc + c * N, s);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float xh = xf[e] * rstd;
        out[e] = rstd * (df[e] * s[e] - xh * mean_gx);
        part[i][e] = fma(static_cast<double>(df[e]), static_cast<double>(xh), part[i][e]);
      }
      dxr[c] = pack<T>(out);
    }
  }

  // each column has one owner: the CTA's partial row needs no tree
  double* out = partial + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = threadIdx.x + nt * i;
    if (c >= nvec) break;
#pragma unroll
    for (int e = 0; e < N; ++e) out[c * N + e] = part[i][e];
  }
}

template <typename T, typename S, int VPL>
int launch_bwd_cta(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                   void* partial, long long rows, int D, float eps, int warps,
                   int rows_per_cta, int ctas, cudaStream_t stream) {
  const size_t smem = scale_bytes(D, sizeof(S)) + sizeof(float2) * 2 * kBwdCtaMaxWarps;
  rmsnorm_bwd_cta_kernel<T, S, VPL><<<ctas, warps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<double*>(partial), rows, D, eps, rows_per_cta);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_tree_kernel<S><<<(D + 31) / 32, kReduceWarps * 32, 0, stream>>>(
      static_cast<const double*>(partial), static_cast<S*>(dscale), ctas, D);
  return static_cast<int>(cudaGetLastError());
}

// vpl 16-byte vectors a lane over `warps` warps covering the row, at most
// 32 floats a lane: the instances are the ones rows of 1025 to 8192
// elements take (fp32 5-8 vectors a lane, bf16 3-4).
template <typename T, typename S>
int launch_bwd_cta_vpl(const void* x, const void* scale, const void* dy, void* dx,
                       void* dscale, void* partial, long long rows, int D, float eps, int vpl,
                       int warps, int rows_per_cta, int ctas, cudaStream_t stream) {
  const int nvec = D / Vec<T>::N;
  const bool ok = rows > 0 && D > 0 && (D * sizeof(T)) % 16 == 0 &&
                  (D * sizeof(S)) % 16 == 0 && warps >= 1 && warps <= kBwdCtaMaxWarps &&
                  warps * 32 * vpl >= nvec && vpl * Vec<T>::N <= 32 && rows_per_cta > 0 &&
                  ctas > 0 && static_cast<long long>(ctas) * rows_per_cta >= rows &&
                  aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(scale);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
#define RMS_BWD_CTA(V)                                                                    \
  return launch_bwd_cta<T, S, V>(x, scale, dy, dx, dscale, partial, rows, D, eps, warps, \
                                 rows_per_cta, ctas, stream)
  if constexpr (Vec<T>::N == 4) {
    switch (vpl) {
      case 5: RMS_BWD_CTA(5);
      case 6: RMS_BWD_CTA(6);
      case 7: RMS_BWD_CTA(7);
      case 8: RMS_BWD_CTA(8);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (vpl) {
      case 3: RMS_BWD_CTA(3);
      case 4: RMS_BWD_CTA(4);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef RMS_BWD_CTA
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

// The backward's generic body: dx (like x) and dscale (like scale) from x,
// scale and dy (like x), all contiguous, rows x D.  `partial` is fp32
// scratch of 2 x max_blocks x D; the rows are split over at most max_blocks
// CTAs.  Returns cudaGetLastError() after the launches.
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

// The backward's warp_rows body, on the inputs of rmsnorm_bwd: rows of
// 16-byte vectors of x, dy, dx and scale, vectors_per_lane one of 1, 2, 4, 8
// (at most 32 floats a lane) covering the row; ctas CTAs of 4 warps, each
// warp rows_per_warp rows (they must cover the rows).  `partial` is fp64
// scratch of ctas x D.  Returns cudaErrorInvalidValue on anything else,
// else cudaGetLastError() after the launches.
extern "C" int rmsnorm_bwd_rows(const void* x, const void* scale, const void* dy, void* dx,
                                void* dscale, void* partial, long long rows, int D, float eps,
                                int x_dtype, int scale_dtype, int vectors_per_lane,
                                int rows_per_warp, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = vectors_per_lane, rpw = rows_per_warp;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch_bwd_vpl<float, float>(x, scale, dy, dx, dscale, partial, rows, D, eps, v,
                                        rpw, ctas, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch_bwd_vpl<float, __nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows, D,
                                                eps, v, rpw, ctas, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch_bwd_vpl<__nv_bfloat16, float>(x, scale, dy, dx, dscale, partial, rows, D,
                                                eps, v, rpw, ctas, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch_bwd_vpl<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale, partial,
                                                        rows, D, eps, v, rpw, ctas, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's cta_rows body, on the inputs of rmsnorm_bwd: rows of
// 16-byte vectors of x, dy, dx and scale, a row over `warps` warps (1-8)
// with vectors_per_lane vectors a lane (fp32 5-8, bf16 3-4: at most 32
// floats) covering it; ctas CTAs, each rows_per_cta rows (they must cover the
// rows).  `partial` is fp64 scratch of ctas x D.  Returns
// cudaErrorInvalidValue on anything else, else cudaGetLastError() after the
// launches.
extern "C" int rmsnorm_bwd_cta(const void* x, const void* scale, const void* dy, void* dx,
                               void* dscale, void* partial, long long rows, int D, float eps,
                               int x_dtype, int scale_dtype, int vectors_per_lane, int warps,
                               int rows_per_cta, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = vectors_per_lane, w = warps, rpc = rows_per_cta;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch_bwd_cta_vpl<float, float>(x, scale, dy, dx, dscale, partial, rows, D, eps, v,
                                            w, rpc, ctas, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch_bwd_cta_vpl<float, __nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows, D,
                                                    eps, v, w, rpc, ctas, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch_bwd_cta_vpl<__nv_bfloat16, float>(x, scale, dy, dx, dscale, partial, rows, D,
                                                    eps, v, w, rpc, ctas, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch_bwd_cta_vpl<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale, partial,
                                                            rows, D, eps, v, w, rpc, ctas, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
