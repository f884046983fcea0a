// RG-LRU linear-recurrence scan for Hopper (sm_90a):
//
//   h_t = exp(la_t) * h_{t-1} + sqrt(max(1 - exp(2 la_t), 1e-12)) * gx_t
//
// over t = 0 .. S-1 for every (batch, channel), with an fp32 state, an
// optional initial state h0, the outputs y_t = h_t in the inputs' type and
// the fp32 state after the last step.
//
// Replaces the TPU kernel rglru_pallas (src/repro/kernels/rglru/kernel.py:50,
// body _rglru_kernel), which walks a sequential grid axis over 128-step time
// blocks and carries a 128-lane slice of the state in VMEM scratch between
// grid steps.  Blocks on the card run in no order, so neither body carries
// state between blocks.  In both, S, W and B need no alignment (the TPU
// kernel asks for S % 128 and W % 128), channels past W are masked, and
// h_last is the fp32 state (the Pallas kernel rounds it through gx's type),
// as rglru_sequential returns it.  Two bodies:
//
// * serial (entry rglru_fwd; every S, decode's S = 1): a thread owns one
//   (b, w) channel for the whole sequence, with its state in a register, and
//   computes what rglru_sequential computes, bit for bit.  Neighbouring
//   threads take neighbouring w, so every step's loads and stores are
//   coalesced across the warp; la and gx do not depend on h, so each thread
//   issues the loads of kAhead steps before it runs their recurrence.
//
// * segmented (entry rglru_fwd_segmented; prefill, S >= 64): a block owns 32
//   consecutive channels (one 128-byte fp32 row a step) and walks time in
//   windows of kSegments * L steps; warp k owns the segment of L steps
//   k L .. k L + L - 1 of the window.  Each thread loads its L steps of la and
//   gx at once (2 L loads in flight), computes a = exp(la) and
//   u = sqrt(max(1 - exp(2 la), 1e-12)) gx in registers with the reference's
//   roundings, composes its segment into (prod a, h from 0) and writes the
//   pair to shared memory.  Each thread then composes the segments before
//   its own onto the carry (h0, or the last window's state) and reruns its L
//   steps from there, storing y.  The inputs are read once and y written
//   once.  It computes rglru_assoc's function (src/repro/kernels/rglru/ref.py,
//   the JAX package's path for S >= 64): the composition rounds in another
//   order than the sequential scan, within the JAX suite's 1e-4.  Steps past
//   S are identity steps (la = gx = 0: a = 1, u = 0).
//
// What bounds it: bytes.  At the recurrentgemma-9b serving shape (B 4,
// S 512, W 4096, fp32 inputs, h0) it reads la and gx once (2 x 33.6 MB) and
// writes y once (33.6 MB): 100.8 MB, 0.03009 ms at 3.35 TB/s, against about
// 9 operations an element; the inputs do not fit in the 50 MB L2.  The
// serial body runs B * W = 16,384 threads, about 4 warps an SM, too few to
// keep enough bytes in flight; the segmented body runs B * W * kSegments
// threads (262,144 at that shape), each with 2 L loads in flight.
// L = kSegmentSteps = 16 (64 registers a thread, two 512-thread blocks an
// SM) was the fastest of 8, 16 and 32 on the card (PERF.md); at 32 a
// thread needs 112 registers and one block fills an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kAhead = 16;    // steps whose loads are issued before their recurrence

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_kernel(const T* __restrict__ la, const T* __restrict__ gx,
                 const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last,
                 int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const long long chan = static_cast<long long>(b) * W + w;
  const long long base = static_cast<long long>(b) * S * W + w;
  float h = h0 != nullptr ? h0[chan] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kAhead) {
    float a[kAhead], x[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      a[i] = 0.f;
      x[i] = 0.f;
      if (t0 + i < S) {
        const long long o = base + static_cast<long long>(t0 + i) * W;
        a[i] = to_f32(la[o]);
        x[i] = to_f32(gx[o]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t0 + i < S) {
        // The reference's roundings: u = beta * gx, then h = exp(la) * h + u,
        // with no fused multiply-add.
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * a[i]), 1e-12f));
        h = __fadd_rn(__fmul_rn(expf(a[i]), h), __fmul_rn(beta, x[i]));
        y[base + static_cast<long long>(t0 + i) * W] = from_f32<T>(h);
      }
    }
  }
  h_last[chan] = h;
}

template <typename T>
int launch(const void* la, const void* gx, const void* h0, void* y, void* h_last, int B, int S,
           int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(la), static_cast<const T*>(gx), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kSegments = 16;      // segments (warps) of a segmented block
constexpr int kSegmentSteps = 16;  // L: the steps of a segment, in registers

template <typename T>
__global__ void __launch_bounds__(kSegments * 32)
    rglru_segmented_kernel(const T* __restrict__ la, const T* __restrict__ gx,
                           const float* __restrict__ h0, T* __restrict__ y,
                           float* __restrict__ h_last, int S, int W) {
  constexpr int L = kSegmentSteps;
  __shared__ float seg_a[kSegments][32], seg_u[kSegments][32], carry[32];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + lane, b = blockIdx.y;
  const bool live = w < W;
  const long long chan = static_cast<long long>(b) * W + w;
  const long long base = static_cast<long long>(b) * S * W + w;
  if (k == 0) carry[lane] = live && h0 != nullptr ? h0[chan] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kSegments * L) {
    const int ts = t0 + k * L;  // this segment's first step
    float a[L], u[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      a[i] = 0.f;
      u[i] = 0.f;
      if (live && ts + i < S) {
        const long long o = base + static_cast<long long>(ts + i) * W;
        a[i] = to_f32(la[o]);
        u[i] = to_f32(gx[o]);
      }
    }
    // the segment from h = 0: U = h after its last step, A = the product of a
    float A = 1.f, U = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      // the reference's roundings: u = beta * gx, h = a * h + u, no fused
      // multiply-add
      const float beta = sqrtf(fmaxf(1.f - expf(2.f * a[i]), 1e-12f));
      u[i] = __fmul_rn(beta, u[i]);
      a[i] = expf(a[i]);
      U = __fadd_rn(__fmul_rn(a[i], U), u[i]);
      A = __fmul_rn(A, a[i]);
    }
    seg_a[k][lane] = A;
    seg_u[k][lane] = U;
    __syncthreads();
    float h = carry[lane];
    for (int j = 0; j < k; ++j) h = __fadd_rn(__fmul_rn(seg_a[j][lane], h), seg_u[j][lane]);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      h = __fadd_rn(__fmul_rn(a[i], h), u[i]);
      if (live && ts + i < S) y[base + static_cast<long long>(ts + i) * W] = from_f32<T>(h);
    }
    __syncthreads();  // every thread has read the carry and the segments
    if (k == kSegments - 1) carry[lane] = h;
    __syncthreads();
  }
  if (k == 0 && live) h_last[chan] = carry[lane];
}

template <typename T>
int launch_segmented(const void* la, const void* gx, const void* h0, void* y, void* h_last,
                     int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + 31) / 32, B);
  rglru_segmented_kernel<T><<<grid, kSegments * 32, 0, stream>>>(
      static_cast<const T*>(la), static_cast<const T*>(gx), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The serial body.  la, gx and y (B,S,W) contiguous, of one type; h0 (B,W)
// float32 or null; h_last (B,W) float32.  dtype codes: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int rglru_fwd(const void* la, const void* gx, const void* h0, void* y, void* h_last,
                         int B, int S, int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(la, gx, h0, y, h_last, B, S, W, st);
    case 1: return launch<__nv_bfloat16>(la, gx, h0, y, h_last, B, S, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The segmented body: arguments as rglru_fwd's.
extern "C" int rglru_fwd_segmented(const void* la, const void* gx, const void* h0, void* y,
                                   void* h_last, int B, int S, int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_segmented<float>(la, gx, h0, y, h_last, B, S, W, st);
    case 1: return launch_segmented<__nv_bfloat16>(la, gx, h0, y, h_last, B, S, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
