// RG-LRU linear-recurrence scan for Hopper (sm_90a):
//
//   h_t = exp(la_t) * h_{t-1} + sqrt(max(1 - exp(2 la_t), 1e-12)) * gx_t
//
// over t = 0 .. S-1 for every (batch, channel), with an fp32 state, an
// optional initial state h0, the outputs y_t = h_t in the inputs' type and
// the fp32 state after the last step.
//
// Replaces the TPU kernel rglru_pallas (src/repro/kernels/rglru/kernel.py,
// body _rglru_kernel).  It computes what rglru_sequential computes
// (src/repro/kernels/rglru/ref.py), not what the TPU kernel does block by
// block:
//
//   * The TPU kernel walks a sequential grid axis over 128-step time blocks
//     and carries a 128-lane slice of the state in VMEM scratch between grid
//     steps.  Blocks on the card run in no order, so the time axis becomes a
//     loop inside one thread: a thread owns one (b, w) channel for the whole
//     sequence, with its state in a register, and no state ever goes to
//     device memory between steps.
//   * Neighbouring threads take neighbouring w, so every step's loads and
//     stores are coalesced across the warp.  la and gx do not depend on h,
//     so each thread issues the loads of kAhead steps before it runs their
//     recurrence: kAhead loads of each input are in flight per thread while
//     the dependent chain of fmas waits on none of them.
//   * S, W and B need no alignment (the TPU kernel asks for S % 128 and
//     W % 128): the last block masks the channels past W, and the last
//     group of steps masks the steps past S.
//   * h_last is the fp32 state (the Pallas kernel rounds it through gx's
//     type), as rglru_sequential returns it.
//
// What bounds it: bytes.  At the recurrentgemma-9b serving shape (B 4,
// S 512, W 4096, fp32 inputs) it reads la and gx once (2 x 33.6 MB) and
// writes y once (33.6 MB): 0.030 ms at 3.35 TB/s, against about 4 flops an
// element.  B * W = 16,384 threads are about 4 warps an SM, too few to hide
// the memory latency with one thread per channel; the loads issued ahead are
// what this design does about it.  A two-pass chunked scan over time (local
// scans of time chunks in parallel, then a pass that carries the state
// across chunks) would fill the card and is later work.
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

}  // namespace

// la, gx and y (B,S,W) contiguous, of one type; h0 (B,W) float32 or null;
// h_last (B,W) float32.  dtype codes: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch.
extern "C" int rglru_fwd(const void* la, const void* gx, const void* h0, void* y, void* h_last,
                         int B, int S, int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(la, gx, h0, y, h_last, B, S, W, st);
    case 1: return launch<__nv_bfloat16>(la, gx, h0, y, h_last, B, S, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
