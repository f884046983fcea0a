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
//
// The backward: the gradients of y and h_last by the reverse scan
//
//   dh_t = dy_t + a_{t+1} dh_{t+1}   (from dh_last, or 0)
//   d gx_t = beta_t dh_t,   d la_t = dh_t (a_t h_{t-1} - gx_t exp(2 la_t) / beta_t)
//   dh0 = a_1 dh_1
//
// with no gradient through beta where its clamp holds (1 - exp(2 la) below
// 1e-12), which is rglru_bwd (src/repro_torch/kernels/rglru/ref.py).  The TPU
// package has no backward kernel: JAX differentiates the jnp reference.  Two
// bodies, both dtypes:
//
// * segmented (entry rglru_bwd_segmented; S >= 64, where the forward is
//   segmented): the reverse carry c_t = a_{t+1} (dy_{t+1} + c_{t+1}) is
//   affine in c, as h is in h_{t-1}, so the forward body's segmentation
//   carries over.  A block owns 32 channels and walks time in windows of
//   kBwdSegments * kBwdSteps = 512 steps, last window first; warp k owns
//   the kBwdSteps = 32 steps k L .. k L + L - 1 of the window, loaded once
//   into shared memory (192 KB a block: in registers they spilled).  Each
//   thread composes its segment both ways: forward into (A = prod a, U = h
//   from 0) and backward into (A, V = the carry leaving its first step from
//   0, sum_t (prod_{s <= t} a_s) dy_t), and writes the pairs to shared
//   memory.  Then it composes the segments before its own onto the state
//   entering the window (h0, or the state pass 1 saved) and the segments
//   after its own, last first, onto the carry entering the window from the
//   right (dh_last, or the carry the later window left); walks its steps
//   forward to form q_t = a_t h_{t-1} + gx_t dbeta_t in place of gx_t, and
//   back to write d gx and d la.  Warp 0's carry leaves the window; after
//   the first window it is dh0.  With S <= 512 there is one window and
//   la, gx and dy are read once, d la and d gx written once: the bytes
//   bound.  Past 512 steps a first pass walks the windows but the last
//   forward (la and gx once more) to save the state entering each in the
//   workspace h_win (B, windows, W) fp32.  It computes rglru_bwd's
//   function in another rounding order (kernels/rglru/ref.py
//   rglru_bwd_segmented models it), within the JAX suite's 1e-4.
//
// * serial (entry rglru_bwd; every S, the previous body): a thread owns one
//   (b, w) channel: it walks the sequence forward once, recomputing h in
//   fp32 with the reference's roundings and saving the state entering every
//   kBwdSegment-step segment (workspace (B, nseg, W) fp32, a sixteenth of
//   the inputs), then walks the segments in reverse: it loads a segment's
//   la, gx and dy at once, recomputes the segment's states from its saved
//   one in registers, and runs the reverse recurrence over them.  So la and
//   gx are read twice, dy once, and d la and d gx written once; B * W
//   threads (16,384 at recurrentgemma-9b's train step) keep too few bytes
//   in flight.
//
// What bounds the backward: bytes.  At recurrentgemma-9b's train step (B 4,
// S 512, W 4096, fp32) la, gx and dy read once and d la and d gx written
// once are 167.8 MB, 0.05008 ms at 3.35 TB/s, against about 30 operations an
// element.
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

constexpr int kBwdThreads = 64;   // channels per block of the backward
constexpr int kBwdSegment = 16;   // steps between the states the backward saves

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    rglru_bwd_kernel(const T* __restrict__ la, const T* __restrict__ gx,
                     const T* __restrict__ dy, const float* __restrict__ h0,
                     const float* __restrict__ dh_last, float* h_saved, T* __restrict__ dla,
                     T* __restrict__ dgx, float* __restrict__ dh0, int S, int W) {
  constexpr int L = kBwdSegment;
  const int w = blockIdx.x * kBwdThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const long long chan = static_cast<long long>(b) * W + w;
  const long long base = static_cast<long long>(b) * S * W + w;
  const int nseg = (S + L - 1) / L;
  float* hs = h_saved + static_cast<long long>(b) * nseg * W + w;  // (B, nseg, W)

  // forward: h from h0, the state entering each segment saved
  float h = h0 != nullptr ? h0[chan] : 0.f;
  for (int k = 0; k < nseg; ++k) {
    hs[static_cast<long long>(k) * W] = h;
    float a[L], x[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int t = k * L + i;
      a[i] = 0.f;
      x[i] = 0.f;
      if (t < S) {
        const long long o = base + static_cast<long long>(t) * W;
        a[i] = to_f32(la[o]);
        x[i] = to_f32(gx[o]);
      }
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (k * L + i < S) {
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * a[i]), 1e-12f));
        h = __fadd_rn(__fmul_rn(expf(a[i]), h), __fmul_rn(beta, x[i]));
      }
    }
  }

  // reverse, a segment at a time
  float carry = dh_last != nullptr ? dh_last[chan] : 0.f;  // a_{t+1} dh_{t+1}
  for (int k = nseg - 1; k >= 0; --k) {
    float a[L], x[L], g[L], hp[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int t = k * L + i;
      a[i] = 0.f;
      x[i] = 0.f;
      g[i] = 0.f;
      if (t < S) {
        const long long o = base + static_cast<long long>(t) * W;
        a[i] = to_f32(la[o]);
        x[i] = to_f32(gx[o]);
        g[i] = to_f32(dy[o]);
      }
    }
    float hh = hs[static_cast<long long>(k) * W];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      hp[i] = hh;  // h_{t-1}
      if (k * L + i < S) {
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * a[i]), 1e-12f));
        hh = __fadd_rn(__fmul_rn(expf(a[i]), hh), __fmul_rn(beta, x[i]));
      }
    }
#pragma unroll
    for (int i = L - 1; i >= 0; --i) {
      const int t = k * L + i;
      if (t < S) {
        const float e2 = expf(2.f * a[i]);
        const float v = 1.f - e2;
        const float beta = sqrtf(fmaxf(v, 1e-12f));
        const float dbeta = v >= 1e-12f ? -e2 / beta : 0.f;
        const float at = expf(a[i]);
        const float gt = g[i] + carry;
        const long long o = base + static_cast<long long>(t) * W;
        dgx[o] = from_f32<T>(beta * gt);
        dla[o] = from_f32<T>(gt * (at * hp[i] + x[i] * dbeta));
        carry = at * gt;
      }
    }
  }
  if (dh0 != nullptr) dh0[chan] = carry;
}

template <typename T>
int launch_bwd(const void* la, const void* gx, const void* dy, const void* h0,
               const void* dh_last, void* h_saved, void* dla, void* dgx, void* dh0, int B, int S,
               int W, cudaStream_t stream) {
  const dim3 grid((W + kBwdThreads - 1) / kBwdThreads, B);
  rglru_bwd_kernel<T><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(la), static_cast<const T*>(gx), static_cast<const T*>(dy),
      static_cast<const float*>(h0), static_cast<const float*>(dh_last),
      static_cast<float*>(h_saved), static_cast<T*>(dla), static_cast<T*>(dgx),
      static_cast<float*>(dh0), S, W);
  return static_cast<int>(cudaGetLastError());
}


constexpr int kBwdSegments = 16;  // segments (warps) of a segmented backward block
constexpr int kBwdSteps = 32;     // L: the steps of a backward segment
constexpr int kBwdWindow = kBwdSegments * kBwdSteps;
constexpr int kBwdSegThreads = kBwdSegments * 32;
// la, gx (then q) and dy of every thread's steps, fp32: 192 KB
constexpr size_t kBwdSegSmem = sizeof(float) * 3 * kBwdSteps * kBwdSegThreads;

// beta = sqrt(max(1 - exp(2 la), 1e-12)) and its derivative in la, 0 where
// the clamp holds (rglru_bwd's)
__device__ __forceinline__ void beta_dbeta(float la, float* beta, float* dbeta) {
  const float e2 = expf(2.f * la);
  const float v = 1.f - e2;
  *beta = sqrtf(fmaxf(v, 1e-12f));
  *dbeta = v >= 1e-12f ? -e2 / *beta : 0.f;
}

// Each thread's steps live in shared memory, step-major ([step][thread]:
// conflict-free), not in registers: la, gx and dy of 32 steps and what the
// walks derive from them took 128 registers and spilled at 512 threads a
// block.  A thread reads only what it wrote, so the staging needs no
// barrier; __syncwarp between the walks keeps the compiler from holding a
// walk's values in registers for the next.
template <typename T>
__global__ void __launch_bounds__(kBwdSegThreads, 1)
    rglru_bwd_segmented_kernel(const T* __restrict__ la, const T* __restrict__ gx,
                               const T* __restrict__ dy, const float* __restrict__ h0,
                               const float* __restrict__ dh_last, float* __restrict__ h_win,
                               T* __restrict__ dla, T* __restrict__ dgx,
                               float* __restrict__ dh0, int S, int W) {
  constexpr int L = kBwdSteps, N = kBwdSegThreads, kChunk = 8;
  extern __shared__ __align__(16) float lru_smem[];
  float* sl = lru_smem + threadIdx.x;  // la of step i at sl[i * N]
  float* sq = sl + L * N;              // gx, then q_t = a_t h_{t-1} + gx_t dbeta_t
  float* sg = sq + L * N;              // dy
  __shared__ float seg_a[kBwdSegments][32], seg_u[kBwdSegments][32], seg_c[kBwdSegments][32];
  __shared__ float h_in[32], c_in[32];  // the window's entry state and right-hand carry
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + lane, b = blockIdx.y;
  const bool live = w < W;
  const long long chan = static_cast<long long>(b) * W + w;
  const long long base = static_cast<long long>(b) * S * W + w;
  const int nwin = (S + kBwdWindow - 1) / kBwdWindow;
  float* hw = h_win + static_cast<long long>(b) * nwin * W + w;  // (B, nwin, W)
  if (k == 0) {
    h_in[lane] = live && h0 != nullptr ? h0[chan] : 0.f;
    c_in[lane] = live && dh_last != nullptr ? dh_last[chan] : 0.f;
  }

  // pass 1 (S past one window): the state entering each window but the
  // last saved, the last one's left in h_in
  for (int win = 0; win + 1 < nwin; ++win) {
    const int ts = win * kBwdWindow + k * L;
    float A = 1.f, U = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float l = 0.f, x = 0.f;
      if (live && ts + i < S) {
        const long long o = base + static_cast<long long>(ts + i) * W;
        l = to_f32(la[o]);
        x = to_f32(gx[o]);
      }
      const float a = expf(l), beta = sqrtf(fmaxf(1.f - expf(2.f * l), 1e-12f));
      U = __fadd_rn(__fmul_rn(a, U), __fmul_rn(beta, x));
      A = __fmul_rn(A, a);
    }
    seg_a[k][lane] = A;
    seg_u[k][lane] = U;
    __syncthreads();
    if (k == 0) {
      float h = h_in[lane];
      if (live) hw[static_cast<long long>(win) * W] = h;
      for (int j = 0; j < kBwdSegments; ++j)
        h = __fadd_rn(__fmul_rn(seg_a[j][lane], h), seg_u[j][lane]);
      h_in[lane] = h;
    }
    __syncthreads();
  }

  // pass 2: the windows last first
  for (int win = nwin - 1; win >= 0; --win) {
    const int ts = win * kBwdWindow + k * L;  // this segment's first step
    if (k == 0 && win < nwin - 1) h_in[lane] = live ? hw[static_cast<long long>(win) * W] : 0.f;
    // the steps into shared memory, kChunk at a time, and the segment's
    // pairs from 0: forward (A = prod a, U = h) and backward (V = the carry
    // leaving its first step, sum_t (prod_{s <= t} a_s) dy_t)
    float A = 1.f, U = 0.f, V = 0.f;
#pragma unroll
    for (int i0 = 0; i0 < L; i0 += kChunk) {
      float l[kChunk], x[kChunk], g[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        l[i] = x[i] = g[i] = 0.f;  // steps past S are identity steps
        if (live && ts + i0 + i < S) {
          const long long o = base + static_cast<long long>(ts + i0 + i) * W;
          l[i] = to_f32(la[o]);
          x[i] = to_f32(gx[o]);
          g[i] = to_f32(dy[o]);
        }
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        sl[(i0 + i) * N] = l[i];
        sq[(i0 + i) * N] = x[i];
        sg[(i0 + i) * N] = g[i];
        const float a = expf(l[i]), beta = sqrtf(fmaxf(1.f - expf(2.f * l[i]), 1e-12f));
        U = __fadd_rn(__fmul_rn(a, U), __fmul_rn(beta, x[i]));
        A = __fmul_rn(A, a);
        V = __fadd_rn(V, __fmul_rn(A, g[i]));
      }
    }
    seg_a[k][lane] = A;
    seg_u[k][lane] = U;
    seg_c[k][lane] = V;
    __syncthreads();
    float h = h_in[lane];
    for (int j = 0; j < k; ++j) h = __fadd_rn(__fmul_rn(seg_a[j][lane], h), seg_u[j][lane]);
    float c = c_in[lane];
    for (int j = kBwdSegments - 1; j > k; --j)
      c = __fadd_rn(__fmul_rn(seg_a[j][lane], c), seg_c[j][lane]);
#pragma unroll 8
    for (int i = 0; i < L; ++i) {
      float beta, dbeta;
      const float l = sl[i * N], x = sq[i * N];
      beta_dbeta(l, &beta, &dbeta);
      const float a = expf(l);
      sq[i * N] = a * h + x * dbeta;  // d la_t / dh_t
      h = __fadd_rn(__fmul_rn(a, h), __fmul_rn(beta, x));
    }
    __syncwarp();
#pragma unroll 8
    for (int i = L - 1; i >= 0; --i) {
      const float l = sl[i * N];
      const float beta = sqrtf(fmaxf(1.f - expf(2.f * l), 1e-12f));
      const float gt = sg[i * N] + c;
      if (live && ts + i < S) {
        const long long o = base + static_cast<long long>(ts + i) * W;
        dgx[o] = from_f32<T>(beta * gt);
        dla[o] = from_f32<T>(gt * sq[i * N]);
      }
      c = expf(l) * gt;
    }
    __syncthreads();  // every thread has read the carries and the segments
    if (k == 0) c_in[lane] = c;  // the carry leaving the window's first step
    __syncthreads();
  }
  if (k == 0 && live && dh0 != nullptr) dh0[chan] = c_in[lane];
}

template <typename T>
int launch_bwd_segmented(const void* la, const void* gx, const void* dy, const void* h0,
                         const void* dh_last, void* h_win, void* dla, void* dgx, void* dh0,
                         int B, int S, int W, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_bwd_segmented_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSegSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + 31) / 32, B);
  rglru_bwd_segmented_kernel<T><<<grid, kBwdSegThreads, kBwdSegSmem, stream>>>(
      static_cast<const T*>(la), static_cast<const T*>(gx), static_cast<const T*>(dy),
      static_cast<const float*>(h0), static_cast<const float*>(dh_last),
      static_cast<float*>(h_win), static_cast<T*>(dla), static_cast<T*>(dgx),
      static_cast<float*>(dh0), S, W);
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

// The backward.  la, gx, dy, dla, dgx (B,S,W) contiguous, of one type; h0,
// dh_last, dh0 (B,W) float32 or null (dh0 is written when given); h_saved
// the float32 workspace (B, ceil(S / 16), W).  S >= 1.  Returns
// cudaGetLastError() after the launch.
extern "C" int rglru_bwd(const void* la, const void* gx, const void* dy, const void* h0,
                         const void* dh_last, void* h_saved, void* dla, void* dgx, void* dh0,
                         int B, int S, int W, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(la, gx, dy, h0, dh_last, h_saved, dla, dgx, dh0, B, S, W, st);
    case 1:
      return launch_bwd<__nv_bfloat16>(la, gx, dy, h0, dh_last, h_saved, dla, dgx, dh0, B, S, W,
                                       st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The segmented backward: arguments as rglru_bwd's, but h_win, the float32
// workspace (B, ceil(S / 512), W), is used only past 512 steps and may be
// null up to there.
extern "C" int rglru_bwd_segmented(const void* la, const void* gx, const void* dy,
                                   const void* h0, const void* dh_last, void* h_win, void* dla,
                                   void* dgx, void* dh0, int B, int S, int W, int dtype,
                                   void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || (S > kBwdWindow && h_win == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd_segmented<float>(la, gx, dy, h0, dh_last, h_win, dla, dgx, dh0, B, S,
                                         W, st);
    case 1:
      return launch_bwd_segmented<__nv_bfloat16>(la, gx, dy, h0, dh_last, h_win, dla, dgx, dh0,
                                                 B, S, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
