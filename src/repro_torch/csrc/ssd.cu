// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// For every (batch b, head h) with group g = h / (H / G), over the chunks of
// Q tokens in order, with an fp32 state (P x N) carried across chunks:
//
//   cum_i    = sum_{t <= i} dt_t * A_h                      (within the chunk)
//   y_i      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//            + exp(cum_i) (state_in C_i)                              (inter)
//            + D_h x_i                                                (skip)
//   state    = exp(cum_{Q-1}) state_in + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_j^T
//
// which is ssd_chunked (src/repro/kernels/ssd/ref.py), and returns y in x's
// type and the fp32 state after the last token.
//
// Replaces the TPU kernel ssd_pallas (src/repro/kernels/ssd/kernel.py, body
// _ssd_kernel).  What differs from it:
//
//   * The TPU kernel walks the chunks on a sequential grid axis and carries
//     the state in VMEM scratch between grid steps.  Blocks on the card run
//     in no order, so the chunk axis is a loop inside one block: a block owns
//     one (b, h) and a slice of PS of the P columns of x, y and the state
//     (y[:, p] and state[p, :] depend on x[:, p] alone), and keeps its
//     state slice in shared memory from the first chunk to the last.
//   * The Pallas wrapper computes dt * A, the within-chunk cumsum, dt * x and
//     exp(total - cum) * dt * x outside the kernel with jnp, so fp32
//     (B, S, H, P) intermediates go through device memory, and it expands B
//     and C to every head.  Here the block reads x, dt, B and C as they are
//     (B and C by group, never copied per head) and computes the rest in
//     shared memory.
//   * The D skip is added in fp32 before the single rounding to x's type,
//     as ssd_chunked does; the Pallas wrapper adds it after the kernel, in
//     x's type (kernel.py:115).
//   * Any S: the last chunk is padded inside the block with dt = 0, x = B =
//     C = 0 (it neither decays nor contributes) and masked at the store.  The
//     TPU kernel asks for S % chunk == 0.
//   * The exponent's argument is masked before the exp, as in both
//     references: exp(cum_i - cum_j) is evaluated only for i >= j, where the
//     argument is <= 0.
//
// What bounds it: operations.  Per (b, h, chunk) the four products are
// Q*Q*N (C B^T), Q*Q*P (scores @ x), Q*N*P (C @ state, skipped for the
// first chunk, whose incoming state is zero) and Q*N*P (B^T @ x)
// multiply-adds, all in fp32 on the FMA units (the references accumulate in
// fp32); the bytes (x, B, C, dt read once, y written once) are far fewer.
// Each thread owns 4 x 4 output tiles and reads its operands as 16-byte
// vectors from shared memory; C B^T is computed for the tiles on or below
// the diagonal only, and scores @ x stops at the diagonal.  One block fills
// one SM (up to 205 KB of shared memory at Q = N = 128, PS = 64), so at
// mamba2-130m's serving shape (B 4, H 24) the card runs B * H * P / PS
// blocks.  Tensor-core products and a chunk-parallel state pass are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;   // chunk
constexpr int kMaxN = 128;   // state dim
constexpr int kMaxP = 128;   // head dim
constexpr int kMaxPS = 64;   // head-dim columns per block
// 4 x 4 tiles per thread: y (Q x PS) and the lower triangle of C B^T (Q x Q)
constexpr int kYItems = (kMaxQ / 4) * (kMaxPS / 4) / kThreads;
constexpr int kCbItems =
    ((kMaxQ / 4) * (kMaxQ / 4 + 1) / 2 + kThreads - 1) / kThreads;

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[a][b] += sum_k A[a * lda + k] * B[b * ldb + k] over k < K (K % 4 == 0)
__device__ __forceinline__ void dot4x4(float (&acc)[4][4], const float* A, int lda,
                                       const float* B, int ldb, int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ld4(A + i * lda + k);
      bv[i] = ld4(B + i * ldb + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// Tile L of the lower triangle (row-major, diagonal included) -> (I, J).
__device__ __forceinline__ void tri_index(int L, int& I, int& J) {
  I = static_cast<int>((sqrtf(8.f * L + 1.f) - 1.f) * 0.5f);
  if ((I + 1) * (I + 2) / 2 <= L) ++I;
  if (I * (I + 1) / 2 > L) --I;
  J = L - I * (I + 1) / 2;
}

__host__ __device__ constexpr int ld_c(int Qp, int N) { return (N > Qp ? N : Qp) + 4; }

__host__ __device__ constexpr int smem_floats(int Qp, int N, int PS) {
  return Qp * ld_c(Qp, N) + Qp * (N + 4) + Qp * (PS + 4) + PS * (N + 4) + 3 * kMaxQ;
}

// the largest block's shared memory (Q = N = 128, PS = 64: 205 KB)
constexpr int kMaxSmemBytes = smem_floats(kMaxQ, kMaxN, kMaxPS) * static_cast<int>(sizeof(float));

// Head-dim columns a block takes: the whole head where it fits, since every
// further block of a head recomputes its C B^T and one block already fills
// an SM.  P is a multiple of 8 up to 128, so P / 2 is a multiple of 4 up to
// kMaxPS.
constexpr int cols_per_block(int P) { return P <= kMaxPS ? P : P / 2; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dskip, T* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int P, int G, int N, int Q,
               int PS) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const int p_base = blockIdx.y * PS;
  const int Qp = (Q + 3) & ~3;
  const int LDC = ld_c(Qp, N), LDN = N + 4, LDP = PS + 4;
  float* cs = reinterpret_cast<float*>(smem4);  // Qp x LDC: C (i, n), then scores^T (j, i)
  float* bs = cs + Qp * LDC;                    // Qp x LDN: B (j, n)
  float* xs = bs + Qp * LDN;                    // Qp x LDP: x (j, p)
  float* st = xs + Qp * LDP;                    // PS x LDN: the state, transposed (p, n)
  float* cum = st + PS * LDN;                   // kMaxQ: within-chunk cumsum of dt * A
  float* wj = cum + kMaxQ;                      // kMaxQ: exp(total - cum_j) * dt_j
  float* dtv = wj + kMaxQ;                      // kMaxQ: dt_j

  const float a_h = A[h], d_h = Dskip[h];
  const int nq4 = Qp / 4, np4 = PS / 4, nn4 = N / 4;
  const int n_y = nq4 * np4, n_cb = nq4 * (nq4 + 1) / 2, n_st = np4 * nn4;
  const long long x_row = static_cast<long long>(H) * P;  // per token
  const long long bc_row = static_cast<long long>(G) * N;
  const T* xb = x + static_cast<long long>(b) * S * x_row + static_cast<long long>(h) * P + p_base;
  T* yb = y + static_cast<long long>(b) * S * x_row + static_cast<long long>(h) * P + p_base;
  const T* Bb = Bm + static_cast<long long>(b) * S * bc_row + static_cast<long long>(g) * N;
  const T* Cb = Cm + static_cast<long long>(b) * S * bc_row + static_cast<long long>(g) * N;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;

  for (int e = tid; e < PS * LDN; e += kThreads) st[e] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    const int rows = min(Q, S - s0);  // tokens of this chunk; the rest is padding

    // ---- 1. the chunk's B, C, x and dt into shared memory, padded with 0
    for (int e = tid; e < Qp * N; e += kThreads) {
      const int t = e / N, n = e - t * N;
      float bv = 0.f, cv = 0.f;
      if (t < rows) {
        const long long o = static_cast<long long>(s0 + t) * bc_row + n;
        bv = to_f32(Bb[o]);
        cv = to_f32(Cb[o]);
      }
      bs[t * LDN + n] = bv;
      cs[t * LDC + n] = cv;
    }
    for (int e = tid; e < Qp * PS; e += kThreads) {
      const int t = e / PS, p = e - t * PS;
      xs[t * LDP + p] = t < rows ? to_f32(xb[static_cast<long long>(s0 + t) * x_row + p]) : 0.f;
    }
    if (tid < kMaxQ) {
      const float d = tid < rows ? dtb[static_cast<long long>(s0 + tid) * H] : 0.f;
      dtv[tid] = d;
      cum[tid] = d * a_h;
    }
    __syncthreads();

    // ---- 2. inclusive cumsum of dt * A over the chunk (Hillis-Steele)
    for (int off = 1; off < Qp; off <<= 1) {
      const float v = (tid < Qp && tid >= off) ? cum[tid - off] : 0.f;
      __syncthreads();
      if (tid < Qp) cum[tid] += v;
      __syncthreads();
    }
    const float total = cum[Qp - 1];  // padding rows add 0
    if (tid < Qp) wj[tid] = expf(total - cum[tid]) * dtv[tid];

    // ---- 3. inter-chunk term y = exp(cum_i) (C @ state) into registers
    // (zero state entering the first chunk), and C B^T on and below the
    // diagonal
    float yacc[kYItems][4][4];
#pragma unroll
    for (int r = 0; r < kYItems; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[r][i][j] = 0.f;
      const int item = tid + r * kThreads;
      if (c > 0 && item < n_y) {
        const int i0 = (item / np4) * 4, p0 = (item - (item / np4) * np4) * 4;
        dot4x4(yacc[r], cs + i0 * LDC, LDC, st + p0 * LDN, LDN, N);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = expf(cum[i0 + i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc[r][i][j] *= e;
        }
      }
    }
    float cb[kCbItems][4][4];
#pragma unroll
    for (int r = 0; r < kCbItems; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[r][i][j] = 0.f;
      const int L = tid + r * kThreads;
      if (L < n_cb) {
        int I, J;
        tri_index(L, I, J);
        dot4x4(cb[r], cs + I * 4 * LDC, LDC, bs + J * 4 * LDN, LDN, N);
      }
    }
    __syncthreads();  // every read of C and of the state entering the chunk is done

    // ---- 4. scores^T (j, i) = C_i.B_j exp(cum_i - cum_j) dt_j for i >= j,
    // over C's buffer; the state update
#pragma unroll
    for (int r = 0; r < kCbItems; ++r) {
      const int L = tid + r * kThreads;
      if (L < n_cb) {
        int I, J;
        tri_index(L, I, J);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ii = I * 4 + i, jj = J * 4 + j;
            // the argument is masked before the exp: i >= j keeps it <= 0
            cs[jj * LDC + ii] = ii >= jj ? cb[r][i][j] * expf(cum[ii] - cum[jj]) * dtv[jj] : 0.f;
          }
        }
      }
    }
    const float decay = expf(total);
    for (int item = tid; item < n_st; item += kThreads) {
      const int p0 = (item / nn4) * 4, n0 = (item - (item / nn4) * nn4) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int t = 0; t < Qp; ++t) {
        const float w = wj[t];
        const float4 xv = ld4(xs + t * LDP + p0);
        const float4 bv = ld4(bs + t * LDN + n0);
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xw[i], bb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* sp = st + (p0 + i) * LDN + n0 + j;
          *sp = fmaf(decay, *sp, acc[i][j]);
        }
    }
    __syncthreads();  // scores^T written

    // ---- 5. intra-chunk term y += scores @ x (j <= i), the D skip in fp32,
    // one rounding to x's type at the store
#pragma unroll
    for (int r = 0; r < kYItems; ++r) {
      const int item = tid + r * kThreads;
      if (item < n_y) {
        const int i0 = (item / np4) * 4, p0 = (item - (item / np4) * np4) * 4;
        const int jmax = min(i0 + 4, Qp);
        for (int t = 0; t < jmax; ++t) {
          const float4 sv = ld4(cs + t * LDC + i0);
          const float4 xv = ld4(xs + t * LDP + p0);
          const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yacc[r][i][j] = fmaf(sa[i], xa[j], yacc[r][i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i0 + i < rows) {
            T* yo = yb + static_cast<long long>(s0 + i0 + i) * x_row + p0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              yo[j] = from_f32<T>(yacc[r][i][j] + xs[(i0 + i) * LDP + p0 + j] * d_h);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites C's, B's and x's buffers
  }

  // ---- the state after the last token: state_out (B, H, P, N)
  float* so = state_out + (static_cast<long long>(bh) * P + p_base) * N;
  for (int e = tid; e < PS * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    so[static_cast<long long>(p) * N + n] = st[p * LDN + n];
  }
}

// Raises ssd_kernel<T>'s shared-memory limit to the largest block's, once
// for each device (the attribute belongs to the device's context).
template <typename T>
cudaError_t allow_max_smem() {
  static std::atomic<uint64_t> done{0};  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* D, void* y, void* state, int B, int S, int H, int P, int G, int N,
           int Q, cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Qp = (Q + 3) & ~3, PS = cols_per_block(P);
  const int bytes = smem_floats(Qp, N, PS) * static_cast<int>(sizeof(float));
  const dim3 grid(B * H, P / PS);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(state), S, H, P, G, N, Q, PS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (B,S,H,P), Bm, Cm (B,S,G,N) contiguous, of one type; dt (B,S,H), A,
// D (H,) float32; state (B,H,P,N) float32, written with the state after the
// last token.  chunk 16-128; P and N multiples of 8 up to 128; G divides H.
// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* D, void* y, void* state, int B, int S,
                       int H, int P, int G, int N, int chunk, int dtype, void* stream) {
  if (chunk < 16 || chunk > kMaxQ || N <= 0 || N % 8 || N > kMaxN || P <= 0 || P % 8 ||
      P > kMaxP || G <= 0 || H <= 0 || H % G || B <= 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, G, N, chunk, st);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, G, N, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
