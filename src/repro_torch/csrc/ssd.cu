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
// type and the fp32 state after the last token.  Every entry takes a chunk
// Q of 16-128 tokens; the wrapper (kernels/ssd/kernel.py) runs a larger
// chunk at a tile of 128, since the chunked scan computes the same function
// at any chunk (only the order of its fp32 sums changes).
//
// Replaces the TPU kernel ssd_pallas (src/repro/kernels/ssd/kernel.py:71,
// body _ssd_kernel).  Three bodies (mma_tf32x3 is described after the
// backward's, whose kernels it shares):
//
// * fma (entry ssd_fwd; float32 and bfloat16): one block a (b, h) walks the
//   chunks in order with the state in shared memory, all products in fp32 on
//   the FMA units.  What differs from the TPU kernel:
//   - The TPU kernel walks the chunks on a sequential grid axis and carries
//     the state in VMEM scratch between grid steps.  Blocks on the card run
//     in no order, so the chunk axis is a loop inside one block: a block owns
//     one (b, h) and a slice of PS of the P columns of x, y and the state
//     (y[:, p] and state[p, :] depend on x[:, p] alone), and keeps its
//     state slice in shared memory from the first chunk to the last.
//   - The Pallas wrapper computes dt * A, the within-chunk cumsum, dt * x and
//     exp(total - cum) * dt * x outside the kernel with jnp, so fp32
//     (B, S, H, P) intermediates go through device memory, and it expands B
//     and C to every head.  Here the block reads x, dt, B and C as they are
//     (B and C by group, never copied per head) and computes the rest in
//     shared memory.
//   - The D skip is added in fp32 before the single rounding to x's type,
//     as ssd_chunked does; the Pallas wrapper adds it after the kernel, in
//     x's type (kernel.py:115).
//   - Any S: the last chunk is padded inside the block with dt = 0, x = B =
//     C = 0 (it neither decays nor contributes) and masked at the store.  The
//     TPU kernel asks for S % chunk == 0.
//   - The exponent's argument is masked before the exp, as in both
//     references: exp(cum_i - cum_j) is evaluated only for i >= j, where the
//     argument is <= 0.
//   Per (b, h, chunk) its four products are Q*Q*N (C B^T), Q*Q*P (scores @
//   x), Q*N*P (C @ state) and Q*N*P (B^T @ x) multiply-adds, in 4 x 4 fp32
//   register tiles.  One block fills one SM (up to 205 KB of shared memory
//   at Q = N = 128, PS = 64), so at mamba2-130m's serving shape (B 4, H 24)
//   the card runs B * H * P / PS = 96 blocks, each through every chunk.
//
// * mma (bfloat16; the served path): chunk-parallel on the tensor cores, in
//   the three phases of ssd_chunked, one launch each, every chunk at once:
//   1. ssd_chunk_state: a block a (chunk, head, batch) computes the chunk's
//      cum (written to cum (B, H, nc * Q) fp32) and its local end state
//      S_c = sum_j exp(total - cum_j) dt_j x_j B_j^T, a (P x N) product over
//      the Q tokens, written in fp32 to states (B, nc, H, P, N).
//   2. ssd_state_pass: one thread a 4-vector of a (b, h) state walks the
//      chunks, overwrites states with the state entering each chunk
//      (s -> exp(total_c) s + S_c; chunk 0's, zero, is neither written nor
//      read) and writes the final state.
//   3. ssd_chunk_scan: a block a (chunk, head, batch) computes
//      y = (C B^T o L o dt_j) x + exp(cum_i) (C state_in^T) + D x, rounded
//      once at the store.  One head a block: a block that walked several
//      heads of a group to share C's tile was slower on the card, since it
//      cost more in blocks an SM than it saved (PERF.md).
//   Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate), their
//   fragments read by ldmatrix, the tiles brought in by cp.async with the
//   padding zero-filled.  x, B and C are bf16 already, so C B^T and every
//   product with them as the only bf16 operand is exact up to the order of
//   the sum.  The operands that the references keep in fp32 (w o x, the
//   scores, the state) are split into hi = bf16(v) and lo = bf16(v - hi)
//   and each enters two products, which keeps about 16 bits of their
//   mantissa (the error stays near fp32's; tests/test_torch_kernels.py
//   measures it beside plain bf16 rounding's).  Masks and padding as in the
//   fma body; the scores' exponent is taken in base 2 of a pre-scaled cum.
//
// What bounds the mma body at mamba2-130m's serving shape (x (4,512,24,64)
// bf16, N 128, chunk 128): bytes.  x, dt, B and C read once, y and the fp32
// state written once are 16.97 MB, 0.00507 ms at 3.35 TB/s; its products on
// the bf16 tensor cores, with every product that has a split operand taken
// twice (chip_smoke.py:ssd_split_macs), are 3.664 GFLOP, 0.00370 ms at 989
// TFLOP/s.  (The fma body does the function's 1.849 GFLOP in fp32 on the FMA
// units, chip_smoke.py:ssd_macs: 0.02760 ms at 67 TFLOP/s.)  Measured on the
// card (globaltimer stamps per block phase): the scan was bound by instruction
// issue and by the latency of each block's load -> product -> store chain, not
// by the tensor cores (removing its products with x saved nothing); the warp
// with the most 16-column tiles under the diagonal set a block's time, and the
// 384 blocks run in two rounds of 264.  What the design does: every chunk and
// head is a block of its own (against the fma body's 96 blocks walking the
// chunks), the fp32 intermediates (states, cum) stay in L2, a scan block needs
// 99 KB of shared memory (B's tile and the state's hi and lo share a buffer)
// and 125 registers, so two share an SM; C B^T is computed one 16-column tile
// at a time just before its scores (software-pipelined with the previous
// tile's products with x, never held whole); row tiles 5-7 hand their score
// tiles from 5 on to the warp that shares their SM sub-partition (a light row
// tile), which passes the sum back through shared memory, so that no warp
// carries much more than the mean; every lane's shared addresses are computed
// once; the chunk states scale and split w o x as each warp reads its A
// fragments.
//
// The backward (entry ssd_bwd; float32 and bfloat16 inputs, fp32 on the FMA
// units): the gradients dx, ddt, dA, dB, dC, dD of y and of the final state
// (ssd_chunked_bwd, src/repro_torch/kernels/ssd/ref.py, in the same phases).
// The TPU package has no backward kernel: JAX differentiates the jnp
// reference.  Six launches on one stream through an fp32 workspace
// (ssd_bwd_workspace_floats):
//   1. ssd_bwd_state_kernel, a block a (chunk, head, batch): the chunk's cum,
//      its local end state sum_j exp(total - cum_j) dt_j x_j B_j^T and
//      E = sum_i exp(cum_i) dy_i C_i^T, the gradient its outputs send to the
//      state entering it.  The forward writes no workspace, so the backward
//      recomputes the chunk states here (each is as costly as one of E) rather
//      than have the forward keep them (12.6 MB a layer at mamba2-130m's train
//      shape, for every layer until its backward).
//   2. ssd_state_pass_kernel (the mma body's): the state entering each chunk.
//   3. ssd_bwd_state_pass_kernel, in reverse: the gradient of each chunk's
//      local state, G_c+1 with G_nc = d_state (or 0) and
//      G_c = exp(total_c) G_c+1 + E_c.
//   4. ssd_bwd_chunk_kernel, a block a (chunk, head, batch): C B^T and dy x^T
//      on and below the diagonal in 4 x 4 register tiles; the scores M, their
//      gradient d(C B^T) and R = dM o M to a per-block scratch in device
//      memory, where the block reads them back (C, B, x and dy fill its
//      shared memory); then dx, and per head dB and dC, as tiles each one
//      thread owns; the sums that cross the tiles are kept as per-tile parts
//      and added in a fixed order.  d(dt A)_t, the reverse cumsum of d cum
//      plus the gradient of the chunk's total (its decay in the state pass
//      and the weights exp(total - cum_j) of its local state), is taken in
//      the form whose large terms do not cancel: sum_{i >= t, j < t} R_ij
//      + sum_{i >= t} exp(cum_i) dy_i . (C state_in^T)_i + sum_{i < t} w_i dw_i
//      + exp(total) <dstate, state_in> (ssd_chunk_scan_bwd).  Each chunk's
//      parts of dA and dD are summed over its tokens as a pairwise tree.
//   cum is summed in double and rounded once (as the plain version's
//   torch.cumsum accumulates): its fp32 Hillis-Steele sum cost exp(cum_i -
//   cum_j) about 1e-5 of relative error at |cum| near 100.
//   5. ssd_bwd_group_kernel: dB and dC summed over each group's heads in
//      order, in the inputs' type.
//   6. ssd_bwd_param_kernel: dA and dD over the batch and the chunks: a lane
//      sums every 256th chunk in turn, then a pairwise tree over the lanes
//      (ssd_sum_ordered).
// No atomics: every sum has one owner and a fixed order, so a second call
// gives the same bits.  exp(cum_i - cum_j) is evaluated only for i >= j.  The
// ragged last chunk is padded with dt = x = B = C = dy = 0 and nothing is
// written past S.  That is the fma body (entry ssd_bwd).
//
// The backward's mma body (entry ssd_bwd_mma; any P and N, multiples of 8
// up to 128, any chunk and S, float32 and bfloat16 inputs): the same phases
// with every product on the TF32 tensor cores, mma.sync m16n8k8, each fp32
// operand split into hi + lo and three products summed small terms first
// (3xTF32, the flash backward's scheme, with truncating splits;
// ref.py:split_einsum and truncate_tf32 model it).  Launches 2, 3, 5 and 6
// are the fma body's; 1 (chunk states and E, a warp a 16-row strip of P) and
// 4 (chunk gradients) are its own, and 1b forms C B^T once for a group's
// heads (mamba2-130m's 24 heads share one group) into the workspace, where
// the fma body kept a 377 MB scratch of every head's scores.  In launch 4 a
// warp owns a 16-token strip; the Q x Q scores, d(C B^T) and R stay in its
// registers (see the kernel).  P past 64 is cut into slabs of kMmaP = 64
// columns (72-120: a ragged second slab, its columns past P zero), a grid
// axis of launches 1 and 4 beside the chunk (slab fastest), so that each
// slab's blocks keep P 64's shared memory and registers: at P = N = chunk =
// 128 the fma body's chunk block would need 269 KB, above the 227 a block
// may have.  What is indexed by p (the chunk states, E, dx) belongs to one
// slab; what sums over p (d(C B^T), hence dB, dC, ddt and the dA / dD parts;
// W, U's dot with x, <dS, state_in>) is linear in each slab's part, which the
// slab writes to the workspace, and launches 5, 6 and 7 (ddt, only with two
// slabs) add the parts in slab order: the same bits on a second call.  C B^T
// does not depend on P and stays one launch 1b a group; what each slab
// repeats is the products of d(C B^T) with B and C (N wide).  What
// bounds it at mamba2-130m's train shape (x, dy (8,1024,24,64) fp32, chunk
// 128): its products, 3 x ssd_bwd_macs = 38.4 G multiply-adds at the TF32
// rate, 0.155 ms (chip_smoke.py:ssd_bwd_split_macs); measured, instruction
// issue: the operands' splits, fragment loads and addresses outnumber the
// HMMAs about 10 to 1 in the compiled chunk kernel (kernels/ab_ssd.py),
// whose block holds the chunk's C, B, x and dy in fp32 (225 KB of shared
// memory, one block of 8 warps an SM).  What the design does about it:
// every tile load in flight at once (cp.async), compile-time shared-memory
// strides and tile counts (a specialisation at N 128 with 64-column slabs:
// P 64 and 128), C B^T a group, and 3-operation splits.
//
// * mma_tf32x3 (entry ssd_fwd_mma_tf32; float32, the training path's
//   forward, every shape the fma body takes): chunk-parallel on the TF32
//   tensor cores with the backward mma body's products (mma_tf32x3,
//   truncating splits: ref.py:split_einsum with truncate_tf32 models it),
//   four launches through an fp32 workspace (ssd_fwd_mma_tf32_workspace_floats):
//   1. ssd_state_mma_kernel without E: cum (in double, rounded once) and
//      each chunk's local end state, as the backward's launch 1; the block
//      holds only B and x, two blocks an SM at P 64.
//   2. ssd_cb_kernel: C B^T once a (b, chunk, group), as the backward's
//      launch 1b without the transpose (mamba2-130m's 24 heads share it).
//   3. ssd_state_pass_kernel (the bf16 body's).
//   4. ssd_chunk_scan_tf32_kernel: a block a (chunk, head, batch), a warp
//      a 16-row strip: exp(cum_i) C_i state_in^T (the state split into hi
//      and lo once, into shared memory) + the strip's tiles of scores
//      (C B^T o L o dt_j, masked before the exp) times x + D x, rounded
//      once at the store; every group of output tiles summed in a fresh
//      accumulator (mma_xb), as the tensor cores truncate their sums.
//   What bounds it at mamba2-130m's train shape (x (8,1024,24,64) fp32,
//   chunk 128): its products, 3 x ssd_macs = 11.7 G multiply-adds at the
//   TF32 rate, 0.0473 ms (chip_smoke.py:ssd_fp32_kernels); the bytes (x,
//   dt, B and C read, y and the state written) 0.017 ms.  Like the
//   backward's mma body it is expected to be bound by instruction issue
//   (splits, fragment loads, addresses) before the tensor cores; what the
//   design does: the state split once a block rather than once a warp,
//   C B^T once a group, C's fragments read once by the one warp that needs
//   them (from device memory, which leaves 103 KB of shared memory a block
//   and so two blocks an SM), and heavy and light strips paired on each SM
//   sub-partition.
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

// Raises Kernel's shared-memory limit to `bytes` (its largest block's), once
// for each device (the attribute belongs to the device's context).
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<uint64_t> done{0};  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* D, void* y, void* state, int B, int S, int H, int P, int G, int N,
           int Q, cudaStream_t stream) {
  const cudaError_t err = allow_smem<ssd_kernel<T>>(kMaxSmemBytes);
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


// ---------------------------------------------------------------------------
// mma: the chunk-parallel body on the tensor cores (bfloat16)
// ---------------------------------------------------------------------------

constexpr int kStateThreads = 256;  // 8 warps: chunk-state blocks
constexpr int kScanThreads = 256;   // 8 warps: chunk-scan blocks, a 16-row tile a warp
constexpr int kPassThreads = 128;   // state-pass blocks
constexpr int kPassAhead = 8;       // chunks whose states a state-pass thread loads at once
constexpr int kStateBatch = 8;      // 4-float loads of the state a scan thread has in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeep = 5;  // tiles of scores a scan warp's heavy row keeps (of up to 8)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without a trip through registers; zero-filled
// where `valid` is false (nothing is read then).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ldmatrix: four 8 x 8 b16 matrices from shared memory (a 32-bit shared
// address); lane l gives the address of row l % 8 of matrix l / 8.  Of
// matrix i, lane l receives in r[i] row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 (ldsm4), or the transpose:
// rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4 (ldsm4_t).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Lane l's row address for the m16n8k16 fragments of a tile t with row
// stride ld (in b16 elements; rows 16-byte aligned), as a shared address:
//  * a_rows: A (16 x 16 at m0, k0) of a row-major [m][k] tile   (ldsm4)
//  * a_cols: A of a k-major [k][m] tile                         (ldsm4_t)
//  * b_rows: B of two n-tiles (16 x 16 at n0, k0) of an [n][k] tile (ldsm4):
//    r[0], r[1] for n0 .. n0 + 7, r[2], r[3] for n0 + 8 .. n0 + 15
//  * b_cols: the same of a [k][n] tile                          (ldsm4_t)
__device__ __forceinline__ uint32_t a_rows(const uint16_t* t, int ld, int m0, int k0, int l) {
  return smem_u32(t + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}
__device__ __forceinline__ uint32_t a_cols(const uint16_t* t, int ld, int m0, int k0, int l) {
  return smem_u32(t + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t b_rows(const uint16_t* t, int ld, int n0, int k0, int l) {
  return smem_u32(t + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t b_cols(const uint16_t* t, int ld, int n0, int k0, int l) {
  return smem_u32(t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

__device__ __forceinline__ float bf(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as two bf16 pairs: hi = bf16(v) and lo = bf16(v - hi), so that
// hi + lo keeps about 16 bits of v's mantissa.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  return {bits(h), bits(__floats2bfloat162_rn(a - hf.x, b - hf.y))};
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// chunk state: cum and w (kMaxQ each), then the tiles of x (Q16 x (P16 + 8))
// and B (Q16 x (N16 + 8)), bf16
__host__ __device__ constexpr int state_smem_bytes(int Q, int P, int N) {
  return 2 * kMaxQ * 4 + round16(Q) * (round16(P) + 8) * 2 + round16(Q) * (round16(N) + 8) * 2;
}

// chunk scan: cum and dt (kMaxQ each), C's tile (Q16 x (N16 + 8)), x's (Q16 x
// (P16 + 8)) and one buffer for the state's hi and lo (P16 x (N16 + 8) each),
// then B's tile (Q16 x (N16 + 8)), bf16; the helpers' sums (8 - kKeep row
// tiles of 16 x 8 PT fp32)
__host__ __device__ constexpr int scan_smem_bytes(int Q, int P, int N) {
  return 2 * kMaxQ * 4 + round16(Q) * (round16(N) + 8) * 2 +
         round16(Q) * (round16(P) + 8) * 2 +
         (round16(Q) > 2 * round16(P) ? round16(Q) : 2 * round16(P)) * (round16(N) + 8) * 2 +
         (8 - kKeep) * 16 * (round16(P) <= 64 ? 64 : 128) * 4;
}

// Phase 1.  Block (c, h, b): cum over the chunk; w_j = exp(total - cum_j) dt_j;
// states[b, c, h] = sum_j (w_j x_j) B_j^T, (P x N) over the Q16 tokens, with
// w_j x_j split into hi and lo as each warp reads its A fragments.  A warp
// owns 16 rows of P and half of N.  Registers are held to 85 a thread so
// that three blocks share an SM: the serving shape's 384 blocks then run in
// one round.
__global__ void __launch_bounds__(kStateThreads, 3)
    ssd_chunk_state_kernel(const uint16_t* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const uint16_t* __restrict__ Bm,
                           float* __restrict__ states, float* __restrict__ cum_out, int S,
                           int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q16 = round16(Q), P16 = round16(P), N16 = round16(N);
  const int s0 = c * Q, rows = min(Q, S - s0);
  const int LX = P16 + 8, LB = N16 + 8;
  float* cumv = reinterpret_cast<float*>(smem4);            // kMaxQ
  float* wv = cumv + kMaxQ;                                  // kMaxQ
  uint16_t* xs = reinterpret_cast<uint16_t*>(wv + kMaxQ);    // Q16 x LX: x (j, p)
  uint16_t* bs = xs + Q16 * LX;                              // Q16 x LB: B (j, n)

  const long long x_row = static_cast<long long>(H) * P, b_row = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + s0;
  const uint16_t* xb = x + row0 * x_row + static_cast<long long>(h) * P;
  const uint16_t* bb = Bm + row0 * b_row + static_cast<long long>(g) * N;
  // every tile load in flight at once; padding rows and columns zero-filled
  for (int e = tid, xv = P16 / 8; e < Q16 * xv; e += kStateThreads) {
    const int j = e / xv, v = e - j * xv;
    const bool in = j < rows && v * 8 < P;
    cp_async16(xs + j * LX + v * 8, in ? xb + j * x_row + v * 8 : xb, in);
  }
  for (int e = tid, bv = N16 / 8; e < Q16 * bv; e += kStateThreads) {
    const int j = e / bv, v = e - j * bv;
    const bool in = j < rows && v * 8 < N;
    cp_async16(bs + j * LB + v * 8, in ? bb + j * b_row + v * 8 : bb, in);
  }
  const float d = tid < rows ? dt[(static_cast<long long>(b) * S + s0 + tid) * H + h] : 0.f;
  if (tid < kMaxQ) cumv[tid] = d * A[h];
  __syncthreads();
  // inclusive cumsum of dt * A over the chunk (Hillis-Steele); padding adds 0
  for (int off = 1; off < Q16; off <<= 1) {
    const float v = tid >= off && tid < Q16 ? cumv[tid - off] : 0.f;
    __syncthreads();
    if (tid < Q16) cumv[tid] += v;
    __syncthreads();
  }
  const float total = cumv[Q16 - 1];
  if (tid < kMaxQ) wv[tid] = tid < Q16 ? expf(total - cumv[tid]) * d : 0.f;
  if (tid < Q) cum_out[(static_cast<long long>(b) * H + h) * nc * Q + s0 + tid] = cumv[tid];
  cp_async_wait_all();
  __syncthreads();

  const int gq = lane >> 2, tq = lane & 3;
  float* out = states + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
  // work item: 16 rows of P (mt) by half of N's 16-column pairs (nh)
  const int pairs = N16 / 16, half = (pairs + 1) / 2;
  for (int item = warp; item < P16 / 16 * 2; item += kStateThreads / 32) {
    const int mt = item >> 1, np0 = (item & 1) * half, np1 = min(pairs, np0 + half);
    float acc[kMaxN / 16][4];
#pragma unroll
    for (int nt = 0; nt < kMaxN / 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const uint32_t a_b = a_cols(xs, LX, mt * 16, 0, lane);
    const uint32_t b_b = b_cols(bs, LB, np0 * 16, 0, lane);
    for (int k0 = 0; k0 < Q16; k0 += 16) {
      // A (m = p, k = j) = w_j x[j][p] from x's k-major tile: registers 0, 1
      // hold k = k0 + 2 tq, + 1 and registers 2, 3 those + 8, split into hi
      // and lo; B (k = j, n)
      uint32_t ax[4], ahi[4], alo[4];
      ldsm4_t(ax, a_b + k0 * LX * 2);
      const float2 w01 = *reinterpret_cast<const float2*>(wv + k0 + 2 * tq);
      const float2 w89 = *reinterpret_cast<const float2*>(wv + k0 + 8 + 2 * tq);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 w = r < 2 ? w01 : w89;
        const Split v = split(w.x * bf(static_cast<uint16_t>(ax[r] & 0xffffu)),
                              w.y * bf(static_cast<uint16_t>(ax[r] >> 16)));
        ahi[r] = v.hi;
        alo[r] = v.lo;
      }
#pragma unroll
      for (int u = 0; u < kMaxN / 32; ++u) {
        if (np0 + u < np1) {
          uint32_t bf4[4];
          ldsm4_t(bf4, b_b + k0 * LB * 2 + u * 32);
          mma_bf16(acc[2 * u], ahi, bf4[0], bf4[1]);
          mma_bf16(acc[2 * u], alo, bf4[0], bf4[1]);
          mma_bf16(acc[2 * u + 1], ahi, bf4[2], bf4[3]);
          mma_bf16(acc[2 * u + 1], alo, bf4[2], bf4[3]);
        }
      }
    }
    const int p0 = mt * 16 + gq;
#pragma unroll
    for (int t = 0; t < kMaxN / 16; ++t) {
      const int n = np0 * 16 + t * 8 + 2 * tq;
      if (np0 * 16 + t * 8 < min(N, np1 * 16)) {
        if (p0 < P)
          *reinterpret_cast<float2*>(out + static_cast<long long>(p0) * N + n) =
              make_float2(acc[t][0], acc[t][1]);
        if (p0 + 8 < P)
          *reinterpret_cast<float2*>(out + static_cast<long long>(p0 + 8) * N + n) =
              make_float2(acc[t][2], acc[t][3]);
      }
    }
  }
}

// Phase 2.  Thread: a 4-vector e of the (P x N) state of (b, h) (grid (.., H, B)).
// states[b, c, h] <- the state entering chunk c, for c >= 1; state_out[b, h]
// <- the state after the last chunk.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                          float* __restrict__ state_out, int H, int PN, int Q, int nc) {
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const float* cb = cum + (static_cast<long long>(b) * H + h) * nc * Q + Q - 1;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    // the loads of kPassAhead chunks are issued before any of their stores
    float4 v[kPassAhead];
    float decay[kPassAhead];
#pragma unroll
    for (int i = 0; i < kPassAhead; ++i) {
      if (c0 + i < nc) {
        v[i] = *reinterpret_cast<const float4*>(
            states + ((static_cast<long long>(b) * nc + c0 + i) * H + h) * PN + e);
        decay[i] = expf(cb[static_cast<long long>(c0 + i) * Q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassAhead; ++i) {
      if (c0 + i < nc) {
        // the state entering chunk 0 is zero and never read: not written
        if (c0 + i > 0)
          *reinterpret_cast<float4*>(
              states + ((static_cast<long long>(b) * nc + c0 + i) * H + h) * PN + e) = s;
        s = make_float4(fmaf(decay[i], s.x, v[i].x), fmaf(decay[i], s.y, v[i].y),
                        fmaf(decay[i], s.z, v[i].z), fmaf(decay[i], s.w, v[i].w));
      }
    }
  }
  *reinterpret_cast<float4*>(state_out + (static_cast<long long>(b) * H + h) * PN + e) = s;
}

// Phase 3.  Block (c, h, b).  A warp owns 16 query rows of the chunk (row
// tile mt; warps w and w + 4 share an SM sub-partition and take tiles mt and
// 7 - mt, so that each sub-partition gets the same work, and the light one
// takes part of the heavy one's scores, see kKeep).  It computes
// the inter-chunk term exp(cum_i) (C state_in^T) with the state's hi and lo
// in shared memory, then, with B's tile in the same buffer, walks the
// 16-column tiles up to its diagonal: C B^T for the tile, the scores
// C B^T exp(cum_i - cum_j) dt_j split into hi and lo in registers, and their
// product with x; then y = that + D x, rounded once.  Nothing holds C B^T
// beyond one tile and C's fragments are read again from shared memory where
// they are needed, so two blocks share an SM without spilling.
// PT: the 8-column tiles of P the accumulators hold (P16 <= 8 * PT).
template <int PT>
__global__ void __launch_bounds__(kScanThreads, PT <= 8 ? 2 : 1)
    ssd_chunk_scan_kernel(const uint16_t* __restrict__ x, const float* __restrict__ dt,
                          const uint16_t* __restrict__ Bm, const uint16_t* __restrict__ Cm,
                          const float* __restrict__ Dskip, const float* __restrict__ cum,
                          const float* __restrict__ states, uint16_t* __restrict__ y, int S,
                          int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int h = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q16 = round16(Q), N16 = round16(N), P16 = round16(P);
  const int s0 = c * Q, rows = min(Q, S - s0);
  const int LC = N16 + 8, LX = P16 + 8;
  float* cumv = reinterpret_cast<float*>(smem4);            // kMaxQ
  float* dtv = cumv + kMaxQ;                                 // kMaxQ
  uint16_t* cs = reinterpret_cast<uint16_t*>(dtv + kMaxQ);  // Q16 x LC: C (i, n)
  uint16_t* xs = cs + Q16 * LC;                              // Q16 x LX: x (j, p)
  uint16_t* sh = xs + Q16 * LX;                              // P16 x LC: hi(state_in) (p, n),
  uint16_t* sl = sh + P16 * LC;                              // P16 x LC: lo(state_in), then
  uint16_t* bs = sh;                                         // Q16 x LC: B (j, n)
  float4* part = reinterpret_cast<float4*>(                  // the helpers' sums
      sh + (Q16 > 2 * P16 ? Q16 : 2 * P16) * LC);

  const long long x_row = static_cast<long long>(H) * P, b_row = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + s0;
  const long long bc0 = row0 * b_row + static_cast<long long>(g) * N;
  const bool inter = c > 0;  // the state entering the first chunk is zero
  // B's tile (or C's) into t, padding rows and columns zero-filled
  auto load_bc = [&](uint16_t* t, const uint16_t* m) {
    for (int e = tid, nv = N16 / 8; e < Q16 * nv; e += kScanThreads) {
      const int j = e / nv, v = e - j * nv;
      const bool in = j < rows && v * 8 < N;
      cp_async16(t + j * LC + v * 8, m + (in ? bc0 + j * b_row + v * 8 : bc0), in);
    }
  };
  load_bc(cs, Cm);

  const int gq = lane >> 2, tq = lane & 3;
  const int mt = warp < 4 ? warp : 11 - warp, i0 = mt * 16 + gq, i1 = i0 + 8;
  const bool active = mt * 16 < Q16;
  const uint16_t* xb = x + row0 * x_row + static_cast<long long>(h) * P;
  for (int e = tid, xv = P16 / 8; e < Q16 * xv; e += kScanThreads) {
    const int j = e / xv, v = e - j * xv;
    const bool in = j < rows && v * 8 < P;
    cp_async16(xs + j * LX + v * 8, in ? xb + j * x_row + v * 8 : xb, in);
  }
  if (inter) {
    // state_in split into hi and lo, kStateBatch loads of 4 floats a thread
    // in flight at once; padding rows and columns zero
    const float* sb = states + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
    const int nv = N16 / 4, total = P16 * nv;
    for (int e0 = tid; e0 < total; e0 += kStateBatch * kScanThreads) {
      float4 v[kStateBatch];
#pragma unroll
      for (int u = 0; u < kStateBatch; ++u) {
        const int e = e0 + u * kScanThreads, p = e / nv, q = e - p * nv;
        v[u] = e < total && p < P && q * 4 < N
                   ? *reinterpret_cast<const float4*>(sb + static_cast<long long>(p) * N + q * 4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kStateBatch; ++u) {
        const int e = e0 + u * kScanThreads, p = e / nv, q = e - p * nv;
        if (e < total) {
          const Split s01 = split(v[u].x, v[u].y), s23 = split(v[u].z, v[u].w);
          *reinterpret_cast<uint2*>(sh + p * LC + q * 4) = make_uint2(s01.hi, s23.hi);
          *reinterpret_cast<uint2*>(sl + p * LC + q * 4) = make_uint2(s01.lo, s23.lo);
        }
      }
    }
  } else {
    load_bc(bs, Bm);
  }
  if (tid < Q16) {
    // cum in log2 units; the tile's rows past Q take the chunk's last cum,
    // so that no exponent's argument on or below the diagonal is positive
    const long long t = (static_cast<long long>(b) * H + h) * nc * Q + s0 + min(tid, Q - 1);
    cumv[tid] = cum[t] * kLog2e;
    dtv[tid] = tid < rows ? dt[(static_cast<long long>(b) * S + s0 + tid) * H + h] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
  const float ci0 = active ? cumv[i0] : 0.f, ci1 = active ? cumv[i1] : 0.f;
  const uint32_t ca_b = a_rows(cs, LC, active ? mt * 16 : 0, 0, lane);
  if (inter) {
    if (active) {
      // C (i, n) @ state_in^T (n, p), the state in hi and lo
#pragma unroll
      const uint32_t sh_b = b_rows(sh, LC, 0, 0, lane), lo = P16 * LC * 2;
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        if (ks * 16 < N16) {
          uint32_t ca[4];
          ldsm4(ca, ca_b + ks * 32);
#pragma unroll
          for (int pp = 0; pp < PT / 2; ++pp) {
            if (pp * 16 < P16) {
              uint32_t bh[4], bl[4];
              const uint32_t o = sh_b + pp * 16 * LC * 2 + ks * 32;
              ldsm4(bh, o);
              ldsm4(bl, o + lo);
              mma_bf16(acc[2 * pp], ca, bh[0], bh[1]);
              mma_bf16(acc[2 * pp], ca, bl[0], bl[1]);
              mma_bf16(acc[2 * pp + 1], ca, bh[2], bh[3]);
              mma_bf16(acc[2 * pp + 1], ca, bl[2], bl[3]);
            }
          }
        }
      }
      const float e0 = exp2f(ci0), e1 = exp2f(ci1);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        acc[pt][0] *= e0;
        acc[pt][1] *= e0;
        acc[pt][2] *= e1;
        acc[pt][3] *= e1;
      }
    }
    __syncthreads();  // every warp has read the state; B's tile takes its buffer
    load_bc(bs, Bm);
    cp_async_wait_all();
    __syncthreads();
  }
  // intra-chunk for row tile `row`, over tiles kk0 .. kk1 - 1 of its
  // scores (16 columns each, up to the diagonal): the scores times x
  // (j, p) into out, interleaved with C B^T for the next tile (summed over
  // even and odd k-steps apart, so that no chain of dependent products is
  // longer than N16 / 32)
  const uint32_t bs_b = b_rows(bs, LC, 0, 0, lane), xs_b = b_cols(xs, LX, 0, 0, lane);
  auto intra = [&](int row, int kk0, int kk1, float(&out)[PT][4]) {
    const int r0 = row * 16 + gq, r1 = r0 + 8;
    const float c0 = cumv[r0], c1 = cumv[r1];
    const uint32_t a_b = a_rows(cs, LC, row * 16, 0, lane);
    float cn[2][2][4];
    auto cb_step = [&](int kk, int ks) {
      uint32_t ca[4], bf4[4];
      ldsm4(ca, a_b + ks * 32);
      ldsm4(bf4, bs_b + kk * 16 * LC * 2 + ks * 32);
      mma_bf16(cn[ks & 1][0], ca, bf4[0], bf4[1]);
      mma_bf16(cn[ks & 1][1], ca, bf4[2], bf4[3]);
    };
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) cn[u][v][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks)
      if (ks * 16 < N16) cb_step(kk0, ks);
    for (int kk = kk0; kk < kk1; ++kk) {
      // scores: C B^T exp2(cum_i - cum_j) dt_j; on the diagonal tile the
      // argument is masked (j > i) before the exp2
      float sc[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = kk * 16 + half * 8 + 2 * tq;
        const float2 cj = *reinterpret_cast<const float2*>(cumv + j);
        const float2 dj = *reinterpret_cast<const float2*>(dtv + j);
        float arg[4] = {c0 - cj.x, c0 - cj.y, c1 - cj.x, c1 - cj.y};
        if (kk == row) {
          arg[0] = r0 >= j ? arg[0] : -1e30f;
          arg[1] = r0 >= j + 1 ? arg[1] : -1e30f;
          arg[2] = r1 >= j ? arg[2] : -1e30f;
          arg[3] = r1 >= j + 1 ? arg[3] : -1e30f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[half][e] =
              (cn[0][half][e] + cn[1][half][e]) * exp2f(arg[e]) * (e & 1 ? dj.y : dj.x);
          cn[0][half][e] = 0.f;
          cn[1][half][e] = 0.f;
        }
      }
      const Split a0 = split(sc[0][0], sc[0][1]), a1 = split(sc[0][2], sc[0][3]);
      const Split a2 = split(sc[1][0], sc[1][1]), a3 = split(sc[1][2], sc[1][3]);
      const uint32_t ahi[4] = {a0.hi, a1.hi, a2.hi, a3.hi};
      const uint32_t alo[4] = {a0.lo, a1.lo, a2.lo, a3.lo};
      const bool next = kk + 1 < kk1;
      const uint32_t xk = xs_b + kk * 16 * LX * 2;
#pragma unroll
      for (int u = 0; u < (PT / 2 > kMaxN / 16 ? PT / 2 : kMaxN / 16); ++u) {
        if (next && u < kMaxN / 16 && u * 16 < N16) cb_step(kk + 1, u);
        if (u < PT / 2 && u * 16 < P16) {
          uint32_t bf4[4];
          ldsm4_t(bf4, xk + u * 32);
          mma_bf16(out[2 * u], ahi, bf4[0], bf4[1]);
          mma_bf16(out[2 * u + 1], ahi, bf4[2], bf4[3]);
          mma_bf16(out[2 * u], alo, bf4[0], bf4[1]);
          mma_bf16(out[2 * u + 1], alo, bf4[2], bf4[3]);
        }
      }
    }
  };
  // y = out + D x for row tile mt, in fp32, one rounding at the store
  const float d_h = Dskip[h];
  uint16_t* yb = y + row0 * x_row + static_cast<long long>(h) * P;
  auto store = [&](const float(&out)[PT][4]) {
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int p = pt * 8 + 2 * tq;
      if (pt * 8 < P) {
        if (i0 < rows)
          *reinterpret_cast<__nv_bfloat162*>(yb + i0 * x_row + p) = __floats2bfloat162_rn(
              fmaf(d_h, bf(xs[i0 * LX + p]), out[pt][0]),
              fmaf(d_h, bf(xs[i0 * LX + p + 1]), out[pt][1]));
        if (i1 < rows)
          *reinterpret_cast<__nv_bfloat162*>(yb + i1 * x_row + p) = __floats2bfloat162_rn(
              fmaf(d_h, bf(xs[i1 * LX + p]), out[pt][2]),
              fmaf(d_h, bf(xs[i1 * LX + p + 1]), out[pt][3]));
      }
    }
  };
  // Row tiles kKeep and up keep their first kKeep tiles of scores; the warp
  // that shares their SM sub-partition (row tile 7 - mt, light) computes
  // the rest after its own row and hands the sum over in shared memory, so
  // that no warp carries more than about kKeep + 4 tiles' work.
  const bool helped = mt >= kKeep;
  if (active) {
    intra(mt, 0, helped ? kKeep : mt + 1, acc);
    if (!helped) store(acc);
  }
  if (Q16 > kKeep * 16) {
    const int hr = 7 - mt;
    if (mt < 8 - kKeep && hr * 16 < Q16) {
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
      intra(hr, kKeep, hr + 1, acc);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
        part[(mt * PT + pt) * 32 + lane] = make_float4(acc[pt][0], acc[pt][1], acc[pt][2],
                                                       acc[pt][3]);
    }
    __syncthreads();
    if (active && helped) {
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const float4 v = part[((7 - mt) * PT + pt) * 32 + lane];
        acc[pt][0] += v.x;
        acc[pt][1] += v.y;
        acc[pt][2] += v.z;
        acc[pt][3] += v.w;
      }
      store(acc);
    }
  }
}

bool shape_ok(int B, int S, int H, int P, int G, int N, int chunk) {
  return chunk >= 16 && chunk <= kMaxQ && N > 0 && N % 8 == 0 && N <= kMaxN && P > 0 &&
         P % 8 == 0 && P <= kMaxP && G > 0 && H > 0 && H % G == 0 && B > 0 && B <= 65535 &&
         H <= 65535 && S >= 0;
}

template <int PT>
int launch_chunk_scan(const void* x, const void* dt, const void* Bm, const void* Cm,
                      const void* D, const void* cum, const void* states, void* y, int B, int S,
                      int H, int P, int G, int N, int Q, cudaStream_t stream) {
  const cudaError_t err =
      allow_smem<ssd_chunk_scan_kernel<PT>>(scan_smem_bytes(kMaxQ, kMaxP, kMaxN));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + Q - 1) / Q, H, B);
  ssd_chunk_scan_kernel<PT><<<grid, kScanThreads, scan_smem_bytes(Q, P, N), stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const float*>(dt),
      static_cast<const uint16_t*>(Bm), static_cast<const uint16_t*>(Cm),
      static_cast<const float*>(D), static_cast<const float*>(cum),
      static_cast<const float*>(states), static_cast<uint16_t*>(y), S, H, P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward: float32 and bfloat16 inputs, fp32 products on the FMA units
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdVecs = 8;                // vectors of kMaxQ floats a chunk block keeps
constexpr int kBwdMaxSmemBytes = 232448;   // the most a block may have (227 KB)
constexpr int kBwdLanes = 256;             // lanes of the dA / dD sum over the chunks

// a chunk block's shared memory: C, B (Qp x (N + 4)), x, dy (Qp x (P + 4)) in
// fp32, kBwdVecs vectors and a kBwdThreads-float reduction buffer
__host__ __device__ constexpr int bwd_smem_floats(int Qp, int P, int N) {
  return 2 * Qp * (N + 4) + 2 * Qp * (P + 4) + kBwdVecs * kMaxQ + kBwdThreads;
}

// a chunk block's scratch in device memory: the scores M, d(C B^T) and
// R = dM o M (Qp x Qp each, rows i, columns j), the per-tile parts of ddt's
// column sums ((Qp / 4) x Qp), and the parts of dw and of the inter-chunk
// term's d cum over the (N / 4) column tiles of N
__host__ __device__ constexpr long long bwd_scratch_floats(int Qp, int N) {
  return 3LL * Qp * Qp + 1LL * (Qp / 4) * Qp + 2LL * (N / 4) * Qp;
}

__host__ __device__ constexpr long long round4(long long v) { return (v + 3) & ~3LL; }

// offsets (floats) of the workspace's parts; dBh, dCh and the dA / dD parts
// once a slab of P (the mma body's; the fma body has one)
struct BwdWorkspace {
  long long cum, states, dstates, final_state, dBh, dCh, parts, scratch, total;
};
__host__ __device__ inline BwdWorkspace bwd_workspace(int B, int S, int H, int P, int N, int Q,
                                                      int slabs = 1) {
  const int nc = (S + Q - 1) / Q, Qp = (Q + 3) & ~3;
  BwdWorkspace w;
  w.cum = 0;
  w.states = round4(w.cum + static_cast<long long>(B) * H * nc * Q);
  w.dstates = w.states + static_cast<long long>(B) * nc * H * P * N;
  w.final_state = w.dstates + static_cast<long long>(B) * nc * H * P * N;
  w.dBh = w.final_state + static_cast<long long>(B) * H * P * N;
  w.dCh = w.dBh + static_cast<long long>(slabs) * B * S * H * N;
  w.parts = w.dCh + static_cast<long long>(slabs) * B * S * H * N;
  w.scratch = round4(w.parts + 2LL * B * nc * H * slabs);
  w.total = w.scratch + static_cast<long long>(B) * nc * H * bwd_scratch_floats(Qp, N);
  return w;
}

// v[0..n) summed as a pairwise tree (k with k + half), n a power of two up to
// kBwdThreads; every thread of the block calls it, after v is written
__device__ float block_tree(float* v, int n) {
  for (int half = n / 2; half > 0; half >>= 1) {
    if (static_cast<int>(threadIdx.x) < half) v[threadIdx.x] += v[threadIdx.x + half];
    __syncthreads();
  }
  const float out = v[0];
  __syncthreads();  // v may be written again
  return out;
}

// The chunk's C, B (rows t, columns n), x and dy (rows t, columns p) into
// shared memory as fp32 and dt into dtv, padding rows (t >= rows) zero.
template <typename T>
__device__ void bwd_load_chunk(float* cs, float* bs, float* xs, float* ys, float* dtv,
                               const T* x, const T* dy, const T* Bm, const T* Cm,
                               const float* dt, int b, int h, int g, int s0, int rows, int S,
                               int H, int P, int G, int N, int Qp) {
  const int tid = threadIdx.x, LDN = N + 4, LDP = P + 4;
  const long long x_row = static_cast<long long>(H) * P, bc_row = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + s0;
  const T* xb = x + row0 * x_row + static_cast<long long>(h) * P;
  const T* yb = dy + row0 * x_row + static_cast<long long>(h) * P;
  const T* Bb = Bm + row0 * bc_row + static_cast<long long>(g) * N;
  const T* Cb = Cm + row0 * bc_row + static_cast<long long>(g) * N;
  for (int e = tid; e < Qp * N; e += kBwdThreads) {
    const int t = e / N, n = e - t * N;
    const bool in = t < rows;
    bs[t * LDN + n] = in ? to_f32(Bb[t * bc_row + n]) : 0.f;
    cs[t * LDN + n] = in ? to_f32(Cb[t * bc_row + n]) : 0.f;
  }
  for (int e = tid; e < Qp * P; e += kBwdThreads) {
    const int t = e / P, p = e - t * P;
    const bool in = t < rows;
    xs[t * LDP + p] = in ? to_f32(xb[t * x_row + p]) : 0.f;
    ys[t * LDP + p] = in ? to_f32(yb[t * x_row + p]) : 0.f;
  }
  if (tid < kMaxQ) dtv[tid] = tid < rows ? dt[(row0 + tid) * H + h] : 0.f;
}

// Launch 1.  Block (c, h, b): cum (written for the chunk's Q tokens), the
// chunk's local end state into states and E into dstates, (P x N) each.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const T* __restrict__ dy,
                         float* __restrict__ cum_out, float* __restrict__ states,
                         float* __restrict__ dstates, int S, int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, g = h / (H / G);
  const int Qp = (Q + 3) & ~3, LDN = N + 4, LDP = P + 4;
  const int s0 = c * Q, rows = min(Q, S - s0);
  float* cs = reinterpret_cast<float*>(smem4);
  float* bs = cs + Qp * LDN;
  float* xs = bs + Qp * LDN;
  float* ys = xs + Qp * LDP;
  float* dtv = ys + Qp * LDP;
  float* cum = dtv + kMaxQ;
  float* wv = cum + kMaxQ;  // exp(total - cum_j) dt_j
  float* ev = wv + kMaxQ;   // exp(cum_i)
  double* cd = reinterpret_cast<double*>(ev + kMaxQ);  // kMaxQ doubles
  bwd_load_chunk<T>(cs, bs, xs, ys, dtv, x, dy, Bm, Cm, dt, b, h, g, s0, rows, S, H, P, G, N,
                    Qp);
  __syncthreads();
  if (tid < kMaxQ) cd[tid] = static_cast<double>(dtv[tid] * A[h]);
  __syncthreads();
  // inclusive cumsum of dt * A over the chunk (Hillis-Steele in double,
  // rounded once); padding adds 0
  for (int off = 1; off < Qp; off <<= 1) {
    const double v = tid >= off && tid < Qp ? cd[tid - off] : 0.0;
    __syncthreads();
    if (tid < Qp) cd[tid] += v;
    __syncthreads();
  }
  if (tid < kMaxQ) cum[tid] = static_cast<float>(cd[tid]);
  __syncthreads();
  const float total = cum[Qp - 1];
  if (tid < Qp) {
    wv[tid] = expf(total - cum[tid]) * dtv[tid];
    ev[tid] = expf(cum[tid]);
  }
  if (tid < Q) cum_out[(static_cast<long long>(b) * H + h) * nc * Q + s0 + tid] = cum[tid];
  __syncthreads();

  const long long off = ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
  const int np4 = P / 4, nn4 = N / 4;
  for (int item = tid; item < np4 * nn4; item += kBwdThreads) {
    const int p0 = (item / nn4) * 4, n0 = (item - (item / nn4) * nn4) * 4;
    float st[4][4], e[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = e[i][j] = 0.f;
    for (int t = 0; t < Qp; ++t) {
      const float4 xv = ld4(xs + t * LDP + p0), bv = ld4(bs + t * LDN + n0);
      const float4 yv = ld4(ys + t * LDP + p0), cv = ld4(cs + t * LDN + n0);
      const float w = wv[t], ec = ev[t];
      const float xa[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
      const float ya[4] = {yv.x * ec, yv.y * ec, yv.z * ec, yv.w * ec};
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w}, ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(xa[i], ba[j], st[i][j]);
          e[i][j] = fmaf(ya[i], ca[j], e[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long o = off + static_cast<long long>(p0 + i) * N + n0;
      *reinterpret_cast<float4*>(states + o) = make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
      *reinterpret_cast<float4*>(dstates + o) = make_float4(e[i][0], e[i][1], e[i][2], e[i][3]);
    }
  }
}

// Launch 3.  Thread: a 4-vector e of the (P x N) state of (b, h), as in
// ssd_state_pass_kernel.  dstates[b, c, h] holds E_c and is overwritten with
// the gradient of chunk c's local state, G_c+1.
__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_state_pass_kernel(float* __restrict__ dstates, const float* __restrict__ cum,
                              const float* __restrict__ d_state, int H, int PN, int Q, int nc) {
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const float* cb = cum + (static_cast<long long>(b) * H + h) * nc * Q + Q - 1;
  float4 g = d_state != nullptr ? *reinterpret_cast<const float4*>(
                                      d_state + (static_cast<long long>(b) * H + h) * PN + e)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    float4* p = reinterpret_cast<float4*>(
        dstates + ((static_cast<long long>(b) * nc + c) * H + h) * PN + e);
    const float4 ev = *p;
    const float decay = expf(cb[static_cast<long long>(c) * Q]);
    *p = g;
    g = make_float4(fmaf(decay, g.x, ev.x), fmaf(decay, g.y, ev.y), fmaf(decay, g.z, ev.z),
                    fmaf(decay, g.w, ev.w));
  }
}

// Launch 4.  Block (c, h, b): every gradient inside the chunk (see the head
// of the file).  states[b, c, h] is the state entering the chunk (for c > 0;
// the first chunk's is zero), dstates[b, c, h] the gradient of its local
// state.  Writes dx (T), ddt (fp32) and dB, dC per head (fp32) for the
// chunk's tokens, and the chunk's parts of dA and dD.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const float* __restrict__ Dskip,
                         const T* __restrict__ dy, const float* __restrict__ cum_in,
                         const float* __restrict__ states, const float* __restrict__ dstates,
                         float* scratch, T* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ dBh, float* __restrict__ dCh,
                         float* __restrict__ parts, int S, int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, g = h / (H / G);
  const int Qp = (Q + 3) & ~3, LDN = N + 4, LDP = P + 4;
  const int nq4 = Qp / 4, np4 = P / 4, nn4 = N / 4;
  const int s0 = c * Q, rows = min(Q, S - s0);
  float* cs = reinterpret_cast<float*>(smem4);
  float* bs = cs + Qp * LDN;
  float* xs = bs + Qp * LDN;
  float* ys = xs + Qp * LDP;
  float* dtv = ys + Qp * LDP;
  float* cum = dtv + kMaxQ;
  float* ecum = cum + kMaxQ;  // exp(cum_i)
  float* tend = ecum + kMaxQ; // exp(total - cum_j)
  float* wv = tend + kMaxQ;   // exp(total - cum_j) dt_j
  float* suf = wv + kMaxQ;    // the suffix sums of exp(cum_i) dy_i . Z_i
  float* pre = suf + kMaxQ;   // the prefix sums of w_i dw_i
  float* red = pre + kMaxQ;   // kMaxQ floats, then the kBwdThreads-float buffer
  float* red2 = red + kMaxQ;

  bwd_load_chunk<T>(cs, bs, xs, ys, dtv, x, dy, Bm, Cm, dt, b, h, g, s0, rows, S, H, P, G, N,
                    Qp);
  const float* cb_in = cum_in + (static_cast<long long>(b) * H + h) * nc * Q + s0;
  if (tid < Qp) cum[tid] = cb_in[min(tid, Q - 1)];  // rows past Q: the chunk's total
  __syncthreads();
  const float total = cum[Qp - 1];
  if (tid < Qp) {
    ecum[tid] = expf(cum[tid]);
    tend[tid] = expf(total - cum[tid]);
    wv[tid] = tend[tid] * dtv[tid];
  }
  __syncthreads();

  const long long blk = (static_cast<long long>(b) * nc + c) * H + h;
  float* Mg = scratch + blk * bwd_scratch_floats(Qp, N);
  float* dCBg = Mg + Qp * Qp;
  float* Rg = dCBg + Qp * Qp;
  float* pcolT = Rg + Qp * Qp;        // [I][j]: column sums of dM o K over tile (I, J)
  float* pdw = pcolT + nq4 * Qp;      // [n tile][j]: parts of dw_j
  float* pz = pdw + nn4 * Qp;         // [n tile][i]: parts of dy_i . (C state_in^T)_i
  const bool inter = c > 0;           // the state entering the first chunk is zero
  const float* Sin = states + blk * P * N;
  const float* dS = dstates + blk * P * N;

  // ---- A. tiles (I, J), I >= J: K = C B^T o L, M = K dt_j (the scores),
  // dM = dy x^T, d(C B^T) = dM o L dt_j, R = dM o M to the scratch; the
  // tile's column sums of dM o K to their parts
  const int n_tri = nq4 * (nq4 + 1) / 2;
  for (int item = tid; item < n_tri; item += kBwdThreads) {
    int I, J;
    tri_index(item, I, J);
    float cb[4][4], dm[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = dm[i][j] = 0.f;
    dot4x4(cb, cs + I * 4 * LDN, LDN, bs + J * 4 * LDN, LDN, N);
    dot4x4(dm, ys + I * 4 * LDP, LDP, xs + J * 4 * LDP, LDP, P);
    float col_t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ii = I * 4 + i;
      float m[4], d[4], r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = J * 4 + j;
        // exp only where i >= j: its argument is <= 0 there
        const float l = ii >= jj ? expf(cum[ii] - cum[jj]) : 0.f;
        const float k = cb[i][j] * l;
        m[j] = k * dtv[jj];
        d[j] = dm[i][j] * l * dtv[jj];
        r[j] = dm[i][j] * m[j];
        col_t[j] += dm[i][j] * k;
      }
      *reinterpret_cast<float4*>(Mg + ii * Qp + J * 4) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(dCBg + ii * Qp + J * 4) = make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(Rg + ii * Qp + J * 4) = make_float4(r[0], r[1], r[2], r[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) pcolT[I * Qp + J * 4 + j] = col_t[j];
  }
  __syncthreads();  // the scratch is written (and visible to the block)

  const long long x_row = static_cast<long long>(H) * P;
  const long long tok0 = static_cast<long long>(b) * S + s0;
  const float d_h = Dskip[h];
  // ---- B1. dx tile (rows j, columns p): sum_{i >= j} M_ij dy_i + w_j U_j
  // + D dy_j, with U_j = dS B_j (the chunk state's transpose)
  for (int item = tid; item < nq4 * np4; item += kBwdThreads) {
    const int j0 = (item / np4) * 4, p0 = (item - (item / np4) * np4) * 4;
    float acc[4][4], u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = u[i][j] = 0.f;
    for (int i = j0; i < Qp; ++i) {
      const float4 mv = ld4(Mg + i * Qp + j0), yv = ld4(ys + i * LDP + p0);
      const float ma[4] = {mv.x, mv.y, mv.z, mv.w}, ya[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(ma[a], ya[q], acc[a][q]);
    }
    dot4x4(u, bs + j0 * LDN, LDN, dS + p0 * N, N, N);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + a;
      if (j < rows) {
        T* o = dx + (tok0 + j) * x_row + static_cast<long long>(h) * P + p0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = from_f32<T>(acc[a][q] + wv[j] * u[a][q] + d_h * ys[j * LDP + p0 + q]);
      }
    }
  }
  // ---- B2. dB tile (rows j, columns n): sum_{i >= j} d(C B^T)_ij C_i
  // + w_j V_j, V_j = x_j dS; the tile's part of dw_j = B_j . V_j
  for (int item = tid; item < nq4 * nn4; item += kBwdThreads) {
    const int j0 = (item / nn4) * 4, n0 = (item - (item / nn4) * nn4) * 4;
    float acc[4][4], v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = v[i][j] = 0.f;
    for (int i = j0; i < Qp; ++i) {
      const float4 dv = ld4(dCBg + i * Qp + j0), cv = ld4(cs + i * LDN + n0);
      const float da[4] = {dv.x, dv.y, dv.z, dv.w}, ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(da[a], ca[q], acc[a][q]);
    }
    for (int p = 0; p < P; ++p) {
      const float4 sv = ld4(dS + p * N + n0);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float xa = xs[(j0 + a) * LDP + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[a][q] = fmaf(xa, sa[q], v[a][q]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + a;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) part = fmaf(bs[j * LDN + n0 + q], v[a][q], part);
      pdw[(n0 / 4) * Qp + j] = part;
      if (j < rows) {
        float* o = dBh + ((tok0 + j) * H + h) * N + n0;
        *reinterpret_cast<float4*>(o) =
            make_float4(fmaf(wv[j], v[a][0], acc[a][0]), fmaf(wv[j], v[a][1], acc[a][1]),
                        fmaf(wv[j], v[a][2], acc[a][2]), fmaf(wv[j], v[a][3], acc[a][3]));
      }
    }
  }
  // ---- B3. dC tile (rows i, columns n): sum_{j <= i} d(C B^T)_ij B_j
  // + exp(cum_i) W_i, W_i = dy_i state_in; the tile's part of C_i . W_i
  for (int item = tid; item < nq4 * nn4; item += kBwdThreads) {
    const int i0 = (item / nn4) * 4, n0 = (item - (item / nn4) * nn4) * 4;
    float acc[4][4], wz[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = wz[i][j] = 0.f;
    for (int j = 0; j < i0 + 4; ++j) {
      const float4 bv = ld4(bs + j * LDN + n0);
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float da = dCBg[(i0 + a) * Qp + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(da, ba[q], acc[a][q]);
      }
    }
    if (inter) {
      for (int p = 0; p < P; ++p) {
        const float4 sv = ld4(Sin + p * N + n0);
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ya = ys[(i0 + a) * LDP + p];
#pragma unroll
          for (int q = 0; q < 4; ++q) wz[a][q] = fmaf(ya, sa[q], wz[a][q]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + a;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) part = fmaf(cs[i * LDN + n0 + q], wz[a][q], part);
      pz[(n0 / 4) * Qp + i] = part;
      if (i < rows) {
        float* o = dCh + ((tok0 + i) * H + h) * N + n0;
        *reinterpret_cast<float4*>(o) =
            make_float4(fmaf(ecum[i], wz[a][0], acc[a][0]), fmaf(ecum[i], wz[a][1], acc[a][1]),
                        fmaf(ecum[i], wz[a][2], acc[a][2]), fmaf(ecum[i], wz[a][3], acc[a][3]));
      }
    }
  }
  // <dS, state_in>: a lane's strided run, then a tree over the lanes
  float ip = 0.f;
  if (inter)
    for (int e = tid; e < P * N; e += kBwdThreads) ip = fmaf(dS[e], Sin[e], ip);
  red2[tid] = ip;
  __syncthreads();  // the parts are written; red2 is full
  ip = block_tree(red2, kBwdThreads);

  // ---- C. d(dt A)_t = sum_{i >= t, j < t} R_ij + sum_{i >= t} exp(cum_i)
  // dy_i . Z_i + sum_{i < t} w_i dw_i + exp(total) <dS, state_in>, and ddt
  if (tid < Qp) {
    // column j = tid of R: its sums over i >= t, for t > j, in place
    float s = 0.f;
    for (int i = Qp - 1; i > tid; --i) {
      s += Rg[i * Qp + tid];
      Rg[i * Qp + tid] = s;
    }
  }
  __syncthreads();
  float da_r = 0.f, ddt_part = 0.f;
  if (tid < kMaxQ) {
    float ez = 0.f, wdw = 0.f;
    if (tid < Qp) {
      const int t = tid;
      float ct = 0.f, dw = 0.f, z = 0.f;
      for (int j = 0; j < t; ++j) da_r += Rg[t * Qp + j];
      for (int I = t / 4; I < nq4; ++I) ct += pcolT[I * Qp + t];
      for (int k = 0; k < nn4; ++k) {
        dw += pdw[k * Qp + t];
        z += pz[k * Qp + t];
      }
      ez = ecum[t] * z;
      wdw = wv[t] * dw;
      ddt_part = ct + tend[t] * dw;
    }
    suf[tid] = ez;
    red[tid] = wdw;
  }
  __syncthreads();
  if (tid < kMaxQ) pre[tid] = tid > 0 && tid < Qp ? red[tid - 1] : 0.f;
  __syncthreads();
  // suffix sums of suf and prefix sums of pre over the chunk (Hillis-Steele)
  for (int off = 1; off < Qp; off <<= 1) {
    const float vs = tid + off < Qp ? suf[tid + off] : 0.f;
    const float vp = tid >= off && tid < Qp ? pre[tid - off] : 0.f;
    __syncthreads();
    if (tid < Qp) {
      suf[tid] += vs;
      pre[tid] += vp;
    }
    __syncthreads();
  }
  const float a_h = A[h], state_term = expf(total) * ip;
  float da_term = 0.f, dd_term = 0.f;
  if (tid < rows) {
    const float da = da_r + suf[tid] + pre[tid] + state_term;
    ddt[(tok0 + tid) * H + h] = fmaf(a_h, da, ddt_part);
    da_term = dtv[tid] * da;
    for (int p = 0; p < P; ++p) dd_term = fmaf(xs[tid * LDP + p], ys[tid * LDP + p], dd_term);
  }
  if (tid < kMaxQ) {
    red[tid] = da_term;
    red2[tid] = dd_term;
  }
  __syncthreads();
  const float dA_c = block_tree(red, kMaxQ);
  const float dD_c = block_tree(red2, kMaxQ);
  if (tid == 0) {
    const long long n_parts = static_cast<long long>(gridDim.z) * nc * H;
    parts[blk] = dA_c;
    parts[n_parts + blk] = dD_c;
  }
}

// Launch 5.  Thread: one (token, group, n) of dB and of dC: the group's
// heads' parts summed in order, each head's kSlabs slab parts (slab_floats
// apart) in slab order, in the inputs' type.
template <typename T, int kSlabs>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_group_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                         T* __restrict__ dBm, T* __restrict__ dCm, long long n_out, int H, int G,
                         int N, long long slab_floats) {
  const long long e = static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (e >= n_out) return;
  const int hpg = H / G;
  const long long tok = e / (static_cast<long long>(G) * N);
  const int rem = static_cast<int>(e - tok * G * N), g = rem / N, n = rem - g * N;
  const long long base = (tok * H + static_cast<long long>(g) * hpg) * N + n;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < hpg; ++k) {
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      sb += dBh[base + static_cast<long long>(k) * N + s * slab_floats];
      sc += dCh[base + static_cast<long long>(k) * N + s * slab_floats];
    }
  }
  dBm[e] = from_f32<T>(sb);
  dCm[e] = from_f32<T>(sc);
}

// Launch 6.  Block (h, which): dA (which 0) or dD (which 1) of head h from the
// chunks' parts (B * nc of them, each chunk's slabs' in slab order after
// one another with the mma body's slabs): lane k sums parts k, k +
// kBwdLanes, ... in turn, then a pairwise tree over the lanes.
__global__ void __launch_bounds__(kBwdLanes)
    ssd_bwd_param_kernel(const float* __restrict__ parts, float* __restrict__ dA,
                         float* __restrict__ dD, int n_chunks, int H) {
  __shared__ float lanes[kBwdLanes];
  const int h = blockIdx.x, which = blockIdx.y, k = threadIdx.x;
  const float* src = parts + static_cast<long long>(which) * n_chunks * H + h;
  float s = 0.f;
  for (int i = k; i < n_chunks; i += kBwdLanes) s += src[static_cast<long long>(i) * H];
  lanes[k] = s;
  __syncthreads();
  const float out = block_tree(lanes, kBwdLanes);
  if (k == 0) (which == 0 ? dA : dD)[h] = out;
}

// Launch 7 of the mma body, with two slabs of P or more: thread e, ddt[e] as
// the sum of the slabs' parts (n apart) in slab order.
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_slab_sum_kernel(const float* __restrict__ parts, float* __restrict__ out, long long n,
                            int slabs) {
  const long long e = static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (e >= n) return;
  float v = parts[e];
  for (int s = 1; s < slabs; ++s) v += parts[s * n + e];
  out[e] = v;
}

// ---------------------------------------------------------------------------
// backward, mma body: the products on the TF32 tensor cores (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kMmaP = 64;             // a slab of P: a block's columns (its dx accumulators)
constexpr int kStrips = kMaxQ / 16;   // 16-token strips of a chunk: a warp each

// Row strides (floats) of the tiles in shared memory: C and B (N columns)
// kLdN, x and dy (P columns) kLdP, whatever N and P; columns past N or P
// are zero.  Compile-time strides make every fragment's offset an
// immediate of its load: with strides read at run time, integer address
// arithmetic took most of the chunk kernel's instructions (an A/B on the
// H100, PERF.md).  128 + 4 and 64 + 4 are 4 (mod 32), which keeps every
// fragment read below free of bank conflicts.
constexpr int kLdN = kMaxN + 4;
constexpr int kLdP = kMmaP + 4;

// chunk states and E: C, B (Q16 x kLdN) and x, dy (Q16 x kLdP) in fp32, dt,
// cum, w and exp(cum) (kMaxQ each), then cum in double (kMaxQ); without E
// (the forward's) B and x only
__host__ __device__ constexpr int bwd_mma_state_smem_bytes(int Q) {
  return 4 * (2 * round16(Q) * kLdN + 2 * round16(Q) * kLdP + 4 * kMaxQ) + 8 * kMaxQ;
}
template <int LP>
__host__ __device__ constexpr int fwd_state_smem_bytes(int Q) {
  return 4 * (round16(Q) * kLdN + round16(Q) * LP + 4 * kMaxQ) + 8 * kMaxQ;
}

// chunk gradients: the four tiles as above, 11 vectors of kMaxQ, two
// kBwdThreads-float reduction buffers, the strips' row sums of R (kStrips x
// kMaxQ), then one region for two 8-row slabs of a state (8 x kLdN each)
// and, after them, the strips' diagonal tiles of R (kStrips x 16 x 16)
__host__ __device__ constexpr int bwd_mma_smem_bytes(int Q) {
  return 4 * (2 * round16(Q) * kLdN + 2 * round16(Q) * kLdP + 11 * kMaxQ + 2 * kBwdThreads +
              kStrips * kMaxQ + (kStrips * 256 > 16 * kLdN ? kStrips * 256 : 16 * kLdN));
}

// hi = x and lo = x - hi, each truncated to TF32 (its low 13 bits cleared;
// ref.py:truncate_tf32): x - hi - lo stays below 2^-20 |x|.  The flash
// backward rounds both to nearest (two integer ops more a split); here the
// splits are most of the instructions, and truncating them took the
// backward from 1.73 to 1.49 ms at mamba2-130m's shape (NVIDIA H100 80GB
// HBM3, 700.00 W; kernels/ab_ssd.py, PERF.md) with the same errors.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a b[i] for W accumulators from split operands, the two small terms
// first (ref.py:split_einsum); each pass runs over all W before the next, so
// no product waits for the one before it.
template <int W>
__device__ __forceinline__ void mma_tf32x3(float (*c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[W][2],
                                           const uint32_t (&blo)[W][2]) {
#pragma unroll
  for (int i = 0; i < W; ++i) mma_tf32(c[i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
  for (int i = 0; i < W; ++i) mma_tf32(c[i], ahi, blo[i][0], blo[i][1]);
#pragma unroll
  for (int i = 0; i < W; ++i) mma_tf32(c[i], ahi, bhi[i][0], bhi[i][1]);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g);
// the accumulator c0, c1 at row g, columns 2t, 2t + 1, c2, c3 at row g + 8.

// A (16 x 8 at column k0) of a row-major fp32 tile, split.
__device__ __forceinline__ void a_split(const float* a, int ld, int k0, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31;
  const float* p = a + (lane >> 2) * ld + k0 + (lane & 3);
  split_trunc(p[0], hi[0], lo[0]);
  split_trunc(p[8 * ld], hi[1], lo[1]);
  split_trunc(p[4], hi[2], lo[2]);
  split_trunc(p[8 * ld + 4], hi[3], lo[3]);
}

// acc (16 x 8W) += A B^T over K (a multiple of 8): A the 16 rows at a, B the
// 8W rows at b, both row-major with k along the row.
template <int W>
__device__ __forceinline__ void mma_abt(float (&acc)[W][4], const float* a, int lda,
                                        const float* b, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ahi[4], alo[4], bhi[W][2], blo[W][2];
    a_split(a, lda, k0, ahi, alo);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float* br = b + (j * 8 + g) * ldb + k0 + t;
      split_trunc(br[0], bhi[j][0], blo[j][0]);
      split_trunc(br[4], bhi[j][1], blo[j][1]);
    }
    mma_tf32x3<W>(acc, ahi, alo, bhi, blo);
  }
}

// acc (16 x 8 ntiles) += X B: X (16 x 16) in registers in the accumulator
// layout (two 8-column tiles), B (16 x 8 ntiles) row-major at b.  X's
// columns 2t and 2t + 1 of tile j go in as k = t and t + 4 of k-step j, B's
// rows 2t and 2t + 1 with them.  The tensor cores' fp32 accumulation
// truncates (as the flash backward found, csrc/flash_attention.cu), so each
// chunk of 4 output tiles is summed in a fresh accumulator and added to acc
// in fp32.
template <int NO>
__device__ __forceinline__ void mma_xb(float (&acc)[NO][4], const float (&x)[2][4],
                                       const float* b, int ldb, int ntiles) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ahi[2][4], alo[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split_trunc(x[j][0], ahi[j][0], alo[j][0]);
    split_trunc(x[j][2], ahi[j][1], alo[j][1]);
    split_trunc(x[j][1], ahi[j][2], alo[j][2]);
    split_trunc(x[j][3], ahi[j][3], alo[j][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += 4) {
    if (n0 < ntiles) {
      float part[4][4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* br = b + (j * 8 + 2 * t) * ldb + g;
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const bool in = n0 + n < ntiles;
          split_trunc(in ? br[(n0 + n) * 8] : 0.f, bhi[n][0], blo[n][0]);
          split_trunc(in ? br[ldb + (n0 + n) * 8] : 0.f, bhi[n][1], blo[n][1]);
        }
        mma_tf32x3<4>(part, ahi[j], alo[j], bhi, blo);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (n0 + n < ntiles)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
    }
  }
}

// acc (16 x 8 ntiles) += A B for one k-step: A (16 x 8 at column k0) of a
// row-major tile, B (8 x 8 ntiles) row-major at b.
template <int NO>
__device__ __forceinline__ void mma_ab_step(float (&acc)[NO][4], const float* a, int lda, int k0,
                                            const float* b, int ldb, int ntiles) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ahi[4], alo[4];
  a_split(a, lda, k0, ahi, alo);
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += 4) {
    if (n0 < ntiles) {
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bool in = n0 + n < ntiles;
        split_trunc(in ? b[t * ldb + (n0 + n) * 8 + g] : 0.f, bhi[n][0], blo[n][0]);
        split_trunc(in ? b[(t + 4) * ldb + (n0 + n) * 8 + g] : 0.f, bhi[n][1], blo[n][1]);
      }
      mma_tf32x3<4>(acc + n0, ahi, alo, bhi, blo);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [0, Q16) of a tile of `cols` columns into dst (row stride ld floats,
// ld - 4 a multiple of 8 and at least cols) as fp32, rows >= rows and
// columns >= cols zero; src
// rows src_row elements apart, 16-byte aligned.  fp32: every 16-byte vector
// in flight at once by cp.async (the caller waits); bf16: kLoadAhead vectors
// of 8 a thread in flight, widened in registers.
constexpr int kLoadAhead = 8;
template <typename T>
__device__ __forceinline__ void mma_load_tile(float* dst, int ld, const T* src, long long src_row,
                                              int rows, int cols, int Q16) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    const int nv = ld / 4;
    for (int e = tid; e < Q16 * nv; e += kBwdThreads) {
      const int t = e / nv, v = e - t * nv;
      const bool in = t < rows && 4 * v < cols;
      cp_async16(dst + t * ld + 4 * v, in ? src + t * src_row + 4 * v : src, in);
    }
  } else {
    const int nv = (ld - 4) / 8, total = Q16 * nv;  // the last 4 columns: zero
    for (int e0 = tid; e0 < total; e0 += kLoadAhead * kBwdThreads) {
      uint4 raw[kLoadAhead];
#pragma unroll
      for (int u = 0; u < kLoadAhead; ++u) {
        const int e = e0 + u * kBwdThreads, t = e / nv, v = e - t * nv;
        raw[u] = e < total && t < rows && 8 * v < cols
                     ? *reinterpret_cast<const uint4*>(src + t * src_row + 8 * v)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kLoadAhead; ++u) {
        const int e = e0 + u * kBwdThreads, t = e / nv, v = e - t * nv;
        if (e < total) {
          const T* hv = reinterpret_cast<const T*>(&raw[u]);
          float4* d = reinterpret_cast<float4*>(dst + t * ld + 8 * v);
          d[0] = make_float4(to_f32(hv[0]), to_f32(hv[1]), to_f32(hv[2]), to_f32(hv[3]));
          d[1] = make_float4(to_f32(hv[4]), to_f32(hv[5]), to_f32(hv[6]), to_f32(hv[7]));
        }
      }
    }
    for (int t = tid; t < Q16; t += kBwdThreads)
      *reinterpret_cast<float4*>(dst + t * ld + ld - 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The chunk's C, B (rows t, columns n), x and dy (rows t, columns p of the
// slab pb .. pb + ps - 1) into shared memory as fp32 with row strides kLdN
// and LP (padding rows and columns zero; for fp32 the caller waits for the
// cp.async copies), and dt into dtv.  C and dy are skipped where cs and ys
// are null (the forward's chunk states read neither).
template <typename T, int LP = kLdP>
__device__ void mma_load_chunk(float* cs, float* bs, float* xs, float* ys, float* dtv,
                               const T* x, const T* dy, const T* Bm, const T* Cm,
                               const float* dt, int b, int h, int g, int s0, int rows, int S,
                               int H, int P, int G, int N, int Q16, int pb, int ps) {
  const long long x_row = static_cast<long long>(H) * P, bc_row = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + s0;
  const long long xo = row0 * x_row + static_cast<long long>(h) * P + pb;
  const long long bo = row0 * bc_row + static_cast<long long>(g) * N;
  if (cs != nullptr) mma_load_tile<T>(cs, kLdN, Cm + bo, bc_row, rows, N, Q16);
  mma_load_tile<T>(bs, kLdN, Bm + bo, bc_row, rows, N, Q16);
  mma_load_tile<T>(xs, LP, x + xo, x_row, rows, ps, Q16);
  if (ys != nullptr) mma_load_tile<T>(ys, LP, dy + xo, x_row, rows, ps, Q16);
  const int t = threadIdx.x;
  if (t < kMaxQ) dtv[t] = t < rows ? dt[(row0 + t) * H + h] : 0.f;
}

// Launch 1 of the backward's mma body (kE) and of the forward's mma_tf32x3
// body (!kE).  Block (c * slabs + si, h, b): cum (as ssd_bwd_state_kernel;
// written by slab 0), the chunk's local end state sum_t (w_t x_t) B_t^T
// into states and, for the backward, E = sum_t (exp(cum_t) dy_t) C_t^T into
// dstates, the slab's rows of (P x N) each: a warp a (product, 16 rows of
// P) item, the 16 x N tile summed over the chunk's tokens in one accumulator
// (A read down the token-major tiles).  Without E the block holds only B
// and x (103 KB at chunk 128 and P 64: two blocks an SM), and an item is
// half of N, so that the 8 warps have 8 items at P 64.  LP: x's (and dy's)
// row stride in shared memory, kLdP for a slab of up to 64 columns.
// kSlabs: 1 (the whole of P in one block), or 2 slabs of kMmaP columns (P
// past 64), fixed at compile time so that the one-slab kernel is the plain
// one.
template <typename T, bool kE, int LP = kLdP, int kSlabs = 1>
__global__ void __launch_bounds__(kBwdThreads, kE ? 1 : 2)
    ssd_state_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const T* __restrict__ dy,
                         float* __restrict__ cum_out, float* __restrict__ states,
                         float* __restrict__ dstates, int S, int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x / kSlabs, si = blockIdx.x - c * kSlabs, nc = gridDim.x / kSlabs;
  const int h = blockIdx.y, b = blockIdx.z;
  const int pb = si * kMmaP, ps = kSlabs > 1 ? min(P - pb, kMmaP) : P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int gh = h / (H / G);
  const int Q16 = round16(Q);
  constexpr int LN = kLdN;
  const int s0 = c * Q, rows = min(Q, S - s0);
  float* base = reinterpret_cast<float*>(smem4);
  float* cs = kE ? base : nullptr;
  float* bs = kE ? base + Q16 * LN : base;
  float* xs = bs + Q16 * LN;
  float* ys = kE ? xs + Q16 * LP : nullptr;
  float* dtv = kE ? ys + Q16 * LP : xs + Q16 * LP;
  float* cum = dtv + kMaxQ;
  float* wv = cum + kMaxQ;  // exp(total - cum_t) dt_t
  float* ev = wv + kMaxQ;   // exp(cum_t)
  double* cd = reinterpret_cast<double*>(ev + kMaxQ);
  mma_load_chunk<T, LP>(cs, bs, xs, ys, dtv, x, dy, Bm, Cm, dt, b, h, gh, s0, rows, S, H, P, G,
                        N, Q16, pb, ps);
  cp_async_wait_all();
  __syncthreads();
  if (tid < kMaxQ) cd[tid] = static_cast<double>(dtv[tid] * A[h]);
  __syncthreads();
  // inclusive cumsum of dt * A (Hillis-Steele in double, rounded once)
  for (int off = 1; off < Q16; off <<= 1) {
    const double v = tid >= off && tid < Q16 ? cd[tid - off] : 0.0;
    __syncthreads();
    if (tid < Q16) cd[tid] += v;
    __syncthreads();
  }
  if (tid < kMaxQ) cum[tid] = static_cast<float>(cd[tid]);
  __syncthreads();
  const float total = cum[Q16 - 1];
  if (tid < Q16) {
    wv[tid] = expf(total - cum[tid]) * dtv[tid];
    ev[tid] = expf(cum[tid]);
  }
  if (si == 0 && tid < Q)
    cum_out[(static_cast<long long>(b) * H + h) * nc * Q + s0 + tid] = cum[tid];
  __syncthreads();

  const long long off = (((static_cast<long long>(b) * nc + c) * H + h) * P + pb) * N;
  const int strips = round16(ps) / 16, ntiles = N / 8;
  // an item is (side, strip of P, part of N): the backward's parts are the
  // whole of N, the forward's halves of it
  constexpr int kParts = kE ? 1 : 2, NT = kMaxN / 8 / kParts;
  const int per = (ntiles + kParts - 1) / kParts;
  for (int item = warp; item < (kE ? 2 : 1) * strips * kParts; item += kBwdThreads / 32) {
    const bool e_side = kE && item >= strips;  // E = (exp(cum) dy)^T C, else (w x)^T B
    const int rest = e_side ? item - strips : item;
    const int p0 = rest / kParts * 16;
    const int nb = kE ? 0 : rest % kParts * per;  // the item's first 8-column tile
    const int nts = kE ? ntiles : min(per, ntiles - nb);
    const float* as = e_side ? ys : xs;
    const float* bt = e_side ? cs : bs;
    const float* sv = e_side ? ev : wv;
    float acc[NT][4] = {};
    for (int k0 = 0; k0 < Q16; k0 += 8) {
      // A (p, k = token): the token-major tile read down its columns, each
      // token's row scaled by its weight
      const float s_lo = sv[k0 + t], s_hi = sv[k0 + t + 4];
      const float* ap = as + (k0 + t) * LP + p0 + g;
      uint32_t ahi[4], alo[4];
      split_trunc(ap[0] * s_lo, ahi[0], alo[0]);
      split_trunc(ap[8] * s_lo, ahi[1], alo[1]);
      split_trunc(ap[4 * LP] * s_hi, ahi[2], alo[2]);
      split_trunc(ap[4 * LP + 8] * s_hi, ahi[3], alo[3]);
      const float* bp = bt + (k0 + t) * LN + nb * 8 + g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += 4) {
        if (n0 < nts) {
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const bool in = n0 + n < nts;
            split_trunc(in ? bp[(n0 + n) * 8] : 0.f, bhi[n][0], blo[n][0]);
            split_trunc(in ? bp[4 * LN + (n0 + n) * 8] : 0.f, bhi[n][1], blo[n][1]);
          }
          mma_tf32x3<4>(acc + n0, ahi, alo, bhi, blo);
        }
      }
    }
    float* out = (e_side ? dstates : states) + off;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < nts) {
        const int n = (nb + nt) * 8 + 2 * t;
        if (p0 + g < ps)
          store2(out + static_cast<long long>(p0 + g) * N + n, acc[nt][0], acc[nt][1]);
        if (p0 + g + 8 < ps)
          store2(out + static_cast<long long>(p0 + g + 8) * N + n, acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// The floats of C B^T for one (b, chunk, group): Q16 x Q16 (the tiles
// above the diagonal unused), and its transpose after it where kT (the
// backward reads both, the forward only C B^T).  The backward's mma body
// keeps them in its workspace from `scratch` on, after the fma body's parts.
template <bool kT>
__host__ __device__ constexpr long long cb_floats(int Q) {
  return (kT ? 2LL : 1LL) * round16(Q) * round16(Q);
}

// Launch 1b of the backward's mma body and launch 2 of the forward's
// mma_tf32x3 body.  Block (c, g, b): C B^T of the chunk's tokens, the
// 16 x 16 tiles on and below the diagonal (a warp a tile in turn), as the
// chunk blocks would form it (mma_abt, one fresh accumulator over N), once
// for the group's heads rather than in each head's block; written
// row-major and, where kT, transposed.
template <typename T, bool kT>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ cbw,
                  int S, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, gh = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int Q16 = round16(Q), ns = Q16 / 16;
  constexpr int LN = kLdN;
  const int s0 = c * Q, rows = min(Q, S - s0);
  float* cs = reinterpret_cast<float*>(smem4);
  float* bs = cs + Q16 * LN;
  const long long bc_row = static_cast<long long>(G) * N;
  const long long bo =
      (static_cast<long long>(b) * S + s0) * bc_row + static_cast<long long>(gh) * N;
  mma_load_tile<T>(cs, LN, Cm + bo, bc_row, rows, N, Q16);
  mma_load_tile<T>(bs, LN, Bm + bo, bc_row, rows, N, Q16);
  cp_async_wait_all();
  __syncthreads();
  float* cb = cbw + ((static_cast<long long>(b) * nc + c) * G + gh) * cb_floats<kT>(Q);
  float* cbt = cb + Q16 * Q16;
  for (int item = warp; item < ns * (ns + 1) / 2; item += kBwdThreads / 32) {
    int I, J;
    tri_index(item, I, J);
    float acc[2][4] = {};
    mma_abt<2>(acc, cs + I * 16 * LN, LN, bs + J * 16 * LN, LN, N);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = I * 16 + g + 8 * h, j = J * 16 + nt * 8 + 2 * t4;
        store2(cb + i * Q16 + j, acc[nt][2 * h], acc[nt][2 * h + 1]);
        if (kT) {
          cbt[j * Q16 + i] = acc[nt][2 * h];
          cbt[(j + 1) * Q16 + i] = acc[nt][2 * h + 1];
        }
      }
  }
}

// Launch 4 of the mma body.  Block (c, h, b), a warp a 16-token strip w of
// the chunk, in four phases on the TF32 tensor cores (3xTF32):
//   1. rows i of strip w, the inter-chunk term (c > 0): W_i = dy_i state_in
//      (the state through shared memory in 8-row slabs of P, double
//      buffered with cp.async); dC_i <- exp(cum_i) W_i, z_i = C_i . W_i.
//   2. rows i of strip w, tiles J <= w: C B^T (launch 1b's, read from the
//      workspace) and dy x^T (16 x 16, in a fresh accumulator), d(C B^T) =
//      dy x^T o L dt_j in registers, and dC_i += d(C B^T) B_j; dC_i is
//      stored.
//   3. rows j of strip w, the chunk state's term: U_j = B_j dS^T (an 8-column
//      tile a slab of dS), dx_j <- w_j U_j + D dy_j, dw_j = x_j . U_j,
//      dB_j <- w_j (x_j dS).
//   4. rows j of strip w, tiles I >= w: (C B^T)^T (launch 1b's) and
//      (dy x^T)^T, then
//      M^T, d(C B^T)^T and R = dM o M in registers; dx_j += M^T dy_I, dB_j
//      += d(C B^T)^T C_I; the column sums sum_i dM_ij K_ij for ddt; R's
//      sums that d(dt A) needs (below).  dx and dB are stored.
// Strip w takes w + 1 tiles in phase 2 and ns - w in phase 4: every warp
// the same number.  Nothing of the Q x Q scores leaves the registers but
// R's sums: d(dt A)_t's term sum_{i >= t, j < t} R_ij is, for t in strip
// tau, sum_{i >= t} sum_{J < tau} r_i(J) + sum_{j in tau, j < t} c_j +
// (the diagonal tile's part), with r_i(J) the row sums of strip J's tiles
// below its diagonal (rsum), c_j the column sums of those tiles (csv), and
// strip tau's diagonal tile of R in shared memory; every sum in a fixed
// order.  Then as ssd_bwd_chunk_kernel: ddt, and the chunk's parts of dA
// and dD.  With slabs > 1 the block is (c * slabs + si, h, b) and takes
// the slab's columns pb .. pb + ps - 1 of x, dy, dx and the rows of the
// states: dx is its own, and what it writes of dC, dB (per head), ddt and
// the dA / dD parts is the slab's part, each slab's in a region of its own
// (ddt's in the workspace, which launch 7 adds up).  NTN and NTP: N / 8
// and the slab's ps / 8 when known at compile time (N 128 with P 64 or 128,
// mamba2-130m's and its 128-wide heads': every guard and k-loop bound then
// a constant), else 0 (read from N and ps).  kSlabs: the slabs of P, 1 or
// 2 at compile time (the one-slab kernel then the plain one), or 0 (read
// from slabs).
template <typename T, int NTN, int NTP, int kSlabs>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_chunk_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                             const float* __restrict__ A, const T* __restrict__ Bm,
                             const T* __restrict__ Cm, const float* __restrict__ Dskip,
                             const T* __restrict__ dy, const float* __restrict__ cum_in,
                             const float* __restrict__ states, const float* __restrict__ dstates,
                             const float* __restrict__ cbw, T* __restrict__ dx,
                             float* __restrict__ ddt, float* __restrict__ dBh,
                             float* __restrict__ dCh, float* __restrict__ parts, int S, int H,
                             int P, int G, int N, int Q, int slabs_in) {
  extern __shared__ float4 smem4[];
  const int slabs = kSlabs > 0 ? kSlabs : slabs_in;
  const int c = blockIdx.x / slabs, si = blockIdx.x - c * slabs, nc = gridDim.x / slabs;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int gh = h / (H / G);
  const int Q16 = round16(Q), ns = Q16 / 16;
  constexpr int LN = kLdN, LP = kLdP;
  // slab si's columns of P (one slab: P, at most kMmaP)
  const int pb = si * kMmaP, ps = kSlabs == 1 ? P : min(P - pb, kMmaP);
  const int ntn = NTN > 0 ? NTN : N / 8, ntp = NTP > 0 ? NTP : ps / 8;
  const int Kn = 8 * ntn, Kp = 8 * ntp;  // N and the slab's width
  // the slab's parts: dC and dB per head, ddt, dA and dD
  const long long bsh = static_cast<long long>(gridDim.z) * S * H;
  dCh += si * bsh * N;
  dBh += si * bsh * N;
  ddt += si * bsh;
  const int s0 = c * Q, rows = min(Q, S - s0);
  float* cs = reinterpret_cast<float*>(smem4);  // Q16 x LN: C (i, n)
  float* bs = cs + Q16 * LN;                     // Q16 x LN: B (j, n)
  float* xs = bs + Q16 * LN;                     // Q16 x LP: x (j, p)
  float* ys = xs + Q16 * LP;                     // Q16 x LP: dy (i, p)
  float* dtv = ys + Q16 * LP;
  float* cum = dtv + kMaxQ;
  float* ecum = cum + kMaxQ;  // exp(cum_i)
  float* tend = ecum + kMaxQ; // exp(total - cum_j)
  float* wv = tend + kMaxQ;   // exp(total - cum_j) dt_j
  float* ctv = wv + kMaxQ;    // sum_{i >= j} dM_ij K_ij
  float* dwv = ctv + kMaxQ;   // dw_j = x_j . U_j
  float* zv = dwv + kMaxQ;    // z_i = C_i . W_i
  float* csv = zv + kMaxQ;    // c_j
  float* suf = csv + kMaxQ;   // suffix sums of exp(cum_i) z_i
  float* pre = suf + kMaxQ;   // prefix sums of w_i dw_i
  float* red = pre + kMaxQ;   // kBwdThreads floats each
  float* red2 = red + kBwdThreads;
  float* rsum = red2 + kBwdThreads;     // kStrips x kMaxQ: r_i(J), then prefix sums over J
  float* slab = rsum + kStrips * kMaxQ; // two 8 x LN slabs; after phase 3 the diagonal tiles
  float* diag = slab;                   // kStrips x 16 x 16: R (j, i) of strip tiles (w, w)

  mma_load_chunk<T>(cs, bs, xs, ys, dtv, x, dy, Bm, Cm, dt, b, h, gh, s0, rows, S, H, P, G, N,
                    Q16, pb, ps);
  const float* cb_in = cum_in + (static_cast<long long>(b) * H + h) * nc * Q + s0;
  if (tid < Q16) cum[tid] = cb_in[min(tid, Q - 1)];  // rows past Q: the chunk's total
  for (int e = tid; e < kStrips * kMaxQ; e += kBwdThreads) rsum[e] = 0.f;
  const long long blk = (static_cast<long long>(b) * nc + c) * H + h;
  const bool inter = c > 0;  // the state entering the first chunk is zero
  const float* Sin = states + (blk * P + pb) * N;
  const float* dS = dstates + (blk * P + pb) * N;
  // C B^T of the chunk's group (launch 1b), and its transpose
  const float* cbm = cbw + ((static_cast<long long>(b) * nc + c) * G + gh) * cb_floats<true>(Q);
  const float* cbtm = cbm + Q16 * Q16;
  // <dS, state_in> while the tiles load: a thread's 4-vectors in turn (a
  // tree over the threads at the end)
  float ip = 0.f;
  if (inter) {
#pragma unroll 4
    for (int e = tid; e < ps * N / 4; e += kBwdThreads) {
      const float4 u = reinterpret_cast<const float4*>(dS)[e];
      const float4 v = reinterpret_cast<const float4*>(Sin)[e];
      ip = fmaf(u.x, v.x, ip);
      ip = fmaf(u.y, v.y, ip);
      ip = fmaf(u.z, v.z, ip);
      ip = fmaf(u.w, v.w, ip);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const float total = cum[Q16 - 1];
  if (tid < Q16) {
    ecum[tid] = expf(cum[tid]);
    tend[tid] = expf(total - cum[tid]);
    wv[tid] = tend[tid] * dtv[tid];
  }
  __syncthreads();

  const bool own = warp < ns;                  // the warp's strip lies in the chunk
  const int w16 = warp * 16, r0 = w16 + g, r1 = r0 + 8;  // the thread's two rows
  const long long x_row = static_cast<long long>(H) * P;
  const long long tok0 = static_cast<long long>(b) * S + s0;
  const float d_h = Dskip[h];
  // slab s (rows 8s .. 8s + 7) of a (P x N) state into buffer s % 2
  auto stage = [&](const float* st, int s) {
    float* dst = slab + (s & 1) * 8 * LN;
    const int nv = N / 4;
    for (int e = tid; e < 8 * nv; e += kBwdThreads) {
      const int r = e / nv, v = e - r * nv;
      cp_async16(dst + r * LN + v * 4, st + static_cast<long long>(8 * s + r) * N + v * 4, true);
    }
    cp_async_commit();
  };

  // ---- 1. W_i = dy_i state_in over the slabs of state_in; dC_i <- exp(cum_i) W_i
  float acc[kMaxN / 8][4];  // W, then dC (rows i of the strip)
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  if (inter) {
    stage(Sin, 0);
#pragma unroll
    for (int s = 0; s < kMmaP / 8; ++s) {
      if (s < ntp) {
        if (s + 1 < ntp) {
          stage(Sin, s + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (own) mma_ab_step<kMaxN / 8>(acc, ys + w16 * LP, LP, 8 * s, slab + (s & 1) * 8 * LN,
                                        LN, ntn);
        __syncthreads();  // the buffer is staged again two slabs on
      }
    }
  }
  if (own) {
    float z[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      if (nt < ntn) {
        const int n = nt * 8 + 2 * t4;
        z[0] = fmaf(cs[r0 * LN + n], acc[nt][0], z[0]);
        z[0] = fmaf(cs[r0 * LN + n + 1], acc[nt][1], z[0]);
        z[1] = fmaf(cs[r1 * LN + n], acc[nt][2], z[1]);
        z[1] = fmaf(cs[r1 * LN + n + 1], acc[nt][3], z[1]);
        acc[nt][0] *= ecum[r0];
        acc[nt][1] *= ecum[r0];
        acc[nt][2] *= ecum[r1];
        acc[nt][3] *= ecum[r1];
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      z[q] += __shfl_xor_sync(0xffffffffu, z[q], 1);
      z[q] += __shfl_xor_sync(0xffffffffu, z[q], 2);
    }
    if (t4 == 0) {
      zv[r0] = z[0];
      zv[r1] = z[1];
    }

    // ---- 2. tiles (w, J <= w): dC_i += d(C B^T)_ij B_j
    const float c0 = cum[r0], c1 = cum[r1];
    for (int J = 0; J <= warp; ++J) {
      float cb[2][4], dm[2][4] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(
              cbm + (r0 + 8 * h) * Q16 + J * 16 + nt * 8 + 2 * t4));
          cb[nt][2 * h] = v.x;
          cb[nt][2 * h + 1] = v.y;
        }
      mma_abt<2>(dm, ys + w16 * LP, LP, xs + J * 16 * LP, LP, Kp);
      float dcb[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? r0 : r1, j = J * 16 + nt * 8 + 2 * t4 + (e & 1);
          // exp only where i >= j: its argument is <= 0 there
          const float l = i >= j ? expf((e < 2 ? c0 : c1) - cum[j]) : 0.f;
          dcb[nt][e] = dm[nt][e] * l * dtv[j];
        }
      mma_xb<kMaxN / 8>(acc, dcb, bs + J * 16 * LN, LN, ntn);
    }
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      if (nt < ntn) {
        const int n = nt * 8 + 2 * t4;
        if (r0 < rows) store2(dCh + ((tok0 + r0) * H + h) * N + n, acc[nt][0], acc[nt][1]);
        if (r1 < rows) store2(dCh + ((tok0 + r1) * H + h) * N + n, acc[nt][2], acc[nt][3]);
      }
    }
  }

  // ---- 3. U_j = B_j dS^T, a slab (8 columns of U) at a time: dx_j <- w_j U_j
  // + D dy_j, dw_j = x_j . U_j; V_j = x_j dS over the slabs, dB_j <- w_j V_j
  float dxa[kMmaP / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float dw[2] = {0.f, 0.f};
  stage(dS, 0);
#pragma unroll
  for (int s = 0; s < kMmaP / 8; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[s][e] = 0.f;
    if (s < ntp) {
      if (s + 1 < ntp) {
        stage(dS, s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* sl = slab + (s & 1) * 8 * LN;
      if (own) {
        float u[1][4] = {};
        mma_abt<1>(u, bs + w16 * LN, LN, sl, LN, Kn);
        const int p = 8 * s + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? r0 : r1, pp = p + (e & 1);
          dxa[s][e] = fmaf(wv[j], u[0][e], d_h * ys[j * LP + pp]);
          dw[e >> 1] = fmaf(xs[j * LP + pp], u[0][e], dw[e >> 1]);
        }
        mma_ab_step<kMaxN / 8>(acc, xs + w16 * LP, LP, 8 * s, sl, LN, ntn);
      }
      __syncthreads();  // the buffer is staged again two slabs on; the last
                        // one frees the region for the diagonal tiles
    }
  }

  if (own) {
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      acc[nt][0] *= wv[r0];
      acc[nt][1] *= wv[r0];
      acc[nt][2] *= wv[r1];
      acc[nt][3] *= wv[r1];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      dw[q] += __shfl_xor_sync(0xffffffffu, dw[q], 1);
      dw[q] += __shfl_xor_sync(0xffffffffu, dw[q], 2);
    }
    if (t4 == 0) {
      dwv[r0] = dw[0];
      dwv[r1] = dw[1];
    }

    // ---- 4. tiles (I >= w, w), transposed: rows j, columns i
    const float dt0 = dtv[r0], dt1 = dtv[r1], c0 = cum[r0], c1 = cum[r1];
    float ct[2] = {0.f, 0.f}, cr[2] = {0.f, 0.f};
    for (int I = warp; I < ns; ++I) {
      float cbt[2][4], dmt[2][4] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(
              cbtm + (r0 + 8 * h) * Q16 + I * 16 + nt * 8 + 2 * t4));
          cbt[nt][2 * h] = v.x;
          cbt[nt][2 * h + 1] = v.y;
        }
      mma_abt<2>(dmt, xs + w16 * LP, LP, ys + I * 16 * LP, LP, Kp);
      float mt[2][4], dct[2][4], rc[2][2] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = g + (e >> 1) * 8, il = nt * 8 + 2 * t4 + (e & 1), i = I * 16 + il;
          const float l = I > warp || il >= jl ? expf(cum[i] - (e < 2 ? c0 : c1)) : 0.f;
          const float k = cbt[nt][e] * l, dtj = e < 2 ? dt0 : dt1;
          const float m = k * dtj, r = dmt[nt][e] * m;
          mt[nt][e] = m;
          dct[nt][e] = dmt[nt][e] * l * dtj;
          ct[e >> 1] = fmaf(dmt[nt][e], k, ct[e >> 1]);
          if (I > warp) {
            cr[e >> 1] += r;
            rc[nt][e & 1] += r;
          } else {
            diag[warp * 256 + jl * 16 + il] = r;
          }
        }
      if (I > warp) {
        // column sums over the strip's 16 rows: the row pairs by shuffles
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float v = rc[nt][q];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) rsum[warp * kMaxQ + I * 16 + nt * 8 + 2 * t4 + q] = v;
          }
      }
      mma_xb<kMmaP / 8>(dxa, mt, ys + I * 16 * LP, LP, ntp);
      mma_xb<kMaxN / 8>(acc, dct, cs + I * 16 * LN, LN, ntn);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      ct[q] += __shfl_xor_sync(0xffffffffu, ct[q], 1);
      ct[q] += __shfl_xor_sync(0xffffffffu, ct[q], 2);
      cr[q] += __shfl_xor_sync(0xffffffffu, cr[q], 1);
      cr[q] += __shfl_xor_sync(0xffffffffu, cr[q], 2);
    }
    if (t4 == 0) {
      ctv[r0] = ct[0];
      ctv[r1] = ct[1];
      csv[r0] = cr[0];
      csv[r1] = cr[1];
    }
    T* dxb = dx + tok0 * x_row + static_cast<long long>(h) * P + pb;
#pragma unroll
    for (int nt = 0; nt < kMmaP / 8; ++nt) {
      if (nt < ntp) {
        const int p = nt * 8 + 2 * t4;
        if (r0 < rows) store2(dxb + r0 * x_row + p, dxa[nt][0], dxa[nt][1]);
        if (r1 < rows) store2(dxb + r1 * x_row + p, dxa[nt][2], dxa[nt][3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      if (nt < ntn) {
        const int n = nt * 8 + 2 * t4;
        if (r0 < rows) store2(dBh + ((tok0 + r0) * H + h) * N + n, acc[nt][0], acc[nt][1]);
        if (r1 < rows) store2(dBh + ((tok0 + r1) * H + h) * N + n, acc[nt][2], acc[nt][3]);
      }
    }
  }

  red2[tid] = ip;
  __syncthreads();  // shared memory holds every strip's sums and tiles
  ip = block_tree(red2, kBwdThreads);
  // rsum[J][i] <- sum_{J' <= J} rsum[J'][i]
  if (tid < Q16)
    for (int J = 1; J + 1 < ns; ++J) rsum[J * kMaxQ + tid] += rsum[(J - 1) * kMaxQ + tid];
  __syncthreads();

  // ---- d(dt A)_t = sum_{i >= t, j < t} R_ij + sum_{i >= t} exp(cum_i) z_i
  // + sum_{i < t} w_i dw_i + exp(total) <dS, state_in>, and ddt
  float da_r = 0.f, ddt_part = 0.f;
  if (tid < kMaxQ) {
    float ez = 0.f, wdw = 0.f;
    if (tid < Q16) {
      const int t = tid, tau = t / 16, tl = t - tau * 16;
      // sum_{i >= t} sum_{J < tau} r_i(J): four running sums, then a tree
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      if (tau > 0) {
        const float* pj = rsum + (tau - 1) * kMaxQ;
        int i = t;
        for (; i + 3 < Q16; i += 4) {
          a0 += pj[i];
          a1 += pj[i + 1];
          a2 += pj[i + 2];
          a3 += pj[i + 3];
        }
        for (; i < Q16; ++i) a0 += pj[i];
      }
      // sum_{j in tau, j < t} c_j, and the diagonal tile: j < t <= i
      float cj = 0.f, dg = 0.f;
      for (int j = tau * 16; j < t; ++j) cj += csv[j];
      const float* dtile = diag + tau * 256;
      for (int jl = 0; jl < tl; ++jl)
        for (int il = tl; il < 16; ++il) dg += dtile[jl * 16 + il];
      da_r = ((a0 + a1) + (a2 + a3)) + (cj + dg);
      ez = ecum[t] * zv[t];
      wdw = wv[t] * dwv[t];
      ddt_part = ctv[t] + tend[t] * dwv[t];
    }
    suf[tid] = ez;
    red[tid] = wdw;
  }
  __syncthreads();
  if (tid < kMaxQ) pre[tid] = tid > 0 && tid < Q16 ? red[tid - 1] : 0.f;
  __syncthreads();
  // suffix sums of suf and prefix sums of pre over the chunk (Hillis-Steele)
  for (int off = 1; off < Q16; off <<= 1) {
    const float vs = tid + off < Q16 ? suf[tid + off] : 0.f;
    const float vp = tid >= off && tid < Q16 ? pre[tid - off] : 0.f;
    __syncthreads();
    if (tid < Q16) {
      suf[tid] += vs;
      pre[tid] += vp;
    }
    __syncthreads();
  }
  const float a_h = A[h], state_term = expf(total) * ip;
  float da_term = 0.f, dd_term = 0.f;
  if (tid < rows) {
    const float da = da_r + suf[tid] + pre[tid] + state_term;
    ddt[(tok0 + tid) * H + h] = fmaf(a_h, da, ddt_part);
    da_term = dtv[tid] * da;
    for (int p = 0; p < ps; ++p) dd_term = fmaf(xs[tid * LP + p], ys[tid * LP + p], dd_term);
  }
  if (tid < kMaxQ) {
    red[tid] = da_term;
    red2[tid] = dd_term;
  }
  __syncthreads();
  const float dA_c = block_tree(red, kMaxQ);
  const float dD_c = block_tree(red2, kMaxQ);
  if (tid == 0) {
    // part (b, c, slab): the param kernel sums them in that order
    const long long n_parts = static_cast<long long>(gridDim.z) * gridDim.x * H;
    const long long part = (static_cast<long long>(b) * gridDim.x + blockIdx.x) * H + h;
    parts[part] = dA_c;
    parts[n_parts + part] = dD_c;
  }
}

// ---------------------------------------------------------------------------
// forward, mma_tf32x3 body: float32 on the TF32 tensor cores (3xTF32)
// ---------------------------------------------------------------------------

// chunk scan: x (Q16 rows of 8 NP + 4 floats), the state entering the chunk
// as (hi, lo) pairs (8 NP rows of kLdN), cum and dt (kMaxQ each)
template <int NP>
__host__ __device__ constexpr int scan_tf32_smem_bytes(int Q) {
  return 4 * round16(Q) * (8 * NP + 4) + 8 * (8 * NP) * kLdN + 8 * kMaxQ;
}

// Launch 4 of the mma_tf32x3 body.  Block (c, h, b); a warp owns a 16-row
// strip of the chunk (warps w and w + 4 share an SM sub-partition and take
// strips w and 7 - w, so that every sub-partition gets the same work):
//   y_i = exp(cum_i) (C_i state_in^T) + sum_{J <= strip} (C B^T o L o dt_j)_iJ x_J + D x_i
// The state entering the chunk is split into hi and lo once, into shared
// memory, where every warp reads it; C's rows come from device memory (each
// warp reads only its own, split as it reads them), C B^T from launch 2
// (one a group), x from shared memory.  The inter-chunk term sums its 16
// k-steps in a fresh accumulator, each tile of scores times x is summed in
// a fresh one and added in fp32 (mma_xb): the tensor cores truncate their
// fp32 accumulation.  One rounding at the store.  NP: 8-column tiles of P
// the accumulators hold (P <= 8 NP): 8 holds mamba2-130m's P 64 with two
// blocks an SM (103 KB each), 16 P up to 128 with one (200 KB).
template <int NP>
__global__ void __launch_bounds__(kBwdThreads, NP <= 8 ? 2 : 1)
    ssd_chunk_scan_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                               const float* __restrict__ Cm, const float* __restrict__ Dskip,
                               const float* __restrict__ cum_in,
                               const float* __restrict__ states, const float* __restrict__ cbw,
                               float* __restrict__ y, int S, int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int gh = h / (H / G);
  const int Q16 = round16(Q), ntp = P / 8;
  constexpr int LX = 8 * NP + 4, LS = kLdN;
  const int s0 = c * Q, rows = min(Q, S - s0);
  float* xs = reinterpret_cast<float*>(smem4);               // Q16 x LX: x (j, p)
  uint2* ss = reinterpret_cast<uint2*>(xs + Q16 * LX);        // 8 NP x LS: state_in (p, n)
  float* cumv = reinterpret_cast<float*>(ss + 8 * NP * LS);   // kMaxQ
  float* dtv = cumv + kMaxQ;                                  // kMaxQ

  const long long x_row = static_cast<long long>(H) * P;
  const long long tok0 = static_cast<long long>(b) * S + s0;
  mma_load_tile<float>(xs, LX, x + tok0 * x_row + static_cast<long long>(h) * P, x_row, rows, P,
                       Q16);
  const bool inter = c > 0;  // the state entering the first chunk is zero
  if (inter) {
    // state_in split into (hi, lo), kStateBatch 4-float loads a thread in
    // flight at once
    const float* sb = states + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
    const int nv = N / 4, total = P * nv;
    for (int e0 = tid; e0 < total; e0 += kStateBatch * kBwdThreads) {
      float4 v[kStateBatch];
#pragma unroll
      for (int u = 0; u < kStateBatch; ++u) {
        const int e = e0 + u * kBwdThreads;
        v[u] = e < total ? reinterpret_cast<const float4*>(sb)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kStateBatch; ++u) {
        const int e = e0 + u * kBwdThreads, p = e / nv, q = e - p * nv;
        if (e < total) {
          uint32_t hi[4], lo[4];
          split_trunc(v[u].x, hi[0], lo[0]);
          split_trunc(v[u].y, hi[1], lo[1]);
          split_trunc(v[u].z, hi[2], lo[2]);
          split_trunc(v[u].w, hi[3], lo[3]);
          uint4* d = reinterpret_cast<uint4*>(ss + p * LS + 4 * q);
          d[0] = make_uint4(hi[0], lo[0], hi[1], lo[1]);
          d[1] = make_uint4(hi[2], lo[2], hi[3], lo[3]);
        }
      }
    }
  }
  if (tid < Q16) {
    // the tile's rows past Q take the chunk's last cum (their dt is 0)
    cumv[tid] = cum_in[(static_cast<long long>(b) * H + h) * nc * Q + s0 + min(tid, Q - 1)];
    dtv[tid] = tid < rows ? dt[(tok0 + tid) * H + h] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int mt = warp < 4 ? warp : 11 - warp, w16 = mt * 16;
  if (w16 >= rows) return;  // no row of the strip lies in the sequence
  const int r0 = w16 + g, r1 = r0 + 8;
  const float c0 = cumv[r0], c1 = cumv[r1];
  float acc[NP][4];
#pragma unroll
  for (int pt = 0; pt < NP; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
  if (inter) {
    // C (rows i, k = n) @ state_in^T (n, p); rows past the sequence read
    // its last row (their y is not stored)
    const long long bc_row = static_cast<long long>(G) * N, co = static_cast<long long>(gh) * N;
    const float* ca = Cm + (tok0 + min(r0, rows - 1)) * bc_row + co + t4;
    const float* cb = Cm + (tok0 + min(r1, rows - 1)) * bc_row + co + t4;
#pragma unroll 4
    for (int k0 = 0; k0 < N; k0 += 8) {
      uint32_t ahi[4], alo[4];
      split_trunc(__ldg(ca + k0), ahi[0], alo[0]);
      split_trunc(__ldg(cb + k0), ahi[1], alo[1]);
      split_trunc(__ldg(ca + k0 + 4), ahi[2], alo[2]);
      split_trunc(__ldg(cb + k0 + 4), ahi[3], alo[3]);
      const uint2* bp = ss + g * LS + k0 + t4;
#pragma unroll
      for (int n0 = 0; n0 < NP; n0 += 4) {
        if (n0 < ntp) {
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const bool in = n0 + n < ntp;
            const uint2 v0 = in ? bp[(n0 + n) * 8 * LS] : make_uint2(0u, 0u);
            const uint2 v1 = in ? bp[(n0 + n) * 8 * LS + 4] : make_uint2(0u, 0u);
            bhi[n][0] = v0.x;
            blo[n][0] = v0.y;
            bhi[n][1] = v1.x;
            blo[n][1] = v1.y;
          }
          mma_tf32x3<4>(acc + n0, ahi, alo, bhi, blo);
        }
      }
    }
    const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
    for (int pt = 0; pt < NP; ++pt) {
      acc[pt][0] *= e0;
      acc[pt][1] *= e0;
      acc[pt][2] *= e1;
      acc[pt][3] *= e1;
    }
  }
  // tiles (strip, J <= strip): the scores C B^T exp(cum_i - cum_j) dt_j,
  // masked on the diagonal tile before the exp, times x_J
  const float* cbm = cbw + ((static_cast<long long>(b) * nc + c) * G + gh) * cb_floats<false>(Q);
  for (int J = 0; J <= mt; ++J) {
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(
            cbm + (r0 + 8 * hh) * Q16 + J * 16 + nt * 8 + 2 * t4));
        sc[nt][2 * hh] = v.x;
        sc[nt][2 * hh + 1] = v.y;
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r0 : r1, j = J * 16 + nt * 8 + 2 * t4 + (e & 1);
        // exp only where i >= j: its argument is <= 0 there
        sc[nt][e] = i >= j ? sc[nt][e] * expf((e < 2 ? c0 : c1) - cumv[j]) * dtv[j] : 0.f;
      }
    mma_xb<NP>(acc, sc, xs + J * 16 * LX, LX, ntp);
  }
  // y = acc + D x, one rounding at the store
  const float d_h = Dskip[h];
  float* yb = y + tok0 * x_row + static_cast<long long>(h) * P;
#pragma unroll
  for (int pt = 0; pt < NP; ++pt) {
    if (pt < ntp) {
      const int p = pt * 8 + 2 * t4;
      if (r0 < rows)
        store2(yb + r0 * x_row + p, fmaf(d_h, xs[r0 * LX + p], acc[pt][0]),
               fmaf(d_h, xs[r0 * LX + p + 1], acc[pt][1]));
      if (r1 < rows)
        store2(yb + r1 * x_row + p, fmaf(d_h, xs[r1 * LX + p], acc[pt][2]),
               fmaf(d_h, xs[r1 * LX + p + 1], acc[pt][3]));
    }
  }
}

// offsets (floats) of the mma_tf32x3 body's workspace: the chunk states
// (B, nc, H, P, N), cum (B, H, nc * Q) and C B^T a (b, chunk, group)
struct FwdWorkspace {
  long long states, cum, cb, total;
};
__host__ __device__ inline FwdWorkspace fwd_workspace(int B, int S, int H, int P, int G, int N,
                                                      int Q) {
  const int nc = (S + Q - 1) / Q;
  FwdWorkspace w;
  w.states = 0;
  w.cum = round4(static_cast<long long>(B) * nc * H * P * N);
  w.cb = round4(w.cum + static_cast<long long>(B) * H * nc * Q);
  w.total = w.cb + static_cast<long long>(B) * nc * G * cb_floats<false>(Q);
  return w;
}

// The mma_tf32x3 body's four launches: chunk states and cum, C B^T a group,
// the state pass (the bf16 mma body's), the chunk scan.
template <int NP>
int launch_fwd_tf32(const float* x, const float* dt, const float* A, const float* Bm,
                    const float* Cm, const float* D, float* y, float* state, float* ws, int B,
                    int S, int H, int P, int G, int N, int Q, cudaStream_t stream) {
  constexpr int LX = 8 * NP + 4;  // x's row stride in shared memory
  cudaError_t err =
      allow_smem<ssd_state_mma_kernel<float, false, LX>>(fwd_state_smem_bytes<LX>(kMaxQ));
  if (err == cudaSuccess) err = allow_smem<ssd_cb_kernel<float, false>>(8 * kMaxQ * kLdN);
  if (err == cudaSuccess)
    err = allow_smem<ssd_chunk_scan_tf32_kernel<NP>>(scan_tf32_smem_bytes<NP>(kMaxQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = (S + Q - 1) / Q, PN = P * N;
  const FwdWorkspace w = fwd_workspace(B, S, H, P, G, N, Q);
  const dim3 chunks(nc, H, B), pass((PN / 4 + kPassThreads - 1) / kPassThreads, H, B);
  if (nc > 0) {
    ssd_state_mma_kernel<float, false, LX>
        <<<chunks, kBwdThreads, fwd_state_smem_bytes<LX>(Q), stream>>>(
            x, dt, A, Bm, nullptr, nullptr, ws + w.cum, ws + w.states, nullptr, S, H, P, G, N, Q);
    ssd_cb_kernel<float, false><<<dim3(nc, G, B), kBwdThreads, 8 * round16(Q) * kLdN, stream>>>(
        Bm, Cm, ws + w.cb, S, G, N, Q);
  }
  // S = 0: the final state is zero, which the pass writes over no chunk
  ssd_state_pass_kernel<<<pass, kPassThreads, 0, stream>>>(ws + w.states, ws + w.cum, state, H,
                                                           PN, Q, nc);
  if (nc > 0)
    ssd_chunk_scan_tf32_kernel<NP><<<chunks, kBwdThreads, scan_tf32_smem_bytes<NP>(Q), stream>>>(
        x, dt, Cm, D, ws + w.cum, ws + w.states, ws + w.cb, y, S, H, P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

bool bwd_shape_ok(int B, int S, int H, int P, int G, int N, int chunk) {
  return shape_ok(B, S, H, P, G, N, chunk) && S > 0 &&
         bwd_smem_floats((chunk + 3) & ~3, P, N) * static_cast<int>(sizeof(float)) <=
             kBwdMaxSmemBytes;
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
               const void* D, const void* dy, const void* d_state, void* dx, void* ddt, void* dA,
               void* dBm, void* dCm, void* dD, void* ws, int B, int S, int H, int P, int G, int N,
               int Q, cudaStream_t stream) {
  cudaError_t err = allow_smem<ssd_bwd_state_kernel<T>>(kBwdMaxSmemBytes);
  if (err == cudaSuccess) err = allow_smem<ssd_bwd_chunk_kernel<T>>(kBwdMaxSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = (S + Q - 1) / Q, Qp = (Q + 3) & ~3, PN = P * N;
  const int smem = bwd_smem_floats(Qp, P, N) * static_cast<int>(sizeof(float));
  const BwdWorkspace w = bwd_workspace(B, S, H, P, N, Q);
  float* wsf = static_cast<float*>(ws);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* yt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const dim3 chunks(nc, H, B), pass((PN / 4 + kPassThreads - 1) / kPassThreads, H, B);
  ssd_bwd_state_kernel<T><<<chunks, kBwdThreads, smem, stream>>>(
      xt, dtf, Af, bt, ct, yt, wsf + w.cum, wsf + w.states, wsf + w.dstates, S, H, P, G, N, Q);
  ssd_state_pass_kernel<<<pass, kPassThreads, 0, stream>>>(wsf + w.states, wsf + w.cum,
                                                           wsf + w.final_state, H, PN, Q, nc);
  ssd_bwd_state_pass_kernel<<<pass, kPassThreads, 0, stream>>>(
      wsf + w.dstates, wsf + w.cum, static_cast<const float*>(d_state), H, PN, Q, nc);
  ssd_bwd_chunk_kernel<T><<<chunks, kBwdThreads, smem, stream>>>(
      xt, dtf, Af, bt, ct, static_cast<const float*>(D), yt, wsf + w.cum, wsf + w.states,
      wsf + w.dstates, wsf + w.scratch, static_cast<T*>(dx), static_cast<float*>(ddt),
      wsf + w.dBh, wsf + w.dCh, wsf + w.parts, S, H, P, G, N, Q);
  const long long n_out = static_cast<long long>(B) * S * G * N;
  ssd_bwd_group_kernel<T, 1><<<static_cast<unsigned>((n_out + kBwdThreads - 1) / kBwdThreads),
                               kBwdThreads, 0, stream>>>(
      wsf + w.dBh, wsf + w.dCh, static_cast<T*>(dBm), static_cast<T*>(dCm), n_out, H, G, N, 0);
  ssd_bwd_param_kernel<<<dim3(H, 2), kBwdLanes, 0, stream>>>(
      wsf + w.parts, static_cast<float*>(dA), static_cast<float*>(dD), B * nc, H);
  return static_cast<int>(cudaGetLastError());
}

bool bwd_mma_shape_ok(int B, int S, int H, int P, int G, int N, int chunk) {
  return shape_ok(B, S, H, P, G, N, chunk) && S > 0 &&
         bwd_mma_smem_bytes(chunk) <= kBwdMaxSmemBytes;
}

// The mma body's slabs of P (kMmaP columns each), and its workspace: the fma
// body's (with dBh, dCh and the dA / dD parts once a slab) with C B^T and
// its transpose for each (b, chunk, group) in place of the chunk blocks'
// scratch, then with two slabs or more each slab's ddt (B * S * H).
constexpr int bwd_slabs(int P) { return (P + kMmaP - 1) / kMmaP; }
inline long long bwd_mma_ddt_offset(int B, int S, int H, int P, int G, int N, int Q) {
  return bwd_workspace(B, S, H, P, N, Q, bwd_slabs(P)).scratch +
         static_cast<long long>(B) * ((S + Q - 1) / Q) * G * cb_floats<true>(Q);
}

// The mma body: launches 2, 3, 5 and 6 are the fma body's (5 over the
// slabs' parts); 1, 1b (C B^T per group), 4 and, with two slabs, 7 its own.
template <typename T>
int launch_bwd_mma(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   const void* D, const void* dy, const void* d_state, void* dx, void* ddt,
                   void* dA, void* dBm, void* dCm, void* dD, void* ws, int B, int S, int H, int P,
                   int G, int N, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, PN = P * N, slabs = bwd_slabs(P);
  // the chunk-state and chunk-gradient kernels for these slabs; N 128 with
  // slabs of 64 (P 64, mamba2-130m's, and P 128) with their tile counts at
  // compile time
  auto state_kernel = slabs == 1 ? ssd_state_mma_kernel<T, true, kLdP, 1>
                                 : ssd_state_mma_kernel<T, true, kLdP, 2>;
  auto chunk_kernel = N == 128 && P == 64    ? ssd_bwd_chunk_mma_kernel<T, 16, 8, 1>
                      : N == 128 && P == 128 ? ssd_bwd_chunk_mma_kernel<T, 16, 8, 2>
                                             : ssd_bwd_chunk_mma_kernel<T, 0, 0, 0>;
  cudaError_t err = allow_smem<ssd_state_mma_kernel<T, true, kLdP, 1>>(kBwdMaxSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem<ssd_state_mma_kernel<T, true, kLdP, 2>>(kBwdMaxSmemBytes);
  if (err == cudaSuccess) err = allow_smem<ssd_cb_kernel<T, true>>(kBwdMaxSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem<ssd_bwd_chunk_mma_kernel<T, 16, 8, 1>>(kBwdMaxSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem<ssd_bwd_chunk_mma_kernel<T, 16, 8, 2>>(kBwdMaxSmemBytes);
  if (err == cudaSuccess)
    err = allow_smem<ssd_bwd_chunk_mma_kernel<T, 0, 0, 0>>(kBwdMaxSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdWorkspace w = bwd_workspace(B, S, H, P, N, Q, slabs);
  float* wsf = static_cast<float*>(ws);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* yt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const dim3 chunks(nc * slabs, H, B), pass((PN / 4 + kPassThreads - 1) / kPassThreads, H, B);
  state_kernel<<<chunks, kBwdThreads, bwd_mma_state_smem_bytes(Q), stream>>>(
      xt, dtf, Af, bt, ct, yt, wsf + w.cum, wsf + w.states, wsf + w.dstates, S, H, P, G, N, Q);
  ssd_cb_kernel<T, true><<<dim3(nc, G, B), kBwdThreads, 8 * round16(Q) * kLdN, stream>>>(
      bt, ct, wsf + w.scratch, S, G, N, Q);
  ssd_state_pass_kernel<<<pass, kPassThreads, 0, stream>>>(wsf + w.states, wsf + w.cum,
                                                           wsf + w.final_state, H, PN, Q, nc);
  ssd_bwd_state_pass_kernel<<<pass, kPassThreads, 0, stream>>>(
      wsf + w.dstates, wsf + w.cum, static_cast<const float*>(d_state), H, PN, Q, nc);
  // one slab writes ddt itself; two or more their parts, which launch 7 adds
  const long long bsh = static_cast<long long>(B) * S * H;
  float* ddt_parts = slabs > 1 ? wsf + bwd_mma_ddt_offset(B, S, H, P, G, N, Q)
                               : static_cast<float*>(ddt);
  chunk_kernel<<<chunks, kBwdThreads, bwd_mma_smem_bytes(Q), stream>>>(
      xt, dtf, Af, bt, ct, static_cast<const float*>(D), yt, wsf + w.cum, wsf + w.states,
      wsf + w.dstates, wsf + w.scratch, static_cast<T*>(dx), ddt_parts, wsf + w.dBh, wsf + w.dCh,
      wsf + w.parts, S, H, P, G, N, Q, slabs);
  const long long n_out = static_cast<long long>(B) * S * G * N;
  const unsigned out_blocks = static_cast<unsigned>((n_out + kBwdThreads - 1) / kBwdThreads);
  if (slabs == 1)
    ssd_bwd_group_kernel<T, 1><<<out_blocks, kBwdThreads, 0, stream>>>(
        wsf + w.dBh, wsf + w.dCh, static_cast<T*>(dBm), static_cast<T*>(dCm), n_out, H, G, N, 0);
  else
    ssd_bwd_group_kernel<T, 2><<<out_blocks, kBwdThreads, 0, stream>>>(
        wsf + w.dBh, wsf + w.dCh, static_cast<T*>(dBm), static_cast<T*>(dCm), n_out, H, G, N,
        bsh * N);
  ssd_bwd_param_kernel<<<dim3(H, 2), kBwdLanes, 0, stream>>>(
      wsf + w.parts, static_cast<float*>(dA), static_cast<float*>(dD), B * nc * slabs, H);
  if (slabs > 1)
    ssd_bwd_slab_sum_kernel<<<static_cast<unsigned>((bsh + kBwdThreads - 1) / kBwdThreads),
                              kBwdThreads, 0, stream>>>(ddt_parts, static_cast<float*>(ddt), bsh,
                                                        slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fma body.  x, y (B,S,H,P), Bm, Cm (B,S,G,N) contiguous, of one type;
// dt (B,S,H), A, D (H,) float32; state (B,H,P,N) float32, written with the
// state after the last token.  chunk 16-128; P and N multiples of 8 up to 128; G divides H.
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

// The mma body, three launches in order on one stream (nc = ceil(S / chunk)):
// ssd_chunk_state, ssd_state_pass, ssd_chunk_scan.  x, y (B,S,H,P), Bm, Cm
// (B,S,G,N) contiguous bfloat16 with 16-byte aligned bases; dt (B,S,H), A, D
// (H,) float32; the workspace states (B,nc,H,P,N) and cum (B,H,nc*chunk)
// float32; state (B,H,P,N) float32.  chunk 16-128; P and N multiples of 8 up
// to 128; G divides H.  Each returns
// cudaGetLastError() after its launch.
extern "C" int ssd_chunk_state(const void* x, const void* dt, const void* A, const void* Bm,
                               void* states, void* cum, int B, int S, int H, int P, int G,
                               int N, int chunk, void* stream) {
  if (!shape_ok(B, S, H, P, G, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err =
      allow_smem<ssd_chunk_state_kernel>(state_smem_bytes(kMaxQ, kMaxP, kMaxN));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + chunk - 1) / chunk, H, B);
  ssd_chunk_state_kernel<<<grid, kStateThreads, state_smem_bytes(chunk, P, N),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const uint16_t*>(Bm),
      static_cast<float*>(states), static_cast<float*>(cum), S, H, P, G, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_state_pass(void* states, const void* cum, void* state, int B, int S, int H,
                              int P, int N, int chunk, void* stream) {
  if (!shape_ok(B, S, H, P, 1, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const int PN = P * N;
  const dim3 grid((PN / 4 + kPassThreads - 1) / kPassThreads, H, B);
  ssd_state_pass_kernel<<<grid, kPassThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(cum), static_cast<float*>(state), H,
      PN, chunk, (S + chunk - 1) / chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_chunk_scan(const void* x, const void* dt, const void* Bm, const void* Cm,
                              const void* D, const void* cum, const void* states, void* y, int B,
                              int S, int H, int P, int G, int N, int chunk, void* stream) {
  if (!shape_ok(B, S, H, P, G, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return round16(P) <= 64
             ? launch_chunk_scan<8>(x, dt, Bm, Cm, D, cum, states, y, B, S, H, P, G, N, chunk, st)
             : launch_chunk_scan<16>(x, dt, Bm, Cm, D, cum, states, y, B, S, H, P, G, N, chunk, st);
}

// The backward.  x, dy, dx (B,S,H,P) and Bm, Cm, dBm, dCm (B,S,G,N)
// contiguous, of one type; dt, ddt (B,S,H), A, D, dA, dD (H,) float32;
// d_state (B,H,P,N) float32 or null (no gradient of the final state); ws a
// float32 workspace of ssd_bwd_workspace_floats(...) floats, 16-byte
// aligned.  S >= 1; chunk 16-128; P and N multiples of 8 up to 128 whose
// chunk block fits in 227 KB of shared memory; G divides H.  Returns
// cudaGetLastError() after the last launch.
extern "C" long long ssd_bwd_workspace_floats(int B, int S, int H, int P, int G, int N,
                                              int chunk) {
  return bwd_workspace(B, S, H, P, N, chunk).total;
}

extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* D, const void* dy, const void* d_state,
                       void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dD, void* ws,
                       int B, int S, int H, int P, int G, int N, int chunk, int dtype,
                       void* stream) {
  if (!bwd_shape_ok(B, S, H, P, G, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, dt, A, Bm, Cm, D, dy, d_state, dx, ddt, dA, dBm, dCm, dD, ws,
                               B, S, H, P, G, N, chunk, st);
    case 1:
      return launch_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, D, dy, d_state, dx, ddt, dA, dBm, dCm,
                                       dD, ws, B, S, H, P, G, N, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's mma body, on the inputs of ssd_bwd at any P (slabs of 64
// columns; a chunk block of bwd_mma_smem_bytes: 225 KB at chunk 128); ws a
// float32 workspace of ssd_bwd_mma_workspace_floats(...) floats, 16-byte
// aligned.  Returns cudaErrorInvalidValue on anything else, else
// cudaGetLastError() after the last launch.
extern "C" long long ssd_bwd_mma_workspace_floats(int B, int S, int H, int P, int G, int N,
                                                  int chunk) {
  const int slabs = bwd_slabs(P);
  return bwd_mma_ddt_offset(B, S, H, P, G, N, chunk) +
         (slabs > 1 ? static_cast<long long>(slabs) * B * S * H : 0LL);
}

extern "C" int ssd_bwd_mma(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* D, const void* dy, const void* d_state,
                           void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dD,
                           void* ws, int B, int S, int H, int P, int G, int N, int chunk,
                           int dtype, void* stream) {
  if (!bwd_mma_shape_ok(B, S, H, P, G, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd_mma<float>(x, dt, A, Bm, Cm, D, dy, d_state, dx, ddt, dA, dBm, dCm, dD,
                                   ws, B, S, H, P, G, N, chunk, st);
    case 1:
      return launch_bwd_mma<__nv_bfloat16>(x, dt, A, Bm, Cm, D, dy, d_state, dx, ddt, dA, dBm,
                                           dCm, dD, ws, B, S, H, P, G, N, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward's mma_tf32x3 body (float32), four launches in order on one
// stream: chunk states and cum, C B^T a group, the state pass, the chunk
// scan.  x, y (B,S,H,P), Bm, Cm (B,S,G,N) contiguous float32 with 16-byte
// aligned bases; dt (B,S,H), A, D (H,) float32; state (B,H,P,N) float32,
// written with the state after the last token; ws a float32 workspace of
// ssd_fwd_mma_tf32_workspace_floats(...) floats, 16-byte aligned.  chunk
// 16-128; P and N multiples of 8 up to 128; G divides H.  Returns
// cudaErrorInvalidValue on anything else, else cudaGetLastError() after the
// last launch.
extern "C" long long ssd_fwd_mma_tf32_workspace_floats(int B, int S, int H, int P, int G, int N,
                                                       int chunk) {
  return fwd_workspace(B, S, H, P, G, N, chunk).total;
}

extern "C" int ssd_fwd_mma_tf32(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, const void* D, void* y, void* state, void* ws,
                                int B, int S, int H, int P, int G, int N, int chunk,
                                void* stream) {
  if (!shape_ok(B, S, H, P, G, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* df = static_cast<const float*>(D);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  float* wf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return P <= 64 ? launch_fwd_tf32<8>(xf, dtf, Af, bf, cf, df, yf, sf, wf, B, S, H, P, G, N,
                                      chunk, st)
                 : launch_fwd_tf32<16>(xf, dtf, Af, bf, cf, df, yf, sf, wf, B, S, H, P, G, N,
                                       chunk, st);
}
