// Forward flash attention for Hopper (sm_90a): GQA, causal / sliding-window /
// chunked masks, fp32 online softmax.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _attn_kernel).  It
// computes what that kernel computes, not what it does block by block:
//
//   * The TPU walks a sequential grid axis over KV blocks and carries the
//     running max / denominator / accumulator in VMEM scratch between grid
//     steps.  Here CTAs run in parallel and in no order, so one CTA owns a
//     64-row query tile of one (batch, head) and loops over 64-key KV tiles
//     itself, with the running statistics and the accumulator in fp32
//     registers.  Grid = (q tiles, heads, batch).
//   * GQA: query head h reads KV head h / (H / K), as the TPU index maps do.
//   * KV tiles that the mask cannot reach (above the causal diagonal, aged
//     out of the window, outside the query tile's chunks) are never loaded:
//     the loop runs over the reachable range only.  Inside a tile the mask is
//     applied per element, and the ragged tail (S not a multiple of 64) is
//     masked, so S needs no alignment.  A row that sees no key returns 0.
//   * Q, K and V are read in their (B, S, heads, dh) layout through strides,
//     so the wrapper makes no transposed copy (the TPU wrapper transposes).
//
// Two bodies, one per input type:
//
//   * bf16 (the serving path): tensor cores through mma.sync m16n8k16 (bf16
//     in, fp32 accumulate).  Each of the 4 warps owns 16 query rows.  Q, K and
//     V tiles are staged in shared memory as bf16 with 16-byte loads and
//     stores (rows padded by 8 elements so the fragment loads are free of
//     bank conflicts); Q's fragments are read from there one 16-wide k-step
//     at a time, so only the O accumulator (dh / 2 floats a thread) stays in
//     registers across the KV loop, and V's fragments come from
//     ldmatrix.trans.  The score accumulators are
//     rescaled, exponentiated and repacked in registers as the A operand of
//     the PV product, so the probabilities never touch shared memory.  They
//     are rounded to bf16 for PV, as the reference casts its probabilities to
//     v's type.
//   * fp32: the same tiling on the fp32 FMA units (no tensor-core type keeps
//     fp32's 2e-5 agreement), 128 threads as 16 row groups x 8 column lanes,
//     with Q, K, V and the probability tile staged in shared memory as fp32.
//
// Head dims: every one the model registry uses (16, 32, 64, 80, 120, 128,
// 160, 256).  Each body is compiled for the head dim rounded up to 16 (the
// mma k-step); a head dim below that width (120 -> 128) is zero-filled in
// shared memory as it is loaded and masked when O is stored, so the wrapper
// makes no padded copy.  Above 128 the tiles shrink so that registers and
// shared memory still fit: 32-key tiles in the bf16 body (the O accumulator
// alone is 128 registers a thread at dh 256) and 32-row query tiles in the
// fp32 body.
//
// What bounds it: at the serving prefill shapes, bytes, just above the
// operations.  qwen2-7b (B 4, S 512, H 28, K 4, dh 128, causal, bf16):
// q, k, v read once and o written once are 34 MB, 10 us at 3.35 TB/s,
// against 7.5 GFLOP, 7.6 us at 989 TFLOP/s.  recurrentgemma-9b (H 16, K 1,
// dh 256, window 2048): 36 MB, 11 us, against 8.6 GFLOP, 8.7 us.  Neither
// body gets near it: mma.sync reaches a fraction of the wgmma rate, the tile
// loads are not overlapped with the products, K and V are loaded again for
// every query tile of a head, and a tile on the causal diagonal computes
// its masked half anyway.  wgmma, TMA with a ring of stages, and warp
// specialisation are later work.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA (the fp32 body halves it above dh 128)
constexpr int kBK = 64;        // keys per KV tile (the bf16 body halves it above dh 128)
constexpr int kThreads = 128;  // 4 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // (B, S, H, dh), contiguous
  int B, S, H, K;
  long long q_sb, q_ss, q_sh;  // strides in elements; the last dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, chunk;
  float scale;
  int dh;  // the real head dim; the body's compiled width is dh rounded up to 16
};

// Keys [lo, hi) that some query of the tile [q0, q0 + bq) can see.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int bq, int* lo, int* hi) {
  const int q_last = min(q0 + bq, p.S) - 1;
  *lo = 0;
  *hi = p.S;
  if (p.causal) *hi = min(*hi, q_last + 1);
  if (p.window) *lo = max(*lo, q0 - p.window + 1);
  if (p.chunk) {
    *lo = max(*lo, (q0 / p.chunk) * p.chunk);
    *hi = min(*hi, (q_last / p.chunk + 1) * p.chunk);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  bool ok = qi < p.S && kj < p.S;
  if (p.causal) ok = ok && qi >= kj;
  if (p.window) ok = ok && (qi - kj) < p.window;
  if (p.chunk) ok = ok && (qi / p.chunk) == (kj / p.chunk);
  return ok;
}

// Stage rows [s0, s0 + rows) of one head, DHP columns wide, into shared
// memory; rows at or past S and columns at or past dh are zero.  16-byte
// loads where the head's rows allow them (the model's q, k and v always
// do), else one element at a time.
template <int DHP, typename T>
__device__ __forceinline__ void load_tile(T* dst, int dst_stride, const T* base,
                                          long long seq_stride, int s0, int rows, int S,
                                          int dh) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(base) % 16 == 0 && seq_stride % kVec == 0 &&
                   dh % kVec == 0;
  if (vec) {
    constexpr int kChunks = DHP / kVec;
    const bool vec_dst =
        (dst_stride * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * kVec, s = s0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s < S && c < dh) v = *reinterpret_cast<const uint4*>(base + s * seq_stride + c);
      T* d = dst + r * dst_stride + c;
      if (vec_dst) {
        *reinterpret_cast<uint4*>(d) = v;
      } else {
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) d[i] = e[i];
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * DHP; idx += kThreads) {
    const int r = idx / DHP, c = idx % DHP, s = s0 + r;
    dst[r * dst_stride + c] = (s < S && c < dh) ? base[s * seq_stride + c] : T(0);
  }
}

// One online-softmax step for a row whose scores this thread holds in s[],
// shared with the other lanes of its group (xor offsets below kLanes).
// Masked scores are -inf.  Returns alpha, the factor for the old
// accumulator; s[] becomes exp(s - m_new).
template <int kN, int kLanes>
__device__ __forceinline__ float softmax_step(float (&s)[kN], float& m, float& l) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kN; ++j) mx = fmaxf(mx, s[j]);
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_new = fmaxf(m, mx);
  float alpha = 1.f, rs = 0.f;
  if (m_new == -INFINITY) {  // no key visible to this row yet
#pragma unroll
    for (int j = 0; j < kN; ++j) s[j] = 0.f;
  } else {
    alpha = expf(m - m_new);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      s[j] = expf(s[j] - m_new);
      rs += s[j];
    }
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
  l = l * alpha + rs;
  m = m_new;
  return alpha;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shared-memory layout of the bf16 body, in bf16 elements.
template <int DHP>
struct SmemBf16 {
  static constexpr int kBKeys = DHP > 128 ? kBK / 2 : kBK;
  static constexpr int kStride = DHP + 8;  // padded row of the Q, K and V tiles
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kStride;
  static constexpr int kV = kK + kBKeys * kStride;
  static constexpr size_t kBytes = sizeof(uint16_t) * (kV + kBKeys * kStride);
};

template <int DHP>
__global__ void __launch_bounds__(kThreads) flash_attn_bf16_kernel(Params p) {
  using L = SmemBf16<DHP>;
  constexpr int BK = L::kBKeys;
  constexpr int kStride = L::kStride;
  constexpr int kKSteps = DHP / 16;
  constexpr int kSTiles = BK / 8;
  constexpr int kOTiles = DHP / 8;
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* sQ = smem16 + L::kQ;
  uint16_t* sK = smem16 + L::kK;
  uint16_t* sV = smem16 + L::kV;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int S = p.S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair

  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // This thread's query rows: r[0] = g and r[1] = g + 8 of the warp's 16.
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint16_t* qfrag = sQ + (warp * 16 + g) * kStride + 2 * t;
  load_tile<DHP>(sQ, kStride, qb, p.q_ss, q0, kBQ, S, p.dh);

  int kv_lo, kv_hi;
  kv_range(p, q0, kBQ, &kv_lo, &kv_hi);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int k0 = (kv_lo / BK) * BK; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read (and Q is staged)
    load_tile<DHP>(sK, kStride, kb, p.k_ss, k0, BK, S, p.dh);
    load_tile<DHP>(sV, kStride, vb, p.v_ss, k0, BK, S, p.dh);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x BK keys: BK / 8 tiles of 16 x 8,
    // one 16-wide k-step of Q's fragments at a time.
    float sacc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint32_t a[4] = {ld32(qfrag + kk * 16), ld32(qfrag + 8 * kStride + kk * 16),
                             ld32(qfrag + kk * 16 + 8), ld32(qfrag + 8 * kStride + kk * 16 + 8)};
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const uint16_t* krow = sK + (j * 8 + g) * kStride + 2 * t + kk * 16;
        mma_bf16(sacc[j], a, ld32(krow), ld32(krow + 8));
      }
    }

    // Mask and online softmax, one row (two accumulator entries per tile) at a time.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float s[2 * kSTiles];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + j * 8 + 2 * t + e;
          const float v = sacc[j][2 * rr + e] * p.scale;
          s[2 * j + e] = visible(p, qrow[rr], kj) ? v : -INFINITY;
        }
      const float alpha = softmax_step<2 * kSTiles, 4>(s, m[rr], l[rr]);
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sacc[j][2 * rr + e] = s[2 * j + e];
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        oacc[n][2 * rr] *= alpha;
        oacc[n][2 * rr + 1] *= alpha;
      }
    }

    // O += P V: P's A fragments are the score accumulators, repacked to bf16.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                             pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                             pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                             pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
      const uint16_t* vrow = sV + (kk * 16 + (lane & 15)) * kStride;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        uint32_t b0, b1;
        const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(vrow + n * 8));
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(addr));
        mma_bf16(oacc[n], a, b0, b1);
      }
    }
  }

  const int dh = p.dh;
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + (static_cast<long long>(b) * S * p.H + h) * dh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qrow[rr] >= S) continue;
    const float inv_l = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    __nv_bfloat16* orow = ob + static_cast<long long>(qrow[rr]) * p.H * dh;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      const int c = n * 8 + 2 * t;  // dh is even, so c < dh covers c + 1 too
      if (c < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            oacc[n][2 * rr] * inv_l, oacc[n][2 * rr + 1] * inv_l);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA units
// ---------------------------------------------------------------------------

constexpr int kCols = kBK / 8;  // score columns per thread

// Shared-memory layout of the fp32 body, in floats.
template <int DHP>
struct Smem32 {
  static constexpr int kBQRows = DHP > 128 ? kBQ / 2 : kBQ;
  static constexpr int kQStride = DHP + 1;
  static constexpr int kKStride = DHP + 1;
  static constexpr int kVStride = DHP;
  static constexpr int kPStride = kBK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQRows * kQStride;
  static constexpr int kV = kK + kBK * kKStride;
  static constexpr int kP = kV + kBK * kVStride;
  static constexpr size_t kBytes = sizeof(float) * (kP + kBQRows * kPStride);
};

template <int DHP>
__global__ void __launch_bounds__(kThreads) flash_attn_f32_kernel(Params p) {
  using L = Smem32<DHP>;
  constexpr int BQ = L::kBQRows;
  constexpr int kRows = BQ / 16;  // rows per thread
  constexpr int kOut = DHP / 8;
  extern __shared__ float smem[];
  float* sQ = smem + L::kQ;
  float* sK = smem + L::kK;
  float* sV = smem + L::kV;
  float* sP = smem + L::kP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int S = p.S;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<DHP>(sQ, L::kQStride, qb, p.q_ss, q0, BQ, S, p.dh);

  int kv_lo, kv_hi;
  kv_range(p, q0, BQ, &kv_lo, &kv_hi);
  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<DHP>(sK, L::kKStride, kb, p.k_ss, k0, kBK, S, p.dh);
    load_tile<DHP>(sV, L::kVStride, vb, p.v_ss, k0, kBK, S, p.dh);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + 16 * i) * L::kQStride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 8 * j) * L::kKStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[i][j] = visible(p, qi, k0 + tx + 8 * j) ? s[i][j] * p.scale : -INFINITY;
      const float alpha = softmax_step<kCols, 8>(s[i], m[i], l[i]);
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) sP[(ty + 16 * i) * L::kPStride + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + 16 * i) * L::kPStride + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = sV[c * L::kVStride + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  const int dh = p.dh;
  float* ob = static_cast<float*>(p.o) + (static_cast<long long>(b) * S * p.H + h) * dh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv_l = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = ob + static_cast<long long>(qi) * p.H * dh;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      if (tx + 8 * j < dh) orow[tx + 8 * j] = acc[i][j] * inv_l;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int bq, size_t smem_bytes, const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + bq - 1) / bq, p.H, p.B);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_dh(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch(flash_attn_bf16_kernel<DHP>, kBQ, SmemBf16<DHP>::kBytes, p, stream);
  return launch(flash_attn_f32_kernel<DHP>, Smem32<DHP>::kBQRows, Smem32<DHP>::kBytes, p,
                stream);
}

}  // namespace

// q (B,S,H,dh), k/v (B,S,K,dh) given by strides (in elements, last dim
// contiguous); o (B,S,H,dh) contiguous.  dtype codes: 0 = float32,
// 1 = bfloat16 (q, k, v and o share it).  head_dim is one of 16, 32, 64, 80,
// 120, 128, 160, 256.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int K, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, int causal, int window,
                                   int chunk, float scale, int head_dim, int dtype,
                                   void* stream) {
  const Params p{q,    k,    v,    o,      B,      S,     H,    K,     q_sb,    q_ss,
                 q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,  v_sh, causal, window, chunk,
                 scale, head_dim};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 16: return launch_dh<16>(p, dtype, st);
    case 32: return launch_dh<32>(p, dtype, st);
    case 64: return launch_dh<64>(p, dtype, st);
    case 80: return launch_dh<80>(p, dtype, st);
    case 120:
    case 128: return launch_dh<128>(p, dtype, st);
    case 160: return launch_dh<160>(p, dtype, st);
    case 256: return launch_dh<256>(p, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
