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
//     in, fp32 accumulate).  Each of the 4 warps owns 16 query rows; its Q
//     fragments stay in registers for the whole KV loop.  K and V tiles are
//     staged in shared memory as bf16 (rows padded by 8 elements so the
//     fragment loads are free of bank conflicts); V's fragments come from
//     ldmatrix.trans.  The score accumulators are rescaled, exponentiated and
//     repacked in registers as the A operand of the PV product, so the
//     probabilities never touch shared memory.  They are rounded to bf16 for
//     PV, as the reference casts its probabilities to v's type.
//   * fp32: the same tiling on the fp32 FMA units (no tensor-core type keeps
//     fp32's 2e-5 agreement), 128 threads as 16 row groups x 8 column lanes,
//     with Q, K, V and the probability tile staged in shared memory as fp32.
//
// What bounds it: at the qwen2-7b prefill shapes (B 4, S 512, H 28, K 4,
// dh 128, causal, bf16) the least time the card could take is set by bytes
// (q, k, v read once and o written once: 34 MB over 3.35 TB/s, 10 us) just
// above the operations (7.5 GFLOP over 989 TFLOP/s, 7.6 us).  Neither body
// gets near it: mma.sync reaches a fraction of the wgmma rate, the tile
// loads are plain 2-byte loads that are not overlapped with the products,
// and a 64-key tile on the causal diagonal computes its masked half anyway.
// wgmma, TMA with a ring of stages, and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per KV tile
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
};

// Keys [lo, hi) that some query of the tile [q0, q0 + kBQ) can see.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int* lo, int* hi) {
  const int q_last = min(q0 + kBQ, p.S) - 1;
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

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_attn_bf16_kernel(Params p) {
  constexpr int kStride = DH + 8;  // padded row of the K and V tiles, in elements
  constexpr int kKSteps = DH / 16;
  constexpr int kSTiles = kBK / 8;
  constexpr int kOTiles = DH / 8;
  __shared__ __align__(16) uint16_t sK[kBK * kStride];
  __shared__ __align__(16) uint16_t sV[kBK * kStride];

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
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int qi = qrow[f & 1];
      const int c = kk * 16 + 2 * t + (f >> 1) * 8;
      const uint16_t* src = qb + qi * p.q_ss + c;
      qf[kk][f] = qi < S ? pack_raw(src[0], src[1]) : 0u;
    }
  }

  int kv_lo, kv_hi;
  kv_range(p, q0, &kv_lo, &kv_hi);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBK * DH; idx += kThreads) {
      const int r = idx / DH, c = idx % DH, s = k0 + r;
      sK[r * kStride + c] = s < S ? kb[s * p.k_ss + c] : 0;
      sV[r * kStride + c] = s < S ? vb[s * p.v_ss + c] : 0;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 tiles of 16 x 8.
    float sacc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      const uint16_t* krow = sK + (j * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(sacc[j], qf[kk], b0, b1);
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
    for (int kk = 0; kk < kBK / 16; ++kk) {
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

  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + (static_cast<long long>(b) * S * p.H + h) * DH;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qrow[rr] >= S) continue;
    const float inv_l = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    __nv_bfloat16* orow = ob + static_cast<long long>(qrow[rr]) * p.H * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          oacc[n][2 * rr] * inv_l, oacc[n][2 * rr + 1] * inv_l);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA units
// ---------------------------------------------------------------------------

constexpr int kRows = kBQ / 16;  // rows per thread
constexpr int kCols = kBK / 8;   // score columns per thread

// Shared-memory layout of the fp32 body, in floats.
template <int DH>
struct Smem32 {
  static constexpr int kQStride = DH + 1;
  static constexpr int kKStride = DH + 1;
  static constexpr int kVStride = DH;
  static constexpr int kPStride = kBK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQStride;
  static constexpr int kV = kK + kBK * kKStride;
  static constexpr int kP = kV + kBK * kVStride;
  static constexpr size_t kBytes = sizeof(float) * (kP + kBQ * kPStride);
};

// Stage rows [s0, s0 + 64) of one head; rows at or past S are zero.
template <int DH>
__device__ __forceinline__ void load_tile32(float* dst, int dst_stride, const float* base,
                                            long long seq_stride, int s0, int S) {
  static_assert(kBQ == kBK, "one tile height for Q, K and V");
  for (int idx = threadIdx.x; idx < kBK * DH; idx += kThreads) {
    const int r = idx / DH, c = idx % DH, s = s0 + r;
    dst[r * dst_stride + c] = s < S ? base[s * seq_stride + c] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_attn_f32_kernel(Params p) {
  using L = Smem32<DH>;
  constexpr int kOut = DH / 8;
  extern __shared__ float smem[];
  float* sQ = smem + L::kQ;
  float* sK = smem + L::kK;
  float* sV = smem + L::kV;
  float* sP = smem + L::kP;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int S = p.S;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile32<DH>(sQ, L::kQStride, qb, p.q_ss, q0, S);

  int kv_lo, kv_hi;
  kv_range(p, q0, &kv_lo, &kv_hi);
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
    load_tile32<DH>(sK, L::kKStride, kb, p.k_ss, k0, S);
    load_tile32<DH>(sV, L::kVStride, vb, p.v_ss, k0, S);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
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

  float* ob = static_cast<float*>(p.o) + (static_cast<long long>(b) * S * p.H + h) * DH;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv_l = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = ob + static_cast<long long>(qi) * p.H * DH;
#pragma unroll
    for (int j = 0; j < kOut; ++j) orow[tx + 8 * j] = acc[i][j] * inv_l;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

dim3 grid_of(const Params& p) { return dim3((p.S + kBQ - 1) / kBQ, p.H, p.B); }

template <int DH>
int launch_bf16(const Params& p, cudaStream_t stream) {
  flash_attn_bf16_kernel<DH><<<grid_of(p), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = Smem32<DH>::kBytes;
  auto kernel = flash_attn_f32_kernel<DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(p), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,S,H,dh), k/v (B,S,K,dh) given by strides (in elements, last dim
// contiguous); o (B,S,H,dh) contiguous.  dtype codes: 0 = float32,
// 1 = bfloat16 (q, k, v and o share it).  head_dim is 32, 64 or 128.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int K, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, int causal, int window,
                                   int chunk, float scale, int head_dim, int dtype,
                                   void* stream) {
  const Params p{q,    k,    v,    o,    B,      S,      H,     K,
                 q_sb, q_ss, q_sh, k_sb, k_ss,   k_sh,   v_sb,  v_ss,
                 v_sh, causal, window, chunk, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = dtype * 1000 + head_dim;
  switch (key) {
    case 32: return launch_f32<32>(p, st);
    case 64: return launch_f32<64>(p, st);
    case 128: return launch_f32<128>(p, st);
    case 1032: return launch_bf16<32>(p, st);
    case 1064: return launch_bf16<64>(p, st);
    case 1128: return launch_bf16<128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
