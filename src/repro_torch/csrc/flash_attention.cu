// Flash attention for Hopper (sm_90a): GQA, causal / sliding-window /
// chunked masks, fp32 online softmax; the forward and, for training, its
// backward.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, body _attn_kernel).  It
// computes what that kernel computes, not what it does block by block:
//
//   * The TPU walks a sequential grid axis over KV blocks and carries the
//     running max / denominator / accumulator in VMEM scratch between grid
//     steps.  Here CTAs run in parallel and in no order, so one CTA owns a
//     query tile of one (batch, head) and loops over KV tiles itself, with
//     the running statistics and the accumulator in fp32 registers.
//   * GQA: query head h reads KV head h / (H / K), as the TPU index maps do.
//   * KV tiles that the mask cannot reach (above the causal diagonal, aged
//     out of the window, outside the query tile's chunks) are never loaded:
//     the loop runs over the reachable range only.  The ragged tail (S not a
//     multiple of the tile) is masked, so S needs no alignment.  A row that
//     sees no key returns 0.
//   * Q, K and V are read in their (B, S, heads, dh) layout through strides,
//     so the wrapper makes no transposed copy (the TPU wrapper transposes).
//
// Four bodies; the wrapper picks one from the dtype, the head dim and the
// alignment of q, k and v (kernels/flash_attention/kernel.py:select_body):
//
//   * sm90 (bf16, dh 80, 120, 128, 160 and 256, 16-byte aligned bases and
//     strides, a scale > 0: the serving path, the bf16 train steps and
//     hubert-xlarge's encode).
//     Warp-specialised: one producer warp issues TMA loads and two consumer
//     warpgroups run wgmma.  The CTAs are persistent, one an SM, and walk
//     the query tiles (under a causal mask latest first, the longest; else
//     head by head, so that the CTAs in flight share a head's K and V in
//     L2), so the producer loads the next tile's Q and K/V while the
//     consumers finish this one.  Q has one buffer,
//     released as soon as the tile's last Q K^T is done; K and V come
//     through a ring of 2 stages; every buffer is a TMA tile with full /
//     empty mbarriers, and the two consumer warpgroups share every K and V
//     tile.  The tensor maps are 4-D, [dh, heads, S, B] over the given
//     strides, with a box of one head x rows x a 64-element (128-byte)
//     column slab and the 128-byte swizzle that wgmma reads; TMA fills rows
//     past S and columns past dh with zeros.  S = Q K^T is wgmma m64nBKk16
//     with Q and K both K-major in shared memory, over the k16 steps that
//     hold dh; O += P V is wgmma m64n128k16 (m64n80k16 at dh 80, m64n160k16
//     at dh 160) with P in
//     registers (the score accumulators, exponentiated and repacked to bf16
//     in place: the accumulator layout is the register-A layout) and V
//     MN-major in shared memory.  The softmax runs in the log2 domain on
//     the raw scores (scale * log2(e) folded into one FMA before ex2).
//     Each consumer warpgroup classifies every KV tile against its 64 rows:
//     a tile that the mask leaves wholly visible skips the mask, one it
//     leaves wholly hidden skips the products, and only edge tiles are
//     masked, each row against the one run of keys it sees (two compares
//     an element).  O leaves through its own shared-memory buffer and a TMA
//     store that the next tile does not wait for.  Registers bound the
//     tiling: ptxas gives this kernel 168 a thread (see Sm90::kThreads), so
//     at dh 80 and 128 each warpgroup owns 64 rows of a 128-row tile with
//     BK 128 (dh 120 runs on the 128 body, its last 8 columns zero-filled),
//     at dh 160 the same rows with BK 64 (all 160 of O's columns a
//     warpgroup), and at dh 256 the two warpgroups share 64 rows and split
//     O's columns.
//   * mma (bf16 at dh 16, 32 and 64, unaligned inputs at any head dim, a
//     scale <= 0; the sm90 body's previous body, forced): tensor cores
//     through mma.sync m16n8k16.  A CTA of 4 warps owns a
//     64-row query tile; each warp owns 16 rows.  Q, K and V tiles are
//     staged in shared memory with 16-byte loads where the inputs allow
//     (rows padded by 8 elements so the fragment loads are free of bank
//     conflicts), else one element at a time; V's fragments come from ldmatrix.trans and the scores stay
//     in registers as the A operand of the PV product.
//   * mma_tf32x3 (fp32 at every head dim: the training path): the tensor
//     cores through mma.sync m16n8k8 TF32, each product from hi + lo splits
//     in three TF32 products (the backward's BwdMma<float>), which keeps
//     fp32's 2e-5 agreement; 4 warps a CTA up to dh 128, 8 at 160 and 256
//     (two to each row group, each holding half of O's columns); described
//     with its kernel below.
//   * fp32 (forced as the previous body of fp32 inputs): the same tiling as
//     mma on the fp32 FMA units, 128 threads as 16 row groups x 8 column
//     lanes, with Q, K, V and the probability tile staged in shared memory
//     as fp32.
//
// Every body rounds the probabilities to v's type for the PV product, as
// the reference casts its probabilities to v's type.
//
// Training: every body also writes each row's log-sum-exp when given a
// pointer for it (Params::lse; serving passes null), and the backward
// recomputes the probabilities from it (flash_attention_bwd, further down:
// 4 warps a CTA up to dh 80, the pair kernels of 8 above; and for bf16 at
// dh 80, 120, 128, 160 and 256, flash_attention_bwd_sm90: wgmma and TMA,
// after the sm90 forward).  The sm90 body writes it in its epilogue, from one lane a row,
// leaving O as it was.
//
// Head dims: the mma, mma_tf32x3 and fp32 bodies take every one the model
// registry uses (16, 32, 64, 80, 120, 128, 160, 256), compiled for the head
// dim rounded up to 16 (the mma k-step); a head dim below that width (120
// -> 128) is zero-filled in shared memory as it is loaded and masked when O
// is stored.  Above 128 their tiles shrink so that registers and shared
// memory still fit: 32-key tiles in the mma and mma_tf32x3 bodies (the
// latter's CTA doubled to 8 warps) and 32-row query tiles in the fp32 body.
//
// What bounds it: at the serving prefill shapes, bytes, just above the
// operations.  qwen2-7b (B 4, S 512, H 28, K 4, dh 128, causal, bf16):
// q, k, v read once and o written once are 34 MB, 10 us at 3.35 TB/s,
// against 7.5 GFLOP, 7.6 us at 989 TFLOP/s.  recurrentgemma-9b (H 16, K 1,
// dh 256, window 2048): 36 MB, 11 us, against 8.6 GFLOP, 8.7 us.  The sm90
// body still reloads K and V for every query tile of a head (from L2,
// mostly), computes Q K^T and the softmax twice at dh 256 (once in each
// warpgroup), and a consumer warpgroup waits for its own products before
// its softmax: overlapping the softmax with the next tile's Q K^T inside a
// warpgroup, packing a GQA group's heads into one tile, and clusters with
// TMA multicast are later work.
//
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace {

// The mma and fp32 bodies:
constexpr int kBQ = 64;        // query rows per CTA (the fp32 body halves it above dh 128)
constexpr int kBK = 64;        // keys per KV tile (the mma body halves it above dh 128)
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
  // (B, H, S) fp32, or null: the log-sum-exp of each row's scaled scores,
  // which the backward needs (every body writes it)
  float* lse;
  // the sm90 body: the query tiles its CTAs walk (set by launch_sm90), read
  // from the kernel's parameters rather than held in a register
  int tiles = 0;
};

// The mask, shared by the forward bodies and the backward: P is Params or
// BwdParams (S, causal, window and chunk are all they read).
//
// Keys [lo, hi) that some query of the tile [q0, q0 + bq) can see.
template <typename P>
__device__ __forceinline__ void kv_range(const P& p, int q0, int bq, int* lo, int* hi) {
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

// Queries [lo, hi) that can see some key of the tile [k0, k0 + bk).
template <typename P>
__device__ __forceinline__ void q_range(const P& p, int k0, int bk, int* lo, int* hi) {
  const int k_last = min(k0 + bk, p.S) - 1;
  *lo = 0;
  *hi = p.S;
  if (p.causal) *lo = k0;
  if (p.window) *hi = min(*hi, k_last + p.window);
  if (p.chunk) {
    *lo = max(*lo, (k0 / p.chunk) * p.chunk);
    *hi = min(*hi, (k_last / p.chunk + 1) * p.chunk);
  }
}

template <typename P>
__device__ __forceinline__ bool visible(const P& p, int qi, int kj) {
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
// accumulator; s[] becomes exp(s - m_new), or 2^(s - m_new) where kExp2
// (scores, and so m, in the log2 domain).
template <int kN, int kLanes, bool kExp2 = false>
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
    alpha = kExp2 ? exp2f(m - m_new) : expf(m - m_new);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      s[j] = kExp2 ? exp2f(s[j] - m_new) : expf(s[j] - m_new);
      rs += s[j];
    }
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
  l = l * alpha + rs;
  m = m_new;
  return alpha;
}

// The row's log-sum-exp of its scaled scores, m + log(l), into p.lse; +inf
// for a row that sees no key, so that the backward's exp(s - lse) is 0.
__device__ __forceinline__ void write_lse(const Params& p, int b, int h, int qi, float m,
                                          float l) {
  p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qi] = l > 0.f ? m + logf(l) : INFINITY;
}

// ---------------------------------------------------------------------------
// mma: bf16 through mma.sync m16n8k16
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two 8x8 bf16 matrices, transposed, from the rows that lanes 0-15 address.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(row)));
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
        ldsm_x2_trans(b0, b1, vrow + n * 8);
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
    if (p.lse != nullptr && t == 0) write_lse(p, b, h, qrow[rr], m[rr], l[rr]);
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
    if (p.lse != nullptr && tx == 0) write_lse(p, b, h, qi, m[i], l[i]);
    const float inv_l = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = ob + static_cast<long long>(qi) * p.H * dh;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      if (tx + 8 * j < dh) orow[tx + 8 * j] = acc[i][j] * inv_l;
  }
}

// ---------------------------------------------------------------------------
// backward (FlashAttention-2, deterministic) on the tensor cores: fp32 by
// the 3xTF32 split, bf16 as it is
// ---------------------------------------------------------------------------
//
// The TPU kernel has no backward (JAX differentiates the jnp reference), so
// this computes what that reference's gradient is, from the forward's
// log-sum-exp (lse) and output O, without the (S, S) probabilities:
//
//   P  = exp(scale * Q K^T - lse)      (masked entries 0)
//   dV = P^T dO          dP = dO V^T
//   dS = P * (dP - D),   D = rowsum(dO * O)
//   dQ = scale * dS K    dK = scale * dS^T Q
//
// Two launches.  First, one CTA a (query tile, head, batch) computes its
// rows' D (written to `delta` for the second launch) and accumulates dQ
// over the KV tiles its rows can see, late query tiles (the longest under
// a causal mask) first.  Then one CTA a (KV tile, KV head, batch)
// accumulates dK and dV over every query head of its GQA group and every
// query tile that can see the tile.  Every sum has one owner and a fixed
// order: no atomics, so two runs give the same bits.  The dQ launch
// computes S and dP again: seven products where the gradient needs five.
// (One launch for both roles after a pre-pass for D measured 4% faster at
// the 100m shapes on the H100, 0.186 against 0.194 ms (kernels/ab.py), but
// its dh-80 kernels needed more than 255 registers and spilled.)
//
// Up to DH 80 a CTA is 4 warps; warp w owns rows 16w..16w+15 of the CTA's
// own 64-row tile (keys in the dK/dV kernel, queries in the dQ kernel),
// staged once; the other operand's tiles (Q, dO, lse, D, or K, V) stream
// through a cp.async ring, the next tile loading while this one computes
// (BwdCfg: 64-row tiles in two stages up to DH 64, 32-row ones at DH 80).
// Above DH 80 the pair kernels (further down) take over at every head dim
// of the registry (120 runs as 128, its last 8 columns zero in shared
// memory and never stored): 8 warps a CTA, two to each 16-row group
// splitting the forming of S and dP.  For bf16 at DH 80, 120 and 128 with a
// scale > 0 the sm90 body (after the sm90 forward: wgmma and TMA) runs
// instead; the 4-warp kernels keep bf16 at DH 80 only as its previous body
// (forced) and for a scale <= 0.
// Every product is mma.sync on the tensor cores, in two shapes
// (BwdMma::rows, BwdMma::regs):
//
//   * rows: C (16 x 64) = A B^T with A the warp's 16 rows and B a streamed
//     tile, both row-major in shared memory with the head dim contiguous:
//     S^T = K Q^T and dP^T = V dO^T (dK/dV), S = Q K^T and dP = dO V^T (dQ).
//   * regs: C (16 x dh) += X B with X (16 x 64) in registers in the
//     accumulator layout (P^T, dS^T, dS) and B a tile in shared memory:
//     dV += P^T dO, dK += dS^T Q, dQ += dS K.  Keys own the rows of the
//     dK/dV kernel, so P^T comes out of S^T = K Q^T already transposed and
//     neither P nor dS goes through shared memory.
//
// fp32 (the training path): mma.sync m16n8k8 tf32, each operand split into
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away from
// zero, as cvt.rna rounds) and each product formed as
// lo*hi + hi*lo + hi*hi in fp32: about 22 bits of mantissa, which holds
// the fp32 tolerance 2e-5 (a bf16 hi + lo split, about 16 bits, does not:
// tests/test_torch_kernels.py, kernels/flash_attention/ref.py:tf32x3).
// The tf32 accumulator holds columns 2t, 2t+1 where the A operand wants t,
// t+4: regs feeds them in as k = t and t + 4 and reads B's rows in the same
// order, so X needs no shuffle.  Operands are split as their fragments are
// loaded: the shared tiles stay fp32, which keeps two CTAs an SM at dh 64.
// bf16: mma.sync m16n8k16, one product with fp32 accumulation, X repacked
// to bf16 in place (the accumulator layout is the A layout) and B's
// fragments from ldmatrix.trans, as in the forward's mma body; P and dS are
// rounded to bf16 for their products, as the reference rounds P to v's
// type.  Tiles are padded by 4 floats / 8 bf16 a row, so every fragment
// load is free of bank conflicts.  Within a tile the mask is applied only
// where the tile is not wholly visible.
//
// What bounds it: at the 100m training shapes, operations: five products
// of 32896 pairs x 64 a head, each three TF32 products; at recurrentgemma-9b's
// (q (4,512,16,256), k/v (4,512,1,256) fp32, causal) the same five products
// of 131328 pairs x 256 a head, 0.130 ms at the TF32 rate.  The pair
// kernels form S and dP once a launch (twice in the dK/dV launch at DH
// 256).  The MQA dK/dV grid at DH 256 is small (16 tiles of 32 keys, 4
// batches: 64 CTAs for 132 SMs), so a GQA group's heads are split over
// CTAs (kernels/flash_attention/kernel.py:bwd_head_split).

constexpr int kBwdThreads = 128;  // 4 warps
constexpr int kBwdTile = 64;      // rows of the CTA's own tiles (and of a streamed one: BwdCfg)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct BwdParams {
  const void* q;     // (B, S, H, dh), contiguous, like o, dout and dq
  const void* k;     // (B, S, K, dh), contiguous, like v, dk and dv
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  float* delta;      // (B, H, S): rowsum(dO * O), written by the dQ launch
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, K;
  int causal, window, chunk;
  float scale;
  int dh;
  // the dK/dV kernel's split of each GQA group's heads over head_split
  // CTAs; above 1 each writes its sums to its slice of `partial` (2,
  // head_split, B, S, K, dh) fp32, unscaled, and a third launch adds them
  int head_split;
  float* partial;
  // the sm90 body: delta is (2, B, H, s_pad) fp32, lse log2(e) then D, with
  // s_pad = S rounded up to 128; split: P and dS in hi + lo bf16 products
  // (both set by launch_bwd_sm90)
  int s_pad = 0;
  int split = 0;
};

// Every query of [q0, q0 + bq) sees every key of [k0, k0 + bk).
template <typename P>
__device__ __forceinline__ bool tile_visible(const P& p, int q0, int bq, int k0, int bk) {
  const int q1 = q0 + bq - 1, k1 = k0 + bk - 1;
  return q1 < p.S && k1 < p.S && (!p.causal || k1 <= q0) &&
         (!p.window || q1 - k0 < p.window) &&
         (!p.chunk || (q0 / p.chunk == k1 / p.chunk && k0 / p.chunk == q1 / p.chunk));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// hi = tf32(x) and lo = tf32(x - hi), rounded to nearest, ties away from
// zero (ref.py:split_tf32): the bits cvt.rna.tf32.f32 gives (finite x), by
// an integer add and mask, which took the backward from 0.245 to 0.194 ms
// at the 100m shapes on the H100 (kernels/ab.py).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// hi = x and lo = x - hi, each truncated to TF32 (the low 13 bits cleared,
// ref.py:split_product with ssd's truncate_tf32): x - hi - lo stays below
// 2^-20 |x|, in 3 operations where split_tf32 takes 5.  The forward's
// mma_tf32x3 body splits so (its products hold 0.05 of the fp32 tolerance
// either way, tests/test_torch_kernels.py); the backward keeps split_tf32.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
template <bool kTrunc>
__device__ __forceinline__ void split_op(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kTrunc)
    split_trunc(x, hi, lo);
  else
    split_tf32(x, hi, lo);
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a b[i] for W independent accumulators from split operands, the
// two small terms first (ref.py:tf32x3); each pass runs over all W before
// the next, so no product waits for the one before it.
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

// The tensor cores' fp32 accumulation truncates: a sum carried through
// hundreds of mma.sync (dV over the 24 query tiles of 8 heads) drifted by
// 1.9x the fp32 tolerance on the card.  So `regs` sums each call (one
// 64-row tile) in a fresh accumulator and adds it to the running sum with an
// fp32 add that rounds to nearest; for registers, a chunk of 4 column tiles
// at a time (2 where dh / 8 is not a multiple of 4: dh 16 and 80).
__host__ __device__ constexpr int bwd_chunk(int tiles) { return tiles % 4 == 0 ? 4 : 2; }

template <int NO, int C>
__device__ __forceinline__ void add_chunk(float (&acc)[NO][4], const float (&part)[C][4], int n0) {
#pragma unroll
  for (int n = 0; n < C; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
}

// The two products of the backward for one element type.  Fragments (g =
// lane / 4, t = lane % 4): the accumulator c0, c1 at row g, columns 2t and
// 2t + 1 of each 8-column tile, c2, c3 at row g + 8.
template <typename T>
struct BwdMma;

// fp32: m16n8k8 tf32, 3xTF32.  A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B: b0 (k t, n g), b1 (k t + 4, n g).
template <>
struct BwdMma<float> {
  static constexpr int kPad = 4;  // a row stride of 4 (mod 16) words: no bank conflicts

  // acc (16 x 8NT) += A B^T: A the warp's 16 rows, B 8NT rows, row-major in
  // shared memory with DH columns and row stride ld.  kTrunc: truncating
  // splits (split_op).
  template <int DH, int NT, bool kTrunc = false, int kKc = DH / 8>
  static __device__ __forceinline__ void rows(float (&acc)[NT][4], const float* a,
                                              const float* b, int ld) {
    if constexpr (kKc < DH / 8) {
      // each kKc-step run of the reduction in a fresh accumulator (bwd_chunk)
#pragma unroll
      for (int k0 = 0; k0 < DH / 8; k0 += kKc) {
        float part[NT][4] = {};
        steps<NT, kTrunc, kKc>(part, a + k0 * 8, b + k0 * 8, ld);
        add_chunk(acc, part, 0);
      }
    } else {
      steps<NT, kTrunc, DH / 8>(acc, a, b, ld);
    }
  }

  // acc += the products of KK reduction steps (8 columns each), W = 4 of
  // the NT tiles a pass (all of them below 4)
  template <int NT, bool kTrunc, int KK>
  static __device__ __forceinline__ void steps(float (&acc)[NT][4], const float* a,
                                               const float* b, int ld) {
    constexpr int W = NT < 4 ? NT : 4;
    static_assert(NT % W == 0, "tiles");
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const float* ar = a + g * ld + kk * 8 + t;
      uint32_t ahi[4], alo[4];
      split_op<kTrunc>(ar[0], ahi[0], alo[0]);
      split_op<kTrunc>(ar[8 * ld], ahi[1], alo[1]);
      split_op<kTrunc>(ar[4], ahi[2], alo[2]);
      split_op<kTrunc>(ar[8 * ld + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += W) {
        uint32_t bhi[W][2], blo[W][2];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float* br = b + ((j0 + j) * 8 + g) * ld + kk * 8 + t;
          split_op<kTrunc>(br[0], bhi[j][0], blo[j][0]);
          split_op<kTrunc>(br[4], bhi[j][1], blo[j][1]);
        }
        mma_tf32x3<W>(acc + j0, ahi, alo, bhi, blo);
      }
    }
  }

  // acc (16 x DH) += X B: X (16 x 8NT) in registers in the accumulator
  // layout, B (8NT x DH) row-major in shared memory.  X's columns 2t and
  // 2t + 1 go in as k = t and t + 4, and B's rows 2t and 2t + 1 with them.
  // Each chunk of acc's columns is summed in a fresh accumulator (bwd_chunk).
  // (kSplitX is the bf16 body's: fp32 splits every operand)
  template <int DH, int NT, bool kTrunc = false, bool kSplitX = false>
  static __device__ __forceinline__ void regs(float (&acc)[DH / 8][4], const float (&x)[NT][4],
                                              const float* b, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    constexpr int kChunk = bwd_chunk(DH / 8);
#pragma unroll
    for (int n0 = 0; n0 < DH / 8; n0 += kChunk) {
      float part[kChunk][4] = {};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ahi[4], alo[4];
        split_op<kTrunc>(x[j][0], ahi[0], alo[0]);
        split_op<kTrunc>(x[j][2], ahi[1], alo[1]);
        split_op<kTrunc>(x[j][1], ahi[2], alo[2]);
        split_op<kTrunc>(x[j][3], ahi[3], alo[3]);
        const float* br = b + (j * 8 + 2 * t) * ld + g;
        uint32_t bhi[kChunk][2], blo[kChunk][2];
#pragma unroll
        for (int n = 0; n < kChunk; ++n) {
          split_op<kTrunc>(br[(n0 + n) * 8], bhi[n][0], blo[n][0]);
          split_op<kTrunc>(br[ld + (n0 + n) * 8], bhi[n][1], blo[n][1]);
        }
        mma_tf32x3<kChunk>(part, ahi, alo, bhi, blo);
      }
      add_chunk(acc, part, n0);
    }
  }
};

// hi = bf16(a, b) packed, and lo = bf16 of what hi leaves of each, packed.
__device__ __forceinline__ void pack_split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// bf16: m16n8k16.  A: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
// a3 (g + 8, 2t+8..); B: b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g).
template <>
struct BwdMma<__nv_bfloat16> {
  static constexpr int kPad = 8;  // a row stride of 4 (mod 32) words, 16-byte rows

  // (kTrunc and kKc are the fp32 body's; bf16's 2e-2 needs no chunked sum)
  template <int DH, int NT, bool kTrunc = false, int kKc = DH / 8>
  static __device__ __forceinline__ void rows(float (&acc)[NT][4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* b, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint16_t* a16 = reinterpret_cast<const uint16_t*>(a);
    const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint16_t* ar = a16 + g * ld + kk * 16 + 2 * t;
      const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * ld), ld32(ar + 8), ld32(ar + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint16_t* br = b16 + (j * 8 + g) * ld + kk * 16 + 2 * t;
        mma_bf16(acc[j], af, ld32(br), ld32(br + 8));
      }
    }
  }

  // kSplitX: X in two bf16 products, hi = bf16(x) and lo = bf16(x - hi),
  // the lo one first (about 16 bits of X where one product keeps 8): P for
  // dV and dS for dK and dQ in the pair kernels.  At
  // recurrentgemma-9b's MQA shape (B 4, S 512, 16 heads, dh 256; a key's
  // dV and dK sum 8192 (head, query) terms) one product each left the
  // gradient outside the bf16 tolerance of the fp32 one on the H100
  // (chip_smoke.py's backward cases), the rounding of P and dS to bf16
  // being what a plain model of the body's roundings showed to set it.
  template <int DH, int NT, bool kTrunc = false, bool kSplitX = false>
  static __device__ __forceinline__ void regs(float (&acc)[DH / 8][4], const float (&x)[NT][4],
                                              const __nv_bfloat16* b, int ld) {
    const int lane = threadIdx.x & 31;
    const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
    constexpr int kChunk = bwd_chunk(DH / 8);
#pragma unroll
    for (int n0 = 0; n0 < DH / 8; n0 += kChunk) {
      float part[kChunk][4] = {};
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t af[4], al[4];
        pack_split_bf16(x[2 * kk][0], x[2 * kk][1], af[0], al[0]);
        pack_split_bf16(x[2 * kk][2], x[2 * kk][3], af[1], al[1]);
        pack_split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], af[2], al[2]);
        pack_split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], af[3], al[3]);
        const uint16_t* br = b16 + (kk * 16 + (lane & 15)) * ld;
#pragma unroll
        for (int n = 0; n < kChunk; ++n) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, br + (n0 + n) * 8);
          if constexpr (kSplitX) mma_bf16(part[n], al, b0, b1);
          mma_bf16(part[n], af, b0, b1);
        }
      }
      add_chunk(acc, part, n0);
    }
  }
};

// The tiling of both kernels at head dim DH (16, 32, 64 or 80) and element
// type T.  The CTA's own tiles have kBwdTile = 64 rows (4 warps x 16); the
// other operand streams through a ring of 2 stages of kStream-row tiles,
// with the streamed lse and D rows (fp32).  At DH 80 the streamed tiles
// have 32 rows, which halves the S and dP tiles a thread holds: with 64-row
// ones the dK/dV kernel spilled at DH 80 in both dtypes.  A CTA accumulates
// every column of dQ, or of dK and dV (80 accumulators a thread at DH 80,
// as the dK/dV kernel holds without a spill); above DH 80 the pair kernels
// (BwdPairCfg) and, for bf16 at 80, 120 and 128, the sm90 body take over.
template <int DH, typename T>
struct BwdCfg {
  static constexpr int kStream = DH >= 80 ? 32 : kBwdTile;
  static constexpr int kStages = 2;
  static constexpr int kLd = DH + BwdMma<T>::kPad;  // row stride, elements
  static constexpr int kOwn = kBwdTile * kLd;       // elements of an own tile
  static constexpr int kStr = kStream * kLd;        // elements of a streamed tile
  static constexpr size_t kRows = sizeof(T) * (2 * kOwn + 2 * kStages * kStr);
  static constexpr size_t kBytes = kRows + sizeof(float) * 2 * kStages * kStream;
  static_assert(DH <= 80 && DH % 16 == 0, "BwdCfg: dh 16, 32, 64 or 80");
  static_assert(kBytes <= 232448, "a block has at most 227 KB of shared memory");
};

// Rows [s0, s0 + R) of one head (row stride ld_g elements) into a tile of
// DH columns and row stride ld by cp.async, 16 bytes a copy, by kN threads;
// rows at or past S and columns at or past dh are zero (dh < DH only at DH
// 128: dh 120).
template <int DH, int R, int kN = kBwdThreads, typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src, long long ld_g, int s0,
                                           int S, int dh) {
  constexpr int kVec = 16 / sizeof(T), kChunks = DH / kVec;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kN) {
    const int r = idx / kChunks, c = (idx % kChunks) * kVec, s = s0 + r;
    const bool col = DH != 128 || c < dh;
    cp_async16(dst + r * ld + c, src + static_cast<long long>(s < S ? s : 0) * ld_g + (col ? c : 0),
               s < S && col);
  }
}

// R floats of one (b, h) row of lse or D from s0 on; zero at or past S
// (those queries are masked).
template <int R, int kN = kBwdThreads>
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int s0, int S) {
  for (int r = threadIdx.x; r < R; r += kN) {
    const int s = s0 + r;
    cp_async4(dst + r, src + (s < S ? s : 0), s < S);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void unpack16(uint4 raw, float (&out)[4]) {
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = e[i];
}
__device__ __forceinline__ void unpack16(uint4 raw, float (&out)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

// The ring stage of streamed item i.
template <int kStages>
__device__ __forceinline__ int stage_of(int i) {
  return kStages == 2 ? (i & 1) : 0;
}

// Wait for streamed item i (the CTA's own tiles came with item 0) after
// issuing the copies of item i + 1 into the other stage, or, with one stage,
// after issuing item i's own copies into the stage the last item freed.
template <int kStages, typename F>
__device__ __forceinline__ void next_item(int i, int items, F&& stage) {
  if constexpr (kStages == 2) {
    if (i + 1 < items) stage(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    if (i > 0) {
      stage(i);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }
  __syncthreads();
}

// dQ (and D) of one query tile of one head, summed over the KV tiles it
// sees.
template <int DH, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_kernel(BwdParams p) {
  using C = BwdCfg<DH, T>;
  using M = BwdMma<T>;
  constexpr int kLd = C::kLd, kBK = C::kStream, NT = kBK / 8, NO = DH / 8, dh = DH;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* tiles = reinterpret_cast<T*>(bwd_smem);
  const T* sQ = tiles;
  const T* sDO = tiles + C::kOwn;
  T* ring = tiles + 2 * C::kOwn;
  const int n_q = (p.S + kBwdTile - 1) / kBwdTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBwdTile;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long qs = static_cast<long long>(p.H) * dh, ks = static_cast<long long>(p.K) * dh;
  const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * dh;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.K + kvh) * dh;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
  stage_tile<DH, kBwdTile>(tiles, kLd, static_cast<const T*>(p.q) + q_off, qs, q0, p.S, dh);
  stage_tile<DH, kBwdTile>(tiles + C::kOwn, kLd, static_cast<const T*>(p.dout) + q_off, qs, q0,
                           p.S, dh);

  int kv_lo, kv_hi;
  kv_range(p, q0, kBwdTile, &kv_lo, &kv_hi);
  const int kt0 = kv_lo / kBK;
  const int items = max(0, (kv_hi + kBK - 1) / kBK - kt0);
  auto stage = [&](int i) {
    T* st = ring + 2 * stage_of<C::kStages>(i) * C::kStr;
    const int k0 = (kt0 + i) * kBK;
    stage_tile<DH, kBK>(st, kLd, static_cast<const T*>(p.k) + kv_off, ks, k0, p.S, dh);
    stage_tile<DH, kBK>(st + C::kStr, kLd, static_cast<const T*>(p.v) + kv_off, ks, k0, p.S,
                        dh);
  };
  if (items > 0) stage(0);
  cp_async_commit();

  // D = rowsum(dO * O) of the warp's 16 rows, from device memory while the
  // tiles load: lanes r and r + 16 take the two halves of row r's 16-byte
  // chunks.
  float d = 0.f;
  {
    constexpr int kVec = 16 / sizeof(T);
    const int s = q0 + warp * 16 + (lane & 15);
    if (s < p.S) {
      constexpr int kHalf = dh / kVec / 2;
      const long long off = q_off + s * qs + (lane >> 4) * kHalf * kVec;
      const uint4* o4 = reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + off);
      const uint4* d4 = reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + off);
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        float ov[kVec], dv[kVec];
        unpack16(o4[c], ov);
        unpack16(d4[c], dv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) d = fmaf(ov[e], dv[e], d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 16);
    if (lane < 16 && s < p.S) p.delta[row + s] = d;
  }
  // this thread's rows g and g + 8: D, and lse in the log2 domain
  const float d_row[2] = {__shfl_sync(0xffffffffu, d, g), __shfl_sync(0xffffffffu, d, g + 8)};
  const int q_row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    lse2[rr] = q_row[rr] < p.S ? p.lse[row + q_row[rr]] * kLog2e : 0.f;
  const float scale2 = p.scale * kLog2e;

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    next_item<C::kStages>(i, items, stage);  // Q, dO and tile i have landed
    const int k0 = (kt0 + i) * kBK;
    const T* sK = ring + 2 * stage_of<C::kStages>(i) * C::kStr;
    const T* sV = sK + C::kStr;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    M::template rows<DH, NT>(s, sQ + warp * 16 * kLd, sK, kLd);
    M::template rows<DH, NT>(dp, sDO + warp * 16 * kLd, sV, kLd);
    const bool full = tile_visible(p, q0, kBwdTile, k0, kBK);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, kj = k0 + j * 8 + 2 * t + (e & 1);
        const float pr = full || visible(p, q_row[rr], kj)
                             ? exp2f(fmaf(s[j][e], scale2, -lse2[rr]))
                             : 0.f;
        s[j][e] = pr * (dp[j][e] - d_row[rr]);  // dS
      }
    M::template regs<DH, NT>(dq, s, sK, kLd);
    __syncthreads();  // this stage is refilled by the copies of a later tile
  }
  cp_async_wait<0>();

  T* dqb = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (q_row[rr] >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      store2(dqb + q_row[rr] * qs + c, dq[n][2 * rr] * p.scale, dq[n][2 * rr + 1] * p.scale);
    }
  }
}

// dK and dV of one KV tile of one KV head, summed over the query heads of
// its group and the query tiles that see it.
template <int DH, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkdv_kernel(BwdParams p) {
  using C = BwdCfg<DH, T>;
  using M = BwdMma<T>;
  constexpr int kLd = C::kLd, kBQ = C::kStream, NT = kBQ / 8, NO = DH / 8, dh = DH;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* tiles = reinterpret_cast<T*>(bwd_smem);
  float* rows = reinterpret_cast<float*>(bwd_smem + C::kRows);
  const T* sK = tiles;
  const T* sV = tiles + C::kOwn;
  T* ring = tiles + 2 * C::kOwn;
  const int k0 = blockIdx.x * kBwdTile, b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.K, h0 = kvh * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long qs = static_cast<long long>(p.H) * dh, ks = static_cast<long long>(p.K) * dh;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.K + kvh) * dh;
  stage_tile<DH, kBwdTile>(tiles, kLd, static_cast<const T*>(p.k) + kv_off, ks, k0, p.S, dh);
  stage_tile<DH, kBwdTile>(tiles + C::kOwn, kLd, static_cast<const T*>(p.v) + kv_off, ks, k0,
                           p.S, dh);

  int q_lo, q_hi;
  q_range(p, k0, kBwdTile, &q_lo, &q_hi);
  const int qt0 = q_lo / kBQ;
  const int n_qt = max(0, (q_hi + kBQ - 1) / kBQ - qt0);
  const int items = G * n_qt;  // item i: head h0 + i / n_qt, query tile qt0 + i % n_qt
  auto stage = [&](int i) {
    const int h = h0 + i / n_qt, q0 = (qt0 + i % n_qt) * kBQ;
    T* st = ring + 2 * stage_of<C::kStages>(i) * C::kStr;
    const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * dh;
    stage_tile<DH, kBQ>(st, kLd, static_cast<const T*>(p.q) + q_off, qs, q0, p.S, dh);
    stage_tile<DH, kBQ>(st + C::kStr, kLd, static_cast<const T*>(p.dout) + q_off, qs, q0, p.S,
                        dh);
    const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
    float* sr = rows + stage_of<C::kStages>(i) * 2 * kBQ;
    stage_floats<kBQ>(sr, p.lse + row, q0, p.S);
    stage_floats<kBQ>(sr + kBQ, p.delta + row, q0, p.S);
  };
  if (items > 0) stage(0);
  cp_async_commit();

  const int k_row[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float scale2 = p.scale * kLog2e;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    next_item<C::kStages>(i, items, stage);  // K, V and item i have landed
    const int q0 = (qt0 + i % n_qt) * kBQ;
    const T* sQ = ring + 2 * stage_of<C::kStages>(i) * C::kStr;
    const T* sDO = sQ + C::kStr;
    const float* sLse = rows + stage_of<C::kStages>(i) * 2 * kBQ;
    const float* sD = sLse + kBQ;
    float st[NT][4], dpt[NT][4];  // S^T and dP^T: the warp's 16 keys x kBQ queries
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    M::template rows<DH, NT>(st, sK + warp * 16 * kLd, sQ, kLd);
    M::template rows<DH, NT>(dpt, sV + warp * 16 * kLd, sDO, kLd);
    const bool full = tile_visible(p, q0, kBQ, k0, kBwdTile);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        const float pr = full || visible(p, q0 + qc, k_row[e >> 1])
                             ? exp2f(fmaf(st[j][e], scale2, -sLse[qc] * kLog2e))
                             : 0.f;
        st[j][e] = pr;                          // P^T
        dpt[j][e] = pr * (dpt[j][e] - sD[qc]);  // dS^T
      }
    M::template regs<DH, NT>(dv, st, sDO, kLd);
    M::template regs<DH, NT>(dk, dpt, sQ, kLd);
    __syncthreads();  // this stage is refilled by the copies of a later item
  }
  cp_async_wait<0>();

  T* dkb = static_cast<T*>(p.dk) + kv_off;
  T* dvb = static_cast<T*>(p.dv) + kv_off;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (k_row[rr] >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long off = k_row[rr] * ks + n * 8 + 2 * t;
      store2(dkb + off, dk[n][2 * rr] * p.scale, dk[n][2 * rr + 1] * p.scale);
      store2(dvb + off, dv[n][2 * rr], dv[n][2 * rr + 1]);
    }
  }
}

// dK = scale * sum and dV = sum of the head_split partial sums, in the
// order of the split (the same bits every run), 4 elements a thread.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum_kernel(BwdParams p) {
  const long long n = static_cast<long long>(p.B) * p.S * p.K * p.dh;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;  // dh is a multiple of 8, so n of 4
  float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = k4;
  for (int hs = 0; hs < p.head_split; ++hs) {
    const float4 a = *reinterpret_cast<const float4*>(p.partial + hs * n + i);
    const float4 c = *reinterpret_cast<const float4*>(p.partial + (p.head_split + hs) * n + i);
    k4.x += a.x, k4.y += a.y, k4.z += a.z, k4.w += a.w;
    v4.x += c.x, v4.y += c.y, v4.z += c.z, v4.w += c.w;
  }
  T* dk = static_cast<T*>(p.dk) + i;
  T* dv = static_cast<T*>(p.dv) + i;
  store2(dk, k4.x * p.scale, k4.y * p.scale);
  store2(dk + 2, k4.z * p.scale, k4.w * p.scale);
  store2(dv, v4.x, v4.y);
  store2(dv + 2, v4.z, v4.w);
}

// ---------------------------------------------------------------------------
// backward above DH 80: warps sharing each 16-row group, S and dP formed once
// ---------------------------------------------------------------------------
//
// Above DH 80 the accumulators of every column would not fit 4 warps'
// registers.  These kernels give a CTA 8 warps, and the warps that share a
// 16-row group of the CTA's own tile split the forming of S and dP, each
// element formed once over the whole head dim, each run of kKc reduction
// steps summed in a fresh accumulator (ref.py:mha_grads_by_products with
// tf32x3 models it), then meet in shared memory (float4 exchanges, [row
// group][warp][tile][lane]).  The gradient needs 7 full-width products a
// (query tile, key tile) without atomics (S and dP in each launch, dQ, dK,
// dV); the column-sliced kernels these replaced formed 9 at DH 128 and 15
// at 256:
//
//   * dQ: 4 row groups of 64 query rows, two warps each: half 0 forms S and
//     P, half 1 dP; both form dS = P (dP - D) on the full tile (the same
//     bits) and each accumulates half of dQ's columns (64 a thread at DH
//     256).  3 products: S, dP, dQ.  (32 query rows in groups of 4 warps at
//     DH 256, which fits 2 stages, measured 5% slower: 0.525 against 0.50
//     ms at recurrentgemma-9b's train shape, NVIDIA H100 80GB HBM3, 700.00
//     W, kernels/ab.py --shape rgemma; its warps form 2 score tiles each,
//     half the independent mma chains.)
//   * dK/dV: a tile of kKvRows keys; up to DH 160, 64 keys in 4 row groups
//     of 2 warps: one forms S^T, turns it into P^T and accumulates dV, the
//     other forms dP^T, reads P^T, forms dS^T and accumulates dK, each over
//     all DH columns (80 accumulators a thread at 160, 64 at 120 / 128); at
//     DH 256, 32 keys in 2 row groups of 4 warps: two form S^T (16 of the
//     32 streamed queries each), two dP^T, and each accumulates half of dV's
//     or dK's 256 columns (64 a thread).  4 products: S^T, dP^T, dK, dV.
//     (64 keys with the columns in two CTA slices, each forming S^T and
//     dP^T, 6 products, took 0.80 ms against 0.567 at recurrentgemma-9b's
//     train shape; kernels/ab.py --shape rgemma, as above.)
//
// Full-width products a (query tile, key tile): 7 at every head dim.  The
// streamed tiles keep 32 rows; K and V stream through 2 stages in the dQ
// kernel (one at DH 256 in fp32: own Q and dO 133 KB, a stage 66.5 KB, the
// exchanges 16 KB, 211 KB), Q, dO, lse and D through 2 in the dK/dV kernel
// (own K and V 66.5 KB at DH 256, the stages 133 KB, 204 KB).  bf16 forms
// P and dS in hi + lo products (BwdMma::regs' kSplitX), and the dK/dV
// launch may split a GQA group's heads over CTAs (BwdParams::head_split,
// bwd_head_split).

constexpr int kPairThreads = 256;  // 8 warps

template <int DH, typename T>
struct BwdPairCfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kStream = 32;        // rows of a streamed tile
  static constexpr int kKc = (DH / 8) % 8 == 0 ? 8 : 10;
  static constexpr int kLd = DH + BwdMma<T>::kPad;
  static constexpr int kStr = kStream * kLd;
  // one exchange of the dQ kernel: 4 row groups x kStream / 8 tiles x 32
  // lanes x 4 floats
  static constexpr int kX = 4 * kStream * 16;
  // dQ: own Q and dO tiles of 64 rows, a warp of each pair half of dQ's
  // columns; K and V stream in 2 stages, one in fp32 at DH 256
  static constexpr int kDqCols = DH / 2;
  static constexpr int kDqStages = kF32 && DH >= 256 ? 1 : 2;
  static constexpr size_t kDqTiles = sizeof(T) * kLd * (2 * kBwdTile + 2 * kDqStages * kStream);
  static constexpr size_t kDqBytes = kDqTiles + sizeof(float) * 2 * kX;
  // dK/dV: own K and V tiles of kKvRows keys in kGroups row groups of
  // kRowWarps warps: kForm of them form S^T (a share of the streamed rows
  // each) and accumulate dV, as many form dP^T and accumulate dK, each over
  // kKvCols columns; 64 keys and pairs up to DH 160, 32 keys and groups of 4
  // at 256 (all 256 columns in halves: 64 accumulators a thread).  Q, dO,
  // lse and D stream in 2 stages.
  static constexpr int kKvRows = DH >= 256 ? 32 : kBwdTile;
  static constexpr int kGroups = kKvRows / 16;
  static constexpr int kRowWarps = 8 / kGroups;
  static constexpr int kForm = kRowWarps / 2;
  static constexpr int kKvCols = DH / kForm;
  static constexpr int kKvStages = 2;
  static constexpr size_t kKvTiles = sizeof(T) * kLd * (2 * kKvRows + 2 * kKvStages * kStream);
  static constexpr size_t kKvFloats = 2 * kKvStages * kStream;  // streamed lse and D
  static constexpr int kKvX = 8 * (kStream / 8 / kForm) * 32 * 4;  // every warp's formed tiles
  static constexpr size_t kKvBytes = kKvTiles + sizeof(float) * (kKvFloats + kKvX);
  static __device__ __forceinline__ int dh(const BwdParams& p) { return DH == 128 ? p.dh : DH; }
  static_assert(DH > 80 && (DH / 8) % kKc == 0 && DH % kForm == 0, "tiling");
  static_assert(kDqTiles % 16 == 0 && kKvTiles % 16 == 0, "the exchanges are float4");
  static_assert(kDqBytes <= 232448 && kKvBytes <= 232448,
                "a block has at most 227 KB of shared memory");
};

// dQ (and D) of one query tile of one head, summed over the KV tiles it
// sees; warp half h accumulates columns [h, h + 1) * kDqCols.
template <int DH, typename T>
__global__ void __launch_bounds__(kPairThreads, 1) flash_bwd_dq_pair_kernel(BwdParams p) {
  using C = BwdPairCfg<DH, T>;
  using M = BwdMma<T>;
  constexpr int kLd = C::kLd, kBK = C::kStream, NT = kBK / 8, NO = C::kDqCols / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int kOwn = kBwdTile * kLd;
  T* tiles = reinterpret_cast<T*>(bwd_smem);
  const T* sQ = tiles;
  const T* sDO = tiles + kOwn;
  T* ring = tiles + 2 * kOwn;
  // [half][row group][tile][lane]: P from half 0, dP from half 1
  float4* sX = reinterpret_cast<float4*>(bwd_smem + C::kDqTiles);
  const int n_q = (p.S + kBwdTile - 1) / kBwdTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBwdTile;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.K), dh = C::dh(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const long long qs = static_cast<long long>(p.H) * dh, ks = static_cast<long long>(p.K) * dh;
  const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * dh;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.K + kvh) * dh;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
  stage_tile<DH, kBwdTile, kPairThreads>(tiles, kLd, static_cast<const T*>(p.q) + q_off, qs, q0,
                                         p.S, dh);
  stage_tile<DH, kBwdTile, kPairThreads>(tiles + kOwn, kLd,
                                         static_cast<const T*>(p.dout) + q_off, qs, q0, p.S, dh);

  int kv_lo, kv_hi;
  kv_range(p, q0, kBwdTile, &kv_lo, &kv_hi);
  const int kt0 = kv_lo / kBK;
  const int items = max(0, (kv_hi + kBK - 1) / kBK - kt0);
  auto stage = [&](int i) {
    T* st = ring + 2 * stage_of<C::kDqStages>(i) * C::kStr;
    const int k0 = (kt0 + i) * kBK;
    stage_tile<DH, kBK, kPairThreads>(st, kLd, static_cast<const T*>(p.k) + kv_off, ks, k0, p.S,
                                      dh);
    stage_tile<DH, kBK, kPairThreads>(st + C::kStr, kLd, static_cast<const T*>(p.v) + kv_off, ks,
                                      k0, p.S, dh);
  };
  if (items > 0) stage(0);
  cp_async_commit();

  // D = rowsum(dO * O) of the row group's 16 rows (both warps of the pair),
  // from device memory while the tiles load: lanes r and r + 16 take the two
  // halves of row r's 16-byte chunks.
  float d = 0.f;
  {
    constexpr int kVec = 16 / sizeof(T);
    const int s = q0 + rg * 16 + (lane & 15);
    if (s < p.S) {
      const int chunks = dh / kVec, hc = chunks / 2;
      const int n = lane < 16 ? hc : chunks - hc;  // hc, but at dh 120 in bf16
      const long long off = q_off + s * qs + (lane >> 4) * hc * kVec;
      const uint4* o4 = reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + off);
      const uint4* d4 = reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + off);
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        float ov[kVec], dv[kVec];
        unpack16(o4[c], ov);
        unpack16(d4[c], dv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) d = fmaf(ov[e], dv[e], d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 16);
    if (half == 0 && lane < 16 && s < p.S) p.delta[row + s] = d;
  }
  // this thread's rows g and g + 8: D, and lse in the log2 domain
  const float d_row[2] = {__shfl_sync(0xffffffffu, d, g), __shfl_sync(0xffffffffu, d, g + 8)};
  const int q_row[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  float lse2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    lse2[rr] = q_row[rr] < p.S ? p.lse[row + q_row[rr]] * kLog2e : 0.f;
  const float scale2 = p.scale * kLog2e;
  const T* own = (half ? sDO : sQ) + rg * 16 * kLd;  // S = Q K^T (half 0), dP = dO V^T (1)

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    next_item<C::kDqStages>(i, items, stage);  // Q, dO and tile i have landed
    const int k0 = (kt0 + i) * kBK;
    const T* sK = ring + 2 * stage_of<C::kDqStages>(i) * C::kStr;
    const T* sV = sK + C::kStr;
    float x[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    M::template rows<DH, NT, false, C::kKc>(x, own, half ? sV : sK, kLd);
    if (half == 0) {  // P
      const bool full = tile_visible(p, q0, kBwdTile, k0, kBK);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1, kj = k0 + j * 8 + 2 * t + (e & 1);
          x[j][e] = full || visible(p, q_row[rr], kj) ? exp2f(fmaf(x[j][e], scale2, -lse2[rr]))
                                                      : 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      sX[((half * 4 + rg) * NT + j) * 32 + lane] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 y4 = sX[(((1 - half) * 4 + rg) * NT + j) * 32 + lane];
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = half ? y[e] : x[j][e], dp = half ? x[j][e] : y[e];
        x[j][e] = pr * (dp - d_row[e >> 1]);  // dS
      }
    }
    M::template regs<C::kDqCols, NT, false, true>(dq, x, sK + half * C::kDqCols, kLd);
    __syncthreads();  // this stage and the exchanges are refilled for a later tile
  }
  cp_async_wait<0>();

  T* dqb = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (q_row[rr] >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = half * C::kDqCols + n * 8 + 2 * t;  // dh % 8 == 0: c < dh covers c + 1
      if (DH != 128 || c < dh)
        store2(dqb + q_row[rr] * qs + c, dq[n][2 * rr] * p.scale, dq[n][2 * rr + 1] * p.scale);
    }
  }
}

// dK and dV of one tile of kKvRows keys of one KV head, summed over the
// query heads of its group (or its share of them: head_split) and the query
// tiles that see it.
template <int DH, typename T>
__global__ void __launch_bounds__(kPairThreads, 1) flash_bwd_dkdv_pair_kernel(BwdParams p) {
  using C = BwdPairCfg<DH, T>;
  using M = BwdMma<T>;
  constexpr int kLd = C::kLd, kBQ = C::kStream, NT = kBQ / 8, NO = C::kKvCols / 8;
  constexpr int NF = NT / C::kForm;  // the streamed row tiles a warp forms
  constexpr int kOwn = C::kKvRows * kLd;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* tiles = reinterpret_cast<T*>(bwd_smem);
  float* rows = reinterpret_cast<float*>(bwd_smem + C::kKvTiles);
  // [row group][warp of the group][tile][lane]: S^T's share turned into
  // P^T, and dP^T's
  float4* sX = reinterpret_cast<float4*>(rows + C::kKvFloats);
  const T* sK = tiles;
  const T* sV = tiles + kOwn;
  T* ring = tiles + 2 * kOwn;
  const int k0 = blockIdx.x * C::kKvRows, b = blockIdx.z;
  const int HS = p.head_split, kvh = blockIdx.y / HS, hs = blockIdx.y % HS;
  const int G = p.H / p.K / HS, h0 = (kvh * HS + hs) * G, dh = C::dh(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp % C::kGroups, r = warp / C::kGroups;  // row group, warp in it
  const bool dk = r >= C::kForm;  // forms dP^T and accumulates dK (else S^T, dV)
  const int part = dk ? r - C::kForm : r;  // its streamed rows and its columns
  const long long qs = static_cast<long long>(p.H) * dh, ks = static_cast<long long>(p.K) * dh;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.K + kvh) * dh;
  stage_tile<DH, C::kKvRows, kPairThreads>(tiles, kLd, static_cast<const T*>(p.k) + kv_off, ks,
                                           k0, p.S, dh);
  stage_tile<DH, C::kKvRows, kPairThreads>(tiles + kOwn, kLd,
                                           static_cast<const T*>(p.v) + kv_off, ks, k0, p.S, dh);

  int q_lo, q_hi;
  q_range(p, k0, C::kKvRows, &q_lo, &q_hi);
  const int qt0 = q_lo / kBQ;
  const int n_qt = max(0, (q_hi + kBQ - 1) / kBQ - qt0);
  const int items = G * n_qt;  // item i: head h0 + i / n_qt, query tile qt0 + i % n_qt
  auto stage = [&](int i) {
    const int h = h0 + i / n_qt, q0 = (qt0 + i % n_qt) * kBQ;
    T* st = ring + 2 * stage_of<C::kKvStages>(i) * C::kStr;
    const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * dh;
    stage_tile<DH, kBQ, kPairThreads>(st, kLd, static_cast<const T*>(p.q) + q_off, qs, q0, p.S,
                                      dh);
    stage_tile<DH, kBQ, kPairThreads>(st + C::kStr, kLd, static_cast<const T*>(p.dout) + q_off,
                                      qs, q0, p.S, dh);
    const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
    float* sr = rows + stage_of<C::kKvStages>(i) * 2 * kBQ;
    stage_floats<kBQ, kPairThreads>(sr, p.lse + row, q0, p.S);
    stage_floats<kBQ, kPairThreads>(sr + kBQ, p.delta + row, q0, p.S);
  };
  if (items > 0) stage(0);
  cp_async_commit();

  const int k_row[2] = {k0 + rg * 16 + g, k0 + rg * 16 + g + 8};
  const float scale2 = p.scale * kLog2e;
  const T* own = (dk ? sV : sK) + rg * 16 * kLd;  // S^T = K Q^T, dP^T = V dO^T
  float acc[NO][4];                               // dK or dV
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    next_item<C::kKvStages>(i, items, stage);  // K, V and item i have landed
    const int q0 = (qt0 + i % n_qt) * kBQ;
    const T* sQ = ring + 2 * stage_of<C::kKvStages>(i) * C::kStr;
    const T* sDO = sQ + C::kStr;
    const float* sLse = rows + stage_of<C::kKvStages>(i) * 2 * kBQ;
    const float* sD = sLse + kBQ;
    float x[NF][4];  // the row group's 16 keys x this warp's NF * 8 queries
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    M::template rows<DH, NF, false, C::kKc>(x, own, (dk ? sDO : sQ) + part * NF * 8 * kLd, kLd);
    if (!dk) {  // P^T
      const bool full = tile_visible(p, q0, kBQ, k0, C::kKvRows);
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = (part * NF + j) * 8 + 2 * t + (e & 1);
          x[j][e] = full || visible(p, q0 + qc, k_row[e >> 1])
                        ? exp2f(fmaf(x[j][e], scale2, -sLse[qc] * kLog2e))
                        : 0.f;
        }
    }
    if constexpr (C::kForm == 1) {
      // a pair: the dV warp passes P^T and keeps it, the dK warp forms dS^T
      // in place
      if (!dk) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          sX[(rg * 2 * NT + j) * 32 + lane] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      }
      __syncthreads();
      if (dk) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 p4 = sX[(rg * 2 * NT + j) * 32 + lane];
          const float pt[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) x[j][e] = pt[e] * (x[j][e] - sD[j * 8 + 2 * t + (e & 1)]);
        }
      }
      M::template regs<C::kKvCols, NT, false, true>(acc, x, dk ? sQ : sDO, kLd);
    } else {
#pragma unroll
      for (int j = 0; j < NF; ++j)
        sX[((rg * C::kRowWarps + r) * NF + j) * 32 + lane] =
            make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      __syncthreads();
      float y[NT][4];  // P^T, or dS^T = P^T (dP^T - D), over the streamed tile
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int w = rg * C::kRowWarps + j / NF;  // the warp that formed its S^T
        const float4 p4 = sX[(w * NF + j % NF) * 32 + lane];
        const float4 d4 = sX[((w + C::kForm) * NF + j % NF) * 32 + lane];
        const float pt[4] = {p4.x, p4.y, p4.z, p4.w}, dpt[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[j][e] = dk ? pt[e] * (dpt[e] - sD[j * 8 + 2 * t + (e & 1)]) : pt[e];
      }
      M::template regs<C::kKvCols, NT, false, true>(acc, y,
                                                    (dk ? sQ : sDO) + part * C::kKvCols, kLd);
    }
    __syncthreads();  // this stage and the exchange are refilled for a later item
  }
  cp_async_wait<0>();

  const long long n_kv = static_cast<long long>(p.B) * p.S * p.K * dh;
  T* out = static_cast<T*>(dk ? p.dk : p.dv) + kv_off;
  // partial (2, HS, B, S, K, dh): dK's sums first, then dV's (used when HS > 1)
  float* sums = p.partial + ((dk ? 0 : HS) + hs) * n_kv + kv_off;
  const float sc = dk ? p.scale : 1.f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (k_row[rr] >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = part * C::kKvCols + n * 8 + 2 * t;
      if (DH == 128 && c >= dh) continue;
      const long long off = k_row[rr] * ks + c;
      if (HS > 1)
        store2(sums + off, acc[n][2 * rr], acc[n][2 * rr + 1]);
      else
        store2(out + off, acc[n][2 * rr] * sc, acc[n][2 * rr + 1] * sc);
    }
  }
}

// ---------------------------------------------------------------------------
// forward, mma_tf32x3: fp32 on the TF32 tensor cores (3xTF32)
// ---------------------------------------------------------------------------
//
// FlashAttention-2's forward on mma.sync m16n8k8 TF32, with the backward's
// products (BwdMma<float>, truncating splits): a CTA owns a 64-row query
// tile (late tiles first, the longest under a causal mask) in 4 row groups
// of 16; K and V stream through a 2-stage cp.async ring of 32- or 64-key
// tiles (Tf32Cfg).  S = Q K^T (rows) and O += P V (regs, with P, the
// exponentiated score accumulators, in registers as X) are each three TF32
// products from hi + lo splits, which holds fp32's 2e-5
// (ref.py:mha_fwd_by_products); the online softmax runs in fp32 registers
// in the log2 domain, a row's four lanes reducing by shuffles; O is
// rescaled in registers and each tile's P V summed in a fresh accumulator
// (the tensor cores truncate their accumulation).  The masks, GQA and the
// row log-sum-exp are the other bodies'.
//
// Up to head dim 128 (120 padded to 128) a CTA has 4 warps, one to each row
// group, each holding all of O's DHP / 2 accumulators a thread (239
// registers at 128, no spill).  At 160 and 256 that spilled (255 registers
// at 160), so there a CTA has 8 warps, two to each row group: each warp of
// a pair forms S for half of the tile's 32 keys over the whole head dim,
// the halves meet in shared memory (8 KB), both warps run the same online
// softmax on the full row (so their m and l are the same bits) and each
// accumulates P V into its half of O's columns: 64 accumulators a thread
// at 256, 40 at 160.  S sums each 64-column run (80 at 160) of its
// reduction in a fresh accumulator (Tf32Cfg::kKc), as the backward does:
// summed in one, the tensor cores' truncating accumulation over 256
// columns biased S (o at 0.23 of the fp32 tolerance, lse 0.12), and the
// backward fed with that o and lse left dV at 1.16 of the tolerance at
// recurrentgemma-9b's train shape; chunked, o 0.12, lse 0.04, dV 0.47,
// under the FMA body's o and lse (0.62), and no slower (NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md).  Shared memory at 256: Q 66.6 KB, K and V at
// 32-key tiles in 2 stages 133 KB, the exchange 8 KB: 208 KB, one CTA (8
// warps) an SM; 64-key tiles would take 266.
//
// What bounds it at the 100m training shape (q (16,256,8,64), k/v
// (16,256,4,64) fp32, causal): bytes, q, k, v, o and lse moved once, 7.5 us
// at 3.35 TB/s, just above its operations, the two products of 32896 pairs
// x 64 a head, each three TF32 products (6.5 us at 494.7 TFLOP/s).
// Measured, latency: a warp's split -> mma -> softmax chain, with 8 warps
// an SM, left the tensor cores idle most of the time; truncating splits
// and the log2 domain took 0.0685 to 0.0603 ms, a third CTA an SM to
// 0.0516 (kernels/ab.py --forward, PERF.md).  At recurrentgemma-9b's
// (q (4,512,16,256), k/v (4,512,1,256), window 2048): operations, 0.0522
// ms at the TF32 rate, against 0.0125 ms of bytes.

// The tiling at head dim DHP: the warps to each 16-row group (kPair), keys
// a K/V tile (kBK; two stages of K and V in a cp.async ring, the next tile
// loading while this one computes) and the CTAs an SM the registers are
// held to (kMinBlocks).  Up to dh 80, 32-key tiles (52 KB of shared memory
// at dh 64) and at most 170 registers let three CTAs share an SM: 0.0516
// ms at the 100m shape against 0.0603 with 64-key tiles and two CTAs an SM
// (NVIDIA H100 80GB HBM3, 700.00 W; kernels/ab.py --forward, PERF.md); a
// fourth CTA (128 registers) gained nothing.
template <int DHP>
struct Tf32Cfg {
  static constexpr int kPair = DHP > 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kPair;
  static constexpr int kBK = DHP <= 80 || DHP > 128 ? 32 : 64;
  static constexpr int kMinBlocks = DHP <= 80 ? 3 : 1;
  static constexpr int kCols = DHP / kPair;  // O's columns a warp accumulates
  // S's reduction steps (8 columns each) a fresh accumulator: all up to
  // 128, 64 columns (80 at 160) above, as the backward sums (BwdCfg::kKc)
  static constexpr int kKc = DHP <= 128 ? DHP / 8 : (DHP / 8) % 8 == 0 ? 8 : 10;
  static constexpr int kLd = DHP + BwdMma<float>::kPad;  // row stride, floats
  // the score exchange of a pair: 4 row groups x kBK / 8 tiles x 32 lanes x 4
  static constexpr int kX = kPair == 2 ? 4 * kBK * 16 : 0;
  static constexpr size_t kBytes = sizeof(float) * (kLd * (kBwdTile + 4 * kBK) + kX);
  static_assert(kBytes <= 232448, "a block has at most 227 KB of shared memory");
};

// Rows [s0, s0 + R) of one head (row stride ld_g floats) into a tile of
// DHP columns and row stride ld by cp.async, 16 bytes a copy where the
// head's rows are 16-byte aligned (vec), else 4; rows at or past S and
// columns at or past dh (a multiple of 8) are zero.  kN threads copy.
template <int DHP, int R, int kN = kThreads>
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, const float* src,
                                               long long ld_g, int s0, int S, int dh, bool vec) {
  constexpr int kChunks = DHP / 4;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kN) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4, s = s0 + r;
    const bool in = s < S && c < dh;
    const float* from = in ? src + static_cast<long long>(s) * ld_g + c : src;
    if (vec) {
      cp_async16(dst + r * ld + c, from, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + r * ld + c + e, in ? from + e : src, in);
    }
  }
}

__device__ __forceinline__ bool rows_aligned16(const float* base, long long seq_stride) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && seq_stride % 4 == 0;
}

template <int DHP>
__global__ void __launch_bounds__(Tf32Cfg<DHP>::kThreads, Tf32Cfg<DHP>::kMinBlocks)
    flash_attn_tf32_kernel(Params p) {
  using C = Tf32Cfg<DHP>;
  using M = BwdMma<float>;
  constexpr int kLd = C::kLd, BK = C::kBK, NT = BK / 8, NO = C::kCols / 8;
  constexpr int NH = NT / C::kPair;  // the score tiles a warp forms
  constexpr int kKV = BK * kLd;      // floats of a K or V buffer
  extern __shared__ __align__(16) float tf32_smem[];
  const float* sQ = tf32_smem;
  float* kv = tf32_smem + kBwdTile * kLd;  // stage i % 2: K, then V
  // [row group][score tile][lane] (kPair 2)
  float4* sX = reinterpret_cast<float4*>(kv + 4 * kKV);
  const int n_q = (p.S + kBwdTile - 1) / kBwdTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBwdTile;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;  // row group, and which of its pair
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const bool k_vec = rows_aligned16(kb, p.k_ss), v_vec = rows_aligned16(vb, p.v_ss);
  stage_rows_f32<DHP, kBwdTile, C::kThreads>(tf32_smem, kLd, qb, p.q_ss, q0, p.S, p.dh,
                                             rows_aligned16(qb, p.q_ss));

  int kv_lo, kv_hi;
  kv_range(p, q0, kBwdTile, &kv_lo, &kv_hi);
  const int kt0 = kv_lo / BK;
  const int items = max(0, (kv_hi + BK - 1) / BK - kt0);
  auto stage = [&](int i) {
    float* st = kv + (i & 1) * 2 * kKV;
    const int k0 = (kt0 + i) * BK;
    stage_rows_f32<DHP, BK, C::kThreads>(st, kLd, kb, p.k_ss, k0, p.S, p.dh, k_vec);
    stage_rows_f32<DHP, BK, C::kThreads>(st + kKV, kLd, vb, p.v_ss, k0, p.S, p.dh, v_vec);
  };
  // every query of the tile sees every key of [k0, k0 + BK)
  auto full_tile = [&](int k0) {
    const int q1 = q0 + kBwdTile - 1, k1 = k0 + BK - 1;
    return q1 < p.S && k1 < p.S && (!p.causal || k1 <= q0) &&
           (!p.window || q1 - k0 < p.window) &&
           (!p.chunk || (q0 / p.chunk == k1 / p.chunk && k0 / p.chunk == q1 / p.chunk));
  };
  if (items > 0) stage(0);
  cp_async_commit();

  const int qrow[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  const float scale2 = p.scale * kLog2e;  // the softmax runs in the log2 domain
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) stage(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile i have landed
    __syncthreads();
    const int k0 = (kt0 + i) * BK;
    const float* sK = kv + (i & 1) * 2 * kKV;
    const float* sV = sK + kKV;
    float s[NT][4];
    if constexpr (C::kPair == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      M::template rows<DHP, NT, true, C::kKc>(s, sQ + rg * 16 * kLd, sK, kLd);
    } else {
      // this warp's half of the keys; both halves through shared memory
      float sh[NH][4];
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sh[j][e] = 0.f;
      M::template rows<DHP, NH, true, C::kKc>(sh, sQ + rg * 16 * kLd,
                                                   sK + half * NH * 8 * kLd, kLd);
#pragma unroll
      for (int j = 0; j < NH; ++j)
        sX[(rg * NT + half * NH + j) * 32 + lane] = make_float4(sh[j][0], sh[j][1], sh[j][2],
                                                                sh[j][3]);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 x = sX[(rg * NT + j) * 32 + lane];
        s[j][0] = x.x, s[j][1] = x.y, s[j][2] = x.z, s[j][3] = x.w;
      }
    }
    const bool full = full_tile(k0);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float sr[2 * NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + j * 8 + 2 * t + e;
          const float v = s[j][2 * rr + e] * scale2;
          sr[2 * j + e] = full || visible(p, qrow[rr], kj) ? v : -INFINITY;
        }
      const float alpha = softmax_step<2 * NT, 4, true>(sr, m[rr], l[rr]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) s[j][2 * rr + e] = sr[2 * j + e];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * rr] *= alpha;
        o[n][2 * rr + 1] *= alpha;
      }
    }
    M::template regs<C::kCols, NT, true>(o, s, sV + half * C::kCols, kLd);
    __syncthreads();  // this stage (and the exchange) is refilled for a later tile
  }
  cp_async_wait<0>();

  const int dh = p.dh;
  float* ob = static_cast<float*>(p.o) + (static_cast<long long>(b) * p.S * p.H + h) * dh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qrow[rr] >= p.S) continue;
    if (p.lse != nullptr && t == 0 && half == 0)
      write_lse(p, b, h, qrow[rr], m[rr] * kLn2, l[rr]);
    const float inv_l = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    float* orow = ob + static_cast<long long>(qrow[rr]) * p.H * dh;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = half * C::kCols + n * 8 + 2 * t;  // dh is a multiple of 8: c < dh covers c + 1
      if (c < dh) store2(orow + c, o[n][2 * rr] * inv_l, o[n][2 * rr + 1] * inv_l);
    }
  }
}

// ---------------------------------------------------------------------------
// sm90: TMA + mbarrier ring, warp-specialised, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// seconds is a fault of the pipeline: trap (the launch then fails) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 2000000000ull)
      __trap();
  }
}

// One TMA tile of a 4-D tensor map into shared memory; completion is counted
// on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all in 16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// A K-major operand: rows of 64 bf16 (128 bytes, one swizzle row), 8-row
// groups 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return gmma_desc(addr, 16, 1024);
}

// An MN-major operand (V as B of P V): each k row (key) holds 64 bf16 of the
// N (head-dim) axis in 128 bytes; 8-key groups are 1024 bytes apart (stride
// offset) and the next 64 columns lie one slab further (leading offset).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t slab_bytes) {
  return gmma_desc(addr, slab_bytes, 1024);
}

#define WG_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128, fp32) += A (64 x 16) * B (16 x 128); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16) * B (16 x 64); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) * B (16 x 128); B
// MN-major in shared memory (the transpose flag).
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, fp32) += A (64 x 16, bf16 in registers) * B (16 x 80); B
// MN-major in shared memory: columns 0-63 in one 128-byte swizzled slab,
// 64-79 at the start of the next (the leading offset apart).
__device__ __forceinline__ void wgmma_rs_n80_mn(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 160, fp32) += A (64 x 16, bf16 in registers) * B (16 x 160); B
// MN-major in shared memory: columns 0-63 and 64-127 in two 128-byte
// swizzled slabs, 128-159 at the start of a third (the leading offset apart).
__device__ __forceinline__ void wgmma_rs_n160_mn(float (&d)[80], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56),
        WG_D8(64), WG_D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D8

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_ss_n128(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_ss_n64(d, da, db);
}

// O += P V over one 16-key step, N = the O columns a warpgroup owns (and
// the backward's sums at N = DH: wgmma_regs).
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128_mn(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<80>(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n80_mn(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<160>(float (&d)[80], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n160_mn(d, a, db);
}

// Tile geometry and shared-memory layout (bytes) of the sm90 body, compiled
// for head dim DH (80, 128, 160 or 256).  A row of Q, K, V or O is held as
// 64-column (128-byte) slabs; the tensor maps' extent is the real head dim,
// so TMA zero-fills the columns past it and clips O's store there (dh 80:
// columns 80-127 of the second slab; dh 120, on the DH 128 body: 120-127;
// dh 160: 160-191 of the third).
//
// dh 128: each consumer warpgroup owns 64 query rows and all of O's 128
// columns (64 accumulator registers a thread), so a query tile is 128 rows.
// dh 80: the same tiles, Q K^T over the 5 k16 steps that hold the 80
// columns and P V at N 80 (40 accumulator registers a thread): no product
// touches the zero-filled columns.
// dh 160: the same 128-row tiles, each warpgroup owning 64 rows and all of
// O's 160 columns (80 registers a thread), with 64-key tiles (kBK): S is
// then 32 registers and P 16, where 128 keys (64 and 32) beside O's 80
// would not fit the 168 ptxas allots.  Q K^T runs over the 10 k16 steps
// that hold the 160 columns and P V at N 160, reading V MN-major across
// two and a half slabs, so no product touches columns 160-191.  Shared
// memory: Q 48 KB, two stages of K and V at 24 KB each, O 48 KB.
// dh 256 (kSplitO): O's 256 columns would be 128 registers a thread, so
// both warpgroups take the same 64 rows and each owns 128 of O's columns;
// each computes the rows' scores and softmax itself (the same numbers),
// which costs a second Q K^T but keeps every register in place.
template <int DH>
struct Sm90 {
  static constexpr bool kSplitO = DH == 256;
  static constexpr int kBQ = kSplitO ? 64 : 128;    // query rows of a tile
  static constexpr int kWGRows = kSplitO ? 0 : 64;  // row offset of warpgroup 1
  static constexpr int kOCols = kSplitO ? 128 : DH; // O columns a warpgroup owns
  // keys of a K / V tile: 64 where a warpgroup holds more than 128 columns
  // of O (dh 160) or shares its rows (dh 256)
  static constexpr int kBK = DH > 128 ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr int kKSteps = DH / 16;            // k16 steps of Q K^T
  static constexpr int kSlabs = (DH + 63) / 64;      // 64-column (128-byte) slabs of a row
  static constexpr int kOSlabs = (kOCols + 63) / 64; // slabs of the O a warpgroup owns
  static constexpr int kQSlab = kBQ * 128;    // bytes of one slab of the Q tile
  static constexpr int kKVSlab = kBK * 128;   // bytes of one slab of a K or V tile
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKVBytes = kSlabs * kKVSlab;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                // kStages K tiles
  static constexpr int kV = kK + kStages * kKVBytes;     // kStages V tiles
  static constexpr int kO = kV + kStages * kKVBytes;     // O, bf16, as Q's tile
  static constexpr int kBar = kO + kQBytes;              // Q full / empty, K, V, empty
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;  // + alignment
  // Consumer warpgroups 0 and 1, and one producer warp.  ptxas allots 168
  // registers a thread to this kernel (an SM sub-partition holds 3 of its
  // 9 warps in 16384 registers).  It allotted the same to a whole producer
  // warpgroup (384 threads), with or without setmaxnreg moving registers
  // from the producer to the consumers, so one warp loads.
  static constexpr int kThreads = 288;
  static_assert(DH == 80 || DH == 128 || DH == 160 || DH == 256,
                "sm90 body: dh 80, 128, 160 or 256");
  static_assert(kBytes <= 232448, "sm90 body: over the 227 KB a block may use");
};

enum TileClass { kHidden = 0, kEdge = 1, kVisible = 2 };

// How the mask meets the tile of rows [r0, r0 + br) x keys [k0, k0 + bk):
// wholly hidden (no row sees a key), wholly visible (every row before S sees
// every key, and no key lies past S), or an edge tile.  Rows past S are
// never stored, so they do not make a tile an edge tile.  P is Params or
// BwdParams.
template <typename P>
__device__ __forceinline__ TileClass tile_class(const P& p, int r0, int br, int k0, int bk) {
  const int r1 = r0 + br - 1, k1 = k0 + bk - 1;
  if (r0 >= p.S || k0 >= p.S) return kHidden;
  const int rl = min(r1, p.S - 1), kl = min(k1, p.S - 1);
  if (p.causal && k0 > rl) return kHidden;
  if (p.window && r0 - kl >= p.window) return kHidden;
  if (p.chunk && (kl / p.chunk < r0 / p.chunk || k0 / p.chunk > rl / p.chunk)) return kHidden;
  bool all = k1 < p.S;
  if (p.causal) all = all && k1 <= r0;
  if (p.window) all = all && r1 - k0 < p.window;
  if (p.chunk)
    all = all && k0 / p.chunk == k1 / p.chunk && r0 / p.chunk == r1 / p.chunk &&
          k0 / p.chunk == r0 / p.chunk;
  return all ? kVisible : kEdge;
}

// The keys [*lo, *hi] that query row qi sees: every mask of Params leaves
// one contiguous run of keys (none, lo > hi, for a row at or past S).  Equal
// to visible(p, qi, kj) for 0 <= kj, so an edge tile costs two compares an
// element and no division.
template <typename P>
__device__ __forceinline__ void row_keys(const P& p, int qi, int* lo, int* hi) {
  *lo = 0;
  *hi = p.S - 1;
  if (qi >= p.S) {
    *lo = 1;
    *hi = 0;
    return;
  }
  if (p.causal) *hi = min(*hi, qi);
  if (p.window) *lo = max(*lo, qi - p.window + 1);
  if (p.chunk) {
    const int c0 = (qi / p.chunk) * p.chunk;
    *lo = max(*lo, c0);
    *hi = min(*hi, c0 + p.chunk - 1);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Barrier `id` over `threads` threads (a multiple of 32); id 0 is __syncthreads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One TMA tile from shared memory into a 4-D tensor map (clipped at its
// bounds), as a bulk group of the issuing thread.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One query tile of the grid-stride walk.  Under a causal mask tiles are
// numbered latest query tile first (they see the most keys), then by (b,
// h).  Without one every tile sees the same keys, and they are numbered
// head-major, (b, h) first: the CTAs in flight then share one head's K and
// V in L2 (hubert-xlarge's encode, 16 heads of 32768 keys, reads 10.5 MB of
// K and V a head against a 50 MB L2).
struct Sm90Tile {
  int q0, h, b, kvh, kt0, kt1;
};

template <int DH>
__device__ __forceinline__ Sm90Tile sm90_tile(const Params& p, int tile) {
  using C = Sm90<DH>;
  const int n_qt = (p.S + C::kBQ - 1) / C::kBQ;
  const int bh = p.causal ? tile % (p.B * p.H) : tile / n_qt;
  const int qt = p.causal ? n_qt - 1 - tile / (p.B * p.H) : tile % n_qt;
  Sm90Tile t;
  t.q0 = qt * C::kBQ;
  t.h = bh % p.H;
  t.b = bh / p.H;
  t.kvh = t.h / (p.H / p.K);
  int lo, hi;
  kv_range(p, t.q0, C::kBQ, &lo, &hi);
  t.kt0 = lo / C::kBK;
  t.kt1 = (hi + C::kBK - 1) / C::kBK;
  return t;
}

// Persistent: gridDim.x CTAs (at most one an SM) walk the query tiles, so
// the producer loads the next tile's Q and K/V while the consumers finish
// this tile's softmax, P V and epilogue.
template <int DH>
__global__ void __launch_bounds__(Sm90<DH>::kThreads, 1)
    flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using C = Sm90<DH>;
  constexpr int BK = C::kBK;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_sm90[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t raw = smem_u32(smem_sm90);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + C::kQ, sK = base + C::kK, sV = base + C::kV, sO = base + C::kO;
  const uint32_t bar_q_full = base + C::kBar;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full_k = bar_q_empty + 8;             // + 8 * stage
  const uint32_t bar_full_v = bar_full_k + 8 * kStages;
  const uint32_t bar_empty = bar_full_v + 8 * kStages;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warp: one thread issues every load of the CTA
    if (threadIdx.x == 256) {
      int it = 0;  // K/V tiles loaded, over all of this CTA's query tiles
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Sm90Tile t = sm90_tile<DH>(p, tile);
        const int n = (tile - blockIdx.x) / gridDim.x;  // this CTA's tiles before it
        if (n > 0) mbar_wait(bar_q_empty, (n - 1) & 1);  // the last tile's Q K^T is done
        mbar_expect_tx(bar_q_full, C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kSlabs; ++c)
          tma_load_4d(sQ + c * C::kQSlab, &tm_q, bar_q_full, c * 64, t.h, t.q0, t.b);
        for (int kt = t.kt0; kt < t.kt1; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(bar_empty + 8 * s, ((it / kStages) - 1) & 1);
          const uint32_t fk = bar_full_k + 8 * s, fv = bar_full_v + 8 * s;
          mbar_expect_tx(fk, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kSlabs; ++c)
            tma_load_4d(sK + s * C::kKVBytes + c * C::kKVSlab, &tm_k, fk, c * 64, t.kvh,
                        kt * BK, t.b);
          mbar_expect_tx(fv, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kSlabs; ++c)
            tma_load_4d(sV + s * C::kKVBytes + c * C::kKVSlab, &tm_v, fv, c * 64, t.kvh,
                        kt * BK, t.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [r0, r0 + 64) of each
    // tile and O's columns [64 o_slab, 64 o_slab + kOCols)
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    constexpr int kOCols = C::kOCols;
    const int o_slab = C::kSplitO ? 2 * wg : 0;  // first 64-column slab of this O
    const uint32_t q_wg = sQ + C::kWGRows * wg * 128;  // this warpgroup's rows of each slab
    const uint32_t o_wg = sO + C::kWGRows * wg * 128;
    const float sl2 = p.scale * 1.4426950408889634f;  // exp(x scale) = 2^(x sl2); scale > 0
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Sm90Tile tl = sm90_tile<DH>(p, tile);
      const int n = (tile - blockIdx.x) / gridDim.x;
      const int r0 = tl.q0 + C::kWGRows * wg;
      float o[kOCols / 2];
#pragma unroll
      for (int i = 0; i < kOCols / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      mbar_wait(bar_q_full, n & 1);
      for (int kt = tl.kt0; kt < tl.kt1; ++kt, ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = kt * BK;
        const TileClass cls = tile_class(p, r0, 64, k0, BK);
        mbar_wait(bar_full_k + 8 * s, ph);
        // S = Q K^T (64 x BK, fp32), one 16-wide k-step of the head dim at a
        // time (kKSteps: the steps that hold the head dim).  The descriptors
        // are rebuilt from opaque bases every tile: hoisted out of the loop,
        // the 2 x kKSteps of them would hold registers that O needs.
        if (cls != kHidden) {
          float sacc[BK / 2];
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) sacc[j] = 0.f;
          uint32_t qa = q_wg, ka = sK + s * C::kKVBytes;
          asm volatile("" : "+r"(qa), "+r"(ka));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::kKSteps; ++kk) {
            const uint32_t off = (kk % 4) * 32;
            wgmma_qk<BK>(sacc, desc_k_major(qa + (kk / 4) * C::kQSlab + off),
                         desc_k_major(ka + (kk / 4) * C::kKVSlab + off));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
          if (kt + 1 == tl.kt1) {  // this warp reads Q no more: the next tile's may load
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_q_empty);
          }

          // Online softmax in the log2 domain, on the raw scores (sl2 > 0,
          // so their max is the max of the scaled ones): p = 2^(s sl2 - m sl2).
          // Entry 4j + 2rr + e of the accumulator is row g + 8rr, key
          // 8j + 2t + e of the tile.
          if (cls == kEdge) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              // this thread's row 16 warp + g + 8 rr sees keys [lo, hi] of the tile, less 2t
              int lo, hi;
              row_keys(p, r0 + 16 * warp + g + 8 * rr, &lo, &hi);
              lo -= k0 + 2 * t;
              hi -= k0 + 2 * t;
#pragma unroll
              for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  if (8 * j + e < lo || 8 * j + e > hi) sacc[4 * j + 2 * rr + e] = -INFINITY;
            }
          }
          float alpha[2];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
              mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * rr], sacc[4 * j + 2 * rr + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[rr], mx);
            // A row that has seen no key yet: 2^(-inf - 0) keeps p and alpha 0.
            const float m_use = m_new == -INFINITY ? 0.f : m_new * sl2;
            alpha[rr] = ex2(m[rr] * sl2 - m_use);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = sacc[4 * j + 2 * rr + e];
                x = ex2(fmaf(x, sl2, -m_use));
                rs += x;
              }
            l[rr] = l[rr] * alpha[rr] + rs;  // this lane's columns; summed at the end
            m[rr] = m_new;
          }
#pragma unroll
          for (int j = 0; j < kOCols / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];

          // P as the register A operand of P V: k-step kk covers keys
          // [16kk, 16kk + 16), i.e. accumulator chunks 2kk and 2kk + 1.
          uint32_t pa[BK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);

          // O += P V
          mbar_wait(bar_full_v + 8 * s, ph);
          const uint32_t v_tile = sV + s * C::kKVBytes;
          fence_regs(o);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_pv<kOCols>(
                o, pa[kk],
                desc_mn_major(v_tile + o_slab * C::kKVSlab + kk * 16 * 128, C::kKVSlab));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
        } else {
          if (kt + 1 == tl.kt1) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_q_empty);
          }
          mbar_wait(bar_full_v + 8 * s, ph);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      }

      // O / l in bf16, staged with the 128-byte swizzle in the O buffer
      // (this warpgroup's rows and slabs), then stored by TMA one slab at a
      // time into (B, S, H, dh), without waiting; TMA clips the rows past S.
      float inv_l[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float lt = l[rr];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        inv_l[rr] = lt > 0.f ? 1.f / lt : 0.f;
        // The row's log-sum-exp of its scaled scores, the mma body's
        // convention (write_lse): l sums 2^((s - m) sl2) = e^((s - m) scale)
        // over raw scores s, so lse = m scale + ln l.  One lane of the quad
        // writes it; at dh 256 both warpgroups hold the same rows, and
        // warpgroup 0 writes them.  Rows past S are skipped: TMA zero-filled
        // them, and nothing clips this store.  (ptxas holds this kernel at
        // 168 registers, with none to spare at dh 128: the tile count comes
        // from the parameters, Params::tiles, so that this fits unspilled.)
        const int qi = r0 + 16 * warp + g + 8 * rr;
        if (p.lse && t == 0 && qi < p.S && (!C::kSplitO || wg == 0))
          p.lse[(static_cast<long long>(tl.b) * p.H + tl.h) * p.S + qi] =
              lt > 0.f ? fmaf(m[rr], p.scale, logf(lt)) : INFINITY;
      }
      if (threadIdx.x % 128 == 0)  // the last tile's store has read the buffer
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_bar_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < kOCols / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = 16 * warp + g + 8 * rr;  // r % 8 == g
          const uint32_t addr = o_wg + (o_slab + j / 8) * C::kQSlab + r * 128 +
                                (((j % 8) ^ g) * 16) + 4 * t;
          st_shared_u32(addr, pack_bf16(o[4 * j + 2 * rr] * inv_l[rr],
                                        o[4 * j + 2 * rr + 1] * inv_l[rr]));
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar_sync(2 + wg, 128);
      if (threadIdx.x % 128 == 0 && r0 < p.S) {
#pragma unroll
        for (int c = o_slab; c < o_slab + C::kOSlabs; ++c)
          tma_store_4d(&tm_o, o_wg + c * C::kQSlab, c * 64, tl.h, r0, tl.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// backward, sm90: bf16 at dh 80, 120, 128, 160 and 256 on wgmma and TMA, warp-specialised
// ---------------------------------------------------------------------------
//
// The gradient of the forward above (FlashAttention-2's backward, without
// atomics, as flash_attention_bwd computes it) for bf16, compiled for head
// dim DH (Sm90Bwd<DH>): 128, with dh 120 on the same instance (the tensor
// maps' extent is the real head dim, so TMA zero-fills the columns past 120,
// which add nothing to a product, and clips the stores there), and 80.  At
// DH 80 the tiles keep their two 64-column slabs, as the forward's Sm90<80>
// does: TMA zero-fills columns 80-127 of the second, S and dP run over the
// 5 k16 steps that hold the 80 columns, and dQ, dK and dV accumulate at N
// 80 (40 fp32 registers a thread where DH 128 holds 64), so no product
// reads the zero-filled columns.  The train paths' shapes: qwen2-vl-2b's
// step, q (4,1024,12,128), k/v (4,1024,2,128), causal: five products of
// its 524800 visible pairs x 128 a head are 0.0326 ms at the bf16 rate, the
// seven this body forms 0.0456; stablelm-3b's, q, k, v (4,1024,32,80),
// causal: five products of 524800 pairs x 80 over 128 heads 0.0543 ms, the
// seven 0.0761.
//
// DH 160 and 256 (kHalves 2: recurrentgemma-9b's step at 256, MQA 16 : 1
// with a window of 2048; stablelm-12b's at 160, GQA 32 : 8): a 64 x DH fp32
// sum is 80 or 128 registers a thread, and a warpgroup also holds S and dP
// (32 each) and dS's hi + lo (32): over the 168 ptxas allots.  So every sum is cut by columns into
// two halves of kN = DH / 2 columns (128, or 80), each the size a warpgroup
// holds at DH 128 or 80, and every tensor is read and written as two
// half-width tensors: a tensor map a half, its base kN columns further and
// its extent kN, so that each half is laid out as the DH-kN instance lays a
// whole row (two 64-column slabs; at 160 TMA zero-fills columns 80-127 of
// each half's second slab, and the N-80 products read columns 0-79 of the
// half).  S and dP run over both halves (16 or 10 k16 steps).  The dQ
// launch takes 64 query rows a CTA, both warpgroups on the same rows:
// warpgroup 0 forms S and P, warpgroup 1 dP and dS = P (dP - D), P and dS
// crossing through shared memory (two exchange buffers, one named barrier
// each way), and each accumulates one column half of dQ.  (Each warpgroup
// forming S and dP itself, as the forward's dh-256 instance splits O
// (Sm90::kSplitO), took the dQ launch to 0.5458 ms against 0.4814 at
// recurrentgemma-9b's train_4k step and 1.0367 against 0.9367 at
// stablelm-12b's, though 0.0854 against 0.0887 and 0.1300 against 0.1417
// at their batch 4 x 512: H100, kernels/ab.py --sm90-bwd.)  The dK/dV
// launch keeps its roles (warpgroup 0 dV, warpgroup 1 dK) and gains a grid
// axis of the two column halves: each CTA forms S^T and dP^T whole and
// accumulates its half of dK and of dV.  That forms S and dP three times a
// pair of tiles where DH 128 forms them twice (9 full-width products of the
// five, against 7), and keeps every register where DH 128 / 80 holds it;
// the sums' order is that of a whole-width body.  Shared memory: a 64-row
// tile is 32 KB, so the rings take 2 stages (the dK/dV launch's own K and
// V, two (Q, dO) stages and the exchange are 226 KB; the dQ launch's 225).
// The timed shapes: q (4,512,16,256), k/v (4,512,1,256), causal (the
// window of 2048 does not bite at S 512), 131328 pairs a head: five
// products 0.0218 ms at the bf16 rate; q (4,512,32,160), k/v
// (4,512,8,160), causal: 0.0272 ms; recurrentgemma-9b's train_4k step, q
// (1,4096,16,256), k/v (1,4096,1,256), window 2048: 6292480 pairs a head,
// 0.2606 ms; stablelm-12b's, q (1,4096,32,160), k/v (1,4096,8,160),
// causal: 8390656 pairs a head, 0.4344 ms.
//
// Two launches, as the mma bodies run them, each a CTA of two consumer
// warpgroups and one producer warp (288 threads), as the forward's.  One
// thread of the producer issues every TMA load through a ring of kStages
// stages with full / empty mbarriers.  ptxas holds such a CTA to 168
// registers a thread, and held the consumer code there with setmaxnreg too
// (a producer warpgroup giving 144 of its 168 to the consumers spilled the
// same 500-1000 bytes on the H100's nvcc 12.9, with the warpgroup index
// proven warp-uniform, with __maxnreg__ and with -maxrregcount), so each
// consumer warpgroup holds one 64 x kN fp32 accumulator.  Tiles are TMA
// boxes of 64 rows x a 64-column (128-byte) slab, 128-byte swizzled, as the
// forward's.  Every product is a bf16 wgmma chain with fp32 accumulation;
// P goes to dV as one bf16 register operand, as SDPA rounds it, and dS to
// dK and dQ as bf16 hi + lo, two chains in one commit group (about 16
// bits, wgmma_regs): at qwen2-vl-2b's
// step one bf16 dS left the gradient at 0.72-0.98 of the bf16 tolerance on
// the H100 (SDPA's own at 0.81-0.92), hi + lo at 0.54-0.79 (kernels/ab.py
// --sm90-bwd).  Above kSm90SplitGroup query heads a KV head P goes as hi +
// lo too.  The two launches:
//
//   * dQ (flash_bwd_dq_sm90_kernel): one CTA a 128-row query tile of one
//     head (64 rows above DH 128, above), late tiles first; each consumer
//     warpgroup owns 64 rows, with Q and dO loaded once and 64-key K and V
//     tiles streamed.  It computes D
//     = rowsum(dO O) of its rows from device memory and writes it, with
//     lse log2(e), to the `delta` scratch (2, B, H, s_pad), rows past S
//     too (D 0, lse +inf), so that the dK/dV launch loads both per query
//     tile by one bulk copy each.  Per key tile: S = Q K^T and dP = dO V^T
//     (m64n64k16, both operands K-major in shared memory), P and dS in
//     registers, dQ += dS K (m64n128k16, or m64n80k16 at kN 80; dS the
//     register operand, K MN-major).  (64 rows a CTA with the roles split
//     as in dK/dV below took 0.109 ms against 0.071 at qwen2-vl-2b's step:
//     K and V stream twice as often, and an exchange a tile.)
//   * dK/dV (flash_bwd_dkdv_sm90_kernel): one CTA a 64-key tile of one KV
//     head (and a share of its group's query heads: head_split; and a
//     column half of dK and dV above DH 128), early
//     tiles first, K and V loaded once; Q, dO, lse and D stream in 64-query
//     tiles over every query head of the share.  Warpgroup 0 forms S^T = K
//     Q^T and P^T = exp(S^T scale - lse) and accumulates dV += P^T dO;
//     warpgroup 1 forms dP^T = V dO^T, reads P^T (fp32) from warpgroup 0
//     through a shared-memory exchange (two buffers, one named barrier a
//     tile), forms dS^T = P^T (dP^T - D) and accumulates dK += dS^T Q.  Keys
//     own the accumulator rows, so P^T and dS^T come out of the products
//     already transposed, as the register A operands of dV and dK.
//
// Each CTA classifies each 64 x 64 tile against the mask (tile_class,
// key_tile_class): hidden tiles skip the products, visible ones the mask.
// The accumulators leave through shared memory and TMA stores (rows past S
// and columns past dh clipped), so no accumulator is read under a
// per-thread condition: reads there made ptxas serialise the wgmma (C7518).
// Every sum has one owner and a fixed order: two runs give the same bits.
// What bounds it: operations (0.0456 ms of the seven products against
// 0.0121 ms of bytes at qwen2-vl-2b's step; 0.0761 against 0.0501 at
// stablelm-3b's, whose MHA reads K and V once a query head).  The tile
// geometry and shared-memory sizes are the same at DH 80 and 128.  What
// holds it back is each consumer warpgroup's chain (products, waits,
// exponentials, the P^T exchange, one after another; two warpgroups an SM):
// at stablelm-3b's step (H100, kernels/ab.py --sm90-bwd, variants that
// only time) the dK/dV launch took 0.174 ms without the exponentials
// against 0.199, dQ 0.126 with one bf16 dS chain against 0.142 and 0.126
// without D's reads of O and dO; launching the CTAs head-major, one head's
// tiles together in L2, took 0.361 against 0.337 (bytes do not bound it),
// and a fourth stage 0.349 against 0.340.  Waiting for each tile's dK or
// dV products only after issuing the next tile's S^T or dP^T took the
// dK/dV launch to 0.220 against 0.198, and the same in the dQ launch to
// 0.164 against 0.138: ptxas serialised the wgmma there (C7514) and
// injected waits (C7517).

template <int DH>
struct Sm90Bwd {
  static_assert(DH == 80 || DH == 128 || DH == 160 || DH == 256,
                "sm90 backward: dh 80, 128 (120 on 128), 160 or 256");
  static constexpr int kHalves = DH > 128 ? 2 : 1;  // column halves of a sum
  static constexpr int kN = DH / kHalves;      // columns a warpgroup accumulates (80 or 128)
  static constexpr int kHalfSteps = kN / 16;   // k16 steps of a half
  static constexpr int kKSteps = DH / 16;      // k16 steps of S and dP over the head dim
  static constexpr int kAcc = kN / 2;          // fp32 registers a thread of a 64 x kN sum
  static constexpr int kSlabs = 2;             // 64-column slabs of a half's bf16 row
  static constexpr int kF32Slabs = (kN + 31) / 32;  // 32-column slabs of a half's fp32 row
  static constexpr int kTile = 64;             // rows of a box, a warpgroup and a streamed tile
  static constexpr int kSlab = kTile * 128;    // bytes of a 64-row slab
  // a 64-row tile of every slab of each half (16 KB; 32 KB at DH 160 / 256)
  static constexpr int kTileBytes = kHalves * kSlabs * kSlab;
  // 3 stages: 0.1554 ms against 2's 0.1588 at qwen2-vl-2b's step (H100,
  // kernels/ab.py --sm90-bwd); 4 at dh 80 moved nothing (above); 2 above
  // DH 128, where 3 do not fit
  static constexpr int kStages = kHalves == 1 ? 3 : 2;
  static constexpr int kThreads = 288;         // consumer warpgroups 0, 1; a producer warp
  static constexpr int kXBytes = kTile * kTile * 4;  // an exchange buffer: 64 x 64 fp32
  // dQ: own Q and dO of kDqRows rows (slabs of kDqRows rows: 64 each
  // warpgroup's, or 64 both take), a ring of (K, V) tiles; above DH 128
  // warpgroup 0 forms S and P, warpgroup 1 dP and dS, and P and dS cross
  // through two exchange buffers
  static constexpr int kDqRows = kHalves == 1 ? 128 : 64;
  static constexpr int kOwnSlab = kDqRows * 128;
  static constexpr int kOwnBytes = kHalves * kSlabs * kOwnSlab;
  static constexpr int kDqRing = 2 * kOwnBytes;
  static constexpr int kDqX = kDqRing + kStages * 2 * kTileBytes;
  static constexpr int kDqBar = kDqX + (kHalves == 2 ? 2 * kXBytes : 0);
  static constexpr int kDqBytes = kDqBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment
  // dK/dV: own K and V of 64 rows, a ring of (Q, dO) tiles, two P^T
  // exchange buffers, a ring of (lse, D) rows
  static constexpr int kKvRing = 2 * kTileBytes;
  static constexpr int kKvX = kKvRing + kStages * 2 * kTileBytes;
  static constexpr int kKvRows = kKvX + 2 * kXBytes;
  static constexpr int kKvBar = kKvRows + kStages * 2 * kTile * 4;
  static constexpr int kKvBytes = kKvBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kKvBytes <= 232448 && kDqBytes <= 232448, "over the 227 KB a block may use");
  // the f32 staging of a half's sum (head split) in the exchange or own K
  static_assert(kF32Slabs * kSlab <= 2 * kXBytes, "an fp32 half over its staging");
};

// The tensor maps of the sm90 backward, one a column half of each tensor
// ([0] only at DH 80 / 128): bf16 (B, S, heads, dh) as [half's columns,
// heads, S, B], 64-row boxes of 64-column slabs; `part` the fp32 partial
// sums (2, head_split, B, S, K, dh) as [columns, K, S, 2 head_split B].
struct Sm90BwdMaps {
  CUtensorMap q[2], k[2], v[2], dout[2], dq[2], dk[2], dv[2], part[2];
};

// `bytes` (a multiple of 16) from a 16-byte aligned global address into
// shared memory; completion counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}
__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The queries [*lo, *hi] that see key kj (none, lo > hi, for a key at or past
// S): row_keys with the roles of rows and keys exchanged.
__device__ __forceinline__ void key_queries(const BwdParams& p, int kj, int* lo, int* hi) {
  *lo = p.causal ? kj : 0;
  *hi = p.S - 1;
  if (kj >= p.S) {
    *lo = 1;
    *hi = 0;
    return;
  }
  if (p.window) *hi = min(*hi, kj + p.window - 1);
  if (p.chunk) {
    const int c0 = (kj / p.chunk) * p.chunk;
    *lo = max(*lo, c0);
    *hi = min(*hi, c0 + p.chunk - 1);
  }
}

// tile_class of the tile of keys [k0, k0 + bk) (the accumulator's rows) x
// queries [q0, q0 + bq).  Keys past S are never stored and queries past S
// add nothing (their Q and dO rows are zero, their lse +inf), so neither
// makes a tile an edge tile.
__device__ __forceinline__ TileClass key_tile_class(const BwdParams& p, int k0, int bk, int q0,
                                                    int bq) {
  if (k0 >= p.S || q0 >= p.S) return kHidden;
  const int kl = min(k0 + bk, p.S) - 1, ql = min(q0 + bq, p.S) - 1;
  if (p.causal && ql < k0) return kHidden;
  if (p.window && q0 - kl >= p.window) return kHidden;
  if (p.chunk && (ql / p.chunk < k0 / p.chunk || q0 / p.chunk > kl / p.chunk)) return kHidden;
  bool all = true;
  if (p.causal) all = q0 >= kl;
  if (p.window) all = all && ql - k0 < p.window;
  if (p.chunk)
    all = all && k0 / p.chunk == kl / p.chunk && q0 / p.chunk == ql / p.chunk &&
          k0 / p.chunk == q0 / p.chunk;
  return all ? kVisible : kEdge;
}

// D (64 x 64) = A B^T over the k16 steps that hold the head dim DH (8, or
// 5 at DH 80: the zero-filled columns 80-127 are never read; above DH 128
// each half's, 8 or 5, half after half), as one commit group: A rows at
// `a` (a tile of a_slab bytes a slab, a half's two slabs after the other's),
// B rows at `b` (64 rows), both K-major.
template <int DH>
__device__ __forceinline__ void wgmma_rows_n64(float (&d)[32], uint32_t a, uint32_t a_slab,
                                               uint32_t b) {
  using C = Sm90Bwd<DH>;
#pragma unroll
  for (int j = 0; j < 32; ++j) d[j] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kKSteps; ++kk) {
    const int kh = kk % C::kHalfSteps;  // the step within its half
    const int slab = C::kSlabs * (kk / C::kHalfSteps) + kh / 4;
    const uint32_t off = (kh % 4) * 32;
    wgmma_ss_n64(d, desc_k_major(a + slab * a_slab + off),
                 desc_k_major(b + slab * C::kSlab + off));
  }
  wgmma_commit();
}

// D (64 x kN) += X B over 64 rows of B, one commit group to its end: X (64
// x 64, an accumulator) in registers as bf16, the register A operand (k-step
// kk covers columns [16kk, 16kk + 16), accumulator chunks 2kk and 2kk + 1),
// B a 64-row tile's half MN-major (at kN 80 the wgmma's N is 80: columns
// 0-63 of the half's first slab and 64-79 of its second).  With kSplit X goes as bf16 hi
// + lo (pack_split_bf16): the chain of lo, then the chain of hi, into D, in
// one group with one wait (two groups, one wait each, took 0.3471 ms
// against 0.3402 at stablelm-3b's step and 0.1569 against 0.1534 at
// qwen2-vl-2b's, the means of two turns, H100, kernels/ab.py --sm90-bwd;
// the same products in the same order, so the same bits).
template <int DH, bool kSplit = false>
__device__ __forceinline__ void wgmma_regs(float (&d)[Sm90Bwd<DH>::kAcc], const float (&x)[32],
                                           uint32_t b) {
  constexpr int N = Sm90Bwd<DH>::kN;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float u = x[8 * kk + 2 * r], v = x[8 * kk + 2 * r + 1];
      if constexpr (kSplit)
        pack_split_bf16(u, v, hi[kk][r], lo[kk][r]);
      else
        hi[kk][r] = pack_bf16(u, v);
    }
  fence_regs(d);
  wgmma_fence();
  if constexpr (kSplit) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<N>(d, lo[kk], desc_mn_major(b + kk * 16 * 128, Sm90Bwd<DH>::kSlab));
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<N>(d, hi[kk], desc_mn_major(b + kk * 16 * 128, Sm90Bwd<DH>::kSlab));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// A 64 x N accumulator (a whole sum, or a column half of one) out through
// shared memory: bf16 (times `scale`) into a 64-row tile of 128-byte
// swizzled 64-column slabs at `tile`, `slab` bytes apart, or fp32 into
// 32-column slabs with kF32, as a tensor map's box lays them (at N 80 the
// last slab's columns past 80 are left as they are: the store clips them);
// every thread writes, under no condition.
template <bool kF32, int N>
__device__ __forceinline__ void stage_acc(uint32_t tile, uint32_t slab, const float (&d)[N / 2],
                                          float scale) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 16 * warp + g + 8 * rr;  // r % 8 == g
      const float a = d[4 * j + 2 * rr] * scale, b = d[4 * j + 2 * rr + 1] * scale;
      if constexpr (kF32) {
        const int chunk = 2 * (j % 4) + t / 2;  // the 16-byte chunk of 8j + 2t in its slab
        st_shared_v2(tile + (j / 4) * slab + r * 128 + ((chunk ^ g) * 16) + (t % 2) * 8, a, b);
      } else {
        st_shared_u32(tile + (j / 8) * slab + r * 128 + (((j % 8) ^ g) * 16) + 4 * t,
                      pack_bf16(a, b));
      }
    }
}

// After stage_acc by every thread of warpgroup wg: one thread stores the
// slabs (`cols` columns each, `slab` bytes apart) through `map` (rows r0..,
// head h, outer index o), and waits until the store has read them.
__device__ __forceinline__ void store_acc(const CUtensorMap* map, uint32_t tile, uint32_t slab,
                                          int slabs, int cols, int wg, int h, int r0, int o) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_bar_sync(2 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < slabs; ++c) tma_store_4d(map, tile + c * slab, c * cols, h, r0, o);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// P = exp(S scale - lse) of a 64 x 64 score tile in place, 0 where an edge
// tile's mask hides the key: entry 4j + 2rr + e is row g + 8rr (lse in the
// log2 domain lse2[rr], keys [lo[rr], hi[rr]] seen), key k0 + 8j + 2t + e.
__device__ __forceinline__ void probs(float (&x)[32], const float (&lse2)[2], const int (&lo)[2],
                                      const int (&hi)[2], int k0, int t, float sl2,
                                      TileClass cls) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int klo = lo[rr] - k0 - 2 * t, khi = hi[rr] - k0 - 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = x[4 * j + 2 * rr + e];
        const float pr = ex2(fmaf(v, sl2, -lse2[rr]));
        v = cls == kEdge && (8 * j + e < klo || 8 * j + e > khi) ? 0.f : pr;
      }
  }
}

// this thread's 32 values to / from its 8 float4 exchange slots at xb
__device__ __forceinline__ void put_x(uint32_t xb, const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_shared_v4(xb + j * 32 * 16, x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}
__device__ __forceinline__ void get_x(uint32_t xb, float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = ld_shared_v4(xb + j * 32 * 16);
    x[4 * j] = v.x, x[4 * j + 1] = v.y, x[4 * j + 2] = v.z, x[4 * j + 3] = v.w;
  }
}

// Groups of more than this many query heads a KV head take P in hi + lo
// bf16 products too (BwdParams::split): a key's dV sums that many times S
// terms, and the plain model of one bf16 P (mha_grads_by_products with
// bf16_operands, the forward's O in bf16) read up to 0.64 of the bf16
// tolerance at 8 heads, 0.95 at 16 (MQA), where the body read 1.06 on the
// H100 at S 300, dh 120.
constexpr int kSm90SplitGroup = 8;

template <int DH>
__global__ void __launch_bounds__(Sm90Bwd<DH>::kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ Sm90BwdMaps m, const BwdParams p) {
  using C = Sm90Bwd<DH>;
  constexpr int kStages = C::kStages, R = C::kDqRows;
  extern __shared__ uint8_t smem_bwd90[];
  const uint32_t base = (smem_u32(smem_bwd90) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = base + C::kOwnBytes, ring = base + C::kDqRing;
  const uint32_t xch = base + C::kDqX;  // [P, dS][warp][j][lane] float4 (kHalves 2)
  const uint32_t bar_own = base + C::kDqBar, bar_full = bar_own + 8,
                 bar_empty = bar_full + 8 * kStages;
  // late tiles first (the longest under a causal mask: the grid's slowest
  // axis is the tile)
  const int n_q = (p.S + R - 1) / R;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.z)) * R;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (p.H / p.K);
  int kv_lo, kv_hi;
  kv_range(p, q0, R, &kv_lo, &kv_hi);
  const int kt0 = kv_lo / C::kTile;
  const int items = max(0, (kv_hi + C::kTile - 1) / C::kTile - kt0);

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it (and
  // every branch on it) as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    // ---- producer warp: one thread issues every load
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_own, 2 * C::kOwnBytes);
#pragma unroll
      for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
        for (int c = 0; c < C::kSlabs; ++c)
#pragma unroll
          for (int r = 0; r < R / 64; ++r) {
            const uint32_t off = (C::kSlabs * hf + c) * C::kOwnSlab + r * C::kSlab;
            tma_load_4d(sQ + off, &m.q[hf], bar_own, c * 64, h, q0 + r * 64, b);
            tma_load_4d(sDO + off, &m.dout[hf], bar_own, c * 64, h, q0 + r * 64, b);
          }
      uint32_t s = 0, ph = 0;  // the stage and its round's parity
      for (int i = 0; i < items; ++i) {
        const int k0 = (kt0 + i) * C::kTile;
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, ph ^ 1);  // the last round's
        const uint32_t full = bar_full + 8 * s, st = ring + s * 2 * C::kTileBytes;
        mbar_expect_tx(full, 2 * C::kTileBytes);
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
          for (int c = 0; c < C::kSlabs; ++c) {
            const uint32_t off = (C::kSlabs * hf + c) * C::kSlab;
            tma_load_4d(st + off, &m.k[hf], full, c * 64, kvh, k0, b);
            tma_load_4d(st + C::kTileBytes + off, &m.v[hf], full, c * 64, kvh, k0, b);
          }
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [r0, r0 + 64) and dQ's
    // column half `half` (kHalves 1: rows q0 + 64 wg, every column; 2: rows
    // q0, columns [wg kN, wg kN + kN))
    constexpr bool kSplitCols = C::kHalves == 2;
    const int half = kSplitCols ? wg : 0;
    const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32 % 4, 0);
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4, r0 = q0 + (kSplitCols ? 0 : 64 * wg), dh = p.dh;
    const long long qs = static_cast<long long>(p.H) * dh;
    const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * dh;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
    // D = rowsum(dO * O) of row 16 warp + (lane & 15), lanes r and r + 16
    // taking the two halves of its 16-byte chunks, from device memory while
    // the tiles load; it and lse log2(e) go to the scratch for the dK/dV
    // launch (rows past S: 0 and +inf; with split columns warpgroup 0's, both
    // holding the same rows).  The reads of lse, O and dO are issued before
    // the first is used, 8 chunks of each at a time (read in turns, the dQ
    // launch took 0.1409 ms against 0.1345 at stablelm-3b's step, H100,
    // kernels/ab.py --sm90-bwd); this thread's rows g and g + 8 take lse in
    // the log2 domain and the keys each sees.
    const int sr = r0 + 16 * warp + (lane & 15);
    const float lse_s = sr < p.S ? p.lse[row + sr] * kLog2e : INFINITY;
    float lse2[2];
    int lo[2], hi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = r0 + 16 * warp + g + 8 * rr;
      lse2[rr] = qi < p.S ? p.lse[row + qi] * kLog2e : INFINITY;
      row_keys(p, qi, &lo[rr], &hi[rr]);
    }
    float d = 0.f;
    if (sr < p.S) {
      const int chunks = dh / 8, hc = chunks / 2;
      const int n = lane < 16 ? hc : chunks - hc;  // hc, but at dh 120
      const long long off = q_off + sr * qs + (lane >> 4) * hc * 8;
      const uint4* o4 = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.o) + off);
      const uint4* d4 =
          reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) + off);
      constexpr int kChunks = DH / 16, kPass = kChunks < 8 ? kChunks : 8;
#pragma unroll
      for (int c0 = 0; c0 < kChunks; c0 += kPass) {
        uint4 ov4[kPass], dv4[kPass];
#pragma unroll
        for (int c = 0; c < kPass; ++c)
          if (c0 + c < n) ov4[c] = o4[c0 + c], dv4[c] = d4[c0 + c];
#pragma unroll
        for (int c = 0; c < kPass; ++c)
          if (c0 + c < n) {
            float ov[8], dv[8];
            unpack16(ov4[c], ov);
            unpack16(dv4[c], dv);
#pragma unroll
            for (int e = 0; e < 8; ++e) d = fmaf(ov[e], dv[e], d);
          }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 16);
    if (lane < 16 && (!kSplitCols || wg == 0)) {
      const long long srow = (static_cast<long long>(b) * p.H + h) * p.s_pad + sr;
      p.delta[srow] = lse_s;
      p.delta[static_cast<long long>(p.B) * p.H * p.s_pad + srow] = d;
    }
    // this thread's rows g and g + 8: D
    const float d_row[2] = {__shfl_sync(0xffffffffu, d, g), __shfl_sync(0xffffffffu, d, g + 8)};
    const float sl2 = p.scale * kLog2e;
    const uint32_t q_wg = sQ + (kSplitCols ? 0 : wg * C::kSlab);
    const uint32_t do_wg = sDO + (kSplitCols ? 0 : wg * C::kSlab);
    const uint32_t half_off = half * C::kSlabs * C::kSlab;  // this half's slabs of a tile
    float dq[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) dq[i] = 0.f;

    mbar_wait(bar_own, 0);
    uint32_t s = 0, ph = 0;
    for (int i = 0; i < items; ++i) {
      const int k0 = (kt0 + i) * C::kTile;
      const TileClass cls = tile_class(p, r0, 64, k0, C::kTile);
      mbar_wait(bar_full + 8 * s, ph);
      if (cls != kHidden) {
        uint32_t st = ring + s * 2 * C::kTileBytes;
        asm volatile("" : "+r"(st));
        if constexpr (kSplitCols) {
          // warpgroup 0: S = Q K^T and P; warpgroup 1: dP = dO V^T and dS =
          // P (dP - D), P handed over and dS back through the exchange (the
          // two warpgroups' accumulators lay out the same elements, so each
          // thread's 32 values go to its own 8 float4 slots), one named
          // barrier each way; both then accumulate dS K at their half
          float x[32];
          wgmma_rows_n64<DH>(x, wg == 0 ? q_wg : do_wg, C::kOwnSlab,
                             wg == 0 ? st : st + C::kTileBytes);
          wgmma_wait<0>();
          fence_regs(x);
          const uint32_t xp = xch + (warp * 8 * 32 + lane) * 16, xs = xp + C::kXBytes;
          if (wg == 0) {
            probs(x, lse2, lo, hi, k0, t, sl2, cls);
            put_x(xp, x);
            named_bar_sync(1, 256);  // P is in the exchange
            named_bar_sync(4, 256);  // dS is
            get_x(xs, x);
          } else {
            named_bar_sync(1, 256);
#pragma unroll
            for (int j = 0; j < 8; ++j) {  // dS = P (dP - D), D by row
              const float4 pt = ld_shared_v4(xp + j * 32 * 16);
              x[4 * j] = pt.x * (x[4 * j] - d_row[0]);
              x[4 * j + 1] = pt.y * (x[4 * j + 1] - d_row[0]);
              x[4 * j + 2] = pt.z * (x[4 * j + 2] - d_row[1]);
              x[4 * j + 3] = pt.w * (x[4 * j + 3] - d_row[1]);
            }
            put_x(xs, x);
            named_bar_sync(4, 256);
          }
          // dQ += dS K (this half's columns of K): dS's bf16 remainder, then dS
          wgmma_regs<DH, true>(dq, x, st + half_off);
        } else {
          float sacc[32], dp[32];
          wgmma_rows_n64<DH>(sacc, q_wg, C::kOwnSlab, st);                // S = Q K^T
          wgmma_rows_n64<DH>(dp, do_wg, C::kOwnSlab, st + C::kTileBytes);  // dP = dO V^T
          wgmma_wait<1>();
          fence_regs(sacc);
          probs(sacc, lse2, lo, hi, k0, t, sl2, cls);  // P = exp(S scale - lse)
          wgmma_wait<0>();
          fence_regs(dp);
#pragma unroll
          for (int j = 0; j < 32; ++j) sacc[j] *= dp[j] - d_row[(j >> 1) & 1];  // dS
          // dQ += dS K (this half's columns of K): dS's bf16 remainder, then dS
          wgmma_regs<DH, true>(dq, sacc, st + half_off);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      if (++s == kStages) s = 0, ph ^= 1;
    }

    // dQ = scale * the sum in bf16, through this warpgroup's Q rows (its
    // products are done with them; with split columns, through its half's
    // slabs once both warpgroups are); TMA clips rows past S and columns
    // past dh
    if constexpr (kSplitCols) named_bar_sync(1, 256);
    const uint32_t out = q_wg + half * C::kSlabs * C::kOwnSlab;
    stage_acc<false, C::kN>(out, C::kOwnSlab, dq, p.scale);
    store_acc(&m.dq[half], out, C::kOwnSlab, C::kSlabs, 64, wg, h, r0, b);
  }
}

// P^T = exp(S^T scale - lse) of a 64-key x 64-query tile in place, 0 where
// an edge tile's mask hides the pair: entry 4j + 2rr + e is key g + 8rr
// (seeing queries [lo[rr], hi[rr]]), query q0 + 8j + 2t + e, whose lse
// log2(e) is lse2[8j + 2t + e].
__device__ __forceinline__ void probs_t(float (&x)[32], const float* lse2, const int (&lo)[2],
                                        const int (&hi)[2], int q0, int t, float sl2,
                                        TileClass cls) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = x[4 * j + 2 * rr + e];
        const float pr = ex2(fmaf(v, sl2, -(e ? l2.y : l2.x)));
        const int qc = q0 + 8 * j + 2 * t + e;
        v = cls == kEdge && (qc < lo[rr] || qc > hi[rr]) ? 0.f : pr;
      }
  }
}

// dS^T = P^T (dP^T - D) in place of dP^T, P^T from this thread's 8 float4
// exchange slots at xb, D by query (dd, as lse2 above).
__device__ __forceinline__ void ds_t(float (&x)[32], uint32_t xb, const float* dd, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 pt = ld_shared_v4(xb + j * 32 * 16);
    const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * t);
    x[4 * j] = pt.x * (x[4 * j] - d2.x);
    x[4 * j + 1] = pt.y * (x[4 * j + 1] - d2.y);
    x[4 * j + 2] = pt.z * (x[4 * j + 2] - d2.x);
    x[4 * j + 3] = pt.w * (x[4 * j + 3] - d2.y);
  }
}

template <int DH>
__global__ void __launch_bounds__(Sm90Bwd<DH>::kThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ Sm90BwdMaps m, const BwdParams p) {
  using C = Sm90Bwd<DH>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_bwd90[];
  const uint32_t base = (smem_u32(smem_bwd90) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::kTileBytes, ring = base + C::kKvRing;
  const uint32_t xch = base + C::kKvX;      // [buffer][warp][j][lane] float4: P^T
  const uint32_t rows = base + C::kKvRows;  // [stage][lse log2(e), D][64] fp32
  const uint32_t bar_own = base + C::kKvBar, bar_full = bar_own + 8,
                 bar_empty = bar_full + 8 * kStages;
  // early key tiles first (the longest under a causal mask: the grid's
  // slowest axis is the tile); the fastest axis the column half of dK and dV
  // (kHalves 2), so that both halves of a tile run together
  const int k0 = blockIdx.z * C::kTile, b = blockIdx.y;
  const int half = blockIdx.x % C::kHalves, split = blockIdx.x / C::kHalves;
  const int HS = p.head_split, kvh = split / HS, hs = split % HS;
  const int G = p.H / p.K / HS, h0 = (kvh * HS + hs) * G;
  int q_lo, q_hi;
  q_range(p, k0, C::kTile, &q_lo, &q_hi);
  const int qt0 = q_lo / C::kTile;
  const int n_qt = max(0, (q_hi + C::kTile - 1) / C::kTile - qt0);
  const int items = G * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_own, 2 * C::kTileBytes);
#pragma unroll
      for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
        for (int c = 0; c < C::kSlabs; ++c) {
          const uint32_t off = (C::kSlabs * hf + c) * C::kSlab;
          tma_load_4d(sK + off, &m.k[hf], bar_own, c * 64, kvh, k0, b);
          tma_load_4d(sV + off, &m.v[hf], bar_own, c * 64, kvh, k0, b);
        }
      // lse log2(e) of head h's rows, and its D n_rows further
      const float* lrow = p.delta + (static_cast<long long>(b) * p.H + h0) * p.s_pad;
      const long long n_rows = static_cast<long long>(p.B) * p.H * p.s_pad;
      uint32_t s = 0, ph = 0;  // the stage and its round's parity
      int i = 0;
      for (int h = h0; h < h0 + G; ++h, lrow += p.s_pad)
        for (int qt = qt0; qt < qt0 + n_qt; ++qt, ++i) {
          if (i >= kStages) mbar_wait(bar_empty + 8 * s, ph ^ 1);  // the last round's
          const uint32_t full = bar_full + 8 * s, st = ring + s * 2 * C::kTileBytes;
          mbar_expect_tx(full, 2 * C::kTileBytes + 2 * C::kTile * 4);
#pragma unroll
          for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
            for (int c = 0; c < C::kSlabs; ++c) {
              const uint32_t off = (C::kSlabs * hf + c) * C::kSlab;
              tma_load_4d(st + off, &m.q[hf], full, c * 64, h, qt * C::kTile, b);
              tma_load_4d(st + C::kTileBytes + off, &m.dout[hf], full, c * 64, h,
                          qt * C::kTile, b);
            }
          const uint32_t sr = rows + s * 2 * C::kTile * 4;
          bulk_load(sr, lrow + qt * C::kTile, C::kTile * 4, full);
          bulk_load(sr + C::kTile * 4, lrow + n_rows + qt * C::kTile, C::kTile * 4, full);
          if (++s == kStages) s = 0, ph ^= 1;
        }
    }
  } else {
    // ---- consumers: both warpgroups take the CTA's 64 keys; warpgroup 0
    // accumulates dV, warpgroup 1 dK (the CTA's column half of each)
    const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32 % 4, 0);
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const float* srows = reinterpret_cast<const float*>(smem_bwd90 + (rows - smem_u32(smem_bwd90)));
    // the queries this thread's keys (rows g and g + 8) see
    int lo[2], hi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) key_queries(p, k0 + 16 * warp + g + 8 * rr, &lo[rr], &hi[rr]);
    const float sl2 = p.scale * kLog2e;
    const uint32_t own = wg == 0 ? sK : sV;  // S^T = K Q^T, dP^T = V dO^T
    const uint32_t half_off = half * C::kSlabs * C::kSlab;  // this half's slabs of a tile
    float acc[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;

    mbar_wait(bar_own, 0);
    uint32_t s = 0, ph = 0, nx = 0;  // nx: the P^T exchanges so far
    int qt = qt0;  // item i: head h0 + i / n_qt, query tile qt0 + i % n_qt
    for (int i = 0; i < items; ++i) {
      const int q0 = qt * C::kTile;
      if (++qt == qt0 + n_qt) qt = qt0;
      const TileClass cls = key_tile_class(p, k0, C::kTile, q0, C::kTile);
      mbar_wait(bar_full + 8 * s, ph);
      if (cls != kHidden) {
        uint32_t sq = ring + s * 2 * C::kTileBytes;
        asm volatile("" : "+r"(sq));
        const uint32_t sdo = sq + C::kTileBytes;
        // this thread's 32 values of P^T in the exchange, as 8 float4
        const uint32_t xb = xch + (nx & 1) * C::kXBytes + (warp * 8 * 32 + lane) * 16;
        const float* lse2 = srows + s * 2 * C::kTile;  // lse log2(e), then D, by query
        float x[32];
        wgmma_rows_n64<DH>(x, own, C::kSlab, wg == 0 ? sq : sdo);
        wgmma_wait<0>();
        fence_regs(x);
        if (wg == 0) {
          probs_t(x, lse2, lo, hi, q0, t, sl2, cls);  // P^T = exp(S^T scale - lse)
          put_x(xb, x);
          named_bar_sync(1, 256);  // P^T is in the exchange
          if (p.split)  // dV += P^T dO: P^T's remainder, then P^T
            wgmma_regs<DH, true>(acc, x, sdo + half_off);
          else
            wgmma_regs<DH>(acc, x, sdo + half_off);  // dV += P^T dO
        } else {
          named_bar_sync(1, 256);
          ds_t(x, xb, lse2 + C::kTile, t);  // dS^T = P^T (dP^T - D), D by query
          // dK += dS^T Q: dS^T's remainder, then dS^T
          wgmma_regs<DH, true>(acc, x, sq + half_off);
        }
        ++nx;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      if (++s == kStages) s = 0, ph ^= 1;
    }

    // Both warpgroups are done with K, V and the exchange: dK (scaled) and
    // dV (this CTA's column half of each) leave through them and TMA
    // stores, in bf16; or with head_split > 1 unscaled in fp32 through this
    // split's slice of `partial` (2, HS, B, S, K, dh), a third launch summing
    // the slices.  TMA clips keys past S and columns past dh.
    named_bar_sync(1, 256);
    if (HS == 1) {
      const uint32_t tile = wg == 0 ? sV : sK;
      stage_acc<false, C::kN>(tile, C::kSlab, acc, wg == 0 ? 1.f : p.scale);
      store_acc(wg == 0 ? &m.dv[half] : &m.dk[half], tile, C::kSlab, C::kSlabs, 64, wg, kvh, k0,
                b);
    } else {
      const uint32_t tile = wg == 0 ? xch : sK;  // 32 KB each
      stage_acc<true, C::kN>(tile, C::kSlab, acc, 1.f);
      store_acc(&m.part[half], tile, C::kSlab, C::kF32Slabs, 32, wg, kvh, k0,
                ((wg == 0 ? HS : 0) + hs) * p.B + b);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Raises kKernel's dynamic shared-memory limit to `bytes` once for each
// device (the attribute belongs to the device's context), not every launch.
template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<uint64_t> done{0};  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <auto kKernel>
int launch(int bq, size_t smem_bytes, const Params& p, cudaStream_t stream,
           int threads = kThreads) {
  const cudaError_t err = allow_smem<kKernel>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + bq - 1) / bq, p.H, p.B);
  kKernel<<<grid, threads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_dh(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch<flash_attn_bf16_kernel<DHP>>(kBQ, SmemBf16<DHP>::kBytes, p, stream);
  return launch<flash_attn_f32_kernel<DHP>>(Smem32<DHP>::kBQRows, Smem32<DHP>::kBytes, p,
                                            stream);
}

template <int DHP>
int launch_tf32(const Params& p, cudaStream_t stream) {
  using C = Tf32Cfg<DHP>;
  return launch<flash_attn_tf32_kernel<DHP>>(kBwdTile, C::kBytes, p, stream, C::kThreads);
}

// After a dK/dV launch: its error, or with head_split > 1 the launch that
// sums the partial sums.
template <typename T>
int launch_dkdv_sum(const BwdParams& p, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.head_split == 1) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(p.B) * p.S * p.K * p.dh / 4;
  flash_bwd_dkdv_sum_kernel<T><<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// BwdCfg's kernels, 4 warps a CTA: the backward up to DH 80 (no head split).
template <int DH, typename T>
int launch_bwd_dh(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t kSmem = BwdCfg<DH, T>::kBytes;
  if (p.head_split != 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>((p.S + kBwdTile - 1) / kBwdTile);
  cudaError_t err = allow_smem<flash_bwd_dq_kernel<DH, T>>(kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<DH, T><<<dim3(tiles, p.H, p.B), kBwdThreads, kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem<flash_bwd_dkdv_kernel<DH, T>>(kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<DH, T><<<dim3(tiles, p.K, p.B), kBwdThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The backward above DH 80: the pair kernels.
template <int DH, typename T>
int launch_bwd_pair(const BwdParams& p, cudaStream_t stream) {
  using C = BwdPairCfg<DH, T>;
  if (p.K * p.head_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<flash_bwd_dq_pair_kernel<DH, T>>(C::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned q_tiles = static_cast<unsigned>((p.S + kBwdTile - 1) / kBwdTile);
  flash_bwd_dq_pair_kernel<DH, T>
      <<<dim3(q_tiles, p.H, p.B), kPairThreads, C::kDqBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem<flash_bwd_dkdv_pair_kernel<DH, T>>(C::kKvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned kv_tiles = static_cast<unsigned>((p.S + C::kKvRows - 1) / C::kKvRows);
  flash_bwd_dkdv_pair_kernel<DH, T>
      <<<dim3(kv_tiles, p.K * p.head_split, p.B), kPairThreads, C::kKvBytes, stream>>>(p);
  return launch_dkdv_sum<T>(p, stream);
}

template <int DH>
int launch_bwd_dtype(const BwdParams& p, int dtype, cudaStream_t stream) {
  if constexpr (DH > 80) {
    if (dtype == 1) return launch_bwd_pair<DH, __nv_bfloat16>(p, stream);
    return launch_bwd_pair<DH, float>(p, stream);
  } else {
    if (dtype == 1) return launch_bwd_dh<DH, __nv_bfloat16>(p, stream);
    return launch_bwd_dh<DH, float>(p, stream);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so the
// library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, heads, dh) tensor given by its strides (in elements) as a
// 4-D tensor map [dh, heads, S, B]; the box is one head x `rows` rows x a
// 64-element slab, 128-byte swizzled (with f32: an fp32 tensor, 32-element
// slabs).  TMA fills what lies past S or past dh with zeros, and clips a
// store there.
int encode_map(CUtensorMap* map, const void* ptr, int dh, int heads, int S, int B,
               long long s_h, long long s_s, long long s_b, int rows, bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t size = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * size,
                                 static_cast<cuuint64_t>(s_s) * size,
                                 static_cast<cuuint64_t>(s_b) * size};
  const cuuint32_t box[4] = {f32 ? 32u : 64u, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The current device's SM count, asked once for each device.
cudaError_t multiprocessors(int* sms) {
  static std::atomic<int> counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < 64 ? counts[dev].load() : 0;
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) counts[dev].store(n);
  }
  *sms = n;
  return cudaSuccess;
}

template <int DH>
int launch_sm90(const Params& p, cudaStream_t stream) {
  using C = Sm90<DH>;
  const int dh = p.dh;  // DH, or 120 on the DH 128 body
  CUtensorMap tq, tk, tv, to;
  int err = encode_map(&tq, p.q, dh, p.H, p.S, p.B, p.q_sh, p.q_ss, p.q_sb, C::kBQ);
  if (!err) err = encode_map(&tk, p.k, dh, p.K, p.S, p.B, p.k_sh, p.k_ss, p.k_sb, C::kBK);
  if (!err) err = encode_map(&tv, p.v, dh, p.K, p.S, p.B, p.v_sh, p.v_ss, p.v_sb, C::kBK);
  if (!err)
    err = encode_map(&to, p.o, dh, p.H, p.S, p.B, dh, static_cast<long long>(p.H) * dh,
                     static_cast<long long>(p.S) * p.H * dh, 64);
  if (err) return err;
  const cudaError_t e = allow_smem<flash_attn_sm90_kernel<DH>>(C::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>((p.S + C::kBQ - 1) / C::kBQ) * p.H * p.B;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t e2 = multiprocessors(&sms);
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  Params pt = p;
  pt.tiles = static_cast<int>(tiles);
  flash_attn_sm90_kernel<DH><<<blocks, C::kThreads, C::kBytes, stream>>>(tq, tk, tv, to, pt);
  return static_cast<int>(cudaGetLastError());
}

// The sm90 backward: the dQ launch (which also writes lse log2(e) and D into
// the delta scratch), the dK/dV launch and, with head_split > 1, the sum.
// The tensor maps' strides are the real head dim; a half's map starts its
// columns further, with its columns' extent (the real head dim at DH 80 /
// 128).
template <int DH>
int launch_bwd_sm90(const BwdParams& p, cudaStream_t stream) {
  using C = Sm90Bwd<DH>;
  const int dh = p.dh;  // DH, or 120 on the DH 128 instance
  if (dh != DH && !(DH == 128 && dh == 120)) return static_cast<int>(cudaErrorInvalidValue);
  const long long ks = static_cast<long long>(p.K) * dh;
  const int cols = dh / C::kHalves;  // a half's columns
  Sm90BwdMaps m{};
  int err = 0;
  for (int hf = 0; hf < C::kHalves && !err; ++hf) {
    const long long c0 = static_cast<long long>(hf) * cols;  // its first column
    // a (B, S, heads, dh) bf16 tensor's half: its columns [c0, c0 + cols)
    const auto half_map = [&](CUtensorMap* map, const void* t, int heads) {
      const long long hs = static_cast<long long>(heads) * dh;
      return encode_map(map, static_cast<const __nv_bfloat16*>(t) + c0, cols, heads, p.S, p.B,
                        dh, hs, hs * p.S, C::kTile);
    };
    err = half_map(&m.q[hf], p.q, p.H);
    if (!err) err = half_map(&m.k[hf], p.k, p.K);
    if (!err) err = half_map(&m.v[hf], p.v, p.K);
    if (!err) err = half_map(&m.dout[hf], p.dout, p.H);
    if (!err) err = half_map(&m.dq[hf], p.dq, p.H);
    if (!err) err = half_map(&m.dk[hf], p.dk, p.K);
    if (!err) err = half_map(&m.dv[hf], p.dv, p.K);
    // partial (2, head_split, B, S, K, dh) fp32 as [dh, K, S, 2 head_split B]
    if (!err && p.head_split > 1)
      err = encode_map(&m.part[hf], p.partial + c0, cols, p.K, p.S, 2 * p.head_split * p.B, dh,
                       ks, ks * p.S, C::kTile, true);
  }
  if (err) return err;
  const long long q_tiles = (p.S + C::kDqRows - 1) / C::kDqRows,
                  kv_tiles = (p.S + C::kTile - 1) / C::kTile;
  if (kv_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem<flash_bwd_dq_sm90_kernel<DH>>(C::kDqBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_sm90_kernel<DH><<<dim3(p.H, p.B, static_cast<unsigned>(q_tiles)), C::kThreads,
                                 C::kDqBytes, stream>>>(m, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem<flash_bwd_dkdv_sm90_kernel<DH>>(C::kKvBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_sm90_kernel<DH>
      <<<dim3(p.K * p.head_split * C::kHalves, p.B, static_cast<unsigned>(kv_tiles)),
         C::kThreads, C::kKvBytes, stream>>>(m, p);
  return launch_dkdv_sum<__nv_bfloat16>(p, stream);
}

}  // namespace

// q (B,S,H,dh), k/v (B,S,K,dh) given by strides (in elements, last dim
// contiguous); o (B,S,H,dh) contiguous.  dtype codes: 0 = float32,
// 1 = bfloat16 (q, k, v and o share it).  head_dim is one of 16, 32, 64, 80,
// 120, 128, 160, 256.  lse: null, or (B,H,S) fp32 for each row's
// log-sum-exp (what the backward needs).  The mma (bf16) and fp32 bodies.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int K, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, int causal, int window,
                                   int chunk, float scale, int head_dim, int dtype,
                                   void* lse, void* stream) {
  const Params p{q,    k,    v,    o,      B,      S,     H,    K,     q_sb,    q_ss,
                 q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,  v_sh, causal, window, chunk,
                 scale, head_dim, static_cast<float*>(lse)};
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

// The sm90 body: bf16 q, k, v and o, laid out as for flash_attention_fwd,
// head_dim 80, 120 (on the 128 body), 128, 160 or 256; the bases of q, k and v
// and their batch, sequence and head strides are multiples of 16 bytes
// (TMA's rule); scale > 0.  lse: null, or (B,H,S) fp32 for each row's
// log-sum-exp, as flash_attention_fwd writes it (O is the same with or
// without it).  Returns cudaErrorInvalidValue on anything else, else
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                        int B, int S, int H, int K, long long q_sb,
                                        long long q_ss, long long q_sh, long long k_sb,
                                        long long k_ss, long long k_sh, long long v_sb,
                                        long long v_ss, long long v_sh, int causal,
                                        int window, int chunk, float scale, int head_dim,
                                        void* lse, void* stream) {
  const Params p{q,    k,    v,    o,      B,      S,     H,    K,     q_sb,    q_ss,
                 q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,  v_sh, causal, window, chunk,
                 scale, head_dim, static_cast<float*>(lse)};
  for (const void* ptr : {q, k, v})
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  for (long long s : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh})
    if (s <= 0 || s % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || K <= 0 || H % K || !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 80: return launch_sm90<80>(p, st);
    case 120:
    case 128: return launch_sm90<128>(p, st);
    case 160: return launch_sm90<160>(p, st);
    case 256: return launch_sm90<256>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: dq (B,S,H,dh), dk and dv (B,S,K,dh) from q, k, v, the
// forward's o and lse, and dout (like o); every tensor contiguous with a
// 16-byte aligned base, of one dtype (0 = float32, 1 = bfloat16; lse
// fp32).  delta is (B,H,S) fp32 scratch.  head_dim is one of 16, 32, 64,
// 80, 120, 128, 160, 256.  head_split divides H / K: the dK/dV kernel's
// CTAs a KV head's group of query heads is split over; above 1, partial
// is fp32 scratch of 2 * head_split * B * S * K * head_dim floats and a
// third launch sums it.  Two or three launches; returns the first launch
// error, else cudaGetLastError() after the last.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int S, int H, int K, int causal,
                                   int window, int chunk, float scale, int head_dim, int dtype,
                                   int head_split, void* partial, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1) || head_split < 1 || (H / K) % head_split ||
      (head_split > 1 && (partial == nullptr || !aligned16(partial))))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {q, k, v, o, dout, static_cast<const void*>(dq), static_cast<const void*>(dk),
                          static_cast<const void*>(dv)})
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q,      k,      v,     o,       dout, static_cast<const float*>(lse),
                    static_cast<float*>(delta), dq, dk, dv, B, S, H, K, causal, window,
                    chunk, scale, head_dim, head_split, static_cast<float*>(partial)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_bwd_dtype<16>(p, dtype, st);
    case 32: return launch_bwd_dtype<32>(p, dtype, st);
    case 64: return launch_bwd_dtype<64>(p, dtype, st);
    case 80: return launch_bwd_dtype<80>(p, dtype, st);
    case 120:
    case 128: return launch_bwd_dtype<128>(p, dtype, st);
    case 160: return launch_bwd_dtype<160>(p, dtype, st);
    case 256: return launch_bwd_dtype<256>(p, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The sm90 backward body: as flash_attention_bwd, bfloat16 only (dtype 1),
// head_dim 80, 120, 128, 160 or 256, scale > 0; delta is fp32 scratch of 2 * B * H * s_pad
// floats, s_pad = S rounded up to 128 (lse log2(e) and D, written by the dQ
// launch for the dK/dV launch), 16-byte aligned.  Returns
// cudaErrorInvalidValue on anything else, else the first launch error or
// cudaGetLastError() after the last launch.
extern "C" int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B, int S,
                                        int H, int K, int causal, int window, int chunk,
                                        float scale, int head_dim, int dtype, int head_split,
                                        void* partial, void* stream) {
  const int halves = head_dim > 128 ? 2 : 1;  // Sm90Bwd<head_dim>::kHalves
  if (B <= 0 || S <= 0 || K <= 0 || H % K || B > 65535 || H > 65535 || dtype != 1 ||
      (head_dim != 80 && head_dim != 120 && head_dim != 128 && head_dim != 160 &&
       head_dim != 256) ||
      !(scale > 0.f) || head_split < 1 || (H / K) % head_split ||
      K * head_split * halves > 65535 ||
      (head_split > 1 && (partial == nullptr || !aligned16(partial))))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {q, k, v, o, dout, static_cast<const void*>(delta),
                          static_cast<const void*>(dq), static_cast<const void*>(dk),
                          static_cast<const void*>(dv)})
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q,      k,      v,     o,       dout, static_cast<const float*>(lse),
                    static_cast<float*>(delta), dq, dk, dv, B, S, H, K, causal, window,
                    chunk, scale, head_dim, head_split, static_cast<float*>(partial),
                    (S + 127) / 128 * 128, H / K > kSm90SplitGroup};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 80: return launch_bwd_sm90<80>(p, st);
    case 160: return launch_bwd_sm90<160>(p, st);
    case 256: return launch_bwd_sm90<256>(p, st);
    default: return launch_bwd_sm90<128>(p, st);  // 120 and 128
  }
}

// The mma_tf32x3 body: float32 q, k, v and o, laid out as for
// flash_attention_fwd; head_dim one of 16, 32, 64, 80, 120, 128, 160, 256; lse
// null or (B,H,S) fp32.  Returns cudaErrorInvalidValue on anything else,
// else cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                                        int B, int S, int H, int K, long long q_sb,
                                        long long q_ss, long long q_sh, long long k_sb,
                                        long long k_ss, long long k_sh, long long v_sb,
                                        long long v_ss, long long v_sh, int causal,
                                        int window, int chunk, float scale, int head_dim,
                                        void* lse, void* stream) {
  const Params p{q,    k,    v,    o,      B,      S,     H,    K,     q_sb,    q_ss,
                 q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,  v_sh, causal, window, chunk,
                 scale, head_dim, static_cast<float*>(lse)};
  if (B <= 0 || S <= 0 || K <= 0 || H % K || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_tf32<16>(p, st);
    case 32: return launch_tf32<32>(p, st);
    case 64: return launch_tf32<64>(p, st);
    case 80: return launch_tf32<80>(p, st);
    case 120:
    case 128: return launch_tf32<128>(p, st);
    case 160: return launch_tf32<160>(p, st);
    case 256: return launch_tf32<256>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
