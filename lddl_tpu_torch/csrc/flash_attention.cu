// Flash attention for Hopper (sm_90a): forward (K1), dq (K2), dk/dv (K3).
//
// Layout: q/k/v/out and their gradients are contiguous [bh, s, d] with
// bh = batch * heads; lse and delta are [bh, s_q] float32; the key bias is
// [batch, s_kv] float32 holding 0 (attend) or -1e9 (padding), shared by the
// heads of one batch row. scale = 1/sqrt(d). Inputs are float32 or bfloat16.
// Outputs are written in the input dtype, lse in float32.
//
// Two bodies. Every kernel in float32 runs the CUDA-core body: every
// product and sum in float32, as the TPU bodies upcast with astype(f32), as
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), so they are bound by
// operations, far from the card's bound for the same work. One CTA owns a
// 64-row tile, a loop inside the CTA replaces the TPU's sequential grid
// axis, the streamed tiles are staged through shared memory as float32, and
// each thread keeps a 4 x (width/16) block of the running sums in
// registers. It is the only body that holds the float32 tolerances. Every
// kernel in bf16 runs the tensor-core body (flash_fwd_mma_kernel,
// flash_dq_mma_kernel, flash_dkv_mma_kernel, below): the same tiles and skip
// on mma.sync with cp.async double buffering (tensor_core.cuh); it rounds P
// and dS to bf16 before the products that take them, as the TPU's MXU
// rounds float32 operands at default precision.
//
// Ragged edge: each kernel masks its own edge by bounds checks (no host-side
// zero padding). Key columns at or past s_kv take no part in any sum, which
// equals the TPU wrapper's -1e9-biased padding columns for every query row
// with at least one attended key. A row with no attended key is outside that
// parity domain: here its softmax runs over the s_kv real (all -1e9 biased)
// keys, i.e. it returns the mean of V over them, where the TPU path also
// averages in its zero padding columns.
//
// No atomics in any sum: dq and dk/dv are separate kernels and each output
// element is summed by one thread (in the tensor-core body, one warp) in a
// fixed order, so gradients are bitwise repeatable from run to run. The one
// atomic is the launch count below, which no output reads.
//
// Launch counts live on the device: the first thread of block (0, 0) of
// every launch adds one to its kernel's slot of g_launches, so a launch
// replayed from a CUDA graph counts as one made from the host does.
// lddl_flash_launches reads the slots and lddl_flash_reset_launches zeroes
// them.
//
// K4, the segmented variants (block-diagonal packed attention), are the same
// three kernels instantiated with kSeg = true; kSeg = false compiles K1-K3
// exactly as before (every segment branch is `if constexpr`). Segment ids
// are int32 document ids per token, [batch, s], -1 on padding. The wrapper
// also passes each tile's [lo, hi] id interval, [batch, n_tiles, 2] int32,
// with -1 left out (an all-padding tile gets lo = 2^30 > hi = -1), at the
// widths the kernel uses: the 64-row tile a CTA owns and the tile_n<D>()
// rows it streams. Before it loads a streamed tile the CTA tests
// qlo <= khi && klo <= qhi and, when the intervals are disjoint, skips the
// whole iteration: no load, no product, no __syncthreads. The test reads the
// same two ints in every thread, so all threads skip together. The
// tensor-core body prefetches: it looks up the next LIVE tile's interval
// and issues that tile's copy, never a skipped one's, so every cp.async
// group it commits is waited for and consumed. A live tile
// adds the elementwise same-document bias (0 or -1e9) on top of the key bias,
// in every live tile, so the result is right for any ids (the interval test
// only ever keeps a tile too many, never one too few).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kRows = 64;       // rows of the tile one CTA owns
constexpr float kNegInf = -1e9f;
constexpr float kLFloor = 1e-30f;

// Rows [row0, row0 + n) of a [len, D] float32 matrix into shared memory
// with row stride D + 1 (conflict-free column reads); rows >= len become 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n, int len) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < len ? src[(size_t)gr * D + c] : 0.f;
  }
}

// Rows [row0, row0 + n) of a length-len float vector; entries >= len become 0.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n, int len) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    dst[r] = row0 + r < len ? src[row0 + r] : 0.f;
  }
}

// The block tile width: 64 streamed rows, or 32 at head_dim 128 so that the
// shared-memory footprint stays near 64-110 KB per CTA.
template <int D>
__host__ __device__ constexpr int tile_n() { return D == 128 ? 32 : 64; }

// Segment ids of a K4 launch (all null in K1-K3): the q rows' and kv rows'
// ids, [batch, s_q] and [batch, s_kv], and the tile intervals of each side,
// [batch, n_tiles, 2], each at the width its kernel tiles that side with.
struct Seg {
  const int* q;
  const int* kv;
  const int* q_iv;
  const int* kv_iv;
};

// Slots of g_launches: fwd, dq, dkv, then the same three with kSeg.
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };
constexpr int kKinds = 6;
__device__ unsigned long long g_launches[kKinds];

template <int kKind, bool kSeg>
__device__ __forceinline__ void count_launch() {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    atomicAdd(&g_launches[kKind + (kSeg ? 3 : 0)], 1ull);
  }
}

// Do two tiles' [lo, hi] id intervals overlap? Disjoint tiles hold no
// same-document pair and are skipped.
__device__ __forceinline__ bool overlap(const int* a, const int* b) {
  return a[0] <= b[1] && b[0] <= a[1];
}

// The same-document bias of one score (JAX _seg_bias).
__device__ __forceinline__ float seg_bias(int a, int b) {
  return a == b ? 0.f : kNegInf;
}

// ---------------------------------------------------------------------------
// K1: forward. Replaces lddl_tpu/ops/flash_attention.py:_fwd_kernel (driven by
// _flash_fwd_impl). One CTA per (64-row q tile, bh); the loop over kv tiles is
// the TPU's sequential kv grid axis. Running (m, l) per row live with the four
// threads that own that row's softmax; the running output acc lives in
// registers.
//
// K4-fwd (kSeg): replaces the same _fwd_kernel with segment refs
// (_tile_live under pl.when, _seg_bias; driven by _flash_fwd_impl). The
// skip drops a disjoint kv tile before its load, so the work, not only the
// result, scales with the same-document pairs. A q tile whose rows are all
// padding skips every kv tile and ends with l = 0, floored at kLFloor: out
// = 0 and a finite lse, as the TPU kernel's _finalize gives. Bound as K1:
// by float32 operations on the CUDA cores, now over the live tiles only.
template <int D>
constexpr size_t fwd_smem() {
  constexpr int BN = tile_n<D>();
  return sizeof(float) * (kRows * (D + 1) + 2 * BN * (D + 1) +
                          kRows * (BN + 1) + 3 * kRows);
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ lse, int heads, int s_q, int s_kv,
                     float scale, Seg seg) {
  count_launch<kFwd, kSeg>();
  constexpr int BN = tile_n<D>();
  constexpr int LD = D + 1, LS = BN + 1, NJ = BN / 16, ND = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRows][LD]
  float* ks = qs + kRows * LD;       // [BN][LD]
  float* vs = ks + BN * LD;          // [BN][LD]
  float* ss = vs + BN * LD;          // [kRows][LS] scores, then probabilities
  float* alpha_s = ss + kRows * LS;  // [kRows]
  float* l_s = alpha_s + kRows;      // [kRows]
  float* m_s = l_s + kRows;          // [kRows]

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int srow = tid / 4, ssub = tid % 4;  // softmax: 4 threads per row
  const float* qb = q + (size_t)bh * s_q * D;
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;
  const int batch = bh / heads;
  const float* biasb = bias + (size_t)batch * s_kv;
  // K4: this q tile's interval, the kv tiles' intervals of this batch row,
  // and the ids of this thread's four score rows.
  const int* q_iv = nullptr;
  const int* kv_iv = nullptr;
  const int* kvsegb = nullptr;
  int qseg[4];
  if constexpr (kSeg) {
    q_iv = seg.q_iv + ((size_t)batch * gridDim.x + blockIdx.x) * 2;
    kv_iv = seg.kv_iv + (size_t)batch * ((s_kv + BN - 1) / BN) * 2;
    kvsegb = seg.kv + (size_t)batch * s_kv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = q0 + ty + 16 * i;
      qseg[i] = gr < s_q ? seg.q[(size_t)batch * s_q + gr] : -1;
    }
  }

  load_tile<D>(qs, qb, q0, kRows, s_q);
  float m_run = kNegInf, l_run = 0.f;
  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < s_kv; kv0 += BN) {
    if constexpr (kSeg) {
      if (!overlap(q_iv, kv_iv + (kv0 / BN) * 2)) continue;
    }
    load_tile<D>(ks, kb, kv0, BN, s_kv);
    load_tile<D>(vs, vb, kv0, BN, s_kv);
    __syncthreads();
    // Scores for rows ty + 16 i, columns tx + 16 j.
    float sacc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float a[4], b[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + e];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = ks[(tx + 16 * j) * LD + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sacc[i][j] = fmaf(a[i], b[j], sacc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = kv0 + tx + 16 * j;
      const float bcol = col < s_kv ? biasb[col] : 0.f;
      int kseg = -1;
      if constexpr (kSeg) kseg = col < s_kv ? kvsegb[col] : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sc = sacc[i][j] * scale + bcol;
        if constexpr (kSeg) sc += seg_bias(qseg[i], kseg);
        ss[(ty + 16 * i) * LS + tx + 16 * j] = col < s_kv ? sc : -INFINITY;
      }
    }
    __syncthreads();
    // Online softmax. Column kv0 < s_kv is always in bounds, so the tile max
    // is finite and out-of-bounds columns get exp(-inf) = 0. In K4 a row
    // with no same-document key in this tile takes exp(-1e9 - m) garbage
    // that its own document's tile wipes out through alpha = 0 (every real
    // row meets its own document, at least at its own column).
    float mt = -INFINITY;
    for (int c = ssub; c < BN; c += 4) mt = fmaxf(mt, ss[srow * LS + c]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run, mt);
    float psum = 0.f;
    for (int c = ssub; c < BN; c += 4) {
      const float p = expf(ss[srow * LS + c] - m_new);
      ss[srow * LS + c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if (ssub == 0) alpha_s[srow] = alpha;
    __syncthreads();
    // acc = acc * alpha + P V for rows ty + 16 i, columns tx + 16 j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= al;
    }
#pragma unroll 8
    for (int e = 0; e < BN; ++e) {
      float p[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * LS + e];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = vs[e * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (ssub == 0) {
    l_s[srow] = fmaxf(l_run, kLFloor);
    m_s[srow] = m_run;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, gr = q0 + r;
    if (gr >= s_q) continue;
    const float l = l_s[r];
    float* orow = out + ((size_t)bh * s_q + gr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) orow[tx + 16 * j] = acc[i][j] / l;
    if (tx == 0) lse[(size_t)bh * s_q + gr] = m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// K2: dq, float32 (bf16: flash_dq_mma_kernel below). Replaces
// lddl_tpu/ops/flash_attention.py:_dq_kernel (driven by _flash_bwd). One
// CTA per (64-row q tile, bh), looping over kv tiles:
// dq = scale * sum_kv (P * (dO V^T - delta)) K with P = exp(s - lse), no clamp.
//
// K4-dq (kSeg): replaces _dq_kernel with segment refs. A disjoint kv tile
// would add exactly zero (P underflows against its -1e9 bias), so it is
// skipped before its load, as in K4-fwd; live tiles add the same-document
// bias. Bound as K2: float32 CUDA-core operations over the live tiles.
template <int D>
constexpr size_t dq_smem() {
  constexpr int BN = tile_n<D>();
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * BN * (D + 1) +
                          kRows * (BN + 1) + 2 * kRows);
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int s_q, int s_kv, float scale, Seg seg) {
  count_launch<kDq, kSeg>();
  constexpr int BN = tile_n<D>();
  constexpr int LD = D + 1, LS = BN + 1, NJ = BN / 16, ND = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRows][LD]
  float* dos = qs + kRows * LD;      // [kRows][LD]
  float* ks = dos + kRows * LD;      // [BN][LD]
  float* vs = ks + BN * LD;          // [BN][LD]
  float* dss = vs + BN * LD;         // [kRows][LS]
  float* lse_s = dss + kRows * LS;   // [kRows]
  float* delta_s = lse_s + kRows;    // [kRows]

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;
  const int batch = bh / heads;
  const float* biasb = bias + (size_t)batch * s_kv;
  const int* q_iv = nullptr;
  const int* kv_iv = nullptr;
  const int* kvsegb = nullptr;
  int qseg[4];
  if constexpr (kSeg) {
    q_iv = seg.q_iv + ((size_t)batch * gridDim.x + blockIdx.x) * 2;
    kv_iv = seg.kv_iv + (size_t)batch * ((s_kv + BN - 1) / BN) * 2;
    kvsegb = seg.kv + (size_t)batch * s_kv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = q0 + ty + 16 * i;
      qseg[i] = gr < s_q ? seg.q[(size_t)batch * s_q + gr] : -1;
    }
  }

  load_tile<D>(qs, q + (size_t)bh * s_q * D, q0, kRows, s_q);
  load_tile<D>(dos, dout + (size_t)bh * s_q * D, q0, kRows, s_q);
  load_vec(lse_s, lse + (size_t)bh * s_q, q0, kRows, s_q);
  load_vec(delta_s, delta + (size_t)bh * s_q, q0, kRows, s_q);
  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < s_kv; kv0 += BN) {
    if constexpr (kSeg) {
      if (!overlap(q_iv, kv_iv + (kv0 / BN) * 2)) continue;
    }
    load_tile<D>(ks, kb, kv0, BN, s_kv);
    load_tile<D>(vs, vb, kv0, BN, s_kv);
    __syncthreads();
    float sacc[4][NJ], pacc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sacc[i][j] = pacc[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float a[4], g[4], kk[NJ], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * LD + e];
        g[i] = dos[(ty + 16 * i) * LD + e];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        kk[j] = ks[(tx + 16 * j) * LD + e];
        vv[j] = vs[(tx + 16 * j) * LD + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          sacc[i][j] = fmaf(a[i], kk[j], sacc[i][j]);
          pacc[i][j] = fmaf(g[i], vv[j], pacc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = kv0 + tx + 16 * j;
      const float bcol = col < s_kv ? biasb[col] : 0.f;
      int kseg = -1;
      if constexpr (kSeg) kseg = col < s_kv ? kvsegb[col] : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float ds = 0.f;
        if (col < s_kv) {
          float sc = sacc[i][j] * scale + bcol;
          if constexpr (kSeg) sc += seg_bias(qseg[i], kseg);
          const float p = expf(sc - lse_s[r]);
          ds = p * (pacc[i][j] - delta_s[r]);
        }
        dss[r * LS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < BN; ++e) {
      float d[4], kk[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = dss[(ty + 16 * i) * LS + e];
#pragma unroll
      for (int j = 0; j < ND; ++j) kk[j] = ks[e * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(d[i], kk[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= s_q) continue;
    float* row = dq + ((size_t)bh * s_q + gr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// K3: dk/dv. Replaces lddl_tpu/ops/flash_attention.py:_dkv_kernel (driven by
// _flash_bwd). One CTA per (64-row kv tile, bh), looping over q tiles with
// the (k, v) tile resident: dv = sum_q P^T dO, dk = scale * sum_q dS^T Q with
// P = exp(min(s - lse, 30)).
//
// K4-dkv (kSeg): replaces _dkv_kernel with segment refs. Here the CTA owns
// a 64-row kv tile and streams q tiles, so q_iv is at the streamed width
// tile_n<D>() and kv_iv at 64; a disjoint q tile is skipped before its
// load, live ones add the same-document bias. Bound as K3: float32
// CUDA-core operations over the live tiles.
template <int D>
constexpr size_t dkv_smem() {
  constexpr int BM = tile_n<D>();
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * BM * (D + 1) +
                          2 * kRows * (BM + 1) + 2 * BM + kRows);
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int s_q, int s_kv,
                     float scale, Seg seg) {
  count_launch<kDkv, kSeg>();
  constexpr int BM = tile_n<D>();
  constexpr int LD = D + 1, LM = BM + 1, NJ = BM / 16, ND = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kRows][LD]
  float* vs = ks + kRows * LD;       // [kRows][LD]
  float* qs = vs + kRows * LD;       // [BM][LD]
  float* dos = qs + BM * LD;         // [BM][LD]
  float* pt = dos + BM * LD;         // [kRows][LM]  P^T
  float* dst = pt + kRows * LM;      // [kRows][LM]  dS^T
  float* lse_s = dst + kRows * LM;   // [BM]
  float* delta_s = lse_s + BM;       // [BM]
  float* bias_s = delta_s + BM;      // [kRows]

  const int bh = blockIdx.y, kv0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = q + (size_t)bh * s_q * D;
  const float* dob = dout + (size_t)bh * s_q * D;
  const float* lseb = lse + (size_t)bh * s_q;
  const float* deltab = delta + (size_t)bh * s_q;
  const int batch = bh / heads;
  // K4: this kv tile's interval, the q tiles' intervals of this batch row,
  // and the ids of this thread's four kv rows.
  const int* kv_iv = nullptr;
  const int* q_iv = nullptr;
  const int* qsegb = nullptr;
  int kseg[4];
  if constexpr (kSeg) {
    kv_iv = seg.kv_iv + ((size_t)batch * gridDim.x + blockIdx.x) * 2;
    q_iv = seg.q_iv + (size_t)batch * ((s_q + BM - 1) / BM) * 2;
    qsegb = seg.q + (size_t)batch * s_q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = kv0 + ty + 16 * i;
      kseg[i] = gr < s_kv ? seg.kv[(size_t)batch * s_kv + gr] : -1;
    }
  }

  load_tile<D>(ks, k + (size_t)bh * s_kv * D, kv0, kRows, s_kv);
  load_tile<D>(vs, v + (size_t)bh * s_kv * D, kv0, kRows, s_kv);
  load_vec(bias_s, bias + (size_t)batch * s_kv, kv0, kRows, s_kv);
  float dk_acc[4][ND], dv_acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < s_q; q0 += BM) {
    if constexpr (kSeg) {
      if (!overlap(kv_iv, q_iv + (q0 / BM) * 2)) continue;
    }
    load_tile<D>(qs, qb, q0, BM, s_q);
    load_tile<D>(dos, dob, q0, BM, s_q);
    load_vec(lse_s, lseb, q0, BM, s_q);
    load_vec(delta_s, deltab, q0, BM, s_q);
    __syncthreads();
    // Transposed scores: kv rows ty + 16 i, q columns tx + 16 j.
    float sacc[4][NJ], pacc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sacc[i][j] = pacc[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float kk[4], vv[4], qq[NJ], gg[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = ks[(ty + 16 * i) * LD + e];
        vv[i] = vs[(ty + 16 * i) * LD + e];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        qq[j] = qs[(tx + 16 * j) * LD + e];
        gg[j] = dos[(tx + 16 * j) * LD + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          sacc[i][j] = fmaf(kk[i], qq[j], sacc[i][j]);
          pacc[i][j] = fmaf(vv[i], gg[j], pacc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = tx + 16 * j;
      const bool live = q0 + r < s_q;
      int qseg = -1;
      if constexpr (kSeg) qseg = live ? qsegb[q0 + r] : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
        float p = 0.f, ds = 0.f;
        if (live) {
          float sc = sacc[i][j] * scale + bias_s[c];
          if constexpr (kSeg) sc += seg_bias(kseg[i], qseg);
          p = expf(fminf(sc - lse_s[r], 30.f));
          ds = p * (pacc[i][j] - delta_s[r]);
        }
        pt[c * LM + r] = p;
        dst[c * LM + r] = ds;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < BM; ++e) {
      float p[4], d[4], g[ND], qv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pt[(ty + 16 * i) * LM + e];
        d[i] = dst[(ty + 16 * i) * LM + e];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        g[j] = dos[e * LD + tx + 16 * j];
        qv[j] = qs[e * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          dv_acc[i][j] = fmaf(p[i], g[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(d[i], qv[j], dk_acc[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = kv0 + ty + 16 * i;
    if (gr >= s_kv) continue;
    float* dkrow = dk + ((size_t)bh * s_kv + gr) * D;
    float* dvrow = dv + ((size_t)bh * s_kv + gr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dkrow[tx + 16 * j] = dk_acc[i][j] * scale;
      dvrow[tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 bodies of K1-K3 (and their K4 forms) on the tensor cores.
//
// FlashAttention-2's structure on mma.sync and cp.async. A CTA of 4 warps
// owns the same 64-row tile as the float32 bodies above and streams the
// other side in the same tile_n<D>() rows, so the grid, the tile intervals
// of K4 and the skip are unchanged. Each warp owns 16 of the 64 rows: every
// product is a chain of m16n8k16 bf16 mma.sync with float32 accumulators in
// registers, and the C fragments of one product, packed to bf16, are the A
// fragments of the next (tensor_core.cuh), so no score or probability tile
// goes through shared memory. The streamed tiles are double-buffered with
// cp.async: while a tile is multiplied, the next live tile's copy is in
// flight. Streamed tiles sit in shared memory at a row stride of D + 8 bf16
// (16-byte aligned rows, and the eight rows of one ldmatrix fall in eight
// distinct 4-bank groups).
//
// Numerics: q, k, v and dO are bf16 already, so S = Q K^T and dP = dO V^T
// are exact products summed in float32. What is new against the float32
// body is one rounding: P and dS to bf16 before the products that take them
// (in dq only dS: P enters no product there); the softmax sums, lse and
// delta stay float32.
//
// What bounds them: the card's bound for this work is the bytes at s=512
// and the tensor cores' rate at the packed shapes, but these bodies run at
// 9-16% of it. Each CTA walks few streamed tiles (8 at s=512, ~13 live in a
// packed row), so its Q copy, first wait and epilogue weigh much, and each
// warp reloads the streamed fragments from shared memory for every product.
// wgmma with TMA and warp specialisation is the next step.

constexpr int kMmaThreads = 128;  // 4 warps x 16 owned rows

using bf16 = __nv_bfloat16;

// Rows [row0, row0 + N) of a [len, D] bf16 matrix into a shared tile of row
// stride D + 8 by 16-byte cp.async; rows >= len are zero-filled.
template <int D, int N>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src,
                                                int row0, int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(N * kChunks % kMmaThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < N * kChunks / kMmaThreads; ++it) {
    const int idx = threadIdx.x + it * kMmaThreads;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int gr = row0 + r;
    const bool in = gr < len;
    tc::cp_async_16(dst + r * (D + 8) + c, src + (size_t)(in ? gr : 0) * D + c,
                    in);
  }
}

// Entries [row0, row0 + N) of a length-len vector of 4-byte values into
// shared memory by cp.async; entries >= len are zero-filled.
template <int N, typename V>
__device__ __forceinline__ void copy_vec_async(V* dst, const V* src, int row0,
                                               int len) {
  static_assert(sizeof(V) == 4, "4-byte entries");
  for (int r = threadIdx.x; r < N; r += kMmaThreads) {
    const bool in = row0 + r < len;
    tc::cp_async_4(dst + r, src + (in ? row0 + r : 0), in);
  }
}

// A fragment (16 x 16) at rows [r0, r0 + 16), cols [c0, c0 + 16) of a
// row-major shared tile of stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  tc::ldmatrix_x4(f, tile + (r0 + lane % 16) * LD + c0 + (lane / 16) * 8);
}

// B fragments of two n-blocks for a product against the TRANSPOSE of a
// row-major tile: n = tile rows [n0, n0 + 16), k = tile cols [k0, k0 + 16).
// f[0], f[1] are n-block n0's b[0], b[1]; f[2], f[3] n-block n0 + 8's.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&f)[4], const bf16* tile,
                                        int n0, int k0, int lane) {
  tc::ldmatrix_x4(f, tile + (n0 + lane % 8 + (lane / 16) * 8) * LD + k0 +
                         ((lane / 8) % 2) * 8);
}

// B fragments of two n-blocks for a product against a row-major tile
// itself: k = tile rows [k0, k0 + 16), n = tile cols [n0, n0 + 16).
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&f)[4], const bf16* tile,
                                       int k0, int n0, int lane) {
  tc::ldmatrix_x4_trans(f, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                               n0 + (lane / 16) * 8);
}

// The A fragments of a [16, 16 * KS] bf16 operand from the float C
// fragments of a [16, 8 * 2 * KS] product (rounded to bf16 here).
template <int KS>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[KS][4],
                                       float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = tc::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = tc::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = tc::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = tc::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// K1 / K4-fwd, bf16: replaces lddl_tpu/ops/flash_attention.py:_fwd_kernel
// as flash_fwd_kernel does. Shared memory: the Q tile, two buffers of K and
// V tiles, and two of the tile's key bias and (K4) kv ids.
template <int D>
constexpr size_t fwd_mma_smem() {
  constexpr int BN = tile_n<D>();
  return sizeof(bf16) * (kRows + 4 * BN) * (D + 8) + 2 * 2 * BN * 4;
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias, bf16* __restrict__ out,
                         float* __restrict__ lse, int heads, int s_q, int s_kv,
                         float scale, Seg seg) {
  count_launch<kFwd, kSeg>();
  constexpr int BN = tile_n<D>(), LD = D + 8;
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int NB = BN / 8;   // n-blocks of the scores
  constexpr int KN = BN / 16;  // k-steps of P V
  constexpr int ND = D / 8;    // n-blocks of out
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [kRows][LD]
  bf16* ks = qs + kRows * LD;                      // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;                     // [2][BN][LD]
  float* bias_s = reinterpret_cast<float*>(vs + 2 * BN * LD);  // [2][BN]
  int* kvseg_s = reinterpret_cast<int*>(bias_s + 2 * BN);      // [2][BN]

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* qb = q + (size_t)bh * s_q * D;
  const bf16* kb = k + (size_t)bh * s_kv * D;
  const bf16* vb = v + (size_t)bh * s_kv * D;
  const int batch = bh / heads;
  const float* biasb = bias + (size_t)batch * s_kv;
  const int n_tiles = (s_kv + BN - 1) / BN;
  // K4: this q tile's interval, the kv tiles' intervals of this batch row,
  // and the ids of this lane's two rows (16 warp + g and + 8).
  const int* q_iv = nullptr;
  const int* kv_iv = nullptr;
  const int* kvsegb = nullptr;
  int qseg[2] = {-1, -1};
  if constexpr (kSeg) {
    q_iv = seg.q_iv + ((size_t)batch * gridDim.x + blockIdx.x) * 2;
    kv_iv = seg.kv_iv + (size_t)batch * n_tiles * 2;
    kvsegb = seg.kv + (size_t)batch * s_kv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gr = q0 + 16 * warp + g + 8 * i;
      qseg[i] = gr < s_q ? seg.q[(size_t)batch * s_q + gr] : -1;
    }
  }
  // The first live kv tile at or after j (n_tiles if none). Every thread
  // reads the same ints, so the whole CTA agrees on every skip.
  auto next_live = [&](int j) {
    if constexpr (kSeg) {
      while (j < n_tiles && !overlap(q_iv, kv_iv + 2 * j)) ++j;
    }
    return j;
  };
  // Two cp.async groups per kv tile: K with its bias and ids, then V.
  auto issue = [&](int j, int buf) {
    const int kv0 = j * BN;
    copy_tile_async<D, BN>(ks + buf * BN * LD, kb, kv0, s_kv);
    copy_vec_async<BN>(bias_s + buf * BN, biasb, kv0, s_kv);
    if constexpr (kSeg) copy_vec_async<BN>(kvseg_s + buf * BN, kvsegb, kv0, s_kv);
    tc::cp_async_commit();
    copy_tile_async<D, BN>(vs + buf * BN * LD, vb, kv0, s_kv);
    tc::cp_async_commit();
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  int j = next_live(0);
  if (j < n_tiles) {  // else a q tile of padding only: out = 0, lse finite
    copy_tile_async<D, kRows>(qs, qb, q0, s_q);
    tc::cp_async_commit();
    issue(j, 0);
    tc::cp_async_wait<2>();  // Q landed (K and V may still be in flight)
    __syncthreads();
    uint32_t qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) load_a<LD>(qf[kk], qs, 16 * warp, 16 * kk, lane);

    int buf = 0;
    while (j < n_tiles) {
      const int jn = next_live(j + 1);
      const int kv0 = j * BN;
      tc::cp_async_wait<1>();  // this tile's K (its V may be in flight)
      // K landed for every thread, and every warp is done with the other
      // buffer (the last tile's), so the next live tile may fill it.
      __syncthreads();
      if (jn < n_tiles) issue(jn, buf ^ 1);
      const bf16* kt = ks + buf * BN * LD;
      const bf16* vt = vs + buf * BN * LD;
      const float* bt = bias_s + buf * BN;
      const int* st = kvseg_s + buf * BN;

      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t kf[4];
          load_bt<LD>(kf, kt, 16 * p, 16 * kk, lane);
          tc::mma_bf16(s[2 * p], qf[kk], kf[0], kf[1]);
          tc::mma_bf16(s[2 * p + 1], qf[kk], kf[2], kf[3]);
        }
      // Scale and biases; columns at or past s_kv take no part.
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          float x = s[n][e] * scale + bt[c];
          if constexpr (kSeg) x += seg_bias(qseg[e >> 1], st[c]);
          x = kv0 + c < s_kv ? x : -INFINITY;
          s[n][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      // Online softmax; the four lanes t of a row share it. Column kv0 is
      // in bounds, so the tile max is finite (see flash_fwd_kernel).
      float alpha[2], m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        m_new[i] = fmaxf(m_run[i], mt[i]);
        alpha[i] = __expf(m_run[i] - m_new[i]);
        m_run[i] = m_new[i];
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[n][e] - m_new[e >> 1]);
          s[n][e] = p;
          psum[e >> 1] += p;
        }
      // Each lane keeps its own columns' part of l; the four parts of a
      // row are summed once, at the end.
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + psum[i];
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      uint32_t pf[KN][4];
      c_to_a<KN>(pf, s);

      if (jn < n_tiles) {
        tc::cp_async_wait<2>();  // this tile's V (the next tile's two groups
      } else {                   // may be in flight)
        tc::cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t vf[4];
          load_b<LD>(vf, vt, 16 * kk, 16 * p, lane);
          tc::mma_bf16(acc[2 * p], pf[kk], vf[0], vf[1]);
          tc::mma_bf16(acc[2 * p + 1], pf[kk], vf[2], vf[3]);
        }
      buf ^= 1;
      j = jn;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = fmaxf(l_run[i], kLFloor);
    const int gr = q0 + 16 * warp + g + 8 * i;
    if (gr >= s_q) continue;
    bf16* orow = out + ((size_t)bh * s_q + gr) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
    }
    if (t == 0) lse[(size_t)bh * s_q + gr] = m_run[i] + logf(l);
  }
}

// K2 / K4-dq, bf16: replaces lddl_tpu/ops/flash_attention.py:_dq_kernel as
// flash_dq_kernel does. The forward's skeleton with another inner step: the
// q rows are M in all three products. S = Q K^T and P = exp(S scale + bias
// - lse) with no clamp, dP = dO V^T, dS = P (dP - delta) in the C
// fragments, and dq += dS K with dS packed to bf16 as the A operand and K,
// as it lies, the B operand (load_b), from the same shared tile as K^T in
// S. Q and dO are held as A fragments for the whole kv loop, lse and delta
// of this lane's two rows in registers. Shared memory: the Q and dO tiles,
// two buffers of K and V tiles, and two of the tile's key bias and (K4) kv
// ids. A buffer is refilled only after the __syncthreads at the top of the
// next tile, which every warp reaches after its last product (dS K) on it.
template <int D>
constexpr size_t dq_mma_smem() {
  constexpr int BN = tile_n<D>();
  return sizeof(bf16) * (2 * kRows + 4 * BN) * (D + 8) + 2 * 2 * BN * 4;
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int heads, int s_q, int s_kv, float scale, Seg seg) {
  count_launch<kDq, kSeg>();
  constexpr int BN = tile_n<D>(), LD = D + 8;
  constexpr int KD = D / 16;   // k-steps of Q K^T and dO V^T
  constexpr int NB = BN / 8;   // n-blocks of S and dP
  constexpr int KN = BN / 16;  // k-steps of dS K
  constexpr int ND = D / 8;    // n-blocks of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // [kRows][LD]
  bf16* dos = qs + kRows * LD;                     // [kRows][LD]
  bf16* ks = dos + kRows * LD;                     // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;                     // [2][BN][LD]
  float* bias_s = reinterpret_cast<float*>(vs + 2 * BN * LD);  // [2][BN]
  int* kvseg_s = reinterpret_cast<int*>(bias_s + 2 * BN);      // [2][BN]

  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)bh * s_kv * D;
  const bf16* vb = v + (size_t)bh * s_kv * D;
  const int batch = bh / heads;
  const float* biasb = bias + (size_t)batch * s_kv;
  const int n_tiles = (s_kv + BN - 1) / BN;
  // This lane's two rows (16 warp + g and + 8): lse, delta and, in K4, ids.
  // Rows past s_q take lse = delta = 0; their zero-filled dO gives dS = 0.
  float row_lse[2], row_delta[2];
  int qseg[2] = {-1, -1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = q0 + 16 * warp + g + 8 * i;
    const bool in = gr < s_q;
    row_lse[i] = in ? lse[(size_t)bh * s_q + gr] : 0.f;
    row_delta[i] = in ? delta[(size_t)bh * s_q + gr] : 0.f;
    if constexpr (kSeg) qseg[i] = in ? seg.q[(size_t)batch * s_q + gr] : -1;
  }
  const int* q_iv = nullptr;
  const int* kv_iv = nullptr;
  const int* kvsegb = nullptr;
  if constexpr (kSeg) {
    q_iv = seg.q_iv + ((size_t)batch * gridDim.x + blockIdx.x) * 2;
    kv_iv = seg.kv_iv + (size_t)batch * n_tiles * 2;
    kvsegb = seg.kv + (size_t)batch * s_kv;
  }
  // As in flash_fwd_mma_kernel: the first live kv tile at or after j, and
  // two cp.async groups per kv tile, K with its bias and ids, then V.
  auto next_live = [&](int j) {
    if constexpr (kSeg) {
      while (j < n_tiles && !overlap(q_iv, kv_iv + 2 * j)) ++j;
    }
    return j;
  };
  auto issue = [&](int j, int buf) {
    const int kv0 = j * BN;
    copy_tile_async<D, BN>(ks + buf * BN * LD, kb, kv0, s_kv);
    copy_vec_async<BN>(bias_s + buf * BN, biasb, kv0, s_kv);
    if constexpr (kSeg)
      copy_vec_async<BN>(kvseg_s + buf * BN, kvsegb, kv0, s_kv);
    tc::cp_async_commit();
    copy_tile_async<D, BN>(vs + buf * BN * LD, vb, kv0, s_kv);
    tc::cp_async_commit();
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int j = next_live(0);
  if (j < n_tiles) {  // else a q tile of padding only: dq = 0
    copy_tile_async<D, kRows>(qs, q + (size_t)bh * s_q * D, q0, s_q);
    copy_tile_async<D, kRows>(dos, dout + (size_t)bh * s_q * D, q0, s_q);
    tc::cp_async_commit();
    issue(j, 0);
    tc::cp_async_wait<2>();  // Q and dO landed (K and V may be in flight)
    __syncthreads();
    uint32_t qf[KD][4], gf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a<LD>(qf[kk], qs, 16 * warp, 16 * kk, lane);
      load_a<LD>(gf[kk], dos, 16 * warp, 16 * kk, lane);
    }

    int buf = 0;
    while (j < n_tiles) {
      const int jn = next_live(j + 1);
      const int kv0 = j * BN;
      tc::cp_async_wait<1>();  // this tile's K (its V may be in flight)
      // K landed for every thread, and every warp is done with the other
      // buffer: its last product there, the last tile's dS K, came before.
      __syncthreads();
      if (jn < n_tiles) issue(jn, buf ^ 1);
      const bf16* kt = ks + buf * BN * LD;
      const bf16* vt = vs + buf * BN * LD;
      const float* bt = bias_s + buf * BN;
      const int* st = kvseg_s + buf * BN;

      // S = Q K^T, then P = exp(S scale + biases - lse) in place; columns
      // at or past s_kv take no part (P = 0 there).
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t kf[4];
          load_bt<LD>(kf, kt, 16 * p, 16 * kk, lane);
          tc::mma_bf16(s[2 * p], qf[kk], kf[0], kf[1]);
          tc::mma_bf16(s[2 * p + 1], qf[kk], kf[2], kf[3]);
        }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          float x = s[n][e] * scale + bt[c];
          if constexpr (kSeg) x += seg_bias(qseg[e >> 1], st[c]);
          s[n][e] = kv0 + c < s_kv ? __expf(x - row_lse[e >> 1]) : 0.f;
        }

      if (jn < n_tiles) {
        tc::cp_async_wait<2>();  // this tile's V (the next tile's two groups
      } else {                   // may be in flight)
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      // dP = dO V^T, then dS = P (dP - delta) in place of P.
      float dp[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t vf[4];
          load_bt<LD>(vf, vt, 16 * p, 16 * kk, lane);
          tc::mma_bf16(dp[2 * p], gf[kk], vf[0], vf[1]);
          tc::mma_bf16(dp[2 * p + 1], gf[kk], vf[2], vf[3]);
        }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] *= dp[n][e] - row_delta[e >> 1];
      uint32_t df[KN][4];
      c_to_a<KN>(df, s);
      // dq += dS K.
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t f[4];
          load_b<LD>(f, kt, 16 * kk, 16 * p, lane);
          tc::mma_bf16(acc[2 * p], df[kk], f[0], f[1]);
          tc::mma_bf16(acc[2 * p + 1], df[kk], f[2], f[3]);
        }
      buf ^= 1;
      j = jn;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = q0 + 16 * warp + g + 8 * i;
    if (gr >= s_q) continue;
    bf16* row = dq + ((size_t)bh * s_q + gr) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] * scale,
                                acc[n][2 * i + 1] * scale);
    }
  }
}

// K3 / K4-dkv, bf16: replaces lddl_tpu/ops/flash_attention.py:_dkv_kernel
// as flash_dkv_kernel does. The kv rows are the M dimension of every
// product: S^T = K Q^T gives P^T directly in C layout, which is the A
// operand of dv += P^T dO; dP^T = V dO^T, dS^T = P^T (dP^T - delta) and
// dk += dS^T Q the same way, so no transpose goes through shared memory.
// Shared memory: the K and V tiles (resident), two buffers of Q and dO
// tiles, and two of the tile's lse, delta and (K4) q ids.
template <int D>
constexpr size_t dkv_mma_smem() {
  constexpr int BM = tile_n<D>();
  return sizeof(bf16) * (2 * kRows + 4 * BM) * (D + 8) + 2 * 3 * BM * 4;
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int heads, int s_q, int s_kv,
                         float scale, Seg seg) {
  count_launch<kDkv, kSeg>();
  constexpr int BM = tile_n<D>(), LD = D + 8;
  constexpr int KD = D / 16;   // k-steps of K Q^T and V dO^T
  constexpr int NB = BM / 8;   // n-blocks of S^T and dP^T
  constexpr int KM = BM / 16;  // k-steps of P^T dO and dS^T Q
  constexpr int ND = D / 8;    // n-blocks of dk and dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);    // [kRows][LD]
  bf16* vs = ks + kRows * LD;                      // [kRows][LD]
  bf16* qs = vs + kRows * LD;                      // [2][BM][LD]
  bf16* dos = qs + 2 * BM * LD;                    // [2][BM][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BM * LD);  // [2][BM]
  float* delta_s = lse_s + 2 * BM;                             // [2][BM]
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * BM);      // [2][BM]

  const int bh = blockIdx.y, kv0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* qb = q + (size_t)bh * s_q * D;
  const bf16* dob = dout + (size_t)bh * s_q * D;
  const float* lseb = lse + (size_t)bh * s_q;
  const float* deltab = delta + (size_t)bh * s_q;
  const int batch = bh / heads;
  const int n_tiles = (s_q + BM - 1) / BM;
  // This lane's two kv rows (16 warp + g and + 8): key bias and, in K4, ids.
  float kbias[2];
  int kseg[2] = {-1, -1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = kv0 + 16 * warp + g + 8 * i;
    kbias[i] = gr < s_kv ? bias[(size_t)batch * s_kv + gr] : 0.f;
    if constexpr (kSeg) kseg[i] = gr < s_kv ? seg.kv[(size_t)batch * s_kv + gr] : -1;
  }
  const int* kv_iv = nullptr;
  const int* q_iv = nullptr;
  const int* qsegb = nullptr;
  if constexpr (kSeg) {
    kv_iv = seg.kv_iv + ((size_t)batch * gridDim.x + blockIdx.x) * 2;
    q_iv = seg.q_iv + (size_t)batch * n_tiles * 2;
    qsegb = seg.q + (size_t)batch * s_q;
  }
  auto next_live = [&](int j) {
    if constexpr (kSeg) {
      while (j < n_tiles && !overlap(kv_iv, q_iv + 2 * j)) ++j;
    }
    return j;
  };
  // Two groups per q tile: Q with its lse and ids, then dO with its delta.
  auto issue = [&](int j, int buf) {
    const int q0 = j * BM;
    copy_tile_async<D, BM>(qs + buf * BM * LD, qb, q0, s_q);
    copy_vec_async<BM>(lse_s + buf * BM, lseb, q0, s_q);
    if constexpr (kSeg) copy_vec_async<BM>(qseg_s + buf * BM, qsegb, q0, s_q);
    tc::cp_async_commit();
    copy_tile_async<D, BM>(dos + buf * BM * LD, dob, q0, s_q);
    copy_vec_async<BM>(delta_s + buf * BM, deltab, q0, s_q);
    tc::cp_async_commit();
  };

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int j = next_live(0);
  if (j < n_tiles) {
    copy_tile_async<D, kRows>(ks, k + (size_t)bh * s_kv * D, kv0, s_kv);
    copy_tile_async<D, kRows>(vs, v + (size_t)bh * s_kv * D, kv0, s_kv);
    tc::cp_async_commit();
    issue(j, 0);
    int buf = 0;
    while (j < n_tiles) {
      const int jn = next_live(j + 1);
      const int q0 = j * BM;
      tc::cp_async_wait<1>();  // K, V and this tile's Q (its dO may be in flight)
      __syncthreads();  // ... for every thread; the other buffer is free
      if (jn < n_tiles) issue(jn, buf ^ 1);
      const bf16* qt = qs + buf * BM * LD;
      const bf16* dot = dos + buf * BM * LD;
      const float* lt = lse_s + buf * BM;
      const float* dlt = delta_s + buf * BM;
      const int* st = qseg_s + buf * BM;

      // S^T = K Q^T: this warp's 16 kv rows x BM q columns.
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kf[4];
        load_a<LD>(kf, ks, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t qf[4];
          load_bt<LD>(qf, qt, 16 * p, 16 * kk, lane);
          tc::mma_bf16(s[2 * p], kf, qf[0], qf[1]);
          tc::mma_bf16(s[2 * p + 1], kf, qf[2], qf[3]);
        }
      }
      // P^T = exp(min(S^T scale + bias - lse, 30)); q columns at or past
      // s_q take no part.
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          float x = s[n][e] * scale + kbias[e >> 1];
          if constexpr (kSeg) x += seg_bias(kseg[e >> 1], st[c]);
          s[n][e] = q0 + c < s_q ? __expf(fminf(x - lt[c], 30.f)) : 0.f;
        }
      uint32_t pf[KM][4];
      c_to_a<KM>(pf, s);

      if (jn < n_tiles) {
        tc::cp_async_wait<2>();  // this tile's dO and delta
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      // dv += P^T dO.
#pragma unroll
      for (int kk = 0; kk < KM; ++kk)
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t f[4];
          load_b<LD>(f, dot, 16 * kk, 16 * p, lane);
          tc::mma_bf16(dv_acc[2 * p], pf[kk], f[0], f[1]);
          tc::mma_bf16(dv_acc[2 * p + 1], pf[kk], f[2], f[3]);
        }
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in place.
      float dp[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t vf[4];
        load_a<LD>(vf, vs, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t f[4];
          load_bt<LD>(f, dot, 16 * p, 16 * kk, lane);
          tc::mma_bf16(dp[2 * p], vf, f[0], f[1]);
          tc::mma_bf16(dp[2 * p + 1], vf, f[2], f[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          dp[n][e] = s[n][e] * (dp[n][e] - dlt[c]);
        }
      uint32_t df[KM][4];
      c_to_a<KM>(df, dp);
      // dk += dS^T Q.
#pragma unroll
      for (int kk = 0; kk < KM; ++kk)
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          uint32_t f[4];
          load_b<LD>(f, qt, 16 * kk, 16 * p, lane);
          tc::mma_bf16(dk_acc[2 * p], df[kk], f[0], f[1]);
          tc::mma_bf16(dk_acc[2 * p + 1], df[kk], f[2], f[3]);
        }
      buf ^= 1;
      j = jn;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = kv0 + 16 * warp + g + 8 * i;
    if (gr >= s_kv) continue;
    bf16* dkrow = dk + ((size_t)bh * s_kv + gr) * D;
    bf16* dvrow = dv + ((size_t)bh * s_kv + gr) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * i] * scale,
                                dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host launchers: each raises the kernel's dynamic shared-memory limit (above
// the 48 KB default) once per device, launches on the caller's stream and
// returns cudaGetLastError(), so a refused launch reaches the Python wrapper.

// A kernel's dynamic shared-memory limit, raised by its first launch on each
// device. Every later launch, one recorded into a CUDA graph included, makes
// no CUDA call but the launch itself (cudaGetDevice aside). One static
// instance per launcher instantiation and body, so per kernel.
struct SmemLimit {
  std::atomic<unsigned long long> devices{0};  // bit d: raised on device d

  template <typename Kernel>
  cudaError_t raise(Kernel kern, size_t smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (devices.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_release);
    return err;
  }
};

template <typename T, int D, bool kSeg>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               void* out, float* lse, int bh, int heads, int s_q, int s_kv,
               float scale, Seg seg, cudaStream_t stream) {
  dim3 grid((s_q + kRows - 1) / kRows, bh);
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor-core body
    constexpr size_t smem = fwd_mma_smem<D>();
    auto kern = flash_fwd_mma_kernel<D, kSeg>;
    static SmemLimit limit;
    cudaError_t err = limit.raise(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (bf16*)out, lse,
        heads, s_q, s_kv, scale, seg);
    return (int)cudaGetLastError();
  } else {  // float32: the CUDA-core body
    constexpr size_t smem = fwd_smem<D>();
    auto kern = flash_fwd_kernel<D, kSeg>;
    static SmemLimit limit;
    cudaError_t err = limit.raise(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, bias,
        (float*)out, lse, heads, s_q, s_kv, scale, seg);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D, bool kSeg>
int launch_dq(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* delta, void* dq,
              int bh, int heads, int s_q, int s_kv, float scale, Seg seg,
              cudaStream_t stream) {
  dim3 grid((s_q + kRows - 1) / kRows, bh);
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor-core body
    constexpr size_t smem = dq_mma_smem<D>();
    auto kern = flash_dq_mma_kernel<D, kSeg>;
    static SmemLimit limit;
    cudaError_t err = limit.raise(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, bias,
        (const bf16*)dout, lse, delta, (bf16*)dq, heads, s_q, s_kv, scale,
        seg);
    return (int)cudaGetLastError();
  } else {  // float32: the CUDA-core body
    constexpr size_t smem = dq_smem<D>();
    auto kern = flash_dq_kernel<D, kSeg>;
    static SmemLimit limit;
    cudaError_t err = limit.raise(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, bias,
        (const float*)dout, lse, delta, (float*)dq, heads, s_q, s_kv, scale,
        seg);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D, bool kSeg>
int launch_dkv(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int bh, int heads, int s_q, int s_kv,
               float scale, Seg seg, cudaStream_t stream) {
  dim3 grid((s_kv + kRows - 1) / kRows, bh);
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor-core body
    constexpr size_t smem = dkv_mma_smem<D>();
    auto kern = flash_dkv_mma_kernel<D, kSeg>;
    static SmemLimit limit;
    cudaError_t err = limit.raise(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, bias,
        (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv, heads, s_q, s_kv,
        scale, seg);
    return (int)cudaGetLastError();
  } else {  // float32: the CUDA-core body
    constexpr size_t smem = dkv_smem<D>();
    auto kern = flash_dkv_kernel<D, kSeg>;
    static SmemLimit limit;
    cudaError_t err = limit.raise(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, bias,
        (const float*)dout, lse, delta, (float*)dk, (float*)dv, heads, s_q,
        s_kv, scale, seg);
    return (int)cudaGetLastError();
  }
}

// Dispatch on (head_dim, dtype); anything else is refused with
// cudaErrorInvalidValue (the Python wrapper checks first).
#define LDDL_DISPATCH(FN, SEG, ...)                                    \
  switch (head_dim * 2 + (is_bf16 ? 1 : 0)) {                          \
    case 64: return FN<float, 32, SEG>(__VA_ARGS__);                   \
    case 65: return FN<__nv_bfloat16, 32, SEG>(__VA_ARGS__);           \
    case 128: return FN<float, 64, SEG>(__VA_ARGS__);                  \
    case 129: return FN<__nv_bfloat16, 64, SEG>(__VA_ARGS__);          \
    case 256: return FN<float, 128, SEG>(__VA_ARGS__);                 \
    case 257: return FN<__nv_bfloat16, 128, SEG>(__VA_ARGS__);         \
    default: return (int)cudaErrorInvalidValue;                        \
  }

Seg make_seg(const void* q_seg, const void* kv_seg, const void* q_iv,
             const void* kv_iv) {
  return Seg{(const int*)q_seg, (const int*)kv_seg, (const int*)q_iv,
             (const int*)kv_iv};
}

}  // namespace

extern "C" {

int lddl_flash_fwd(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int bh, int heads,
                   int s_q, int s_kv, int head_dim, int is_bf16, float scale,
                   void* stream) {
  LDDL_DISPATCH(launch_fwd, false, q, k, v, (const float*)bias, out,
                (float*)lse, bh, heads, s_q, s_kv, scale, Seg{},
                (cudaStream_t)stream)
}

int lddl_flash_dq(const void* q, const void* k, const void* v,
                  const void* bias, const void* dout, const void* lse,
                  const void* delta, void* dq, int bh, int heads, int s_q,
                  int s_kv, int head_dim, int is_bf16, float scale,
                  void* stream) {
  LDDL_DISPATCH(launch_dq, false, q, k, v, (const float*)bias, dout,
                (const float*)lse, (const float*)delta, dq, bh, heads, s_q,
                s_kv, scale, Seg{}, (cudaStream_t)stream)
}

int lddl_flash_dkv(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int bh, int heads,
                   int s_q, int s_kv, int head_dim, int is_bf16, float scale,
                   void* stream) {
  LDDL_DISPATCH(launch_dkv, false, q, k, v, (const float*)bias, dout,
                (const float*)lse, (const float*)delta, dk, dv, bh, heads, s_q,
                s_kv, scale, Seg{}, (cudaStream_t)stream)
}

// K4 launchers: the segment-free signature plus the int32 segment ids of
// the q and kv rows ([batch, s]) and the tile intervals ([batch, n_tiles,
// 2]): q_iv at 64 rows and kv_iv at tile_n<D>() rows for fwd and dq, q_iv
// at tile_n<D>() and kv_iv at 64 for dkv (each kernel's owned and streamed
// tile widths).

int lddl_flash_fwd_seg(const void* q, const void* k, const void* v,
                       const void* bias, const void* q_seg,
                       const void* kv_seg, const void* q_iv,
                       const void* kv_iv, void* out, void* lse, int bh,
                       int heads, int s_q, int s_kv, int head_dim,
                       int is_bf16, float scale, void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_iv, kv_iv);
  LDDL_DISPATCH(launch_fwd, true, q, k, v, (const float*)bias, out,
                (float*)lse, bh, heads, s_q, s_kv, scale, seg,
                (cudaStream_t)stream)
}

int lddl_flash_dq_seg(const void* q, const void* k, const void* v,
                      const void* bias, const void* q_seg, const void* kv_seg,
                      const void* q_iv, const void* kv_iv, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh,
                      int heads, int s_q, int s_kv, int head_dim, int is_bf16,
                      float scale, void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_iv, kv_iv);
  LDDL_DISPATCH(launch_dq, true, q, k, v, (const float*)bias, dout,
                (const float*)lse, (const float*)delta, dq, bh, heads, s_q,
                s_kv, scale, seg, (cudaStream_t)stream)
}

int lddl_flash_dkv_seg(const void* q, const void* k, const void* v,
                       const void* bias, const void* q_seg,
                       const void* kv_seg, const void* q_iv,
                       const void* kv_iv, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int bh,
                       int heads, int s_q, int s_kv, int head_dim,
                       int is_bf16, float scale, void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_iv, kv_iv);
  LDDL_DISPATCH(launch_dkv, true, q, k, v, (const float*)bias, dout,
                (const float*)lse, (const float*)delta, dk, dv, bh, heads, s_q,
                s_kv, scale, seg, (cudaStream_t)stream)
}

// The device's launch counts of the current device, [kKinds] in g_launches
// order, read after the device is idle.
int lddl_flash_launches(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
}

int lddl_flash_reset_launches() {
  const unsigned long long zero[kKinds] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}

const char* lddl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
