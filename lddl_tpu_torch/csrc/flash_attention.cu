// Flash attention for Hopper (sm_90a): forward (K1), dq (K2), dk/dv (K3).
//
// Layout: q/k/v/out and their gradients are contiguous [bh, s, d] with
// bh = batch * heads; lse and delta are [bh, s_q] float32; the key bias is
// [batch, s_kv] float32 holding 0 (attend) or -1e9 (padding), shared by the
// heads of one batch row. scale = 1/sqrt(d). Inputs are float32 or bfloat16;
// every product and sum runs in float32, as the TPU bodies upcast with
// astype(f32). Outputs are written in the input dtype, lse in float32.
//
// What bounds these kernels on the H100: they run their matrix products as
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16), so they are bound by operations, far from the card's
// bound for the same work. Tensor cores (mma.sync / wgmma) and TMA loads come
// in a later PR; the design here is the simple correct one: one CTA owns a
// 64-row tile, a loop inside the CTA replaces the TPU's sequential grid axis,
// the streamed tiles are staged through shared memory as float32, and each
// thread keeps a 4 x (width/16) block of the running sums in registers.
//
// Ragged edge: each kernel masks its own edge by bounds checks (no host-side
// zero padding). Key columns at or past s_kv take no part in any sum, which
// equals the TPU wrapper's -1e9-biased padding columns for every query row
// with at least one attended key. A row with no attended key is outside that
// parity domain: here its softmax runs over the s_kv real (all -1e9 biased)
// keys, i.e. it returns the mean of V over them, where the TPU path also
// averages in its zero padding columns.
//
// No atomics anywhere: dq and dk/dv are separate kernels and each output
// element is summed by one thread in a fixed order, so gradients are bitwise
// repeatable from run to run.
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
// same two ints in every thread, so all threads skip together. A live tile
// adds the elementwise same-document bias (0 or -1e9) on top of the key bias,
// in every live tile, so the result is right for any ids (the interval test
// only ever keeps a tile too many, never one too few).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kRows = 64;       // rows of the tile one CTA owns
constexpr float kNegInf = -1e9f;
constexpr float kLFloor = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + n) of a [len, D] matrix into shared memory as float32
// with row stride D + 1 (conflict-free column reads); rows >= len become 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n, int len) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < len ? to_f32(src[(size_t)gr * D + c]) : 0.f;
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
template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr int BN = tile_n<D>();
  return sizeof(float) * (kRows * (D + 1) + 2 * BN * (D + 1) +
                          kRows * (BN + 1) + 3 * kRows);
}

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, float* __restrict__ lse, int heads,
                     int s_q, int s_kv, float scale, Seg seg) {
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
  const T* qb = q + (size_t)bh * s_q * D;
  const T* kb = k + (size_t)bh * s_kv * D;
  const T* vb = v + (size_t)bh * s_kv * D;
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

  load_tile<T, D>(qs, qb, q0, kRows, s_q);
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
    load_tile<T, D>(ks, kb, kv0, BN, s_kv);
    load_tile<T, D>(vs, vb, kv0, BN, s_kv);
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
    T* orow = out + ((size_t)bh * s_q + gr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
    if (tx == 0) lse[(size_t)bh * s_q + gr] = m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// K2: dq. Replaces lddl_tpu/ops/flash_attention.py:_dq_kernel (driven by
// _flash_bwd). One CTA per (64-row q tile, bh), looping over kv tiles:
// dq = scale * sum_kv (P * (dO V^T - delta)) K with P = exp(s - lse), no clamp.
//
// K4-dq (kSeg): replaces _dq_kernel with segment refs. A disjoint kv tile
// would add exactly zero (P underflows against its -1e9 bias), so it is
// skipped before its load, as in K4-fwd; live tiles add the same-document
// bias. Bound as K2: float32 CUDA-core operations over the live tiles.
template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr int BN = tile_n<D>();
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * BN * (D + 1) +
                          kRows * (BN + 1) + 2 * kRows);
}

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int s_q, int s_kv, float scale, Seg seg) {
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
  const T* kb = k + (size_t)bh * s_kv * D;
  const T* vb = v + (size_t)bh * s_kv * D;
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

  load_tile<T, D>(qs, q + (size_t)bh * s_q * D, q0, kRows, s_q);
  load_tile<T, D>(dos, dout + (size_t)bh * s_q * D, q0, kRows, s_q);
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
    load_tile<T, D>(ks, kb, kv0, BN, s_kv);
    load_tile<T, D>(vs, vb, kv0, BN, s_kv);
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
    T* row = dq + ((size_t)bh * s_q + gr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
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
template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr int BM = tile_n<D>();
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * BM * (D + 1) +
                          2 * kRows * (BM + 1) + 2 * BM + kRows);
}

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int s_q, int s_kv,
                     float scale, Seg seg) {
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
  const T* qb = q + (size_t)bh * s_q * D;
  const T* dob = dout + (size_t)bh * s_q * D;
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

  load_tile<T, D>(ks, k + (size_t)bh * s_kv * D, kv0, kRows, s_kv);
  load_tile<T, D>(vs, v + (size_t)bh * s_kv * D, kv0, kRows, s_kv);
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
    load_tile<T, D>(qs, qb, q0, BM, s_q);
    load_tile<T, D>(dos, dob, q0, BM, s_q);
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
    T* dkrow = dk + ((size_t)bh * s_kv + gr) * D;
    T* dvrow = dv + ((size_t)bh * s_kv + gr) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dkrow[tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dvrow[tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host launchers: each sets the kernel's dynamic shared-memory limit (above
// the 48 KB default), launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

template <typename T, int D, bool kSeg>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               void* out, float* lse, int bh, int heads, int s_q, int s_kv,
               float scale, Seg seg, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<T, D>();
  auto kern = flash_fwd_kernel<T, D, kSeg>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_q + kRows - 1) / kRows, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, lse, heads, s_q,
      s_kv, scale, seg);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kSeg>
int launch_dq(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* delta, void* dq,
              int bh, int heads, int s_q, int s_kv, float scale, Seg seg,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem<T, D>();
  auto kern = flash_dq_kernel<T, D, kSeg>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_q + kRows - 1) / kRows, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)dout, lse, delta,
      (T*)dq, heads, s_q, s_kv, scale, seg);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kSeg>
int launch_dkv(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int bh, int heads, int s_q, int s_kv,
               float scale, Seg seg, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<T, D>();
  auto kern = flash_dkv_kernel<T, D, kSeg>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_kv + kRows - 1) / kRows, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, heads, s_q, s_kv, scale, seg);
  return (int)cudaGetLastError();
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

const char* lddl_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
