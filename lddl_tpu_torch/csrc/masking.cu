// Static MLM masking on the H100: the two device programs of
// lddl_tpu/ops/masking.py, bit for bit.
//
//   - lddl_mask_partition (M1, the jit program _partition_kernel,
//     lddl_tpu/ops/masking.py:494): gathers each [CLS] A [SEP] B [SEP] row
//     out of the partition's flat id array, draws its MLM masking and
//     writes the sorted picked positions (padded with seq_len, int16), the
//     post-masking ids at those positions (at min(pos, seq_len - 1) in the
//     padding slots) and k;
//   - lddl_mask_matrix (M2, _device_kernel, :414): the same draw over a
//     padded id matrix, writing the masked matrix and the picked bitmap.
//
// The draw is JAX's under jax_default_prng_impl = threefry2x32 and
// jax_threefry_partitionable = True: the host splits PRNGKey(seed) into
// (ku, kd, kr) and kr into randint's two keys; element (r, p) of an [n, L]
// draw is threefry2x32(key, hi, lo) of the 64-bit counter r * L + p, its
// two output words XORed. uniform() takes the top 23 bits as a float in
// [1, 2) minus 1; randint(0, vocab) is JAX's two-draw remainder form in
// wrapping uint32 arithmetic. k = min(max(1, rint(float32(row_len) *
// float32(ratio))), the row's valid positions, max_pred), in float32 as
// XLA computes it. The k smallest (uniform bits, position) keys win -- the
// stable argsort's tie order -- and 80/10/10 follows from the kd and kr
// draws at each picked position.
//
// One CTA per row. Each thread computes the threefry counters of its
// positions, the keys (uint64: float bits << 32 | position; invalid
// positions keyed 2.0) are sorted by a bitonic network in shared memory,
// the first k mark their positions, and a block-wide exclusive scan over
// those flags writes the positions in ascending order. Rows of up to
// kMaxSeqLen positions; the host wrapper refuses longer ones.
//
// Plain C interface, loaded with ctypes (lddl_tpu_torch/ops/_build.py);
// each launcher returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeqLen = 8192;
constexpr uint32_t kInvalidKey = 0x40000000u;  // the bits of 2.0f

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: JAX's _threefry2x32_lowering, unrolled.
__device__ __forceinline__ uint32_t threefry_bits(Key key, uint64_t count) {
  const uint32_t k0 = key.k0, k1 = key.k1, k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(count >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(count) + k1;
#define LDDL_ROUND(r) \
  x0 += x1;           \
  x1 = rotl(x1, r) ^ x0;
  LDDL_ROUND(13) LDDL_ROUND(15) LDDL_ROUND(26) LDDL_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  LDDL_ROUND(17) LDDL_ROUND(29) LDDL_ROUND(16) LDDL_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  LDDL_ROUND(13) LDDL_ROUND(15) LDDL_ROUND(26) LDDL_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  LDDL_ROUND(17) LDDL_ROUND(29) LDDL_ROUND(16) LDDL_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  LDDL_ROUND(13) LDDL_ROUND(15) LDDL_ROUND(26) LDDL_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef LDDL_ROUND
  return x0 ^ x1;
}

// jax.random.uniform(key, shape, float32) at one counter.
__device__ __forceinline__ float uniform01(Key key, uint64_t count) {
  return __uint_as_float((threefry_bits(key, count) >> 9) | 0x3f800000u) -
         1.0f;
}

struct Draw {
  Key ku, kd, kr0, kr1;  // uniform keys, decide, randint's two keys
  uint32_t span, mult;   // vocab, and (2**16 % span)**2 % span (uint32)
  float ratio;
  int mask_id;
};

// jax.random.randint(kr, shape, 0, span, int32) at one counter.
__device__ __forceinline__ int32_t rand_id(const Draw& d, uint64_t count) {
  const uint32_t hi = threefry_bits(d.kr0, count);
  const uint32_t lo = threefry_bits(d.kr1, count);
  const uint32_t off = (hi % d.span) * d.mult + lo % d.span;
  return static_cast<int32_t>(off % d.span);
}

// The post-masking id of a picked position.
__device__ __forceinline__ int32_t masked_id(const Draw& d, uint64_t count,
                                             int32_t original) {
  const float decide = uniform01(d.kd, count);
  if (decide < 0.8f) return d.mask_id;
  if (decide >= 0.9f) return rand_id(d, count);
  return original;
}

__device__ __forceinline__ int pick_count(const Draw& d, int row_len,
                                          int nvalid, int max_pred) {
  int k = static_cast<int>(rintf(__fmul_rn(static_cast<float>(row_len),
                                           d.ratio)));
  k = max(1, k);
  if (max_pred >= 0) k = min(k, max_pred);
  return min(k, nvalid);
}

// Shared memory: keys[lp] (uint64), flags[L] (int), sums[blockDim] (int).
// After the sort the keys' space holds the ascending picked positions.
__device__ __forceinline__ void sort_keys(uint64_t* keys, int lp) {
  for (int size = 2; size <= lp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < (lp >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const uint64_t a = keys[lo], b = keys[hi];
        if ((a > b) == ascending) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

// Mark the first k sorted keys' positions in flags[0, L), then write the
// marked positions in ascending order to out_pos (shared, reusing the
// keys' space) by an exclusive scan over per-thread chunk counts.
__device__ void pick_in_order(uint64_t* keys, int* flags, int* sums, int L,
                              int k, int* out_pos) {
  for (int p = threadIdx.x; p < L; p += blockDim.x) flags[p] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    flags[static_cast<uint32_t>(keys[j])] = 1;
  __syncthreads();  // keys are dead from here: out_pos may overwrite them
  const int t = threadIdx.x, nt = blockDim.x;
  const int chunk = (L + nt - 1) / nt;
  const int lo = min(L, t * chunk), hi = min(L, lo + chunk);
  int mine = 0;
  for (int p = lo; p < hi; ++p) mine += flags[p];
  sums[t] = mine;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {  // Hillis-Steele inclusive scan
    const int add = t >= off ? sums[t - off] : 0;
    __syncthreads();
    sums[t] += add;
    __syncthreads();
  }
  int slot = sums[t] - mine;
  for (int p = lo; p < hi; ++p)
    if (flags[p]) out_pos[slot++] = p;
  __syncthreads();
}

template <typename T>
__global__ void mask_partition_kernel(
    const T* __restrict__ flat, int64_t flat_len,
    const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
    const int32_t* __restrict__ b0, const int32_t* __restrict__ b1, int L,
    int lp, int max_pred, int P, int cls_id, int sep_id, Draw d,
    int16_t* __restrict__ out_pos, int32_t* __restrict__ out_new,
    int32_t* __restrict__ out_k) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;
  int* flags = reinterpret_cast<int*>(keys + lp);
  int* sums = flags + L;
  __shared__ int nvalid;
  const int64_t r = blockIdx.x;
  const int ra0 = a0[r], rb0 = b0[r];
  const int la = a1[r] - ra0, lb = b1[r] - rb0;
  const int row_len = la + lb + 3;
  const uint64_t base = static_cast<uint64_t>(r) * static_cast<uint64_t>(L);
  if (threadIdx.x == 0) nvalid = 0;
  __syncthreads();
  int mine = 0;
  for (int p = threadIdx.x; p < lp; p += blockDim.x) {
    uint64_t key = ~0ull;
    if (p < L) {
      const bool valid = (p >= 1 && p < 1 + la) ||
                         (p >= 2 + la && p < 2 + la + lb);
      mine += valid;
      const uint32_t bits =
          valid ? __float_as_uint(uniform01(d.ku, base + p)) : kInvalidKey;
      key = (static_cast<uint64_t>(bits) << 32) | static_cast<uint32_t>(p);
    }
    keys[p] = key;
  }
  atomicAdd(&nvalid, mine);
  sort_keys(keys, lp);  // starts with a barrier: nvalid is complete
  const int k = pick_count(d, row_len, nvalid, max_pred);
  int* pos = reinterpret_cast<int*>(keys);
  pick_in_order(keys, flags, sums, L, k, pos);
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    const int p = j < k ? pos[j] : L;
    const int q = min(p, L - 1);
    int32_t v;
    if (q == 0) {
      v = cls_id;
    } else if (q == 1 + la || q == row_len - 1) {
      v = sep_id;
    } else {
      const bool in_a = q >= 1 && q < 1 + la;
      const bool in_b = q >= 2 + la && q < 2 + la + lb;
      if (in_a || in_b) {
        int64_t g = in_a ? static_cast<int64_t>(ra0) + q - 1
                         : static_cast<int64_t>(rb0) + q - 2 - la;
        g = g < 0 ? 0 : (g >= flat_len ? flat_len - 1 : g);  // mode='clip'
        v = static_cast<int32_t>(flat[g]);
      } else {
        v = 0;
      }
    }
    if (flags[q]) v = masked_id(d, base + q, v);
    out_pos[r * P + j] = static_cast<int16_t>(p);
    out_new[r * P + j] = v;
  }
  if (threadIdx.x == 0) out_k[r] = k;
}

__global__ void mask_matrix_kernel(const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ row_len,
                                   const int32_t* __restrict__ na, int L,
                                   int lp, int max_pred, Draw d,
                                   int32_t* __restrict__ out_masked,
                                   uint8_t* __restrict__ out_picked) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;
  int* flags = reinterpret_cast<int*>(keys + lp);
  int* sums = flags + L;
  __shared__ int nvalid;
  const int64_t r = blockIdx.x;
  const int rl = row_len[r], rna = na[r];
  const uint64_t base = static_cast<uint64_t>(r) * static_cast<uint64_t>(L);
  if (threadIdx.x == 0) nvalid = 0;
  __syncthreads();
  int mine = 0;
  for (int p = threadIdx.x; p < lp; p += blockDim.x) {
    uint64_t key = ~0ull;
    if (p < L) {
      const bool special = p == 0 || p == 1 + rna || p == rl - 1;
      const bool valid = p < rl && !special;
      mine += valid;
      const uint32_t bits =
          valid ? __float_as_uint(uniform01(d.ku, base + p)) : kInvalidKey;
      key = (static_cast<uint64_t>(bits) << 32) | static_cast<uint32_t>(p);
    }
    keys[p] = key;
  }
  atomicAdd(&nvalid, mine);
  sort_keys(keys, lp);
  const int k = pick_count(d, rl, nvalid, max_pred);
  pick_in_order(keys, flags, sums, L, k, reinterpret_cast<int*>(keys));
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    const int64_t at = r * L + p;
    int32_t v = ids[at];
    if (flags[p]) v = masked_id(d, base + p, v);
    out_masked[at] = v;
    out_picked[at] = static_cast<uint8_t>(flags[p]);
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Threads per CTA: one compare-exchange each per bitonic stage.
int threads_for(int lp) {
  int t = lp / 2;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return t;
}

size_t smem_for(int L, int lp, int threads) {
  return static_cast<size_t>(lp) * 8 + static_cast<size_t>(L) * 4 +
         static_cast<size_t>(threads) * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

Draw make_draw(const unsigned* keys8, unsigned span, unsigned mult,
               float ratio, int mask_id) {
  Draw d;
  d.ku = {keys8[0], keys8[1]};
  d.kd = {keys8[2], keys8[3]};
  d.kr0 = {keys8[4], keys8[5]};
  d.kr1 = {keys8[6], keys8[7]};
  d.span = span;
  d.mult = mult;
  d.ratio = ratio;
  d.mask_id = mask_id;
  return d;
}

}  // namespace

extern "C" {

int lddl_mask_max_seq_len() { return kMaxSeqLen; }

// flat: uint16 (flat_u16 != 0) or int32 ids of the partition; a0/a1/b0/b1
// int32 [n]; keys8: ku, kd, kr0, kr1 as (k0, k1) pairs. Writes out_pos
// int16 [n, P], out_new int32 [n, P], out_k int32 [n].
int lddl_mask_partition(const void* flat, int flat_u16, long long flat_len,
                        const int32_t* a0, const int32_t* a1,
                        const int32_t* b0, const int32_t* b1, int n, int L,
                        int max_pred, int P, int cls_id, int sep_id,
                        int mask_id, const unsigned* keys8, unsigned span,
                        unsigned mult, float ratio, int16_t* out_pos,
                        int32_t* out_new, int32_t* out_k, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (L <= 0 || L > kMaxSeqLen || P <= 0 || P > L || flat_len <= 0)
    return cudaErrorInvalidValue;
  const int lp = pow2_at_least(L);
  const int threads = threads_for(lp);
  const size_t smem = smem_for(L, lp, threads);
  const Draw d = make_draw(keys8, span, mult, ratio, mask_id);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (flat_u16) {
    auto kernel = mask_partition_kernel<uint16_t>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<n, threads, smem, st>>>(
        static_cast<const uint16_t*>(flat), flat_len, a0, a1, b0, b1, L, lp,
        max_pred, P, cls_id, sep_id, d, out_pos, out_new, out_k);
  } else {
    auto kernel = mask_partition_kernel<int32_t>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<n, threads, smem, st>>>(
        static_cast<const int32_t*>(flat), flat_len, a0, a1, b0, b1, L, lp,
        max_pred, P, cls_id, sep_id, d, out_pos, out_new, out_k);
  }
  return cudaGetLastError();
}

// ids int32 [n, L], row_len/na int32 [n]; max_pred < 0: no cap. Writes
// out_masked int32 [n, L] and out_picked uint8 [n, L].
int lddl_mask_matrix(const int32_t* ids, const int32_t* row_len,
                     const int32_t* na, int n, int L, int max_pred,
                     int mask_id, const unsigned* keys8, unsigned span,
                     unsigned mult, float ratio, int32_t* out_masked,
                     uint8_t* out_picked, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (L <= 0 || L > kMaxSeqLen) return cudaErrorInvalidValue;
  const int lp = pow2_at_least(L);
  const int threads = threads_for(lp);
  const size_t smem = smem_for(L, lp, threads);
  cudaError_t err = allow_smem(mask_matrix_kernel, smem);
  if (err != cudaSuccess) return err;
  mask_matrix_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ids, row_len, na, L, lp, max_pred,
      make_draw(keys8, span, mult, ratio, mask_id), out_masked, out_picked);
  return cudaGetLastError();
}

const char* lddl_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
