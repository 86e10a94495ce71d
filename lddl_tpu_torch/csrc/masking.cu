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
// XLA computes it. The k smallest (uniform, position) keys win -- the
// stable argsort's tie order -- and 80/10/10 follows from the kd and kr
// draws at each picked position.
//
// What bounds them on this card: the int32 operations of the draws (a
// threefry, ~73 operations, at every valid position and three more at each
// picked one); M2's bytes (its [n, L] int32 read and int32 + uint8 writes)
// come close behind. The work that picks the k positions is not in that
// bound, so the design keeps it small next to the draws:
//
//   - One warp a row, several rows a CTA, no block barrier. Each lane owns
//     one contiguous run of the row's positions, split over min(row_len, L),
//     not over L: padding gets no key and no work. A key is the uniform's
//     23 bits (the float is exactly bits * 2**-23, so they order and tie as
//     the float does); a position that draws nothing is keyed above them.
//     Rows of up to kRegSeqLen positions keep their keys in registers (at
//     most 32 a lane); longer ones, up to kMaxSeqLen, in shared memory,
//     key j of lane i at j * 32 + i (no bank conflict).
//   - The threshold: the k-th smallest key by a descent over its 23 bits,
//     each step one count of the keys under a candidate (per lane, summed
//     by __reduce_add_sync). It stops early at a candidate with exactly k
//     keys under it, which random keys reach in about a dozen steps.
//   - Order without a sort: the picks are the keys under the threshold and
//     the lowest-positioned (k - count under it) keys equal to it. One
//     exclusive warp scan of each lane's (under, equal) counts gives each
//     lane its tie quota and its first output slot: its picks are
//     ascending, and so are the lanes' runs.
//   - Memory: the picked positions go to the warp's shared slots; the
//     80/10/10 draws then run a slot a lane, converged, and M1 reads the
//     flat ids only at picked positions. M2 writes its [n, L] outputs
//     coalesced (lane i at i, i + 32, ...) from a picked-flag byte a
//     position in shared memory, and the picked positions' masked ids from
//     the slots.
//
// Plain C interface, loaded with ctypes (lddl_tpu_torch/ops/_build.py);
// each launcher returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSeqLen = 8192;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegSeqLen = 1024;   // keys in registers up to this row width
constexpr int kKeyBits = 23;       // the uniform's bits
constexpr uint32_t kNoKey = 0xffffffffu;  // a position that draws nothing
constexpr int kRegWarps = 8;       // rows (warps) a CTA, keys in registers
constexpr int kSmemBudget = 112 * 1024;  // a CTA's shared memory, keys in smem

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

// A lane's keys: C in registers (the loop fully unrolled, so every index is
// a constant)...
template <int C>
struct RegKeys {
  uint32_t v[C];
  __device__ __forceinline__ RegKeys(unsigned char*, int) {}
  template <typename F>
  __device__ __forceinline__ void each(int c, F f) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (j < c) f(j, v[j]);
  }
};

// ...or in the warp's shared memory, lane-interleaved.
struct SmemKeys {
  uint32_t* s;
  __device__ __forceinline__ SmemKeys(unsigned char* warp_smem, int lane)
      : s(reinterpret_cast<uint32_t*>(warp_smem) + lane) {}
  template <typename F>
  __device__ __forceinline__ void each(int c, F f) {
    for (int j = 0; j < c; ++j) f(j, s[j * kWarp]);
  }
};

// C keys a lane in registers, or C == 0: in shared memory.
template <int C>
using KeysOf = std::conditional_t<C == 0, SmemKeys, RegKeys<C>>;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// A warp's shared memory: [keys (C == 0 only)] [slots: L int16]
// [flags: L bytes (M2 only)].
__host__ __device__ __forceinline__ int key_bytes(int L, bool smem_keys) {
  return smem_keys ? 4 * kWarp * ((L + kWarp - 1) / kWarp) : 0;
}
__host__ __device__ __forceinline__ int warp_bytes(int L, bool smem_keys,
                                                   bool flags) {
  return key_bytes(L, smem_keys) + round16(2 * L) + (flags ? round16(L) : 0);
}

// Exclusive prefix sum of x over the warp's lanes; *total the warp's sum.
__device__ __forceinline__ int warp_exclusive_scan(int x, int lane,
                                                   int* total) {
  int s = x;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s += y;
  }
  *total = __shfl_sync(kFull, s, kWarp - 1);
  return s - x;
}

// Draw the uniform at each valid position of the lane's run [lo, lo + c)
// (clipped to npos) into keys; returns the row's count of valid positions.
template <typename Keys, typename Valid>
__device__ __forceinline__ int draw_row_keys(Keys& keys, const Draw& d,
                                         uint64_t base, int lo, int c,
                                         int npos, Valid valid) {
  int mine = 0;
  keys.each(c, [&](int j, uint32_t& key) {
    const int p = lo + j;
    key = kNoKey;
    if (p < npos && valid(p)) {
      key = threefry_bits(d.ku, base + p) >> 9;
      ++mine;
    }
  });
  return __reduce_add_sync(kFull, mine);
}

// The k smallest (key, position) of the row, ascending by position, into
// slots[0, k); each picked position p also calls mark(p).
template <typename Keys, typename Mark>
__device__ __forceinline__ void select_row(Keys& keys, int lane, int lo,
                                           int c, int k, int16_t* slots,
                                           Mark mark) {
  // The threshold t: the largest value with fewer than k keys under it (the
  // k-th smallest key), or the first candidate with exactly k under it.
  uint32_t t = 0;
  if (k > 0) {
    for (int b = kKeyBits - 1; b >= 0; --b) {
      const uint32_t cand = t | (1u << b);
      int mine = 0;
      keys.each(c, [&](int, uint32_t& key) { mine += key < cand; });
      const int under = __reduce_add_sync(kFull, mine);
      if (under <= k) t = cand;
      if (under == k) break;
    }
  }
  int under = 0, equal = 0;
  keys.each(c, [&](int, uint32_t& key) {
    under += key < t;
    equal += key == t;
  });
  int total;  // under in the low 16 bits, equal in the high (each <= 8192)
  const int before = warp_exclusive_scan(under | (equal << 16), lane, &total);
  const int quota = k - (total & 0xffff);  // ties picked, lowest first
  int eq_rank = before >> 16;
  int slot = (before & 0xffff) + min(quota, eq_rank);
  keys.each(c, [&](int j, uint32_t& key) {
    bool pick = key < t;
    if (key == t) pick = eq_rank++ < quota;
    if (pick) {
      slots[slot++] = static_cast<int16_t>(lo + j);
      mark(lo + j);
    }
  });
  __syncwarp();
}

// C: keys a lane holds in registers (L <= 32 * C), or 0: in shared memory.
template <typename T, int C>
__global__ void __launch_bounds__(kWarp * kRegWarps) mask_partition_kernel(
    const T* __restrict__ flat, int64_t flat_len,
    const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
    const int32_t* __restrict__ b0, const int32_t* __restrict__ b1, int n,
    int L, int max_pred, int P, int cls_id, int sep_id, Draw d,
    int16_t* __restrict__ out_pos, int32_t* __restrict__ out_new,
    int32_t* __restrict__ out_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                    warp;
  if (r >= n) return;  // the whole warp: its row is past the end
  unsigned char* ws = smem + static_cast<size_t>(warp) *
                                 warp_bytes(L, C == 0, false);
  int16_t* slots = reinterpret_cast<int16_t*>(ws + key_bytes(L, C == 0));
  KeysOf<C> keys(ws, lane);

  const int ra0 = a0[r], rb0 = b0[r];
  const int la = a1[r] - ra0, lb = b1[r] - rb0;
  const int row_len = la + lb + 3;
  const uint64_t base = static_cast<uint64_t>(r) * static_cast<uint64_t>(L);
  const int npos = max(0, min(row_len, L));  // every valid position is below
  const int c = (npos + kWarp - 1) / kWarp;
  const int lo = lane * c;
  const auto in_a = [&](int p) { return p >= 1 && p < 1 + la; };
  const auto in_b = [&](int p) { return p >= 2 + la && p < 2 + la + lb; };
  const int nvalid = draw_row_keys(
      keys, d, base, lo, c, npos, [&](int p) { return in_a(p) || in_b(p); });
  const int k = pick_count(d, row_len, nvalid, max_pred);
  select_row(keys, lane, lo, c, k, slots, [](int) {});

  // The ids at min(pos, L - 1): the last slot's position is the row's
  // largest pick, so L - 1 is picked exactly when it is there.
  const bool last_picked = k > 0 && slots[k - 1] == L - 1;
  for (int j = lane; j < P; j += kWarp) {
    const int p = j < k ? slots[j] : L;
    const int q = min(p, L - 1);
    int32_t v;
    if (q == 0) {
      v = cls_id;
    } else if (q == 1 + la || q == row_len - 1) {
      v = sep_id;
    } else if (in_a(q) || in_b(q)) {
      int64_t g = in_a(q) ? static_cast<int64_t>(ra0) + q - 1
                          : static_cast<int64_t>(rb0) + q - 2 - la;
      g = g < 0 ? 0 : (g >= flat_len ? flat_len - 1 : g);  // mode='clip'
      v = static_cast<int32_t>(flat[g]);
    } else {
      v = 0;
    }
    if (j < k || last_picked) v = masked_id(d, base + q, v);
    out_pos[r * P + j] = static_cast<int16_t>(p);
    out_new[r * P + j] = v;
  }
  if (lane == 0) out_k[r] = k;
}

template <int C>
__global__ void __launch_bounds__(kWarp * kRegWarps) mask_matrix_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ row_len,
    const int32_t* __restrict__ na, int n, int L, int max_pred, Draw d,
    int32_t* __restrict__ out_masked, uint8_t* __restrict__ out_picked) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                    warp;
  if (r >= n) return;
  unsigned char* ws = smem + static_cast<size_t>(warp) *
                                 warp_bytes(L, C == 0, true);
  int16_t* slots = reinterpret_cast<int16_t*>(ws + key_bytes(L, C == 0));
  uint8_t* flags = reinterpret_cast<uint8_t*>(slots) + round16(2 * L);
  KeysOf<C> keys(ws, lane);

  for (int i = lane; i < round16(L) / 4; i += kWarp)
    reinterpret_cast<uint32_t*>(flags)[i] = 0;
  const int rl = row_len[r], rna = na[r];
  const uint64_t base = static_cast<uint64_t>(r) * static_cast<uint64_t>(L);
  const int npos = max(0, min(rl, L));
  const int c = (npos + kWarp - 1) / kWarp;
  const int lo = lane * c;
  const int nvalid = draw_row_keys(keys, d, base, lo, c, npos, [&](int p) {
    return p != 0 && p != 1 + rna && p != rl - 1;
  });
  const int k = pick_count(d, rl, nvalid, max_pred);
  __syncwarp();  // the flags are zero
  select_row(keys, lane, lo, c, k, slots, [&](int p) { flags[p] = 1; });

  const int64_t row = r * L;
  for (int p = lane; p < L; p += kWarp) {
    const uint8_t f = flags[p];
    if (!f) out_masked[row + p] = ids[row + p];
    out_picked[row + p] = f;
  }
  for (int j = lane; j < k; j += kWarp) {
    const int p = slots[j];
    out_masked[row + p] = masked_id(d, base + p, ids[row + p]);
  }
}

// Rows a CTA (one warp each) and its dynamic shared memory.
struct Shape {
  int warps;
  size_t smem;
};

Shape shape_for(int L, bool flags) {
  const bool smem_keys = L > kRegSeqLen;
  const int per_warp = warp_bytes(L, smem_keys, flags);
  int warps = kRegWarps;
  if (smem_keys) warps = max(1, min(kRegWarps, kSmemBudget / per_warp));
  return {warps, static_cast<size_t>(warps) * per_warp};
}

// Above 48 KB a kernel must be allowed its dynamic shared memory first;
// raised once for the largest size asked, outside any stream capture after
// the first launch at that size.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *allowed = bytes;
  return err;
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

template <typename T, int C>
cudaError_t launch_partition(const T* flat, long long flat_len,
                             const int32_t* a0, const int32_t* a1,
                             const int32_t* b0, const int32_t* b1, int n,
                             int L, int max_pred, int P, int cls_id,
                             int sep_id, const Draw& d, int16_t* out_pos,
                             int32_t* out_new, int32_t* out_k,
                             cudaStream_t st) {
  static size_t allowed = 0;
  const Shape sh = shape_for(L, false);
  auto kernel = mask_partition_kernel<T, C>;
  const cudaError_t err = allow_smem(kernel, sh.smem, &allowed);
  if (err != cudaSuccess) return err;
  const int blocks = (n + sh.warps - 1) / sh.warps;
  kernel<<<blocks, sh.warps * kWarp, sh.smem, st>>>(
      flat, flat_len, a0, a1, b0, b1, n, L, max_pred, P, cls_id, sep_id, d,
      out_pos, out_new, out_k);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_matrix(const int32_t* ids, const int32_t* row_len,
                          const int32_t* na, int n, int L, int max_pred,
                          const Draw& d, int32_t* out_masked,
                          uint8_t* out_picked, cudaStream_t st) {
  static size_t allowed = 0;
  const Shape sh = shape_for(L, true);
  auto kernel = mask_matrix_kernel<C>;
  const cudaError_t err = allow_smem(kernel, sh.smem, &allowed);
  if (err != cudaSuccess) return err;
  const int blocks = (n + sh.warps - 1) / sh.warps;
  kernel<<<blocks, sh.warps * kWarp, sh.smem, st>>>(
      ids, row_len, na, n, L, max_pred, d, out_masked, out_picked);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, C>()) with C the keys a lane holds in
// registers for rows of L positions, or C = 0: in shared memory.
template <typename F>
cudaError_t with_key_form(int L, F f) {
  const int c = (L + kWarp - 1) / kWarp;
  if (c <= 4) return f(std::integral_constant<int, 4>());
  if (c <= 8) return f(std::integral_constant<int, 8>());
  if (c <= 16) return f(std::integral_constant<int, 16>());
  if (c <= kRegSeqLen / kWarp) return f(std::integral_constant<int, 32>());
  return f(std::integral_constant<int, 0>());
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
  const Draw d = make_draw(keys8, span, mult, ratio, mask_id);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_key_form(L, [&](auto form) {
    constexpr int C = decltype(form)::value;
    if (flat_u16)
      return launch_partition<uint16_t, C>(
          static_cast<const uint16_t*>(flat), flat_len, a0, a1, b0, b1, n, L,
          max_pred, P, cls_id, sep_id, d, out_pos, out_new, out_k, st);
    return launch_partition<int32_t, C>(
        static_cast<const int32_t*>(flat), flat_len, a0, a1, b0, b1, n, L,
        max_pred, P, cls_id, sep_id, d, out_pos, out_new, out_k, st);
  });
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
  const Draw d = make_draw(keys8, span, mult, ratio, mask_id);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_key_form(L, [&](auto form) {
    return launch_matrix<decltype(form)::value>(
        ids, row_len, na, n, L, max_pred, d, out_masked, out_picked, st);
  });
}

const char* lddl_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
