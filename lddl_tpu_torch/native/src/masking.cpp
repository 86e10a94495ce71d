// Host MLM masking, copied from lddl_tpu/native/src/masking.cpp.
//
// lddl_mask_topk: per-row top-k selection (replaces the numpy
// argpartition + take_along_axis + argsort + nonzero chain in
// lddl_tpu_torch/ops/masking.py's padded-matrix host path). Inputs are the
// tie-free uint64 sort keys (positive-float bit patterns with the lane
// index in the low bits — see mask_batch_host) and the per-row pick
// count k; the output is the picked (row, col) index pairs in row-major
// ascending order, exactly matching np.nonzero(picked) on the boolean
// matrix the numpy path builds — so the downstream decide/replacement
// RNG draws line up draw-for-draw and the masked output is bit-identical.
//
// lddl_mask_partition: the fused ragged path — gather A/B ids, draw the
// masked positions via partial Fisher-Yates with a counter-based
// Philox4x32-10 stream, apply the 80/10/10 recipe, and emit sorted
// positions + original label ids, all in one pass with no padded id
// matrix. The numpy fallback (lddl_tpu_torch/ops/masking.py:_mask_partition_numpy)
// implements the identical draw scheme bit-for-bit; parity is tested
// (tests/test_torch_masking.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void topk_rows(const uint64_t* keys, const int64_t* k, int64_t lo,
               int64_t hi, int64_t l, const int64_t* out_offsets,
               int64_t* out_cols) {
  std::vector<uint64_t> scratch(l);
  for (int64_t r = lo; r < hi; ++r) {
    int64_t kk = k[r];
    if (kk <= 0) continue;
    if (kk > l) kk = l;
    const uint64_t* row = keys + r * l;
    // Keys are unique (lane index in the low bits), so the kth-smallest
    // value is a clean threshold: one nth_element on values, then one
    // ascending scan emits the picked columns already sorted.
    std::copy(row, row + l, scratch.begin());
    std::nth_element(scratch.begin(), scratch.begin() + (kk - 1),
                     scratch.end());
    uint64_t kth = scratch[kk - 1];
    int64_t* out = out_cols + out_offsets[r];
    for (int64_t j = 0; j < l; ++j)
      if (row[j] <= kth) *out++ = j;
  }
}

// --- Philox4x32-10, the shared counter-based stream spec ---------------
//
// Round function and key schedule follow the standard Philox4x32
// construction (round i uses key (k0 + i*W0, k1 + i*W1)); this is the
// masking stream's own specification, mirrored exactly by the numpy
// fallback. Counter layout per draw t of row r:
//   (c0, c1, c2, c3) = (t, r, 0x6d61736b /* "mask" domain */, 0)
// One call yields 4 x 32 bits: x0 drives the Fisher-Yates index, x1 the
// 80/10/10 decide, x2 the replacement vocab id. Bounded draws use
// Lemire's multiply-shift ((uint64)x * n) >> 32; the residual bias at
// vocab-size scale (~30k / 2^32) is < 1e-5 and deterministic.

struct P4 {
  uint32_t v[4];
};

inline P4 philox4x32(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                     uint32_t k0, uint32_t k1) {
  for (uint32_t i = 0; i < 10; ++i) {
    uint32_t ki0 = k0 + i * 0x9E3779B9u;
    uint32_t ki1 = k1 + i * 0xBB67AE85u;
    uint64_t p0 = static_cast<uint64_t>(c0) * 0xD2511F53u;
    uint64_t p1 = static_cast<uint64_t>(c2) * 0xCD9E8D57u;
    uint32_t hi0 = static_cast<uint32_t>(p0 >> 32);
    uint32_t lo0 = static_cast<uint32_t>(p0);
    uint32_t hi1 = static_cast<uint32_t>(p1 >> 32);
    uint32_t lo1 = static_cast<uint32_t>(p1);
    c0 = hi1 ^ c1 ^ ki0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ ki1;
    c3 = lo0;
  }
  return {{c0, c1, c2, c3}};
}

// decide thresholds: floor(0.8 * 2^32) and floor(0.9 * 2^32).
constexpr uint32_t kMaskThreshold = 3435973836u;
constexpr uint32_t kRandThreshold = 3865470566u;

struct Pick {
  int32_t v;        // valid-position index in [0, na + nb)
  uint32_t decide;  // 80/10/10 draw
  int32_t rand_id;  // replacement id (used when decide >= kRandThreshold)
};

void mask_rows(const int32_t* flat_ids, const int64_t* a_ranges,
               const int64_t* b_ranges, int64_t lo, int64_t hi,
               const int64_t* offs_a, const int64_t* offs_b, const int64_t* k,
               const int64_t* offs_k, uint64_t seed, int32_t vocab_size,
               int32_t mask_id, int32_t* flat_a, int32_t* flat_b,
               uint16_t* pos_out, int32_t* label_out) {
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  std::vector<int32_t> arr;
  std::vector<Pick> picks;
  for (int64_t r = lo; r < hi; ++r) {
    const int64_t a0 = a_ranges[2 * r], a1 = a_ranges[2 * r + 1];
    const int64_t b0 = b_ranges[2 * r], b1 = b_ranges[2 * r + 1];
    const int64_t na = a1 - a0, nb = b1 - b0;
    const int64_t L = na + nb;
    int32_t* outa = flat_a + offs_a[r];
    int32_t* outb = flat_b + offs_b[r];
    std::memcpy(outa, flat_ids + a0, na * sizeof(int32_t));
    std::memcpy(outb, flat_ids + b0, nb * sizeof(int32_t));
    int64_t kk = k[r];
    if (kk <= 0) continue;
    if (kk > L) kk = L;
    arr.resize(L);
    for (int64_t i = 0; i < L; ++i) arr[i] = static_cast<int32_t>(i);
    picks.clear();
    for (int64_t t = 0; t < kk; ++t) {
      P4 x = philox4x32(static_cast<uint32_t>(t), static_cast<uint32_t>(r),
                        0x6d61736bu, 0u, k0, k1);
      int64_t j =
          t + static_cast<int64_t>(
                  (static_cast<uint64_t>(x.v[0]) *
                   static_cast<uint64_t>(L - t)) >> 32);
      std::swap(arr[t], arr[j]);
      int32_t rid = static_cast<int32_t>(
          (static_cast<uint64_t>(x.v[2]) *
           static_cast<uint64_t>(vocab_size)) >> 32);
      picks.push_back({arr[t], x.v[1], rid});
    }
    std::sort(picks.begin(), picks.end(),
              [](const Pick& a, const Pick& b) { return a.v < b.v; });
    uint16_t* po = pos_out + offs_k[r];
    int32_t* lb = label_out + offs_k[r];
    for (size_t i = 0; i < picks.size(); ++i) {
      const Pick& p = picks[i];
      const bool in_a = p.v < na;
      // assembled position: [CLS] A [SEP] B [SEP]
      po[i] = static_cast<uint16_t>(in_a ? p.v + 1 : p.v + 2);
      int32_t* dst = in_a ? outa + p.v : outb + (p.v - na);
      lb[i] = *dst;
      if (p.decide < kMaskThreshold) {
        *dst = mask_id;
      } else if (p.decide >= kRandThreshold) {
        *dst = p.rand_id;
      }
    }
  }
}

}  // namespace

extern "C" {

// keys: uint64[n*l] row-major; k: int64[n] (clamped to [0, l]);
// out_offsets: int64[n+1] exclusive prefix sums of k (caller-computed);
// out_cols: int64[out_offsets[n]]. Rows are emitted at their offset, so
// the flat (repeat(rows, k), out_cols) pairing is row-major ascending.
void lddl_mask_topk(const uint64_t* keys, const int64_t* k, int64_t n,
                    int64_t l, const int64_t* out_offsets, int64_t* out_cols,
                    int32_t nthreads) {
  if (nthreads <= 1 || n <= 1) {
    topk_rows(keys, k, 0, n, l, out_offsets, out_cols);
    return;
  }
  if (nthreads > n) nthreads = static_cast<int32_t>(n);
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(topk_rows, keys, k, lo, hi, l, out_offsets,
                         out_cols);
  }
  for (auto& th : threads) th.join();
}

// Fused ragged masking for one partition (see file header). Layout:
//   flat_ids: int32[] token-id pool; a_ranges/b_ranges: int64[n*2]
//   (start, end) ranges into it; offs_a/offs_b: int64[n+1] output offsets
//   (prefix sums of na/nb); k: int64[n] pick counts, pre-clamped by the
//   caller to [0, na+nb]; offs_k: int64[n+1] prefix sums of k.
// Outputs: flat_a/flat_b (post-masking ids, ragged by na/nb),
//   pos_out: uint16[offs_k[n]] picked positions in the assembled
//   [CLS] A [SEP] B [SEP] row, ascending per row;
//   label_out: int32[offs_k[n]] the pre-masking ids at those positions.
void lddl_mask_partition(const int32_t* flat_ids, const int64_t* a_ranges,
                         const int64_t* b_ranges, int64_t n,
                         const int64_t* offs_a, const int64_t* offs_b,
                         const int64_t* k, const int64_t* offs_k,
                         uint64_t seed, int32_t vocab_size, int32_t mask_id,
                         int32_t* flat_a, int32_t* flat_b, uint16_t* pos_out,
                         int32_t* label_out, int32_t nthreads) {
  if (nthreads <= 1 || n <= 1) {
    mask_rows(flat_ids, a_ranges, b_ranges, 0, n, offs_a, offs_b, k, offs_k,
              seed, vocab_size, mask_id, flat_a, flat_b, pos_out, label_out);
    return;
  }
  if (nthreads > n) nthreads = static_cast<int32_t>(n);
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(mask_rows, flat_ids, a_ranges, b_ranges, lo, hi,
                         offs_a, offs_b, k, offs_k, seed, vocab_size, mask_id,
                         flat_a, flat_b, pos_out, label_out);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
