// Native NSP pair planner, copied from lddl_tpu/native/src/pairing.cpp: a
// draw-for-draw mirror of the Python planner
// (lddl_tpu_torch/preprocess/pairing.py, a copy of
// lddl_tpu/preprocess/pairing.py), which itself mirrors the reference
// recipe (lddl/dask/bert/pretrain.py:241-365). The planner was the last
// pure-Python hot loop of the fast preprocess path (~40% of partition
// time including CPython Random overhead); running it natively keeps the
// outputs bit-identical because the embedded RNG reproduces CPython's
// random.Random exactly:
//
//   - MT19937 core identical to CPython _randommodule.c (same
//     regeneration and tempering);
//   - random()   = genrand_res53 (two 32-bit draws);
//   - getrandbits(k<=32) = genrand() >> (32-k);
//   - randint(a,b) = a + _randbelow(b-a+1) with CPython's
//     rejection-sampling _randbelow_with_getrandbits loop (the variable
//     draw count on rejection is part of the contract — a different
//     sampler would desynchronize every later draw).
//
// State is imported from Random.getstate() and exported back, so Python
// draws after the call continue the identical stream.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

struct PyRandom {
  uint32_t mt[624];
  int mti;

  uint32_t genrand() {
    constexpr uint32_t kMatrixA = 0x9908b0dfu;
    constexpr uint32_t kUpper = 0x80000000u;
    constexpr uint32_t kLower = 0x7fffffffu;
    if (mti >= 624) {
      int kk;
      uint32_t y;
      for (kk = 0; kk < 624 - 397; kk++) {
        y = (mt[kk] & kUpper) | (mt[kk + 1] & kLower);
        mt[kk] = mt[kk + 397] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
      }
      for (; kk < 623; kk++) {
        y = (mt[kk] & kUpper) | (mt[kk + 1] & kLower);
        mt[kk] = mt[kk - 227] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
      }
      y = (mt[623] & kUpper) | (mt[0] & kLower);
      mt[623] = mt[396] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
      mti = 0;
    }
    uint32_t y = mt[mti++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }

  double random01() {
    uint32_t a = genrand() >> 5, b = genrand() >> 6;
    return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
  }

  // k must be in [1, 32] (all widths in the planner fit 32 bits).
  uint32_t getrandbits(int k) { return genrand() >> (32 - k); }

  int64_t randbelow(int64_t n) {
    // n < 1 would make __builtin_clzll(0) UB; callers validate
    // (max_seq_length >= 5 is enforced Python-side, mirroring CPython's
    // ValueError for an empty randint range), so this is pure defense.
    if (n < 1) return 0;
    int k = 64 - __builtin_clzll(static_cast<uint64_t>(n));  // bit_length
    uint32_t r = getrandbits(k);
    while (static_cast<int64_t>(r) >= n) r = getrandbits(k);
    return r;
  }

  int64_t randint(int64_t a, int64_t b) { return a + randbelow(b - a + 1); }
};

}  // namespace

extern "C" {

// Plans NSP pairs for a partition. Writes rows (a0, a1, b0, b1,
// is_random_next) into out[cap][5]; returns the row count, or -1 if cap
// would be exceeded (callers size cap = duplicate_factor * n_sents, an
// upper bound since every emitted pair permanently consumes >= 1
// sentence). mt_state[624] / mt_index are CPython Random state, updated
// in place.
int64_t lddl_plan_pairs(const int64_t* sent_offsets,
                        const int64_t* doc_sent_start, int64_t n_docs,
                        uint32_t* mt_state, int32_t* mt_index,
                        int32_t max_seq_length, double short_seq_prob,
                        int32_t duplicate_factor, int64_t* out, int64_t cap) {
  PyRandom rng;
  std::memcpy(rng.mt, mt_state, sizeof(rng.mt));
  rng.mti = *mt_index;
  int64_t n_out = 0;
  const int64_t max_num_tokens = max_seq_length - 3;

  for (int32_t pass = 0; pass < duplicate_factor; pass++) {
    for (int64_t d = 0; d < n_docs; d++) {
      const int64_t ds = doc_sent_start[d];
      const int64_t n_sent = doc_sent_start[d + 1] - ds;
      int64_t target_seq_length = max_num_tokens;
      if (rng.random01() < short_seq_prob)
        target_seq_length = rng.randint(2, max_num_tokens);

      int64_t chunk_first = 0, chunk_n = 0, chunk_len = 0;
      int64_t i = 0;
      while (i < n_sent) {
        if (chunk_n == 0) chunk_first = i;
        chunk_n += 1;
        chunk_len += sent_offsets[ds + i + 1] - sent_offsets[ds + i];
        if (i == n_sent - 1 || chunk_len >= target_seq_length) {
          // chunk_n >= 1 always holds here.
          int64_t a_end = chunk_n < 2 ? 1 : rng.randint(1, chunk_n - 1);
          int64_t a0 = sent_offsets[ds + chunk_first];
          int64_t a1 = sent_offsets[ds + chunk_first + a_end];
          const int64_t la = a1 - a0;
          bool is_random;
          int64_t b0, b1;
          if (chunk_n == 1 || rng.random01() < 0.5) {
            is_random = true;
            const int64_t target_b = target_seq_length - la;
            int64_t rd = d;
            for (int t = 0; t < 10; t++) {
              int64_t cand = rng.randint(0, n_docs - 1);
              if (cand != d) { rd = cand; break; }
            }
            if (rd == d) is_random = false;
            const int64_t rds = doc_sent_start[rd];
            const int64_t rn = doc_sent_start[rd + 1] - rds;
            const int64_t start = rng.randint(0, rn - 1);
            b0 = sent_offsets[rds + start];
            // First end >= b0 + max(target_b, 1), clamped to the last
            // sentence (numpy searchsorted side='left' == lower_bound).
            const int64_t* ends = sent_offsets + rds + start + 1;
            const int64_t m = rn - start;
            int64_t j = std::lower_bound(ends, ends + m,
                                         b0 + std::max<int64_t>(target_b, 1)) -
                        ends;
            j = std::min(j, rn - start - 1);
            b1 = ends[j];
            i -= chunk_n - a_end;  // unused trailing sentences replay
          } else {
            is_random = false;
            b0 = a1;
            b1 = sent_offsets[ds + chunk_first + chunk_n];
          }
          const int64_t lb = b1 - b0;
          int64_t fa = 0, ba = 0, fb = 0, bb = 0;
          {
            int64_t xa = la, xb = lb;
            while (xa + xb > max_num_tokens) {
              if (xa > xb) {
                if (rng.random01() < 0.5) fa++; else ba++;
                xa--;
              } else {
                if (rng.random01() < 0.5) fb++; else bb++;
                xb--;
              }
            }
          }
          a0 += fa;
          a1 -= ba;
          b0 += fb;
          b1 -= bb;
          if (a1 > a0 && b1 > b0) {
            if (n_out >= cap) return -1;
            int64_t* row = out + n_out * 5;
            row[0] = a0;
            row[1] = a1;
            row[2] = b0;
            row[3] = b1;
            row[4] = is_random ? 1 : 0;
            n_out++;
          }
          chunk_n = 0;
          chunk_len = 0;
        }
        i += 1;
      }
    }
  }
  std::memcpy(mt_state, rng.mt, sizeof(rng.mt));
  *mt_index = rng.mti;
  return n_out;
}

}  // extern "C"
