// Host decompression for the Parquet page codecs the loader reads: LZ4
// blocks (raw, and in the Hadoop framing Parquet's LZ4 codec writes) and
// Snappy. These are the byte-serial loops of the shard reader
// (lddl_tpu_torch/pipeline/parquet_io.py); everything else it decodes
// with numpy. The shard writer's byte-serial loops live here too: an LZ4
// block compressor (its pages are LZ4_RAW) and the PLAIN encoding of a
// BYTE_ARRAY column (a 4-byte length before each value). Built with `c++ -O3 -shared -fPIC` at first use and loaded
// with ctypes (lddl_tpu_torch/pipeline/codecs.py).
//
// Every function takes the compressed bytes and an output buffer of
// known capacity, and returns the number of bytes written, or a negative
// code when the input is malformed or does not fit: a decoder never reads
// or writes outside the buffers it was given.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kMalformed = -1;   // truncated or inconsistent input
constexpr int64_t kOverflow = -2;    // output larger than its capacity
constexpr int64_t kBadOffset = -3;   // a match reaching before the output

// Copies `len` bytes from `offset` bytes back in `dst`; the regions may
// overlap (offset < len repeats the last `offset` bytes), so copy forward
// byte by byte unless they do not.
inline void copy_match(uint8_t* out, int64_t offset, int64_t len) {
  const uint8_t* from = out - offset;
  if (offset >= len) {
    std::memcpy(out, from, static_cast<size_t>(len));
  } else {
    for (int64_t i = 0; i < len; ++i) out[i] = from[i];
  }
}

// One LZ4 block (the LZ4 block format: sequences of a token, literals, a
// 2-byte offset and a match length; the last sequence has literals only).
int64_t lz4_block(const uint8_t* src, int64_t src_len, uint8_t* dst,
                  int64_t dst_cap) {
  int64_t ip = 0, op = 0;
  while (ip < src_len) {
    const uint8_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= src_len) return kMalformed;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (lit > src_len - ip) return kMalformed;
    if (lit > dst_cap - op) return kOverflow;
    std::memcpy(dst + op, src + ip, static_cast<size_t>(lit));
    ip += lit;
    op += lit;
    if (ip == src_len) break;  // the last sequence: literals only
    if (src_len - ip < 2) return kMalformed;
    const int64_t offset = src[ip] | (src[ip + 1] << 8);
    ip += 2;
    if (offset == 0 || offset > op) return kBadOffset;
    int64_t len = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= src_len) return kMalformed;
        b = src[ip++];
        len += b;
      } while (b == 255);
    }
    if (len > dst_cap - op) return kOverflow;
    copy_match(dst + op, offset, len);
    op += len;
  }
  return op;
}

inline uint32_t load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline uint32_t load_le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint32_t(p[i]) << (8 * i);
  return v;
}

}  // namespace

extern "C" {

int64_t lddl_lz4_block_decompress(const uint8_t* src, int64_t src_len,
                                  uint8_t* dst, int64_t dst_cap) {
  return lz4_block(src, src_len, dst, dst_cap);
}

// Parquet's LZ4 codec as Hadoop frames it: blocks of a big-endian 4-byte
// decompressed size, a big-endian 4-byte compressed size and one LZ4 block,
// to the end of the input. Any mismatch is malformed; the caller then
// reads the input as one raw block, as older writers left it.
int64_t lddl_lz4_hadoop_decompress(const uint8_t* src, int64_t src_len,
                                   uint8_t* dst, int64_t dst_cap) {
  int64_t ip = 0, op = 0;
  while (src_len - ip >= 8) {
    const int64_t raw = load_be32(src + ip);
    const int64_t packed = load_be32(src + ip + 4);
    ip += 8;
    if (packed > src_len - ip || raw > dst_cap - op) return kMalformed;
    const int64_t got = lz4_block(src + ip, packed, dst + op, raw);
    if (got != raw) return kMalformed;
    ip += packed;
    op += raw;
  }
  return ip == src_len ? op : kMalformed;
}

// Snappy's raw format: a varint of the decompressed length, then literal
// and copy elements, each led by a tag byte whose low two bits give its kind.
int64_t lddl_snappy_decompress(const uint8_t* src, int64_t src_len,
                               uint8_t* dst, int64_t dst_cap) {
  int64_t ip = 0, expected = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= src_len || shift > 28) return kMalformed;
    const uint8_t b = src[ip++];
    expected |= int64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
  }
  if (expected > dst_cap) return kOverflow;
  int64_t op = 0;
  while (ip < src_len) {
    const uint8_t tag = src[ip++];
    int64_t len, offset;
    switch (tag & 3) {
      case 0: {  // literal
        len = tag >> 2;
        if (len >= 60) {
          const int extra = static_cast<int>(len) - 59;
          if (src_len - ip < extra) return kMalformed;
          len = load_le(src + ip, extra);
          ip += extra;
        }
        len += 1;
        if (len > src_len - ip) return kMalformed;
        if (len > expected - op) return kOverflow;
        std::memcpy(dst + op, src + ip, static_cast<size_t>(len));
        ip += len;
        op += len;
        continue;
      }
      case 1:  // copy, 11-bit offset
        if (ip >= src_len) return kMalformed;
        len = 4 + ((tag >> 2) & 7);
        offset = (int64_t(tag >> 5) << 8) | src[ip++];
        break;
      case 2:  // copy, 16-bit offset
        if (src_len - ip < 2) return kMalformed;
        len = (tag >> 2) + 1;
        offset = load_le(src + ip, 2);
        ip += 2;
        break;
      default:  // copy, 32-bit offset
        if (src_len - ip < 4) return kMalformed;
        len = (tag >> 2) + 1;
        offset = load_le(src + ip, 4);
        ip += 4;
        break;
    }
    if (offset == 0 || offset > op) return kBadOffset;
    if (len > expected - op) return kOverflow;
    copy_match(dst + op, offset, len);
    op += len;
  }
  return op == expected ? op : kMalformed;
}

// One LZ4 block of src (greedy, a 4-byte hash of each position into a
// table of the last position it was seen at, matches within 64 KiB). It
// keeps the block format's end rules: no match starts in the last 12
// bytes, and the last 5 bytes are literals. Returns the block's size, or
// kOverflow when dst_cap is short (n + n / 255 + 16 always suffices).
int64_t lddl_lz4_block_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                                int64_t dst_cap) {
  constexpr int kHashBits = 16;
  constexpr int64_t kMinMatch = 4, kLastLiterals = 5, kMfLimit = 12;
  std::vector<int64_t> table(size_t(1) << kHashBits, -1);
  int64_t ip = 0, anchor = 0, op = 0;
  auto put_length = [&](int64_t len) -> bool {  // the bytes after 15
    for (; len >= 255; len -= 255) {
      if (op >= dst_cap) return false;
      dst[op++] = 255;
    }
    if (op >= dst_cap) return false;
    dst[op++] = static_cast<uint8_t>(len);
    return true;
  };
  auto put_literals = [&](int64_t lit, int64_t match) -> bool {
    if (op >= dst_cap) return false;
    const int64_t token_at = op++;
    dst[token_at] = static_cast<uint8_t>(
        (lit < 15 ? lit : 15) << 4 | (match < 15 ? match : 15));
    if (lit >= 15 && !put_length(lit - 15)) return false;
    if (lit > dst_cap - op) return false;
    std::memcpy(dst + op, src + anchor, static_cast<size_t>(lit));
    op += lit;
    return true;
  };
  auto load32 = [&](int64_t at) {
    uint32_t v;
    std::memcpy(&v, src + at, 4);
    return v;
  };
  const int64_t limit = n - kMfLimit;
  while (ip < limit) {
    const uint32_t seq = load32(ip);
    const uint32_t h = (seq * 2654435761u) >> (32 - kHashBits);
    const int64_t ref = table[h];
    table[h] = ip;
    if (ref < 0 || ip - ref > 65535 || load32(ref) != seq) {
      ++ip;
      continue;
    }
    int64_t len = kMinMatch;
    const int64_t max_len = n - kLastLiterals - ip;
    while (len < max_len && src[ref + len] == src[ip + len]) ++len;
    const int64_t code = len - kMinMatch;
    if (!put_literals(ip - anchor, code)) return kOverflow;
    if (dst_cap - op < 2) return kOverflow;
    const int64_t offset = ip - ref;
    dst[op++] = static_cast<uint8_t>(offset & 0xff);
    dst[op++] = static_cast<uint8_t>(offset >> 8);
    if (code >= 15 && !put_length(code - 15)) return kOverflow;
    ip += len;
    anchor = ip;
  }
  if (!put_literals(n - anchor, 0)) return kOverflow;
  return op;
}

// PLAIN encoding of n BYTE_ARRAY values (value i is
// data[offsets[i]:offsets[i + 1]]): each value's 4-byte little-endian
// length, then its bytes. dst holds 4 * n + offsets[n] - offsets[0] bytes.
void lddl_plain_byte_arrays(const int64_t* offsets, const uint8_t* data,
                            int64_t n, uint8_t* dst) {
  int64_t op = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = offsets[i + 1] - offsets[i];
    const uint32_t len32 = static_cast<uint32_t>(len);
    for (int b = 0; b < 4; ++b)
      dst[op++] = static_cast<uint8_t>((len32 >> (8 * b)) & 0xff);
    std::memcpy(dst + op, data + offsets[i], static_cast<size_t>(len));
    op += len;
  }
}

}  // extern "C"
