// Host decompression for the Parquet page codecs the loader reads: LZ4
// blocks (raw, and in the Hadoop framing Parquet's LZ4 codec writes) and
// Snappy. These are the byte-serial loops of the shard reader
// (lddl_tpu_torch/pipeline/parquet_io.py); everything else it decodes
// with numpy. Built with `c++ -O3 -shared -fPIC` at first use and loaded
// with ctypes (lddl_tpu_torch/pipeline/codecs.py).
//
// Every function takes the compressed bytes and an output buffer of
// known capacity, and returns the number of bytes written, or a negative
// code when the input is malformed or does not fit: a decoder never reads
// or writes outside the buffers it was given.

#include <cstdint>
#include <cstring>

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

}  // extern "C"
