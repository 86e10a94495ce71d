// lddl_tpu_torch native host code: BERT text normalization and WordPiece
// longest-match encoding, one C call per batch of texts, multithreaded and
// GIL-free, driven through ctypes (lddl_tpu_torch/native/wordpiece.py).
//
// The encoder of lddl_tpu/native/src/wordpiece.cpp, copied: UTF-8
// decoding, the normalizer and basic tokenizer, the vocabulary tables, the
// per-thread word cache, encode_text and the batch entry point. One part
// departs: the accent-stripping lowercase of Latin, Greek and Cyrillic
// letters is a table generated from Unicode's data (lower_strip below),
// so the ids equal HF's where lddl_tpu's hand-written folding does not. The sentence
// splitter, the document encoder, the string-column decoder and the
// columnar emitter only serve preprocessing and are not copied; nor is the
// decode arena of the Model, which only they read.
//
// Normalization parity: matches HuggingFace's BertNormalizer for ASCII,
// U+00C0..U+024F and U+0370..U+04FF (accents stripped when lowercasing),
// combining marks, and CJK spacing. Exotic scripts outside those ranges
// pass through unchanged (the divergence lddl_tpu/native/wordpiece.py
// documents).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- unicode

// Decode one UTF-8 codepoint starting at s[i]; advances i. Invalid bytes
// decode as 0xFFFD and advance by one.
inline uint32_t decode_utf8(const char* s, int64_t len, int64_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) |
                  (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1; return 0xFFFD;
}

inline void encode_utf8(uint32_t cp, std::string& out) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

inline bool is_whitespace(uint32_t cp) {
  switch (cp) {
    case ' ': case '\t': case '\n': case '\r':
    case 0x00A0: case 0x1680: case 0x2028: case 0x2029:
    case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

inline bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;  // treated as ws
  if (cp < 0x20 || cp == 0x7F) return true;
  // Common Cf (format) characters.
  if (cp == 0x00AD || cp == 0xFEFF) return true;
  if (cp >= 0x200B && cp <= 0x200F) return true;
  if (cp >= 0x202A && cp <= 0x202E) return true;
  if (cp >= 0x2060 && cp <= 0x2064) return true;
  return false;
}

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

inline bool is_punctuation(uint32_t cp) {
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  // Common Unicode punctuation blocks / characters.
  if (cp >= 0x2010 && cp <= 0x2027) return true;   // dashes, quotes, bullets
  if (cp >= 0x2030 && cp <= 0x205E) return true;   // permille .. general punct
  if (cp == 0x00A1 || cp == 0x00A7 || cp == 0x00AB || cp == 0x00B6 ||
      cp == 0x00B7 || cp == 0x00BB || cp == 0x00BF)
    return true;
  if (cp >= 0x3001 && cp <= 0x3003) return true;   // CJK comma/stop
  if (cp >= 0x3008 && cp <= 0x3011) return true;   // CJK brackets
  if (cp >= 0x3014 && cp <= 0x301F) return true;
  if (cp == 0x30FB || cp == 0xFF01 || cp == 0xFF0C || cp == 0xFF0E ||
      cp == 0xFF1A || cp == 0xFF1B || cp == 0xFF1F)
    return true;
  return false;
}

// Combining diacritical marks (category Mn slices BertNormalizer strips
// after NFD when lowercasing).
inline bool is_combining_mark(uint32_t cp) {
  return (cp >= 0x0300 && cp <= 0x036F) || (cp >= 0x1AB0 && cp <= 0x1AFF) ||
         (cp >= 0x1DC0 && cp <= 0x1DFF) || (cp >= 0x20D0 && cp <= 0x20FF);
}

// HuggingFace's BertNormalizer on one codepoint when lowercasing: NFD
// decomposition, the nonspacing marks (Mn) dropped, then lowercase. For
// U+00C0..U+024F (Latin-1 letters, Latin Extended-A and -B) and
// U+0370..U+04FF (Greek and Coptic, Cyrillic) every result is one codepoint
// or none (0: the codepoint is a mark and is dropped). Generated from
// Unicode 15.0's data with Python:
//   ''.join(c for c in unicodedata.normalize('NFD', chr(cp))
//           if unicodedata.category(c) != 'Mn').lower()
// (tests/test_torch_tokenization.py holds every entry against HF's
// tokenizer). lddl_tpu's encoder folds these ranges by hand, and parts
// wrongly (Cyrillic i with breve, Greek letters with tonos, L with stroke,
// Latin Extended-B), so its ids differ from HF's there; these tables make
// the port's equal HF's.
const uint16_t kFoldLatin[0x250 - 0xC0] = {
    0x0061, 0x0061, 0x0061, 0x0061, 0x0061, 0x0061, 0x00E6, 0x0063,
    0x0065, 0x0065, 0x0065, 0x0065, 0x0069, 0x0069, 0x0069, 0x0069,
    0x00F0, 0x006E, 0x006F, 0x006F, 0x006F, 0x006F, 0x006F, 0x00D7,
    0x00F8, 0x0075, 0x0075, 0x0075, 0x0075, 0x0079, 0x00FE, 0x00DF,
    0x0061, 0x0061, 0x0061, 0x0061, 0x0061, 0x0061, 0x00E6, 0x0063,
    0x0065, 0x0065, 0x0065, 0x0065, 0x0069, 0x0069, 0x0069, 0x0069,
    0x00F0, 0x006E, 0x006F, 0x006F, 0x006F, 0x006F, 0x006F, 0x00F7,
    0x00F8, 0x0075, 0x0075, 0x0075, 0x0075, 0x0079, 0x00FE, 0x0079,
    0x0061, 0x0061, 0x0061, 0x0061, 0x0061, 0x0061, 0x0063, 0x0063,
    0x0063, 0x0063, 0x0063, 0x0063, 0x0063, 0x0063, 0x0064, 0x0064,
    0x0111, 0x0111, 0x0065, 0x0065, 0x0065, 0x0065, 0x0065, 0x0065,
    0x0065, 0x0065, 0x0065, 0x0065, 0x0067, 0x0067, 0x0067, 0x0067,
    0x0067, 0x0067, 0x0067, 0x0067, 0x0068, 0x0068, 0x0127, 0x0127,
    0x0069, 0x0069, 0x0069, 0x0069, 0x0069, 0x0069, 0x0069, 0x0069,
    0x0069, 0x0131, 0x0133, 0x0133, 0x006A, 0x006A, 0x006B, 0x006B,
    0x0138, 0x006C, 0x006C, 0x006C, 0x006C, 0x006C, 0x006C, 0x0140,
    0x0140, 0x0142, 0x0142, 0x006E, 0x006E, 0x006E, 0x006E, 0x006E,
    0x006E, 0x0149, 0x014B, 0x014B, 0x006F, 0x006F, 0x006F, 0x006F,
    0x006F, 0x006F, 0x0153, 0x0153, 0x0072, 0x0072, 0x0072, 0x0072,
    0x0072, 0x0072, 0x0073, 0x0073, 0x0073, 0x0073, 0x0073, 0x0073,
    0x0073, 0x0073, 0x0074, 0x0074, 0x0074, 0x0074, 0x0167, 0x0167,
    0x0075, 0x0075, 0x0075, 0x0075, 0x0075, 0x0075, 0x0075, 0x0075,
    0x0075, 0x0075, 0x0075, 0x0075, 0x0077, 0x0077, 0x0079, 0x0079,
    0x0079, 0x007A, 0x007A, 0x007A, 0x007A, 0x007A, 0x007A, 0x017F,
    0x0180, 0x0253, 0x0183, 0x0183, 0x0185, 0x0185, 0x0254, 0x0188,
    0x0188, 0x0256, 0x0257, 0x018C, 0x018C, 0x018D, 0x01DD, 0x0259,
    0x025B, 0x0192, 0x0192, 0x0260, 0x0263, 0x0195, 0x0269, 0x0268,
    0x0199, 0x0199, 0x019A, 0x019B, 0x026F, 0x0272, 0x019E, 0x0275,
    0x006F, 0x006F, 0x01A3, 0x01A3, 0x01A5, 0x01A5, 0x0280, 0x01A8,
    0x01A8, 0x0283, 0x01AA, 0x01AB, 0x01AD, 0x01AD, 0x0288, 0x0075,
    0x0075, 0x028A, 0x028B, 0x01B4, 0x01B4, 0x01B6, 0x01B6, 0x0292,
    0x01B9, 0x01B9, 0x01BA, 0x01BB, 0x01BD, 0x01BD, 0x01BE, 0x01BF,
    0x01C0, 0x01C1, 0x01C2, 0x01C3, 0x01C6, 0x01C6, 0x01C6, 0x01C9,
    0x01C9, 0x01C9, 0x01CC, 0x01CC, 0x01CC, 0x0061, 0x0061, 0x0069,
    0x0069, 0x006F, 0x006F, 0x0075, 0x0075, 0x0075, 0x0075, 0x0075,
    0x0075, 0x0075, 0x0075, 0x0075, 0x0075, 0x01DD, 0x0061, 0x0061,
    0x0061, 0x0061, 0x00E6, 0x00E6, 0x01E5, 0x01E5, 0x0067, 0x0067,
    0x006B, 0x006B, 0x006F, 0x006F, 0x006F, 0x006F, 0x0292, 0x0292,
    0x006A, 0x01F3, 0x01F3, 0x01F3, 0x0067, 0x0067, 0x0195, 0x01BF,
    0x006E, 0x006E, 0x0061, 0x0061, 0x00E6, 0x00E6, 0x00F8, 0x00F8,
    0x0061, 0x0061, 0x0061, 0x0061, 0x0065, 0x0065, 0x0065, 0x0065,
    0x0069, 0x0069, 0x0069, 0x0069, 0x006F, 0x006F, 0x006F, 0x006F,
    0x0072, 0x0072, 0x0072, 0x0072, 0x0075, 0x0075, 0x0075, 0x0075,
    0x0073, 0x0073, 0x0074, 0x0074, 0x021D, 0x021D, 0x0068, 0x0068,
    0x019E, 0x0221, 0x0223, 0x0223, 0x0225, 0x0225, 0x0061, 0x0061,
    0x0065, 0x0065, 0x006F, 0x006F, 0x006F, 0x006F, 0x006F, 0x006F,
    0x006F, 0x006F, 0x0079, 0x0079, 0x0234, 0x0235, 0x0236, 0x0237,
    0x0238, 0x0239, 0x2C65, 0x023C, 0x023C, 0x019A, 0x2C66, 0x023F,
    0x0240, 0x0242, 0x0242, 0x0180, 0x0289, 0x028C, 0x0247, 0x0247,
    0x0249, 0x0249, 0x024B, 0x024B, 0x024D, 0x024D, 0x024F, 0x024F,
};

const uint16_t kFoldGreekCyrillic[0x500 - 0x370] = {
    0x0371, 0x0371, 0x0373, 0x0373, 0x02B9, 0x0375, 0x0377, 0x0377,
    0x0378, 0x0379, 0x037A, 0x037B, 0x037C, 0x037D, 0x003B, 0x03F3,
    0x0380, 0x0381, 0x0382, 0x0383, 0x0384, 0x00A8, 0x03B1, 0x00B7,
    0x03B5, 0x03B7, 0x03B9, 0x038B, 0x03BF, 0x038D, 0x03C5, 0x03C9,
    0x03B9, 0x03B1, 0x03B2, 0x03B3, 0x03B4, 0x03B5, 0x03B6, 0x03B7,
    0x03B8, 0x03B9, 0x03BA, 0x03BB, 0x03BC, 0x03BD, 0x03BE, 0x03BF,
    0x03C0, 0x03C1, 0x03A2, 0x03C3, 0x03C4, 0x03C5, 0x03C6, 0x03C7,
    0x03C8, 0x03C9, 0x03B9, 0x03C5, 0x03B1, 0x03B5, 0x03B7, 0x03B9,
    0x03C5, 0x03B1, 0x03B2, 0x03B3, 0x03B4, 0x03B5, 0x03B6, 0x03B7,
    0x03B8, 0x03B9, 0x03BA, 0x03BB, 0x03BC, 0x03BD, 0x03BE, 0x03BF,
    0x03C0, 0x03C1, 0x03C2, 0x03C3, 0x03C4, 0x03C5, 0x03C6, 0x03C7,
    0x03C8, 0x03C9, 0x03B9, 0x03C5, 0x03BF, 0x03C5, 0x03C9, 0x03D7,
    0x03D0, 0x03D1, 0x03D2, 0x03D2, 0x03D2, 0x03D5, 0x03D6, 0x03D7,
    0x03D9, 0x03D9, 0x03DB, 0x03DB, 0x03DD, 0x03DD, 0x03DF, 0x03DF,
    0x03E1, 0x03E1, 0x03E3, 0x03E3, 0x03E5, 0x03E5, 0x03E7, 0x03E7,
    0x03E9, 0x03E9, 0x03EB, 0x03EB, 0x03ED, 0x03ED, 0x03EF, 0x03EF,
    0x03F0, 0x03F1, 0x03F2, 0x03F3, 0x03B8, 0x03F5, 0x03F6, 0x03F8,
    0x03F8, 0x03F2, 0x03FB, 0x03FB, 0x03FC, 0x037B, 0x037C, 0x037D,
    0x0435, 0x0435, 0x0452, 0x0433, 0x0454, 0x0455, 0x0456, 0x0456,
    0x0458, 0x0459, 0x045A, 0x045B, 0x043A, 0x0438, 0x0443, 0x045F,
    0x0430, 0x0431, 0x0432, 0x0433, 0x0434, 0x0435, 0x0436, 0x0437,
    0x0438, 0x0438, 0x043A, 0x043B, 0x043C, 0x043D, 0x043E, 0x043F,
    0x0440, 0x0441, 0x0442, 0x0443, 0x0444, 0x0445, 0x0446, 0x0447,
    0x0448, 0x0449, 0x044A, 0x044B, 0x044C, 0x044D, 0x044E, 0x044F,
    0x0430, 0x0431, 0x0432, 0x0433, 0x0434, 0x0435, 0x0436, 0x0437,
    0x0438, 0x0438, 0x043A, 0x043B, 0x043C, 0x043D, 0x043E, 0x043F,
    0x0440, 0x0441, 0x0442, 0x0443, 0x0444, 0x0445, 0x0446, 0x0447,
    0x0448, 0x0449, 0x044A, 0x044B, 0x044C, 0x044D, 0x044E, 0x044F,
    0x0435, 0x0435, 0x0452, 0x0433, 0x0454, 0x0455, 0x0456, 0x0456,
    0x0458, 0x0459, 0x045A, 0x045B, 0x043A, 0x0438, 0x0443, 0x045F,
    0x0461, 0x0461, 0x0463, 0x0463, 0x0465, 0x0465, 0x0467, 0x0467,
    0x0469, 0x0469, 0x046B, 0x046B, 0x046D, 0x046D, 0x046F, 0x046F,
    0x0471, 0x0471, 0x0473, 0x0473, 0x0475, 0x0475, 0x0475, 0x0475,
    0x0479, 0x0479, 0x047B, 0x047B, 0x047D, 0x047D, 0x047F, 0x047F,
    0x0481, 0x0481, 0x0482, 0x0000, 0x0000, 0x0000, 0x0000, 0x0000,
    0x0488, 0x0489, 0x048B, 0x048B, 0x048D, 0x048D, 0x048F, 0x048F,
    0x0491, 0x0491, 0x0493, 0x0493, 0x0495, 0x0495, 0x0497, 0x0497,
    0x0499, 0x0499, 0x049B, 0x049B, 0x049D, 0x049D, 0x049F, 0x049F,
    0x04A1, 0x04A1, 0x04A3, 0x04A3, 0x04A5, 0x04A5, 0x04A7, 0x04A7,
    0x04A9, 0x04A9, 0x04AB, 0x04AB, 0x04AD, 0x04AD, 0x04AF, 0x04AF,
    0x04B1, 0x04B1, 0x04B3, 0x04B3, 0x04B5, 0x04B5, 0x04B7, 0x04B7,
    0x04B9, 0x04B9, 0x04BB, 0x04BB, 0x04BD, 0x04BD, 0x04BF, 0x04BF,
    0x04CF, 0x0436, 0x0436, 0x04C4, 0x04C4, 0x04C6, 0x04C6, 0x04C8,
    0x04C8, 0x04CA, 0x04CA, 0x04CC, 0x04CC, 0x04CE, 0x04CE, 0x04CF,
    0x0430, 0x0430, 0x0430, 0x0430, 0x04D5, 0x04D5, 0x0435, 0x0435,
    0x04D9, 0x04D9, 0x04D9, 0x04D9, 0x0436, 0x0436, 0x0437, 0x0437,
    0x04E1, 0x04E1, 0x0438, 0x0438, 0x0438, 0x0438, 0x043E, 0x043E,
    0x04E9, 0x04E9, 0x04E9, 0x04E9, 0x044D, 0x044D, 0x0443, 0x0443,
    0x0443, 0x0443, 0x0443, 0x0443, 0x0447, 0x0447, 0x04F7, 0x04F7,
    0x044B, 0x044B, 0x04FB, 0x04FB, 0x04FD, 0x04FD, 0x04FF, 0x04FF,
};

// Lowercase + accent-strip one codepoint. Returns 0 when the codepoint
// should be dropped (a combining mark). Exact for ASCII, the combining
// diacritical blocks and the two tables' ranges; outside those, codepoints
// pass through unchanged (no accent stripping, no lowercasing: the
// documented divergence from HF for exotic scripts, as in lddl_tpu).
inline uint32_t lower_strip(uint32_t cp) {
  if (cp < 0x80) {
    if (cp >= 'A' && cp <= 'Z') return cp + 32;
    return cp;
  }
  if (is_combining_mark(cp)) return 0;
  if (cp >= 0xC0 && cp < 0x250) return kFoldLatin[cp - 0xC0];
  if (cp >= 0x370 && cp < 0x500) return kFoldGreekCyrillic[cp - 0x370];
  return cp;
}

// ------------------------------------------------------------- vocabulary

struct SvHash {
  size_t operator()(std::string_view sv) const {
    // FNV-1a
    size_t h = 1469598103934665603ull;
    for (char c : sv) {
      h ^= static_cast<unsigned char>(c);
      h *= 1099511628211ull;
    }
    return h;
  }
};

std::atomic<uint64_t> g_model_gen{0};

struct Model {
  std::string vocab_blob;                 // concatenated token bytes
  std::vector<std::string_view> tokens;   // id -> token view into blob
  std::unordered_map<std::string_view, int32_t, SvHash> roots;
  std::unordered_map<std::string_view, int32_t, SvHash> suffixes;  // sans ##
  int32_t unk_id = 0;
  bool lowercase = true;
  int32_t max_input_chars = 100;
  // Longest vocab entry in bytes, split by table: substrings longer than
  // this cannot match, so the longest-match scan starts below it.
  int32_t max_root_bytes = 0;
  int32_t max_suffix_bytes = 0;
  // Unique instance tag (never reused, unlike the heap address) so
  // thread-local word caches can detect a model switch.
  uint64_t gen = ++g_model_gen;
};

// Per-thread memo of normalized-word bytes -> wordpiece ids. Natural text
// is Zipfian, so a small open-addressing table absorbs almost every word
// after the first few MB; a hit costs one hash + one memcmp instead of the
// longest-match probe loop. Purely an evaluation cache: values are the
// deterministic encode_word output, so cached and uncached paths are
// byte-identical.
struct WordCache {
  static constexpr uint32_t kSlots = 1u << 16;
  static constexpr uint32_t kMask = kSlots - 1;
  static constexpr size_t kMaxEntries = 48000;   // ~0.73 load factor cap
  static constexpr size_t kMaxKeyBytes = 64;     // don't cache pathological words
  // Don't pay the slot-table memset until the call has seen enough words
  // to plausibly amortize it (single-text tokenize calls never do).
  static constexpr uint64_t kActivateAfterWords = 64;
  struct Slot {
    int32_t key_off = -1;
    int32_t key_len = 0;
    int32_t ids_off = 0;
    int32_t ids_len = 0;
  };
  std::vector<Slot> slots;   // empty until activated
  std::string keys;
  std::vector<int32_t> ids;
  size_t entries = 0;
  uint64_t model_gen = 0;    // which Model the cached ids belong to
  uint64_t words_seen = 0;

  bool active() const { return !slots.empty(); }

  // Bind to a model; a switch (or first use) drops all cached entries.
  void attach(const Model& m) {
    if (model_gen != m.gen) {
      slots.clear();
      keys.clear();
      ids.clear();
      entries = 0;
      words_seen = 0;
      model_gen = m.gen;
    }
  }

  void note_word() {
    if (!active() && ++words_seen == kActivateAfterWords) {
      slots.assign(kSlots, Slot{});
      keys.reserve(1 << 18);
      ids.reserve(1 << 16);
    }
  }

  // Linear-probe to the slot holding `w` (found=true) or the first empty
  // slot (found=false). The entry cap keeps at least one slot empty, so the
  // probe always terminates.
  uint32_t probe(std::string_view w, bool& found) const {
    uint32_t idx = static_cast<uint32_t>(SvHash{}(w)) & kMask;
    while (true) {
      const Slot& s = slots[idx];
      if (s.key_off < 0) { found = false; return idx; }
      if (static_cast<size_t>(s.key_len) == w.size() &&
          std::memcmp(keys.data() + s.key_off, w.data(), w.size()) == 0) {
        found = true;
        return idx;
      }
      idx = (idx + 1) & kMask;
    }
  }

  void insert(uint32_t idx, std::string_view w, const int32_t* v, size_t n) {
    if (entries >= kMaxEntries || w.size() > kMaxKeyBytes) return;
    // (idx came from probe() on the active table, so slots is non-empty.)
    Slot& s = slots[idx];
    s.key_off = static_cast<int32_t>(keys.size());
    s.key_len = static_cast<int32_t>(w.size());
    keys.append(w.data(), w.size());
    s.ids_off = static_cast<int32_t>(ids.size());
    s.ids_len = static_cast<int32_t>(n);
    ids.insert(ids.end(), v, v + n);
    ++entries;
  }
};

// ------------------------------------------------------- word -> wordpiece

struct Word {
  // Normalized UTF-8 bytes plus codepoint boundary offsets.
  std::string bytes;
  std::vector<int32_t> cp_off;  // size = n_cp + 1
};

// One cache per OS thread, rebound (and flushed) on model switch. The
// calling thread keeps its cache warm across encode calls; short-lived
// worker threads get a fresh one, whose cost lazy activation bounds.
WordCache& local_word_cache(const Model& m) {
  static thread_local WordCache cache;
  cache.attach(m);
  return cache;
}

// Greedy longest-match (HF WordPiece::tokenize semantics): whole word
// becomes UNK if any position fails to match.
inline void encode_word(const Model& m, const Word& w,
                        std::vector<int32_t>& out) {
  int32_t n_cp = static_cast<int32_t>(w.cp_off.size()) - 1;
  if (n_cp == 0) return;
  if (n_cp > m.max_input_chars) {
    out.push_back(m.unk_id);
    return;
  }
  size_t mark = out.size();
  int32_t start = 0;
  while (start < n_cp) {
    int32_t end = n_cp;
    int32_t found = -1;
    const auto& map = (start == 0) ? m.roots : m.suffixes;
    // Substrings longer than the longest vocab entry can't match; skip
    // straight down to the first probe-able length.
    const int32_t max_bytes = (start == 0) ? m.max_root_bytes
                                           : m.max_suffix_bytes;
    while (end > start && w.cp_off[end] - w.cp_off[start] > max_bytes) --end;
    while (end > start) {
      std::string_view sub(w.bytes.data() + w.cp_off[start],
                           w.cp_off[end] - w.cp_off[start]);
      auto it = map.find(sub);
      if (it != map.end()) { found = it->second; break; }
      --end;
    }
    if (found < 0) {
      out.resize(mark);
      out.push_back(m.unk_id);
      return;
    }
    out.push_back(found);
    start = end;
  }
}

// Normalize + pre-tokenize + wordpiece one text into `out`.
inline void encode_text(const Model& m, const char* s, int64_t len,
                        std::vector<int32_t>& out, int32_t max_tokens,
                        WordCache& cache) {
  Word w;
  w.bytes.reserve(32);
  w.cp_off.reserve(33);
  size_t start_size = out.size();
  int64_t i = 0;
  auto flush_word = [&]() {
    if (!w.bytes.empty()) {
      if (cache.active()) {
        std::string_view key(w.bytes);
        bool found;
        uint32_t idx = cache.probe(key, found);
        if (found) {
          const WordCache::Slot& sl = cache.slots[idx];
          out.insert(out.end(), cache.ids.data() + sl.ids_off,
                     cache.ids.data() + sl.ids_off + sl.ids_len);
        } else {
          size_t before = out.size();
          encode_word(m, w, out);
          cache.insert(idx, key, out.data() + before, out.size() - before);
        }
      } else {
        encode_word(m, w, out);
        cache.note_word();
      }
      w.bytes.clear();
      w.cp_off.clear();
    }
  };
  w.cp_off.clear();
  auto push_cp = [&](uint32_t cp) {
    if (w.cp_off.empty()) w.cp_off.push_back(0);
    encode_utf8(cp, w.bytes);
    w.cp_off.push_back(static_cast<int32_t>(w.bytes.size()));
  };
  auto is_word_byte = [](unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
  };
  while (i < len) {
    if (max_tokens > 0 &&
        out.size() - start_size >= static_cast<size_t>(max_tokens))
      break;
    unsigned char c0 = static_cast<unsigned char>(s[i]);
    // Fast path for the dominant case: runs of lowercase ASCII letters /
    // digits append to the current word byte-for-byte (no decode,
    // classification, or re-encode), and a single space flushes. The
    // budget check above only changes value at flush boundaries, so
    // skipping it within a run leaves the output byte-identical.
    if (is_word_byte(c0)) {
      if (w.cp_off.empty()) w.cp_off.push_back(0);
      do {
        w.bytes.push_back(static_cast<char>(c0));
        w.cp_off.push_back(static_cast<int32_t>(w.bytes.size()));
        ++i;
        if (i >= len) break;
        c0 = static_cast<unsigned char>(s[i]);
      } while (is_word_byte(c0));
      continue;
    }
    if (c0 == ' ') {
      flush_word();
      ++i;
      continue;
    }
    uint32_t cp = decode_utf8(s, len, i);
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) { flush_word(); continue; }
    if (m.lowercase) {
      cp = lower_strip(cp);
      if (cp == 0) continue;
    }
    if (is_cjk(cp) || is_punctuation(cp)) {
      flush_word();
      push_cp(cp);
      flush_word();
      continue;
    }
    push_cp(cp);
  }
  flush_word();
  if (max_tokens > 0 &&
      out.size() - start_size > static_cast<size_t>(max_tokens))
    out.resize(start_size + max_tokens);
}

struct ThreadSlice {
  std::vector<int32_t> ids;
  std::vector<int64_t> seq_ends;    // per-sequence end offset (local)
};

void run_threads(int64_t n_items, int nthreads,
                 const std::function<void(int64_t, int64_t, int)>& body) {
  if (nthreads <= 1 || n_items <= 1) {
    body(0, n_items, 0);
    return;
  }
  if (nthreads > n_items) nthreads = static_cast<int>(n_items);
  std::vector<std::thread> threads;
  int64_t chunk = (n_items + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n_items, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(body, lo, hi, t);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Build a model. vocab_blob: concatenated UTF-8 token bytes; offsets:
// int64[n+1] boundaries; tokens are in id order.
void* lddl_wp_create(const char* vocab_blob, const int64_t* offsets,
                     int32_t n, int32_t unk_id, int32_t lowercase,
                     int32_t max_input_chars) {
  Model* m = new Model();
  m->vocab_blob.assign(vocab_blob, offsets[n]);
  m->tokens.resize(n);
  m->roots.reserve(n * 2);
  m->suffixes.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    std::string_view tok(m->vocab_blob.data() + offsets[i],
                         offsets[i + 1] - offsets[i]);
    m->tokens[i] = tok;
    if (tok.size() > 2 && tok[0] == '#' && tok[1] == '#') {
      m->suffixes.emplace(tok.substr(2), i);
      m->max_suffix_bytes = std::max<int32_t>(
          m->max_suffix_bytes, static_cast<int32_t>(tok.size()) - 2);
    } else {
      m->roots.emplace(tok, i);
      m->max_root_bytes = std::max<int32_t>(
          m->max_root_bytes, static_cast<int32_t>(tok.size()));
    }
  }
  m->unk_id = unk_id;
  m->lowercase = lowercase != 0;
  m->max_input_chars = max_input_chars;
  return m;
}

void lddl_wp_destroy(void* model) { delete static_cast<Model*>(model); }

// Encode n_texts texts (concatenated blob + int64[n+1] offsets).
// out_ids: int32 capacity `cap` (>= blob byte length is always enough);
// out_offsets: int64[n_texts+1]. max_tokens<=0 means unlimited.
// Returns total id count, or -1 if cap insufficient.
int64_t lddl_wp_encode_batch(void* model, const char* blob,
                             const int64_t* offsets, int64_t n_texts,
                             int32_t max_tokens, int32_t* out_ids,
                             int64_t cap, int64_t* out_offsets,
                             int32_t nthreads) {
  const Model& m = *static_cast<Model*>(model);
  std::vector<ThreadSlice> slices(std::max<int64_t>(
      1, std::min<int64_t>(nthreads <= 0 ? 1 : nthreads, n_texts)));
  int real_threads = static_cast<int>(slices.size());
  auto body = [&](int64_t lo, int64_t hi, int t) {
    ThreadSlice& sl = slices[t];
    sl.ids.reserve((offsets[hi] - offsets[lo]) / 4 + 16);
    WordCache& cache = local_word_cache(m);
    for (int64_t k = lo; k < hi; ++k) {
      encode_text(m, blob + offsets[k], offsets[k + 1] - offsets[k], sl.ids,
                  max_tokens, cache);
      sl.seq_ends.push_back(static_cast<int64_t>(sl.ids.size()));
    }
  };
  run_threads(n_texts, real_threads, body);
  int64_t total = 0;
  for (auto& sl : slices) total += static_cast<int64_t>(sl.ids.size());
  if (total > cap) return -1;
  int64_t pos = 0, seq = 0;
  out_offsets[0] = 0;
  for (int t = 0; t < real_threads; ++t) {
    ThreadSlice& sl = slices[t];
    if (!sl.ids.empty())
      std::memcpy(out_ids + pos, sl.ids.data(), sl.ids.size() * 4);
    for (int64_t e : sl.seq_ends) out_offsets[++seq] = pos + e;
    pos += static_cast<int64_t>(sl.ids.size());
  }
  return total;
}

int64_t lddl_native_abi_version() { return 4; }

}  // extern "C"
