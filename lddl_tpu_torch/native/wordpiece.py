"""ctypes front end for the native WordPiece encoder.

A copy of :class:`lddl_tpu.native.wordpiece.NativeWordPiece`: one
GIL-free, multithreaded C call per batch of texts, and the preprocessor's
half (sentence split and encode of whole documents, the space-joined
string columns and the fused columnar emit of a shard's columns).
Its ids equal HuggingFace's ``BertTokenizerFast`` for ASCII, Latin
accents, Greek, Cyrillic and CJK (``tests/test_torch_tokenization.py``);
codepoints outside those ranges skip accent stripping and pass through
unchanged, as in the JAX package's encoder, whose ids the port keeps
there (a documented departure from HF, not from ``lddl_tpu``).

The output does not depend on the thread count: each thread encodes a
contiguous range of texts with its own word cache, a pure memo of the
deterministic word encoding, and the ranges are joined in order.
"""

import ctypes
import os

import numpy as np

from .build import library

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def default_threads():
  return min(8, os.cpu_count() or 1)


def _offsets_blob(texts):
  """Concatenate texts -> (bytes blob, int64[n+1] offsets)."""
  encoded = [t.encode('utf-8') if isinstance(t, str) else t for t in texts]
  offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
  np.cumsum([len(e) for e in encoded], out=offsets[1:])
  return b''.join(encoded), offsets


class NativeWordPiece:
  """C++ longest-match WordPiece over a fixed id-ordered vocabulary.

  Builds the library at construction when it has no build yet. It is not
  picklable: the model pointer is process-local, so each worker process
  builds its own.
  """

  def __init__(self, vocab_words, unk_token='[UNK]', lowercase=True,
               max_input_chars_per_word=100, num_threads=None):
    self._lib = library()
    self._vocab_words = list(vocab_words)
    try:
      unk_id = self._vocab_words.index(unk_token)
    except ValueError:
      unk_id = 0
    blob, offsets = _offsets_blob(self._vocab_words)
    self._model = self._lib.lddl_wp_create(
        blob, offsets.ctypes.data_as(_i64p), len(self._vocab_words), unk_id,
        1 if lowercase else 0, max_input_chars_per_word)
    self.lowercase = lowercase
    self.num_threads = int(num_threads or default_threads())

  def __del__(self):
    model = getattr(self, '_model', None)
    if model:
      self._lib.lddl_wp_destroy(model)
      self._model = None

  def __getstate__(self):
    raise TypeError('NativeWordPiece is not picklable; rebuild per process')

  @property
  def vocab_words(self):
    return self._vocab_words

  def encode_batch_ids(self, texts, max_tokens=None):
    """Encode texts -> (flat int32 ids, int64[n+1] offsets); each text
    keeps at most ``max_tokens`` ids when given."""
    if not len(texts):
      return np.zeros(0, np.int32), np.zeros(1, np.int64)
    blob, offsets = _offsets_blob(texts)
    cap = max(16, len(blob))
    out_ids = np.empty(cap, dtype=np.int32)
    out_offsets = np.empty(len(texts) + 1, dtype=np.int64)
    total = self._lib.lddl_wp_encode_batch(
        self._model, blob, offsets.ctypes.data_as(_i64p), len(texts),
        max_tokens or 0, out_ids.ctypes.data_as(_i32p), cap,
        out_offsets.ctypes.data_as(_i64p), self.num_threads)
    if total < 0:
      raise RuntimeError('native encode overflow (internal capacity bug)')
    return out_ids[:total].copy(), out_offsets

  def encode_docs(self, doc_texts, max_tokens_per_sent=None):
    """Sentence-split + encode documents in one native call.

    Returns (flat int32 ids, int64 sentence offsets into ids [n_sents+1],
    int64 per-doc sentence counts). Sentences yielding zero tokens are
    dropped (mirrors ``documents_from_lines``).
    """
    if not len(doc_texts):
      return (np.zeros(0, np.int32), np.zeros(1, np.int64),
              np.zeros(0, np.int64))
    blob, offsets = _offsets_blob(doc_texts)
    cap_ids = max(16, len(blob))
    cap_sents = len(blob) + len(doc_texts) + 1
    out_ids = np.empty(cap_ids, dtype=np.int32)
    out_sent_offsets = np.empty(cap_sents + 1, dtype=np.int64)
    out_doc_counts = np.empty(len(doc_texts), dtype=np.int64)
    total = self._lib.lddl_encode_docs(
        self._model, blob, offsets.ctypes.data_as(_i64p), len(doc_texts),
        max_tokens_per_sent or 0, out_ids.ctypes.data_as(_i32p), cap_ids,
        out_sent_offsets.ctypes.data_as(_i64p), cap_sents,
        out_doc_counts.ctypes.data_as(_i64p), self.num_threads)
    if total < 0:
      raise RuntimeError('native encode_docs overflow (internal capacity bug)')
    n_sents = int(out_doc_counts.sum())
    return (out_ids[:total].copy(), out_sent_offsets[:n_sents + 1].copy(),
            out_doc_counts)

  def split_sentences(self, text):
    """Rule-based sentence split (same semantics as the Python 'rules'
    backend in ``lddl_tpu/tokenization/sentences.py``)."""
    data = text.encode('utf-8')
    cap = max(8, len(data) // 2 + 1)
    out = np.empty(cap * 2, dtype=np.int64)
    n = self._lib.lddl_split_sentences(data, len(data),
                                       out.ctypes.data_as(_i64p), cap)
    if n > cap:  # pathological input; retry with exact size
      out = np.empty(n * 2, dtype=np.int64)
      n = self._lib.lddl_split_sentences(data, len(data),
                                         out.ctypes.data_as(_i64p), n)
    bounds = out[:n * 2].reshape(-1, 2)
    return [data[b:e].decode('utf-8') for b, e in bounds]

  def tokenize(self, text, max_length=None):
    ids, _ = self.encode_batch_ids([text], max_tokens=max_length)
    words = self._vocab_words
    return [words[i] for i in ids]

  def batch_tokenize(self, texts, max_length=None):
    ids, offsets = self.encode_batch_ids(texts, max_tokens=max_length)
    words = self._vocab_words
    flat = [words[i] for i in ids]
    return [flat[offsets[k]:offsets[k + 1]] for k in range(len(texts))]

  def decode_join_buffers(self, ids, offsets):
    """ids ranges -> Arrow string-column buffers (int32 offsets, utf8 data).

    The buffers of the writer's string column of space-joined tokens.
    """
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    # Upper bound: every token expands to at most max(token_len) bytes plus
    # a separator; use sum of per-id lengths computed cheaply via a lens LUT.
    if not hasattr(self, '_lens_lut'):
      self._lens_lut = np.array([len(w.encode('utf-8')) for w in
                                 self._vocab_words], dtype=np.int64)
    n_ids = int(offsets[-1])
    if n_ids:
      # Out-of-range ids decode as '[UNK]' (5 bytes) in the native code;
      # clip them to that length here instead of mis-indexing the LUT.
      used = ids[:n_ids]
      in_range = (used >= 0) & (used < len(self._lens_lut))
      lens = np.where(in_range, self._lens_lut[np.where(in_range, used, 0)], 5)
      # +48 slack keeps the native wide-store fast path active through
      # the final tokens (it needs kDecodeStride+1 bytes of headroom).
      cap = int(lens.sum()) + n_ids + 48
    else:
      cap = 48
    out_data = np.empty(cap, dtype=np.uint8)
    out_offsets = np.empty(n + 1, dtype=np.int32)
    total = self._lib.lddl_decode_join(
        self._model, ids.ctypes.data_as(_i32p),
        offsets.ctypes.data_as(_i64p), n,
        out_data.ctypes.data_as(ctypes.c_char_p), cap,
        out_offsets.ctypes.data_as(_i32p))
    if total == -2:
      raise ValueError(
          'joined string column exceeds 2 GiB (Arrow int32 offset limit); '
          'split the partition into smaller batches')
    if total < 0:
      raise RuntimeError('native decode overflow (internal capacity bug)')
    return out_offsets, out_data[:total]

  def columnar_emit(self, columns, positions=None):
    """Fused Arrow-column build: many string columns (and optionally the
    npy-framed uint16 positions binary column) in one native round trip.

    ``columns`` is a sequence of ``(flat_ids, offsets)`` pairs (the
    :meth:`encode_batch_ids` representation); ``positions`` is an optional
    ``(values_u16, offsets)`` pair. Returns ``(string_parts, pos_parts)``
    where ``string_parts[i]`` is ``(out_offsets int32[n+1], data uint8)``
    (a string column's buffers) and ``pos_parts``
    is ``(boffs int64[n+1], data uint8)`` matching
    :func:`lddl_tpu_torch.core.utils.u16_batch_binary_parts` byte-for-byte
    (``None`` when ``positions`` is ``None``).

    Versus per-column :meth:`decode_join_buffers` this skips the numpy
    capacity-LUT pass (sizes are computed natively, exactly) and the
    vectorized-numpy npy framing; output bytes are identical.
    """
    import ctypes as c
    cols = [(np.ascontiguousarray(ids, dtype=np.int32),
             np.ascontiguousarray(offs, dtype=np.int64))
            for ids, offs in columns]
    ncols = len(cols)
    ids_p = (c.c_void_p * max(ncols, 1))(
        *[a.ctypes.data for a, _ in cols] or [None])
    offs_p = (c.c_void_p * max(ncols, 1))(
        *[o.ctypes.data for _, o in cols] or [None])
    ns = np.array([len(o) - 1 for _, o in cols] or [0], dtype=np.int64)
    caps = np.zeros(max(ncols, 1), dtype=np.int64)
    if positions is not None:
      pos_vals = np.ascontiguousarray(positions[0], dtype='<u2')
      pos_offs = np.ascontiguousarray(positions[1], dtype=np.int64)
      if int(pos_offs[0]) != 0 or int(pos_offs[-1]) != len(pos_vals):
        # Offsets may describe a sub-span of values (mirror of
        # u16_batch_binary_parts' normalization).
        pos_vals = np.ascontiguousarray(pos_vals[pos_offs[0]:pos_offs[-1]])
        pos_offs = pos_offs - pos_offs[0]
      pos_n = len(pos_offs) - 1
      pos_boffs = np.zeros(pos_n + 1, dtype=np.int64)
      pos_offs_p = pos_offs.ctypes.data_as(_i64p)
      pos_boffs_p = pos_boffs.ctypes.data_as(_i64p)
    else:
      pos_vals = pos_offs = pos_boffs = None
      pos_n = 0
      pos_offs_p = pos_boffs_p = None
    self._lib.lddl_columnar_sizes(
        self._model, ncols, ids_p, offs_p, ns.ctypes.data_as(_i64p),
        caps.ctypes.data_as(_i64p), pos_offs_p, pos_n, pos_boffs_p)
    out = [(np.empty(int(ns[i]) + 1, dtype=np.int32),
            np.empty(int(caps[i]), dtype=np.uint8)) for i in range(ncols)]
    out_offs_p = (c.c_void_p * max(ncols, 1))(
        *[oo.ctypes.data for oo, _ in out] or [None])
    out_data_p = (c.c_void_p * max(ncols, 1))(
        *[od.ctypes.data for _, od in out] or [None])
    if positions is not None:
      pos_data = np.empty(int(pos_boffs[-1]), dtype=np.uint8)
      pos_vals_p = pos_vals.ctypes.data_as(c.POINTER(c.c_uint16))
      pos_data_p = pos_data.ctypes.data_as(c.c_char_p)
    else:
      pos_data = None
      pos_vals_p = pos_data_p = None
    rc = self._lib.lddl_columnar_emit(
        self._model, ncols, ids_p, offs_p, ns.ctypes.data_as(_i64p),
        out_offs_p, out_data_p, caps.ctypes.data_as(_i64p), pos_vals_p,
        pos_offs_p, pos_n, pos_boffs_p, pos_data_p, self.num_threads)
    if rc == -2:
      raise ValueError(
          'joined string column exceeds 2 GiB (Arrow int32 offset limit); '
          'split the partition into smaller batches')
    if rc < 0:
      raise RuntimeError('native columnar emit overflow (capacity bug)')
    string_parts = [(oo, od[:int(oo[-1])]) for oo, od in out]
    pos_parts = (pos_boffs, pos_data) if positions is not None else None
    return string_parts, pos_parts

  def decode_join(self, ids, offsets):
    """ids ranges -> list of space-joined token strings."""
    out_offsets, data = self.decode_join_buffers(ids, offsets)
    buf = data.tobytes()
    return [
        buf[out_offsets[k]:out_offsets[k + 1]].decode('utf-8')
        for k in range(len(out_offsets) - 1)
    ]
