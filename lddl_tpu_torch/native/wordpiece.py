"""ctypes front end for the native WordPiece encoder.

A copy of the encoding half of :class:`lddl_tpu.native.wordpiece.
NativeWordPiece`: one GIL-free, multithreaded C call per batch of texts.
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

  def tokenize(self, text, max_length=None):
    ids, _ = self.encode_batch_ids([text], max_tokens=max_length)
    words = self._vocab_words
    return [words[i] for i in ids]

  def batch_tokenize(self, texts, max_length=None):
    ids, offsets = self.encode_batch_ids(texts, max_tokens=max_length)
    words = self._vocab_words
    flat = [words[i] for i in ids]
    return [flat[offsets[k]:offsets[k + 1]] for k in range(len(texts))]
