"""WordPiece tokenization over a vocab file, with no transformers.

The port's counterpart of :mod:`lddl_tpu.tokenization.wordpiece`. The card's
machine has neither transformers nor tokenizers, so
:class:`BertWordPiece` reads the vocab file itself, as
``BertTokenizerFast(vocab_file=..., do_lower_case=lowercase)`` does (one
token per line, its id the line number, an unknown token mapped to
``[UNK]``), and tokenizes text through the native C++ encoder
(:class:`~lddl_tpu_torch.native.NativeWordPiece`, a copy of the JAX
package's): HF's normalization (accents stripped only when lowercasing,
CJK characters split) and its greedy longest-match WordPiece.

The preprocessor (:mod:`lddl_tpu_torch.preprocess.bert`) also decodes
through it: id ranges back to space-joined token columns.

Most collates take from the tokenizer only the special ids,
``vocab_size`` and ``convert_tokens_to_ids`` (the BERT, packed and
CodeBERT shards hold tokens or ids already), so the encoder is built at
the first encode and never by the constructor: those loaders, and the
CLIs that build them, never compile it. The BART loader tokenizes raw
text at load time and builds it. A failed build raises; nothing falls
back to another tokenizer.
"""

import operator
import os
import threading

import numpy as np


class BertWordPiece:
  """Token <-> id over a WordPiece vocab file, and text -> ids through the
  native encoder (built at the first encode)."""

  def __init__(self, vocab_file, lowercase=True):
    with open(vocab_file, encoding='utf-8') as f:
      # A repeated token keeps its last line's id, as transformers'
      # load_vocab does.
      self._token_to_id = {line.rstrip('\n'): i for i, line in enumerate(f)}
    # Id-ordered, as lddl_tpu builds its encoder from HF's get_vocab().
    self._vocab_words = [t for t, _ in sorted(self._token_to_id.items(),
                                              key=lambda kv: kv[1])]
    self.lowercase = bool(lowercase)
    self.unk_token, self.sep_token, self.pad_token = '[UNK]', '[SEP]', '[PAD]'
    self.cls_token, self.mask_token = '[CLS]', '[MASK]'
    ids = self._token_to_id
    self.unk_token_id = ids.get(self.unk_token)
    self.sep_token_id = ids.get(self.sep_token)
    self.pad_token_id = ids.get(self.pad_token)
    self.cls_token_id = ids.get(self.cls_token)
    self.mask_token_id = ids.get(self.mask_token)
    self._unk_id = 0 if self.unk_token_id is None else self.unk_token_id
    self._native = None
    self._native_lock = threading.Lock()

  @property
  def vocab_words(self):
    """Vocabulary tokens ordered by token id."""
    return self._vocab_words

  @property
  def vocab_size(self):
    return len(self._token_to_id)

  def convert_tokens_to_ids(self, tokens):
    t2i = self._token_to_id
    # itemgetter runs the whole lookup at C speed; the .get() path runs
    # only when some token is out of the vocabulary.
    if len(tokens) > 1:
      try:
        return list(operator.itemgetter(*tokens)(t2i))
      except KeyError:
        pass
    unk = self._unk_id
    return [t2i.get(t, unk) for t in tokens]

  def get_special_tokens_mask(self, ids):
    """1 where an id is a special token's ([UNK], [SEP], [PAD], [CLS],
    [MASK], those in the vocab), else 0: HF's ``get_special_tokens_mask(
    ids, already_has_special_tokens=True)``."""
    special = {self.unk_token_id, self.sep_token_id, self.pad_token_id,
               self.cls_token_id, self.mask_token_id} - {None}
    return [1 if i in special else 0 for i in ids]

  def encoder(self):
    """The native encoder, built (and its library compiled, if this host
    has no build of it yet) at the first call."""
    with self._native_lock:
      if self._native is None:
        from ..native import NativeWordPiece
        self._native = NativeWordPiece(
            self._vocab_words, unk_token=self.unk_token,
            lowercase=self.lowercase)
      return self._native

  @property
  def native(self):
    """The native encoder (built at the first use); the preprocessor's
    document encoder and column assembly run through it."""
    return self.encoder()

  def decode_join_buffers(self, flat_ids, offsets):
    """Id ranges -> the buffers of a column of space-joined tokens:
    (int32 offsets [n+1], uint8 UTF-8 data)."""
    return self.encoder().decode_join_buffers(flat_ids, offsets)

  def decode_join(self, flat_ids, offsets):
    """Id ranges -> a list of space-joined token strings."""
    return self.encoder().decode_join(flat_ids, offsets)

  def columnar_emit(self, columns, positions=None):
    """Every string column of a shard (and the npy-framed positions
    column) in one native round trip; see
    :meth:`~lddl_tpu_torch.native.NativeWordPiece.columnar_emit`."""
    return self.encoder().columnar_emit(columns, positions=positions)

  def encode_batch_ids(self, texts, max_tokens=None):
    """Tokenize many texts straight to ids: (flat int32 ids, int64 [n+1]
    offsets), each text cut to ``max_tokens`` ids when given."""
    if not len(texts):
      return np.zeros(0, np.int32), np.zeros(1, np.int64)
    return self.encoder().encode_batch_ids(texts, max_tokens=max_tokens)

  def tokenize(self, text, max_length=None):
    return self.encoder().tokenize(text, max_length=max_length)

  def batch_tokenize(self, texts, max_length=None):
    if not texts:
      return []
    return self.encoder().batch_tokenize(texts, max_length=max_length)


def load_bert_tokenizer(vocab_file=None, hub_name=None, lowercase=True,
                        backend='native'):
  """A :class:`BertWordPiece` over a local ``vocab_file``.

  Takes :func:`lddl_tpu.tokenization.wordpiece.load_bert_tokenizer`'s
  signature, but only its native backend: ``hub_name`` and
  ``backend='hf'`` raise (a hub tokenizer needs the network, and HF's
  needs transformers, which the card's machine has not), and ``'auto'``
  means native. Where the JAX package falls back to HF when the encoder
  cannot be built, the port raises at the first encode.
  """
  if hub_name is not None:
    raise ValueError(
        f'hub_name={hub_name!r}: hub tokenizers are not ported (they need '
        'the network and transformers); pass vocab_file')
  if backend == 'hf':
    raise ValueError("backend='hf' is not ported (it needs transformers); "
                     "the port tokenizes with its native encoder")
  if backend not in ('native', 'auto'):
    raise ValueError(f'unknown tokenizer backend {backend!r} '
                     "(native|auto)")
  if vocab_file is None:
    raise ValueError('need vocab_file (a local WordPiece vocab file)')
  return BertWordPiece(os.path.abspath(os.path.expanduser(vocab_file)),
                       lowercase=lowercase)
