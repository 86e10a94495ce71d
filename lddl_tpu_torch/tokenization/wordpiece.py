"""A WordPiece vocabulary map: the part of the tokenizer the loader uses.

The collates of :mod:`lddl_tpu.loader` take from the tokenizer only the
special ids, ``vocab_size`` and ``convert_tokens_to_ids``
(``lddl_tpu/loader/bert.py:87-99,124-126``, ``loader/packed.py:45-49``):
the shards hold WordPiece tokens (pairs) or ids (packed rows) already, so
nothing is tokenized at load time. The card's machine has no
transformers, so the port reads the vocab file itself, as
``BertTokenizerFast(vocab_file=...)`` does: one token per line, its id
the line number, an unknown token mapped to ``[UNK]``.
"""

import operator
import os

_SPECIALS = {'unk': '[UNK]', 'sep': '[SEP]', 'pad': '[PAD]', 'cls': '[CLS]',
             'mask': '[MASK]'}


class BertVocab:
  """Token <-> id over a WordPiece vocab file."""

  def __init__(self, vocab_file):
    with open(vocab_file, encoding='utf-8') as f:
      # A repeated token keeps its last line's id, as transformers'
      # load_vocab does.
      self._token_to_id = {line.rstrip('\n'): i for i, line in enumerate(f)}
    ids = {k: self._token_to_id.get(t) for k, t in _SPECIALS.items()}
    self.unk_token_id = ids['unk']
    self.sep_token_id = ids['sep']
    self.pad_token_id = ids['pad']
    self.cls_token_id = ids['cls']
    self.mask_token_id = ids['mask']
    self._unk_id = 0 if self.unk_token_id is None else self.unk_token_id

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


def load_bert_tokenizer(vocab_file):
  """A :class:`BertVocab` over ``vocab_file``. The JAX package's
  ``hub_name``, ``lowercase`` and ``backend`` are not taken: a hub
  tokenizer needs the network and transformers, and the other two only
  shape tokenizing, which the loader never does."""
  if vocab_file is None:
    raise ValueError('need vocab_file (a local WordPiece vocab file)')
  return BertVocab(os.path.abspath(os.path.expanduser(vocab_file)))
