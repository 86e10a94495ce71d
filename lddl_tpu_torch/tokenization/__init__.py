"""WordPiece tokenization the port copies from :mod:`lddl_tpu.tokenization`:
the vocab map and the native encoder's front end.

Its exports (``lddl_tpu.tokenization``'s names) load at first access.
"""

_LAZY = {
    'BertWordPiece': 'wordpiece',
    'load_bert_tokenizer': 'wordpiece',
    'split_sentences': 'sentences',
}


def __getattr__(name):
  module = _LAZY.get(name)
  if module is None:
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
  import importlib
  return getattr(importlib.import_module(f'.{module}', __name__), name)
