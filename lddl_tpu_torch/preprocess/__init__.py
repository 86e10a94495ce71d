"""Preprocessors the port copies from :mod:`lddl_tpu.preprocess`: the BERT
pretraining preprocessor's fast engine (:mod:`.bert`).

Its exports (``lddl_tpu.preprocess``'s names) load at first access.
"""

_LAZY = {
    'Corpus': 'readers',
    'split_id_text': 'readers',
}


def __getattr__(name):
  module = _LAZY.get(name)
  if module is None:
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
  import importlib
  return getattr(importlib.import_module(f'.{module}', __name__), name)
