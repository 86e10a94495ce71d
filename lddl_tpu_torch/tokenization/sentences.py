"""Sentence segmentation, copied from :mod:`lddl_tpu.tokenization.sentences`.

The reference depends on nltk's punkt models downloaded at run time
(reference ``lddl/dask/bert/pretrain.py:86,583``). TPU-VM fleets are often
egress-restricted, so the default here is a self-contained rule-based
segmenter; punkt is used transparently when its model data is already
installed.
"""

import re

_ABBREVIATIONS = {
    'mr', 'mrs', 'ms', 'dr', 'prof', 'sr', 'jr', 'st', 'vs', 'etc', 'inc',
    'ltd', 'co', 'corp', 'dept', 'univ', 'assn', 'bros', 'e.g', 'i.e', 'cf',
    'al', 'ave', 'blvd', 'rd', 'fig', 'no', 'vol', 'pp', 'op', 'cit', 'ca',
    'gen', 'col', 'sgt', 'capt', 'lt', 'cmdr', 'adm', 'gov', 'sen', 'rep',
    'rev', 'hon', 'pres', 'supt', 'det', 'mt', 'ft', 'approx',
}

# A sentence ends at [.!?]+ (optionally followed by closing quotes/brackets)
# when followed by whitespace and an upper-case letter, digit, or opening
# quote.
_BOUNDARY = re.compile(r'([.!?]+[\'")\]]*)\s+(?=["\'(\[]?[A-Z0-9])')


def _looks_like_abbreviation(text_before):
  last = text_before.rsplit(None, 1)[-1] if text_before.strip() else ''
  last = last.lstrip('("\'[')
  core = last[:-1] if last.endswith('.') else last
  core_l = core.lower()
  if core_l in _ABBREVIATIONS:
    return True
  # Single capital letter ("A."), or dotted initialisms ("U.S.").
  if len(core) == 1 and core.isalpha() and core.isupper():
    return True
  if re.fullmatch(r'(?:[A-Za-z]\.)+[A-Za-z]?', core):
    return True
  return False


def _rule_based_split(text):
  sentences = []
  start = 0
  for m in _BOUNDARY.finditer(text):
    end = m.end(1)
    if text[end - 1] == '.' or (m.group(1) and m.group(1)[0] == '.'):
      if _looks_like_abbreviation(text[start:end]):
        continue
    piece = text[start:end].strip()
    if piece:
      sentences.append(piece)
    start = m.end()
  tail = text[start:].strip()
  if tail:
    sentences.append(tail)
  return sentences


_nltk_punkt = None


def _try_punkt():
  global _nltk_punkt
  if _nltk_punkt is None:
    try:
      import nltk
      # Probe by actually segmenting: nltk's data requirements differ across
      # versions (punkt vs punkt_tab), so a data.find() check is unreliable.
      nltk.tokenize.sent_tokenize('Probe one. Probe two.')
      _nltk_punkt = nltk.tokenize.sent_tokenize
    except Exception:
      _nltk_punkt = False
  return _nltk_punkt


def resolve_backend(backend='auto'):
  """Resolve 'auto' to the concrete backend this host would use.

  Pipelines must resolve once (and broadcast) before fanning out, so that
  the segmentation — and therefore shard content — never depends on which
  worker host happens to have nltk data installed.
  """
  if backend == 'auto':
    return 'punkt' if _try_punkt() else 'rules'
  return backend


def split_sentences(text, backend='auto'):
  """Split a document into sentences.

  backend: 'auto' (punkt when its data is usable, else rules),
  'punkt', or 'rules'.
  """
  backend = resolve_backend(backend)
  if backend == 'punkt':
    import nltk
    return nltk.tokenize.sent_tokenize(text)
  return _rule_based_split(text)
