"""Realistic synthetic corpus generation for benchmarks and tests.

Copied whole from :mod:`lddl_tpu.core.synth`: the same seed writes the
same corpus, byte for byte, in either package.

This fleet has no network egress, so benchmarks cannot download Wikipedia;
a toy corpus, however, understates tokenizer cost (a 55-token vocabulary
against 7 suffixes is not WordPiece against 30,522 entries). This
generator instead reproduces the statistics WordPiece and the preprocess
pipeline actually pay for:

  - a **Zipf-Mandelbrot word-frequency curve** over ~50k distinct word
    types (s ~= 1.07, like natural language), function words on top;
  - **English-like morphology**: a shared stem pool crossed with a
    productive suffix system, so a trained 30k vocab is ##-dense and
    longest-match does real multi-probe work on rare inflections;
  - **punctuation, digits, capitalization** at prose-like rates (commas,
    quotes, parentheses, years, decimals), which exercise the
    normalizer's split paths;
  - a sprinkle of **non-ASCII** (accented Latin, Greek, Cyrillic, CJK) at
    roughly English-Wikipedia rates, hitting the normalizer's hard paths;
  - lognormal **sentence/document lengths** (sentences avg ~17 words,
    documents avg ~12 sentences).

Generation is vectorized (one cumulative-probability ``searchsorted`` per
shard, Python only at the sentence-join level): ~10 MB/s/core, so corpus
synthesis never dominates a benchmark's untimed setup.

The companion vocab (``benchmarks/assets/bench_vocab_30522.txt``) is a
real 30,522-entry WordPiece model trained on this distribution with the
HuggingFace ``tokenizers`` trainer — see ``benchmarks/make_bench_vocab.py``.
"""

import os

import numpy as np

_FUNCTION_WORDS = (
    'the of and to in a is that for it as was with be by on not he this are '
    'at from his but an they which one you were her all she there would '
    'their we him been has when who will no more if out so up said what its '
    'about than into them can only other time new some could these two may '
    'first then do any like my now over such our man me even most made '
    'after also did many off before must well back through years where much '
    'your way down should because each just those people how too little '
    'state good very make world still see own men work long here get both '
    'between life being under never day same another know while last might '
    'us great old year come since against go came right used take three '
    'himself few house use during without again place american around '
    'however home small found mrs thought went say part once high general '
    'upon school every').split()

_ONSETS = ('b c d f g h j k l m n p r s t v w z bl br ch cl cr dr fl fr gl '
           'gr pl pr sc sh sk sl sm sn sp st str sw th tr tw wh').split()
_VOWELS = 'a e i o u a e i o ai ea ee ie oa oo ou y'.split()
_CODAS = ('b ck d g k l ll m n nd ng nt p r rd rk rm rn rt s ss st t tch '
          'th x').split()
_SUFFIXES = ('s ed ing ly er est ion tion ment ness ful less able ible al '
             'ous ive ity ize ise ist ism ance ence ant ent ate ary ery ory '
             'ish hood ship ward wise').split()
_ACCENT_MAP = str.maketrans('aeioucn', 'áéíóüçñ')
_GREEK = ['αλφα', 'βητα', 'γαμμα', 'δελτα', 'λογος', 'κοσμος', 'θεωρια',
          'φυσις', 'μετρον', 'πολις']
_CYRILLIC = ['москва', 'россия', 'город', 'народ', 'война', 'мир', 'книга',
             'слово', 'время', 'земля']
_CJK_CHARS = '中国日本人民大学生活世界文化歴史東京北京上海'


def _make_stem(r):
  n_syll = r.choices((1, 2, 3), weights=(30, 50, 20))[0]
  parts = []
  for _ in range(n_syll):
    parts.append(r.choice(_ONSETS))
    parts.append(r.choice(_VOWELS))
    if r.random() < 0.55:
      parts.append(r.choice(_CODAS))
  return ''.join(parts)


def build_word_population(n_types=50000, seed=20260730):
  """(words list[str], probabilities float64[n]) — Zipf-Mandelbrot ranked.

  Deterministic in (n_types, seed). Function words occupy the top ranks;
  content words are stem x suffix crosses (morphological families), with
  numeral and non-ASCII types mixed through the tail.
  """
  import random as _random
  r = _random.Random(seed)
  words = list(_FUNCTION_WORDS)
  target_content = n_types - len(words)
  # Stem pool sized so suffix crosses create deep families: every stem
  # appears with several inflections, teaching the trained vocab its
  # stems and ## suffixes.
  stems = []
  seen = set(words)
  while len(stems) < max(1200, target_content // 9):
    s = _make_stem(r)
    if 3 <= len(s) <= 14 and s not in seen:
      seen.add(s)
      stems.append(s)
  content = []
  while len(content) < target_content:
    stem = r.choice(stems)
    roll = r.random()
    if roll < 0.30:
      w = stem
    elif roll < 0.88:
      w = stem + r.choice(_SUFFIXES)
    elif roll < 0.93:
      w = stem + '-' + r.choice(stems)          # hyphenated compounds
    elif roll < 0.965:
      kind = r.random()
      if kind < 0.5:
        w = str(r.randrange(1800, 2031))         # years
      elif kind < 0.8:
        w = str(r.randrange(0, 100000))
      else:
        w = f'{r.randrange(0, 100)}.{r.randrange(0, 100)}'
    elif roll < 0.985:
      w = stem.translate(_ACCENT_MAP)            # accented Latin
    elif roll < 0.995:
      w = r.choice(_GREEK if r.random() < 0.5 else _CYRILLIC)
    else:
      w = ''.join(r.choice(_CJK_CHARS) for _ in range(r.randrange(1, 3)))
    if w not in seen:
      seen.add(w)
      content.append(w)
  words += content
  ranks = np.arange(1, len(words) + 1, dtype=np.float64)
  probs = 1.0 / (ranks + 2.7) ** 1.07            # Zipf-Mandelbrot
  probs /= probs.sum()
  return words, probs


def generate_documents(words, probs, target_bytes, seed=0):
  """Yield one-document strings (no doc-id prefix) totalling ~target_bytes.

  Sentences: capitalized, terminal [.?!], ~22% contain a comma clause,
  ~4% quoted, ~3% parenthesized aside. One cumulative ``searchsorted``
  per refill keeps the hot path in numpy.
  """
  rng = np.random.default_rng(seed)
  arr = np.array(words, dtype=object)
  cum = np.cumsum(probs)
  cum[-1] = 1.0

  written = 0
  buf_tokens = arr[np.searchsorted(cum, rng.random(1 << 18))]
  buf_pos = 0

  def take(n):
    nonlocal buf_tokens, buf_pos
    if buf_pos + n > len(buf_tokens):
      buf_tokens = arr[np.searchsorted(cum, rng.random(max(1 << 18, n)))]
      buf_pos = 0
    out = buf_tokens[buf_pos:buf_pos + n]
    buf_pos += n
    return out

  while written < target_bytes:
    n_sents = int(np.clip(rng.lognormal(2.35, 0.65), 2, 60))
    sent_lens = np.clip(
        rng.lognormal(2.75, 0.45, size=n_sents), 4, 45).astype(np.int64)
    u = rng.random((n_sents, 3))
    sents = []
    for k in range(n_sents):
      toks = take(int(sent_lens[k]))
      if u[k, 0] < 0.22 and len(toks) >= 8:      # comma clause
        cut = 2 + int(u[k, 2] * (len(toks) - 4))
        s = ' '.join(toks[:cut]) + ', ' + ' '.join(toks[cut:])
      else:
        s = ' '.join(toks)
      s = s[:1].upper() + s[1:]
      if u[k, 1] < 0.04:
        s = '"' + s + '"'
      elif u[k, 1] < 0.07:
        s += ' (' + str(take(1)[0]) + ')'
      term = '.' if u[k, 2] < 0.93 else ('?' if u[k, 2] < 0.97 else '!')
      sents.append(s + term)
    doc = ' '.join(sents)
    written += len(doc) + 1
    yield doc


def write_corpus(out_dir, target_mb, num_shards=4, seed=0, id_prefix='synth'):
  """Write a one-document-per-line corpus (first token = doc id — the
  downloader output contract, reference ``wikipedia.py:62-63``) sharded
  round-robin. Returns actual MB written."""
  os.makedirs(out_dir, exist_ok=True)
  words, probs = build_word_population()
  target = int(target_mb * 1024 * 1024)
  files = []
  try:
    files.extend(
        open(os.path.join(out_dir, f'{i}.txt'), 'w', encoding='utf-8')
        for i in range(num_shards))
    written = 0
    for doc_id, doc in enumerate(
        generate_documents(words, probs, target, seed=seed)):
      line = f'{id_prefix}-{doc_id} {doc}\n'
      files[doc_id % num_shards].write(line)
      written += len(line.encode('utf-8'))
      if written >= target:
        break
  finally:
    for f in files:
      f.close()
  return written / (1024 * 1024)
