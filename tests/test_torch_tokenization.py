"""The port's WordPiece tokenizer and native encoder against lddl_tpu's.

The same texts through the port's ``load_bert_tokenizer`` (its C++
encoder, ``lddl_tpu_torch/native/src/wordpiece.cpp``) and through
lddl_tpu's ``load_bert_tokenizer`` with ``backend='hf'`` (HuggingFace's
``BertTokenizerFast``, the oracle) and ``backend='native'`` (lddl_tpu's
C++ encoder, which the port copies), over the bench vocab: flat ids and
offsets equal. Two departures are named and shown: outside the Latin,
Greek and Cyrillic blocks the port keeps lddl_tpu's native ids (no accent
stripping, as HF does), and inside them the port's generated fold tables
give HF's ids where lddl_tpu's hand-written folding does not. Also: the
thread count, pickling, a failing compiler, the refused backends, and the
loaders that never build the encoder.
"""

import os
import pickle
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest

from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer as jax_tok
from lddl_tpu_torch.native import NativeWordPiece
from lddl_tpu_torch.native import build as native_build
from lddl_tpu_torch.tokenization.wordpiece import (BertWordPiece,
                                                   load_bert_tokenizer)


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = Path(__file__).resolve().parent.parent
VOCAB = str(ROOT / 'benchmarks' / 'assets' / 'bench_vocab_30522.txt')
# The fold tables' ranges (lower_strip in the C++ source).
TABLE_RANGES = ((0xC0, 0x250), (0x370, 0x500))


def _synth(seed=3, target_bytes=48 << 10):
  from lddl_tpu.core import synth
  words, probs = synth.build_word_population()
  return list(synth.generate_documents(words, probs, target_bytes,
                                       seed=seed))


CASES = {
    'synth': _synth(),
    'case_accents_greek_cyrillic_cjk': [
        'Hello World HELLO world hElLo', 'café naïve Zürich Straße Ångström',
        'Français ÜBER résumé façade jalapeño', 'Δοκιμή ΑΒΓ αλφα Σίσυφος',
        'ОЧЕНЬ Москва Ёлка война Київ', '中国 日本人 漢字かな 한국어',
        'mixed中文words and Ελληνικά', 'ÀÉÎÕÜ àéîõü ÇÑ çñ'],
    'punctuation_control': [
        'U.S. e.g. Mr. 3.14 hello-world "quote" it\'s (paren) [brk]',
        '¡Hola! ¿Qué? «guillemets» — dashes – and … ellipsis',
        'tab\tnew\nline\rcarriage zero\x00width​joiner soft\xadhyphen',
        'bell\x07 del\x7f bom﻿ nbsp\xa0thin space ideo　sp',
        '中文，标点。「引号」！', 'a,b;c:d!e?f/g\\h|i@j#k$l%m^n&o*p'],
    'long_word_unk': [
        'a' * 101, 'b' * 100 + ' ok', 'short ' + 'x' * 150 + ' tail',
        'é' * 120, '中' * 130],
    'empty_whitespace': ['', ' ', '   ', '\t\n', '　 ', 'a  b'],
}


def _equal(got, want):
  return (np.array_equal(got[0], want[0]) and
          np.array_equal(got[1], want[1]) and got[0].dtype == np.int32 and
          got[1].dtype == np.int64)


@pytest.fixture(scope='module')
def hf():
  return {lc: jax_tok(vocab_file=VOCAB, backend='hf', lowercase=lc)
          for lc in (True, False)}


@pytest.fixture(scope='module')
def jax_native():
  return {lc: jax_tok(vocab_file=VOCAB, backend='native', lowercase=lc)
          for lc in (True, False)}


@pytest.fixture(scope='module')
def port():
  return {lc: load_bert_tokenizer(VOCAB, lowercase=lc)
          for lc in (True, False)}


@pytest.mark.parametrize('lowercase', [True, False],
                         ids=['lowercase', 'cased'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_ids_equal_hf(hf, port, case, lowercase):
  """Flat ids and offsets equal lddl_tpu's HF tokenizer's, in one batch
  and text by text; tokenize/batch_tokenize give HF's tokens."""
  texts = CASES[case]
  want = hf[lowercase].encode_batch_ids(texts)
  assert _equal(port[lowercase].encode_batch_ids(texts), want)
  for text in texts:
    assert _equal(port[lowercase].encode_batch_ids([text]),
                  hf[lowercase].encode_batch_ids([text]))
  words = port[lowercase].vocab_words
  assert port[lowercase].batch_tokenize(texts) == [
      [words[i] for i in want[0][want[1][k]:want[1][k + 1]]]
      for k in range(len(texts))]
  assert port[lowercase].tokenize(texts[-1]) == hf[lowercase].tokenize(
      texts[-1])


@pytest.mark.parametrize('max_tokens', [1, 7, 64])
@pytest.mark.parametrize('case', sorted(CASES))
def test_max_tokens_truncation_equals_hf(hf, port, case, max_tokens):
  texts = CASES[case]
  got = port[True].encode_batch_ids(texts, max_tokens=max_tokens)
  assert _equal(got, hf[True].encode_batch_ids(texts, max_tokens=max_tokens))
  assert np.diff(got[1]).max(initial=0) <= max_tokens


def _in_tables(text):
  return any(lo <= ord(c) < hi for c in text for lo, hi in TABLE_RANGES)


@pytest.mark.parametrize('lowercase', [True, False],
                         ids=['lowercase', 'cased'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_ids_equal_lddl_tpus_native_encoder(jax_native, hf, port, case,
                                            lowercase):
  """The port's encoder is lddl_tpu's copied: each text's ids are its
  ids, except in texts with a letter of the fold tables' ranges, where
  they may differ and are then HF's (the second departure, below)."""
  for text in CASES[case]:
    got = port[lowercase].encode_batch_ids([text])
    if _equal(got, jax_native[lowercase].encode_batch_ids([text])):
      continue
    assert lowercase and _in_tables(text), text
    assert _equal(got, hf[lowercase].encode_batch_ids([text])), text


def test_departure_exotic_scripts_follow_lddl_tpus_native_encoder(
    hf, jax_native, port):
  """Departure from HF, kept from lddl_tpu: outside ASCII, the Latin,
  Greek and Cyrillic blocks and CJK, codepoints pass through without
  accent stripping or lowercasing (Latin Extended Additional, as in
  Vietnamese, and polytonic Greek), so the ids are lddl_tpu's native
  encoder's, not HF's."""
  texts = ['Việt Nam', 'ὁ', 'Ṁ', 'Ḗ']
  for text in texts:
    got = port[True].encode_batch_ids([text])
    assert _equal(got, jax_native[True].encode_batch_ids([text])), text
    assert not _equal(got, hf[True].encode_batch_ids([text])), text


def test_departure_fold_tables_give_hfs_ids_where_lddl_tpu_does_not(
    hf, jax_native, port):
  """Departure from lddl_tpu's native encoder: its hand-written folding
  keeps the breve of Cyrillic й, lowercases Ё without its diaeresis,
  keeps Greek tonos letters and strips L with stroke to l; HF folds each
  by NFD and lowercase, and so does the port's table."""
  for text in ('война', 'Ёлка', 'ά', 'Łódź'):
    got = port[True].encode_batch_ids([text])
    assert _equal(got, hf[True].encode_batch_ids([text])), text
    assert not _equal(got, jax_native[True].encode_batch_ids([text])), text


def _fold(cp):
  return ''.join(c for c in unicodedata.normalize('NFD', chr(cp))
                 if unicodedata.category(c) != 'Mn').lower()


@pytest.mark.parametrize('lowercase', [True, False],
                         ids=['lowercase', 'cased'])
def test_fold_tables_equal_hf_codepoint_by_codepoint(tmp_path, lowercase):
  """Every codepoint of the tables' ranges, alone and between ASCII
  letters, over a vocab that holds every codepoint and every fold, so
  each fold has an id of its own: the port's ids are HF's. Cased, the
  two punctuation marks of the ranges (U+037E, U+0387) are not split off
  as HF splits them: the encoder's punctuation set is a list, not
  Unicode's P categories, as in lddl_tpu, whose ids the port keeps there
  (lowercased, they fold to ';' and U+00B7, which the list holds)."""
  cps = [cp for lo, hi in TABLE_RANGES for cp in range(lo, hi)]
  words = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]']
  words += [chr(c) for c in range(ord('a'), ord('z') + 1)]
  words += [chr(cp) for cp in cps] + [_fold(cp) for cp in cps if _fold(cp)]
  words += ['##' + w for w in list(words[5:])]
  vocab = tmp_path / 'vocab.txt'
  vocab.write_text('\n'.join(dict.fromkeys(words)) + '\n', encoding='utf-8')
  port_tok = load_bert_tokenizer(str(vocab), lowercase=lowercase)
  refs = {b: jax_tok(vocab_file=str(vocab), backend=b, lowercase=lowercase)
          for b in ('hf', 'native')}
  punct = {cp for cp in cps
           if unicodedata.category(chr(cp)).startswith('P')}
  assert punct == {0x37E, 0x387}
  texts = [f'{chr(cp)} q{chr(cp)}z' for cp in cps]
  got = port_tok.encode_batch_ids(texts)
  if lowercase:
    assert _equal(got, refs['hf'].encode_batch_ids(texts))
  for cp, text in zip(cps, texts):
    ref = refs['native' if cp in punct and not lowercase else 'hf']
    assert _equal(port_tok.encode_batch_ids([text]),
                  ref.encode_batch_ids([text])), hex(cp)


def test_output_does_not_depend_on_the_thread_count():
  """1 thread against 8 (and 3) over enough texts for every thread's word
  cache to switch on: the same ids and offsets."""
  words = [w.rstrip('\n') for w in open(VOCAB, encoding='utf-8')]
  texts = CASES['synth'] * 4
  out = [NativeWordPiece(words, num_threads=n).encode_batch_ids(texts)
         for n in (1, 8, 3)]
  assert _equal(out[1], out[0]) and _equal(out[2], out[0])
  assert _equal(BertWordPiece(VOCAB).encode_batch_ids(texts), out[0])


def test_not_picklable():
  enc = load_bert_tokenizer(VOCAB).encoder()
  with pytest.raises(TypeError, match='not picklable'):
    pickle.dumps(enc)


def test_a_failing_compiler_raises_with_no_fallback(tmp_path, monkeypatch):
  """A source that does not compile raises at the first encode and names
  the compiler's output; the tokenizer is left with no encoder, and the
  next encode raises again. No compiler at all raises too."""
  bad = tmp_path / 'wordpiece.cpp'
  bad.write_text('this is not C++\n')
  monkeypatch.setattr(native_build, 'SOURCE', bad)
  monkeypatch.setattr(native_build, 'BUILD_DIR', tmp_path / 'build')
  monkeypatch.setattr(native_build, '_lib', None)
  tok = load_bert_tokenizer(VOCAB)
  for _ in range(2):
    with pytest.raises(RuntimeError, match='failed .* building'):
      tok.encode_batch_ids(['hello world'])
  assert tok._native is None
  assert not list((tmp_path / 'build').glob('*.so'))
  monkeypatch.setattr(native_build.shutil, 'which', lambda name: None)
  with pytest.raises(RuntimeError, match='no C\\+\\+ compiler'):
    tok.tokenize('hello')


def test_the_library_is_named_by_its_toolchain(monkeypatch):
  here = native_build.library_path()
  cxx, version, machine = native_build._toolchain()
  monkeypatch.setattr(native_build, '_toolchain',
                      lambda: (cxx, version + ' (another build)', machine))
  assert native_build.library_path() != here
  monkeypatch.setattr(native_build, '_toolchain',
                      lambda: (cxx, version, 'other'))
  assert native_build.library_path() != here
  assert here.name.startswith('wordpiece-')


@pytest.mark.parametrize('kwargs,match', [
    (dict(vocab_file=VOCAB, hub_name='bert-base-uncased'), 'hub_name'),
    (dict(vocab_file=VOCAB, backend='hf'), "backend='hf'"),
    (dict(vocab_file=VOCAB, backend='rust'), 'unknown tokenizer backend'),
    (dict(), 'need vocab_file')], ids=['hub', 'hf', 'other', 'no-vocab'])
def test_refused_tokenizers_raise(kwargs, match):
  with pytest.raises(ValueError, match=match):
    load_bert_tokenizer(**kwargs)


def test_auto_means_native(hf):
  tok = load_bert_tokenizer(VOCAB, backend='auto')
  texts = CASES['case_accents_greek_cyrillic_cjk']
  assert _equal(tok.encode_batch_ids(texts), hf[True].encode_batch_ids(texts))


def test_vocab_lookups_and_specials_equal_hf(hf):
  tok = load_bert_tokenizer(VOCAB)
  h = hf[True].hf
  for name in ('cls', 'sep', 'mask', 'pad', 'unk'):
    assert getattr(tok, f'{name}_token') == getattr(h, f'{name}_token')
    assert getattr(tok, f'{name}_token_id') == getattr(h, f'{name}_token_id')
  assert tok.vocab_words == hf[True].vocab_words
  assert tok.vocab_size == hf[True].vocab_size
  assert tok.lowercase is True
  assert load_bert_tokenizer(VOCAB, lowercase=False).lowercase is False


def test_the_bert_packed_and_codebert_loaders_build_no_encoder():
  """They read tokens or ids from their shards: a batch of each, in a
  fresh process, neither builds nor loads the encoder's library."""
  code = f'''
import json, sys
from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                   get_codebert_pretrain_data_loader,
                                   get_packed_pretrain_data_loader)
shards = {str(ROOT / 'tests' / 'assets' / 'torch_shards')!r}
with open(shards + '/digests.json') as f:
  d = json.load(f)
for name, make in (('pairs', get_bert_pretrain_data_loader),
                   ('packed', get_packed_pretrain_data_loader),
                   ('codebert', get_codebert_pretrain_data_loader)):
  loader = make(shards + '/' + name, vocab_file={VOCAB!r},
                **d[name]['settings'])
  next(iter(loader))
from lddl_tpu_torch.native import build
with open('/proc/self/maps') as f:
  print(build._lib is None, build.build_info['seconds'], 'wordpiece-' in f.read())
'''
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip().splitlines()[-1] == 'True None False'
