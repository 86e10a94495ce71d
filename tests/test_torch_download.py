"""The port's downloaders' offline steps against lddl_tpu's, on the CPU.

The counterparts of ``tests/test_download_cli.py`` and
``tests/test_codesearchnet.py``: each offline step (shard documents,
parse and shard wikiextractor output, books and pages, the Common Crawl
spools and article sink, CodeSearchNet's split, extract and shard) runs
in both packages over the same input, and the port's output files equal
lddl_tpu's byte for byte; sharding at several worker processes (the
port's from the forkserver) equals one. The network and third-party steps
are never called: where their tool is absent they raise a named error,
as lddl_tpu's do, and ``train-tokenizer`` (transformers) raises before
any step runs.
"""

import gzip
import json
import multiprocessing
import os
import pickle
import sys
import threading
import types

import pytest

from lddl_tpu.download import books as jbooks
from lddl_tpu.download import codesearchnet as jcsn
from lddl_tpu.download import common_crawl as jcc
from lddl_tpu.download import openwebtext as jowt
from lddl_tpu.download import utils as jutils
from lddl_tpu.download import wikipedia as jwiki
from lddl_tpu_torch.download import books as tbooks
from lddl_tpu_torch.download import codesearchnet as tcsn
from lddl_tpu_torch.download import common_crawl as tcc
from lddl_tpu_torch.download import openwebtext as towt
from lddl_tpu_torch.download import utils as tutils
from lddl_tpu_torch.download import wikipedia as twiki


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The downloaders make no shm segment; the shared fixture would count
  # other xdist workers' segments as this test's leak.
  yield


def _tree(root):
  """``{relative path: bytes}`` of every file under ``root``."""
  out = {}
  for d, _, names in os.walk(root):
    for n in names:
      p = os.path.join(d, n)
      with open(p, 'rb') as f:
        out[os.path.relpath(p, root)] = f.read()
  return out


def _extracts(root, n_files=5, docs_per_file=4):
  """A wikiextractor output tree: ``AA/wiki_NN`` files of ``<doc>``
  blocks, a title line, blank and body lines, non-ASCII text."""
  d = os.path.join(root, 'AA')
  os.makedirs(d)
  for i in range(n_files):
    blocks = []
    for j in range(docs_per_file):
      blocks.append(f'<doc id="{i}-{j}" url="u?curid={i}" title="T {j}">\n'
                    f'T {j}\n\nbody of doc {i} {j}.\n  Zweite Zeile, '
                    f'ünïcode {i}.\n\n</doc>\n')
    with open(os.path.join(d, f'wiki_{i:02d}'), 'w', encoding='utf-8') as f:
      f.write(''.join(blocks))
  return root


@pytest.mark.parametrize('num_shards', [1, 3])
def test_shard_documents(tmp_path, num_shards):
  docs = [(f'd{i}', f'line one\nline  two {i}') for i in range(7)] + [
      ('empty', '   \n '), ('x', 'tail')]
  got = tutils.shard_documents(iter(docs), str(tmp_path / 't'), num_shards)
  want = jutils.shard_documents(iter(docs), str(tmp_path / 'j'), num_shards)
  assert got == want
  assert _tree(tmp_path / 't') == _tree(tmp_path / 'j')


def test_parse_extracted_shard(tmp_path):
  p = tmp_path / 'wiki_00'
  p.write_text('<doc id="12" url="u" title="Anarchism">\nAnarchism\n\n'
               'Anarchism is a philosophy.\nIt questions authority.\n</doc>\n'
               '<doc id="25" url="u" title="Autism">\nAutism\n'
               'Autism is a condition.\n</doc>\n<doc id="9" url="u" '
               'title="Empty">\nEmpty\n</doc>\n')
  got = list(twiki.parse_extracted_shard(str(p)))
  assert got == list(jwiki.parse_extracted_shard(str(p)))
  assert got == [
      ('wiki-12', 'Anarchism is a philosophy. It questions authority.'),
      ('wiki-25', 'Autism is a condition.')]


@pytest.mark.parametrize('workers', [1, 3])
def test_wikipedia_shard_extracted(tmp_path, workers):
  extract = _extracts(str(tmp_path / 'extracted'))
  for shards in (3, 8):
    got = twiki.shard_extracted(extract, str(tmp_path / f't{shards}'),
                                shards, num_workers=workers)
    want = jwiki.shard_extracted(extract, str(tmp_path / f'j{shards}'),
                                 shards, num_workers=1)
    assert got == want and sum(got) == 20
    assert _tree(tmp_path / f't{shards}') == _tree(tmp_path / f'j{shards}')


def test_the_wikipedia_cli_offline(tmp_path):
  """``--no-download --no-extract`` over ``<outdir>/extracted/<lang>``:
  the same ``source/<lang>`` shards."""
  for name in ('t', 'j'):
    _extracts(str(tmp_path / name / 'extracted' / 'en'))
  twiki.main(['--outdir', str(tmp_path / 't'), '--no-download',
              '--no-extract', '--num-shards', '4', '--num-workers', '2'])
  jwiki.main(['--outdir', str(tmp_path / 'j'), '--no-download',
              '--no-extract', '--num-shards', '4', '--num-workers', '1'])
  got = _tree(tmp_path / 't' / 'source')
  assert got == _tree(tmp_path / 'j' / 'source') and len(got) == 4


def test_books_and_pages(tmp_path):
  src = tmp_path / 'books'
  for sub in ('a', 'b'):
    os.makedirs(src / sub)
    for k in range(3):
      (src / sub / f'{sub}{k}.epub.txt').write_text(
          f'Book {sub}{k}.\n\nChapter one: words\nand more words {k}.\n')
  for t, j, fn in ((tbooks, jbooks, 'shard_books'),
                   (towt, jowt, 'shard_pages')):
    got = getattr(t, fn)(str(src), str(tmp_path / f't_{fn}'), 4,
                         num_workers=2)
    want = getattr(j, fn)(str(src), str(tmp_path / f'j_{fn}'), 4,
                          num_workers=1)
    assert got == want and sum(got) == 6
    assert _tree(tmp_path / f't_{fn}') == _tree(tmp_path / f'j_{fn}')
  assert list(tbooks.read_books(str(src))) == list(jbooks.read_books(str(src)))
  assert list(towt.read_pages(str(src))) == list(jowt.read_pages(str(src)))


def test_common_crawl_spools(tmp_path):
  spool = tmp_path / 'spool'
  os.makedirs(spool)
  for t in range(4):
    with open(spool / f'articles-{t}.txt', 'w') as f:
      for k in range(3):
        f.write(f'ccnews-{t}-{k} article text {t} {k}\n')
    (spool / 'other.txt').write_text('not-a-spool x\n')
  assert list(tcc.read_spools(str(spool))) == list(jcc.read_spools(str(spool)))
  got = tcc.shard_spools(str(spool), str(tmp_path / 't'), 3, num_workers=2)
  want = jcc.shard_spools(str(spool), str(tmp_path / 'j'), 3, num_workers=1)
  assert got == want and sum(got) == 12
  assert _tree(tmp_path / 't') == _tree(tmp_path / 'j')


def test_empty_tail_shards_still_written(tmp_path):
  p = tmp_path / 'articles-0.txt'
  p.write_text('id-0 text\n')
  got = tutils.shard_text_files_parallel([str(p)], str(tmp_path / 'out'), 3,
                                         tcc._read_one_spool, num_workers=1)
  assert got == [1, 0, 0]
  assert sorted(os.listdir(tmp_path / 'out')) == ['0.txt', '1.txt', '2.txt']


def test_article_sink_threads(tmp_path):
  sink = tcc.ArticleSink(str(tmp_path / 'spool'), articles_per_flush=4)

  def worker(k):
    for i in range(5):
      sink(types.SimpleNamespace(maintext=f'text {k}-{i}', title=f'T{k}'))
    sink(types.SimpleNamespace(maintext='', title='dropped'))

  threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  sink.flush()
  docs = list(tcc.read_spools(str(tmp_path / 'spool')))
  assert len(docs) == 15 and len({d[0] for d in docs}) == 15
  assert sorted(d[1] for d in docs) == sorted(
      f'T{k} text {k}-{i}\n' for k in range(3) for i in range(5))


def test_article_sink_process_safe(tmp_path):
  """Forked extraction workers neither collide with the parent's spool
  files and ids nor lose their tails (flushed at their exit)."""
  spool = str(tmp_path / 'spool')
  sink = tcc.ArticleSink(spool, articles_per_flush=100)
  sink(types.SimpleNamespace(maintext='parent text', title='P'))

  def child(k):
    for i in range(3):
      sink(types.SimpleNamespace(maintext=f'child {k} {i}', title='C'))

  ctx = multiprocessing.get_context('fork')
  procs = [ctx.Process(target=child, args=(k,), daemon=True)
           for k in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(60)
    if p.is_alive():
      p.kill()
  assert all(p.exitcode == 0 for p in procs)
  sink.flush()
  docs = list(tcc.read_spools(spool))
  assert len(docs) == 7 and len({d[0] for d in docs}) == 7


def _codesearchnet(root, lang='python'):
  """tests/test_codesearchnet.py's dataset: two jsonl splits and a dedupe
  pickle with overlapping bodies, CRLF inside one."""
  funcs = {
      'train_a': 'def add(a, b):\r\n    return a + b',
      'train_b': 'def sub(a, b):\n    return a - b',
      'valid_a': 'def mul(a, b):\n    return a * b',
      'test_a': 'def div(a, b):\n    return a / b',
      'orphan': 'def pow(a, b):\n    return a ** b',
  }
  jsonl = {'train': ['train_a', 'train_b'], 'valid': ['valid_a'],
           'test': ['test_a']}
  for split, keys in jsonl.items():
    d = os.path.join(root, lang, 'final', 'jsonl', split)
    os.makedirs(d)
    with gzip.open(os.path.join(d, '0.jsonl.gz'), 'wt',
                   encoding='utf-8') as f:
      for k in keys:
        f.write(json.dumps({'code': funcs[k]}) + '\n')
  defs = [{'function': funcs[k], 'docstring': doc} for k, doc in (
      ('train_a', 'adds two numbers'), ('train_b', ''),
      ('valid_a', 'multiplies'), ('test_a', 'divides'),
      ('orphan', 'powers'))]
  with open(os.path.join(root, f'{lang}_dedupe_definitions_v2.pkl'),
            'wb') as f:
    pickle.dump(defs, f)


def test_codesearchnet_split_extract_shard(tmp_path):
  """``--steps split extract shard`` in both packages: the same pickles
  and blocks, byte for byte; the train split keeps the orphan."""
  data = str(tmp_path / 'data')
  os.makedirs(data)
  _codesearchnet(data)
  for name, mod in (('t', tcsn), ('j', jcsn)):
    mod.main(['--data-dir', data, '--outdir', str(tmp_path / name),
              '--langs', 'python', '--steps', 'split', 'extract', 'shard',
              '--num-blocks', '3', '--seed', '7'])
  got = _tree(tmp_path / 't')
  assert got == _tree(tmp_path / 'j')
  assert sorted(got) == sorted(
      ['python_train.pkl', 'python_valid.pkl', 'python_test.pkl',
       'extracted_train.pkl', 'extracted_valid.pkl', 'extracted_test.pkl'] +
      [os.path.join('source', f'block_{b}.txt') for b in range(3)])
  with open(tmp_path / 't' / 'python_train.pkl', 'rb') as f:
    assert sorted(i for i, _ in pickle.load(f)) == [
        'python_0', 'python_1', 'python_4']
  # Four records into four blocks fill all four.
  pkl = tmp_path / 'four.pkl'
  with open(pkl, 'wb') as f:
    pickle.dump((['a', 'b', 'c', 'd', 'e'], [''] * 5, ['x'] * 5), f)
  for name, mod in (('t4', tcsn), ('j4', jcsn)):
    mod.shard_data(str(pkl), str(tmp_path / name), num_blocks=4, seed=1)
  assert _tree(tmp_path / 't4') == _tree(tmp_path / 'j4')
  assert all(_tree(tmp_path / 't4').values())


def test_the_steps_that_need_what_the_port_lacks(tmp_path, monkeypatch):
  """``train-tokenizer`` raises its named error before any step runs; a
  network or third-party step whose tool is absent raises lddl_tpu's
  named error (the tools are hidden, nothing is fetched)."""
  with pytest.raises(tcsn.TokenizerTrainingNotPorted, match='transformers'):
    tcsn.main(['--data-dir', str(tmp_path / 'none'), '--outdir',
               str(tmp_path / 'w'), '--steps', 'split', 'train-tokenizer'])
  assert os.listdir(tmp_path / 'w') == []
  for tool in ('wikiextractor', 'newsplease', 'newsplease.crawler', 'gdown',
               'requests'):
    monkeypatch.setitem(sys.modules, tool, None)
  with pytest.raises(RuntimeError, match='wikiextractor is not installed'):
    twiki.extract_dump('dump.xml.bz2', str(tmp_path / 'x'))
  with pytest.raises(RuntimeError, match='news-please is not installed'):
    tcc.crawl(str(tmp_path / 's'), None, None)
  with pytest.raises(RuntimeError, match='gdown is not installed'):
    towt.gdown_fetch('url', str(tmp_path / 'a'))
  with pytest.raises(ImportError, match='requests'):
    tutils.download_file('url', str(tmp_path / 'f'))
