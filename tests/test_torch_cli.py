"""The port's command table, ``python -m lddl_tpu_torch.cli``, on the CPU.

Every name of ``lddl_tpu.cli`` has a counterpart in the port's table, each
delegate reaches its module's ``--help``, and ``lddl_analyze`` runs the
port's analyzer (``lddl_tpu_torch.analysis.cli``). The counterparts of
``tests/test_download_cli.py``'s CLI cases: the usage (exit 2); the BERT
preprocess, the balancer and the cache command end to end through the
table, the same rows and sample counts as lddl_tpu's table writes; BART
through the table; and the offline Wikipedia step as a user runs it,
``python -m lddl_tpu_torch.cli download_wikipedia --no-download
--no-extract``, byte-equal to lddl_tpu's.
"""

import json
import os
import subprocess
import sys

import pyarrow.parquet as pq
import pytest

from lddl_tpu import cli as jcli
from lddl_tpu_torch import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The commands here make no shm segment; the shared fixture would count
  # other xdist workers' segments as this test's leak.
  yield


def _rows(sink):
  return {n: pq.read_table(os.path.join(sink, n)).to_pylist()
          for n in sorted(os.listdir(sink)) if '.parquet' in n}


def test_every_lddl_tpu_name_has_a_counterpart():
  assert set(tcli._COMMANDS) == set(jcli._COMMANDS)
  for name, fn in jcli._COMMANDS.items():
    # The same command under the same name (aliases alias the same one).
    assert tcli._COMMANDS[name].__name__ == fn.__name__, name


@pytest.mark.parametrize('name', sorted(
    n for n in tcli._COMMANDS if '-' not in n))
def test_each_delegate_reaches_its_module(name, capsys):
  with pytest.raises(SystemExit) as e:
    tcli._COMMANDS[name](['--help'])
  assert e.value.code == 0
  assert 'usage' in capsys.readouterr().out


def test_the_analyzer_runs_by_name(tmp_path, capsys, monkeypatch):
  """``lddl_analyze`` and ``lddl-analyze`` run the port's analyzer: its
  exit code (1 on an unsuppressed finding, 0 on a clean tree) and its
  JSON document; with no path it lints ./lddl_tpu_torch."""
  pkg = tmp_path / 'pkg'
  pkg.mkdir()
  (pkg / '__init__.py').write_text('')
  (pkg / 'm.py').write_text('import torch.distributed as dist\n\n\n'
                            'def f(rank, t):\n'
                            '  if rank == 0:\n'
                            '    dist.all_reduce(t)\n')
  for name in ('lddl_analyze', 'lddl-analyze'):
    assert tcli.main([name, '--format', 'json', str(pkg)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f['rule'] for f in doc['findings']] == ['LDA005']
    assert doc['mode'] == 'project' and doc['files_scanned'] == 2
  monkeypatch.chdir(ROOT)
  assert tcli.main(['lddl_analyze', '--no-project', '--rule', 'LDA001']) == 0
  assert 'files (files mode), 0 finding(s)' in capsys.readouterr().out


def test_usage(capsys):
  assert tcli.main([]) == 2
  assert tcli.main(['no_such_command']) == 2
  out = capsys.readouterr().out
  assert 'python -m lddl_tpu_torch.cli' in out
  assert 'preprocess_bert_pretrain' in out and 'lddl-replay' in out


def test_end_to_end_through_the_table(tmp_path, tiny_vocab, tmp_corpus):
  """preprocess -> balance -> cache through both tables: the same rows,
  the same balanced counts."""
  out = {}
  for name, cli in (('t', tcli), ('j', jcli)):
    sink, bal = str(tmp_path / f'{name}sink'), str(tmp_path / f'{name}bal')
    cli.preprocess_bert_pretrain([
        '--source', tmp_corpus, '--sink', sink, '--vocab-file', tiny_vocab,
        '--num-blocks', '2', '--num-workers', '1', '--bin-size', '64',
        '--sample-ratio', '1.0', '--sentence-backend', 'rules'])
    cli.balance_shards(['--indir', sink, '--outdir', bal, '--num-shards',
                        '2'])
    os.remove(os.path.join(bal, '.num_samples.json'))
    cli.generate_num_samples_cache(['--path', bal])
    with open(os.path.join(bal, '.num_samples.json')) as f:
      out[name] = (_rows(sink), _rows(bal), json.load(f))
  assert any(n.endswith('.parquet_0') for n in out['t'][0])
  assert out['t'] == out['j']


def test_bart_through_the_table(tmp_path, tmp_corpus):
  rows = {}
  for name, cli in (('t', tcli), ('j', jcli)):
    sink = str(tmp_path / f'{name}bart')
    cli.preprocess_bart_pretrain([
        '--source', tmp_corpus, '--sink', sink, '--num-blocks', '2',
        '--num-workers', '1', '--sentence-backend', 'rules',
        '--sample-ratio', '1.0'])
    rows[name] = _rows(sink)
  assert rows['t'] and rows['t'] == rows['j']


def test_download_wikipedia_as_a_user_runs_it(tmp_path):
  """The offline step through ``python -m lddl_tpu_torch.cli`` (exit 0)
  and lddl_tpu's table: the same source shards, byte for byte."""
  for name in ('t', 'j'):
    d = tmp_path / name / 'extracted' / 'en' / 'AA'
    os.makedirs(d)
    for i in range(3):
      (d / f'wiki_{i:02d}').write_text(''.join(
          f'<doc id="{i}{j}" url="u" title="T">\nT\n\nArticle {i} {j} '
          f'body.\nMore text.\n</doc>\n' for j in range(4)))
  proc = subprocess.run(
      [sys.executable, '-m', 'lddl_tpu_torch.cli', 'download_wikipedia',
       '--outdir', str(tmp_path / 't'), '--no-download', '--no-extract',
       '--num-shards', '2', '--num-workers', '2'],
      cwd=ROOT, capture_output=True, text=True, timeout=120,
      env=dict(os.environ, PYTHONPATH=ROOT))
  assert proc.returncode == 0, proc.stderr
  assert 'sharded 12 articles into 2 shards' in proc.stdout
  jcli.download_wikipedia(['--outdir', str(tmp_path / 'j'), '--no-download',
                           '--no-extract', '--num-shards', '2'])
  for i in range(2):
    path = os.path.join('source', 'en', f'{i}.txt')
    with open(tmp_path / 't' / path, 'rb') as f, \
        open(tmp_path / 'j' / path, 'rb') as g:
      assert f.read() == g.read()
