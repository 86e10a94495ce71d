"""The port's Parquet writer against lddl_tpu's (pyarrow's) files.

pyarrow is the oracle here: the port writes a shard partition with
``write_table_partition`` and lddl_tpu writes the same content with its
own; ``pq.read_table`` must read the same rows with the same Arrow types
from both, for both shard formats, masked and unmasked, binned and
unbinned, zero-row files and several row groups and pages. The shard
format tag round-trips through lddl_tpu's ``shard_format_of``, the port's
reader reads every file, and the LZ4_RAW pages decompress with
``pyarrow.Codec``. File bytes differ (``created_by``, no
``ARROW:schema``, page sizes), so parity is by rows.
"""

import os
import random

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from lddl_tpu.core.utils import serialize_np_array
from lddl_tpu.pipeline import parquet_io as jio
from lddl_tpu.pipeline import shard_format as jformat
from lddl_tpu.preprocess import bert as jbert
from lddl_tpu_torch.balance import plan_shards
from lddl_tpu_torch.pipeline import codecs
from lddl_tpu_torch.pipeline import parquet_io as tio
from lddl_tpu_torch.pipeline import shard_format as tformat
from lddl_tpu_torch.preprocess import bert as tbert

WORDS = ('the', 'of', '##ing', 'alpha', '[MASK]', 'délta', '漢字', 'x')


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def _rows(n, masking, fmt, seed=0):
  """``n`` rows of a BERT shard's columns (``bert_schema``'s order)."""
  r = random.Random(seed)
  words = lambda lo, hi: ' '.join(r.choice(WORDS)  # noqa: E731
                                  for _ in range(r.randrange(lo, hi)))
  rows = []
  for _ in range(n):
    row = {'A': words(1, 40), 'B': words(1, 60),
           'is_random_next': r.random() < 0.5,
           'num_tokens': r.randrange(4, 512)}
    if fmt == 'delta':
      for name in jformat.DELTA_COLUMNS:
        row[name] = serialize_np_array(np.asarray(
            [r.randrange(30522) for _ in range(r.randrange(0, 30))],
            np.uint16))
    elif masking:
      row['masked_lm_positions'] = serialize_np_array(np.asarray(
          [r.randrange(512) for _ in range(r.randrange(1, 20))], np.uint16))
      row['masked_lm_labels'] = words(1, 20)
    rows.append(row)
  return rows


CASES = [(False, 'materialized', None), (True, 'materialized', None),
         (True, 'materialized', 128), (True, 'delta', 128),
         (True, 'delta', None), (False, 'materialized', 64)]


@pytest.mark.parametrize('masking,fmt,bin_size', CASES, ids=[
    f'{"masked" if m else "unmasked"}-{f}-{"bin" + str(b) if b else "unbinned"}'
    for m, f, b in CASES])
def test_partitions_read_back_as_lddl_tpu_writes_them(tmp_path, masking, fmt,
                                                      bin_size):
  rows = _rows(300, masking, fmt, seed=len(fmt) + (bin_size or 0))
  nbins = 512 // bin_size if bin_size else None
  jschema = jformat.tag_schema(jbert.bert_schema(masking, fmt), fmt, 5)
  jout = jio.write_samples_partition(rows, jschema, str(tmp_path / 'j'), 3,
                                     bin_size=bin_size, nbins=nbins)
  tschema = tformat.tag_schema(tbert.bert_schema(masking, fmt), fmt, 5)
  tout = tio.write_samples_partition(rows, tschema, str(tmp_path / 't'), 3,
                                     bin_size=bin_size, nbins=nbins)
  assert sorted(os.path.basename(p) for p, _ in jout.values()) == sorted(
      os.path.basename(p) for p, _ in tout.values())
  assert {b: n for b, (_, n) in jout.items()} == {
      b: n for b, (_, n) in tout.items()}
  for b, (jpath, n) in jout.items():
    tpath = tout[b][0]
    want, got = pq.read_table(jpath), pq.read_table(tpath)
    assert got.schema.names == want.schema.names
    assert got.schema.types == want.schema.types
    assert got.to_pylist() == want.to_pylist()
    assert jformat.shard_format_of(tpath) == (fmt, 5)
    assert tformat.shard_format_of(tpath) == (fmt, 5)
    meta = pq.ParquetFile(tpath).metadata
    assert meta.num_rows == n
    if n:  # codec 7, LZ4_RAW (pyarrow names it LZ4), as lddl_tpu writes
      assert {c[4] for c in tio.ParquetFile(tpath).metadata.row_groups[0]
              .chunks} == {codecs.LZ4_RAW}
      assert meta.row_group(0).column(0).compression == pq.ParquetFile(
          jpath).metadata.row_group(0).column(0).compression
    port = tio.ParquetFile(tpath).read()
    assert port.fields == tio.ParquetFile(jpath).read().fields
    assert port.to_pylist() == want.to_pylist()


def test_a_zero_row_file_keeps_its_schema_and_tag(tmp_path):
  schema = tformat.tag_schema(tbert.bert_schema(True, 'delta'), 'delta', 5)
  out = tio.write_table_partition(schema.empty_table(), str(tmp_path), 0,
                                  bin_size=64, nbins=2)
  assert {b: n for b, (_, n) in out.items()} == {0: 0, 1: 0}
  for path, _ in out.values():
    got = pq.read_table(path)
    want = jbert.bert_schema(True, 'delta').append(
        pa.field('bin_id', pa.int64()))
    assert got.num_rows == 0 and got.schema.types == want.types
    assert jformat.shard_format_of(path) == ('delta', 5)
    assert tio.ParquetFile(path).metadata.num_rows == 0
    assert list(tio.ParquetFile(path).iter_batches()) == []


@pytest.mark.parametrize('row_group_rows,page_bytes', [(64, 1 << 20),
                                                        (1000, 2048)],
                         ids=['row-groups', 'pages'])
def test_row_groups_and_pages(tmp_path, monkeypatch, row_group_rows,
                              page_bytes):
  monkeypatch.setattr(tio, 'PAGE_BYTES', page_bytes)
  rows = _rows(300, True, 'materialized', seed=5)
  table = tio.Table({k: [r[k] for r in rows] for k in rows[0]},
                    tbert.bert_schema(True).fields, {b'k': b'v'})
  path = str(tmp_path / 'x.parquet')
  tio.write_parquet(table, path, row_group_rows=row_group_rows)
  meta = pq.ParquetFile(path).metadata
  assert meta.num_row_groups == -(-300 // row_group_rows)
  assert pq.read_table(path).to_pylist() == rows
  assert pq.read_table(path).schema.metadata == {b'k': b'v'}
  assert tio.ParquetFile(path).read().to_pylist() == rows
  # A slice spanning row groups, as the balancer reads one.
  assert tio.ParquetFile(path).read().slice(70, 200).to_pylist() == \
      rows[70:200]


@pytest.mark.parametrize('size', [0, 1, 13, 4096, 70000, 300000])
def test_lz4_raw_pages_decompress_with_pyarrow(size):
  r = np.random.default_rng(size)
  text = ' '.join(r.choice(WORDS, size // 4 + 1)).encode()[:size]
  for data in (text, r.integers(0, 256, size, dtype=np.uint8).tobytes()):
    packed = codecs.compress(codecs.LZ4_RAW, np.frombuffer(data, np.uint8))
    got = pa.Codec('lz4_raw').decompress(packed.tobytes(),
                                         decompressed_size=len(data))
    assert got.to_pybytes() == data
    assert codecs.decompress(codecs.LZ4_RAW, packed.tobytes(),
                             len(data)).tobytes() == data


def test_uncompressed_and_txt_outputs(tmp_path):
  rows = _rows(20, False, 'materialized', seed=9)
  table = tio.Table({k: [r[k] for r in rows] for k in rows[0]},
                    tbert.bert_schema(False).fields)
  path = str(tmp_path / 'u.parquet')
  tio.write_shard_file(table, path, compression=None)
  assert pq.ParquetFile(path).metadata.row_group(0).column(0).compression \
      == 'UNCOMPRESSED'
  assert pq.read_table(path).to_pylist() == rows
  txt = str(tmp_path / 'u.txt')
  tio.write_shard_file(table, txt, output_format='txt')
  with open(txt) as f:
    assert f.read().splitlines() == [repr(r) for r in rows]
  with pytest.raises(ValueError, match='compression'):
    tio.write_shard_file(table, path, compression='snappy')
  assert not [p for p in os.listdir(tmp_path) if p.endswith('.tmp')]


def test_plan_shards_is_lddl_tpus():
  from lddl_tpu import balance as jbal
  from lddl_tpu.core import File as JFile
  from lddl_tpu_torch.balance import File
  sizes = [0, 7, 3, 0, 12, 1]
  for shards in (1, 4, 9, 40):
    want = jbal.plan_shards([JFile(str(i), n) for i, n in enumerate(sizes)],
                            shards)
    got = plan_shards([File(str(i), n) for i, n in enumerate(sizes)], shards)
    assert got == want
