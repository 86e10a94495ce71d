"""The port's Parquet reader and codec library against pyarrow.

pyarrow exists on this machine, not on the card's, so it is the oracle:
files pyarrow writes with the schemas of lddl_tpu's shards (pairs with
dynamic and static masking, mask-delta pairs, packed rows) under each
codec, with and without dictionary pages, page versions 1 and 2, small
pages and several row groups, read back value by value by the port's
reader; and the C++ codec library against ``pyarrow.Codec``.
"""

import random
import struct

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

from lddl_tpu.core.utils import serialize_np_array
from lddl_tpu.pipeline import shard_format as jformat
from lddl_tpu_torch.pipeline import codecs
from lddl_tpu_torch.pipeline import shard_format as tformat
from lddl_tpu_torch.pipeline.parquet_io import ParquetFile


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


WORDS = ('the', 'of', '##ing', 'alpha', 'bravo', '[UNK]', 'délta', '漢字')


def _tokens(r, lo, hi):
  return ' '.join(r.choice(WORDS) for _ in range(r.randrange(lo, hi)))


def _npy(r, lo, hi, dtype=np.uint16):
  return serialize_np_array(
      np.asarray([r.randrange(512) for _ in range(r.randrange(lo, hi))],
                 dtype=dtype))


def _table(kind, n, seed=0):
  """``n`` rows with the columns and types lddl_tpu's shards of ``kind``
  have (``lddl_tpu/preprocess/bert.py:558``, ``preprocess/packed.py``,
  ``pipeline/parquet_io.py:218``), tagged as the writers tag them."""
  r = random.Random(seed)
  cols = {}
  if kind == 'packed':
    cols['input_ids'] = pa.array([_npy(r, 10, 400) for _ in range(n)],
                                 pa.binary())
    cols['doc_offsets'] = pa.array([_npy(r, 1, 16) for _ in range(n)],
                                   pa.binary())
  else:
    cols['A'] = pa.array([_tokens(r, 1, 60) for _ in range(n)], pa.string())
    cols['B'] = pa.array([_tokens(r, 1, 60) for _ in range(n)], pa.string())
    cols['is_random_next'] = pa.array([r.random() < 0.5 for _ in range(n)])
  cols['num_tokens'] = pa.array([r.randrange(3, 65536) for _ in range(n)],
                                pa.uint16())
  if kind == 'static':
    cols['masked_lm_positions'] = pa.array(
        [_npy(r, 1, 20) for _ in range(n)], pa.binary())
    cols['masked_lm_labels'] = pa.array([_tokens(r, 1, 20)
                                         for _ in range(n)], pa.string())
  if kind == 'delta':
    for name in jformat.DELTA_COLUMNS:
      cols[name] = pa.array([_npy(r, 1, 30, np.int32) for _ in range(n)],
                            pa.binary())
  cols['bin_id'] = pa.array([r.randrange(4) for _ in range(n)], pa.int64())
  table = pa.table(cols)
  return jformat.tag_table(
      table, jformat.DELTA if kind == 'delta' else jformat.MATERIALIZED, 5)


def _read_rows(path):
  rows = []
  with ParquetFile(path) as pf:
    for batch in pf.iter_batches():
      cols = []
      for name in batch.names:
        col = batch.column(name)
        cols.append(col.tolist() if isinstance(col, np.ndarray) else col)
      rows += [dict(zip(batch.names, vals)) for vals in zip(*cols)]
    return rows, pf.metadata


@pytest.mark.parametrize('kind', ['dynamic', 'static', 'delta', 'packed'])
@pytest.mark.parametrize('version', ['1.0', '2.0'])
@pytest.mark.parametrize('dictionary', [True, False],
                         ids=['dictionary', 'plain'])
@pytest.mark.parametrize('codec', ['none', 'snappy', 'lz4'])
def test_reader_matches_pyarrow(tmp_path, codec, dictionary, version, kind):
  """Value by value, with num_rows and the key-value metadata; small
  pages and row groups, so a column spans many pages and batches (and a
  dictionary falls back to PLAIN within a chunk)."""
  path = str(tmp_path / 'shard.parquet')
  pq.write_table(_table(kind, 300), path,
                 compression=codec, use_dictionary=dictionary,
                 data_page_version=version, data_page_size=512,
                 dictionary_pagesize_limit=2048, row_group_size=70)
  rows, meta = _read_rows(path)
  want = pq.read_table(path).to_pylist()
  assert rows == want
  ref = pq.ParquetFile(path).metadata
  assert meta.num_rows == ref.num_rows == 300
  assert meta.num_row_groups == ref.num_row_groups > 1
  assert meta.metadata == ref.metadata
  assert tformat.shard_format_of(path) == jformat.shard_format_of(path)


@pytest.mark.parametrize('kind', ['dynamic', 'packed'])
def test_reader_reads_a_zero_row_file(tmp_path, kind):
  """The balancer writes zero-row shards (``balance.py:121-126``)."""
  path = str(tmp_path / 'empty.parquet')
  pq.write_table(_table(kind, 0), path)
  rows, meta = _read_rows(path)
  assert rows == [] and meta.num_rows == 0
  assert meta.metadata == pq.ParquetFile(path).metadata.metadata


def test_token_counts_match_count_substring(tmp_path):
  """The numpy count that replaces ``pyarrow.compute.count_substring``."""
  path = str(tmp_path / 'shard.parquet')
  table = _table('static', 200)
  pq.write_table(table, path, data_page_size=256)
  with ParquetFile(path) as pf:
    batch = next(pf.iter_batches())
    for name in ('A', 'B', 'masked_lm_labels'):
      want = pc.count_substring(table.column(name), ' ').to_numpy() + 1
      np.testing.assert_array_equal(batch.byte_arrays(name).token_counts(),
                                    want)


def test_reader_rejects_what_it_does_not_read(tmp_path):
  table = pa.table({'a': ['x y', 'z']})
  zstd = str(tmp_path / 'zstd.parquet')
  pq.write_table(table, zstd, compression='zstd')
  with ParquetFile(zstd) as pf, pytest.raises(ValueError, match='ZSTD'):
    list(pf.iter_batches())
  nulls = str(tmp_path / 'nulls.parquet')
  pq.write_table(pa.table({'a': ['x', None]}), nulls)
  with ParquetFile(nulls) as pf, pytest.raises(ValueError, match='null'):
    list(pf.iter_batches())
  nested = str(tmp_path / 'nested.parquet')
  pq.write_table(pa.table({'a': [[1, 2], [3]]}), nested)
  with pytest.raises(ValueError, match='nested|repeated'):
    ParquetFile(nested)
  junk = tmp_path / 'junk.parquet'
  junk.write_bytes(b'PAR1' + b'\x00' * 64)
  with pytest.raises(ValueError, match='PAR1|footer'):
    ParquetFile(str(junk))


# ---- the codec library ----


def _payloads():
  rng = np.random.default_rng(0)
  text = ' '.join(random.Random(1).choice(WORDS) for _ in range(20000))
  return {
      'text': text.encode(),
      'random': rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
      # Matches that overlap their own output (offset < length).
      'overlap': b'ab' * 40000 + b'abc' * 30000 + b'x' * 100000,
      # Copies longer than 64 bytes at long offsets.
      'long_copies': (rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
                      * 30),
      'short': b'q',
      'empty': b'',
  }


@pytest.mark.parametrize('payload', sorted(_payloads()))
@pytest.mark.parametrize('codec,name', [(codecs.SNAPPY, 'snappy'),
                                        (codecs.LZ4_RAW, 'lz4_raw')])
def test_codec_matches_pyarrow(codec, name, payload):
  raw = _payloads()[payload]
  packed = pa.Codec(name).compress(raw, asbytes=True)
  assert codecs.decompress(codec, packed, len(raw)).tobytes() == raw


def _hadoop_frames(raw, block):
  """Parquet's LZ4 codec as Hadoop frames it: per block, big-endian
  decompressed and compressed sizes, then one raw LZ4 block."""
  out = b''
  for i in range(0, len(raw), block):
    chunk = raw[i:i + block]
    packed = pa.Codec('lz4_raw').compress(chunk, asbytes=True)
    out += struct.pack('>II', len(chunk), len(packed)) + packed
  return out


def test_lz4_reads_hadoop_frames_and_raw_blocks():
  raw = _payloads()['text']
  for block in (len(raw), 4096):
    framed = _hadoop_frames(raw, block)
    assert codecs.decompress(codecs.LZ4, framed, len(raw)).tobytes() == raw
  # One raw block under codec id 5, as older writers left it.
  block = pa.Codec('lz4_raw').compress(raw, asbytes=True)
  assert codecs.decompress(codecs.LZ4, block, len(raw)).tobytes() == raw


@pytest.mark.parametrize('codec,name', [(codecs.SNAPPY, 'snappy'),
                                        (codecs.LZ4_RAW, 'lz4_raw')])
def test_codec_raises_on_a_malformed_page(codec, name):
  raw = _payloads()['text']
  packed = pa.Codec(name).compress(raw, asbytes=True)
  with pytest.raises(ValueError, match='does not decompress'):
    codecs.decompress(codec, packed[:len(packed) // 2], len(raw))
  with pytest.raises(ValueError, match='does not decompress'):
    codecs.decompress(codec, packed, len(raw) - 1)


def test_unsupported_codecs_raise_and_name_the_codec():
  for codec, name in ((2, 'GZIP'), (4, 'BROTLI'), (6, 'ZSTD'), (42, '42')):
    with pytest.raises(ValueError, match=name):
      codecs.decompress(codec, b'', 0)


def test_a_failed_build_raises(tmp_path, monkeypatch):
  """No slower fallback: a library that does not compile raises."""
  bad = tmp_path / 'codecs.cpp'
  bad.write_text('this is not C++\n')
  monkeypatch.setattr(codecs, 'SOURCE', bad)
  monkeypatch.setattr(codecs, 'BUILD_DIR', tmp_path / 'build')
  monkeypatch.setattr(codecs, '_lib', None)
  with pytest.raises(RuntimeError, match='failed'):
    codecs.decompress(codecs.SNAPPY, b'\x01\x00q', 1)


def test_the_library_is_named_by_its_toolchain(monkeypatch):
  """Another compiler version or another machine builds a library of its
  own: a build made elsewhere is never loaded as it is."""
  here = codecs.library_path()
  cxx, version, machine = codecs._toolchain()
  monkeypatch.setattr(codecs, '_toolchain',
                      lambda: (cxx, version + ' (another build)', machine))
  assert codecs.library_path() != here
  monkeypatch.setattr(codecs, '_toolchain', lambda: (cxx, version, 'other'))
  assert codecs.library_path() != here
  monkeypatch.setattr(codecs, '_toolchain', lambda: (cxx, version, machine))
  assert codecs.library_path() == here
