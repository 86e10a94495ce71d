"""Shard discovery and the np.save wire format of binary columns.

Copied from :mod:`lddl_tpu.core.utils` (``lddl_tpu/core/utils.py:36-121``
and its (de)serialization; the port keeps its own copy and imports
nothing of ``lddl_tpu``):

  - shard discovery under a directory, with the ``*.parquet_<bin_id>``
    file-extension convention that encodes the sequence bin id;
  - per-file sample counts from the Parquet footer, read with the port's
    own reader (:mod:`lddl_tpu_torch.pipeline.parquet_io`);
  - ``serialize_np_array`` / ``deserialize_np_array``: preprocessed shards
    store masked positions, packed token ids and document offsets as
    np.save bytes in a binary column;
  - the preprocessor's batched form of that framing
    (``npy_batch_binary_parts``), which builds a whole binary column as
    (offsets, bytes) buffers with no per-row Python object, and the
    command-line helpers of the preprocessor and the balancer.
"""

import functools
import io
import os
import re

import numpy as np

from ..pipeline.parquet_io import ByteArrays, ParquetFile


def mkdir(d):
  os.makedirs(d, exist_ok=True)


def expand_outdir_and_mkdir(outdir):
  outdir = os.path.abspath(os.path.expanduser(outdir))
  mkdir(outdir)
  return outdir


def get_all_files_paths_under(root):
  """All file paths (sorted) under a directory tree."""
  return sorted(
      os.path.join(r, f) for r, _, files in os.walk(root) for f in files)


def get_all_parquets_under(path):
  """All Parquet shard paths under a directory, including binned shards
  whose filenames end with ``.parquet_<bin_id>``."""
  return [
      p for p in get_all_files_paths_under(path)
      if '.parquet' in os.path.splitext(p)[1]
  ]


def get_all_txt_files_under(path):
  return [
      p for p in get_all_files_paths_under(path)
      if '.txt' in os.path.splitext(p)[1]
  ]


def _bin_id_of(path):
  """The bin id of a ``*.parquet_<bin_id>`` filename; None for a plain
  ``*.parquet`` file; raises ValueError for a malformed bin suffix."""
  ext = os.path.splitext(path)[1]
  if ext == '.parquet':
    return None
  parts = ext.split('_')
  if len(parts) != 2 or parts[0] != '.parquet':
    return None
  try:
    return int(parts[1])
  except ValueError:
    raise ValueError(f'malformed bin suffix in shard path {path!r}')


def get_all_bin_ids(file_paths):
  """Sorted distinct bin ids of the given shard paths; raises unless they
  are exactly ``0..N-1`` (the contract the binned loader relies on)."""
  bin_ids = sorted({
      b for b in (_bin_id_of(p) for p in file_paths) if b is not None
  })
  num_bins = len(bin_ids)
  if bin_ids != list(range(num_bins)):
    raise ValueError(
        f'bin_ids must be exactly 0..{num_bins - 1}, got {bin_ids}')
  return bin_ids


def get_file_paths_for_bin_id(file_paths, bin_id):
  return [p for p in file_paths if _bin_id_of(p) == bin_id]


def get_num_samples_of_parquet(path):
  """Number of rows of a Parquet file, from footer metadata only."""
  with ParquetFile(path) as pf:
    return pf.metadata.num_rows


def count_parquet_samples_strided(paths, comm=None):
  """Per-file sample counts (a list of ints) from the Parquet footers:
  rank ``r`` reads the footers of ``paths[r::world]`` and the count
  vector is summed over the ranks of ``comm`` (None: one process)."""
  counts = np.zeros((len(paths),), dtype=np.int64)
  rank = comm.rank if comm is not None else 0
  world = comm.world_size if comm is not None else 1
  for i in range(rank, len(paths), world):
    counts[i] = get_num_samples_of_parquet(paths[i])
  if world > 1:
    counts = comm.allreduce_sum(counts)
  return [int(c) for c in counts]

_NPY_1D_HEADER_RE = re.compile(
    rb"^\{'descr': '([^']+)', 'fortran_order': False, "
    rb"'shape': \((\d+),\), \}\s*\n$")


@functools.lru_cache(maxsize=4096)
def _npy_header(descr, n):
  """The exact ``.npy`` v1.0 header ``np.save`` writes for a 1-D array."""
  body = "{'descr': '%s', 'fortran_order': False, 'shape': (%d,), }" % (
      descr, n)
  pad = (-(10 + len(body) + 1)) % 64
  body = body + ' ' * pad + '\n'
  return b'\x93NUMPY\x01\x00' + len(body).to_bytes(2, 'little') + body.encode(
      'latin1')


def serialize_np_array(a):
  """numpy array -> np.save-compatible bytes (built directly for 1-D
  arrays of simple scalar dtypes, through ``np.save`` otherwise)."""
  a = np.ascontiguousarray(a)
  if a.ndim == 1 and a.dtype.isnative and a.dtype.kind in 'biufc':
    return _npy_header(a.dtype.str, a.shape[0]) + a.tobytes()
  buf = io.BytesIO()
  np.save(buf, a, allow_pickle=False)
  return buf.getvalue()


def serialize_u16_batch(values, offsets):
  """Many uint16 position arrays at once: a list of ``np.save`` bytes, one
  per ``values[offsets[k]:offsets[k + 1]]``."""
  values = np.ascontiguousarray(values, dtype='<u2')
  raw = values.tobytes()
  return [
      _npy_header('<u2', int(offsets[k + 1] - offsets[k])) +
      raw[int(offsets[k]) * 2:int(offsets[k + 1]) * 2]
      for k in range(len(offsets) - 1)
  ]


def npy_batch_binary_parts(values, offsets, dtype='<u2'):
  """The ``np.save`` framing of many arrays at once, as the buffers of a
  binary column: ``(value_offsets int64 [n+1], data uint8)``, where row
  ``i`` holds ``values[offsets[i]:offsets[i + 1]]`` as ``dtype``. No
  per-row Python object exists at any point."""
  dtype = np.dtype(dtype)
  descr = dtype.str
  itemsize = dtype.itemsize
  values = np.ascontiguousarray(values, dtype=dtype)
  offsets = np.asarray(offsets, dtype=np.int64)
  n = len(offsets) - 1
  if n <= 0:
    return np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.uint8)
  # Offsets may describe a sub-span of values: make the span 0-based.
  if offsets[0] != 0 or offsets[-1] != len(values):
    values = np.ascontiguousarray(values[offsets[0]:offsets[-1]])
    offsets = offsets - offsets[0]
  counts = np.diff(offsets)
  uniq = np.unique(counts)
  hdr_bytes = {int(c): np.frombuffer(_npy_header(descr, int(c)), np.uint8)
               for c in uniq}
  hdr_len = np.zeros(int(uniq.max()) + 1, dtype=np.int64)
  for c, h in hdr_bytes.items():
    hdr_len[c] = len(h)
  hl = hdr_len[counts]
  row_bytes = hl + itemsize * counts
  boffs = np.zeros(n + 1, dtype=np.int64)
  np.cumsum(row_bytes, out=boffs[1:])
  data = np.empty(int(boffs[-1]), dtype=np.uint8)
  for c, h in hdr_bytes.items():
    rows = np.nonzero(counts == c)[0]
    idx = boffs[rows][:, None] + np.arange(len(h), dtype=np.int64)[None, :]
    data[idx.ravel()] = np.tile(h, len(rows))
  # Payload: the flat values are in row order, so each payload byte lands
  # at its row's payload start plus its offset within the row's payload.
  payload = values.view(np.uint8)
  nbytes = itemsize * counts
  target = (np.repeat(boffs[:n] + hl - itemsize * offsets[:n], nbytes)
            + np.arange(len(payload), dtype=np.int64))
  data[target] = payload
  return boffs, data


def u16_batch_binary_parts(values, offsets):
  """:func:`npy_batch_binary_parts` of uint16 positions (the
  ``masked_lm_positions`` column)."""
  return npy_batch_binary_parts(values, offsets, '<u2')


def binary_column_from_parts(boffs, bdata, n, column_name):
  """The writer's binary column (:class:`~lddl_tpu_torch.pipeline.
  parquet_io.ByteArrays`) over :func:`npy_batch_binary_parts`' buffers.
  A Parquet BYTE_ARRAY value and an Arrow ``binary`` column are both
  capped at 2 GiB; a partition past that raises instead of wrapping."""
  boffs = np.asarray(boffs, dtype=np.int64)
  if len(boffs) != n + 1:
    raise ValueError(f'{column_name}: {len(boffs) - 1} values for {n} rows')
  if int(boffs[-1]) > np.iinfo(np.int32).max:
    raise ValueError(
        f'{column_name} column exceeds 2 GiB (the int32 offset limit); '
        'split the partition into smaller batches')
  return ByteArrays(boffs, np.asarray(bdata, dtype=np.uint8))


def attach_bool_arg(parser, flag_name, default=False, help_str=None):
  """Attach a ``--flag/--no-flag`` boolean argument pair to a parser."""
  attr_name = flag_name.replace('-', '_')
  group = parser.add_mutually_exclusive_group()
  help_str = help_str if help_str is not None else flag_name
  group.add_argument(
      '--' + flag_name,
      dest=attr_name,
      action='store_true',
      help=help_str + ' (default: {})'.format(default))
  group.add_argument(
      '--no-' + flag_name,
      dest=attr_name,
      action='store_false',
      help='disable ' + help_str)
  parser.set_defaults(**{attr_name: default})


def parse_str_of_num_bytes(s, return_str=False):
  """Parse ``"n[KMG]"`` into bytes."""
  try:
    power = 'kmg'.find(s[-1].lower()) + 1
    size = float(s[:-1]) * 1024**power if power > 0 else float(s)
  except ValueError:
    raise ValueError('Invalid size: {}'.format(s))
  if return_str:
    return s
  return int(size)


def deserialize_np_array(b):
  """Inverse of :func:`serialize_np_array`: the simple 1-D v1.0 header is
  parsed directly, anything else goes through ``np.load``."""
  if b[:8] == b'\x93NUMPY\x01\x00':
    hlen = int.from_bytes(b[8:10], 'little')
    m = _NPY_1D_HEADER_RE.match(b[10:10 + hlen])
    if m:
      dt = np.dtype(m.group(1).decode('latin1'))
      # .copy() so callers get a writable array, like np.load returns.
      return np.frombuffer(
          b, dtype=dt, count=int(m.group(2)), offset=10 + hlen).copy()
  return np.load(io.BytesIO(b), allow_pickle=False)
