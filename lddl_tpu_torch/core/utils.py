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
    np.save bytes in a binary column.
"""

import io
import os
import re

import numpy as np

from ..pipeline.parquet_io import ParquetFile


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
  """Per-file sample counts (a list of ints) from the Parquet footers. The
  JAX package spreads the footers over the ranks of ``comm`` and sums the
  counts; the port has one process until its comm backend is ported, so
  a ``comm`` with a world size above 1 raises."""
  if comm is not None and comm.world_size > 1:
    raise NotImplementedError(
        'count_parquet_samples_strided over a comm of world size '
        f'{comm.world_size}: the port has no comm backend yet')
  return [get_num_samples_of_parquet(p) for p in paths]

_NPY_1D_HEADER_RE = re.compile(
    rb"^\{'descr': '([^']+)', 'fortran_order': False, "
    rb"'shape': \((\d+),\), \}\s*\n$")


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
