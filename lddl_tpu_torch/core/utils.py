"""The np.save wire format of packed rows.

Copied from :mod:`lddl_tpu.core.utils` (``serialize_np_array``,
``deserialize_np_array``; the port keeps its own copy and imports nothing
of ``lddl_tpu``). Preprocessed shards store each row's token ids and
document offsets as np.save bytes in a binary column; these two functions
write and read them.
"""

import io
import re

import numpy as np

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
