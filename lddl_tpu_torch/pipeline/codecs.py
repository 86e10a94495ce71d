"""Parquet page codecs: the host codec library, built at first use.

The page codecs the shard reader meets (:mod:`.parquet_io`) are LZ4 and
Snappy; their decoders are byte-serial loops, so they live in C++
(``csrc/codecs.cpp``), compiled with ``c++ -O3 -shared -fPIC`` into
``build/lddl_tpu_torch/`` beside the package and loaded with
:mod:`ctypes` by the host-library helpers of
:mod:`lddl_tpu_torch.native.build`. The library is named by a hash of its source, the flags, the
compiler (its path and ``--version``) and the machine's architecture, so
an edited source, another toolchain or another host builds its own.
Nothing is compiled at import, and a failed build raises: there is no
slower fallback.

Parquet codec ids (``CompressionCodec`` in parquet.thrift): 0
UNCOMPRESSED, 1 SNAPPY, 5 LZ4 (Hadoop-framed blocks, or one raw block as
older writers left it), 7 LZ4_RAW. Any other codec raises and names it.
The shard writer compresses its pages as LZ4_RAW (:func:`compress`) and
PLAIN-encodes its BYTE_ARRAY columns (:func:`plain_byte_arrays`) with the
same library.
"""

import ctypes
import threading

import numpy as np

from ..native.build import (compile_host_library, compiler,
                            host_library_path, toolchain)
from ..ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / 'codecs.cpp'
CXX_FLAGS = ('-std=c++17', '-O3', '-shared', '-fPIC')

UNCOMPRESSED, SNAPPY, LZ4, LZ4_RAW = 0, 1, 5, 7
CODEC_NAMES = {0: 'UNCOMPRESSED', 1: 'SNAPPY', 2: 'GZIP', 3: 'LZO',
               4: 'BROTLI', 5: 'LZ4', 6: 'ZSTD', 7: 'LZ4_RAW'}
_ERRORS = {-1: 'malformed input', -2: 'output larger than the page says',
           -3: 'a match reaches before the start of the output'}

_lock = threading.Lock()
_lib = None


def _compiler():
  return compiler('the Parquet codec library')


def _toolchain():
  return toolchain(_compiler())


def library_path():
  return host_library_path(BUILD_DIR, 'codecs', SOURCE, CXX_FLAGS,
                           _toolchain())


def _build(out):
  compile_host_library(_compiler(), SOURCE, CXX_FLAGS, out)


def library():
  """The loaded codec library, built first if this source has no build."""
  global _lib
  with _lock:
    if _lib is None:
      out = library_path()
      if not out.exists():
        _build(out)
      lib = ctypes.CDLL(str(out))
      for name in ('lddl_lz4_block_decompress', 'lddl_lz4_hadoop_decompress',
                   'lddl_snappy_decompress'):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64]
        fn.restype = ctypes.c_int64
      lib.lddl_lz4_block_compress.argtypes = [
          ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
      lib.lddl_lz4_block_compress.restype = ctypes.c_int64
      lib.lddl_plain_byte_arrays.argtypes = [
          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
      lib.lddl_plain_byte_arrays.restype = None
      _lib = lib
    return _lib


def _call(name, data, size):
  out = np.empty(size, dtype=np.uint8)
  got = getattr(library(), name)(data, len(data), out.ctypes.data, size)
  return out, got


def decompress(codec, data, size):
  """``data`` (bytes) compressed with Parquet codec id ``codec``, as a
  uint8 array of exactly ``size`` bytes (the page header's uncompressed
  size). Raises on an unsupported codec or a malformed page."""
  if codec == UNCOMPRESSED:
    out = np.frombuffer(data, dtype=np.uint8)
    got = out.shape[0]
  elif codec == SNAPPY:
    out, got = _call('lddl_snappy_decompress', data, size)
  elif codec == LZ4_RAW:
    out, got = _call('lddl_lz4_block_decompress', data, size)
  elif codec == LZ4:
    out, got = _call('lddl_lz4_hadoop_decompress', data, size)
    if got != size:
      out, got = _call('lddl_lz4_block_decompress', data, size)
  else:
    raise ValueError(f'Parquet codec {CODEC_NAMES.get(codec, codec)} '
                     f'(id {codec}) is not supported: the reader takes '
                     'UNCOMPRESSED, SNAPPY, LZ4 and LZ4_RAW')
  if got != size:
    why = _ERRORS.get(got, f'{got} bytes where the page says {size}')
    raise ValueError(f'{CODEC_NAMES[codec]} page does not decompress: {why}')
  return out


def compress(codec, page):
  """``page`` (a contiguous uint8 array) compressed with Parquet codec id
  ``codec`` (UNCOMPRESSED or LZ4_RAW), as a uint8 array."""
  if codec == UNCOMPRESSED:
    return page
  if codec != LZ4_RAW:
    raise ValueError(f'the shard writer compresses with LZ4_RAW or not at '
                     f'all, not {CODEC_NAMES.get(codec, codec)}')
  n = page.shape[0]
  cap = n + n // 255 + 16
  out = np.empty(cap, dtype=np.uint8)
  got = library().lddl_lz4_block_compress(page.ctypes.data, n,
                                          out.ctypes.data, cap)
  if got < 0:
    raise RuntimeError(f'LZ4 block compression overflowed {cap} bytes')
  return out[:got]


def plain_byte_arrays(offsets, data):
  """PLAIN encoding of a BYTE_ARRAY column given as int64 ``offsets``
  (``[n + 1]``) into uint8 ``data``: each value's 4-byte length, then its
  bytes."""
  offsets = np.ascontiguousarray(offsets, dtype=np.int64)
  data = np.ascontiguousarray(data, dtype=np.uint8)
  n = offsets.shape[0] - 1
  out = np.empty(4 * n + int(offsets[-1] - offsets[0]), dtype=np.uint8)
  if n:
    library().lddl_plain_byte_arrays(offsets.ctypes.data, data.ctypes.data, n,
                                     out.ctypes.data)
  return out
