"""Decompress Parquet pages: the host codec library, built at first use.

The page codecs the shard reader meets (:mod:`.parquet_io`) are LZ4 and
Snappy; their decoders are byte-serial loops, so they live in C++
(``csrc/codecs.cpp``), compiled with ``c++ -O3 -shared -fPIC`` into
``build/lddl_tpu_torch/`` beside the package and loaded with
:mod:`ctypes`, the way :mod:`lddl_tpu_torch.ops._build` builds the CUDA
kernels. The library is named by a hash of its source, the flags, the
compiler (its path and ``--version``) and the machine's architecture, so
an edited source, another toolchain or another host builds its own.
Nothing is compiled at import, and a failed build raises: there is no
slower fallback.

Parquet codec ids (``CompressionCodec`` in parquet.thrift): 0
UNCOMPRESSED, 1 SNAPPY, 5 LZ4 (Hadoop-framed blocks, or one raw block as
older writers left it), 7 LZ4_RAW. Any other codec raises and names it.
"""

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

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
  cxx = shutil.which('c++') or shutil.which('g++')
  if cxx is None:
    raise RuntimeError('no C++ compiler (c++ or g++ on PATH): the Parquet '
                       'codec library of lddl_tpu_torch is built at first use')
  return cxx


@functools.lru_cache(maxsize=None)
def _toolchain():
  """The compiler's path and ``--version``, and the machine: what else
  besides the source and flags decides the library's bytes."""
  cxx = _compiler()
  version = subprocess.run([cxx, '--version'], capture_output=True,
                           text=True, check=False).stdout
  return cxx, version, platform.machine()


def library_path():
  h = hashlib.sha256(SOURCE.read_bytes())
  for part in (' '.join(CXX_FLAGS), *_toolchain()):
    h.update(b'\0' + part.encode())
  return BUILD_DIR / f'codecs-{h.hexdigest()[:16]}.so'


def _build(out):
  cxx = _compiler()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                        capture_output=True, text=True, check=False)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'{cxx} failed (exit {proc.returncode}) building '
                       f'{SOURCE}:\n{proc.stderr}{proc.stdout}')
  os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


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
