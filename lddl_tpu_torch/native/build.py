"""Build and load the port's host C++ libraries at first use.

A host library (the WordPiece encoder here, ``src/wordpiece.cpp``; the
Parquet page codecs, :mod:`lddl_tpu_torch.pipeline.codecs`) is compiled
with the host's ``c++`` into ``build/lddl_tpu_torch/`` beside the package
and loaded with :mod:`ctypes`. Its file is named by a hash of the
source, the flags, the compiler (its path and ``--version``) and the
machine's architecture, so an edited source, another toolchain or
another host builds its own. The encoder is integer code and takes no
``-march=native``: the name does not hash the CPU model, so a library
built on one CPU must run on another of the same architecture. Two
processes that reach first use together (loader workers) each compile
into a file of their own pid and ``os.replace`` it into place, so either
sees all of a library or none. Nothing is compiled at import, and a
failed build raises with the compiler's output: there is no fallback.
"""

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / 'src' / 'wordpiece.cpp'
CXX_FLAGS = ('-std=c++17', '-O3', '-shared', '-fPIC', '-pthread')

_lock = threading.Lock()
_lib = None
# What the last build in this process did: its wall time and the library;
# None when an existing library was loaded.
build_info = {'seconds': None, 'path': None}


def compiler(what):
  """The host's C++ compiler; ``what`` names the library that needs it."""
  cxx = shutil.which('c++') or shutil.which('g++')
  if cxx is None:
    raise RuntimeError(f'no C++ compiler (c++ or g++ on PATH): {what} of '
                       'lddl_tpu_torch is built at first use')
  return cxx


@functools.lru_cache(maxsize=None)
def toolchain(cxx):
  """The compiler's path and ``--version``, and the machine: what else
  besides the source and flags decides a library's bytes."""
  version = subprocess.run([cxx, '--version'], capture_output=True,
                           text=True, check=False).stdout
  return cxx, version, platform.machine()


def host_library_path(build_dir, stem, source, flags, chain):
  """``build_dir/<stem>-<hash>.so`` for ``source`` built with ``flags`` by
  the toolchain ``chain`` (:func:`toolchain`'s triple)."""
  h = hashlib.sha256(Path(source).read_bytes())
  for part in (' '.join(flags), *chain):
    h.update(b'\0' + part.encode())
  return Path(build_dir) / f'{stem}-{h.hexdigest()[:16]}.so'


def compile_host_library(cxx, source, flags, out):
  """Compile ``source`` into ``out`` (atomically); returns the seconds it
  took. Raises with the compiler's output when it fails."""
  out.parent.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  t0 = time.perf_counter()
  proc = subprocess.run([cxx, *flags, '-o', str(tmp), str(source)],
                        capture_output=True, text=True, check=False)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'{cxx} failed (exit {proc.returncode}) building '
                       f'{source}:\n{proc.stderr}{proc.stdout}')
  os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
  return time.perf_counter() - t0


def _compiler():
  return compiler('the WordPiece encoder')


def _toolchain():
  return toolchain(_compiler())


def library_path():
  return host_library_path(BUILD_DIR, 'wordpiece', SOURCE, CXX_FLAGS,
                           _toolchain())


def library():
  """The loaded encoder library, built first if this source has no build."""
  global _lib
  with _lock:
    if _lib is None:
      out = library_path()
      if not out.exists():
        seconds = compile_host_library(_compiler(), SOURCE, CXX_FLAGS, out)
        build_info.update(seconds=seconds, path=str(out))
      lib = ctypes.CDLL(str(out))
      c = ctypes
      lib.lddl_wp_create.restype = c.c_void_p
      lib.lddl_wp_create.argtypes = [
          c.c_char_p, c.POINTER(c.c_int64), c.c_int32, c.c_int32, c.c_int32,
          c.c_int32]
      lib.lddl_wp_destroy.restype = None
      lib.lddl_wp_destroy.argtypes = [c.c_void_p]
      lib.lddl_wp_encode_batch.restype = c.c_int64
      lib.lddl_wp_encode_batch.argtypes = [
          c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int64, c.c_int32,
          c.POINTER(c.c_int32), c.c_int64, c.POINTER(c.c_int64), c.c_int32]
      lib.lddl_native_abi_version.restype = c.c_int64
      lib.lddl_native_abi_version.argtypes = []
      _lib = lib
    return _lib
