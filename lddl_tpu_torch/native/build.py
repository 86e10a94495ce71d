"""Build and load the port's host C++ libraries at first use.

A host library (the native preprocessing library here: the WordPiece
encoder and its preprocessing half, ``src/wordpiece.cpp``, the NSP pair
planner, ``src/pairing.cpp``, and host MLM masking, ``src/masking.cpp``,
linked into one library; the Parquet page codecs and the writer's LZ4
compressor, :mod:`lddl_tpu_torch.pipeline.codecs`) is compiled
with the host's ``c++`` into ``build/lddl_tpu_torch/`` beside the package
and loaded with :mod:`ctypes`. Its file is named by a hash of the
sources, the flags, the compiler (its path and ``--version``) and the
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

_SRC = Path(__file__).resolve().parent / 'src'
SOURCE = _SRC / 'wordpiece.cpp'  # the encoder; linked with the two below
OTHER_SOURCES = (_SRC / 'pairing.cpp', _SRC / 'masking.cpp')
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


def _sources(source):
  return [source] if isinstance(source, (str, os.PathLike)) else list(source)


def host_library_path(build_dir, stem, source, flags, chain):
  """``build_dir/<stem>-<hash>.so`` for ``source`` (a path, or a sequence
  of paths linked into one library) built with ``flags`` by the toolchain
  ``chain`` (:func:`toolchain`'s triple)."""
  h = hashlib.sha256()
  for src in _sources(source):
    h.update(Path(src).read_bytes() + b'\0')
  for part in (' '.join(flags), *chain):
    h.update(b'\0' + part.encode())
  return Path(build_dir) / f'{stem}-{h.hexdigest()[:16]}.so'


def compile_host_library(cxx, source, flags, out):
  """Compile ``source`` into ``out`` (atomically); returns the seconds it
  took. Raises with the compiler's output when it fails."""
  out.parent.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  t0 = time.perf_counter()
  proc = subprocess.run(
      [cxx, *flags, '-o', str(tmp), *(str(s) for s in _sources(source))],
                        capture_output=True, text=True, check=False)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'{cxx} failed (exit {proc.returncode}) building '
                       f'{source}:\n{proc.stderr}{proc.stdout}')
  os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
  return time.perf_counter() - t0


def _compiler():
  return compiler('the native preprocessing library')


def _toolchain():
  return toolchain(_compiler())


def _all_sources():
  return (SOURCE, *OTHER_SOURCES)


def library_path():
  return host_library_path(BUILD_DIR, 'wordpiece', _all_sources(),
                           CXX_FLAGS, _toolchain())


def library():
  """The loaded encoder library, built first if this source has no build."""
  global _lib
  with _lock:
    if _lib is None:
      out = library_path()
      if not out.exists():
        seconds = compile_host_library(_compiler(), _all_sources(),
                                       CXX_FLAGS, out)
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
      lib.lddl_split_sentences.restype = c.c_int64
      lib.lddl_split_sentences.argtypes = [
          c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.c_int64]
      lib.lddl_encode_docs.restype = c.c_int64
      lib.lddl_encode_docs.argtypes = [
          c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int64, c.c_int32,
          c.POINTER(c.c_int32), c.c_int64, c.POINTER(c.c_int64), c.c_int64,
          c.POINTER(c.c_int64), c.c_int32]
      lib.lddl_decode_join.restype = c.c_int64
      lib.lddl_decode_join.argtypes = [
          c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.c_int64,
          c.c_char_p, c.c_int64, c.POINTER(c.c_int32)]
      lib.lddl_columnar_sizes.restype = c.c_int64
      lib.lddl_columnar_sizes.argtypes = [
          c.c_void_p, c.c_int32, c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),
          c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_int64),
          c.c_int64, c.POINTER(c.c_int64)]
      lib.lddl_columnar_emit.restype = c.c_int64
      lib.lddl_columnar_emit.argtypes = [
          c.c_void_p, c.c_int32, c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),
          c.POINTER(c.c_int64), c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),
          c.POINTER(c.c_int64), c.POINTER(c.c_uint16), c.POINTER(c.c_int64),
          c.c_int64, c.POINTER(c.c_int64), c.c_char_p, c.c_int32]
      lib.lddl_plan_pairs.restype = c.c_int64
      lib.lddl_plan_pairs.argtypes = [
          c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int64,
          c.POINTER(c.c_uint32), c.POINTER(c.c_int32), c.c_int32, c.c_double,
          c.c_int32, c.POINTER(c.c_int64), c.c_int64]
      lib.lddl_mask_topk.restype = None
      lib.lddl_mask_topk.argtypes = [
          c.POINTER(c.c_uint64), c.POINTER(c.c_int64), c.c_int64, c.c_int64,
          c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32]
      lib.lddl_mask_partition.restype = None
      lib.lddl_mask_partition.argtypes = [
          c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.POINTER(c.c_int64),
          c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
          c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_uint64, c.c_int32,
          c.c_int32, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
          c.POINTER(c.c_uint16), c.POINTER(c.c_int32), c.c_int32]
      _lib = lib
    return _lib
