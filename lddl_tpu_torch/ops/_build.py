"""Build and load the port's CUDA kernels at first use.

The sources under ``lddl_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which is loaded
with :mod:`ctypes` (no PyTorch headers, so a build takes seconds, not
minutes). The library lands in ``build/lddl_tpu_torch/`` beside the
package, named by a hash of the source and the flags, so an edited source
builds anew and an unchanged one is reused. Nothing is compiled at import:
the first call to :func:`library` builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / 'csrc' / 'flash_attention.cu'
BUILD_DIR = _PKG.parent / 'build' / 'lddl_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (pointer args, int args); every launcher ends with a float scale
# and the stream pointer, and returns a cudaError_t as int.
_SIGNATURES = {
    'lddl_flash_fwd': (6, 6),
    'lddl_flash_dq': (8, 6),
    'lddl_flash_dkv': (9, 6),
    # K4: the same, plus q/kv segment ids and q/kv tile intervals.
    'lddl_flash_fwd_seg': (10, 6),
    'lddl_flash_dq_seg': (12, 6),
    'lddl_flash_dkv_seg': (13, 6),
}

_lock = threading.Lock()
_lib = None
# What the last build in this process did: nvcc's log (ptxas register and
# shared-memory report) and its wall time; None when the library was reused.
build_info = {'log': None, 'seconds': None, 'path': None}


def _nvcc():
  found = shutil.which('nvcc')
  if found:
    return found
  default = Path('/usr/local/cuda/bin/nvcc')
  if default.exists():
    return str(default)
  raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin): the '
                     'CUDA kernels of lddl_tpu_torch are built at first use '
                     'and need the CUDA toolkit')


def library_path():
  digest = hashlib.sha256(SOURCE.read_bytes() +
                          ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
  return BUILD_DIR / f'flash_attention-{digest}.so'


def _build(out):
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  t0 = time.perf_counter()
  proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(SOURCE)],
                        capture_output=True, text=True, check=False)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'nvcc failed (exit {proc.returncode}) building '
                       f'{SOURCE}:\n{proc.stderr}{proc.stdout}')
  os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
  build_info.update(log=proc.stderr + proc.stdout,
                    seconds=time.perf_counter() - t0, path=str(out))


def library():
  """The loaded kernel library, built first if this source has no build."""
  global _lib
  with _lock:
    if _lib is None:
      out = library_path()
      if not out.exists():
        _build(out)
      lib = ctypes.CDLL(str(out))
      for name, (n_ptr, n_int) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_F, _P]
        fn.restype = _I
      lib.lddl_cuda_error_string.argtypes = [_I]
      lib.lddl_cuda_error_string.restype = ctypes.c_char_p
      _lib = lib
    return _lib


def launch(name, *args):
  """Call one C launcher; raise if it reports a CUDA error."""
  lib = library()
  err = getattr(lib, name)(*args)
  if err != 0:
    msg = lib.lddl_cuda_error_string(err).decode()
    raise RuntimeError(f'{name} failed: CUDA error {err} ({msg})')
