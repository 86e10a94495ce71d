"""Build and load the port's CUDA kernels at first use.

Two sources under ``lddl_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a``, each into a shared library with a plain C interface loaded
with :mod:`ctypes` (no PyTorch headers, so a build takes seconds, not
minutes): ``flash_attention.cu`` (the flash kernels, :func:`library`) and
``masking.cu`` (the preprocessor's MLM masking, :func:`masking_library`).
A preprocessing run builds only the second, a training run only the
first; :func:`build_all` starts both ``nvcc`` runs together. The
libraries land in ``build/lddl_tpu_torch/`` beside the package; the flash
library is named by a hash of every file under ``csrc`` (the ``.cu`` nvcc
compiles and the headers it includes) and the flags, the masking library
by its own source and the flags, so an edited source or header builds
anew and an unchanged tree is reused. Nothing is compiled at import: the
first call to :func:`library` or :func:`masking_library` builds.
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
CSRC = _PKG / 'csrc'
SOURCE = CSRC / 'flash_attention.cu'
MASKING_SOURCE = CSRC / 'masking.cu'
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
_masking_lock = threading.Lock()
_masking_lib = None
# What the last build in this process did: nvcc's log (ptxas register and
# shared-memory report) and its wall time; None when the library was reused.
build_info = {'log': None, 'seconds': None, 'path': None}
masking_build_info = {'log': None, 'seconds': None, 'path': None}


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
  h = hashlib.sha256()
  for path in sorted(p for p in CSRC.rglob('*') if p.is_file()):
    h.update(path.relative_to(CSRC).as_posix().encode() + b'\0')
    h.update(path.read_bytes() + b'\0')
  h.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'flash_attention-{h.hexdigest()[:16]}.so'


def masking_library_path():
  h = hashlib.sha256(MASKING_SOURCE.read_bytes())
  h.update(b'\0' + ' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'masking-{h.hexdigest()[:16]}.so'


def _build(out, source=SOURCE, info=build_info):
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  t0 = time.perf_counter()
  proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(source)],
                        capture_output=True, text=True, check=False)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'nvcc failed (exit {proc.returncode}) building '
                       f'{source}:\n{proc.stderr}{proc.stdout}')
  os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
  info.update(log=proc.stderr + proc.stdout,
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
      lib.lddl_flash_launches.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
      lib.lddl_flash_launches.restype = _I
      lib.lddl_flash_reset_launches.argtypes = []
      lib.lddl_flash_reset_launches.restype = _I
      lib.lddl_cuda_error_string.argtypes = [_I]
      lib.lddl_cuda_error_string.restype = ctypes.c_char_p
      _lib = lib
    return _lib


_I64, _U, _F32 = ctypes.c_longlong, ctypes.c_uint, ctypes.c_float


def masking_library():
  """The loaded masking library, built first if its source has no build."""
  global _masking_lib
  with _masking_lock:
    if _masking_lib is None:
      out = masking_library_path()
      if not out.exists():
        _build(out, MASKING_SOURCE, masking_build_info)
      lib = ctypes.CDLL(str(out))
      lib.lddl_mask_partition.argtypes = (
          [_P, _I, _I64] + [_P] * 4 + [_I] * 7 + [_P, _U, _U, _F32] +
          [_P] * 4)
      lib.lddl_mask_partition.restype = _I
      lib.lddl_mask_matrix.argtypes = (
          [_P] * 3 + [_I] * 4 + [_P, _U, _U, _F32] + [_P] * 3)
      lib.lddl_mask_matrix.restype = _I
      lib.lddl_mask_max_seq_len.argtypes = []
      lib.lddl_mask_max_seq_len.restype = _I
      lib.lddl_mask_error_string.argtypes = [_I]
      lib.lddl_mask_error_string.restype = ctypes.c_char_p
      _masking_lib = lib
    return _masking_lib


def masking_launch(name, *args):
  """Call one launcher of the masking library; raise on a CUDA error."""
  lib = masking_library()
  err = getattr(lib, name)(*args)
  if err != 0:
    msg = lib.lddl_mask_error_string(err).decode()
    raise RuntimeError(f'{name} failed: CUDA error {err} ({msg})')


def build_all():
  """Build (or load) both libraries, their ``nvcc`` runs started together;
  returns ``{name: seconds}`` of the builds that ran."""
  from concurrent.futures import ThreadPoolExecutor
  with ThreadPoolExecutor(2) as pool:
    for done in [pool.submit(fn) for fn in (library, masking_library)]:
      done.result()  # re-raises a failed build here
  return {name: info['seconds'] for name, info in
          (('flash_attention', build_info), ('masking', masking_build_info))
          if info['seconds'] is not None}


def launch(name, *args):
  """Call one C function of the library (a launcher, or the launch-count
  read and reset); raise if it reports a CUDA error."""
  lib = library()
  err = getattr(lib, name)(*args)
  if err != 0:
    msg = lib.lddl_cuda_error_string(err).decode()
    raise RuntimeError(f'{name} failed: CUDA error {err} ({msg})')


def loaded():
  """Whether this process has loaded the library (no build is started)."""
  return _lib is not None
