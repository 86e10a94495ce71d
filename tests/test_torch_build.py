"""The port's kernel build: the cached library is named by every file
under lddl_tpu_torch/csrc, so an edited header builds anew, packaging
ships every kind of file there, and chip_smoke.py reads each kernel's
registers and spills from nvcc's log. No nvcc is needed: only names are
built and a log is parsed."""

import importlib.util
import shutil
from pathlib import Path

import pytest

from lddl_tpu_torch.ops import _build


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
  copy = tmp_path / 'csrc'
  shutil.copytree(_build.CSRC, copy)
  monkeypatch.setattr(_build, 'CSRC', copy)
  return copy


def test_the_kernel_sources_include_a_header():
  assert (_build.CSRC / 'tensor_core.cuh').is_file()
  assert '#include "tensor_core.cuh"' in _build.SOURCE.read_text()


@pytest.mark.parametrize('name', ['tensor_core.cuh', 'flash_attention.cu'])
def test_an_edited_source_changes_the_library_name(csrc_copy, name):
  before = _build.library_path()
  path = csrc_copy / name
  original = path.read_bytes()
  path.write_bytes(original + b'\n// edited\n')
  assert _build.library_path() != before
  path.write_bytes(original)
  assert _build.library_path() == before


def test_a_new_header_changes_the_library_name(csrc_copy):
  before = _build.library_path()
  (csrc_copy / 'extra.cuh').write_text('#pragma once\n')
  assert _build.library_path() != before


def test_the_library_name_is_independent_of_where_csrc_lies(csrc_copy,
                                                            monkeypatch):
  here = _build.library_path()
  monkeypatch.setattr(_build, 'CSRC', ROOT / 'lddl_tpu_torch' / 'csrc')
  assert _build.library_path() == here


def test_setup_ships_every_kind_of_kernel_source():
  setup = (ROOT / 'setup.py').read_text()
  for suffix in sorted({p.suffix for p in _build.CSRC.iterdir()}):
    assert f"'csrc/*{suffix}'" in setup, suffix


def _chip_smoke(monkeypatch):
  # chip_smoke sets this at import when it is unset; keep it to this test.
  monkeypatch.setenv('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
  spec = importlib.util.spec_from_file_location('chip_smoke',
                                                ROOT / 'chip_smoke.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _ptxas_entry(kernel, head_dim, seg, registers, spill=0):
  """One instantiation as nvcc -Xptxas -v reports it."""
  name = f'{kernel}ILi{head_dim}ELb{int(seg)}EEEvPKfS2_S2_PKfPfS5_iiifNS_3SegE'
  return (f"ptxas info    : Compiling entry function "
          f"'_ZN12_GLOBAL__N_1{len(kernel)}{name}' for 'sm_90a'\n"
          f"ptxas info    : Function properties for _ZN12_GLOBAL__N_1{name}\n"
          f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
          f"bytes spill loads\n"
          f"ptxas info    : Used {registers} registers, used 1 barriers\n")


def test_ptxas_report_names_each_body_and_refuses_a_spill_at_d64(
    monkeypatch):
  """Every instantiation is keyed by kernel and body; the tensor-core
  ones at head_dim 64 are returned, and a spill there raises (elsewhere
  it is only reported)."""
  cs = _chip_smoke(monkeypatch)
  log = (_ptxas_entry('flash_dq_kernel', 64, False, 80) +
         _ptxas_entry('flash_dq_mma_kernel', 64, False, 168) +
         _ptxas_entry('flash_dq_mma_kernel', 64, True, 175) +
         _ptxas_entry('flash_dq_mma_kernel', 128, True, 234, spill=8) +
         _ptxas_entry('flash_fwd_kernel', 128, False, 64, spill=72))
  got = cs.ptxas_report(log)
  assert got == {
      ('dq', cs.MMA_BODY): {'registers': 168, 'spill_bytes': 0},
      ('dq_seg', cs.MMA_BODY): {'registers': 175, 'spill_bytes': 0}}
  with pytest.raises(AssertionError, match='dkv_seg'):
    cs.ptxas_report(log + _ptxas_entry('flash_dkv_mma_kernel', 64, True, 255,
                                       spill=16))
