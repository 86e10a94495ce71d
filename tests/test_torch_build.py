"""The port's kernel build: the cached library is named by every file
under lddl_tpu_torch/csrc, so an edited header builds anew, and packaging
ships every kind of file there. No nvcc is needed: only names are built."""

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
