"""lddl_tpu_torch.loader.device.prefetch_to_device on the CPU path."""

import threading
import time

import numpy as np
import pytest

from lddl_tpu_torch.loader.device import prefetch_to_device


def _batches(n, seed=0):
  rng = np.random.default_rng(seed)
  return [{'input_ids': rng.integers(0, 30522, (4, 16)).astype(np.int32),
           'next_sentence_labels': rng.integers(0, 2, 4).astype(np.int32)}
          for _ in range(n)]


def test_batches_are_byte_identical_copies():
  src = _batches(5)
  out = list(prefetch_to_device(iter(src), 'cpu', size=2))
  assert len(out) == len(src)
  for a, b in zip(src, out):
    assert set(a) == set(b)
    for k in a:
      got = b[k].numpy()
      assert got.dtype == a[k].dtype
      assert got.tobytes() == a[k].tobytes()
      assert not np.shares_memory(got, a[k])


def test_producer_error_reaches_the_consumer():
  def source():
    yield from _batches(2)
    raise RuntimeError('shard read failed')

  stream = prefetch_to_device(source(), 'cpu')
  assert next(stream) is not None
  assert next(stream) is not None
  with pytest.raises(RuntimeError, match='shard read failed'):
    next(stream)


def test_close_returns_within_its_bound(monkeypatch):
  """A consumer that walks away mid-stream: close() stops the producer,
  which sits blocked on the full queue, and joins it promptly."""
  monkeypatch.setenv('LDDL_PREFETCH_JOIN_TIMEOUT', '2')
  before = threading.active_count()
  stream = prefetch_to_device(iter(_batches(50)), 'cpu', size=1)
  next(stream)
  t0 = time.monotonic()
  stream.close()
  assert time.monotonic() - t0 < 2.0
  assert threading.active_count() == before


def test_close_is_bounded_when_the_source_hangs(monkeypatch):
  monkeypatch.setenv('LDDL_PREFETCH_JOIN_TIMEOUT', '0.3')
  release = threading.Event()

  def source():
    yield _batches(1)[0]
    release.wait(5)  # a wedged upstream

  stream = prefetch_to_device(source(), 'cpu')
  next(stream)
  t0 = time.monotonic()
  with pytest.warns(UserWarning, match='still running'):
    stream.close()
  assert time.monotonic() - t0 < 2.0
  release.set()


def test_unsupported_device_raises():
  with pytest.raises(ValueError, match='device'):
    next(prefetch_to_device(iter(_batches(1)), 'meta'))
