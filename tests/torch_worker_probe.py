"""A loader factory for tests/test_torch_workers.py that reports, from
inside a loader worker process, which of a few modules are loaded there.

Kept apart from the test module: a worker imports its factory's module,
and the test module imports jax, torch and pytest.
"""

import sys

import numpy as np

PROBED = ('torch', 'jax', 'lddl_tpu', 'lddl_tpu_torch.loader.bert',
          'lddl_tpu_torch.telemetry.ledger')


class ProbeLoader:
  """Two one-row batches an epoch; each carries a flag per PROBED module
  (1 where the collating process has it in ``sys.modules``)."""

  batch_size = 1
  batches_per_epoch = 2
  samples_per_epoch = 2

  def __init__(self):
    self.epoch, self._first = 0, 0

  def __len__(self):
    return self.batches_per_epoch - self._first

  def seek(self, epoch, batch_index):
    self.epoch, self._first = epoch, batch_index
    return self

  def tell(self):
    return self.epoch, self._first

  def iter_steps(self, step_shard=(0, 1)):
    w, num_shards = step_shard
    first, self._first = self._first, 0
    for step in range(first, self.batches_per_epoch):
      if step % num_shards == w:
        loaded = [int(m in sys.modules) for m in PROBED]
        yield step, {'loaded': np.asarray(loaded, np.int32)}
    self.epoch += 1


def probe_loader(**_):
  return ProbeLoader()
