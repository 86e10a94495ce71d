"""A loader-protocol stand-in for transport tests and benches.

A copy of :class:`lddl_tpu.testing.SyntheticBatchLoader` (numpy only; the
port keeps its own copy and imports nothing of :mod:`lddl_tpu`): the
batches it yields are byte-identical to the reference's, so either
package's data server can serve it (``--synthetic``) to either package's
client.
"""


class SyntheticBatchLoader:
  """A loader-protocol stand-in that replays one precollated batch.

  Implements exactly the surface :class:`~lddl_tpu_torch.loader.workers.
  MultiprocessLoader` drives (``iter_steps``, ``seek``/``tell``,
  ``epoch``, ``__len__``, ``samples_per_epoch``, ``batch_size``) with a
  near-zero production cost, so transport
  microbenchmarks and tests measure the worker→parent handoff itself
  rather than collate throughput.
  """

  def __init__(self, batch_size=64, seq_len=512, steps=256, comm=None,
               **_ignored):
    import numpy as np
    self._steps = int(steps)
    self._batch_size = int(batch_size)
    rng = np.random.Generator(np.random.Philox(key=[7, 9]))
    shape = (int(batch_size), int(seq_len))
    self._batch = {
        'input_ids': rng.integers(0, 30000, shape).astype(np.int32),
        'token_type_ids': np.zeros(shape, np.int32),
        'attention_mask': np.ones(shape, np.int32),
        'labels': np.full(shape, -100, np.int32),
        'next_sentence_labels': np.zeros(int(batch_size), np.int32),
    }
    self.epoch = 0
    self._batches_consumed = 0

  def __len__(self):
    return self._steps - self._batches_consumed

  @property
  def batch_size(self):
    return self._batch_size

  @property
  def batches_per_epoch(self):
    return self._steps

  def seek(self, epoch, batch_index, exact=False):
    """Public positioning contract (see
    :meth:`lddl_tpu_torch.loader.bert.BertPretrainLoader.seek`). Every
    seek is byte-exact here (a batch is a function of its step), so
    ``exact`` changes nothing."""
    epoch, batch_index = int(epoch), int(batch_index)
    if epoch < 0 or batch_index < 0:
      raise ValueError(f'seek({epoch}, {batch_index}): coordinates must '
                       'be non-negative')
    if batch_index > self._steps:  # == steps: epoch drained
      raise ValueError(f'seek({epoch}, {batch_index}): epoch has only '
                       f'{self._steps} batches')
    self.epoch = epoch
    self._batches_consumed = batch_index
    return self

  def tell(self):
    return self.epoch, self._batches_consumed

  def coordinate_of_batch(self, ordinal):
    return ordinal // self._steps, ordinal % self._steps

  @property
  def samples_per_epoch(self):
    return self._steps * self._batch_size

  def iter_steps(self, step_shard=(0, 1)):
    import numpy as np
    w, num_shards = step_shard
    first = self._batches_consumed
    self._batches_consumed = 0
    for step in range(first, self._steps):
      if step % num_shards != w:
        continue
      # Stamp the step into the batch so byte-identity checks catch
      # reordering / slot-recycling bugs, not just transport liveness.
      batch = dict(self._batch)
      ids = batch['input_ids'].copy()
      ids[:, 0] = np.int32(step)
      batch['input_ids'] = ids
      yield step, batch
    self.epoch += 1

  def __iter__(self):
    for _, batch in self.iter_steps():
      yield batch


def get_synthetic_batch_loader(**kwargs):
  """Factory entry point for worker processes (importable by module
  path, the :data:`~lddl_tpu_torch.loader.workers.DEFAULT_FACTORY` shape)."""
  return SyntheticBatchLoader(**kwargs)
