"""Host pipeline pieces the port copies from :mod:`lddl_tpu.pipeline`.

Its exports (``lddl_tpu.pipeline``'s names) load at first access, so
importing one submodule loads no other.
"""

_LAZY = {
    'AsyncShardWriter': 'pool',
    'Executor': 'executor',
    'PoolBroken': 'pool',
    'TextSlice': 'partition',
    'WorkerPool': 'pool',
    'current_writer': 'pool',
    'estimate_block_size': 'partition',
    'plan_text_partitions': 'partition',
    'read_lines': 'partition',
    'read_samples': 'parquet_io',
    'shuffle_lines': 'shuffle',
    'write_samples_partition': 'parquet_io',
    'write_shard_file': 'parquet_io',
}


def __getattr__(name):
  module = _LAZY.get(name)
  if module is None:
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
  import importlib
  return getattr(importlib.import_module(f'.{module}', __name__), name)
