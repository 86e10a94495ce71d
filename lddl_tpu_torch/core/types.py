"""Value types shared across the port: a copy of :mod:`lddl_tpu.core.types`
(``File``, the record the balancer and the datasets pass around)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class File:
  """A shard file on disk together with its sample count."""

  path: str
  num_samples: int

  def __str__(self):
    return f'File(path={self.path}, num_samples={self.num_samples})'
