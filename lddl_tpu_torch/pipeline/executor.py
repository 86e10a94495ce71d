"""The lease timeout of :mod:`lddl_tpu.pipeline.executor`, which
:class:`~lddl_tpu_torch.training.elastic.RankMembership` reads. The
elastic map executor itself stays with :mod:`lddl_tpu` (host-only data
preparation)."""

import os


def lease_timeout():
  """Seconds of heartbeat silence before survivors revoke a lease (env
  ``LDDL_LEASE_TIMEOUT``). The pid-beacon death probe usually fires far
  earlier on same-host worlds; this is the cross-host backstop."""
  try:
    return max(0.2, float(os.environ.get('LDDL_LEASE_TIMEOUT', '60')))
  except ValueError:
    return 60.0
