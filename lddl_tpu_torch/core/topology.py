"""Process-topology discovery: (rank, node_rank, local_rank) placement.

A copy of :mod:`lddl_tpu.core.topology` over the port's comm backends;
the train CLI puts a process on ``cuda:<local_rank>`` unless
``--device`` names one.

Capability parity: reference ``lddl/torch/utils.py:28-94`` derives
``nproc_per_node = allreduce_MAX(local_rank) + 1`` and
``node_rank = rank // nproc_per_node`` from the launcher-provided
``LOCAL_RANK`` env var. Here the same derivation runs over the port's
host-collective backends (:mod:`lddl_tpu_torch.comm`), with a
hostname-grouping fallback when no launcher set ``LOCAL_RANK``.
"""

import collections
import os
import socket

Topology = collections.namedtuple(
    'Topology', ['rank', 'world_size', 'local_rank', 'node_rank',
                 'nproc_per_node'])


def discover_topology(comm=None):
  """Resolve this process's placement in the job.

  Resolution order:
    1. single-process world: the trivial topology;
    2. ``LDDL_LOCAL_RANK`` / ``LOCAL_RANK`` env (torchrun-style launchers):
       reference derivation — ``nproc_per_node`` = max(local_rank)+1 via
       allgather, ``node_rank = rank // nproc_per_node``;
    3. hostname grouping: allgather ``(hostname, rank)``, number the nodes
       by first appearance in rank order, and number this process's
       ``local_rank`` by its rank position within its node's group.
  """
  from ..comm import get_backend
  comm = comm or get_backend()
  rank, world = comm.rank, comm.world_size
  if world == 1:
    return Topology(rank=rank, world_size=1, local_rank=0, node_rank=0,
                    nproc_per_node=1)
  env_local = os.environ.get('LDDL_LOCAL_RANK', os.environ.get('LOCAL_RANK'))
  # One collective carrying both candidate sources, so every rank runs the
  # same collective sequence and the env-vs-hostname decision is made on
  # world-consistent data (a launcher that sets LOCAL_RANK on only some
  # ranks must not split the world into mismatched collectives).
  gathered = comm.allgather_object(
      (None if env_local is None else int(env_local), socket.gethostname()))
  env_of_rank = [g[0] for g in gathered]
  if all(e is not None for e in env_of_rank):
    local_rank = env_of_rank[rank]
    nproc_per_node = max(env_of_rank) + 1
    return Topology(rank=rank, world_size=world, local_rank=local_rank,
                    node_rank=rank // nproc_per_node,
                    nproc_per_node=nproc_per_node)
  if any(e is not None for e in env_of_rank):
    import warnings
    warnings.warn(
        'LOCAL_RANK/LDDL_LOCAL_RANK set on some ranks but not all; '
        'ignoring it and deriving topology from hostnames')
  host_of_rank = [g[1] for g in gathered]
  node_of_host, members = {}, collections.defaultdict(list)
  for r, host in enumerate(host_of_rank):
    if host not in node_of_host:
      node_of_host[host] = len(node_of_host)
    members[host].append(r)
  my_host = host_of_rank[rank]
  return Topology(
      rank=rank,
      world_size=world,
      local_rank=members[my_host].index(rank),
      node_rank=node_of_host[my_host],
      nproc_per_node=max(len(m) for m in members.values()))
