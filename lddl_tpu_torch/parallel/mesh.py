"""Mesh construction, the data layout of a global batch and parameter
placement: the port of :mod:`lddl_tpu.parallel.mesh`, over
``torch.distributed``.

Axes, in the JAX package's order (any can be size 1)::

  data    pure data parallelism (gradients all-reduced over the group)
  fsdp    data parallelism with sharded parameters and optimizer state
  tensor  tensor (Megatron-style) parallelism inside attention/MLP blocks
  seq     sequence parallelism (ring attention,
          :mod:`lddl_tpu_torch.parallel.ring`)

A process group makes the mesh a
``torch.distributed.device_mesh.DeviceMesh`` laid out as the JAX
package's ``devices.reshape(data, fsdp, tensor, seq)``: rank
``((d * fsdp + f) * tensor + t) * seq + s``. A single process without a
group has the mesh ``None`` (every axis 1), and every function here takes
that.

The reference's dp_rank-feeding contract holds as in the JAX package: a
batch is laid out ``P(('data', 'fsdp'), 'seq')``, so the ranks of one
``tensor`` or ``seq`` group hold the same rows (:func:`batch_rank`,
:func:`batch_size`, :func:`local_batch`), and a ``seq`` rank keeps its
contiguous ``1 / seq`` of every row (:func:`seq_columns`).

Placement. A spec is a tuple with one entry per dim of a tensor: None, an
axis name or a tuple of them, as a JAX ``PartitionSpec``. In this port
only the ``tensor`` entries split a parameter (:func:`shard`); the
``fsdp`` axis shards the step's flat parameter buffer instead
(:class:`~lddl_tpu_torch.parallel.train.ShardedDataParallel`), so an
``fsdp`` entry names where the buffer's shard comes from, not a dim that
is cut. Every ``seq`` rank holds the whole parameters of its
``(data, fsdp, tensor)`` coordinate. A checkpoint holds the whole state
(world 1's layout), and :func:`reshard_state` gives a rank its shards of
it on any mesh.
"""

import re

MESH_AXES = ('data', 'fsdp', 'tensor', 'seq')
# The axes whose ranks a step reduces over, flattened: the batch group, the
# gradients' group and an fsdp shard's replicas (:func:`_group_over`).
_FLAT_AXES = (('data', 'fsdp'), ('data', 'fsdp', 'seq'), ('data', 'seq'))


def make_mesh(data=1, fsdp=1, tensor=1, seq=1, device_type=None):
  """The mesh over every rank of the default process group, or None in a
  single process with no group.

  Any leftover rank factor folds into ``data`` when data is left at its
  default, so ``make_mesh()`` is pure data parallelism over every rank
  (as :func:`lddl_tpu.parallel.mesh.make_mesh`). ``device_type`` defaults
  to ``cuda`` when the build has it; set the process's CUDA device first
  (``torch.cuda.set_device``), or DeviceMesh picks ``cuda:<LOCAL_RANK>``.
  Every rank must call it (it makes the axes' process groups).
  """
  import torch
  import torch.distributed as dist
  up = dist.is_available() and dist.is_initialized()
  n = dist.get_world_size() if up else 1
  model = fsdp * tensor * seq
  if data == 1 and n % model == 0:
    data = n // model
  if data * model != n:
    raise ValueError(f'mesh data={data} fsdp={fsdp} tensor={tensor} '
                     f'seq={seq} != {n} ranks')
  if not up:
    return None
  from torch.distributed.device_mesh import init_device_mesh
  if device_type is None:
    device_type = 'cuda' if torch.cuda.is_available() else 'cpu'
  mesh = init_device_mesh(device_type, (data, fsdp, tensor, seq),
                          mesh_dim_names=MESH_AXES)
  # The flattened groups over more than one axis above 1, keyed by those
  # axes (new_group is collective, so every rank makes them all): data x
  # fsdp (the batch group), data x fsdp x seq (the gradients') and data x
  # seq (an fsdp shard's replicas).
  shape = dict(zip(MESH_AXES, (data, fsdp, tensor, seq)))
  mesh._lddl_groups = {}
  for axes in _FLAT_AXES:
    big = tuple(a for a in axes if shape[a] > 1)
    if len(big) > 1 and big not in mesh._lddl_groups:
      mesh._lddl_groups[big] = _flat_group(shape, big)
  return mesh


def _flat_group(shape, axes):
  """This rank's group over ``axes`` flattened in mesh order (the other
  axes fixed at this rank's coordinates): every rank makes every such
  group, in the same order, as make_mesh() must."""
  import itertools

  import torch.distributed as dist
  rank = dist.get_rank()
  fixed = [a for a in MESH_AXES if a not in axes]
  mine = None
  for coord in itertools.product(*(range(shape[a]) for a in fixed)):
    at = dict(zip(fixed, coord))
    ranks = []
    for free in itertools.product(*(range(shape[a]) for a in axes)):
      at.update(zip(axes, free))
      r = 0
      for a in MESH_AXES:
        r = r * shape[a] + at[a]
      ranks.append(r)
    group = dist.new_group(ranks)
    if rank in ranks:
      mine = group
  return mine


def check_mesh(mesh):
  """Raise :class:`NotImplementedError` unless ``mesh`` is None or a
  DeviceMesh with the four axes."""
  if mesh is None:
    return
  from torch.distributed.device_mesh import DeviceMesh
  if not isinstance(mesh, DeviceMesh) or tuple(
      mesh.mesh_dim_names or ()) != MESH_AXES:
    raise NotImplementedError(
        f'mesh {mesh!r}: only a torch DeviceMesh with the axes '
        f'{MESH_AXES} (make_mesh()) is ported')


def mesh_summary(mesh):
  if mesh is None:
    return ', '.join(f'{a}=1' for a in MESH_AXES)
  return ', '.join(f'{k}={v}' for k, v in zip(mesh.mesh_dim_names,
                                                mesh.shape))


def axis_size(mesh, axis):
  """The size of ``axis`` (1 without a mesh)."""
  return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis):
  """This rank's index on ``axis`` (0 without a mesh)."""
  return 0 if mesh is None else mesh.get_local_rank(axis)


def data_rank(mesh):
  return axis_rank(mesh, 'data')


def data_size(mesh):
  return axis_size(mesh, 'data')


def data_group(mesh):
  """The ``data`` axis' process group, or None without a mesh."""
  return None if mesh is None else mesh.get_group('data')


def fsdp_group(mesh):
  return None if mesh is None else mesh.get_group('fsdp')


def tensor_group(mesh):
  return None if mesh is None else mesh.get_group('tensor')


def seq_group(mesh):
  """The ``seq`` axis' process group (the ring), or None without a
  mesh."""
  return None if mesh is None else mesh.get_group('seq')


def seq_rank(mesh):
  """This rank's index on ``seq``: which ``1 / seq`` of each row it
  holds."""
  return axis_rank(mesh, 'seq')


def seq_size(mesh):
  return axis_size(mesh, 'seq')


def batch_rank(mesh):
  """This rank's flattened ``(data, fsdp)`` coordinate: which rows of a
  global batch it holds, and the loader's ``dp_rank``."""
  return data_rank(mesh) * axis_size(mesh, 'fsdp') + axis_rank(mesh, 'fsdp')


def batch_size(mesh):
  """The ``data x fsdp`` product: the loader's ``dp_world``."""
  return data_size(mesh) * axis_size(mesh, 'fsdp')


def _group_over(mesh, axes):
  """The group over ``axes`` (of :data:`_FLAT_AXES`) flattened in mesh
  order: the mesh's own group of the one axis above 1 (of ``axes[0]``
  when none is), else the group make_mesh() built."""
  big = tuple(a for a in axes if axis_size(mesh, a) > 1)
  if len(big) <= 1:
    return mesh.get_group(big[0] if big else axes[0])
  group = getattr(mesh, '_lddl_groups', {}).get(big)
  if group is None:
    raise ValueError(f'a mesh with {" and ".join(big)} above 1 needs their '
                     'flattened group: build it with make_mesh()')
  return group


def batch_group(mesh):
  """The flattened ``data x fsdp`` group (group rank = :func:`batch_rank`)
  the batch normalizers reduce over with ``seq`` at 1, or None."""
  return None if mesh is None else _group_over(mesh, ('data', 'fsdp'))


def reduce_group(mesh):
  """The flattened ``data x fsdp x seq`` group, or None without a mesh:
  the ranks whose gradients and batch normalizers sum to the step's (the
  batch group's ranks each hold their rows, and a seq group's ranks their
  part of each row). It is :func:`batch_group` when ``seq`` is 1."""
  if mesh is None:
    return None
  return _group_over(mesh, ('data', 'fsdp', 'seq'))


def replica_group(mesh):
  """The flattened ``data x seq`` group: the ranks that hold the same
  ``fsdp`` shard, over which that shard's gradient is summed after the
  reduce-scatter over ``fsdp``. None without a mesh or when both axes are
  1."""
  if mesh is None or data_size(mesh) * seq_size(mesh) == 1:
    return None
  return _group_over(mesh, ('data', 'seq'))


def batch_pspec(ndim=2, seq_dim=1):
  """The spec of a ``[batch, seq, ...]`` array: batch over (data, fsdp),
  sequence over seq, trailing dims replicated."""
  spec = [None] * ndim
  spec[0] = ('data', 'fsdp')
  if seq_dim is not None and ndim > seq_dim:
    spec[seq_dim] = 'seq'
  return tuple(spec)


def canonical_batch_spec(mesh, shape):
  """:func:`batch_pspec` restricted to what ``shape`` allows, as
  :func:`lddl_tpu.parallel.mesh.canonical_batch_spec` gives it on a mesh
  with the four axes: dim 0 over ``('data', 'fsdp')``, dim 1 over
  ``seq`` when divisible by that axis' size, trailing dims replicated. A
  mesh of None has every axis, at size 1."""
  spec = [None] * len(shape)
  spec[0] = ('data', 'fsdp')
  if len(shape) > 1 and shape[1] % axis_size(mesh, 'seq') == 0:
    spec[1] = 'seq'
  return tuple(spec)


def _axes(entry):
  """The axis names of one spec entry."""
  if entry is None:
    return ()
  return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_rows(mesh, global_rows):
  """The rows of a ``global_rows`` batch this rank holds under
  ``canonical_batch_spec``'s ``P(('data', 'fsdp'), 'seq')``: dim 0 split
  in :func:`batch_rank` order into equal contiguous blocks, the same
  block for every rank of a ``tensor`` or ``seq`` group."""
  n = batch_size(mesh)
  if global_rows % n:
    raise ValueError(f'{global_rows} rows do not split over data x fsdp = '
                     f'{n}')
  per = global_rows // n
  r = batch_rank(mesh)
  return slice(r * per, (r + 1) * per)


def seq_columns(mesh, length):
  """The columns of a row of ``length`` this rank holds: its contiguous
  ``1 / seq`` in :func:`seq_rank` order. A length that ``seq`` does not
  divide raises ``ValueError`` (the JAX package's ``shard_map`` of the
  ring cannot take it either)."""
  n = seq_size(mesh)
  if length % n:
    raise ValueError(f'sequence length {length} does not split over '
                     f'seq={n}')
  per = length // n
  r = seq_rank(mesh)
  return slice(r * per, (r + 1) * per)


def seq_shard(batch, mesh):
  """This rank's ``seq`` part of a loader-format batch whose rows are
  already its own: dim 1 of every array of two or more dims cut by
  :func:`seq_columns` (``[b]`` arrays, ``next_sentence_labels``, stay
  whole). The batch itself when ``seq`` is 1."""
  if seq_size(mesh) == 1:
    return batch
  out = {}
  for k, v in batch.items():
    if v.ndim > 1:
      try:
        v = v[:, seq_columns(mesh, v.shape[1])]
      except ValueError as e:
        raise ValueError(f'{k}: {e}') from None
    out[k] = v
  return out


def local_batch(batch, mesh):
  """This rank's part of a global loader-format batch (a dict of arrays
  or tensors with the batch on dim 0): its rows (:func:`batch_rows`),
  then its ``seq`` columns of them (:func:`seq_shard`)."""
  rows = batch_rows(mesh, len(next(iter(batch.values()))))
  return seq_shard({k: v[rows] for k, v in batch.items()}, mesh)


# ---- collectives that every backend runs ----


def backend_for(group, device):
  """The name of ``group``'s backend for tensors on ``device``."""
  import torch.distributed as dist
  config = str(dist.get_backend_config(group))
  for part in config.split(','):
    dev, _, name = part.rpartition(':')
    if not dev or dev == device.type:
      return name
  return config


def stack_over(t, group):
  """Every rank's ``t`` (same shape and dtype on each), stacked in group
  rank order: ``[world, *t.shape]``, bit for bit on every rank.

  NCCL runs ``all_gather_into_tensor``. Any other backend (gloo, which
  stages CUDA tensors through host memory) runs the one collective this
  port has shown it takes for CUDA tensors, an int64 sum: each rank
  writes its bytes into its own slot of a zeroed buffer, so every sum
  adds one rank's bits to zeros and is exact."""
  import torch
  import torch.distributed as dist
  world = dist.get_world_size(group)
  if world == 1:
    return t[None].clone()
  t = t.contiguous()
  if backend_for(group, t.device) == 'nccl':
    out = torch.empty((world, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out
  raw = t.reshape(-1).view(torch.uint8)
  words = -(-raw.numel() // 8)
  slots = torch.zeros((world, words * 8), dtype=torch.uint8,
                      device=t.device)
  slots[dist.get_rank(group), :raw.numel()] = raw
  bits = slots.view(torch.int64)
  dist.all_reduce(bits, group=group)
  return slots[:, :raw.numel()].contiguous().view(t.dtype).view(
      world, *t.shape)


# ---- parameter placement ----


def match_partition_rules(rules, named):
  """Map every entry of ``named`` (a ``{name: tensor}`` mapping such as a
  ``state_dict``) to a spec by regex rules, as
  :func:`lddl_tpu.parallel.mesh.match_partition_rules` does over tree
  paths: ``rules`` is an ordered ``[(pattern, spec), ...]``, each name is
  searched against the patterns in order and the first match wins. A
  scalar (0-d) entry is replicated without consulting the rules; a
  non-scalar entry no rule matches raises ``ValueError`` (replicating a
  large tensor silently is the quiet OOM this exists to prevent)."""
  specs = {}
  for name, value in named.items():
    if getattr(value, 'ndim', 0) == 0:
      specs[name] = ()
      continue
    for pattern, spec in rules:
      if re.search(pattern, name):
        specs[name] = tuple(spec)
        break
    else:
      raise ValueError(f'no partition rule matches {name!r}')
  return specs


def shard(t, spec, mesh, blocks=1):
  """This rank's shard of the whole tensor ``t`` under ``spec``: each dim
  whose entry names ``tensor`` is cut into ``tensor`` equal parts and the
  rank keeps its own. ``blocks`` > 1 cuts every one of that many equal
  blocks of the dim so (a fused q/k/v projection: each rank keeps its
  heads of q, of k and of v)."""
  import torch
  size = axis_size(mesh, 'tensor')
  if size == 1:
    return t
  rank = axis_rank(mesh, 'tensor')
  for dim, entry in enumerate(spec):
    if 'tensor' not in _axes(entry):
      continue
    n = t.shape[dim]
    if n % (blocks * size):
      raise ValueError(f'dim {dim} of {tuple(t.shape)} does not split into '
                       f'{blocks} block(s) x tensor={size}')
    part = n // (blocks * size)
    pieces = [t.narrow(dim, b * n // blocks + rank * part, part)
              for b in range(blocks)]
    t = pieces[0] if blocks == 1 else torch.cat(pieces, dim)
  return t


def unshard(stacked, spec, blocks=1):
  """The whole tensor from its ``tensor`` shards ``stacked``
  (``[tensor, *shard shape]``, :func:`stack_over`): :func:`shard`'s
  inverse. A spec with no ``tensor`` entry returns shard 0."""
  import torch
  dims = [d for d, e in enumerate(spec) if 'tensor' in _axes(e)]
  if not dims or stacked.shape[0] == 1:
    return stacked[0]
  (dim,) = dims
  shards = list(stacked.unbind(0))
  if blocks == 1:
    return torch.cat(shards, dim)
  return torch.cat([torch.cat([s.chunk(blocks, dim)[b] for s in shards], dim)
                    for b in range(blocks)], dim)


def reshard_state(state, mesh, like=None, rules=None, blocks=None):
  """This rank's shards of a **whole** state (``{name: tensor}``, world
  1's layout, as a checkpoint holds it) on ``mesh``: the counterpart of
  :func:`lddl_tpu.parallel.mesh.reshard_pytree`. Placement comes from
  exactly one of:

  - ``like``: a model built over ``mesh`` (its ``placement()`` gives
    each name's spec and ``param_blocks`` its blocks), the restore path;
  - ``rules``: ``[(regex, spec), ...]`` resolved by
    :func:`match_partition_rules`, with ``blocks(name)`` (default 1).

  A tensor is sliced, not copied."""
  if (like is None) == (rules is None):
    raise ValueError('pass exactly one of like= / rules=')
  if like is not None:
    specs = like.placement()
    blocks = like.param_blocks
    missing = sorted(set(state) - set(specs))
    if missing:
      raise ValueError(f'no placement for {missing}')
  else:
    specs = match_partition_rules(rules, state)
  blocks = blocks or (lambda name: 1)
  return {name: shard(t, specs[name], mesh, blocks(name))
          for name, t in state.items()}
