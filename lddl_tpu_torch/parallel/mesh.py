"""Mesh construction and the data layout of a global batch: the port of
:mod:`lddl_tpu.parallel.mesh`, over ``torch.distributed``.

Axes, in the JAX package's order (any can be size 1)::

  data    pure data parallelism (gradients all-reduced over the group)
  fsdp    data parallelism with sharded parameters and optimizer state
  tensor  tensor (Megatron-style) parallelism inside attention/MLP blocks
  seq     sequence parallelism (ring attention)

This slice ports ``data`` only: ``fsdp``, ``tensor`` or ``seq`` above 1
raise :class:`NotImplementedError`. A process group makes the mesh a
``torch.distributed.device_mesh.DeviceMesh``; a single process without
one has the mesh ``None`` (one rank holds the whole batch), and every
function here takes that.
"""

MESH_AXES = ('data', 'fsdp', 'tensor', 'seq')


def check_axes(fsdp=1, tensor=1, seq=1):
  """Raise for a model-parallel axis above 1 (later slices)."""
  if seq > 1:
    raise NotImplementedError(
        f'seq={seq}: ring attention over the seq axis is not ported yet '
        '(a later slice)')
  if fsdp > 1 or tensor > 1:
    raise NotImplementedError(
        f'fsdp={fsdp} tensor={tensor}: parameter placement (the fsdp and '
        'tensor axes, _RULES) is not ported yet (the next slice); this '
        'slice runs the data axis only')


def make_mesh(data=1, fsdp=1, tensor=1, seq=1, device_type=None):
  """The mesh over every rank of the default process group, or None in a
  single process with no group.

  Any leftover rank factor folds into ``data`` when data is left at its
  default, so ``make_mesh()`` is pure data parallelism over every rank
  (as :func:`lddl_tpu.parallel.mesh.make_mesh`). ``device_type`` defaults
  to ``cuda`` when the build has it; set the process's CUDA device first
  (``torch.cuda.set_device``), or DeviceMesh picks ``cuda:<LOCAL_RANK>``.
  """
  import torch
  import torch.distributed as dist
  check_axes(fsdp, tensor, seq)
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
  return init_device_mesh(device_type, (data, fsdp, tensor, seq),
                          mesh_dim_names=MESH_AXES)


def check_mesh(mesh):
  """Raise :class:`NotImplementedError` unless ``mesh`` is None or a
  DeviceMesh with a ``data`` axis and no other axis above 1."""
  if mesh is None:
    return
  from torch.distributed.device_mesh import DeviceMesh
  if not isinstance(mesh, DeviceMesh) or 'data' not in (
      mesh.mesh_dim_names or ()):
    raise NotImplementedError(
        f'mesh {mesh!r}: only a torch DeviceMesh with a data axis '
        '(make_mesh()) is ported')
  sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
  check_axes(sizes.get('fsdp', 1), sizes.get('tensor', 1),
             sizes.get('seq', 1))


def mesh_summary(mesh):
  if mesh is None:
    return ', '.join(f'{a}=1' for a in MESH_AXES)
  return ', '.join(f'{k}={v}' for k, v in zip(mesh.mesh_dim_names,
                                                mesh.shape))


def data_rank(mesh):
  """This rank's index on the ``data`` axis (0 without a mesh)."""
  return 0 if mesh is None else mesh.get_local_rank('data')


def data_size(mesh):
  """The ``data`` axis' size (1 without a mesh)."""
  return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index('data'))


def data_group(mesh):
  """The process group the gradients reduce over, or None."""
  return None if mesh is None else mesh.get_group('data')


def batch_rows(mesh, global_rows):
  """The rows of a ``global_rows`` batch this rank holds: the
  counterpart of ``batch_pspec``/``canonical_batch_spec``'s
  ``P(('data', 'fsdp'), 'seq')``, dim 0 split in ``data``-rank order into
  equal contiguous blocks (``seq`` is 1, so no rank splits a row)."""
  n = data_size(mesh)
  if global_rows % n:
    raise ValueError(f'{global_rows} rows do not split over data={n}')
  per = global_rows // n
  r = data_rank(mesh)
  return slice(r * per, (r + 1) * per)


def local_batch(batch, mesh):
  """This rank's rows of a global loader-format batch (a dict of arrays
  or tensors with the batch on dim 0)."""
  rows = batch_rows(mesh, len(next(iter(batch.values()))))
  return {k: v[rows] for k, v in batch.items()}
