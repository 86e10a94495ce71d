"""Deterministic time-travel over a recorded run: ``python -m
lddl_tpu_torch.replay.cli`` (the JAX package's ``lddl-replay``).

Subcommands (the coordinate grammar is the auditor's rendered key form,
e.g. ``epoch=0,index=3`` / ``epoch=1,gi=7`` / ``step=42``):

- ``batch LEDGER --key epoch=E,index=I <loader spec>`` — rematerialize
  the recorded batch by replaying the deterministic draw sequence to
  its coordinate, fingerprint it, and verdict against the ledger line
  (exit 0 match, 1 mismatch, 2 usage);
- ``bundle LEDGER --key ... --out DIR <loader spec>`` — same, then emit
  a hermetic repro bundle (packed batch bytes + Philox inputs +
  checkpoint ref + ledger excerpt — replayable with no corpus). A
  mismatching reconstruction refuses to bundle;
- ``step --checkpoint-dir D --step S [--ledger L] <loader spec |
  --bundle DIR ...>`` — restore the newest checkpoint <= S-1, re-execute
  to S through the step cache under deterministic algorithms, and diff
  the state fingerprint against the recorded ``step=S`` ledger line;
  ``--bundle`` may repeat, one bundle per step to re-execute, in order;
- ``bisect --checkpoint-dir D --lo A --hi B [--ledger L] <loader
  spec>`` — walk the step window, report the largest loss jump and the
  batch (optionally sample) coordinate that fed it; with ``--ledger``
  over the batches the run fed (exit 2 when no stream of the loader
  matches them), without it over the uninterrupted stream, unchecked
  (one line on stderr says so);
- ``smoke LEDGER <loader spec>`` — one random coordinate per boundary,
  replayed and verified.

The loader spec is the JAX CLI's: ``--path`` (BERT shards) /
``--synthetic`` / ``--factory MODULE:ATTR --kwargs-json ...``, plus
``--shuffle-buffer-size`` (the recorded run's, part of its batch
stream). The model arguments are the JAX CLI's, less ``--tokenizer`` (a
hub tokenizer needs the network; ``--vocab-file`` goes through the
port's vocab map), plus ``--device`` (default the CUDA card
``cuda:<local rank>``; ``cpu`` runs there). Step digests are the port's
own: a ledger the JAX package wrote replays here for its batches, not
its steps.

A sharded run (``--dp/--fsdp/--tp/--sp``, ring attention) sums a step's
products in another order than one process does, so its steps
re-execute bit for bit only on its own layout: ``step``, ``bisect`` and
``bundle`` are then launched as the recorded run's ranks with ``--comm
torch`` (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, e.g.
``torch.distributed.run --nproc-per-node N``; two ranks on one card add
``LDDL_DIST_CUDA_BACKEND=gloo``), over ``make_mesh(data=--dp,
fsdp=--fsdp, tensor=--tp, seq=--sp)``, as the pretrain CLI built it (at
world 1 the mesh of one, so ring attention runs at ``seq=1``; under
``--comm null`` no mesh, as there). A mesh whose size is not the world
size exits 2 and names the launch it needs. Each rank restores its
shards from the world-1 checkpoint, reads its own ledger file
(``ledger.rank<RANK>.jsonl``), feeds its batch rank's rows and its seq
columns of them, and the world compares the fingerprint of the gathered
state. The verdict is the world's: every rank exits 0 when every rank
matched, 1 on any mismatch, 2 when the replay could not reach a verdict
(a usage error or missing input on any rank, a tensor or seq group whose
ranks would feed different batches, a rank that failed); only rank 0
prints it. Launched as ranks, ``bundle --out DIR`` writes each batch
rank's bundle to ``DIR/rank<R>`` and ``step --bundle DIR`` feeds a rank
its batch rank's.
"""

import argparse
import json
import math
import os
import sys

_PROG = 'python -m lddl_tpu_torch.replay.cli'
_AXES = (('--dp', 'dp'), ('--fsdp', 'fsdp'), ('--tp', 'tp'), ('--sp', 'sp'))


def _attach_loader_args(p):
  p.add_argument('--path', default=None,
                 help='balanced shard directory (BERT pretrain loader)')
  p.add_argument('--vocab-file', default=None)
  p.add_argument('--batch-size', type=int, default=64)
  p.add_argument('--bin-size', type=int, default=None)
  p.add_argument('--max-seq-length', type=int, default=512)
  p.add_argument('--base-seed', type=int, default=12345)
  p.add_argument('--masking', default='static',
                 choices=('static', 'dynamic'))
  p.add_argument('--shuffle-buffer-size', type=int, default=None,
                 help="the recorded run's loader shuffle buffer (default: "
                      "the loader's)")
  p.add_argument('--dp-rank', type=int, default=0)
  p.add_argument('--dp-world', type=int, default=1)
  p.add_argument('--synthetic', action='store_true',
                 help='replay the SyntheticBatchLoader stream')
  p.add_argument('--steps', type=int, default=256,
                 help='steps per epoch in --synthetic mode')
  p.add_argument('--factory', default=None, metavar='MODULE:ATTR',
                 help='replay an arbitrary loader factory')
  p.add_argument('--kwargs-json', default='{}',
                 help='JSON kwargs for --factory')


def _shuffle_kwargs(args):
  if args.shuffle_buffer_size is None:
    return {}
  return {'shuffle_buffer_size': args.shuffle_buffer_size}


def loader_spec(args):
  """CLI args -> ``(factory, build_kwargs)`` for
  :func:`~lddl_tpu_torch.replay.rematerialize.rematerialize_batch` — the
  same three loader sources the data server accepts."""
  if args.synthetic:
    return ('lddl_tpu_torch.testing', 'get_synthetic_batch_loader'), dict(
        batch_size=args.batch_size, seq_len=args.max_seq_length,
        steps=args.steps)
  if args.factory:
    module, _, attr = args.factory.partition(':')
    return (module, attr), json.loads(args.kwargs_json)
  if not args.path:
    raise SystemExit(f'{_PROG}: need --path, --synthetic, or --factory')
  from ..comm import NullBackend
  return ('lddl_tpu_torch.loader.bert', 'get_bert_pretrain_data_loader'), dict(
      path=args.path, batch_size_per_rank=args.batch_size,
      vocab_file=args.vocab_file, bin_size=args.bin_size,
      max_seq_length=args.max_seq_length, base_seed=args.base_seed,
      masking=args.masking, dp_rank=args.dp_rank,
      dp_world_size=args.dp_world, comm=NullBackend(),
      **_shuffle_kwargs(args))


def _attach_model_args(p):
  from ..training.pretrain import MODEL_SIZES
  p.add_argument('--vocab-size', type=int, default=None,
                 help='padded vocab size, replacing --vocab-file '
                      '(bundle replay needs no vocab)')
  p.add_argument('--model', choices=sorted(MODEL_SIZES), default='base')
  p.add_argument('--attention',
                 choices=['dense', 'flash', 'ring', 'ring_flash'],
                 default='dense')
  p.add_argument('--remat', action='store_true')
  p.add_argument('--data-format', choices=['pairs', 'packed'],
                 default='pairs')
  p.add_argument('--block-diagonal', action='store_true')
  p.add_argument('--seed', type=int, default=127)
  p.add_argument('--learning-rate', type=float, default=1e-4)
  p.add_argument('--warmup-steps', type=int, default=100)
  p.add_argument('--total-steps', type=int, default=1000,
                 help='the recorded run\'s --steps (the LR schedule '
                      'depends on it; must match for bit-identity)')
  p.add_argument('--weight-decay', type=float, default=0.01)
  p.add_argument('--max-predictions', type=int, default=None)
  p.add_argument('--prefetch', type=int, default=2)
  p.add_argument('--device', default=None,
                 help="torch device; default the CUDA card "
                      "cuda:<local rank> (raises without one). 'cpu' runs "
                      'on the CPU')
  _attach_world_args(p)


def _attach_world_args(p):
  for flag, _ in _AXES:
    p.add_argument(flag, type=int, default=1,
                   help='the recorded run\'s mesh axis (above 1: launch as '
                        'its ranks with --comm torch)')
  p.add_argument('--comm', choices=['null', 'torch'], default='null',
                 help="'torch': run as the recorded run's ranks, a "
                      "torch.distributed group from the launcher's "
                      "environment (RANK, WORLD_SIZE, MASTER_ADDR, "
                      'MASTER_PORT)')


def check_world(args, world_size):
  """``ValueError`` unless the mesh of ``--dp/--fsdp/--tp/--sp`` has
  ``world_size`` ranks (a sharded step re-executes bit for bit only on
  its own layout), naming the launch it needs."""
  sizes = [getattr(args, name) for _, name in _AXES]
  n = math.prod(sizes)
  if n == world_size:
    return
  axes = ' '.join(f'{flag} {v}' for (flag, _), v in zip(_AXES, sizes))
  raise ValueError(
      f'{axes}: a mesh of {n} rank(s), and this replay runs as '
      f'{world_size} process(es). A sharded step re-executes bit for bit '
      'only on its own layout: launch the replay as the recorded run\'s '
      f'ranks, WORLD_SIZE={n} with RANK, MASTER_ADDR and MASTER_PORT set '
      f'(e.g. python -m torch.distributed.run --nproc-per-node {n} -m '
      'lddl_tpu_torch.replay.cli ...), with --comm torch')


def _device(args, comm):
  """The rank's device (:func:`~lddl_tpu_torch.training.pretrain.
  rank_device`); on the card, the deterministic cuBLAS workspace is set
  before anything initialises CUDA."""
  from ..training.pretrain import rank_device, require_deterministic_cublas
  if args.device is None or not str(args.device).startswith('cpu'):
    require_deterministic_cublas()
  try:
    return rank_device(args.device, comm)
  except RuntimeError as e:  # no card, and --device cpu not given
    raise ValueError(str(e)) from None


def _comm(args):
  from ..comm import NullBackend, get_backend
  return get_backend('torch') if args.comm == 'torch' else NullBackend()


def build_loop(args):
  """Reconstruct the recorded run's
  :class:`~lddl_tpu_torch.training.pretrain.TrainLoop` from CLI args —
  every knob the LR schedule, model shapes, or data stream depend on
  must match the original run, or the replayed arithmetic (correctly)
  diverges. With ``--comm torch`` the loop is this rank's over
  ``make_mesh(data=--dp, fsdp=--fsdp, tensor=--tp, seq=--sp)`` (every
  rank calls it: the mesh's groups are made collectively), as the
  pretrain CLI builds it; a mesh that is not the world's size is
  ``ValueError`` (:func:`check_world`)."""
  from ..models import BertConfig
  from ..parallel import make_mesh
  from ..tokenization.wordpiece import load_bert_tokenizer
  from ..training.pretrain import MODEL_SIZES, TrainLoop
  comm = _comm(args)
  check_world(args, comm.world_size)
  device = _device(args, comm)
  mesh = None
  if args.comm == 'torch':
    mesh = make_mesh(data=args.dp, fsdp=args.fsdp, tensor=args.tp,
                     seq=args.sp, device_type=device.type)
  tokenizer = (load_bert_tokenizer(args.vocab_file) if args.vocab_file
               else None)
  vocab = args.vocab_size
  if vocab is None:
    if tokenizer is None:
      raise ValueError('need --vocab-file or --vocab-size')
    vocab = ((tokenizer.vocab_size + 63) // 64) * 64
  cfg = BertConfig(
      vocab_size=vocab,
      max_position_embeddings=max(args.max_seq_length, 512),
      attention_impl=args.attention,
      remat=args.remat,
      **MODEL_SIZES[args.model])
  return TrainLoop.build(
      args.path, tokenizer, model_cfg=cfg, device=device,
      learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
      total_steps=args.total_steps, weight_decay=args.weight_decay,
      batch_size_per_rank=args.batch_size, bin_size=args.bin_size,
      max_seq_length=args.max_seq_length, masking=args.masking,
      seed=args.seed, max_predictions=args.max_predictions,
      data_format=args.data_format, block_diagonal=args.block_diagonal,
      loader_kwargs=_shuffle_kwargs(args) or None, mesh=mesh, comm=comm)


def _parse_key(spec):
  from ..telemetry.audit import parse_key
  try:
    return parse_key(spec)
  except ValueError as e:
    raise SystemExit(f'{_PROG}: {e}')


def _print_result(result, as_json):
  out = {k: v for k, v in result.items() if k != 'batch'}
  if as_json:
    print(json.dumps(out, indent=2, default=str))
    return
  from .rematerialize import format_coordinate
  coord = format_coordinate(out.get('coordinate', {'step': out.get('step')}))
  if out.get('match'):
    print(f'replay: ({coord}) reconstructed bit-identical — '
          f'{out["reconstructed" if "reconstructed" in out else "digest"]} '
          f'({out["algo"]})')
  elif 'match' in out:
    print(f'replay: ({coord}) MISMATCH — recorded '
          f'{out["recorded"]}, reconstructed '
          f'{out.get("reconstructed", out.get("digest"))}')
  else:
    print(json.dumps(out, indent=2, default=str))


def _cmd_batch(args):
  from .rematerialize import replay_coordinate
  key = _parse_key(args.key)
  factory, kwargs = loader_spec(args)
  result = replay_coordinate(args.ledger, key, factory, kwargs,
                             boundary=args.boundary, rank=args.rank)
  _print_result(result, args.as_json)
  return 0 if result['match'] else 1


class _Stop(Exception):
  """The world agreed on a non-zero exit code (some rank failed)."""

  def __init__(self, code):
    super().__init__(code)
    self.code = code


class World:
  """The processes a replay command runs as: one (``--comm null``), or
  the recorded run's ranks (``--comm torch``).

  The ranks agree in rounds, each one object all-gather over the world
  (gloo, CPU): before the first collective (:meth:`agree`), once every
  rank has read what it reads alone (:meth:`ready`: also that the ranks
  of a tensor or seq group will feed the same batches), and on the
  verdict (:meth:`verdict`). A rank that fails before the replay's
  collectives joins the next round with its exit code (:meth:`abort`),
  so every rank exits with it; one that fails inside them exits, and the
  others' collectives fail with it."""

  def __init__(self, args):
    self.comm = _comm(args)
    self.rank = self.comm.rank
    self.batch_rank = 0
    self._collective = False

  def _round(self, code, plan=None):
    gathered = self.comm.allgather_object((code, self.batch_rank, plan))
    worst = max(c for c, _, _ in gathered)
    if worst:
      return worst
    plans = {}
    for rank, (_, batch_rank, p) in enumerate(gathered):
      if p is not None:
        plans.setdefault(batch_rank, {})[rank] = p
    for batch_rank, by_rank in sorted(plans.items()):
      if len({tuple(p) for p in by_rank.values()}) > 1:
        if self.rank == 0:
          print(f'replay: the ranks {sorted(by_rank)} of batch rank '
                f'{batch_rank} would feed different batches '
                f'({by_rank}); a tensor or seq group feeds the same rows',
                file=sys.stderr)
        return 2
    return 0

  def agree(self, code=0, plan=None):
    worst = self._round(code, plan)
    if worst:
      raise _Stop(worst)

  def ready(self, plan, loop=None):
    """:meth:`agree` with the batches this rank will feed (their
    digests), before the replay's first collective."""
    if loop is not None and loop.mesh is not None:
      self.batch_rank = loop.dp_rank
    self.agree(0, plan)
    self._collective = True

  def verdict(self, code):
    self._collective = False
    return self._round(code)

  def abort(self, code):
    """Join the next round with ``code`` (not inside the collectives,
    where the others wait in another call)."""
    if self._collective:
      return code
    try:
      return max(code, self._round(code))
    except Exception:  # a peer already gone
      return code

  def run(self, fn):
    """``fn()``'s exit code, the world's: a failure on any rank is every
    rank's exit code."""
    try:
      return fn()
    except _Stop as e:
      return e.code
    except Exception as e:
      from .rematerialize import ReplayMismatch
      expected = (ReplayMismatch, FileNotFoundError, LookupError,
                  ValueError, NotImplementedError)
      if self.comm.world_size == 1 and not isinstance(e, expected):
        raise
      print(f'replay: {e}' if isinstance(e, expected) else
            f'replay: rank {self.rank}: {type(e).__name__}: {e}',
            file=sys.stderr)
      # A named fingerprint mismatch is a *verdict* (CI-gateable), not a
      # usage error.
      return self.abort(1 if isinstance(e, ReplayMismatch) else 2)


def _cmd_bundle(args):
  world = World(args)

  def bundle():
    from ..telemetry.audit import load_run
    from .bundle import write_bundle
    from .rematerialize import lookup_digest, replay_coordinate
    check_world(args, world.comm.world_size)
    key = _parse_key(args.key)
    out_dir, writes, rank, mesh = args.out, True, args.rank, None
    if args.comm == 'torch':
      from ..parallel import batch_rank, batch_size, make_mesh
      from ..parallel.mesh import axis_rank
      world.agree()
      mesh = make_mesh(data=args.dp, fsdp=args.fsdp, tensor=args.tp,
                       seq=args.sp, device_type='cpu')
      if mesh is not None:
        # One rank's batch a bundle: the batch rank's loader and its
        # ledger file; the first rank of its tensor x seq group writes it.
        world.batch_rank = args.dp_rank = batch_rank(mesh)
        args.dp_world = batch_size(mesh)
        out_dir = os.path.join(args.out, f'rank{args.dp_rank}')
        writes = axis_rank(mesh, 'tensor') == axis_rank(mesh, 'seq') == 0
        rank = world.rank if rank is None else rank
    factory, kwargs = loader_spec(args)
    if mesh is not None and not args.synthetic:
      kwargs = dict(kwargs, dp_rank=args.dp_rank, dp_world_size=args.dp_world)
    result = replay_coordinate(args.ledger, key, factory, kwargs,
                               boundary=args.boundary, rank=rank)
    if not result['match'] and world.rank == 0:
      _print_result(result, args.as_json)
    world.agree(0 if result['match'] else 1, [result['reconstructed']])
    if writes:
      _, hits = lookup_digest(load_run(args.ledger, rank=rank),
                              key, boundary=args.boundary)
      coord = dict(key)
      philox = {'base_seed': kwargs.get('base_seed', args.base_seed),
                'dp_rank': kwargs.get('dp_rank', args.dp_rank),
                'epoch': coord.get('epoch'),
                'step': coord.get('index', coord.get('gi'))}
      checkpoint = None
      if args.checkpoint_dir:
        checkpoint = {'dir': args.checkpoint_dir,
                      'step': args.checkpoint_step}
      write_bundle(
          out_dir, result['batch'], coord, digest=result['recorded'],
          philox=philox, checkpoint=checkpoint,
          ledger_excerpt=[dict(rec, rank=r) for r, rec in hits],
          algo=result['algo'])
    code = world.verdict(0)
    if world.rank == 0 and not code:
      print(f'replay: bundle written to {out_dir}' if out_dir == args.out
            else f'replay: bundles written to {args.out}/rank<R>, one a '
                 'batch rank')
    return code

  code = world.run(bundle)
  if code == 1 and world.rank == 0:
    print('replay: refusing to bundle a mismatching reconstruction',
          file=sys.stderr)
  return code


def _step_batches(args, loop):
  """The bundled batches this rank feeds, one per step (None: the
  corpus); on a mesh each ``--bundle`` names a step's directory of every
  batch rank's bundles (or this rank's own bundle)."""
  if not args.bundle:
    return None
  from .bundle import rank_bundle, read_bundle
  batch_rank = loop.dp_rank if loop.mesh is not None else None
  batches = []
  for path in args.bundle:
    manifest, batch = read_bundle(rank_bundle(path, batch_rank))
    dp_rank = (manifest.get('philox') or {}).get('dp_rank')
    if batch_rank is not None and dp_rank not in (None, batch_rank):
      raise ValueError(f'bundle {path} holds batch rank {dp_rank}\'s batch; '
                       f'this rank feeds batch rank {batch_rank}\'s')
    batches.append(batch)
  return batches


def _cmd_step(args):
  world = World(args)

  def step():
    from .steps import replay_step_coordinate
    check_world(args, world.comm.world_size)
    world.agree()
    loop = build_loop(args)
    result = replay_step_coordinate(
        loop, args.checkpoint_dir, args.step, ledger_path=args.ledger,
        batches=_step_batches(args, loop), prefetch=args.prefetch,
        rank=args.rank, agree=lambda plan: world.ready(plan, loop))
    result['coordinate'] = {'step': args.step}
    code = world.verdict(0 if result.get('match', True) else 1)
    if world.rank == 0:
      if code and result.get('match', True):
        print(f'replay: (step={args.step}) MISMATCH on another rank; this '
              f'rank reconstructed {result["digest"]} ({result["algo"]})')
      else:
        _print_result(result, args.as_json)
    return code

  return world.run(step)


def _cmd_bisect(args):
  world = World(args)

  def bisect():
    from .steps import bisect_window
    check_world(args, world.comm.world_size)
    world.agree()
    loop = build_loop(args)
    if args.ledger is None and world.rank == 0:
      print('replay: bisect feeds the uninterrupted stream, not checked '
            'against a recording (pass --ledger)', file=sys.stderr)
    result = bisect_window(loop, args.checkpoint_dir, args.lo, args.hi,
                           prefetch=args.prefetch,
                           per_sample=args.per_sample,
                           ledger_path=args.ledger,
                           agree=lambda plan: world.ready(plan, loop))
    code = world.verdict(0)
    if world.rank == 0:
      _print_bisect(args, result)
    return code

  return world.run(bisect)


def _print_bisect(args, result):
  if args.as_json:
    print(json.dumps(result, indent=2, default=str))
    return
  print(f'replay: spike at step {result["spike_step"]} '
        f'(loss {result["spike_loss"]:.4f}, jump +{result["delta"]:.4f} '
        f'over window ({args.lo}, {args.hi}])')
  if 'batch_coordinate' in result:
    c = result['batch_coordinate']
    print(f'  fed by batch epoch={c["epoch"]}, index={c["index"]}')
  if 'spike_sample' in result:
    print(f'  dominant sample: row {result["spike_sample"]} '
          f'(per-sample loss '
          f'{result["per_sample"][result["spike_sample"]]:.4f})')


def _cmd_smoke(args):
  from .rematerialize import replay_smoke
  factory, kwargs = loader_spec(args)
  results, rc = replay_smoke(args.ledger, factory, kwargs,
                             seed=args.seed, rank=args.rank)
  if args.as_json:
    print(json.dumps(results, indent=2, default=str))
  else:
    for bd, r in sorted(results.items()):
      print(f'{bd}: {r["status"]}' +
            (f' at {r["coordinate"]}' if 'coordinate' in r else '') +
            (f' — {r.get("error") or r.get("reason", "")}'
             if r['status'] not in ('ok',) else ''))
  return rc


def attach_args(parser):
  sub = parser.add_subparsers(dest='command')

  p = sub.add_parser('batch', help='rematerialize + verify one recorded '
                                   'batch coordinate')
  p.add_argument('ledger', help='ledger directory or rank file')
  p.add_argument('--key', required=True, metavar='LINEAGE_KEY',
                 help="e.g. 'epoch=0,index=3' or 'epoch=1,gi=7'")
  p.add_argument('--boundary', default=None)
  p.add_argument('--rank', type=int, default=None)
  p.add_argument('--json', action='store_true', dest='as_json')
  _attach_loader_args(p)

  p = sub.add_parser('bundle', help='emit a hermetic repro bundle for a '
                                    'verified coordinate')
  p.add_argument('ledger')
  p.add_argument('--key', required=True, metavar='LINEAGE_KEY')
  p.add_argument('--out', required=True, help='bundle directory to write')
  p.add_argument('--boundary', default=None)
  p.add_argument('--rank', type=int, default=None)
  p.add_argument('--checkpoint-dir', default=None,
                 help='checkpoint ref to embed (step replay later)')
  p.add_argument('--checkpoint-step', type=int, default=None)
  p.add_argument('--json', action='store_true', dest='as_json')
  _attach_loader_args(p)
  _attach_world_args(p)

  p = sub.add_parser('step', help='re-execute a recorded train step and '
                                  'diff its state fingerprint')
  p.add_argument('--checkpoint-dir', required=True)
  p.add_argument('--step', type=int, required=True)
  p.add_argument('--ledger', default=None,
                 help='verdict against this run\'s step records')
  p.add_argument('--bundle', default=None, action='append',
                 help='feed the steps from repro bundles (no corpus): one '
                      'per step from the restored checkpoint on, in order; '
                      'launched as ranks, a step\'s directory of rank<R>/ '
                      'bundles (one a batch rank) or the rank\'s own bundle')
  p.add_argument('--rank', type=int, default=None)
  p.add_argument('--json', action='store_true', dest='as_json')
  _attach_loader_args(p)
  _attach_model_args(p)

  p = sub.add_parser('bisect', help='walk a step window, attribute the '
                                    'largest loss jump')
  p.add_argument('--checkpoint-dir', required=True)
  p.add_argument('--lo', type=int, required=True)
  p.add_argument('--hi', type=int, required=True)
  p.add_argument('--per-sample', action='store_true',
                 help='re-score the spike batch row by row')
  p.add_argument('--ledger', default=None,
                 help='the run\'s ledger: feed the batches it records the '
                      'run fed')
  p.add_argument('--json', action='store_true', dest='as_json')
  _attach_loader_args(p)
  _attach_model_args(p)

  p = sub.add_parser('smoke', help='replay one random coordinate per '
                                   'boundary')
  p.add_argument('ledger')
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--rank', type=int, default=None)
  p.add_argument('--json', action='store_true', dest='as_json')
  _attach_loader_args(p)
  return parser


def main(argv=None):
  parser = attach_args(argparse.ArgumentParser(
      prog=_PROG,
      description='deterministic time-travel: rematerialize any batch '
                  'or train step a recorded run consumed',
      formatter_class=argparse.RawDescriptionHelpFormatter))
  args = parser.parse_args(argv)
  cmds = {'batch': _cmd_batch, 'bundle': _cmd_bundle, 'step': _cmd_step,
          'bisect': _cmd_bisect, 'smoke': _cmd_smoke}
  fn = cmds.get(args.command)
  if fn is None:
    parser.print_usage(sys.stderr)
    return 2
  from .rematerialize import ReplayMismatch
  try:
    return fn(args)
  except ReplayMismatch as e:
    # A named fingerprint mismatch is a *verdict* (CI-gateable), not a
    # usage error.
    print(f'replay: {e}', file=sys.stderr)
    return 1
  except (FileNotFoundError, LookupError, ValueError,
          NotImplementedError) as e:
    print(f'replay: {e}', file=sys.stderr)
    return 2


if __name__ == '__main__':
  sys.exit(main())
