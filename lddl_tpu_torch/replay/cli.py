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
port's vocab map), plus ``--device`` (default the CUDA card; ``cpu``
runs there). ``--fsdp/--tp/--sp`` above 1 raise (a sharded step
re-executes bit for bit only on its own layout, launched as ranks), so
does ring attention (it runs over a mesh, which one replay process has
not), and ``--dp`` above 1 (a step of a data-parallel run needs its
ranks' batches). Step digests are the port's own: a ledger
the JAX package wrote replays here for its batches, not its steps.
"""

import argparse
import json
import sys

_PROG = 'python -m lddl_tpu_torch.replay.cli'


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
  p.add_argument('--dp', type=int, default=1)
  p.add_argument('--fsdp', type=int, default=1)
  p.add_argument('--tp', type=int, default=1)
  p.add_argument('--sp', type=int, default=1)
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
                 help="torch device; default the CUDA card (raises "
                      "without one). 'cpu' runs on the CPU")


def _device(args):
  """The replay's device; on the card, the deterministic cuBLAS
  workspace is set before anything initialises CUDA."""
  from ..training.pretrain import require_deterministic_cublas, resolve_device
  try:
    device = resolve_device(args.device)
  except RuntimeError as e:  # no card, and --device cpu not given
    raise ValueError(str(e)) from None
  if device.type == 'cuda':
    require_deterministic_cublas()
  return device


def build_loop(args):
  """Reconstruct the recorded run's
  :class:`~lddl_tpu_torch.training.pretrain.TrainLoop` from CLI args —
  every knob the LR schedule, model shapes, or data stream depend on
  must match the original run, or the replayed arithmetic (correctly)
  diverges."""
  from ..models import BertConfig
  from ..tokenization.wordpiece import load_bert_tokenizer
  from ..training.pretrain import MODEL_SIZES, TrainLoop
  if args.fsdp != 1 or args.tp != 1 or args.sp != 1:
    # A step of a sharded run sums its products in another order than one
    # process does, so it re-executes bit for bit only on its own layout.
    raise NotImplementedError(
        f'--fsdp {args.fsdp} --tp {args.tp} --sp {args.sp}: a single replay '
        'process cannot re-execute a sharded step bit for bit; replay of a '
        'sharded run, launched as ranks, is not ported (ROADMAP Queue 1)')
  if args.attention in ('ring', 'ring_flash'):
    # The ring runs over a mesh's seq group (at seq 1 too: one block, then
    # the merge); without one the model would run dense or flash.
    raise NotImplementedError(
        f'--attention {args.attention}: ring attention runs over a mesh; '
        'replay of a sharded run, launched as ranks, is not ported '
        '(ROADMAP Queue 1)')
  if args.dp != 1:
    raise ValueError(f'--dp {args.dp}: step replay runs one process; a '
                     'data-parallel step needs every rank\'s batch')
  device = _device(args)
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
      loader_kwargs=_shuffle_kwargs(args) or None)


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


def _cmd_bundle(args):
  from ..telemetry.audit import load_run
  from .bundle import write_bundle
  from .rematerialize import lookup_digest, replay_coordinate
  key = _parse_key(args.key)
  factory, kwargs = loader_spec(args)
  result = replay_coordinate(args.ledger, key, factory, kwargs,
                             boundary=args.boundary, rank=args.rank)
  if not result['match']:
    _print_result(result, args.as_json)
    print('replay: refusing to bundle a mismatching reconstruction',
          file=sys.stderr)
    return 1
  _, hits = lookup_digest(load_run(args.ledger, rank=args.rank),
                          key, boundary=args.boundary)
  coord = dict(key)
  philox = {'base_seed': kwargs.get('base_seed', args.base_seed),
            'dp_rank': kwargs.get('dp_rank', args.dp_rank),
            'epoch': coord.get('epoch'),
            'step': coord.get('index', coord.get('gi'))}
  checkpoint = None
  if args.checkpoint_dir:
    checkpoint = {'dir': args.checkpoint_dir, 'step': args.checkpoint_step}
  out = write_bundle(
      args.out, result['batch'], coord, digest=result['recorded'],
      philox=philox, checkpoint=checkpoint,
      ledger_excerpt=[dict(rec, rank=r) for r, rec in hits],
      algo=result['algo'])
  print(f'replay: bundle written to {out}')
  return 0


def _cmd_step(args):
  from .steps import replay_step_coordinate
  batches = None
  if args.bundle:
    from .bundle import read_bundle
    batches = [read_bundle(b)[1] for b in args.bundle]
  loop = build_loop(args)
  result = replay_step_coordinate(
      loop, args.checkpoint_dir, args.step, ledger_path=args.ledger,
      batches=batches, prefetch=args.prefetch, rank=args.rank)
  result['coordinate'] = {'step': args.step}
  _print_result(result, args.as_json)
  if 'match' not in result:
    return 0  # no ledger to verdict against; the replay itself succeeded
  return 0 if result['match'] else 1


def _cmd_bisect(args):
  from .steps import bisect_window
  loop = build_loop(args)
  if args.ledger is None:
    print('replay: bisect feeds the uninterrupted stream, not checked '
          'against a recording (pass --ledger)', file=sys.stderr)
  result = bisect_window(loop, args.checkpoint_dir, args.lo, args.hi,
                         prefetch=args.prefetch,
                         per_sample=args.per_sample,
                         ledger_path=args.ledger)
  if args.as_json:
    print(json.dumps(result, indent=2, default=str))
  else:
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
  return 0


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

  p = sub.add_parser('step', help='re-execute a recorded train step and '
                                  'diff its state fingerprint')
  p.add_argument('--checkpoint-dir', required=True)
  p.add_argument('--step', type=int, required=True)
  p.add_argument('--ledger', default=None,
                 help='verdict against this run\'s step records')
  p.add_argument('--bundle', default=None, action='append',
                 help='feed the steps from repro bundles (no corpus): one '
                      'per step from the restored checkpoint on, in order')
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
