"""Black-box flight recorder: bounded batch ring → hermetic incidents.

A copy of :mod:`lddl_tpu.training.flight` over the port's modules
(numpy and the stdlib at import; torch only through the profiler it may
arm). While the loop runs, the recorder keeps:

- the last **K host batches**, packed through the shm/wire
  ``_pack_into`` spec (:func:`~lddl_tpu_torch.loader.service.
  pack_batch`) — the *same bytes* the determinism ledger fingerprints,
  so a frozen batch carries its own ground truth;
- each batch's **ledger coordinate** ``(epoch, index)`` via the
  loaders' public ``coordinate_of_batch`` contract (ring ordinals are
  global step numbers: one batch per rank per step);
- a short window of **step metrics** (loss, grad norm, data wait) and
  the latest **checkpoint ref**.

The ring tees the *host* iterator before
:func:`~lddl_tpu_torch.loader.device.prefetch_to_device` (device tensors
cannot be packed, and re-fetching them would perturb the run), so
:meth:`FlightRecorder.wrap_host_stream` executes on the feed's producer
thread — the ring is lock-protected.

When a sentinel (:mod:`lddl_tpu_torch.telemetry.sentinel`) fires,
:meth:`capture` (on the loop's thread, between steps) freezes everything
into an incident directory::

  incident-step42-loss_spike/
    incident.json            # trigger, suspect coordinate, ring index,
                             # recent metrics, live_status snapshot,
                             # ledger excerpt, checkpoint ref
    bundles/
      ord000042-e0-i42/      # a replay bundle per ring entry
        bundle.json
        batch.bin

The layout and the manifest are the JAX package's. Each bundle is written
with the payload's **pre-capture** fingerprint, so the replay reader
later proves bit-for-bit identity. Capture can also arm the port's
:class:`~lddl_tpu_torch.telemetry.profiling.StepProfiler` for the next N
steps (``LDDL_FLIGHT_PROFILE_STEPS``) so the trace of the steps *after*
the anomaly lands next to its cause.

Capture must never take down the run it is documenting: every failure
inside :meth:`capture` is caught and reported, not raised. The
``flight.dump`` fault site drills the two failure classes — a raise-spec
kills a dump at entry (training continues), a corrupt-spec flips a byte
of one bundle payload mid-dump so the replay reader later *rejects* the
damaged bundle instead of silently replaying it.

The recorder rides the sentinel's gate: ``get_flight_recorder()``
returns the live recorder only when ``LDDL_SENTINEL`` is on, else the
shared no-op (whose ``wrap_host_stream`` returns the iterator untouched
— zero overhead, zero threads, zero files).

:func:`main` is the incident CLI, ``python -m
lddl_tpu_torch.training.flight``: ``list``/``show`` incidents,
``replay``/``bisect`` pass through to ``python -m
lddl_tpu_torch.replay.cli``. ``replay`` with step arguments feeds the
step replay every ring bundle from the incident's checkpoint to its
``replay_step`` (the JAX CLI feeds the suspect's alone, which covers only
a checkpoint at the suspect's step). ``bisect <incident> -- --ledger L
...`` hands the run's ledger to the bisect, which then feeds the batches
the run fed (the manifest names no ledger).
"""

import argparse
import json
import os
import sys
import threading
import time

from ..core import faults
from ..loader.service import pack_batch, unpack_batch
from ..replay.bundle import write_bundle
from ..replay.rematerialize import ReplayMismatch, format_coordinate
from ..telemetry.ledger import fingerprint_packed, get_ledger
from ..telemetry.sentinel import get_sentinel

_ENV_DIR = 'LDDL_FLIGHT_DIR'
_ENV_RING = 'LDDL_FLIGHT_RING'
_ENV_PROFILE = 'LDDL_FLIGHT_PROFILE_STEPS'

#: Incident manifest filename — what ``scan_incidents`` looks for.
MANIFEST = 'incident.json'

#: Ring capacity when ``LDDL_FLIGHT_RING`` is unset.
DEFAULT_RING = 8

#: Captures per process — a pathological run (every step fires) must
#: not fill the disk with identical incidents.
DEFAULT_MAX_INCIDENTS = 8

_REPLAY = 'python -m lddl_tpu_torch.replay.cli'
_INCIDENT = 'python -m lddl_tpu_torch.training.flight'


class NoopFlightRecorder:
  """Shared inert recorder: the stream passes through untouched."""

  __slots__ = ()
  enabled = False

  def wrap_host_stream(self, it, loader=None, ordinal0=0):
    return it

  def record_step(self, step, **metrics):
    return None

  def note_checkpoint(self, ckpt_dir, step):
    return None

  def capture(self, trigger, extra=None):
    return None


NOOP_FLIGHT = NoopFlightRecorder()


class FlightRecorder:
  """Bounded ring of packed batches + step metrics, frozen on trigger."""

  enabled = True

  def __init__(self, out_dir=None, capacity=None, metrics_window=None,
               profile_steps=None, max_incidents=DEFAULT_MAX_INCIDENTS):
    if out_dir is None:
      out_dir = os.environ.get(_ENV_DIR, '').strip()
    if not out_dir:
      base = os.environ.get('LDDL_TELEMETRY_DIR', '').strip() or '.'
      out_dir = os.path.join(base, 'incidents')
    self.out_dir = out_dir
    raw = os.environ.get(_ENV_RING, '').strip()
    self.capacity = int(capacity if capacity is not None
                        else (raw or DEFAULT_RING))
    self.metrics_window = int(metrics_window or 4 * self.capacity)
    raw = os.environ.get(_ENV_PROFILE, '').strip()
    self.profile_steps = int(profile_steps if profile_steps is not None
                             else (raw or 0))
    self.max_incidents = int(max_incidents)
    self._ring = []      # [{'ordinal','epoch','index','spec','payload'}]
    self._metrics = []   # [{'step', **scalars}]
    self._checkpoint = None
    self._lock = threading.Lock()
    self._warned = False
    self.incident_dirs = []

  # -- recording (hot path)

  def wrap_host_stream(self, it, loader=None, ordinal0=0):
    """Tee the host batch iterator into the ring.

    Runs on whatever thread drives ``it`` (the feed's producer).
    ``ordinal0`` is the global step the first yielded batch will feed;
    coordinates come from ``loader.coordinate_of_batch`` when the loader
    publishes that contract, else ``(None, ordinal)``. A packing failure
    is reported once and skipped — the recorder must never starve the
    input pipeline. Closing the tee closes ``it`` (a worker loader's
    processes go with it, as when the feed closes its source).
    """
    def tee():
      ordinal = int(ordinal0)
      try:
        for batch in it:
          try:
            self._record_batch(batch, loader, ordinal)
          except Exception as exc:
            # _warned is shared with capture(), which runs on the loop's
            # thread: claim the warning under the lock.
            with self._lock:
              first, self._warned = not self._warned, True
            if first:
              print(f'flight: batch recording disabled after error: '
                    f'{type(exc).__name__}: {exc}', file=sys.stderr)
          ordinal += 1
          yield batch
      finally:
        close = getattr(it, 'close', None)
        if close is not None:
          close()
    return tee()

  def _record_batch(self, batch, loader, ordinal):
    spec, payload = pack_batch(batch)  # copies: detached from the batch
    epoch = index = None
    co = getattr(loader, 'coordinate_of_batch', None)
    if co is not None:
      try:
        epoch, index = co(ordinal)
      except Exception:
        epoch, index = None, None
    if index is None:
      index = ordinal
    with self._lock:
      self._ring.append({'ordinal': ordinal, 'epoch': epoch,
                         'index': index, 'spec': spec, 'payload': payload})
      del self._ring[:-self.capacity]

  def record_step(self, step, **scalars):
    """Append one step's scalars (loss, grad_norm, data_wait) to the
    bounded metrics window that ships inside the manifest."""
    entry = {'step': int(step)}
    entry.update({k: v for k, v in scalars.items() if v is not None})
    with self._lock:
      self._metrics.append(entry)
      del self._metrics[:-self.metrics_window]

  def note_checkpoint(self, ckpt_dir, step):
    """Remember the newest checkpoint a replay can restore from."""
    with self._lock:
      self._checkpoint = {'dir': os.path.abspath(ckpt_dir),
                          'step': int(step)}

  # -- capture (cold path)

  def capture(self, trigger, extra=None):
    """Freeze the ring into an incident directory; returns its path or
    None. Never raises: an incident dump failing must not crash the
    training run it is documenting (the failure is reported instead)."""
    try:
      with self._lock:
        capped = len(self.incident_dirs) >= self.max_incidents
        first = capped and not self._warned
        self._warned = self._warned or capped
      if capped:
        if first:
          print(f'flight: incident cap ({self.max_incidents}) reached; '
                'further triggers are counted but not captured',
                file=sys.stderr)
        return None
      faults.inject('flight.dump', step=trigger.get('step'))
      return self._dump(trigger, extra)
    except Exception as exc:
      print(f'flight: incident capture failed: '
            f'{type(exc).__name__}: {exc}', file=sys.stderr)
      return None

  def _incident_dir(self, trigger):
    step = trigger.get('step')
    tag = (f'step{step}' if step is not None else 'async')
    base = os.path.join(self.out_dir,
                        f'incident-{tag}-{trigger.get("detector", "x")}')
    path, n = base, 1
    while os.path.exists(path):
      n += 1
      path = f'{base}-{n}'
    return path

  def _dump(self, trigger, extra):
    with self._lock:
      entries = list(self._ring)
      metrics = list(self._metrics)
      checkpoint = dict(self._checkpoint) if self._checkpoint else None
    out = self._incident_dir(trigger)
    os.makedirs(out, exist_ok=True)
    step = trigger.get('step')
    ring, suspect = [], None
    for e in entries:
      coord = ({'epoch': e['epoch'], 'index': e['index']}
               if e['epoch'] is not None else {'index': e['index']})
      # The recorded fingerprint is taken from the *pristine* ring bytes
      # — the same bytes the ledger hashed at collate time. The
      # corrupt-spec drill below damages only the dumped copy, so the
      # replay reader proves it rejects a corrupted incident bundle.
      digest = fingerprint_packed(e['spec'], e['payload'])
      payload = bytearray(e['payload'])
      faults.corrupt_bytes('flight.dump', payload, **coord)
      name = f'ord{e["ordinal"]:06d}-e{e["epoch"]}-i{e["index"]}'
      bdir = os.path.join(out, 'bundles', name)
      write_bundle(bdir, unpack_batch(e['spec'], payload), coord,
                   digest=digest, checkpoint=checkpoint)
      entry = {'ordinal': e['ordinal'], 'coordinate': coord,
               'digest': digest, 'payload_bytes': len(e['payload']),
               'bundle': os.path.join('bundles', name),
               'suspect': step is not None and e['ordinal'] == step}
      if entry['suspect']:
        suspect = entry
      ring.append(entry)
    if suspect is None and ring:
      suspect = ring[-1]  # async triggers: newest batch is the best lead
    led = get_ledger()
    manifest = {
        'version': 1,
        'trigger': dict(trigger),
        'step': step,
        'replay_step': (step + 1) if step is not None else None,
        'unix_time': time.time(),
        'pid': os.getpid(),
        'checkpoint': checkpoint,
        'ring': ring,
        'suspect': suspect,
        'metrics': metrics,
        'ledger': led.signals() if led.enabled else None,
        'live_status': self._live_status(),
        'extra': extra,
    }
    if self.profile_steps > 0:
      manifest['profile'] = self._arm_profiler()
    with open(os.path.join(out, MANIFEST), 'w') as f:
      json.dump(manifest, f, indent=2, default=str)
      f.write('\n')
    with self._lock:  # read by capture()'s cap check
      self.incident_dirs.append(out)
    get_sentinel().note_incident(out, trigger)
    return out

  def _live_status(self):
    """The monitor's window snapshot when one is serving, else a fresh
    one-sample window — best effort, None on any failure. It reads the
    allocator's host counters only (``telemetry.roofline.sample_hbm``),
    no CUDA runtime call."""
    try:
      from ..telemetry.live import SnapshotWindow, live_status
      from ..telemetry.server import get_monitor
      mon = get_monitor()
      if mon.enabled and getattr(mon, 'window', None) is not None:
        with mon.window_lock:
          return live_status(mon.window, rank=mon.rank,
                             include_metrics=False)
      return live_status(SnapshotWindow(), include_metrics=False)
    except Exception:
      return None

  def _arm_profiler(self):
    try:
      from ..telemetry.profiling import get_step_profiler
      get_step_profiler().arm(self.profile_steps)
      return {'armed_steps': self.profile_steps}
    except Exception as exc:
      return {'armed_steps': 0,
              'error': f'{type(exc).__name__}: {exc}'}


# -- module gate: the recorder rides the sentinel's LDDL_SENTINEL gate

_active = None
# Sentinel triggers and the train loop resolve lazily from several
# threads; the lock makes install atomic.
_active_lock = threading.Lock()


def get_flight_recorder():
  """The process flight recorder — live iff the sentinel is live."""
  global _active
  with _active_lock:
    if _active is None:
      _active = FlightRecorder() if get_sentinel().enabled else NOOP_FLIGHT
    return _active


def enable_flight(**kwargs):
  """Force-enable (tests): installs and returns a fresh recorder."""
  global _active
  with _active_lock:
    _active = FlightRecorder(**kwargs)
    return _active


def disable_flight():
  """Force-disable and drop the active instance (tests)."""
  global _active
  with _active_lock:
    _active = NOOP_FLIGHT


# -- incident inventory

def scan_incidents(root):
  """Every incident under ``root`` (itself an incident dir, or a tree
  of them), sorted by path: ``[{'dir', 'manifest'}, ...]``. Unreadable
  manifests surface as ``{'dir', 'error'}`` — a half-written incident
  still fails a gate."""
  out = []
  pending = [str(root)] if os.path.isdir(str(root)) else []
  while pending:
    dirpath = pending.pop()
    names = sorted(os.listdir(dirpath))
    if MANIFEST not in names:
      pending += [p for p in (os.path.join(dirpath, n) for n in names)
                  if os.path.isdir(p)]
      continue
    # An incident's bundles are not incidents: its subtree stops here.
    try:
      with open(os.path.join(dirpath, MANIFEST)) as f:
        out.append({'dir': dirpath, 'manifest': json.load(f)})
    except (OSError, ValueError) as exc:
      out.append({'dir': dirpath, 'manifest': None,
                  'error': f'{type(exc).__name__}: {exc}'})
  return sorted(out, key=lambda i: i['dir'])


def replay_bundles(incident_dir, manifest):
  """The bundles a step replay of the incident feeds, in step order:
  every ring entry from the incident's checkpoint to its ``replay_step``
  when the ring holds them all, else the suspect's alone (enough when
  the checkpoint is at the suspect's step)."""
  root = os.path.abspath(incident_dir)
  ring = {e['ordinal']: e for e in manifest.get('ring') or []}
  ckpt = manifest.get('checkpoint') or {}
  replay_step = manifest.get('replay_step')
  if ckpt.get('step') is not None and replay_step is not None:
    wanted = range(int(ckpt['step']), int(replay_step))
    if len(wanted) and all(o in ring for o in wanted):
      return [os.path.join(root, ring[o]['bundle']) for o in wanted]
  suspect = (manifest.get('suspect') or {}).get('bundle')
  return [os.path.join(root, suspect)] if suspect else []


def replay_command(incident_dir, manifest):
  """The one-command repro for an incident, as a shell string."""
  if not manifest:
    return None
  bundles = replay_bundles(incident_dir, manifest)
  if not bundles:
    return None
  ckpt = manifest.get('checkpoint') or {}
  replay_step = manifest.get('replay_step')
  if ckpt.get('dir') and replay_step is not None:
    return (f'{_REPLAY} step ' +
            ' '.join(f'--bundle {b}' for b in bundles) +
            f' --checkpoint-dir {ckpt["dir"]} --step {replay_step}')
  return f'{_INCIDENT} replay {os.path.abspath(incident_dir)}'


# -- the incident CLI

def _load_manifest(incident_dir):
  path = os.path.join(incident_dir, MANIFEST)
  if not os.path.isfile(path):
    raise FileNotFoundError(f'not an incident dir (no {MANIFEST}): '
                            f'{incident_dir}')
  with open(path) as f:
    return json.load(f)


def _default_root():
  root = os.environ.get(_ENV_DIR, '').strip()
  if root:
    return root
  base = os.environ.get('LDDL_TELEMETRY_DIR', '').strip() or '.'
  return os.path.join(base, 'incidents')


def _cmd_list(args):
  incidents = scan_incidents(args.root)
  if not incidents:
    print(f'no incidents under {args.root}')
    return 0
  for inc in incidents:
    man = inc['manifest']
    if man is None:
      print(f'{inc["dir"]}  [unreadable: {inc.get("error")}]')
      continue
    trig = man.get('trigger') or {}
    print(f'{inc["dir"]}  detector={trig.get("detector", "?")} '
          f'step={man.get("step")} '
          f'bundles={len(man.get("ring") or [])}')
  return 0


def _cmd_show(args):
  try:
    man = _load_manifest(args.incident)
  except (OSError, ValueError) as exc:
    print(f'incident: {exc}', file=sys.stderr)
    return 2
  trig = man.get('trigger') or {}
  print(f'incident:   {args.incident}')
  print(f'detector:   {trig.get("detector")}')
  print(f'step:       {man.get("step")}')
  print(f'reason:     {trig.get("reason")}')
  if trig.get('stats'):
    print(f'stats:      {json.dumps(trig["stats"], default=str)}')
  ckpt = man.get('checkpoint') or {}
  if ckpt:
    print(f'checkpoint: {ckpt.get("dir")} @ step {ckpt.get("step")}')
  print('ring:')
  for entry in man.get('ring') or []:
    mark = ' <- suspect' if entry.get('suspect') else ''
    print(f'  ord {entry["ordinal"]:>6}  '
          f'({format_coordinate(entry.get("coordinate") or {})})  '
          f'{entry.get("digest")}  {entry.get("bundle")}{mark}')
  if man.get('metrics'):
    last = man['metrics'][-1]
    print(f'last step metrics: {json.dumps(last, default=str)}')
  cmd = replay_command(args.incident, man)
  if cmd:
    print(f'replay:     {cmd}')
  return 0


def _cmd_replay(args):
  try:
    man = _load_manifest(args.incident)
    bundles = replay_bundles(args.incident, man)
    if not bundles:
      raise LookupError('incident has no suspect bundle (empty ring?)')
  except (OSError, ValueError, LookupError) as exc:
    print(f'incident: {exc}', file=sys.stderr)
    return 2
  rest = [a for a in (args.rest or []) if a != '--']
  if rest:
    # Pass through to the step replay: the bundles name the batches, the
    # caller supplies the model/checkpoint args (e.g. --checkpoint-dir
    # ... --step N --vocab-size V --device cuda).
    from ..replay.cli import main as replay_main
    argv = ['step']
    for b in bundles:
      argv += ['--bundle', b]
    return replay_main(argv + rest)
  # No passthrough: verify the suspect bundle's payload against its
  # recorded fingerprint — the fast "is the repro intact" check.
  from ..replay.bundle import read_bundle
  suspect = os.path.join(os.path.abspath(args.incident),
                         (man.get('suspect') or {}).get('bundle', ''))
  try:
    manifest, _ = read_bundle(suspect)
  except ReplayMismatch as exc:
    print(f'incident: {exc}', file=sys.stderr)
    return 1
  except (OSError, ValueError) as exc:
    print(f'incident: {exc}', file=sys.stderr)
    return 2
  print(f'bundle ok: {format_coordinate(manifest.get("coordinate") or {})} '
        f'digest={manifest.get("digest")}')
  cmd = replay_command(args.incident, man)
  if cmd:
    print(f'full step replay: {cmd}')
  return 0


def _cmd_bisect(args):
  try:
    man = _load_manifest(args.incident)
  except (OSError, ValueError) as exc:
    print(f'incident: {exc}', file=sys.stderr)
    return 2
  ckpt = man.get('checkpoint') or {}
  replay_step = man.get('replay_step') or man.get('step')
  if not ckpt.get('dir') or replay_step is None:
    print('incident: incident carries no checkpoint ref; bisect needs one '
          '(run with ckpt_every > 0)', file=sys.stderr)
    return 2
  # The ring's window, but not below the checkpoint: bisect restores at or
  # below lo (the JAX CLI takes 0 when the ring reaches further back,
  # where no checkpoint may be).
  lo = max(int(ckpt.get('step') or 0),
           int(replay_step) - max(len(man.get('ring') or []), 1))
  # The loader and model arguments pass through, --ledger among them:
  # the manifest names no ledger.
  rest = [a for a in (args.rest or []) if a != '--']
  from ..replay.cli import main as replay_main
  return replay_main(['bisect', '--checkpoint-dir', ckpt['dir'],
                      '--lo', str(lo), '--hi', str(replay_step)] + rest)


def attach_args(parser):
  sub = parser.add_subparsers(dest='cmd', required=True)
  p = sub.add_parser('list', help='inventory incidents under a root')
  p.add_argument('--root', default=_default_root(),
                 help='incident tree (default: LDDL_FLIGHT_DIR or '
                      '$LDDL_TELEMETRY_DIR/incidents)')
  p.set_defaults(fn=_cmd_list)
  p = sub.add_parser('show', help='render one incident manifest')
  p.add_argument('incident', help='incident directory')
  p.set_defaults(fn=_cmd_show)
  p = sub.add_parser(
      'replay', help='verify the suspect bundle, or pass extra args '
                     'through to the step replay over the ring\'s bundles')
  p.add_argument('incident', help='incident directory')
  p.add_argument('rest', nargs=argparse.REMAINDER,
                 help='forwarded to the replay CLI\'s step')
  p.set_defaults(fn=_cmd_replay)
  p = sub.add_parser(
      'bisect', help='pass through to the replay CLI\'s bisect over the '
                     'steps the ring covers (loader/model args and '
                     '--ledger pass through)')
  p.add_argument('incident', help='incident directory')
  p.add_argument('rest', nargs=argparse.REMAINDER,
                 help='forwarded to the replay CLI\'s bisect')
  p.set_defaults(fn=_cmd_bisect)
  return parser


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog=_INCIDENT,
      description='List, inspect, and replay flight-recorder incidents.')
  attach_args(parser)
  args = parser.parse_args(argv)
  return args.fn(args)


if __name__ == '__main__':
  sys.exit(main())
