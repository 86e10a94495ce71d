"""Deterministic, env-gated fault injection for the robustness tests.

A copy of :mod:`lddl_tpu.core.faults` (stdlib only). The train loop's
recovery paths (the emergency checkpoint behind a preemption, the async
checkpoint writer's first-error-wins surfacing) exist to survive faults
that are miserable to reproduce organically; this module turns each into
a one-line env spec so the tests exercise the exact recovery branch.

Spec grammar (env ``LDDL_FAULTS``; ``;``-separated, each fires
independently)::

  <action>:<site>[:k=v,...]

  actions:  kill    SIGKILL the current process (no cleanup, no atexit)
            term    SIGTERM the current process (handlers run — the
                    graceful-preemption drill the train loop's
                    emergency-checkpoint hook is tested with)
            raise   raise OSError('injected fault ...')
            delay   sleep ``sec`` seconds (default 0.1)
            corrupt flip one byte of a buffer the site hands in (only
                    through :func:`corrupt_bytes`: the determinism
                    ledger's silent-data-corruption drill)
  filters:  rank=R  only when the caller passes rank=R
            gi=N    only when the caller passes gi=N
            nth=K   only on the K-th matching hit in this process (1-based)
            once    at most once per ``LDDL_FAULTS_DIR`` marker — survives
                    process restarts, so a killed-then-restarted run does
                    not re-trip the same fault (the resume tests need
                    exactly this)
  extras:   sec=S   delay duration
            at=B    corrupt: the byte to flip (default 0, modulo the
                    buffer's length)

The port instruments ``elastic.task`` (the elastic executor's task
entry, in the process that runs the task, ``gi`` and ``rank``
filterable: a ``kill`` models a rank or worker dying mid-phase),
``pool.task`` (a pool worker's task entry, ``gi`` filterable),
``train.step`` (train-loop step entry, after the
batch is pulled: a ``kill`` models a process dying mid-training, a
``term`` the preemption notice), ``train.ckpt`` (checkpoint write entry;
it fires on the background writer thread under ``LDDL_ASYNC_CKPT``, so
raise-specs exercise the first-error-wins surfacing),
``sentinel.trigger`` (caught by the sentinel and turned into a forced
trigger), ``ledger.corrupt`` (the loaders' ``collate`` boundary: the
batch's first array, just before it is fingerprinted), ``replay.read``
(:func:`corrupt_bytes` on a repro bundle's packed payload as the replay
loads it: a damaged bundle is refused with the mismatch named at its
coordinate), ``replay.step`` (step replay, before each re-executed step)
and ``flight.dump`` (the flight recorder's incident capture: a raise-spec
kills the dump at entry and training goes on, a corrupt-spec flips a byte
of one bundle payload mid-dump so the replay reader refuses it).
``inject()`` and
``corrupt_bytes()`` are no-ops (one env read) when ``LDDL_FAULTS`` is
unset.
"""

import os
import re
import signal
import time

# Per-process hit counters keyed by full spec text: ``nth`` is a count of
# *matching* invocations in this process, deterministic because every
# instrumented site sits on a deterministic execution path.
_counts = {}


def reset():
  """Forget per-process hit counts (test isolation)."""
  _counts.clear()


def _once_marker(spec):
  name = 'fired.' + re.sub(r'[^A-Za-z0-9]+', '_', spec)
  return os.path.join(os.environ.get('LDDL_FAULTS_DIR', ''), name)


def _fire(action, site, opts):
  if action == 'kill':
    os.kill(os.getpid(), signal.SIGKILL)
  if action == 'term':
    # Delivered to this process's own handlers (unlike 'kill'): the
    # preemption drill — the signal lands synchronously on the main
    # thread's next bytecode boundary, so a loop checking its guard
    # right after this call already sees the flag.
    os.kill(os.getpid(), signal.SIGTERM)
    return
  if action == 'raise':
    raise OSError(f'injected fault at {site}')
  if action == 'delay':
    time.sleep(float(opts.get('sec', '0.1')))
    return
  raise ValueError(f'unknown fault action {action!r}')


def _match(spec, site, ctx):
  """Parse ``spec`` and apply its site + filter gates against this
  invocation; returns ``(action, opts)`` when the fault should fire,
  else None. Counts and once-markers are claimed here."""
  fields = spec.split(':')
  if len(fields) < 2 or fields[1] != site:
    return None
  action = fields[0]
  opts = {}
  for kv in (fields[2].split(',') if len(fields) > 2 else ()):
    k, _, v = kv.partition('=')
    opts[k] = v
  for key in ('rank', 'gi'):
    if key in opts and str(ctx.get(key)) != opts[key]:
      return None
  _counts[spec] = _counts.get(spec, 0) + 1
  if 'nth' in opts and _counts[spec] != int(opts['nth']):
    return None
  if 'once' in opts:
    marker = _once_marker(spec)
    if not os.environ.get('LDDL_FAULTS_DIR'):
      raise ValueError("'once' fault filter needs LDDL_FAULTS_DIR")
    try:
      # O_EXCL create is the atomic claim: exactly one process across
      # the fault's whole lifetime (restarts included) wins the fire.
      fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
      os.close(fd)
    except FileExistsError:
      return None
  return action, opts


def inject(site, **ctx):
  """Fire any configured fault matching ``site`` + ``ctx`` filters.

  Call at the top of a recoverable operation, passing whatever identity
  the filters should see (``gi=``, ``rank=``). No-op when ``LDDL_FAULTS``
  is unset. ``corrupt`` specs are ignored here: they fire only through
  :func:`corrupt_bytes`, which has the buffer to damage.
  """
  specs = os.environ.get('LDDL_FAULTS', '')
  if not specs:
    return
  for spec in specs.split(';'):
    spec = spec.strip()
    if not spec or spec.startswith('corrupt:'):
      continue
    hit = _match(spec, site, ctx)
    if hit is not None:
      _fire(hit[0], site, hit[1])


def corrupt_bytes(site, buf, **ctx):
  """Flip one byte of ``buf`` when a ``corrupt:<site>`` spec matches:
  the silent-data-corruption drill for the determinism ledger.

  ``buf`` is any writable buffer-protocol object (a shm slot window, an
  ndarray's ``.data``); byte ``at`` (default 0, modulo the buffer
  length) is XORed with 0xFF. Same filters as :func:`inject`
  (``rank=``/``gi=``/``nth=``/``once``), same no-op-when-unset cost.
  Returns True when the buffer was damaged.
  """
  specs = os.environ.get('LDDL_FAULTS', '')
  if not specs:
    return False
  hit = False
  for spec in specs.split(';'):
    spec = spec.strip()
    if not spec or not spec.startswith('corrupt:'):
      continue
    m = _match(spec, site, ctx)
    if m is None:
      continue
    mv = memoryview(buf).cast('B')
    if len(mv):
      i = int(m[1].get('at', '0')) % len(mv)
      mv[i] ^= 0xFF
      hit = True
  return hit
