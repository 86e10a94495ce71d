"""Streaming anomaly sentinels over signals the train loop already pays for.

A copy of :mod:`lddl_tpu.telemetry.sentinel` for the detectors whose
signals the port has. Each is a cheap online test over a scalar the step
loop already produced:

  ``nonfinite_loss``  loss is NaN/Inf
  ``loss_spike``      robust z-score of the latest loss against a
                      windowed median +- MAD baseline (the ``lddl-perf``
                      decision rule, upward only)
  ``grad_spike``      the same test over the step's grad norm; a
                      non-finite grad norm fires unconditionally
  ``data_stall``      one batch wait exceeded a wall-time budget
  ``hbm_headroom``    :func:`~lddl_tpu_torch.telemetry.roofline.sample_hbm`
                      headroom fell below a floor (probed every N steps)

The JAX package's ``serve_backlog`` (the data service) and
``ledger_divergence`` (the determinism ledger) wait for the slices that
port those subsystems; naming either in ``LDDL_SENTINEL`` raises.

``LDDL_SENTINEL`` unset gives a shared no-op singleton whose
``observe_step`` is an empty method; ``LDDL_SENTINEL=1`` enables every
detector above, a comma list a subset. Thresholds tune via the same
``LDDL_SENTINEL_*`` knobs as the JAX package (kwargs win). A trigger is a
plain dict (detector, step, reason, value, window stats); the caller
decides what to do with it. A ``raise:sentinel.trigger`` spec in
``LDDL_FAULTS`` is caught inside ``observe_step`` and converted into a
forced trigger (detector ``injected``).
"""

import math
import os
import threading
import time

from ..core import faults
from .metrics import get_telemetry
from .perf import robust_stats

_ENV = 'LDDL_SENTINEL'

#: Every detector, in the order ``LDDL_SENTINEL=1`` enables them.
DETECTORS = ('nonfinite_loss', 'loss_spike', 'grad_spike', 'data_stall',
             'hbm_headroom')


def _env_float(name, default):
  raw = os.environ.get(name, '').strip()
  try:
    return float(raw) if raw else default
  except ValueError:
    return default


def _env_int(name, default):
  raw = os.environ.get(name, '').strip()
  try:
    return int(raw) if raw else default
  except ValueError:
    return default


class NoopSentinel:
  """Shared inert sentinel: every observation is an empty method."""

  __slots__ = ()
  enabled = False
  detectors = ()
  triggers = 0

  def observe_step(self, step, loss=None, grad_norm=None, data_wait=None):
    return None


NOOP_SENTINEL = NoopSentinel()


class Sentinel:
  """Online anomaly detectors over the step loop's existing scalars.

  One instance per process; ``observe_step`` runs on the training
  thread, ``status`` wherever a caller asks. Shared mutable state is
  lock-protected, but the per-step fast path (window append +
  median/MAD over <= ``window`` floats) takes the lock only to publish a
  fire.
  """

  enabled = True

  def __init__(self, detectors=None, window=None, warmup=None,
               z_threshold=None, min_rel=None, stall_sec=None,
               headroom_min=None, cooldown=None, hbm_every=None):
    spec = detectors if detectors is not None else DETECTORS
    unknown = [d for d in spec if d not in DETECTORS]
    if unknown:
      raise ValueError(
          f'unknown sentinel detector(s) {unknown}; choose from '
          f'{list(DETECTORS)}')
    self.detectors = tuple(spec)
    self._det = frozenset(self.detectors)
    self.window = window if window is not None else _env_int(
        'LDDL_SENTINEL_WINDOW', 64)
    self.warmup = warmup if warmup is not None else _env_int(
        'LDDL_SENTINEL_WARMUP', 16)
    self.z_threshold = z_threshold if z_threshold is not None else _env_float(
        'LDDL_SENTINEL_Z', 8.0)
    self.min_rel = min_rel if min_rel is not None else _env_float(
        'LDDL_SENTINEL_MIN_REL', 0.5)
    self.stall_sec = stall_sec if stall_sec is not None else _env_float(
        'LDDL_SENTINEL_STALL_SEC', 60.0)
    self.headroom_min = (headroom_min if headroom_min is not None
                         else _env_float('LDDL_SENTINEL_HEADROOM', 0.03))
    self.cooldown = cooldown if cooldown is not None else _env_int(
        'LDDL_SENTINEL_COOLDOWN', 32)
    self.hbm_every = hbm_every if hbm_every is not None else _env_int(
        'LDDL_SENTINEL_HBM_EVERY', 32)
    self._losses = []    # bounded manually: pop(0) past self.window
    self._grads = []
    self._cooldown_until = None   # step number triggers are muted below
    self.triggers = 0
    self.last_trigger = None
    self._lock = threading.Lock()
    tele = get_telemetry()
    self._trigger_c = tele.counter('sentinel.triggers')

  # -- firing

  def _fire(self, detector, step, reason, value=None, stats=None,
            force=False):
    """Publish a trigger dict, honoring the per-step cooldown.

    ``force`` (fault-injected triggers) bypasses the cooldown so a
    drill always exercises the capture path.
    """
    with self._lock:
      if (not force and step is not None
          and self._cooldown_until is not None
          and step < self._cooldown_until):
        return None
      if step is not None:
        self._cooldown_until = step + self.cooldown
      trigger = {
          'detector': detector,
          'step': step,
          'reason': reason,
          'value': value,
          'unix_time': time.time(),
      }
      if stats:
        trigger['stats'] = stats
      self.triggers += 1
      self.last_trigger = trigger
      self._trigger_c.add(1)
      return dict(trigger)

  def _spike(self, detector, series, value, step, label):
    """Robust z-test of ``value`` against the windowed baseline —
    the lddl-perf decision rule, upward-only (a loss/grad *drop* is
    good news)."""
    if len(series) < self.warmup:
      return None
    med, mad = robust_stats(series)
    scale = max(1.4826 * mad, self.min_rel * abs(med), 1e-12)
    z = (value - med) / scale
    rel = (value - med) / abs(med) if med else 0.0
    if z > self.z_threshold and rel > self.min_rel:
      return self._fire(
          detector, step,
          f'{label} {value:.6g} spiked over window median {med:.6g} '
          f'(robust z={z:.1f}, +{100 * rel:.0f}%)',
          value=value,
          stats={'median': med, 'mad': mad, 'robust_z': round(z, 3),
                 'rel_change': round(rel, 4), 'window': len(series)})
    return None

  # -- observations

  def observe_step(self, step, loss=None, grad_norm=None, data_wait=None):
    """One training step's signals. Returns a trigger dict when a
    detector fires (at most one per call; earlier detectors win) or
    None. Never raises — a sentinel must not take down the run it
    watches."""
    step = int(step)
    try:
      faults.inject('sentinel.trigger', step=step)
    except OSError as exc:
      return self._fire('injected', step, f'fault-injected trigger: {exc}',
                        force=True)
    det = self._det
    fired = None
    if loss is not None:
      loss = float(loss)
      if not math.isfinite(loss):
        if 'nonfinite_loss' in det:
          fired = self._fire('nonfinite_loss', step,
                             f'loss is non-finite ({loss!r})', value=loss)
      else:
        if fired is None and 'loss_spike' in det:
          fired = self._spike('loss_spike', self._losses, loss, step, 'loss')
        self._losses.append(loss)
        if len(self._losses) > self.window:
          self._losses.pop(0)
    if grad_norm is not None:
      grad_norm = float(grad_norm)
      if not math.isfinite(grad_norm):
        if fired is None and 'grad_spike' in det:
          fired = self._fire('grad_spike', step,
                             f'grad norm is non-finite ({grad_norm!r})',
                             value=grad_norm)
      else:
        if fired is None and 'grad_spike' in det:
          fired = self._spike('grad_spike', self._grads, grad_norm, step,
                              'grad norm')
        self._grads.append(grad_norm)
        if len(self._grads) > self.window:
          self._grads.pop(0)
    if (fired is None and data_wait is not None and 'data_stall' in det
        and float(data_wait) >= self.stall_sec):
      fired = self._fire(
          'data_stall', step,
          f'batch wait {float(data_wait):.1f}s exceeded the '
          f'{self.stall_sec:.0f}s stall budget', value=float(data_wait))
    if (fired is None and 'hbm_headroom' in det and self.hbm_every > 0
        and step % self.hbm_every == 0):
      fired = self._check_hbm(step)
    return fired

  def _check_hbm(self, step):
    try:
      from .roofline import sample_hbm
      summary = sample_hbm()
    except Exception:
      return None  # no HBM introspection on this platform
    if not summary:
      return None
    headroom = summary.get('headroom_frac')
    if headroom is not None and headroom < self.headroom_min:
      return self._fire(
          'hbm_headroom', step,
          f'HBM headroom {100 * headroom:.1f}% below the '
          f'{100 * self.headroom_min:.1f}% floor', value=headroom,
          stats={k: summary.get(k) for k in
                 ('peak_bytes_in_use', 'bytes_limit', 'devices')
                 if summary.get(k) is not None})
    return None


# -- module gate: resolved once from the environment, no-op when unset

_active = None
# Threads and the main loop may race to the first get_sentinel(); the
# lock makes the lazy install atomic.
_active_lock = threading.Lock()


def _parse_spec(spec):
  """``LDDL_SENTINEL`` grammar → detector tuple or None (disabled)."""
  s = spec.strip().lower()
  if s in ('', '0', 'false', 'off', 'no'):
    return None
  if s in ('1', 'true', 'on', 'yes', 'all'):
    return DETECTORS
  return tuple(n.strip() for n in s.split(',') if n.strip())


def get_sentinel():
  """The process sentinel: a live :class:`Sentinel` when
  ``LDDL_SENTINEL`` is set, else the shared :data:`NOOP_SENTINEL`."""
  global _active
  with _active_lock:
    if _active is None:
      names = _parse_spec(os.environ.get(_ENV, ''))
      _active = Sentinel(detectors=names) if names else NOOP_SENTINEL
    return _active


def enable_sentinel(**kwargs):
  """Force-enable (tests): installs and returns a fresh sentinel."""
  global _active
  with _active_lock:
    _active = Sentinel(**kwargs)
    return _active


def disable_sentinel():
  """Force-disable and drop the active instance (tests)."""
  global _active
  with _active_lock:
    _active = NOOP_SENTINEL
