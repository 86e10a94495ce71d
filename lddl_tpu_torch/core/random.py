"""Resumable, explicitly-stated RNG primitives of the loader.

Copied from :mod:`lddl_tpu.core.random` (stdlib ``random`` only): every
rank evolves the same world RNG state, so shard permutations, bin draws
and shuffle-buffer replacements agree across ranks and across resumes
with no communication, and agree with the JAX package's loader draw for
draw. The preprocessor's shuffle draws through the same state-threading
helpers (``randrange_batch``, ``shuffle``), so its partitions hold the
JAX package's lines in the JAX package's order.
"""

import random as _py_random


def rng_from_key(*parts):
  """An independent ``random.Random`` seeded from a structured key, e.g.
  ``rng_from_key(seed, 'perm', epoch)``. String seeding hashes with
  sha512, so it is stable across processes and Python versions."""
  return _py_random.Random(':'.join(str(p) for p in parts))


def _swap_rng_state(new_state):
  # Fails loudly (TypeError) on None: callers must thread an explicit
  # state; silently reusing the global state would break determinism.
  old_state = _py_random.getstate()
  _py_random.setstate(new_state)
  return old_state


def get_state(seed):
  """A fresh Mersenne state initialized from ``seed``."""
  orig = _py_random.getstate()
  _py_random.seed(seed)
  state = _py_random.getstate()
  _py_random.setstate(orig)
  return state


def randrange(stop, rng_state=None):
  orig_rng_state = _swap_rng_state(rng_state)
  n = _py_random.randrange(stop)
  return n, _swap_rng_state(orig_rng_state)


def randrange_batch(stop, k, rng_state=None):
  """``k`` successive ``randrange(stop)`` draws with a single state swap
  (draw for draw the same as ``k`` :func:`randrange` calls)."""
  orig_rng_state = _swap_rng_state(rng_state)
  draw = _py_random.randrange
  ns = [draw(stop) for _ in range(k)]
  return ns, _swap_rng_state(orig_rng_state)


def random(rng_state=None):
  orig_rng_state = _swap_rng_state(rng_state)
  x = _py_random.random()
  return x, _swap_rng_state(orig_rng_state)


def shuffle(x, rng_state=None):
  orig_rng_state = _swap_rng_state(rng_state)
  _py_random.shuffle(x)
  return _swap_rng_state(orig_rng_state)


def sample(population, k, rng_state=None):
  orig_rng_state = _swap_rng_state(rng_state)
  s = _py_random.sample(population, k)
  return s, _swap_rng_state(orig_rng_state)


def choices(population, weights=None, cum_weights=None, k=1, rng_state=None):
  """``random.choices`` drawn from ``rng_state``; returns the draw and the
  advanced state."""
  orig_rng_state = _swap_rng_state(rng_state)
  c = _py_random.choices(population, weights=weights, cum_weights=cum_weights,
                         k=k)
  return c, _swap_rng_state(orig_rng_state)
