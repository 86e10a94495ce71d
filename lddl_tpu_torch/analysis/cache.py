"""Incremental analysis cache (``LDDL_ANALYZE_CACHE``), the port's copy
of :mod:`lddl_tpu.analysis.cache`.

Analysis is a pure function of file content: the same source bytes
produce the same findings and the same per-module facts every time (the
whole suite is built around byte-identical output). That makes both
layers cacheable by content hash alone:

  - **findings** — per file, keyed by source + ruleset fingerprint, so a
    warm ``lddl-analyze`` run skips parsing and rule execution for every
    unchanged file;
  - **facts** — per module
    (:class:`~lddl_tpu_torch.analysis.engine.ModuleFacts` pickles), so
    project mode's ``ProjectIndex.build`` skips re-parsing unchanged
    files even though the cross-file rules still run (linking is cheap;
    parsing is the 90%).

The cache is enabled by pointing ``LDDL_ANALYZE_CACHE`` at a directory
(created on demand) and bypassed by ``--no-cache``. Keys bake in the
schema constant below, the absolute *and* as-given path (findings embed
paths verbatim), and the ruleset fingerprint; custom (non-registry) rule
instances have no stable fingerprint and always bypass the cache.
``CACHE_SCHEMA`` must be bumped whenever rule logic or the facts layer
changes shape — content hashes cannot see code changes.

The keys also carry :data:`NAMESPACE`, the port's own: ``lddl_tpu``'s
analyzer honours the same variable, and a directory both analyzers share
must never serve one package's pickles to the other (unpickling the
reference's ``ModuleFacts`` would import ``lddl_tpu``; the port's rules
also read facts the reference's never record). The two key spaces are
disjoint, so each analyzer only ever loads what it stored.

Entries are written atomically (tempfile + ``os.replace``) so concurrent
analyzer runs sharing one cache directory never read torn pickles; any
unreadable entry is treated as a miss.
"""

import hashlib
import os
import pickle
import tempfile

# Bump when rule logic, the facts dataclasses, or the finding model
# change: cached entries from older code are silently wrong otherwise.
CACHE_SCHEMA = 1

# Hashed into every key: the port's entries and lddl_tpu's never collide.
NAMESPACE = 'lddl_tpu_torch.analysis'


def cache_root(no_cache=False):
  """The cache directory from the environment, or '' when disabled."""
  if no_cache:
    return ''
  return os.environ.get('LDDL_ANALYZE_CACHE', '')


def cache_from_env(no_cache=False):
  """An :class:`AnalysisCache` per ``LDDL_ANALYZE_CACHE``, else None."""
  root = cache_root(no_cache=no_cache)
  if not root:
    return None
  try:
    return AnalysisCache(root)
  except OSError:
    return None  # unusable cache dir: run uncached rather than fail


class AnalysisCache:
  """Content-addressed pickle store for per-file findings and facts."""

  def __init__(self, root):
    self.root = root
    os.makedirs(root, exist_ok=True)

  def _key(self, kind, path, source, extra=''):
    h = hashlib.blake2b(digest_size=20)
    for part in (NAMESPACE, str(CACHE_SCHEMA), kind,
                 os.path.abspath(path), path, extra, source):
      h.update(part.encode('utf-8', 'replace'))
      h.update(b'\x00')
    return h.hexdigest()

  def _path_for(self, kind, path, source, extra=''):
    return os.path.join(self.root,
                        f'{self._key(kind, path, source, extra)}.pkl')

  def load(self, kind, path, source, extra=''):
    """The cached value, or None on any miss/corruption (a bad entry is
    a miss, never an error — the analyzer just recomputes)."""
    try:
      with open(self._path_for(kind, path, source, extra), 'rb') as fh:
        return pickle.load(fh)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
            ImportError, IndexError, ValueError):
      return None

  def store(self, kind, path, source, value, extra=''):
    """Atomically persist ``value``; storage failures are silent (the
    cache is an accelerator, not a dependency)."""
    target = self._path_for(kind, path, source, extra)
    try:
      fd, tmp = tempfile.mkstemp(dir=self.root, suffix='.tmp')
      try:
        with os.fdopen(fd, 'wb') as fh:
          pickle.dump(value, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, target)
      except BaseException:
        try:
          os.unlink(tmp)
        except OSError:
          pass
        raise
    except (OSError, pickle.PicklingError):
      pass
