"""The read side of the load balancer's sample-count cache.

Copied from :mod:`lddl_tpu.balance` (``NUM_SAMPLES_CACHE`` and
``load_num_samples_cache``, ``lddl_tpu/balance.py:52,216-222``). Balancing
shards (writing them) stays with :mod:`lddl_tpu` on a host that has
pyarrow; the port only reads what the balancer wrote.
"""

import json
import os

NUM_SAMPLES_CACHE = '.num_samples.json'


def load_num_samples_cache(path):
  """Read ``.num_samples.json`` if present; returns None otherwise."""
  cache = os.path.join(path, NUM_SAMPLES_CACHE)
  if not os.path.isfile(cache):
    return None
  with open(cache) as f:
    return json.load(f)
