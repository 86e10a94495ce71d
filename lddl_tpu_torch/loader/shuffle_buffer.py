"""Streaming reservoir-style shuffle buffer.

Copied verbatim from :mod:`lddl_tpu.loader.shuffle_buffer` (reference
``lddl/torch/datasets.py:46-109``). Samples are pushed in stream order;
while the buffer is filling, one random resident sample is popped every
``warmup_factor`` pushes; once full, each new sample evicts and yields a
random resident one. The final drain is shuffled.

Every draw comes from the caller's ``random.Random`` and depends only on
stream position, never on sample contents, so a given (seed, stream
order) yields the same shuffled stream as the JAX package's loader.
"""


class ShuffleBuffer:

  def __init__(self, size, warmup_factor, rng):
    """``size``: resident capacity; ``warmup_factor``: pushes per pop during
    warmup; ``rng``: a ``random.Random``."""
    self._size = max(1, size)
    self._warmup_factor = max(1, warmup_factor)
    self._rng = rng

  def shuffle_stream(self, stream):
    """Yield the samples of ``stream`` in shuffled order (a generator)."""
    buf = []
    n_pushed = 0
    for sample in stream:
      if len(buf) < self._size:
        buf.append(sample)
        n_pushed += 1
        if n_pushed % self._warmup_factor == 0 and len(buf) > 1:
          yield self._pop_random(buf)
      else:
        i = self._rng.randrange(len(buf))
        out, buf[i] = buf[i], sample
        yield out
    self._rng.shuffle(buf)
    yield from buf

  def _pop_random(self, buf):
    i = self._rng.randrange(len(buf))
    out = buf[i]
    buf[i] = buf[-1]
    buf.pop()
    return out
