"""A loader-protocol stand-in for transport tests and benches.

A copy of :class:`lddl_tpu.testing.SyntheticBatchLoader` (numpy only; the
port keeps its own copy and imports nothing of :mod:`lddl_tpu`): the
batches it yields are byte-identical to the reference's, so either
package's data server can serve it (``--synthetic``) to either package's
client.
"""


class SyntheticBatchLoader:
  """A loader-protocol stand-in that replays one precollated batch.

  Implements exactly the surface :class:`~lddl_tpu_torch.loader.workers.
  MultiprocessLoader` drives (``iter_steps``, ``seek``/``tell``,
  ``epoch``, ``__len__``, ``samples_per_epoch``, ``batch_size``) with a
  near-zero production cost, so transport
  microbenchmarks and tests measure the worker→parent handoff itself
  rather than collate throughput.
  """

  def __init__(self, batch_size=64, seq_len=512, steps=256, comm=None,
               **_ignored):
    import numpy as np
    self._steps = int(steps)
    self._batch_size = int(batch_size)
    rng = np.random.Generator(np.random.Philox(key=[7, 9]))
    shape = (int(batch_size), int(seq_len))
    self._batch = {
        'input_ids': rng.integers(0, 30000, shape).astype(np.int32),
        'token_type_ids': np.zeros(shape, np.int32),
        'attention_mask': np.ones(shape, np.int32),
        'labels': np.full(shape, -100, np.int32),
        'next_sentence_labels': np.zeros(int(batch_size), np.int32),
    }
    self.epoch = 0
    self._batches_consumed = 0

  def __len__(self):
    return self._steps - self._batches_consumed

  @property
  def batch_size(self):
    return self._batch_size

  @property
  def batches_per_epoch(self):
    return self._steps

  def seek(self, epoch, batch_index, exact=False):
    """Public positioning contract (see
    :meth:`lddl_tpu_torch.loader.bert.BertPretrainLoader.seek`). Every
    seek is byte-exact here (a batch is a function of its step), so
    ``exact`` changes nothing."""
    epoch, batch_index = int(epoch), int(batch_index)
    if epoch < 0 or batch_index < 0:
      raise ValueError(f'seek({epoch}, {batch_index}): coordinates must '
                       'be non-negative')
    if batch_index > self._steps:  # == steps: epoch drained
      raise ValueError(f'seek({epoch}, {batch_index}): epoch has only '
                       f'{self._steps} batches')
    self.epoch = epoch
    self._batches_consumed = batch_index
    return self

  def tell(self):
    return self.epoch, self._batches_consumed

  def coordinate_of_batch(self, ordinal):
    return ordinal // self._steps, ordinal % self._steps

  @property
  def samples_per_epoch(self):
    return self._steps * self._batch_size

  def iter_steps(self, step_shard=(0, 1)):
    import numpy as np
    w, num_shards = step_shard
    first = self._batches_consumed
    self._batches_consumed = 0
    for step in range(first, self._steps):
      if step % num_shards != w:
        continue
      # Stamp the step into the batch so byte-identity checks catch
      # reordering / slot-recycling bugs, not just transport liveness.
      batch = dict(self._batch)
      ids = batch['input_ids'].copy()
      ids[:, 0] = np.int32(step)
      batch['input_ids'] = ids
      yield step, batch
    self.epoch += 1

  def __iter__(self):
    for _, batch in self.iter_steps():
      yield batch


def get_synthetic_batch_loader(**kwargs):
  """Factory entry point for worker processes (importable by module
  path, the :data:`~lddl_tpu_torch.loader.workers.DEFAULT_FACTORY` shape)."""
  return SyntheticBatchLoader(**kwargs)


# The source corpora of the committed shard sets (tests/assets/torch_shards,
# written by lddl_tpu through tests/make_torch_shards.py): the same recipes
# over the port's copy of core/synth, so a machine without lddl_tpu remakes
# each set's source from its digests.json ``corpus_seed`` and checks that
# the port's preprocessor writes lddl_tpu's shards.

#: Per set: the port's preprocessor CLI flags that make it from its source
#: (besides ``--source``, ``--sink``, ``--seed`` and ``--vocab-file``) and
#: the balancer's ``--num-shards``: tests/make_torch_shards.py's settings.
SHARD_SETS = {
    'packed': (['--target-seq-length', '8192', '--num-blocks', '1',
                '--sample-ratio', '1.0', '--sentence-backend', 'rules'], 2),
    'codebert': (['--target-seq-length', '512', '--bin-size', '128',
                  '--num-blocks', '2', '--lowercase'], 2),
    'bart': (['--target-seq-length', '128', '--num-blocks', '2',
              '--sample-ratio', '1.0', '--sentence-backend', 'rules'], 2),
}


def shard_set_argv(name, src, sink, seed, vocab_file):
  """The preprocessor CLI's arguments that make set ``name``'s sink."""
  argv = ['--source', src, '--sink', sink, '--seed', str(seed),
          *SHARD_SETS[name][0]]
  return argv + (['--vocab-file', vocab_file] if name != 'bart' else [])


def synth_docs(seed, target_bytes):
  """core/synth documents of about ``target_bytes`` from ``seed``."""
  from .core import synth
  words, probs = synth.build_word_population()
  return list(synth.generate_documents(words, probs, target_bytes,
                                       seed=seed))


def write_doc_source(src, docs):
  """One-document-per-line source: ``src/0.txt``, ``synth-<i> <doc>``."""
  import os
  os.makedirs(src)
  with open(os.path.join(src, '0.txt'), 'w', encoding='utf-8') as f:
    for i, doc in enumerate(docs):
      f.write(f'synth-{i} {doc}\n')


def write_packed_source(src, seed, vocab_file, doc_tokens=(500, 680),
                        rows=24, docs=(12, 16), draw_bytes=1 << 20):
  """The packed set's source: synth documents of ``doc_tokens`` tokens
  (the vocab's WordPiece count), drawn ``draw_bytes`` at a time from
  seeds 10000 + seed, 10001 + seed, ... until there are enough for
  ``rows`` rows of ``docs`` documents."""
  import numpy as np

  from .tokenization.wordpiece import load_bert_tokenizer
  tok = load_bert_tokenizer(vocab_file)
  lo, hi = doc_tokens
  kept = []
  draw = seed
  while len(kept) < rows * sum(docs) // 2 + 16:
    batch = synth_docs(10_000 + draw, draw_bytes)
    draw += 1
    n = np.diff(tok.encode_batch_ids(batch)[1])
    kept += [d for d, k in zip(batch, n) if lo <= k <= hi]
  write_doc_source(src, kept)


def write_codebert_source(src, seed, target_bytes=320 << 10):
  """The CodeBERT set's source: ``id<CODESPLIT>docstring<CODESPLIT>code``
  records (CRLF-delimited) made of synth documents from seed 20000 +
  seed: a document's first sentence is its docstring (none for every
  fourth), its other sentences its code lines."""
  import os
  os.makedirs(src)
  with open(os.path.join(src, '0.txt'), 'w', encoding='utf-8',
            newline='') as f:
    for i, doc in enumerate(synth_docs(20_000 + seed, target_bytes)):
      lines = [x.strip() for x in doc.split('. ') if x.strip()]
      if len(lines) < 2:
        continue
      docstring = '' if i % 4 == 3 else lines[0]
      code = '\n'.join(lines[1:])
      f.write(f'synth-{i}<CODESPLIT>{docstring}<CODESPLIT>{code}\r\n')


def write_bart_source(src, seed, target_bytes=480 << 10):
  """The BART set's source: synth documents from seed 30000 + seed."""
  write_doc_source(src, synth_docs(30_000 + seed, target_bytes))


def write_set_source(name, src, seed, vocab_file):
  """Set ``name``'s source (its recipe above) under ``src``."""
  if name == 'packed':
    write_packed_source(src, seed, vocab_file)
  elif name == 'codebert':
    write_codebert_source(src, seed)
  elif name == 'bart':
    write_bart_source(src, seed)
  else:
    raise ValueError(f'no source recipe for shard set {name!r}')
