"""A loader-protocol stand-in for transport tests and benches.

A copy of :class:`lddl_tpu.testing.SyntheticBatchLoader` (numpy only; the
port keeps its own copy and imports nothing of :mod:`lddl_tpu`): the
batches it yields are byte-identical to the reference's, so either
package's data server can serve it (``--synthetic``) to either package's
client. Below it, the sources of the committed shard sets, and copies of
``lddl_tpu.testing``'s word-salad corpus and vocab, its Parquet hash and
its data-parallel drain accounting.
"""

import os


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


def write_wikiextractor_source(extract_dir, seed, target_bytes,
                               docs_per_file=64):
  """core/synth articles of about ``target_bytes`` from ``seed`` in
  wikiextractor's output format, the input of ``download_wikipedia
  --no-download --no-extract``: ``extract_dir/AA/wiki_NN`` files of
  ``<doc id=... url=... title=...>`` blocks, each a title line, a blank
  line and the body on two lines. Returns the number of articles."""
  import os
  docs = synth_docs(seed, target_bytes)
  d = os.path.join(extract_dir, 'AA')
  os.makedirs(d)
  for f in range(0, len(docs), docs_per_file):
    with open(os.path.join(d, f'wiki_{f // docs_per_file:02d}'), 'w',
              encoding='utf-8') as out:
      for i, doc in enumerate(docs[f:f + docs_per_file], f):
        body = doc.replace('. ', '.\n', 1)
        out.write(f'<doc id="{i}" url="https://en.wikipedia.org/wiki?'
                  f'curid={i}" title="Article {i}">\nArticle {i}\n\n'
                  f'{body}\n</doc>\n')
  return len(docs)


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


# The word-salad corpus, the Parquet hash and the data-parallel drain
# accounting of lddl_tpu.testing, copied (stdlib and the port only).

WORDS = ('alpha', 'bravo', 'charlie', 'delta', 'echo', 'foxtrot', 'golf',
         'hotel', 'india', 'juliet', 'kilo', 'lima', 'mike', 'november')


def write_word_vocab(path, pad_multiple=1):
  """A minimal WordPiece vocab covering :data:`WORDS`; returns its size.
  ``pad_multiple``: ``[unusedN]`` entries are appended until the size
  divides it (vocab-sized parameters split evenly over a tensor axis)."""
  tokens = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]', '.', ',']
  tokens += list(WORDS) + ['##' + w[1:] for w in WORDS]
  while len(tokens) % pad_multiple:
    tokens.append(f'[unused{len(tokens)}]')
  with open(path, 'w') as f:
    f.write('\n'.join(tokens) + '\n')
  return len(tokens)


def write_word_corpus(src, num_docs=160, num_shards=1, seed=1234,
                      sents_range=(2, 6), words_range=(4, 10)):
  """A one-document-per-line corpus of :data:`WORDS` salad under ``src``
  (created), round-robin across ``num_shards`` files; the same seed
  writes lddl_tpu.testing's bytes."""
  import random
  os.makedirs(src)
  r = random.Random(seed)
  docs = []
  for d in range(num_docs):
    sents = [
        (' '.join(r.choice(WORDS)
                  for _ in range(r.randrange(*words_range))) + '.').capitalize()
        for _ in range(r.randrange(*sents_range))
    ]
    docs.append(f'doc-{d} ' + ' '.join(sents))
  for shard in range(num_shards):
    with open(os.path.join(src, f'{shard}.txt'), 'w') as f:
      for line in docs[shard::num_shards]:
        f.write(line + '\n')


def hash_parquets(directory):
  """``{basename: sha256}`` of every Parquet shard under ``directory``:
  the file bytes, read without a Parquet library."""
  import hashlib

  from .core.utils import get_all_parquets_under
  out = {}
  for p in get_all_parquets_under(directory):
    with open(p, 'rb') as f:
      out[os.path.basename(p)] = hashlib.sha256(f.read()).hexdigest()
  return out


def _read_rows(path):
  from .pipeline.parquet_io import ParquetFile
  with ParquetFile(path) as f:
    return f.read().to_pylist()


def _sample_key(row, with_positions):
  """The identity of one raw sample, shared by the drain and the on-disk
  scan. The stored mask positions are part of it by default (word-salad
  pairs can collide on text alone); a delta row's copy index too (its
  copies share its text)."""
  key = (row['A'], row['B'], bool(row['is_random_next']))
  if with_positions and 'masked_lm_positions' in row:
    key += (bytes(row['masked_lm_positions']),)
  if 'mask_delta_positions' in row:
    key += (int(row['mask_delta_copy']),)
    if with_positions:
      key += (bytes(row['mask_delta_positions']),)
  return key


def drain_rank_keys(balanced_dir, rank, world, bin_size, base_seed,
                    with_positions=True):
  """Drain one data rank's epoch of raw rows; returns their keys."""
  from .comm import NullBackend
  from .loader.bert import get_bert_pretrain_data_loader
  loader = get_bert_pretrain_data_loader(
      balanced_dir, dp_rank=rank, dp_world_size=world,
      batch_size_per_rank=1, bin_size=bin_size, base_seed=base_seed,
      comm=NullBackend(), return_raw_samples=True)
  return [_sample_key(row, with_positions)
          for rows in loader for row in rows]


def expected_min_truncated_rows(balanced_dir):
  """The samples a full data-parallel drain yields: per bin, the files'
  smallest row count times the number of files, times ``dup`` for delta
  shards (a delta row is ``dup`` samples)."""
  from .core.utils import (get_all_bin_ids, get_all_parquets_under,
                           get_file_paths_for_bin_id)
  from .pipeline.parquet_io import ParquetFile
  from .pipeline.shard_format import DELTA, scan_shard_format
  paths = get_all_parquets_under(balanced_dir)
  fmt, dup = scan_shard_format(paths)
  expansion = dup if fmt == DELTA else 1
  expected = 0
  for b in get_all_bin_ids(paths):
    counts = []
    for p in get_file_paths_for_bin_id(paths, b):
      with ParquetFile(p) as f:
        counts.append(f.metadata.num_rows)
    expected += min(counts) * len(counts) * expansion
  return expected


def check_dp_drains(balanced_dir, world, bin_size, base_seed,
                    drained_keys=None, with_positions=True):
  """Assert the data ranks' drains are pairwise disjoint, hold exactly
  :func:`expected_min_truncated_rows` samples, and are rows on disk.
  ``drained_keys``: per-rank key lists (drained here when omitted).
  Returns the number of drained rows."""
  from .core.utils import get_all_parquets_under
  from .pipeline.shard_format import DELTA, scan_shard_format
  if drained_keys is None:
    drained_keys = [
        drain_rank_keys(balanced_dir, r, world, bin_size, base_seed,
                        with_positions=with_positions)
        for r in range(world)]
  all_keys = [k for keys in drained_keys for k in keys]
  assert len(set(all_keys)) == len(all_keys), \
      'dp ranks drained overlapping rows'
  expected = expected_min_truncated_rows(balanced_dir)
  assert len(all_keys) == expected, (len(all_keys), expected)
  paths = get_all_parquets_under(balanced_dir)
  fmt, dup = scan_shard_format(paths)
  on_disk = set()
  for p in paths:
    for row in _read_rows(p):
      if fmt == DELTA:
        for c in range(dup):
          on_disk.add(_sample_key(dict(row, mask_delta_copy=c),
                                  with_positions))
      else:
        on_disk.add(_sample_key(row, with_positions))
  assert set(all_keys) <= on_disk
  return len(all_keys)
