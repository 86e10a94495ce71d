"""Shared downloader helpers: the port's :mod:`lddl_tpu.download.utils`.

``download_file``: streaming HTTP download with a progress meter
(reference ``lddl/download/utils.py:30-39``; ``requests`` imported at the
call). ``shard_documents``: write
an iterator of (doc_id, one_line_text) into N round-robin ``.txt`` shards
— the common final step of every downloader (reference per-corpus
variants: ``wikipedia.py:48-85``, ``books.py:163-187``,
``openwebtext.py:106-167``).
"""

import os


def download_file(url, path, chunk_size=16 * 1024 * 1024, quiet=False):
  """Stream ``url`` to ``path`` (skips if already fully present)."""
  import requests
  if os.path.isfile(path):
    head = requests.head(url, allow_redirects=True, timeout=60)
    size = int(head.headers.get('content-length', -1))
    if size == os.path.getsize(path):
      if not quiet:
        print(f'{path} already downloaded')
      return path
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  tmp = path + '.tmp'
  with requests.get(url, stream=True, timeout=60) as r:
    r.raise_for_status()
    total = int(r.headers.get('content-length', 0))
    done = 0
    with open(tmp, 'wb') as f:
      for chunk in r.iter_content(chunk_size=chunk_size):
        f.write(chunk)
        done += len(chunk)
        if not quiet and total:
          print(f'\r{path}: {done / 1e6:.0f}/{total / 1e6:.0f} MB', end='')
  if not quiet:
    print()
  os.replace(tmp, path)
  return path


def _sanitize_one_line(text):
  """Flatten a document to a single line (the one-doc-per-line contract)."""
  return ' '.join(text.split())


def _write_doc_line(f, doc_id, text):
  """Write one document under the one-doc-per-line contract; returns
  whether anything was written (empty docs are dropped). The single copy
  of the contract — every sharding path goes through here."""
  line = _sanitize_one_line(text)
  if not line:
    return False
  f.write(f'{doc_id} {line}\n')
  return True


def shard_documents(docs, outdir, num_shards):
  """Round-robin (doc_id, text) documents into ``num_shards`` txt shards.

  Returns per-shard document counts. Documents are flattened to one line;
  empties are dropped.
  """
  os.makedirs(outdir, exist_ok=True)
  counts = [0] * num_shards
  files = []
  try:
    files.extend(
        open(os.path.join(outdir, f'{i}.txt'), 'w', encoding='utf-8')
        for i in range(num_shards))
    i = 0
    for doc_id, text in docs:
      if _write_doc_line(files[i % num_shards], doc_id, text):
        counts[i % num_shards] += 1
        i += 1
  finally:
    for f in files:
      f.close()
  return counts


def _scatter_worker(task):
  """Phase A: parse one input file, round-robin its docs into per-(file,
  shard) spill files. Returns per-shard counts for this file."""
  file_idx, path, num_shards, spill_dir, parse_fn = task
  counts = [0] * num_shards
  writers = {}
  try:
    k = 0
    for doc_id, text in parse_fn(path):
      # Stagger each file's starting shard so short files don't all pile
      # onto the low shard indices.
      j = (file_idx + k) % num_shards
      f = writers.get(j)
      if f is None:
        writers[j] = f = open(
            os.path.join(spill_dir, f'shard{j}.src{file_idx}'), 'w',
            encoding='utf-8')
      if _write_doc_line(f, doc_id, text):
        counts[j] += 1
        k += 1
  finally:
    for f in writers.values():
      f.close()
  return file_idx, counts


def _concat_worker(task):
  """Phase B: concatenate one shard's spill files (sorted source order)."""
  shard_idx, spill_paths, out_path = task
  tmp = out_path + '.tmp'
  with open(tmp, 'wb') as out:
    for p in spill_paths:
      with open(p, 'rb') as f:
        while True:
          chunk = f.read(1 << 22)
          if not chunk:
            break
          out.write(chunk)
  os.replace(tmp, out_path)
  return shard_idx


def _run_pool(worker, tasks, num_workers):
  """map ``worker`` over ``tasks``, in-process when num_workers <= 1 else
  over a pool of forkserver processes (never a fork of a parent that may
  hold a CUDA context; ``lddl_tpu`` forks where jax is not loaded);
  yields results."""
  if num_workers <= 1 or len(tasks) <= 1:
    yield from map(worker, tasks)
    return
  from ..loader.workers import worker_context
  ctx = worker_context(__name__)
  pool = ctx.Pool(min(num_workers, len(tasks)))
  try:
    yield from pool.imap_unordered(worker, tasks)
    pool.close()
    pool.join()
  except BaseException:
    pool.terminate()
    raise


def shard_text_files_parallel(input_paths, outdir, num_shards, parse_fn,
                              num_workers=None):
  """Parallel shard preparation with document-level balance.

  The reference parallelizes shard prep with a ``multiprocessing.Pool``
  and a 1:1 input-file -> output-shard mapping
  (``lddl/download/wikipedia.py:84-85``, ``common_crawl.py:425-426``) —
  which couples shard count and balance to the input file layout. Here
  prep is a two-phase scatter/concat: workers parse input files in
  parallel, round-robining each file's documents into per-(file, shard)
  spill files, then workers concatenate each shard's spills in sorted
  source order. Shard contents are a pure function of the sorted input
  paths — independent of worker count — and documents spread evenly over
  all ``num_shards`` even when there are fewer input files than shards.
  ``parse_fn(path)`` must be a picklable top-level function yielding
  ``(doc_id, text)``. Returns per-shard document counts.
  """
  import shutil
  import tempfile

  os.makedirs(outdir, exist_ok=True)
  input_paths = sorted(input_paths)
  if num_workers is None:
    num_workers = max(1, os.cpu_count() or 1)
  counts = [0] * num_shards
  spill_dir = tempfile.mkdtemp(prefix='.shard_spill_', dir=outdir)
  try:
    scatter = [(i, p, num_shards, spill_dir, parse_fn)
               for i, p in enumerate(input_paths)]
    per_file = {}
    for file_idx, file_counts in _run_pool(_scatter_worker, scatter,
                                           num_workers):
      per_file[file_idx] = file_counts
    for file_counts in per_file.values():
      for j, c in enumerate(file_counts):
        counts[j] += c
    concat = []
    for j in range(num_shards):
      spills = [
          os.path.join(spill_dir, f'shard{j}.src{i}')
          for i in range(len(input_paths))
          if per_file.get(i, [0] * num_shards)[j]
      ]
      concat.append((j, spills, os.path.join(outdir, f'{j}.txt')))
    for _ in _run_pool(_concat_worker, concat, num_workers):
      pass
  finally:
    shutil.rmtree(spill_dir, ignore_errors=True)
  return counts
