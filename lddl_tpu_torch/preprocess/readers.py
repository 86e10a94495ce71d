"""Corpus readers: one-document-per-line text shards -> planned partitions.

Copied from :mod:`lddl_tpu.preprocess.readers`.

Input contract (shared with the downloaders; reference
``lddl/dask/readers.py:60-147``): each ``.txt`` shard under a source
directory holds one document per line, and the first whitespace-separated
token of the line is the document id.

The reference builds dask bags; here a :class:`Corpus` is a *plan* — a list
of byte-slice partitions plus deterministic per-partition sampling — that
the executor materializes anywhere.
"""

import dataclasses
import os

from ..core.utils import get_all_txt_files_under
from ..core.random import rng_from_key
from ..pipeline.partition import (
    estimate_block_size,
    plan_text_partitions,
    read_lines,
    read_records,
)

CODE_SPLIT = '<CODESPLIT>'


def split_id_text(raw_text):
  """Split a document line into (doc_id, text)."""
  parts = raw_text.split(None, 1)
  if len(parts) < 2:
    return parts[0] if parts else '', ''
  return parts[0], parts[1]


def split_id_code_docstring(raw_text):
  """Split a bimodal code record into (id, docstring, code) on the
  ``<CODESPLIT>`` separator (reference ``lddl/dask/readers.py:150-151``)."""
  parts = raw_text.split(CODE_SPLIT)
  if len(parts) != 3:
    return None
  return tuple(parts)


@dataclasses.dataclass(frozen=True)
class Corpus:
  """A partitioned view of one or more source directories."""

  partitions: tuple  # tuple of tuples of TextSlice
  sample_ratio: float = 1.0
  sample_seed: int = 12345
  delimiter: str = '\n'  # record delimiter ('\r\n' for the code corpus)

  @property
  def num_partitions(self):
    return len(self.partitions)

  def read_partition(self, idx):
    """Yield the (possibly subsampled) raw document lines of partition idx."""
    return read_partition_lines(self.partitions[idx], idx, self.sample_ratio,
                                self.sample_seed, self.delimiter)


def read_partition_lines(part_slices, idx, sample_ratio, sample_seed,
                         delimiter='\n'):
  """Yield one partition's (possibly subsampled) document lines.

  Module-level so distributed tasks can carry just their own slices plus
  scalar sampling parameters instead of the whole corpus plan.
  """
  rng = rng_from_key(sample_seed, 'corpus-sample', idx)
  for s in part_slices:
    records = (read_lines(s) if delimiter == '\n' else
               read_records(s, delimiter=delimiter))
    for line in records:
      if sample_ratio >= 1.0 or rng.random() < sample_ratio:
        yield line


def read_corpus(dirs, num_blocks=None, block_size=None, sample_ratio=1.0,
                sample_seed=12345, delimiter='\n'):
  """Plan a corpus from source directories of one-doc-per-line txt shards.

  Exactly one of num_blocks/block_size controls partition granularity
  (reference ``lddl/dask/readers.py:48-70``).
  """
  paths = []
  for d in ([dirs] if isinstance(dirs, str) else dirs):
    if d is None:
      continue
    found = get_all_txt_files_under(d)
    if not found:
      raise ValueError(f'no .txt shards found under {d!r}')
    paths.extend(found)
  if block_size is None:
    if num_blocks is None:
      raise ValueError('need num_blocks or block_size')
    block_size = estimate_block_size(paths, num_blocks)
  slices = plan_text_partitions(paths, block_size)
  return Corpus(
      partitions=tuple((s,) for s in slices),
      sample_ratio=sample_ratio,
      sample_seed=sample_seed,
      delimiter=delimiter,
  )


def read_wikipedia(path, lang='en', **kwargs):
  return read_corpus(os.path.join(path, lang), **kwargs)


def read_books(path, **kwargs):
  return read_corpus(os.path.join(path, 'source'), **kwargs)


def read_common_crawl(path, **kwargs):
  return read_corpus(path, **kwargs)


def read_open_webtext(path, **kwargs):
  return read_corpus(path, **kwargs)


def read_code(path, **kwargs):
  """Bimodal code corpus: CRLF-delimited ``id<CODESPLIT>doc<CODESPLIT>code``
  records whose content contains plain newlines (reference
  ``lddl/dask/readers.py:130-139``)."""
  kwargs.setdefault('delimiter', '\r\n')
  return read_corpus(path, **kwargs)
