"""Shard format tags: materialized vs mask-delta corpora.

Copied from :mod:`lddl_tpu.pipeline.shard_format`. The JAX package keeps
the tag in the Arrow schema's metadata, which Parquet round-trips as the
footer's key-value metadata; the port writes and reads that footer
directly (:mod:`.parquet_io`), under the same keys, so either package
reads the other's tag.

  - ``materialized``: one physical row per training sample (and the
    implicit format of untagged shards);
  - ``delta``: one physical row per base pair plus ``duplicate_factor``
    per-copy mask deltas, which the loader expands into that many samples.

Formats must not be mixed within one corpus: their sample arithmetic
differs, so :func:`scan_shard_format` refuses a mixed file set.
"""

from .parquet_io import ParquetFile

MATERIALIZED = 'materialized'
DELTA = 'delta'

FORMAT_KEY = b'lddl_shard_format'
DUP_KEY = b'lddl_duplicate_factor'

#: The three ragged-packed delta columns of a delta-format BERT shard.
DELTA_COLUMNS = ('mask_delta_positions', 'mask_delta_new_ids',
                 'mask_delta_k')


def _tag_metadata(existing, shard_format, duplicate_factor):
  if shard_format not in (MATERIALIZED, DELTA):
    raise ValueError(f'unknown shard format {shard_format!r}')
  meta = dict(existing or {})
  meta[FORMAT_KEY] = shard_format.encode()
  meta[DUP_KEY] = str(int(duplicate_factor)).encode()
  return meta


def tag_table(table, shard_format, duplicate_factor):
  """Merge the shard-format tag into a :class:`~.parquet_io.Table`'s
  metadata."""
  return table.with_metadata(
      _tag_metadata(table.metadata, shard_format, duplicate_factor))


def tag_schema(schema, shard_format, duplicate_factor):
  """Schema-level sibling of :func:`tag_table`."""
  return schema.with_metadata(
      _tag_metadata(schema.metadata, shard_format, duplicate_factor))


def format_of_schema(metadata):
  """``(shard_format, duplicate_factor)`` from a footer's key-value
  metadata (``{bytes: bytes}``). Untagged shards read as
  ``('materialized', 1)``."""
  meta = metadata or {}
  fmt = meta.get(FORMAT_KEY, b'materialized').decode()
  if fmt not in (MATERIALIZED, DELTA):
    raise ValueError(f'unknown shard format tag {fmt!r} in schema metadata')
  dup = int(meta.get(DUP_KEY, b'1'))
  if dup < 1:
    raise ValueError(f'invalid duplicate_factor tag {dup}')
  return fmt, dup


def shard_format_of(path):
  """``(shard_format, duplicate_factor)`` of one Parquet shard, from the
  footer only (no data pages are read)."""
  with ParquetFile(path) as pf:
    return format_of_schema(pf.metadata.metadata)


def scan_shard_format(paths):
  """The single ``(shard_format, duplicate_factor)`` all ``paths`` agree
  on; raises ``ValueError`` on a mixed corpus. Materialized shards'
  stamped duplicate factor is provenance only, so it may differ."""
  if not paths:
    return MATERIALIZED, 1
  seen = {}
  for p in paths:
    fmt, dup = shard_format_of(p)
    key = (fmt, dup if fmt == DELTA else 1)
    seen.setdefault(key, []).append(p)
  if len(seen) > 1:
    desc = '; '.join(
        f'{fmt} (dup={dup}): e.g. {ps[0]}' for (fmt, dup), ps in
        sorted(seen.items()))
    raise ValueError(
        f'mixed shard formats in one corpus: {desc} — materialized and '
        'delta shards may not be mixed (and delta shards must share one '
        'duplicate_factor); re-preprocess with a single --shard-format')
  return next(iter(seen))
