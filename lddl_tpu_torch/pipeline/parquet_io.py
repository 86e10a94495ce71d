"""A Parquet reader and writer in numpy, for the shards of lddl_tpu.

The card's machine has no pyarrow, so the port reads and writes shards
itself. The write side (:class:`Table`, :func:`write_parquet`, and the
preprocessor's partition writers below) is at the end of this module. The
read side covers the part of ``pyarrow.parquet.ParquetFile`` the loader uses
(``lddl_tpu/loader/dataset.py:207``, ``lddl_tpu/core/utils.py:81``,
``lddl_tpu/pipeline/shard_format.py:94``): the footer's row count and
key-value metadata, and :meth:`ParquetFile.iter_batches`, one
:class:`RecordBatch` per row group.

It reads what :mod:`lddl_tpu` writes, and raises on anything else:

  - flat schemas of BOOLEAN (bit-packed, or RLE in v2 pages), INT32 (with
    its 8/16-bit integer logical types: ``num_tokens`` is uint16), INT64
    and BYTE_ARRAY (UTF8 strings, or binary) columns, required or
    nullable, with no null present;
  - data pages v1 and v2, several pages and row groups per file, and
    zero-row files (the balancer writes them);
  - PLAIN pages (the preprocess writes ``use_dictionary=False``,
    ``lddl_tpu/pipeline/parquet_io.py:82-83``), and a dictionary page with
    RLE_DICTIONARY (or PLAIN_DICTIONARY) data pages that may fall back to
    PLAIN within the chunk (the balancer writes pyarrow's defaults,
    ``lddl_tpu/balance.py:130``);
  - the codecs of :mod:`.codecs` (none, Snappy, LZ4, LZ4_RAW).

The footer and page headers are Thrift compact-protocol structs, parsed
here in Python into ``{field id: value}`` dicts, so fields a newer writer
adds (size statistics and the like) are read past and ignored. Levels and
dictionary indices (the RLE/bit-packed hybrid) are decoded with numpy;
decompression runs in the host C++ library of :mod:`.codecs`.
"""

import os
import pickle
import struct
import tempfile

import numpy as np

from .codecs import (LZ4_RAW, UNCOMPRESSED, compress, decompress,
                     plain_byte_arrays)

MAGIC = b'PAR1'

# parquet.thrift enums.
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
_TYPE_NAMES = ('BOOLEAN', 'INT32', 'INT64', 'INT96', 'FLOAT', 'DOUBLE',
               'BYTE_ARRAY', 'FIXED_LEN_BYTE_ARRAY')
REQUIRED, OPTIONAL, REPEATED = range(3)
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
_ENCODING_NAMES = {0: 'PLAIN', 2: 'PLAIN_DICTIONARY', 3: 'RLE',
                   4: 'BIT_PACKED', 5: 'DELTA_BINARY_PACKED',
                   6: 'DELTA_LENGTH_BYTE_ARRAY', 7: 'DELTA_BYTE_ARRAY',
                   8: 'RLE_DICTIONARY', 9: 'BYTE_STREAM_SPLIT'}
_UTF8 = 0  # ConvertedType.UTF8
# ConvertedType -> numpy dtype of the integer types the loader meets.
_CONVERTED_INTS = {11: np.uint8, 12: np.uint16, 13: np.uint32, 14: np.uint64,
                   15: np.int8, 16: np.int16, 17: np.int32, 18: np.int64}
_PLAIN_DTYPES = {INT32: np.dtype('<i4'), INT64: np.dtype('<i8')}


class _Compact:
  """Thrift compact-protocol reader over ``buf`` from ``pos``: structs come
  back as ``{field id: value}``, every field kept, known or not."""

  def __init__(self, buf, pos=0):
    self.buf = buf
    self.pos = pos

  def byte(self):
    b = self.buf[self.pos]
    self.pos += 1
    return b

  def varint(self):
    result = shift = 0
    while True:
      b = self.byte()
      result |= (b & 0x7f) << shift
      if not b & 0x80:
        return result
      shift += 7

  def zigzag(self):
    n = self.varint()
    return (n >> 1) ^ -(n & 1)

  def value(self, kind, in_field=False):
    if kind in (1, 2):  # bool: the type itself in a field header
      return kind == 1 if in_field else self.byte() == 1
    if kind == 3:
      b = self.byte()
      return b - 256 if b > 127 else b
    if kind in (4, 5, 6):
      return self.zigzag()
    if kind == 7:
      (x,) = struct.unpack_from('<d', self.buf, self.pos)
      self.pos += 8
      return x
    if kind == 8:
      n = self.varint()
      out = bytes(self.buf[self.pos:self.pos + n])
      if len(out) != n:
        raise IndexError('binary runs past the end')
      self.pos += n
      return out
    if kind in (9, 10):  # list, set
      head = self.byte()
      size, elem = head >> 4, head & 0x0f
      if size == 15:
        size = self.varint()
      return [self.value(elem) for _ in range(size)]
    if kind == 11:  # map
      size = self.varint()
      if not size:
        return {}
      kv = self.byte()
      return {self.value(kv >> 4): self.value(kv & 0x0f)
              for _ in range(size)}
    if kind == 12:
      return self.struct()
    raise ValueError(f'unknown thrift compact type {kind}')

  def struct(self):
    fields, last = {}, 0
    while True:
      head = self.byte()
      if head == 0:  # STOP
        return fields
      kind, delta = head & 0x0f, head >> 4
      fid = last + delta if delta else self.zigzag()
      fields[fid] = self.value(kind, in_field=True)
      last = fid


def _parse_struct(buf, pos, what):
  """``(fields, end)`` of the thrift struct at ``buf[pos:]``."""
  reader = _Compact(buf, pos)
  try:
    return reader.struct(), reader.pos
  except (IndexError, struct.error, RecursionError) as e:
    raise ValueError(f'malformed Parquet {what}: {e}') from None


class Column:
  """A leaf of the (flat) schema: its name, physical type, whether it is
  nullable, and the numpy dtype or Python type its values come as."""

  __slots__ = ('name', 'physical', 'nullable', 'dtype', 'text')

  def __init__(self, elem):
    self.name = elem[4].decode('utf-8')
    self.physical = elem.get(1)
    self.nullable = elem.get(3, REQUIRED) == OPTIONAL
    logical = elem.get(10, {})
    self.text = self.physical == BYTE_ARRAY and (
        elem.get(6) == _UTF8 or 1 in logical)
    self.dtype = None
    if self.physical == BOOLEAN:
      self.dtype = np.dtype(bool)
    elif self.physical in _PLAIN_DTYPES:
      self.dtype = _PLAIN_DTYPES[self.physical]
      if 10 in logical:  # IntType {1: bitWidth, 2: isSigned}
        bits, signed = logical[10][1], logical[10][2]
        self.dtype = np.dtype(f'{"i" if signed else "u"}{bits // 8}')
      elif elem.get(6) in _CONVERTED_INTS:
        self.dtype = np.dtype(_CONVERTED_INTS[elem[6]])
    elif self.physical != BYTE_ARRAY:
      name = (_TYPE_NAMES[self.physical] if self.physical is not None and
              0 <= self.physical < len(_TYPE_NAMES) else self.physical)
      raise ValueError(f'column {self.name!r}: physical type {name} is not '
                       'supported')
    if elem.get(3) == REPEATED:
      raise ValueError(f'column {self.name!r} is repeated: only flat '
                       'schemas are supported')


class RowGroupMeta:
  __slots__ = ('num_rows', 'chunks')

  def __init__(self, rg):
    self.num_rows = rg[3]
    # ColumnChunk.meta_data (3): ColumnMetaData.
    self.chunks = [c.get(3) for c in rg[1]]


class FileMetaData:
  """The footer: ``num_rows``, the row groups, the schema's leaf columns
  and the key-value metadata (``{bytes: bytes}``)."""

  def __init__(self, fields):
    self.num_rows = fields[3]
    schema = fields[2]
    root = schema[0]
    leaves = schema[1:]
    if root.get(5, 0) != len(leaves) or any(5 in e for e in leaves):
      raise ValueError('nested Parquet schemas are not supported')
    self.columns = [Column(e) for e in leaves]
    self.row_groups = [RowGroupMeta(rg) for rg in fields.get(4, [])]
    self.metadata = {kv[1]: kv.get(2, b'') for kv in fields.get(5, [])}

  @property
  def num_row_groups(self):
    return len(self.row_groups)


class ByteArrays:
  """A BYTE_ARRAY column as Arrow lays one out: value ``i`` is
  ``data[offsets[i]:offsets[i + 1]]``."""

  __slots__ = ('offsets', 'data')

  def __init__(self, offsets, data):
    self.offsets = offsets
    self.data = data

  def __len__(self):
    return self.offsets.shape[0] - 1

  def take(self, idx):
    """The values at ``idx`` (a dictionary lookup), gathered in numpy."""
    lens = np.diff(self.offsets)[idx]
    offsets = np.zeros(idx.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    src = (np.repeat(self.offsets[:-1][idx] - offsets[:-1], lens) +
           np.arange(offsets[-1], dtype=np.int64))
    return ByteArrays(offsets, self.data[src])

  def slice(self, start, stop):
    """Values ``[start, stop)``, their offsets rebased to 0."""
    offsets = self.offsets[start:stop + 1]
    return ByteArrays(offsets - offsets[0],
                      self.data[offsets[0]:offsets[-1]])

  @staticmethod
  def concat(parts):
    if len(parts) == 1:
      return parts[0]
    shifts = np.cumsum([0] + [p.data.shape[0] for p in parts[:-1]])
    offsets = np.concatenate([parts[0].offsets[:1]] + [
        p.offsets[1:] + s for p, s in zip(parts, shifts)])
    return ByteArrays(offsets, np.concatenate([p.data for p in parts]))

  def to_pylist(self, text):
    raw = self.data.tobytes()
    o = self.offsets.tolist()
    if text:
      return [raw[a:b].decode('utf-8') for a, b in zip(o, o[1:])]
    return [raw[a:b] for a, b in zip(o, o[1:])]

  def token_counts(self):
    """Per value: spaces + 1 (the token count of a single-space-joined
    string), in numpy over the whole column."""
    spaces = np.zeros(self.data.shape[0] + 1, dtype=np.int64)
    np.cumsum(self.data == 32, out=spaces[1:])
    return spaces[self.offsets[1:]] - spaces[self.offsets[:-1]] + 1


def _plain_byte_arrays(buf, pos, end, n):
  """``n`` PLAIN BYTE_ARRAY values (each a 4-byte little-endian length,
  then its bytes) from ``buf[pos:end]``, and the position after them."""
  starts = np.empty(n, dtype=np.int64)
  lens = np.empty(n, dtype=np.int64)
  unpack = struct.Struct('<i').unpack_from
  for i in range(n):
    if pos + 4 > end:
      raise ValueError('PLAIN BYTE_ARRAY values run past the page')
    (k,) = unpack(buf, pos)
    starts[i] = pos + 4
    lens[i] = k
    pos += 4 + k
  if pos > end:
    raise ValueError('PLAIN BYTE_ARRAY values run past the page')
  offsets = np.zeros(n + 1, dtype=np.int64)
  np.cumsum(lens, out=offsets[1:])
  src = np.repeat(starts - offsets[:-1], lens) + np.arange(offsets[-1])
  return ByteArrays(offsets, buf[src]), pos


def _rle_hybrid(buf, pos, end, bit_width, n):
  """``n`` values of the RLE/bit-packed hybrid at ``buf[pos:end]`` (a
  uint8 array) as int64, and the position after the last run read."""
  out = np.zeros(n, dtype=np.int64)
  width_bytes = (bit_width + 7) // 8
  weights = np.left_shift(1, np.arange(bit_width, dtype=np.int64))
  filled = 0
  while filled < n:
    header = shift = 0
    while True:
      if pos >= end:
        raise ValueError('RLE/bit-packed run header runs past the data')
      b = int(buf[pos])
      pos += 1
      header |= (b & 0x7f) << shift
      if not b & 0x80:
        break
      shift += 7
    if header & 1:  # bit-packed: (header >> 1) groups of 8 values
      count = (header >> 1) * 8
      nbytes = (header >> 1) * bit_width
      if pos + nbytes > end:
        raise ValueError('bit-packed run runs past the data')
      take = min(count, n - filled)
      if bit_width:
        bits = np.unpackbits(buf[pos:pos + nbytes], bitorder='little')
        out[filled:filled + take] = (
            bits.reshape(count, bit_width)[:take] @ weights)
      pos += nbytes
    else:  # one value repeated (header >> 1) times
      count = header >> 1
      if pos + width_bytes > end:
        raise ValueError('RLE run runs past the data')
      take = min(count, n - filled)
      out[filled:filled + take] = int.from_bytes(
          buf[pos:pos + width_bytes].tobytes(), 'little')
      pos += width_bytes
    if count == 0:
      raise ValueError('empty RLE/bit-packed run')
    filled += take
  return out, pos


def _plain_values(column, buf, pos, end, n):
  if column.physical == BYTE_ARRAY:
    return _plain_byte_arrays(buf, pos, end, n)[0]
  if column.physical == BOOLEAN:
    if pos + (n + 7) // 8 > end:
      raise ValueError('PLAIN BOOLEAN values run past the page')
    return np.unpackbits(buf[pos:pos + (n + 7) // 8],
                         bitorder='little')[:n].astype(bool)
  raw = _PLAIN_DTYPES[column.physical]
  if pos + n * raw.itemsize > end:
    raise ValueError(f'PLAIN {_TYPE_NAMES[column.physical]} values run past '
                     'the page')
  return np.frombuffer(buf, raw, n, pos).astype(column.dtype)


class _ChunkReader:
  """Decodes one column chunk, page by page."""

  def __init__(self, column, meta, raw):
    self.column = column
    self.codec = meta[4]
    self.num_values = meta[5]
    self.raw = raw  # the chunk's bytes: page headers, then page bodies
    self.dictionary = None

  def _check_nulls(self, nulls):
    if nulls:
      raise ValueError(f'column {self.column.name!r} holds {nulls} null '
                       'value(s): the shard reader takes none')

  def _levels(self, page, pos, end, n):
    """Skip (v1) the definition levels of a nullable column after checking
    that all ``n`` values are defined; returns the position after them."""
    if not self.column.nullable:
      return pos
    if pos + 4 > end:
      raise ValueError('definition levels run past the page')
    length = int.from_bytes(page[pos:pos + 4].tobytes(), 'little')
    levels, _ = _rle_hybrid(page, pos + 4, pos + 4 + length, 1, n)
    self._check_nulls(n - int(levels.sum()))
    return pos + 4 + length

  def _values(self, encoding, page, pos, end, n):
    col = self.column
    if encoding == PLAIN:
      return _plain_values(col, page, pos, end, n)
    if encoding in (RLE_DICTIONARY, PLAIN_DICTIONARY):
      if self.dictionary is None:
        raise ValueError(f'column {col.name!r}: a dictionary-encoded page '
                         'with no dictionary page before it')
      if pos >= end:
        raise ValueError('dictionary indices run past the page')
      idx, _ = _rle_hybrid(page, pos + 1, end, int(page[pos]), n)
      size = len(self.dictionary)
      if n and (idx.min() < 0 or idx.max() >= size):
        raise ValueError(f'column {col.name!r}: dictionary index out of '
                         f'range (dictionary of {size})')
      if isinstance(self.dictionary, ByteArrays):
        return self.dictionary.take(idx)
      return self.dictionary[idx]
    if encoding == RLE and col.physical == BOOLEAN:
      if pos + 4 > end:
        raise ValueError('RLE BOOLEAN values run past the page')
      length = int.from_bytes(page[pos:pos + 4].tobytes(), 'little')
      bits, _ = _rle_hybrid(page, pos + 4, min(end, pos + 4 + length), 1, n)
      return bits.astype(bool)
    raise ValueError(f'column {col.name!r}: encoding '
                     f'{_ENCODING_NAMES.get(encoding, encoding)} is not '
                     'supported')

  def read(self):
    parts, got, pos = [], 0, 0
    raw = self.raw
    while got < self.num_values:
      header, pos = _parse_struct(raw, pos, 'page header')
      kind, size, packed = header[1], header[2], header[3]
      payload = raw[pos:pos + packed]
      if len(payload) != packed:
        raise ValueError(f'column {self.column.name!r}: page runs past the '
                         'column chunk')
      pos += packed
      if kind == DICTIONARY_PAGE:
        dph = header[7]
        page = decompress(self.codec, payload, size)
        if dph.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
          raise ValueError('dictionary page encoding '
                           f'{_ENCODING_NAMES.get(dph[2], dph[2])} is not '
                           'supported')
        self.dictionary = _plain_values(self.column, page, 0, size, dph[1])
      elif kind == DATA_PAGE:
        dph = header[5]
        n = dph[1]
        page = decompress(self.codec, payload, size)
        start = self._levels(page, 0, size, n)
        parts.append(self._values(dph[2], page, start, size, n))
        got += n
      elif kind == DATA_PAGE_V2:
        dph = header[8]
        n = dph[1]
        self._check_nulls(dph[2])
        levels = dph[5] + dph[6]
        body = payload[levels:]
        if dph.get(7, True):
          page = decompress(self.codec, body, size - levels)
        else:
          page = np.frombuffer(body, dtype=np.uint8)
        parts.append(self._values(dph[4], page, 0, page.shape[0], n))
        got += n
      # INDEX_PAGE and unknown page kinds carry no values: skipped.
    if got != self.num_values:
      raise ValueError(f'column {self.column.name!r}: pages hold {got} '
                       f'values, the chunk says {self.num_values}')
    if not parts:
      parts = [_plain_values(self.column, np.zeros(0, np.uint8), 0, 0, 0)]
    if isinstance(parts[0], ByteArrays):
      return ByteArrays.concat(parts)
    return np.concatenate(parts)


class RecordBatch:
  """One row group's columns: ``column(name)`` gives a numpy array
  (fixed-width types), a list of ``str`` (UTF8) or a list of ``bytes``
  (BINARY); :meth:`byte_arrays` gives a BYTE_ARRAY column undecoded."""

  def __init__(self, num_rows, columns, values):
    self.num_rows = num_rows
    self.names = [c.name for c in columns]
    self._columns = {c.name: c for c in columns}
    self._values = values

  def byte_arrays(self, name):
    values = self._values[name]
    if not isinstance(values, ByteArrays):
      raise TypeError(f'column {name!r} is not a BYTE_ARRAY column')
    return values

  def column(self, name):
    values = self._values[name]
    if isinstance(values, ByteArrays):
      return values.to_pylist(self._columns[name].text)
    return values


class ParquetFile:
  """``with ParquetFile(path) as pf:`` ``pf.metadata.num_rows``,
  ``pf.metadata.metadata`` (the footer's key-value metadata) and
  ``pf.iter_batches()``. The footer is read here; each read of row groups
  opens the file for as long as it lasts, so no handle outlives a call
  or an exhausted or closed iterator."""

  def __init__(self, path):
    self.path = os.fspath(path)
    with open(self.path, 'rb') as f:
      self.metadata = self._read_footer(f)

  def _read_footer(self, f):
    size = f.seek(0, os.SEEK_END)
    if size < 12:
      raise ValueError(f'{self.path}: {size} bytes is too short for Parquet')
    f.seek(0)
    head = f.read(4)
    f.seek(size - 8)
    tail = f.read(8)
    if head != MAGIC or tail[4:] != MAGIC:
      raise ValueError(f'{self.path}: not a Parquet file (no PAR1 magic)')
    length = int.from_bytes(tail[:4], 'little')
    if length > size - 12:
      raise ValueError(f'{self.path}: footer length {length} exceeds the '
                       'file')
    f.seek(size - 8 - length)
    fields, _ = _parse_struct(f.read(length), 0, 'footer')
    return FileMetaData(fields)

  def _read_row_group(self, f, i):
    rg = self.metadata.row_groups[i]
    values = {}
    for column, meta in zip(self.metadata.columns, rg.chunks):
      if meta is None:
        raise ValueError(f'{self.path}: column {column.name!r} has no '
                         f'metadata in row group {i}')
      if meta[1] != column.physical:
        raise ValueError(f'{self.path}: column {column.name!r} is '
                         f'{meta[1]} in row group {i}, {column.physical} in '
                         'the schema')
      f.seek(meta.get(11) or meta[9])  # the dictionary page, if any, leads
      values[column.name] = _ChunkReader(column, meta, f.read(meta[7])).read()
      if len(values[column.name]) != rg.num_rows:
        raise ValueError(f'{self.path}: column {column.name!r} has '
                         f'{len(values[column.name])} values in row group '
                         f'{i} of {rg.num_rows} rows')
    return RecordBatch(rg.num_rows, self.metadata.columns, values)

  def read_row_groups(self, indices):
    """Row groups ``indices``, in that order, as one :class:`Table` with
    the file's schema and key-value metadata."""
    with open(self.path, 'rb') as f:
      batches = [self._read_row_group(f, i) for i in indices]
    fields = schema_of(self.metadata.columns)
    columns = {name: _concat_values([b._values[name] for b in batches])
               if batches else _empty_values(kind) for name, kind in fields}
    return Table(columns, fields, self.metadata.metadata)

  def read(self):
    """The whole file as one :class:`Table`."""
    return self.read_row_groups(range(self.metadata.num_row_groups))

  def iter_batches(self):
    """One :class:`RecordBatch` per non-empty row group, in file order."""
    with open(self.path, 'rb') as f:
      for i, rg in enumerate(self.metadata.row_groups):
        if rg.num_rows:
          yield self._read_row_group(f, i)

  def close(self):
    """Nothing to release: no handle stays open between calls."""

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


# ---------------------------------------------------------------------------
# the write side: tables in column buffers, and the Parquet writer

#: The column kinds the writer takes, as Arrow names them: kind ->
#: (physical type, ConvertedType, LogicalType union as a thrift struct,
#: numpy dtype). ``uint16`` carries both the converted and the logical
#: type, so pyarrow reads ``num_tokens`` as uint16, not int32.
KINDS = {
    'string': (BYTE_ARRAY, _UTF8, {1: {}}, None),
    'binary': (BYTE_ARRAY, None, None, None),
    'bool': (BOOLEAN, None, None, np.dtype(bool)),
    'uint16': (INT32, 12, {10: {1: 16, 2: False}}, np.dtype('<u2')),
    'int32': (INT32, None, None, np.dtype('<i4')),
    'int64': (INT64, None, None, np.dtype('<i8')),
}
_KIND_OF_DTYPE = {np.dtype(bool): 'bool', np.dtype('<u2'): 'uint16',
                  np.dtype('<i4'): 'int32', np.dtype('<i8'): 'int64'}


def schema_of(columns):
  """``[(name, kind)]`` of the reader's leaf :class:`Column` s."""
  fields = []
  for c in columns:
    if c.physical == BYTE_ARRAY:
      kind = 'string' if c.text else 'binary'
    elif c.dtype in _KIND_OF_DTYPE:
      kind = _KIND_OF_DTYPE[c.dtype]
    else:
      raise ValueError(f'column {c.name!r}: {c.dtype} has no writer kind')
    fields.append((c.name, kind))
  return fields


def byte_arrays_of(values):
  """A :class:`ByteArrays` column of Python ``str`` (UTF-8) or ``bytes``."""
  raw = [v.encode('utf-8') if isinstance(v, str) else bytes(v)
         for v in values]
  offsets = np.zeros(len(raw) + 1, dtype=np.int64)
  np.cumsum([len(r) for r in raw], out=offsets[1:])
  return ByteArrays(offsets, np.frombuffer(b''.join(raw), dtype=np.uint8))


def _empty_values(kind):
  if KINDS[kind][0] == BYTE_ARRAY:
    return ByteArrays(np.zeros(1, np.int64), np.zeros(0, np.uint8))
  return np.zeros(0, dtype=KINDS[kind][3])


def _concat_values(parts):
  if isinstance(parts[0], ByteArrays):
    return ByteArrays.concat(parts)
  return np.concatenate(parts)


def _as_column(kind, values):
  if kind not in KINDS:
    raise ValueError(f'unknown column kind {kind!r} ({", ".join(KINDS)})')
  if KINDS[kind][0] == BYTE_ARRAY:
    if isinstance(values, ByteArrays):
      return ByteArrays(np.asarray(values.offsets, dtype=np.int64),
                        np.asarray(values.data, dtype=np.uint8))
    return byte_arrays_of(values)
  return np.ascontiguousarray(values, dtype=KINDS[kind][3])


class Schema:
  """A flat schema: ``fields`` ``[(name, kind)]`` and the key-value
  ``metadata`` (``{bytes: bytes}``) the footer carries."""

  def __init__(self, fields, metadata=None):
    self.fields = [(name, kind) for name, kind in fields]
    self.metadata = dict(metadata or {})

  @property
  def names(self):
    return [name for name, _ in self.fields]

  def with_metadata(self, metadata):
    return Schema(self.fields, metadata)

  def empty_table(self):
    return Table({name: _empty_values(kind) for name, kind in self.fields},
                 self.fields, self.metadata)


class Table:
  """A flat table held as column buffers: a numpy array per fixed-width
  column, a :class:`ByteArrays` per string or binary column, in the order
  of ``fields`` (``[(name, kind)]``, kinds of :data:`KINDS`), plus the
  footer's key-value ``metadata``."""

  def __init__(self, columns, fields, metadata=None):
    self.schema = Schema(fields, metadata)
    self._columns = {name: _as_column(kind, columns[name])
                     for name, kind in self.schema.fields}
    lengths = {name: len(v) for name, v in self._columns.items()}
    if len(set(lengths.values())) > 1:
      raise ValueError(f'columns of unequal length: {lengths}')
    self.num_rows = next(iter(lengths.values()), 0)

  @property
  def fields(self):
    return self.schema.fields

  @property
  def names(self):
    return self.schema.names

  @property
  def metadata(self):
    return self.schema.metadata

  def column(self, name):
    return self._columns[name]

  def take(self, idx):
    """Rows ``idx`` (an int array), in that order."""
    idx = np.asarray(idx, dtype=np.int64)
    return Table({n: v.take(idx) if isinstance(v, ByteArrays) else v[idx]
                  for n, v in self._columns.items()}, self.fields,
                 self.metadata)

  def slice(self, start, stop):
    return Table({n: v.slice(start, stop) if isinstance(v, ByteArrays)
                  else v[start:stop] for n, v in self._columns.items()},
                 self.fields, self.metadata)

  def append_column(self, name, kind, values):
    columns = dict(self._columns)
    columns[name] = values
    return Table(columns, self.fields + [(name, kind)], self.metadata)

  def with_metadata(self, metadata):
    return Table(self._columns, self.fields, metadata)

  @staticmethod
  def concat(tables):
    """Row-wise concatenation of tables of one schema (the first's
    metadata)."""
    first = tables[0]
    if any(t.fields != first.fields for t in tables[1:]):
      raise ValueError('concat of tables with different schemas')
    return Table({n: _concat_values([t.column(n) for t in tables])
                  for n in first.names}, first.fields, first.metadata)

  def to_pylist(self):
    """Rows as dicts: ``str`` for strings, ``bytes`` for binary values,
    Python ints and bools otherwise (as ``pyarrow``'s ``to_pylist``)."""
    cols = {}
    for name, kind in self.fields:
      v = self._columns[name]
      cols[name] = (v.to_pylist(kind == 'string')
                    if isinstance(v, ByteArrays) else v.tolist())
    return [dict(zip(cols, row)) for row in zip(*cols.values())] \
        if cols else []


# Thrift compact-protocol types.
_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64 = 1, 2, 3, 4, 5, 6
_T_BINARY, _T_LIST, _T_STRUCT = 8, 9, 12


class _CompactWriter:
  """Thrift compact-protocol writer. A struct is a list of ``(field id,
  type, value)`` in ascending field order (None values are left out); a
  list value is ``(element type, items)``."""

  def __init__(self):
    self.out = bytearray()

  def varint(self, n):
    while True:
      b = n & 0x7f
      n >>= 7
      if n:
        self.out.append(b | 0x80)
      else:
        self.out.append(b)
        return

  def zigzag(self, n):
    self.varint((n << 1) ^ (n >> 63))

  def value(self, kind, v):
    if kind in (_T_BYTE,):
      self.out.append(v & 0xff)
    elif kind in (_T_I16, _T_I32, _T_I64):
      self.zigzag(v)
    elif kind == _T_BINARY:
      v = v.encode('utf-8') if isinstance(v, str) else bytes(v)
      self.varint(len(v))
      self.out += v
    elif kind == _T_LIST:
      elem, items = v
      if len(items) < 15:
        self.out.append(len(items) << 4 | elem)
      else:
        self.out.append(0xf0 | elem)
        self.varint(len(items))
      for item in items:
        self.value(elem, item)
    elif kind == _T_STRUCT:
      self.struct(v)
    else:
      raise ValueError(f'thrift compact type {kind} is not written here')

  def struct(self, fields):
    last = 0
    for fid, kind, v in fields:
      if v is None:
        continue
      head = kind
      if kind == _T_TRUE:  # a bool field: its value is its type
        head = _T_TRUE if v else _T_FALSE
      delta = fid - last
      if 0 < delta <= 15:
        self.out.append(delta << 4 | head)
      else:
        self.out.append(head)
        self.zigzag(fid)
      if kind != _T_TRUE:
        self.value(kind, v)
      last = fid
    self.out.append(0)  # STOP


def _thrift(fields):
  w = _CompactWriter()
  w.struct(fields)
  return bytes(w.out)


def _logical_struct(logical):
  """A LogicalType union (``{field: struct-or-IntType}``) as writer
  fields."""
  (fid, body), = logical.items()
  if fid == 10:  # IntType {1: bitWidth (i8), 2: isSigned}
    inner = [(1, _T_BYTE, body[1]), (2, _T_TRUE, body[2])]
  else:
    inner = []
  return [(fid, _T_STRUCT, inner)]


#: Bytes of encoded values per data page (pyarrow's default page size).
PAGE_BYTES = 1 << 20
#: Rows per row group, at most (pyarrow's default).
ROW_GROUP_ROWS = 1 << 20
CREATED_BY = 'lddl_tpu_torch parquet writer'


def _page_rows(kind, values, start, stop):
  """Row bounds ``[start, ..., stop]`` of pages of about PAGE_BYTES."""
  if KINDS[kind][0] == BYTE_ARRAY:
    sizes = 4 + np.diff(values.offsets[start:stop + 1])
    cum = np.cumsum(sizes)
    bounds = [0]
    while bounds[-1] < stop - start:
      base = cum[bounds[-1] - 1] if bounds[-1] else 0
      nxt = int(np.searchsorted(cum, base + PAGE_BYTES, side='right'))
      bounds.append(min(stop - start, max(nxt, bounds[-1] + 1)))
    return [start + b for b in bounds]
  width = KINDS[kind][3].itemsize if kind != 'bool' else 1
  step = max(8, PAGE_BYTES // width)
  return list(range(start, stop, step)) + [stop]


def _encode_page(kind, values, start, stop):
  physical = KINDS[kind][0]
  if physical == BYTE_ARRAY:
    o = values.offsets[start:stop + 1]
    return plain_byte_arrays(o - o[0], values.data[o[0]:o[-1]])
  part = values[start:stop]
  if physical == BOOLEAN:
    return np.packbits(part, bitorder='little')
  raw = np.dtype('<i4') if physical == INT32 else np.dtype('<i8')
  return np.ascontiguousarray(part.astype(raw)).view(np.uint8)


def _write_chunk(f, kind, values, start, stop, codec):
  """One column chunk (PLAIN data pages v1) at ``f``'s position; returns
  its ColumnMetaData fields without the name."""
  offset = f.tell()
  raw_total = packed_total = 0
  bounds = _page_rows(kind, values, start, stop)
  for a, b in zip(bounds, bounds[1:]):
    body = _encode_page(kind, values, a, b)
    packed = compress(codec, body)
    header = _thrift([
        (1, _T_I32, DATA_PAGE), (2, _T_I32, int(body.shape[0])),
        (3, _T_I32, int(packed.shape[0])),
        (5, _T_STRUCT, [(1, _T_I32, b - a), (2, _T_I32, PLAIN),
                        (3, _T_I32, RLE), (4, _T_I32, RLE)])])
    f.write(header)
    f.write(packed.tobytes())
    raw_total += len(header) + body.shape[0]
    packed_total += len(header) + packed.shape[0]
  return offset, raw_total, packed_total


def write_parquet(table, path, compression=LZ4_RAW,
                  row_group_rows=ROW_GROUP_ROWS):
  """Write ``table`` (a :class:`Table`) to ``path`` as Parquet: required
  columns, PLAIN data pages v1 of about :data:`PAGE_BYTES` compressed
  with ``compression`` (a codec id: LZ4_RAW or UNCOMPRESSED), row groups
  of at most ``row_group_rows`` rows (none for a zero-row table), and
  the table's metadata as the footer's key-value metadata."""
  if compression not in (LZ4_RAW, UNCOMPRESSED):
    raise ValueError(f'compression {compression!r}: the writer takes '
                     f'LZ4_RAW ({LZ4_RAW}) or UNCOMPRESSED ({UNCOMPRESSED})')
  row_groups = []
  with open(path, 'wb') as f:
    f.write(MAGIC)
    for r0 in range(0, table.num_rows, max(1, int(row_group_rows))):
      r1 = min(table.num_rows, r0 + int(row_group_rows))
      chunks, raw_rg, packed_rg = [], 0, 0
      for name, kind in table.fields:
        offset, raw, packed = _write_chunk(f, kind, table.column(name), r0,
                                           r1, compression)
        meta = [(1, _T_I32, KINDS[kind][0]), (2, _T_LIST, (_T_I32, [PLAIN])),
                (3, _T_LIST, (_T_BINARY, [name])),
                (4, _T_I32, compression), (5, _T_I64, r1 - r0),
                (6, _T_I64, raw), (7, _T_I64, packed), (9, _T_I64, offset)]
        chunks.append([(2, _T_I64, offset), (3, _T_STRUCT, meta)])
        raw_rg += raw
        packed_rg += packed
      first = chunks[0][0][2] if chunks else f.tell()
      row_groups.append([
          (1, _T_LIST, (_T_STRUCT, chunks)), (2, _T_I64, raw_rg),
          (3, _T_I64, r1 - r0), (5, _T_I64, first),
          (6, _T_I64, packed_rg), (7, _T_I16, len(row_groups))])
    schema = [[(4, _T_BINARY, 'schema'),
               (5, _T_I32, len(table.fields))]]
    for name, kind in table.fields:
      physical, converted, logical, _ = KINDS[kind]
      schema.append([
          (1, _T_I32, physical), (3, _T_I32, REQUIRED),
          (4, _T_BINARY, name), (6, _T_I32, converted),
          (10, _T_STRUCT, _logical_struct(logical) if logical else None)])
    kv = [[(1, _T_BINARY, k), (2, _T_BINARY, v)]
          for k, v in table.metadata.items()]
    footer = _thrift([
        (1, _T_I32, 1), (2, _T_LIST, (_T_STRUCT, schema)),
        (3, _T_I64, table.num_rows), (4, _T_LIST, (_T_STRUCT, row_groups)),
        (5, _T_LIST, (_T_STRUCT, kv)) if kv else (5, _T_LIST, None),
        (6, _T_BINARY, CREATED_BY)])
    f.write(footer)
    f.write(len(footer).to_bytes(4, 'little'))
    f.write(MAGIC)


# ---------------------------------------------------------------------------
# the preprocessor's partition writers (lddl_tpu/pipeline/parquet_io.py)


def compute_bin_ids(num_tokens, bin_size, nbins):
  """``clamp((num_tokens - 1) // bin_size, 0, nbins - 1)``, vectorized."""
  num_tokens = np.asarray(num_tokens, dtype=np.int64)
  return np.clip((num_tokens - 1) // bin_size, 0, nbins - 1)


# The writers' ``compression`` names (pyarrow's, as lddl_tpu passes them):
# 'default' and 'lz4' are LZ4_RAW, which pyarrow writes for 'lz4'.
_COMPRESSION = {'default': LZ4_RAW, 'lz4': LZ4_RAW, None: UNCOMPRESSED}


def _codec(compression):
  if compression not in _COMPRESSION:
    raise ValueError(f'compression {compression!r}: the port writes '
                     f'{", ".join(map(repr, _COMPRESSION))}')
  return _COMPRESSION[compression]


def write_shard_file(table, path, output_format='parquet',
                     compression='default'):
  """Write one shard file atomically: a pid-unique tmp file in the same
  directory (invisible to shard discovery: a leading dot and ``.tmp``),
  fingerprinted into the ledger when it is on, then renamed into place.
  ``compression='default'`` is LZ4_RAW, the codec lddl_tpu writes.

  Module-level, so an :class:`~.pool.AsyncShardWriter` can run it: a
  deferred write changes when bytes land, never what lands."""
  from ..telemetry import get_telemetry
  out_dir = os.path.dirname(path) or '.'
  tmp = os.path.join(out_dir, f'.{os.path.basename(path)}.{os.getpid()}.tmp')
  try:
    if output_format == 'parquet':
      with get_telemetry().span('pipeline.write_seconds'):
        write_parquet(table, tmp, compression=_codec(compression))
    elif output_format == 'txt':
      with open(tmp, 'w', encoding='utf-8') as f:
        for row in table.to_pylist():
          f.write(repr(row) + '\n')
    else:
      raise ValueError(f'unknown output_format {output_format!r}')
    from ..telemetry.ledger import fingerprint_file, get_ledger
    ledger = get_ledger()
    if ledger.enabled:
      # The shard boundary: the exact bytes about to be renamed into place.
      ledger.record('shard', fingerprint_file(tmp),
                    path=os.path.basename(path))
    os.rename(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)


def write_table_partition(table, out_dir, partition_idx, bin_size=None,
                          nbins=None, compression='default',
                          output_format='parquet', writer=None):
  """Write one partition's :class:`Table`: ``part.<idx>.parquet``, or one
  file per sequence bin, ``part.<idx>.parquet_<bin>``, each with an int64
  ``bin_id`` column (every bin's file is written, empty or not, so the
  bin-id set stays contiguous). The bin split is one stable argsort and a
  take per bin. With ``writer`` (an :class:`~.pool.AsyncShardWriter`) the
  writes go to its thread. Returns ``{bin_id_or_None: (path,
  num_samples)}``."""
  os.makedirs(out_dir, exist_ok=True)

  def _write(tbl, path):
    if writer is not None:
      writer.submit(write_shard_file, tbl, path, output_format=output_format,
                    compression=compression)
    else:
      write_shard_file(tbl, path, output_format=output_format,
                       compression=compression)

  ext = 'parquet' if output_format == 'parquet' else 'txt'
  if bin_size is None:
    path = os.path.join(out_dir, f'part.{partition_idx}.{ext}')
    _write(table, path)
    return {None: (path, table.num_rows)}
  if nbins is None:
    raise ValueError('nbins is required when bin_size is set')
  bin_ids = compute_bin_ids(table.column('num_tokens'), bin_size, nbins)
  order = np.argsort(bin_ids, kind='stable')
  boundaries = np.searchsorted(bin_ids[order], np.arange(nbins + 1))
  out = {}
  for b in range(nbins):
    idx = order[boundaries[b]:boundaries[b + 1]]
    tbl = table.take(idx).append_column(
        'bin_id', 'int64', np.full(len(idx), b, dtype=np.int64))
    path = os.path.join(out_dir, f'part.{partition_idx}.{ext}_{b}')
    _write(tbl, path)
    out[b] = (path, len(idx))
  return out


def write_samples_partition(samples, schema, out_dir, partition_idx,
                            bin_size=None, nbins=None, compression='default',
                            output_format='parquet', writer=None):
  """:func:`write_table_partition` of a list of sample dicts over
  ``schema`` (a :class:`Schema`, whose metadata rides into the footer)."""
  cols = {name: [r[name] for r in samples] for name in schema.names}
  return write_table_partition(
      Table(cols, schema.fields, schema.metadata), out_dir, partition_idx,
      bin_size=bin_size, nbins=nbins, compression=compression,
      output_format=output_format, writer=writer)


def read_samples(path, columns=None):
  """Read a Parquet shard back into a list of row dicts (``columns``, in
  that order, or every column), as ``lddl_tpu``'s ``read_samples`` gives
  them through ``pyarrow``'s ``to_pylist``."""
  table = ParquetFile(path).read()
  if columns is not None:
    kinds = dict(table.fields)
    table = Table({name: table.column(name) for name in columns},
                  [(name, kinds[name]) for name in columns], table.metadata)
  return table.to_pylist()


# ---------------------------------------------------------------------------
# completion manifests (the elastic executor; lddl_tpu/pipeline/parquet_io.py)


def manifest_key(global_index):
  """Completion-manifest key of one task of an elastic map phase."""
  return f'done.{int(global_index)}'


def write_manifest_file(manifest_root, global_index, payload):
  """Publish one completion manifest atomically (a temporary file in the
  same directory, then a rename, as :func:`write_shard_file` does).
  ``payload`` is the pickled task result; the manifest's existence is the
  completion bit that claims and a restart's resume read, so it only ever
  appears whole."""
  fd, tmp = tempfile.mkstemp(dir=manifest_root)
  with os.fdopen(fd, 'wb') as f:
    f.write(payload)
  os.rename(tmp, os.path.join(manifest_root, manifest_key(global_index)))


def publish_result_manifest(manifest_root, global_index, result):
  """Publish ``done.<gi>`` for a finished task, behind its shard writes.

  Runs in the process that ran the task. With an ambient
  :class:`~.pool.AsyncShardWriter` the manifest is submitted to the queue
  the task's shard writes went through, so it lands only after them, and
  not at all where an earlier write on that queue failed: a manifest never
  vouches for shards that were not written. Without a writer the task's
  writes have already landed, and the manifest is written here."""
  from .pool import current_writer
  payload = pickle.dumps(result)
  writer = current_writer()
  if writer is not None:
    writer.submit(_manifest_write_job, writer, manifest_root, global_index,
                  payload)
  else:
    write_manifest_file(manifest_root, global_index, payload)


def _manifest_write_job(writer, manifest_root, global_index, payload):
  # On the writer thread, after every earlier job of the task.
  if writer.failed:
    return  # an earlier shard write failed: the phase fails and reruns it
  write_manifest_file(manifest_root, global_index, payload)


def read_result_manifest(store, global_index):
  """The unpickled result of a :class:`~..comm.backend.LeaseStore`
  manifest, or :data:`MANIFEST_MISSING` where there is none (a result may
  be None)."""
  raw = store.read(manifest_key(global_index))
  return MANIFEST_MISSING if raw is None else pickle.loads(raw)


#: Tells "no manifest yet" from a published None.
MANIFEST_MISSING = object()
