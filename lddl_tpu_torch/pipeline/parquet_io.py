"""A read-only Parquet reader in numpy, for the shards lddl_tpu writes.

The card's machine has no pyarrow, so the port reads shards itself. This
module covers the part of ``pyarrow.parquet.ParquetFile`` the loader uses
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
import struct

import numpy as np

from .codecs import decompress

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
