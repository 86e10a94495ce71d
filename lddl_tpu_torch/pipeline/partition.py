"""Byte-range partitioning of one-document-per-line text shards.

Copied from :mod:`lddl_tpu.pipeline.partition`.

Replaces ``dask.bag.read_text(blocksize=...)`` (reference
``lddl/dask/readers.py:48-70``) with an explicit plan: each partition is a
list of byte slices; slice boundaries are arbitrary, and the reader applies
the standard convention that a line straddling a slice's *start* belongs to
the previous slice, so no newline scanning is needed at planning time.
"""

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class TextSlice:
  path: str
  start: int
  end: int  # exclusive


def estimate_block_size(paths, num_blocks):
  """Total corpus bytes / desired block count (reference readers.py:48-57)."""
  total = sum(os.path.getsize(p) for p in paths)
  if num_blocks <= 0:
    raise ValueError('num_blocks must be positive')
  return max(1, -(-total // num_blocks))  # ceil div


def plan_text_partitions(paths, block_size):
  """One partition per ~block_size byte slice, in sorted path order."""
  partitions = []
  for path in sorted(paths):
    size = os.path.getsize(path)
    if size == 0:
      continue
    start = 0
    while start < size:
      end = min(start + block_size, size)
      partitions.append(TextSlice(path, start, end))
      start = end
  return partitions


def read_records(text_slice, delimiter='\r\n', encoding='utf-8',
                 chunk_size=1 << 16):
  """Yield the records owned by a slice for an arbitrary multi-byte record
  delimiter (the bimodal code corpus uses CRLF records whose *content*
  contains plain newlines; reference ``lddl/dask/readers.py:130-139``).

  Ownership rule matches :func:`read_lines`: a record belongs to the slice
  in which it starts (= the byte after its predecessor's delimiter).
  """
  dlm = delimiter.encode(encoding)
  nd = len(dlm)
  with open(text_slice.path, 'rb') as f:
    start = text_slice.start
    if start > 0:
      # Does a delimiter end exactly at `start`? Then a record starts here.
      f.seek(max(0, start - nd))
      head = f.read(min(nd, start))
      if head != dlm:
        # Mid-record: the true next record start is the end of the first
        # delimiter whose END lies strictly after `start` (a delimiter may
        # straddle the boundary, so back up nd-1 bytes before scanning).
        scan_pos = max(0, start - (nd - 1))
        f.seek(scan_pos)
        buf = b''
        found = -1
        while found < 0:
          chunk = f.read(chunk_size)
          if not chunk:
            return
          buf += chunk
          i = buf.find(dlm)
          while i >= 0:
            if scan_pos + i + nd > start:
              found = scan_pos + i + nd
              break
            i = buf.find(dlm, i + 1)
          if found < 0:
            # Keep only a possible straddling prefix of a delimiter
            # (nothing for a single-byte delimiter — buf[-0:] would keep
            # the whole buffer and corrupt scan_pos).
            keep = nd - 1
            scan_pos += len(buf) - keep
            buf = buf[len(buf) - keep:] if keep else b''
        start = found
    if start >= text_slice.end:
      return
    f.seek(start)
    data = f.read(text_slice.end - start)
    # Complete the trailing record (it started inside the slice).
    if not data.endswith(dlm):
      while True:
        search_from = max(0, len(data) - (nd - 1))
        chunk = f.read(chunk_size)
        if not chunk:
          break
        data += chunk
        i = data.find(dlm, search_from)
        if i >= 0:
          data = data[:i + nd]
          break
    for rec in data.split(dlm):
      text = rec.decode(encoding).strip()
      if text:
        yield text


def read_lines(text_slice, encoding='utf-8'):
  """Yield the complete '\\n'-separated lines owned by a slice.

  Ownership rule: a line belongs to the slice in which it *starts*. A slice
  whose start is mid-line skips to the next newline; a slice whose last line
  straddles its end reads past the end to finish that line. (Records with
  multi-byte delimiters go through :func:`read_records`.)
  """
  with open(text_slice.path, 'rb') as f:
    pos = text_slice.start
    if pos > 0:
      f.seek(pos - 1)
      prev = f.read(1)
      if prev != b'\n':
        # We started mid-line: the line belongs to the previous slice.
        chunk = f.readline()
        pos += len(chunk)
    else:
      f.seek(0)
    if pos >= text_slice.end:
      return
    # Chunked bulk reads with a carried remainder: the syscall win of
    # block reads at O(chunk) memory, not O(slice) (slices can be hundreds
    # of MB when few workers partition a large corpus).
    chunk_size = 8 << 20
    remaining = text_slice.end - pos
    # Newline-free chunks accumulate in a list (joined only once a newline
    # arrives), so a pathological single-line slice costs O(line) total
    # copying, not O(line * chunks).
    pending = []
    while remaining > 0:
      chunk = f.read(min(chunk_size, remaining))
      if not chunk:
        break
      remaining -= len(chunk)
      pending.append(chunk)
      if chunk.rfind(b'\n') < 0:
        continue
      data = b''.join(pending)
      nl = data.rfind(b'\n')
      pending = [data[nl + 1:]] if nl + 1 < len(data) else []
      for line in data[:nl].split(b'\n'):
        text = line.decode(encoding).rstrip('\r')
        if text.strip():
          yield text
    rem = b''.join(pending)
    if rem:
      # The final line straddles the slice end (or the file ends without a
      # newline): finish it, matching the ownership rule.
      rem += f.readline()
      for line in rem.split(b'\n'):
        text = line.decode(encoding).rstrip('\r')
        if text.strip():
          yield text
