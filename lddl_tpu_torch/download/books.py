"""BookCorpus downloader: books1.tar.gz -> untar -> one-book-per-line shards.

The port's :mod:`lddl_tpu.download.books` (reference
``lddl/download/books.py``: download
``books1.tar.gz``, untar via subprocess, round-robin whole books into
shards with the book file name as document id, one book flattened per
line; reference ``books.py:163-224``).
"""

import argparse
import glob
import os
import subprocess

from ..core.utils import attach_bool_arg
from .utils import download_file, shard_text_files_parallel

# Canonical public mirror (same dataset the reference fetches,
# books.py:38); often rate-limited — override with --url if needed.
_URL = ('https://the-eye.eu/public/AI/pile_preliminary_components/'
        'books1.tar.gz')


def _parse_book_file(path):
  """One extracted book file -> a single (book-<name>, text) document."""
  name = os.path.splitext(os.path.basename(path))[0]
  with open(path, encoding='utf-8', errors='ignore') as f:
    yield f'book-{name}', f.read()


def read_books(books_dir):
  """Yield (book-<name>, text) for every ``.epub.txt`` under books_dir."""
  paths = sorted(
      glob.glob(os.path.join(books_dir, '**', '*.txt'), recursive=True))
  for p in paths:
    yield from _parse_book_file(p)


def shard_books(books_dir, outdir, num_shards, num_workers=None):
  """Parallel scatter/concat sharding (one worker per input file batch;
  the reference shards books with a Pool too, ``books.py:186-187``)."""
  paths = sorted(
      glob.glob(os.path.join(books_dir, '**', '*.txt'), recursive=True))
  return shard_text_files_parallel(paths, outdir, num_shards,
                                   _parse_book_file,
                                   num_workers=num_workers)


def untar(tar_path, outdir):
  os.makedirs(outdir, exist_ok=True)
  subprocess.run(['tar', '-xzf', tar_path, '-C', outdir], check=True)


def attach_args(parser):
  parser.add_argument('--outdir', type=str, required=True)
  parser.add_argument('--url', type=str, default=_URL,
                      help='books1.tar.gz mirror URL')
  parser.add_argument('--num-shards', type=int, default=256)
  parser.add_argument('--num-workers', type=int, default=None,
                      help='processes for shard prep (default: all cores)')
  attach_bool_arg(parser, 'download', default=True)
  attach_bool_arg(parser, 'extract', default=True)
  attach_bool_arg(parser, 'shard', default=True)
  return parser


def main(args=None):
  parser = attach_args(argparse.ArgumentParser(description=__doc__))
  args = parser.parse_args(args)
  outdir = os.path.abspath(os.path.expanduser(args.outdir))
  tar_path = os.path.join(outdir, 'books1.tar.gz')
  extract_dir = os.path.join(outdir, 'extracted')
  source = os.path.join(outdir, 'source')
  if args.download:
    download_file(args.url, tar_path)
  if args.extract:
    untar(tar_path, extract_dir)
  if args.shard:
    counts = shard_books(extract_dir, source, args.num_shards,
                         num_workers=args.num_workers)
    print(f'sharded {sum(counts)} books into {len(counts)} shards '
          f'under {source}')


if __name__ == '__main__':
  main()
