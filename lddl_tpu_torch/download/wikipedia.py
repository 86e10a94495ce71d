"""Wikipedia downloader: dump -> wikiextractor -> one-line docs -> shards.

The port's :mod:`lddl_tpu.download.wikipedia` (reference
``lddl/download/wikipedia.py``). Steps
(each independently skippable):
  1. download the ``<lang>wiki-latest-pages-articles`` dump;
  2. run wikiextractor (subprocess) to turn XML into ``<doc id=...>``
     blocks (reference ``wikipedia.py:112-128``);
  3. parse each extracted shard: drop the title line, flatten the article
     to one line ``wiki-<id> <text>`` (reference ``:48-74``), aggregate
     into ``source/<lang>/N.txt`` shards.
"""

import argparse
import glob
import os
import subprocess
import sys

from ..core.utils import attach_bool_arg
from .utils import download_file

_URLS = {
    'en': 'https://dumps.wikimedia.org/enwiki/latest/'
          'enwiki-latest-pages-articles.xml.bz2',
    'zh': 'https://dumps.wikimedia.org/zhwiki/latest/'
          'zhwiki-latest-pages-articles.xml.bz2',
}


def parse_extracted_shard(path):
  """Yield (doc_id, text) from one wikiextractor output file.

  Format: ``<doc id="..." ...>`` line, title line, body lines, ``</doc>``.
  The title line (first non-empty after the tag) is dropped, matching the
  reference (``wikipedia.py:55-70``).
  """
  doc_id, lines, saw_title = None, [], False
  with open(path, encoding='utf-8') as f:
    for line in f:
      line = line.strip()
      if line.startswith('<doc id='):
        quote = line.find('"')
        doc_id = line[quote + 1:line.find('"', quote + 1)]
        lines, saw_title = [], False
      elif line.startswith('</doc>'):
        if doc_id is not None and lines:
          yield f'wiki-{doc_id}', ' '.join(lines)
        doc_id = None
      elif doc_id is not None:
        if not saw_title:
          if line:
            saw_title = True  # drop the title
          continue
        if line:
          lines.append(line)


def extract_dump(dump_path, extract_dir, shard_size='128M'):
  """Run wikiextractor as a subprocess (reference ``wikipedia.py:112-128``)."""
  try:
    import wikiextractor  # noqa: F401
  except ImportError:
    raise RuntimeError(
        'wikiextractor is not installed; install it or skip with '
        '--no-extract and provide pre-extracted files')
  subprocess.run(
      [
          sys.executable, '-m', 'wikiextractor.WikiExtractor', dump_path,
          '--bytes', shard_size, '-o', extract_dir
      ],
      check=True)


def shard_extracted(extract_dir, outdir, num_shards, num_workers=None):
  """Parse + shard the wikiextractor output, one worker process per output
  shard (the reference shards via a multiprocessing.Pool too,
  ``wikipedia.py:84-85``; round 1 here was serial — a real bottleneck on a
  full dump)."""
  from .utils import shard_text_files_parallel
  paths = sorted(glob.glob(os.path.join(extract_dir, '**', 'wiki_*'),
                           recursive=True))
  return shard_text_files_parallel(paths, outdir, num_shards,
                                   parse_extracted_shard,
                                   num_workers=num_workers)


def attach_args(parser):
  parser.add_argument('--outdir', type=str, required=True)
  parser.add_argument('--lang', type=str, default='en',
                      choices=sorted(_URLS))
  parser.add_argument('--num-shards', type=int, default=256)
  parser.add_argument('--shard-size', type=str, default='128M',
                      help='wikiextractor shard size')
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
  dump = os.path.join(outdir, f'{args.lang}wiki.xml.bz2')
  extract_dir = os.path.join(outdir, 'extracted', args.lang)
  source = os.path.join(outdir, 'source', args.lang)
  if args.download:
    download_file(_URLS[args.lang], dump)
  if args.extract:
    extract_dump(dump, extract_dir, shard_size=args.shard_size)
  if args.shard:
    counts = shard_extracted(extract_dir, source, args.num_shards,
                             num_workers=args.num_workers)
    print(f'sharded {sum(counts)} articles into {len(counts)} shards '
          f'under {source}')


if __name__ == '__main__':
  main()
