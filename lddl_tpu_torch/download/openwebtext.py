"""OpenWebText downloader: gdown fetch -> nested .xz untar -> page shards.

The port's :mod:`lddl_tpu.download.openwebtext` (reference
``lddl/download/openwebtext.py``: Google
Drive archive of per-subset ``.xz`` tarballs, each holding page text
files; reference ``openwebtext.py:100,127-167``).
"""

import argparse
import glob
import os
import subprocess

from ..core.utils import attach_bool_arg
from .utils import shard_text_files_parallel

_GDRIVE_URL = ('https://drive.google.com/uc?id='
               '1EA5V0oetDCOke7afsktL_JDQ-ETtNOvx')


def gdown_fetch(url, path):
  try:
    import gdown
  except ImportError:
    raise RuntimeError('gdown is not installed; fetch the archive manually '
                       'and rerun with --no-download')
  gdown.download(url, path, quiet=False)


def unpack(archive_path, extract_dir):
  """Untar the top archive, then every nested ``*.xz`` subset tarball."""
  os.makedirs(extract_dir, exist_ok=True)
  subprocess.run(['tar', '-xf', archive_path, '-C', extract_dir], check=True)
  for sub in sorted(
      glob.glob(os.path.join(extract_dir, '**', '*.xz'), recursive=True)):
    subdir = os.path.splitext(sub)[0]
    os.makedirs(subdir, exist_ok=True)
    subprocess.run(['tar', '-xJf', sub, '-C', subdir], check=True)


def _parse_page_file(path):
  """One extracted page file -> a single (openweb-<name>, text) document."""
  name = os.path.splitext(os.path.basename(path))[0]
  with open(path, encoding='utf-8', errors='ignore') as f:
    yield f'openweb-{name}', f.read()


def read_pages(extract_dir):
  """Yield (openweb-<name>, text) for every extracted page ``.txt``."""
  for p in sorted(
      glob.glob(os.path.join(extract_dir, '**', '*.txt'), recursive=True)):
    yield from _parse_page_file(p)


def shard_pages(extract_dir, outdir, num_shards, num_workers=None):
  """Parallel scatter/concat sharding (reference pools page sharding too,
  ``openwebtext.py:160-167``)."""
  paths = sorted(
      glob.glob(os.path.join(extract_dir, '**', '*.txt'), recursive=True))
  return shard_text_files_parallel(paths, outdir, num_shards,
                                   _parse_page_file,
                                   num_workers=num_workers)


def attach_args(parser):
  parser.add_argument('--outdir', type=str, required=True)
  parser.add_argument('--url', type=str, default=_GDRIVE_URL)
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
  archive = os.path.join(outdir, 'openwebtext.tar.xz')
  extract_dir = os.path.join(outdir, 'extracted')
  source = os.path.join(outdir, 'source')
  if args.download:
    gdown_fetch(args.url, archive)
  if args.extract:
    unpack(archive, extract_dir)
  if args.shard:
    counts = shard_pages(extract_dir, source, args.num_shards,
                         num_workers=args.num_workers)
    print(f'sharded {sum(counts)} pages into {len(counts)} shards '
          f'under {source}')


if __name__ == '__main__':
  main()
