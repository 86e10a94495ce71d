"""Common Crawl news downloader: news-please crawl -> article shards.

The port's :mod:`lddl_tpu.download.common_crawl` (reference
``lddl/download/common_crawl.py``: news-please
``commoncrawl_crawler`` over CC-NEWS WARCs with date/language filters, a
streaming article writer, then shard aggregation; reference
``common_crawl.py:326-483``). The crawler dependency is gated; the article
sink + sharding are plain functions so the pipeline stays testable.
"""

import argparse
import datetime
import glob
import os
import threading
import uuid

from ..core.utils import attach_bool_arg


class ArticleSink:
  """Thread- and process-safe streaming writer: news-please invokes the
  callback from many threads (and, with ``number_of_extraction_processes
  > 1``, from forked worker processes); each (process, thread) appends to
  its own spool file (the reference uses a thread-local layout,
  ``common_crawl.py:310-352``, which silently loses worker-process
  buffers — here a forked child detects the pid change, drops the
  buffers it inherited (the parent owns flushing those), namespaces its
  spool files and doc ids by a per-process unique token (a recycled pid
  alone would collide: the spool file would be reopened in append mode
  with the doc counter restarted, duplicating ids), and registers its
  own exit flush)."""

  def __init__(self, spool_dir, articles_per_flush=512):
    self._dir = spool_dir
    os.makedirs(spool_dir, exist_ok=True)
    self._local = threading.local()
    self._per_flush = articles_per_flush
    self._count = 0
    self._lock = threading.Lock()
    self._all_buffers = []  # [(buf, path)] so a final flush sees every thread
    self._pid = os.getpid()
    self._ns = uuid.uuid4().hex[:12]
    # Never replaced after construction (unlike _lock, which a post-fork
    # reset swaps), so it can safely serialize the reset itself. The
    # parent only ever acquires it here in __init__-time registration
    # paths, so it cannot be held across a fork.
    self._reset_lock = threading.Lock()
    self._register_exit_flush()

  def _register_exit_flush(self):
    import atexit
    atexit.register(self.flush)
    # multiprocessing children skip atexit (they leave via
    # util._exit_function), but that path does run Finalize callbacks with
    # an exitpriority — needed because news-please's extraction workers
    # are multiprocessing processes.
    import multiprocessing.util as mp_util
    mp_util.Finalize(self, type(self).flush, args=(self,), exitpriority=10)

  def _check_fork(self):
    if os.getpid() == self._pid:
      return
    # Double-checked under a lock that is itself never swapped: two
    # threads making the child's first callbacks concurrently must not
    # both run the reset (the loser would discard the winner's
    # freshly-registered buffer, losing its articles).
    with self._reset_lock:
      pid = os.getpid()
      if pid == self._pid:
        return
      self._all_buffers = []
      self._count = 0
      self._local = threading.local()
      self._lock = threading.Lock()
      self._ns = uuid.uuid4().hex[:12]  # fresh namespace: pids recycle
      self._register_exit_flush()
      self._pid = pid  # last: gates the unsynchronized fast path

  def _thread_buffer(self):
    buf = getattr(self._local, 'buf', None)
    if buf is None:
      self._local.buf = buf = []
      self._local.path = os.path.join(
          self._dir, f'articles-{self._ns}-{threading.get_ident()}.txt')
      with self._lock:
        self._all_buffers.append((buf, self._local.path))
    return buf

  def __call__(self, article):
    text = getattr(article, 'maintext', None) or ''
    title = getattr(article, 'title', '') or ''
    if not text:
      return
    self._check_fork()
    buf = self._thread_buffer()
    with self._lock:
      self._count += 1
      idx = self._count
    one_line = ' '.join((title + ' ' + text).split())
    buf.append(f'ccnews-{self._ns}-{idx} {one_line}\n')
    if len(buf) >= self._per_flush:
      self._write(buf, self._local.path)

  @staticmethod
  def _write(buf, path):
    with open(path, 'a', encoding='utf-8') as f:
      f.writelines(buf)
    buf.clear()

  def flush(self):
    """Flush every thread's pending buffer (call once after the crawl)."""
    with self._lock:
      for buf, path in self._all_buffers:
        if buf:
          self._write(buf, path)


def crawl(spool_dir, start_date, end_date, languages=('en',),
          articles_per_flush=512, valid_hosts=None, warc_dir=None,
          strict_date=True, reuse_previously_downloaded_files=True,
          continue_after_error=True, show_download_progress=False,
          delete_warc_after_extraction=True, continue_process=True,
          number_of_extraction_processes=1):
  """Crawl CC-NEWS WARCs into the spool (reference
  ``common_crawl.py:452-483``): host filters, WARC reuse/idempotence, and
  crash resume (``continue_process`` restarts extraction from the last
  fully downloaded but unextracted WARC) all forward to news-please."""
  try:
    from newsplease.crawler import commoncrawl_crawler
  except ImportError:
    raise RuntimeError(
        'news-please is not installed; install it or provide pre-crawled '
        'article files and rerun with --no-crawl')
  sink = ArticleSink(spool_dir, articles_per_flush)
  commoncrawl_crawler.crawl_from_commoncrawl(
      sink,
      valid_hosts=valid_hosts,
      start_date=start_date,
      end_date=end_date,
      language=list(languages),
      strict_date=strict_date,
      reuse_previously_downloaded_files=reuse_previously_downloaded_files,
      local_download_dir_warc=warc_dir,
      continue_after_error=continue_after_error,
      show_download_progress=show_download_progress,
      number_of_extraction_processes=number_of_extraction_processes,
      delete_warc_after_extraction=delete_warc_after_extraction,
      continue_process=continue_process,
      fetch_images=False,
  )
  sink.flush()


def _read_one_spool(path):
  """Yield (doc_id, text) out of one spool file (top-level so the parallel
  sharder can pickle it)."""
  with open(path, encoding='utf-8') as f:
    for line in f:
      parts = line.split(None, 1)
      if len(parts) == 2:
        yield parts[0], parts[1]


def read_spools(spool_dir):
  """Yield (doc_id, text) back out of the spool files."""
  for p in sorted(glob.glob(os.path.join(spool_dir, 'articles-*.txt'))):
    yield from _read_one_spool(p)


def shard_spools(spool_dir, outdir, num_shards, num_workers=None):
  """Aggregate spool files into shards, one worker per output shard (the
  reference aggregates with a process pool too, ``common_crawl.py:425-426``)."""
  from .utils import shard_text_files_parallel
  paths = sorted(glob.glob(os.path.join(spool_dir, 'articles-*.txt')))
  return shard_text_files_parallel(paths, outdir, num_shards,
                                   _read_one_spool,
                                   num_workers=num_workers)


def attach_args(parser):
  parser.add_argument('--outdir', type=str, required=True)
  parser.add_argument('--start-date', type=str, default='2020-01-01')
  parser.add_argument('--end-date', type=str, default='2020-02-01')
  parser.add_argument('--langs', type=str, default='en',
                      help='comma-separated language codes')
  parser.add_argument('--valid-hosts', type=str, nargs='*', default=None,
                      help='keep only articles from these hosts '
                           '(reference common_crawl.py:216-226)')
  parser.add_argument('--num-shards', type=int, default=256)
  parser.add_argument('--num-workers', type=int, default=None,
                      help='processes for shard aggregation '
                           '(default: all cores)')
  parser.add_argument('--articles-per-write', type=int, default=512)
  parser.add_argument('--number-of-extraction-processes', type=int,
                      default=1)
  attach_bool_arg(parser, 'crawl', default=True)
  attach_bool_arg(parser, 'shard', default=True)
  attach_bool_arg(
      parser, 'strict-date', default=True,
      help_str='discard articles whose publish date falls outside '
               '[start-date, end-date]')
  attach_bool_arg(
      parser, 'reuse-previously-downloaded-files', default=True,
      help_str='skip WARCs already present in <outdir>/warc (no integrity '
               'check, same caveat as the reference)')
  attach_bool_arg(
      parser, 'continue-after-error', default=True,
      help_str='keep crawling when news-please hits an error')
  attach_bool_arg(parser, 'show-download-progress', default=False)
  attach_bool_arg(
      parser, 'delete-warc-after-extraction', default=True,
      help_str='delete each WARC once its articles are extracted')
  attach_bool_arg(
      parser, 'continue-process', default=True,
      help_str='resume extraction from fully-downloaded but unextracted '
               'WARCs of a previous run (filters must be unchanged)')
  return parser


def main(args=None):
  parser = attach_args(argparse.ArgumentParser(description=__doc__))
  args = parser.parse_args(args)
  outdir = os.path.abspath(os.path.expanduser(args.outdir))
  spool = os.path.join(outdir, 'spool')
  source = os.path.join(outdir, 'source')
  if args.crawl:
    crawl(
        spool,
        datetime.datetime.fromisoformat(args.start_date),
        datetime.datetime.fromisoformat(args.end_date),
        languages=args.langs.split(','),
        articles_per_flush=args.articles_per_write,
        valid_hosts=args.valid_hosts,
        warc_dir=os.path.join(outdir, 'warc'),
        strict_date=args.strict_date,
        reuse_previously_downloaded_files=(
            args.reuse_previously_downloaded_files),
        continue_after_error=args.continue_after_error,
        show_download_progress=args.show_download_progress,
        delete_warc_after_extraction=args.delete_warc_after_extraction,
        continue_process=args.continue_process,
        number_of_extraction_processes=args.number_of_extraction_processes)
  if args.shard:
    counts = shard_spools(spool, source, args.num_shards,
                          num_workers=args.num_workers)
    print(f'sharded {sum(counts)} articles into {len(counts)} shards '
          f'under {source}')


if __name__ == '__main__':
  main()
