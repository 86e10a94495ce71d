"""The command table of :mod:`lddl_tpu.cli`, over the port's modules.

Every name of ``lddl_tpu``'s table, each a thin delegate:

  download_wikipedia / download_books / download_common_crawl /
  download_open_webtext          -> lddl_tpu_torch.download.*
  prepare_codesearchnet          -> lddl_tpu_torch.download.codesearchnet
  preprocess_bert_pretrain       -> lddl_tpu_torch.preprocess.bert
  preprocess_bart_pretrain       -> lddl_tpu_torch.preprocess.bart
  preprocess_codebert_pretrain   -> lddl_tpu_torch.preprocess.codebert
  preprocess_packed_pretrain     -> lddl_tpu_torch.preprocess.packed
  pretrain_bert                  -> lddl_tpu_torch.training.pretrain
  balance_shards (balance_dask_output), generate_num_samples_cache
                                 -> lddl_tpu_torch.balance
  telemetry_report, telemetry_trace, lddl_monitor, lddl_perf,
  lddl_audit                     -> lddl_tpu_torch.telemetry.*
  lddl_data_server               -> lddl_tpu_torch.loader.service
  lddl_replay                    -> lddl_tpu_torch.replay.cli
  lddl_incident                  -> lddl_tpu_torch.training.flight
  lddl_analyze                   -> raises: the static analyzer
                                    (lddl_tpu/analysis/) is not ported
                                    (ROADMAP, Queue 1)

and the dash-form aliases. Run as ``python -m lddl_tpu_torch.cli <name>
[args...]``; the installed console scripts stay ``lddl_tpu``'s.
"""

import sys


def download_wikipedia(args=None):
  from .download.wikipedia import main
  return main(args)


def download_books(args=None):
  from .download.books import main
  return main(args)


def download_common_crawl(args=None):
  from .download.common_crawl import main
  return main(args)


def download_open_webtext(args=None):
  from .download.openwebtext import main
  return main(args)


def preprocess_bert_pretrain(args=None):
  from .preprocess.bert import main
  return main(args)


def preprocess_bart_pretrain(args=None):
  from .preprocess.bart import main
  return main(args)


def preprocess_codebert_pretrain(args=None):
  from .preprocess.codebert import main
  return main(args)


def preprocess_packed_pretrain(args=None):
  from .preprocess.packed import main
  return main(args)


def prepare_codesearchnet(args=None):
  from .download.codesearchnet import main
  return main(args)


def pretrain_bert(args=None):
  from .training.pretrain import main
  return main(args)


def balance_shards(args=None):
  from .balance import main
  return main(args)


def generate_num_samples_cache(args=None):
  from .balance import cache_main
  return cache_main(args)


def telemetry_report(args=None):
  from .telemetry.report import main
  return main(args)


def telemetry_trace(args=None):
  from .telemetry.trace import main
  return main(args)


class AnalyzerNotPorted(NotImplementedError):
  """``lddl_analyze``: the static analyzer is not ported."""


def lddl_analyze(args=None):
  del args
  raise AnalyzerNotPorted(
      'lddl_analyze: the static analyzer (lddl_tpu/analysis/) is not ported '
      'to lddl_tpu_torch yet (ROADMAP, Queue 1: analysis/); run python -m '
      'lddl_tpu.cli lddl_analyze')


def lddl_monitor(args=None):
  from .telemetry.monitor import main
  return main(args)


def lddl_perf(args=None):
  from .telemetry.perf import main
  return main(args)


def lddl_audit(args=None):
  from .telemetry.audit import main
  return main(args)


def lddl_data_server(args=None):
  from .loader.service import main
  return main(args)


def lddl_replay(args=None):
  from .replay.cli import main
  return main(args)


def lddl_incident(args=None):
  from .training.flight import main
  return main(args)


_COMMANDS = {
    'download_wikipedia': download_wikipedia,
    'download_books': download_books,
    'download_common_crawl': download_common_crawl,
    'download_open_webtext': download_open_webtext,
    'preprocess_bert_pretrain': preprocess_bert_pretrain,
    'preprocess_bart_pretrain': preprocess_bart_pretrain,
    'preprocess_codebert_pretrain': preprocess_codebert_pretrain,
    'preprocess_packed_pretrain': preprocess_packed_pretrain,
    'prepare_codesearchnet': prepare_codesearchnet,
    'pretrain_bert': pretrain_bert,
    'balance_shards': balance_shards,
    'balance_dask_output': balance_shards,  # the reference's name
    'generate_num_samples_cache': generate_num_samples_cache,
    'telemetry_report': telemetry_report,
    'telemetry-report': telemetry_report,
    'telemetry_trace': telemetry_trace,
    'telemetry-trace': telemetry_trace,
    'lddl_analyze': lddl_analyze,
    'lddl-analyze': lddl_analyze,
    'lddl_monitor': lddl_monitor,
    'lddl-monitor': lddl_monitor,
    'lddl_perf': lddl_perf,
    'lddl-perf': lddl_perf,
    'lddl_audit': lddl_audit,
    'lddl-audit': lddl_audit,
    'lddl_data_server': lddl_data_server,
    'lddl-data-server': lddl_data_server,
    'lddl_replay': lddl_replay,
    'lddl-replay': lddl_replay,
    'lddl_incident': lddl_incident,
    'lddl-incident': lddl_incident,
}


def main(argv=None):
  """Run ``argv[0]`` (default ``sys.argv[1:]``) with the rest as its
  arguments; an unknown or missing name prints the table, exit 2. A
  command's integer return is the exit code, anything else 0."""
  argv = sys.argv[1:] if argv is None else list(argv)
  if not argv or argv[0] not in _COMMANDS:
    names = '\n  '.join(sorted(_COMMANDS))
    print(f'usage: python -m lddl_tpu_torch.cli <command> [args...]\n'
          f'commands:\n  {names}')
    return 2
  rc = _COMMANDS[argv[0]](argv[1:])
  return rc if type(rc) is int else 0


if __name__ == '__main__':
  sys.exit(main())
