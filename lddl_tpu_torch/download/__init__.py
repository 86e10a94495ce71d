"""Corpus downloaders: the port's :mod:`lddl_tpu.download`.

Each downloader is a multi-step CLI (``--no-download`` / ``--no-extract``
/ ``--no-shard`` toggles) whose product is a ``source/`` directory of
``.txt`` shards, one document per line, the first whitespace-separated
token the document id: what :mod:`lddl_tpu_torch.preprocess` reads. The
offline steps (sharding extracted or crawled files, CodeSearchNet's
split, extract and shard) write ``lddl_tpu``'s bytes from the same input.

The network and third-party tools (requests, wikiextractor, news-please,
gdown) are imported where a step needs them, as in ``lddl_tpu``, and an
absent one raises a named error, so the offline steps run on a machine
without them. Process pools start from the forkserver, as the port's
loader and worker pool do.
"""

from .utils import download_file, shard_documents

__all__ = ['download_file', 'shard_documents']
