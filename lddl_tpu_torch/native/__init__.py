"""Native host code of the port: the C++ WordPiece encoder.

A copy of the encoder of :mod:`lddl_tpu.native` (``src/wordpiece.cpp``),
built with the host's ``c++`` at first use (:mod:`.build`) and driven
through :mod:`ctypes` (:mod:`.wordpiece`). The JAX package's sentence
splitter, document encoder, decoder and pairing/masking kernels serve
preprocessing only and are not ported.
"""

from .build import library, library_path  # noqa: F401
from .wordpiece import NativeWordPiece  # noqa: F401
