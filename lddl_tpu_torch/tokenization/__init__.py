"""WordPiece tokenization the port copies from :mod:`lddl_tpu.tokenization`:
the vocab map and the native encoder's front end."""
