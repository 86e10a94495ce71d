"""Token-id lookup the port copies from :mod:`lddl_tpu.tokenization`."""
