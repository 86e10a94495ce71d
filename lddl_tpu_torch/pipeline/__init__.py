"""Host pipeline pieces the port copies from :mod:`lddl_tpu.pipeline`."""
