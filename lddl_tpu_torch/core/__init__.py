"""Host utilities the port copies from :mod:`lddl_tpu.core`."""
