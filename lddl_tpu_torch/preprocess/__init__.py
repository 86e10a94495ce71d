"""Preprocessors the port copies from :mod:`lddl_tpu.preprocess`: the BERT
pretraining preprocessor's fast engine (:mod:`.bert`)."""
