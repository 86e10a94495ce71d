"""Host utilities the port copies from :mod:`lddl_tpu.core`.

Its exports (``lddl_tpu.core``'s names) load at first access, so
importing a submodule such as :mod:`.faults` loads nothing else.
"""

_LAZY = {
    'File': 'types',
    'attach_bool_arg': 'utils',
    'deserialize_np_array': 'utils',
    'expand_outdir_and_mkdir': 'utils',
    'get_all_bin_ids': 'utils',
    'get_all_files_paths_under': 'utils',
    'get_all_parquets_under': 'utils',
    'get_all_txt_files_under': 'utils',
    'get_file_paths_for_bin_id': 'utils',
    'get_num_samples_of_parquet': 'utils',
    'parse_str_of_num_bytes': 'utils',
    'serialize_np_array': 'utils',
}


def __getattr__(name):
  module = _LAZY.get(name)
  if module is None:
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
  import importlib
  return getattr(importlib.import_module(f'.{module}', __name__), name)
