"""One intra-op torch thread for the port's CPU tests.

The tier-1 run puts six test processes (xdist workers) on the host's
cores, each with JAX's thread pool beside it; torch's default of one
thread a core in each of them oversubscribes the host, and every tiny
CPU step then waits on the others (a ledger test of a few seconds alone
took minutes under the run). A test file imports
:func:`torch_one_thread_a_file` (an autouse, module-scoped fixture),
which pins torch to one thread for the file and restores the count
after it.
Comparisons within a file are unaffected: both sides run at the same
count; the spawned rank processes set their own.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def torch_one_thread_a_file():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)
