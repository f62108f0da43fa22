"""A module-scoped fixture shared by the port's CPU label and VAD tests.

A test module takes it with ``from torch_threads import one_torch_thread``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the importing module. The port's CPU decode
    loop is many small ops, and each op above torch's grain size runs as an
    OpenMP team of all cores, which stalls for whole scheduler slices when
    the suite's parallel workers oversubscribe the CPU: one label run took
    83 s with the default 8 threads and 3 s with one, on an 8-core host
    beside 10 busy processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
