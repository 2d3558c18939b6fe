"""One PyTorch CPU thread while a port test file's tests run.

The port's CPU tests run small integer rounds, whose ops are too short
for PyTorch's intra-op thread pool to pay off. Under the suite's
``-p xdist -n 6`` each worker would start a pool of one thread per core,
and six such pools spinning on eight cores slow one another down many
times over (a round of a few ops a slot took 5x longer with 8 threads
than with 1, even alone). A port test file imports
:func:`one_torch_thread`; while that file's tests run, PyTorch uses one
intra-op thread, and the previous count is restored when the file ends.
The tests compare integer states and responses, which no thread count
changes.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
