"""A fixture for the port's CPU tests that run frames of some size.

Test workers that run side by side each hold an OpenMP team as wide as the
machine. On the elementwise operations of a 256x144 frame's plain raster
the teams stall one another at their barriers, and two such tests together
take many minutes where each alone takes seconds. One thread a worker has
no barriers. Import the fixture into a test module to apply it there:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
