"""A module-scoped autouse fixture for test files whose reduced models run
many tiny CPU ops one after another (engine runs of 2-layer configs):
imported into such a file, it gives the file's tests one intra-op thread
and restores the count after them. Torch's default, a thread per core in
every worker of the parallel suite (``xdist -n 6``), has the workers' pools
spin on each other's cores; on an 8-core machine the file's summed time
was about 10x its single-thread time."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
