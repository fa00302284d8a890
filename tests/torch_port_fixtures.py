"""What every CPU test of the port runs under, decided here once. A test
file of the port takes it with one line:

    from torch_port_fixtures import one_thread  # noqa: F401

``one_thread`` is autouse and module-scoped, so it covers every test of
the file and the file's module-scoped set-ups (which it precedes: pytest
runs a scope's autouse fixtures first). The card's tests
(test_torch_port_cuda.py) do not take it: there no other test worker
shares the host."""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread, and ``OMP_NUM_THREADS=1`` for the
    processes a test starts (CLIs, exported artifacts, ranks); both
    restored afterwards. The test workers share the host's cores: with a
    thread per core each, their threads spend the run waiting on each
    other."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
