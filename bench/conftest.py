"""pytest settings of the benchmark's CPU tests (``bench/tests``)."""
import pytest
import torch

# ``bench/out`` holds what runs leave behind, unpacked checkouts among them,
# whose test files would collide with these.
collect_ignore = ["out"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside other test workers, and a
    tiny run's window is not to be spent waiting on a thread pool's
    barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
