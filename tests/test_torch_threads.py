"""One intra-op torch thread for a heavy port test file.

The suite runs in parallel worker processes, and a pool of every core in
each of them oversubscribes the machine (spin-waiting pools made small
ops ~100x slower).  A file that imports `one_torch_thread` by name makes
it its own module-scoped autouse fixture: its torch ops run on one
thread, and the count is restored after its last test.  The thread
count changes no result the tests check.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for the importing file's tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_one_thread_inside_a_file_that_holds_the_fixture():
    assert torch.get_num_threads() == 1
