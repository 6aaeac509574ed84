"""The heavy port test modules' shared fixture: one intra-op torch thread
for a module's work.  A module takes it with one import::

    from _torch_threads import _one_torch_thread  # noqa: F401

(a fixture imported into a test module is collected there, and
``scope="module"`` gives each module its own setting and restore)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the CPU suite
    runs several workers on the host's cores, and torch's default of a
    thread a core in each of them oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
