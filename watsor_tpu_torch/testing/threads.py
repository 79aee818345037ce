"""The port's tests in one torch thread: their small shapes gain nothing
from more, and in a parallel test run an OpenMP team of one thread a core
stalls at every barrier while the other workers hold the cores.

A test module takes the fixture by importing it::

    from watsor_tpu_torch.testing.threads import one_torch_thread  # noqa
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One torch thread for the module's tests, then the earlier count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
