"""The process settings of the port's test files (tests/test_torch_*.py),
shared by importing the fixture: `from torch_port_env import port_test_module`.

Beside the other test workers, torch's default of a thread a core
oversubscribes the CPU, so a port test file runs its port side on one
thread. A module's fixtures (JAX chains, train states) leave gigabytes of
freed memory in the C heap, which glibc keeps: after the module, the heap
is trimmed, so that the worker goes on to its next file, perhaps a
compile-heavy one of the JAX package, without holding it."""
import ctypes
import gc

import pytest
import torch


def _trim_heap() -> None:
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc
        pass


@pytest.fixture(autouse=True, scope="module")
def port_test_module():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _trim_heap()
