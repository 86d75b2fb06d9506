"""Torch's intra-op threads while a port test file runs.

Tier-1 runs the test files in several pytest-xdist workers at once, one
file a worker at a time.  Torch's CPU kernels start one OpenMP thread per
core by default, so W workers run W x cores threads that spin against
each other on the same cores: the port's files took twice their time for
it (one measurement on an 8-core host, 6 workers: 1337 s of test time for
the six slowest files, 621 s at 2 threads).  Under xdist each port test
file therefore runs at cores / workers threads (at least 2), and the
count is put back after the file; run alone, a file keeps torch's
default.

A port test file uses it with `from torch_threads import torch_threads
# noqa: F401` (an autouse fixture of module scope)."""

import os

import pytest
import torch


def _threads():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(2, (os.cpu_count() or 2) // int(workers))


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = _threads()
    if n is None:
        yield
        return
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
