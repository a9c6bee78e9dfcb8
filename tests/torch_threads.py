"""A fixture for the port's test modules: under pytest-xdist, torch's
intra-op pool shares the cores with the other workers.

Each xdist worker is a process of its own, and torch sizes its OpenMP
pool to every core of the machine. With six workers on eight cores that
is six pools of eight threads, which spin between ops: code made of
many small ops (a Mamba scan, a CLI run of a smoke model) then runs tens
of times slower than alone. A test module imports the fixture
(`from torch_threads import share_cores  # noqa: F401`, which registers
it there), and its tests run with the cores divided among the workers;
the count is restored after the module. Outside xdist nothing
changes.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if not workers:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)
