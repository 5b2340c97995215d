"""What the modules ``test_portbench_suite_*.py`` share, which bring the
benchmark's own tests (``portbench/tests``) into this suite: pytest's
assertion rewriting for those modules, and ``one_torch_thread``."""

import pytest
import torch

pytest.register_assert_rewrite("portbench.tests")


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """Each benchmark test on one torch thread, and the processes it starts
    too (``OMP_NUM_THREADS``). The suite's workers share the machine's
    cores, and under that load each of the harness's small torch operations
    waits for a team of threads: the refine cell's CPU run took 188 s beside
    six busy processes on eight cores, and 10 s on one thread."""
    threads = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
