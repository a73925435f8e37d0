"""Pytest settings for the PyTorch port's tests (tests/test_torch_*.py).

The port's test modules run on one torch thread. The suite runs several
pytest-xdist workers on the machine's cores, and torch's default of a
thread a core in each worker oversubscribes them: the train steps' many
small ops then wait on spinning thread pools, which made the train and
int8 serving benches 20-100 times slower and one 60-step train test take
minutes in place of seconds. Subprocesses that the tests start get the
same decision through their environment (tests/test_torch_multiprocess.py
`child_env`).

torch is imported only for those modules, so the JAX package's tests run
as before; the card's command (`--noconftest`) does not load this file.
"""

from pathlib import Path

import pytest

PORT_TESTS = Path(__file__).resolve().parent / "tests"


@pytest.fixture(autouse=True, scope="module")
def one_thread(request):
    """One torch thread while a port test module runs; the previous count
    is restored after it."""
    path = request.path.resolve()
    if path.parent != PORT_TESTS or not path.name.startswith("test_torch_"):
        yield
        return
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
