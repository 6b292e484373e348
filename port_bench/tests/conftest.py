"""Tests of the benchmark itself.  ``gpu`` tests need a CUDA card and
skip without one; whether there is one is decided inside the fixture."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)            # the tiny solves; workers share cores
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device and nvcc (the port's kernels)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: measured on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def tiny() -> dict:
    """The 16x16 configuration cut to a CPU test's size: the same solver
    and limits at 4 x 4 antennas and 64 probes."""
    with open(ROOT / "port_bench" / "configs" / "a2_16x16_m1024.json") as f:
        config = json.load(f)
    config.update(nt=4, nr=4, m=64)
    return config


TINY_TRAFFIC = {
    "batch": {"entry": "batch", "batch": 4, "paths": 2, "angle_rad": 1.2},
    "single": {"entry": "single", "paths": 2, "angle_rad": 1.2},
}
