"""The benchmark's CPU tests: cells cut to a size a test run holds."""
import copy
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from port_bench import harness  # noqa: E402

TINY_VOCAB = 300
TINY_BATCH = 64
TINY_K = 4
TINY_T = 12


def tiny(cell: harness.Cell) -> harness.Cell:
    """``cell`` at a size the CPU holds: small vocabularies, batch and
    history; the widths and the traffic's laws as they are."""
    cell = copy.deepcopy(cell)
    cfg = cell.config
    for col in cfg["columns"]:
        if "vocab" in col:
            col["vocab"] = min(col["vocab"], TINY_VOCAB)
    cfg["batch"], cfg["steps_per_call"] = TINY_BATCH, TINY_K
    if "history" in cell.traffic:
        cell.traffic["history"]["maxlen"] = TINY_T
    return cell


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
    return torch.device("cuda")
