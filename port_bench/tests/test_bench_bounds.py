"""The frozen arithmetic gives chip_smoke.py's figures where the two agree,
and counts only the least work."""
import numpy as np
import pytest

from port_bench import bounds
from port_bench.models import deepfm, din
from port_bench import harness


def test_din_backward_bound_at_dins_shape():
    ms, by = bounds.din_backward_bound(8192, 50, 32, 80, 40, positions=224_750)
    assert by == "operations" and ms == pytest.approx(0.04795, abs=5e-6)


def test_adagrad_bound_on_bench_stream():
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    _, X, _ = synthetic_criteo(n_rows=16384, vocab=100_000, embedding_dim=8, seed=0)
    rows = np.stack([X[f"C{f + 1}"].astype(np.int64) + f * 100_000 for f in range(26)], 1)
    ms, by = bounds.sparse_rows_bound(rows.size, len(np.unique(rows)), 9, "adagrad")
    assert by == "bytes" and ms == pytest.approx(0.02248, abs=5e-6)


def test_forward_bound_counts_unmasked_positions_only():
    full, _ = bounds.din_forward_bound(8192, 50, 32, 80, 40, positions=8192 * 50)
    half, _ = bounds.din_forward_bound(8192, 50, 32, 80, 40, positions=8192 * 25)
    assert half < 0.6 * full
    # all positions: within chip_smoke.py's din_bound, which also reads masked keys
    assert full <= 0.02947


def test_step_flops():
    cfg = harness.load_cell("deepfm.train.criteo").config
    stats = {"batch": 16384}
    assert deepfm.step_flops(cfg, stats) / 16384 == 3 * 2 * (273 * 400 + 400 * 400 * 2
                                                             + 400)
    cfg = harness.load_cell("din.train.electronics").config
    stats = {"batch": 8192, "K": 128, "H1": 80, "H2": 40, "positions": 42_000}
    fwd = (2 * 42_000 * (128 * 80 + 80 * 40 + 40) + 2 * 8192 * 2 * 128 * 80
           + 2 * 42_000 * 128 + 2 * 8192 * (256 * 80 + 80 * 40 + 40))
    assert din.step_flops(cfg, stats) == 3 * fwd
