"""The port's ``run`` against the JAX CLI's: the same result keys for
DeepFM, DIN, DSSM, MMOE, LSTM and Transformer on the CPU; and ``main``, in
memory and out of core, with ``jax`` blocked."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from recommender_system_tpu import train as jtrain
from recommender_system_tpu.config import ExperimentConfig as JConfig
from recommender_system_tpu_torch import ExperimentConfig, train
from tests.test_torch_criteo_data import write_criteo_tsv

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(max_rows=320, epochs=1, batch_size=64, embedding_dim=4, hidden_units=(16, 8))


@pytest.mark.parametrize("model", ["deepfm", "din", "dssm", "mmoe", "lstm", "transformer"])
def test_run_returns_the_jax_keys(model):
    dataset = "synthetic_behavior" if model in ("din", "dssm") else "synthetic"
    got = train.run(ExperimentConfig(model=model, dataset=dataset, device="cpu", **SMALL))
    want = jtrain.run(JConfig(model=model, dataset=dataset, **SMALL))
    assert list(got) == list(want)
    assert len(got["train_loss"]) == len(want["train_loss"]) == 1
    assert all(np.isfinite(v) for k, v in got.items() if k not in ("model", "train_loss"))


def test_main_runs_with_jax_blocked(tmp_path):
    """The CLI, in memory and out of core, imports nothing of JAX."""
    tsv = write_criteo_tsv(tmp_path / "t.tsv", 600)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'recommender_system_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from recommender_system_tpu_torch.train import main\n"
        "main(['--device', 'cpu', '--model', 'deepfm', '--dataset', 'synthetic',\n"
        "      '--max-rows', '512', '--epochs', '1', '--batch-size', '128'])\n"
        f"main(['--device', 'cpu', '--stream', '--data-path', {tsv!r},\n"
        f"      '--stream-eval-path', {tsv!r}, '--fused-embedding', 'adagrad',\n"
        "      '--batch-size', '128', '--hash-buckets', '1000', '--epochs', '1',\n"
        "      '--stream-steps-per-call', '2', '--hidden-units', '16', '8'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert [sorted(r) for r in lines] == [
        ["accuracy", "auc", "examples_per_sec", "logloss", "model", "train_loss"],
        ["auc", "examples_per_sec", "logloss", "model", "train_loss"]]
