"""A run on the CPU at the tests' size: the result line's keys, the check
against the reference, the control and the planted faults coming out not
correct, and the guards of the command line."""
import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import tiny
from port_bench import harness

CELLS = ["deepfm.train.criteo", "din.train.electronics"]
BENCH_DIR = harness.BENCH
OPTIMIZERS = {
    "adam": ({"name": "adam", "learning_rate": 0.001, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
             {"name": "lazy_adam", "learning_rate": 0.001, "b1": 0.9, "b2": 0.999,
              "eps": 1e-8}),
    "adagrad": ({"name": "adagrad", "learning_rate": 0.05, "initial_accumulator_value": 0.1,
                 "eps": 1e-7},
                {"name": "adagrad", "learning_rate": 0.05, "initial_accumulator_value": 0.1,
                 "eps": 1e-7}),
    "sgd": ({"name": "sgd", "learning_rate": 0.5}, {"name": "sgd", "learning_rate": 0.5}),
}


def run_cpu(name, traced=False, seed=5):
    return harness.run(tiny(harness.load_cell(name)), seed, 0.2, traced, time.time(),
                       device="cpu")


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(traced):
    out = run_cpu("deepfm.train.criteo", traced)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "compared"
    assert set(out["compared"]) == {"loss_gap", "change_gap", "state_gap"}
    assert all(set(v) == {"value", "limit"} for v in out["compared"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    if traced:
        assert {"train_mfu", "trainer.host_ms_per_call", "train_step_p95_ms"} <= set(
            out["metrics"])
    else:
        assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}
    json.dumps(out)


@pytest.mark.parametrize("name,rules", [(c, r) for c in CELLS for r in (None, *OPTIMIZERS)])
def test_reference_follows_the_port(name, rules):
    """The port's steps through set-up's three calls against the plain
    reference at the tests' size, with the cell's optimizers and with each
    pair the reference knows: float32 cells to rounding, DeepFM's bfloat16
    tower within the cell's limits."""
    cell = tiny(harness.load_cell(name))
    if rules is not None:
        cell.config["optimizer"], cell.config["embedding_optimizer"] = OPTIMIZERS[rules]
    program = harness.set_up(cell, 11, "cpu")
    ref = harness.follow_reference(cell, 11, "cpu")
    got = harness.numbers(program.readings, ref)
    assert len(ref["losses"]) == harness.CHECK_CALLS * cell.config["steps_per_call"]
    assert ("state_gap" in got) == (cell.config["optimizer"]["name"] != "sgd")
    if cell.config["tower_dtype"] == "float32":
        assert got["loss_gap"][0] < 1e-6
        assert all(got[n][0] < 1e-5 for n in ("change_gap", "state_gap") if n in got), got
    else:
        # the bfloat16 tower's rounding flips apart after a few steps, even on
        # the CPU: held to the cell's limits
        assert harness.judge(cell, got)[0], got


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference one step below the stated precision, in the program's
    place, fails the cell's limits."""
    cell = tiny(harness.load_cell(name))
    control = harness.follow_reference(cell, 12, "cpu", control=True)
    correct, compared = harness.judge(
        cell, harness.numbers(control, harness.follow_reference(cell, 12, "cpu")))
    assert not correct, compared


def _losses():
    return __import__("recommender_system_tpu_torch.training.losses", fromlist=["x"])


def _half_batch(mp):
    f = _losses().bce_with_logits

    def loss(logits, labels, weights=None):
        half = labels.shape[0] // 2
        return f(logits[:half], labels[:half])
    mp.setattr(f"{LOSSES}.bce_with_logits", loss)


def _answer_altered(mp):
    """One answer a step altered where it is produced: the first row's logit
    off by one."""
    f = _losses().bce_with_logits
    mp.setattr(f"{LOSSES}.bce_with_logits",
               lambda logits, labels, weights=None: f(
                   torch.cat([logits[:1] + 1.0, logits[1:]]), labels))


def _state_unchanged(mp):
    for rule in (f"{OPTIM}.SGD", f"{OPTIM}.Adam", f"{OPTIM}.Adagrad", f"{TRAINING}.FusedSGD",
                 f"{TRAINING}.FusedAdam", f"{TRAINING}.FusedAdagrad"):
        mp.setattr(f"{rule}.{'update' if rule.startswith(OPTIM) else 'apply'}",
                   lambda self, *a, **k: None)


def _slots_not_written(mp):
    """The optimizers update the parameters from their slots but never store
    the slots: an accumulator or a moment never updated."""
    from recommender_system_tpu_torch.training import harness as trainer_module, optim

    dense, fused = optim.Adam.update, trainer_module.FusedAdam.apply

    def update(self, params, grads, state, step, scalars=None):
        dense(self, params, grads, {n: {k: v.clone() for k, v in s.items()}
                                    for n, s in state.items()}, step, scalars)

    def apply(self, table, slots, *a, **k):
        fused(self, table, tuple(s.clone() for s in slots), *a, **k)
    mp.setattr(f"{OPTIM}.Adam.update", update)
    mp.setattr(f"{TRAINING}.FusedAdam.apply", apply)


def _bias_unchanged(mp):
    """The dense optimizer leaves every bias as it is."""
    from recommender_system_tpu_torch.training import optim

    for rule in (optim.SGD, optim.Adam):
        def update(self, params, *a, _inner=rule.update, **k):
            _inner(self, {n: p for n, p in params.items() if not n.endswith(".bias")}, *a, **k)
        mp.setattr(rule, "update", update)


def _inputs_not_copied(mp):
    """Every call after the first trains on the first call's batches, as a
    graph whose inputs are never copied in would."""
    from recommender_system_tpu_torch.training import Trainer

    inner, first = Trainer.multi_step, {}

    def multi_step(self, batches, labels):
        first.setdefault(id(self), (batches, labels))
        return inner(self, *first[id(self)])
    mp.setattr(Trainer, "multi_step", multi_step)


def _stale_scalars(mp):
    """Every call reads the first step's scalars (learning rate, bias
    corrections), as a graph whose scalar table is never refreshed would."""
    from recommender_system_tpu_torch.training import Trainer

    inner = Trainer._stage_scalars

    def stage(self, k, out=None):
        step, self.step = self.step, 0
        try:
            return inner(self, k, out)
        finally:
            self.step = step
    mp.setattr(Trainer, "_stage_scalars", stage)


LOSSES = "recommender_system_tpu_torch.training.losses"
OPTIM = "recommender_system_tpu_torch.training.optim"
TRAINING = "recommender_system_tpu_torch.training.harness"
# each fault planted in the program, and the cells that can have it
FAULTS = {
    "state_unchanged": (_state_unchanged, CELLS),
    "half_batch": (_half_batch, CELLS),
    "answer_altered": (_answer_altered, CELLS),
    "slots_not_written": (_slots_not_written, ["deepfm.train.criteo"]),
    "bias_unchanged": (_bias_unchanged, CELLS),
    "inputs_not_copied": (_inputs_not_copied, CELLS),
    "stale_scalars": (_stale_scalars, ["deepfm.train.criteo"]),
}


@pytest.mark.parametrize("name,fault", [(c, f) for f, (_, cells) in sorted(FAULTS.items())
                                        for c in cells])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """A whole run (the look for a card skipped) with the timed path broken
    underneath comes out not correct."""
    FAULTS[fault][0](monkeypatch)
    out = run_cpu(name)
    assert out["correct"] is False, out["compared"]


def test_imports_name_no_jax_module():
    """No module of port_bench imports jax, jaxlib, flax or the JAX package,
    compared by whole top-level name (the port's own name begins with the
    JAX package's)."""
    found = set()
    for path in BENCH_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                found |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                found.add(node.module.split(".")[0])
    assert not found & set(harness.FORBIDDEN), found & set(harness.FORBIDDEN)
    assert "recommender_system_tpu_torch" in found


def test_a_run_loads_no_jax_module():
    code = ("import sys, time; sys.path.insert(0, 'port_bench/tests'); sys.path.insert(0, '.');"
            "from conftest import tiny; from port_bench import harness;"
            "harness.run(tiny(harness.load_cell('din.train.electronics')), 3, 0.1, True,"
            " time.time(), device='cpu');"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax',"
            " 'recommender_system_tpu', 'recommender_system_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip().splitlines()[-1]
    assert out == "['recommender_system_tpu_torch']"


def test_command_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    got = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "din.train.electronics", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert got.returncode == 2 and got.stdout == ""


def test_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and port_bench/, a run
    exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "din.train.electronics", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and not got.stdout.strip()


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    """One short run of each cell on the card comes out correct."""
    got = subprocess.run([sys.executable, "port_bench/run.py", "--workload", name,
                          "--seed", "77", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["correct"] is True
