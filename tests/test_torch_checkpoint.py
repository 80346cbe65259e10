"""Checkpoint and resume of the port's ``Trainer``: a stream run through the
CLI, stopped, resumed and continued, ends bitwise where the uninterrupted
run ends (the dense optimizer's state and the fused slots included), and a
restored ``Trainer`` continues bitwise (BatchNorm statistics, Adam moments,
the fused slots ``()``, ``(acc,)`` and ``(m, v)``, the dropout
generator)."""
import copy
import os

import pytest
import torch

from recommender_system_tpu_torch import NFM, FusedAdagrad, FusedAdam, FusedSGD, Trainer
from recommender_system_tpu_torch.train import main
from recommender_system_tpu_torch.training import SGD, Adagrad, Adam
from recommender_system_tpu_torch.training.checkpoint import (FILE, latest_step,
                                                              restore_checkpoint,
                                                              save_checkpoint)
from recommender_system_tpu_torch.utils import datasets
from tests.test_torch_criteo_data import write_criteo_tsv

LR, BUCKETS, DIM, BATCH, K = 0.05, 500, 4, 64, 4
HIDDEN = (16, 8)
ROWS = 1100  # 17 batches of 64 an epoch


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return write_criteo_tsv(tmp_path_factory.mktemp("checkpoint") / "train.tsv", ROWS)


def _checkpoint(path):
    return torch.load(f"{path}/{latest_step(path)}/{FILE}", weights_only=True)


def _assert_bitwise(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_bitwise(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{where}/{i}")
    else:
        assert a == b, where


@pytest.mark.parametrize("optimizer,fused", [("adagrad", None), ("adagrad", "adagrad"),
                                             ("adam", "adam")])
def test_stream_resume_equals_the_uninterrupted_run(tsv, tmp_path, optimizer, fused):
    """Two epochs with the shuffle pool, 24 steps in all; the interrupted run
    stops at step 8 (checkpoints every 4) and resumes, skipping the batches
    it trained on."""
    argv = ["--device", "cpu", "--stream", "--data-path", tsv, "--batch-size", str(BATCH),
            "--hash-buckets", str(BUCKETS), "--embedding-dim", str(DIM), "--hidden-units",
            *map(str, HIDDEN), "--epochs", "2", "--stream-steps-per-call", str(K),
            "--stream-shuffle-rows", "200", "--stream-chunk-rows", "300", "--optimizer",
            optimizer, "--learning-rate", str(LR)]
    if fused:
        argv += ["--fused-embedding", fused]
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    main(argv + ["--stream-max-steps", "24", "--checkpoint-dir", whole])
    main(argv + ["--stream-max-steps", "8", "--checkpoint-every", "4", "--checkpoint-dir",
                 part])
    assert sorted(int(d) for d in os.listdir(part)) == [4, 8]
    main(argv + ["--stream-max-steps", "24", "--checkpoint-dir", part, "--resume"])
    a, b = _checkpoint(whole), _checkpoint(part)
    assert a["step"] == b["step"] == latest_step(whole) > 17
    if fused:
        assert len(a["fused_slots"]) == 1 and len(next(iter(a["fused_slots"].values()))) == \
            {"adagrad": 1, "adam": 2}[fused]
    _assert_bitwise(a, b)


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_restored_trainer_continues_bitwise(tmp_path, kind):
    """NFM with dropout (the generator's state), BatchNorm statistics, the
    dense optimizer's state and the fused slots ``()``, ``(acc,)``, ``(m,
    v)``: two steps after a restore equal two steps without one."""
    dense, fused = {"sgd": (SGD(0.01), FusedSGD(0.01)),
                    "adagrad": (Adagrad(LR), FusedAdagrad(LR)),
                    "adam": (Adam(1e-2), FusedAdam(1e-2))}[kind]
    cols, X, y = datasets.synthetic_criteo(n_rows=4 * BATCH, vocab=BUCKETS,
                                           embedding_dim=DIM, seed=4)

    def fresh():
        model = NFM(tuple(cols), hidden_units=HIDDEN, dropout_rate=0.3, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        return Trainer(model, copy.deepcopy(dense), fused_embedding=fused, device="cpu",
                       generator=torch.Generator().manual_seed(9))

    batches = list(datasets.iter_batches(X, y, BATCH, shuffle=False))
    original = fresh()
    for xb, yb in batches[:2]:
        original.train_step(original._to_device(xb), torch.as_tensor(yb))
    save_checkpoint(str(tmp_path), original)
    restored = restore_checkpoint(str(tmp_path), fresh())
    assert restored.step == 2
    for trainer in (original, restored):
        for xb, yb in batches[2:]:
            trainer.train_step(trainer._to_device(xb), torch.as_tensor(yb))
    save_checkpoint(str(tmp_path / "a"), original)
    save_checkpoint(str(tmp_path / "b"), restored)
    _assert_bitwise(_checkpoint(str(tmp_path / "a")), _checkpoint(str(tmp_path / "b")))
    assert original.model.bn.running_mean.abs().sum() > 0


def test_a_generator_of_another_device_is_seeded_anew(tmp_path):
    """A checkpoint whose generator is of another device type (a CPU run
    restored on the card, or the reverse: their states differ in size)
    restores everything else and seeds the generator from ``seed + step``;
    one of the same type comes back as it was."""
    cols, X, y = datasets.synthetic_criteo(n_rows=2 * BATCH, vocab=BUCKETS,
                                           embedding_dim=DIM, seed=4)

    def fresh():
        model = NFM(tuple(cols), hidden_units=HIDDEN, dropout_rate=0.3, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        return Trainer(model, Adagrad(LR), device="cpu", seed=5,
                       generator=torch.Generator().manual_seed(9))

    original = fresh()
    xb, yb = next(datasets.iter_batches(X, y, BATCH, shuffle=False))
    original.train_step(original._to_device(xb), torch.as_tensor(yb))
    directory = save_checkpoint(str(tmp_path), original)
    restored = restore_checkpoint(str(tmp_path), fresh())
    assert torch.equal(restored.generator.get_state(), original.generator.get_state())
    saved = torch.load(f"{directory}/{FILE}", weights_only=True)
    saved["generator"] = torch.zeros(16, dtype=torch.uint8)  # a CUDA generator's size
    torch.save(saved, f"{directory}/{FILE}")
    restored = restore_checkpoint(str(tmp_path), fresh())
    assert restored.step == 1
    assert torch.equal(restored.generator.get_state(),
                       torch.Generator().manual_seed(5 + 1).get_state())
    _assert_bitwise({n: p.detach() for n, p in restored.model.named_parameters()},
                    {n: p.detach() for n, p in original.model.named_parameters()})
