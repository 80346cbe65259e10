"""The training CLI (counterpart of ``recommender_system_tpu/train.py``).

Usage, on the card (``--device cpu`` runs on the CPU):

    python -m recommender_system_tpu_torch.train --model deepfm --dataset criteo \\
        --data-path train.txt --hash-buckets 50000 --epochs 2
    python -m recommender_system_tpu_torch.train --model din --dataset movielens
    python -m recommender_system_tpu_torch.train --model dssm --dataset synthetic_behavior
    python -m recommender_system_tpu_torch.train --stream --data-path train.txt \\
        --fused-embedding adagrad --batch-size 16384 --hash-buckets 1000000 \\
        --stream-eval-path heldout.txt

Loads the dataset, builds the model from ``ExperimentConfig``, trains it
through ``Trainer`` and prints one JSON line with the JAX CLI's keys: the
model, the training losses, examples/s and the test metrics (AUC, logloss,
accuracy; per task for MMOE; recall@10 for DSSM). ``--stream`` trains out of
core over a Criteo-format TSV through the native parser. Checkpoints go to
``--checkpoint-dir`` (``--resume`` continues from the latest);
``--profile-dir`` writes a ``torch.profiler`` trace of the training loop.
``--mesh-data N`` trains over N ranks under ``torchrun`` (the README's
multi-chip command), one rank a card, the tables sharded by row:

    torchrun --nproc-per-node 8 -m recommender_system_tpu_torch.train \
        --model deepfm --mesh-data 8 --fused-embedding adagrad \
        --explicit-lookup --capacity-factor 2.0

``--mesh-model M`` adds a model axis of M consecutive ranks (``torchrun
--nproc-per-node N*M``): MMOE's experts split over it and, under the plain
step without ``--explicit-lookup``, tables of dim >= 64 split by column.
Every rank runs the whole program on its rows of each batch; rank 0 prints
the result and writes the checkpoints. ``--explicit-lookup`` and
``--capacity-factor`` act with a mesh only, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from .config import ExperimentConfig

SEQUENCE_MODELS = {"din", "dien"}
TOKEN_MODELS = {"lstm", "transformer"}


def build_data(config: ExperimentConfig):
    """-> (columns, X_train, y_train, X_test, y_test), as the JAX CLI builds
    them. Without a ``data_path`` (or with one that does not exist) the
    Criteo and MovieLens datasets fall back to their synthetic stand-ins,
    as the JAX CLI does where its default files are missing."""
    from .utils import datasets as D

    name = config.dataset
    if name == "synthetic_tokens" or config.model in TOKEN_MODELS:
        rng = np.random.default_rng(config.seed)
        vocab = config.hash_buckets or 200
        n = config.max_rows or 4096
        T = max(config.seq_len, 8)
        X = rng.integers(1, vocab, (n, T)).astype(np.int32)
        y = (X % 7 == 1).any(1).astype(np.float32)  # token-presence signal
        n_test = n // 5
        return [], X[:-n_test], y[:-n_test], X[-n_test:], y[-n_test:]
    if name == "criteo":
        try:
            if config.data_path is None:
                raise FileNotFoundError("no --data-path")
            return D.load_criteo(config.data_path, embedding_dim=config.embedding_dim,
                                 hash_buckets=config.hash_buckets,
                                 max_rows=config.max_rows)
        except FileNotFoundError:
            name = "synthetic"
    if name == "avazu":
        if not config.data_path:
            raise ValueError("--dataset avazu requires --data-path train.csv")
        return D.load_avazu(config.data_path, embedding_dim=config.embedding_dim,
                            hash_buckets=config.hash_buckets or 1_000_000,
                            max_rows=config.max_rows)
    if name == "amazon":
        if not config.data_path:
            raise ValueError("--dataset amazon requires --data-path "
                             "reviews.json[.gz][,meta.json[.gz]]")
        parts = config.data_path.split(",")
        return D.build_amazon_behavior_dataset(
            parts[0], parts[1] if len(parts) > 1 else None,
            seq_len=config.seq_len, embedding_dim=config.embedding_dim,
            max_rows=config.max_rows, negsample_hist=(config.model == "dien"),
            seed=config.seed)
    if name == "movielens":
        try:
            if config.data_path is None:
                raise FileNotFoundError("no --data-path")
            ratings = D.load_movielens_ratings(config.data_path)
            return D.build_behavior_dataset(
                ratings, seq_len=config.seq_len, embedding_dim=config.embedding_dim,
                negsample=(config.model == "dien"), seed=config.seed)
        except FileNotFoundError:
            name = "synthetic_behavior"
    if name == "synthetic_behavior" or (
            name == "synthetic" and config.model in SEQUENCE_MODELS | {"dssm"}):
        cols, X, y = D.synthetic_behavior(
            n_rows=config.max_rows or 4096, seq_len=config.seq_len,
            embedding_dim=config.embedding_dim, seed=config.seed)
        if config.model == "dien":
            from .utils.features import SparseFeat, VarLenSparseFeat

            rng = np.random.default_rng(config.seed)
            n_items = next(c for c in cols if c.name == "item_id").vocabulary_size
            neg = rng.integers(1, n_items, X["hist_item_id"].shape).astype(np.int32)
            X["neg_hist_item_id"] = np.where(X["hist_item_id"] > 0, neg, 0)
            cols = list(cols) + [VarLenSparseFeat(
                SparseFeat("neg_hist_item_id", n_items, config.embedding_dim,
                           embedding_name="item_id"),
                maxlen=config.seq_len, combiner="mean", length_name="hist_len")]
    elif name == "synthetic":
        cols, X, y = D.synthetic_criteo(n_rows=config.max_rows or 4096,
                                        embedding_dim=config.embedding_dim, seed=config.seed)
    else:
        raise ValueError(f"unknown dataset {config.dataset!r}")
    if config.model == "mmoe":
        # a second task: the label of whether the row's dense sum passes the median
        dense = np.concatenate(
            [np.reshape(X[k], (len(y), -1)) for k in X
             if X[k].dtype.kind == "f"] or [np.zeros((len(y), 1))], axis=1)
        task2 = (dense.sum(1) > np.median(dense.sum(1))).astype(np.float32)
        y = np.stack([y, task2], axis=1)
    n_test = len(y) // 5
    X_train = {k: v[:-n_test] for k, v in X.items()}
    X_test = {k: v[-n_test:] for k, v in X.items()}
    return cols, X_train, y[:-n_test], X_test, y[-n_test:]


def build_model(config: ExperimentConfig, columns):
    """The model the JAX CLI builds for ``config``, on ``config.device``
    (the card by default), its weights drawn from ``config.seed``."""
    from . import models as M
    from .ops.dispatch import resolve_device

    kwargs = dict(config.model_kwargs)
    kwargs.update(device=resolve_device(config.device),
                  generator=torch.Generator().manual_seed(config.seed))
    name = config.model
    if config.dnn_dtype and name not in {"lr", "cf", "mf", "fm", "ffm", "afm",
                                         "deep_crossing", "mmoe"} | TOKEN_MODELS:
        kwargs.setdefault("dnn_dtype", getattr(torch, config.dnn_dtype))
    if name == "mmoe":
        return M.MMOE(feature_columns=tuple(columns),
                      tower_hidden_units=tuple(config.hidden_units[-1:]), **kwargs)
    if name == "dssm":
        kwargs.pop("temperature", None)  # the loss's setting (make_loss_fn)
        user_cols = tuple(c for c in columns if c.name in ("user_id", "hist_item_id"))
        item_cols = tuple(c for c in columns if c.name == "item_id")
        return M.DSSM(user_cols, item_cols, user_hidden_units=tuple(config.hidden_units),
                      item_hidden_units=tuple(config.hidden_units), **kwargs)
    if name == "lstm":
        return M.LSTMClassifier(vocab_size=config.hash_buckets or 200,
                                embed_dim=config.embedding_dim * 4,
                                hidden=config.hidden_units[-1], **kwargs)
    if name == "transformer":
        return M.TransformerClassifier(
            vocab_size=config.hash_buckets or 200, model_dim=32, num_heads=4,
            num_layers=1, ffn_dim=64, max_len=max(config.seq_len, 8), **kwargs)
    if name not in M.CTR_MODELS:
        raise ValueError(
            f"unknown model {name!r} (choose from "
            f"{sorted(M.CTR_MODELS) + ['dssm', 'mmoe', 'lstm', 'transformer']})")
    cls = M.CTR_MODELS[name]
    if name == "dien":
        kwargs.setdefault("use_negsampling", True)
    if name in ("fm", "ffm", "afm"):
        return cls(tuple(columns), **kwargs)
    return cls(tuple(columns), hidden_units=tuple(config.hidden_units), **kwargs)


def make_loss_fn(config: ExperimentConfig):
    """DSSM's loss (in-batch softmax, or BCE of the scaled inner product
    with ``--dssm-loss logistic``) at ``model_kwargs['temperature']``
    (default 0.05); ``default_loss`` for every other model."""
    from .training import default_loss
    from .training.losses import bce_with_logits, inbatch_softmax_loss

    if config.model != "dssm":
        return default_loss
    temperature = config.model_kwargs.get("temperature", 0.05)
    if config.dssm_loss == "logistic":
        def dssm_loss(outputs, labels, batch):
            user_emb, item_emb = outputs
            return bce_with_logits(torch.sum(user_emb * item_emb, dim=-1) / temperature,
                                   labels)
    else:
        def dssm_loss(outputs, labels, batch):
            user_emb, item_emb = outputs
            return inbatch_softmax_loss(user_emb, item_emb, batch["item_id"],
                                        temperature=temperature)
    return dssm_loss


def build_trainer(config: ExperimentConfig, columns):
    """The ``Trainer`` of ``config`` over a new model of ``columns``: the
    dense optimizer of ``--optimizer``, the fused one of
    ``--fused-embedding`` at the same learning rate, the loss of
    ``make_loss_fn``, over the mesh of ``--mesh-data`` (started first, so
    that the model lies on this rank's card)."""
    from .training import FusedAdagrad, FusedAdam, FusedSGD, Trainer

    mesh = config.build_mesh()
    model = build_model(config, columns)
    fused = None
    if config.fused_embedding:
        fused = {"adagrad": FusedAdagrad, "sgd": FusedSGD,
                 "adam": FusedAdam}[config.fused_embedding](config.learning_rate)
    return Trainer(model, config.build_optimizer(), fused_embedding=fused, seed=config.seed,
                   device=config.device, loss_fn=make_loss_fn(config),
                   weight_decay=config.weight_decay, mesh=mesh,
                   capacity_factor=config.capacity_factor,
                   explicit_lookup=config.explicit_lookup)


class _Profile:
    """A ``torch.profiler`` trace of the block into ``directory/trace.json``
    (CPU and, on a card, CUDA activity); nothing without a directory."""

    def __init__(self, directory: Optional[str], device: torch.device):
        self.directory, self.device, self.prof = directory, device, None

    def __enter__(self):
        if self.directory:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.__exit__(*exc)
            os.makedirs(self.directory, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.directory, "trace.json"))
        return False


def _result(config: ExperimentConfig, history: dict) -> dict:
    return {"model": config.model, "train_loss": history["loss"],
            "examples_per_sec": round(float(np.mean(history["examples_per_sec"])), 1)}


def run_stream(config: ExperimentConfig, timings: Optional[dict] = None) -> dict:
    """The out-of-core path: train over ``stream_criteo`` batches, the
    README's north-star configuration, then score ``--stream-eval-path``
    with the streaming AUC. A resumed run skips the batches its checkpoint
    already trained on: the stream replays the same batches (the file's
    order, and the shuffle pool's generator from ``config.seed``), so the
    run continues the uninterrupted trajectory. ``timings``, where given,
    accumulates the host's seconds by part (``stream_criteo``'s ``stats``
    and ``Trainer.fit_stream``'s ``timings``)."""
    from .training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from .utils.datasets import criteo_columns, stream_criteo

    if not config.data_path:
        raise ValueError("--stream requires --data-path <criteo tsv>")
    if config.epochs < 1:
        raise ValueError(f"--stream requires --epochs >= 1, got {config.epochs}")
    hash_buckets = config.hash_buckets or 1_000_000
    columns = criteo_columns(embedding_dim=config.embedding_dim, hash_buckets=hash_buckets)
    trainer = build_trainer(config, columns)

    def stream(path, shuffle_rows=0, stats=None):
        return stream_criteo(
            path, batch_size=config.batch_size, hash_buckets=hash_buckets,
            chunk_rows=config.stream_chunk_rows, epochs=1,
            prefetch_chunks=config.stream_prefetch, shuffle_buffer_rows=shuffle_rows,
            seed=config.seed, stats=stats)

    checkpoint_fn = None
    if config.checkpoint_dir:
        if config.resume and latest_step(config.checkpoint_dir) is not None:
            restore_checkpoint(config.checkpoint_dir, trainer)
        if config.checkpoint_every:
            def checkpoint_fn(tr, _steps):
                save_checkpoint(config.checkpoint_dir, tr)

    skip = {"batches": trainer.step}

    def skipping(it):
        for item in it:
            if skip["batches"] > 0:
                skip["batches"] -= 1
                continue
            yield item

    history = {"loss": [], "examples_per_sec": []}
    with _Profile(config.profile_dir, trainer.device):
        for _ in range(config.epochs):
            remaining = (config.stream_max_steps - trainer.step
                         if config.stream_max_steps else 0)
            if config.stream_max_steps and remaining <= 0:
                break
            epoch = stream(config.data_path, config.stream_shuffle_rows, timings)
            try:
                ep = trainer.fit_stream(
                    skipping(epoch), log_every=config.log_every,
                    steps_per_call=config.stream_steps_per_call,
                    checkpoint_every=config.checkpoint_every, checkpoint_fn=checkpoint_fn,
                    max_steps=remaining, timings=timings)
            finally:
                epoch.close()
            for k, v in ep.items():
                history.setdefault(k, []).extend(v)
    if config.checkpoint_dir:
        save_checkpoint(config.checkpoint_dir, trainer)
    result = _result(config, history)
    if config.stream_eval_path:
        held_out = stream(config.stream_eval_path)
        try:
            metrics = trainer.evaluate_stream(held_out)
        finally:
            held_out.close()
        result["auc"] = round(metrics["auc"], 4)
        result["logloss"] = round(metrics["logloss"], 4)
    return result


def run(config: ExperimentConfig) -> dict:
    """Train as ``config`` says; returns the JAX CLI's result keys."""
    if config.stream:
        return run_stream(config)
    from .training.checkpoint import latest_step, restore_checkpoint, save_checkpoint

    columns, X_train, y_train, X_test, y_test = build_data(config)
    trainer = build_trainer(config, columns)
    if config.resume and config.checkpoint_dir \
            and latest_step(config.checkpoint_dir) is not None:
        restore_checkpoint(config.checkpoint_dir, trainer)
    return train_and_score(config, trainer, X_train, y_train, X_test, y_test)


def train_and_score(config: ExperimentConfig, trainer, X_train, y_train, X_test,
                    y_test) -> dict:
    """``run``'s training and scoring on a built (and perhaps restored)
    trainer."""
    from .training.checkpoint import save_checkpoint

    with _Profile(config.profile_dir, trainer.device):
        history = trainer.fit(X_train, y_train, batch_size=config.batch_size,
                              epochs=config.epochs, log_every=config.log_every)
    if config.checkpoint_dir:
        save_checkpoint(config.checkpoint_dir, trainer)
    result = _result(config, history)
    if config.model == "dssm":
        from .utils.metrics import recall_at_n

        model = trainer.model
        model.eval()
        with torch.inference_mode():
            user_emb = model.user_embedding(trainer._to_device(X_test))
            item_ids = np.unique(X_test["item_id"])
            item_emb = model.item_embedding(trainer._to_device({"item_id": item_ids}))
            scores = (user_emb @ item_emb.T).cpu().numpy()
        top = item_ids[np.argsort(-scores, axis=1)[:, :10]]
        result["recall@10"] = round(recall_at_n(list(top), list(X_test["item_id"])), 4)
    else:
        metrics = trainer.evaluate(X_test, y_test)
        result.update({k: round(v, 4) for k, v in metrics.items()})
    return result


def parse_args(argv=None) -> ExperimentConfig:
    defaults = ExperimentConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=defaults.model)
    p.add_argument("--dataset", default=defaults.dataset)
    p.add_argument("--data-path", default=None)
    p.add_argument("--embedding-dim", type=int, default=defaults.embedding_dim)
    p.add_argument("--hash-buckets", type=int, default=None)
    p.add_argument("--max-rows", type=int, default=None)
    p.add_argument("--seq-len", type=int, default=defaults.seq_len)
    p.add_argument("--hidden-units", type=int, nargs="+", default=list(defaults.hidden_units))
    p.add_argument("--batch-size", type=int, default=defaults.batch_size)
    p.add_argument("--epochs", type=int, default=defaults.epochs)
    p.add_argument("--learning-rate", type=float, default=defaults.learning_rate)
    p.add_argument("--optimizer", default=defaults.optimizer)
    p.add_argument("--weight-decay", type=float, default=defaults.weight_decay)
    p.add_argument("--seed", type=int, default=defaults.seed)
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data axis of the mesh, under torchrun --nproc-per-node data*model")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="model axis of the mesh (torchrun --nproc-per-node data*model)")
    p.add_argument("--explicit-lookup", action="store_true",
                   help="mesh only: the explicit all-to-all embedding lookup")
    p.add_argument("--capacity-factor", type=float, default=defaults.capacity_factor,
                   help="mesh only: per-destination exchange bucket bound")
    p.add_argument("--fused-embedding", default=defaults.fused_embedding,
                   choices=[None, "adagrad", "sgd", "adam"],
                   help="fused sparse embedding optimizer (CUDA kernel on the card)")
    p.add_argument("--dnn-dtype", default=defaults.dnn_dtype, choices=[None, "bfloat16"],
                   help="deep-tower compute dtype (parameters stay f32)")
    p.add_argument("--dssm-loss", default=defaults.dssm_loss, choices=["inbatch", "logistic"])
    p.add_argument("--stream", action="store_true",
                   help="out-of-core training over a Criteo-format TSV (requires --data-path)")
    p.add_argument("--stream-chunk-rows", type=int, default=defaults.stream_chunk_rows,
                   help="rows per parsed chunk in --stream mode")
    p.add_argument("--stream-prefetch", type=int, default=defaults.stream_prefetch,
                   help="parsed chunks resident ahead of the device step")
    p.add_argument("--stream-eval-path", default=None,
                   help="held-out Criteo TSV scored with the streaming AUC after --stream "
                        "training")
    p.add_argument("--stream-steps-per-call", type=int,
                   default=defaults.stream_steps_per_call,
                   help="batches per packed copy and multi_step call in --stream mode "
                        "(1 = per-batch staging)")
    p.add_argument("--stream-shuffle-rows", type=int, default=defaults.stream_shuffle_rows,
                   help="bounded shuffle pool (rows) for --stream; 0 = the file's order")
    p.add_argument("--stream-max-steps", type=int, default=defaults.stream_max_steps,
                   help="stop --stream after N train steps in all (0 = run the stream dry)")
    p.add_argument("--checkpoint-every", type=int, default=defaults.checkpoint_every,
                   help="--stream: save a checkpoint every N steps (requires "
                        "--checkpoint-dir; --resume restarts from it, skipping consumed rows)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the training loop here")
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="where to run: the card by default; 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    return ExperimentConfig(
        model=args.model, dataset=args.dataset, data_path=args.data_path,
        embedding_dim=args.embedding_dim, hash_buckets=args.hash_buckets,
        max_rows=args.max_rows, seq_len=args.seq_len,
        hidden_units=tuple(args.hidden_units), batch_size=args.batch_size,
        epochs=args.epochs, learning_rate=args.learning_rate,
        optimizer=args.optimizer, weight_decay=args.weight_decay,
        seed=args.seed, dssm_loss=args.dssm_loss, dnn_dtype=args.dnn_dtype,
        fused_embedding=args.fused_embedding,
        mesh_data=args.mesh_data, mesh_model=args.mesh_model,
        explicit_lookup=args.explicit_lookup, capacity_factor=args.capacity_factor,
        stream=args.stream, stream_chunk_rows=args.stream_chunk_rows,
        stream_prefetch=args.stream_prefetch, stream_eval_path=args.stream_eval_path,
        stream_steps_per_call=args.stream_steps_per_call,
        stream_shuffle_rows=args.stream_shuffle_rows,
        stream_max_steps=args.stream_max_steps,
        checkpoint_every=args.checkpoint_every, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, profile_dir=args.profile_dir, log_every=args.log_every,
        device=args.device)


def main(argv=None) -> dict:
    """Parse ``argv``, run, print the result as one JSON line (on rank 0
    under a mesh, whose process group it then ends); returns it."""
    from .utils.logging import is_host_zero

    config = parse_args(argv)
    result = run(config)
    if is_host_zero():
        print(json.dumps(result))
    if config.mesh_data is not None:
        torch.distributed.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
    if "TORCHELASTIC_RUN_ID" in os.environ and parse_args().device == "cpu":
        # A workaround, not a repair: torch's own C++ teardown of a gloo job
        # at interpreter exit aborts a worker now and then ("terminate called
        # without an active exception", no Python frame left), failing the
        # job. So a gloo torchrun worker whose work is done and printed ends
        # here without the interpreter's teardown (no atexit handlers, no
        # finalisation). NCCL jobs, where the abort was never seen, exit as
        # usual.
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
