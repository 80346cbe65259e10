"""Experiment configuration: one dataclass names the model, the data, the
optimizers and the run (counterpart of ``recommender_system_tpu/config.py``).

``ExperimentConfig`` has the JAX package's fields and defaults, plus
``device``: None runs on the card (and raises without one), any other value
names the device, as ``--device cpu`` does on the command line.
``build_mesh`` starts a ``torchrun`` job's process group for ``mesh_data``
x ``mesh_model`` ranks.
``recommender_system_tpu_torch.train`` turns one into a run.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class ExperimentConfig:
    # model
    model: str = "deepfm"           # key in models.CTR_MODELS, or dssm/mmoe/lstm/transformer
    hidden_units: Tuple[int, ...] = (256, 128, 64)
    embedding_dim: int = 8
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # data
    # criteo | avazu | amazon | movielens | synthetic | synthetic_behavior |
    # synthetic_tokens
    dataset: str = "criteo"
    data_path: Optional[str] = None
    hash_buckets: Optional[int] = None
    max_rows: Optional[int] = None
    seq_len: int = 10

    # training
    batch_size: int = 256
    epochs: int = 5
    learning_rate: float = 1e-3
    optimizer: str = "adam"         # adam | adagrad | sgd
    weight_decay: float = 0.0
    seed: int = 0

    # DSSM's loss: 'inbatch' (in-batch softmax with the log-Q correction)
    # or 'logistic' (BCE of the scaled inner product against the labels)
    dssm_loss: str = "inbatch"
    # the deep towers' compute dtype: None (f32) or 'bfloat16' (parameters
    # stay f32)
    dnn_dtype: Optional[str] = None
    # the fused sparse embedding optimizer: None | 'adagrad' | 'sgd' |
    # 'adam' (lazy), at learning_rate
    fused_embedding: Optional[str] = None

    # out-of-core training over a Criteo-format TSV (Trainer.fit_stream over
    # utils.datasets.stream_criteo): requires data_path; hash_buckets
    # defaults to 1,000,000; stream_eval_path is a held-out TSV scored with
    # the streaming AUC after training
    stream: bool = False
    stream_chunk_rows: int = 1 << 18
    stream_prefetch: int = 2
    stream_eval_path: Optional[str] = None
    # batches packed into one host-to-device copy per dtype and trained in
    # one multi_step call; 1 stages batch by batch
    stream_steps_per_call: int = 8
    # rows of the bounded shuffle pool; 0 keeps the file's order
    stream_shuffle_rows: int = 0
    # stop the stream after this many steps (0: run it dry)
    stream_max_steps: int = 0
    # save a checkpoint every N stream steps (0: only at the end); --resume
    # restarts from the latest and skips the rows it consumed
    checkpoint_every: int = 0

    # parallelism (None: one device): mesh_data x mesh_model ranks under
    # torchrun, one a card; explicit_lookup and capacity_factor act with a
    # mesh only
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    explicit_lookup: bool = False
    capacity_factor: float = 2.0

    # persistence and observability
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    profile_dir: Optional[str] = None
    log_every: int = 0

    # where to run: None is the card
    device: Optional[str] = None

    def build_optimizer(self):
        """The dense optimizer at ``learning_rate``: the port's ``Adam``,
        ``Adagrad`` or ``SGD``."""
        from .training.optim import SGD, Adagrad, Adam

        table = {"adam": Adam, "adagrad": Adagrad, "sgd": SGD}
        if self.optimizer not in table:
            raise ValueError(f"unknown optimizer {self.optimizer!r} "
                             f"(choose from {sorted(table)})")
        return table[self.optimizer](self.learning_rate)

    def build_mesh(self):
        """None without ``mesh_data``; else the ``mesh_data`` x
        ``mesh_model`` mesh over a ``torchrun`` job of that many ranks
        (``parallel.launch.initialize``: NCCL, one rank a card; gloo with
        ``device='cpu'``), its model groups of consecutive ranks
        (``make_pod_mesh``). Raises unless ``WORLD_SIZE`` is
        ``mesh_data * mesh_model``."""
        if self.mesh_data is None:
            return None
        from .parallel import initialize, make_pod_mesh

        ranks = self.mesh_data * self.mesh_model
        world = os.environ.get("WORLD_SIZE")
        if world is None or int(world) != ranks:
            raise RuntimeError(
                f"--mesh-data {self.mesh_data} --mesh-model {self.mesh_model} runs under "
                f"torchrun --nproc-per-node {ranks} (WORLD_SIZE is {world})")
        initialize("gloo" if self.device == "cpu" else "nccl")
        return make_pod_mesh(self.mesh_model)
