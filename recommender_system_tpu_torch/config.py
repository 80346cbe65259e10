"""Experiment configuration: one dataclass names the model, the data, the
optimizers and the run (counterpart of ``recommender_system_tpu/config.py``).

``ExperimentConfig`` has the JAX package's fields and defaults, plus
``device``: None runs on the card (and raises without one), any other value
names the device, as ``--device cpu`` does on the command line.
``recommender_system_tpu_torch.train`` turns one into a run.
"""
from __future__ import annotations

import dataclasses
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

    # parallelism (None: one device); the mesh options come with the
    # distributed slice of the port
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
        """None without ``mesh_data``; a mesh comes with the distributed
        slice of the port and raises ``NotImplementedError`` until then."""
        if self.mesh_data is None:
            return None
        raise NotImplementedError("mesh_data comes with the distributed slice of the port")
