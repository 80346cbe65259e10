"""DeepFM as the port runs it (``recommender_system_tpu_torch.DeepFM``): the
model built from a configuration, its leaves and their initial draws, and
what a step's batch asks of each layer (its sparse stream, its FLOPs)."""
from __future__ import annotations

import torch

from .. import bounds
from ..generate import expand_columns


def _fields(config):
    cols = expand_columns(config)
    sparse = [c for c in cols if c["kind"] == "sparse"]
    dense = [c for c in cols if c["kind"] == "dense"]
    return sparse, dense


def build(config: dict, traffic: dict, device, generator: torch.Generator):
    from recommender_system_tpu_torch import DeepFM
    from recommender_system_tpu_torch.utils.features import DenseFeat, SparseFeat

    sparse, dense = _fields(config)
    cols = [SparseFeat(c["name"], c["vocab"], c["dim"], init_std=config["embedding_init_std"])
            for c in sparse] + [DenseFeat(c["name"], 1) for c in dense]
    dtype = torch.bfloat16 if config["tower_dtype"] == "bfloat16" else None
    return DeepFM(cols, hidden_units=tuple(config["hidden_units"]),
                  activation=config["activation"], dropout_rate=config["dropout"],
                  dnn_dtype=dtype, device=device, generator=generator)


def widths(config: dict):
    sparse, dense = _fields(config)
    return [sum(c["dim"] for c in sparse) + len(dense), *config["hidden_units"], 1]


def leaves(config: dict, traffic: dict) -> dict:
    sparse, dense = _fields(config)
    dim = sparse[0]["dim"]
    rows = sum(c["vocab"] for c in sparse)
    out = {f"unified.embeddings.table_d{dim + 1}": ((rows, dim + 1),
                                                    ("normal", config["embedding_init_std"])),
           "unified.dense_w": ((len(dense), 1), ("normal", 1e-4)),
           "unified.bias": ((1,), ("zeros",))}
    w = widths(config)
    for i, (a, b) in enumerate(zip(w[:-1], w[1:])):
        name = "deep.output" if i == len(w) - 2 else f"deep.dense_{i}"
        out[f"{name}.weight"] = ((b, a), ("glorot",))
        out[f"{name}.bias"] = ((b,), ("zeros",))
    return out


def table_rows(config: dict, columns: dict) -> torch.Tensor:
    """A batch's ``[B, F]`` rows of the table, as the lookup clamps and
    offsets each field's ids."""
    sparse, _ = _fields(config)
    rows, offset = [], 0
    for c in sparse:
        rows.append(columns[c["name"]].long().clamp(0, c["vocab"] - 1) + offset)
        offset += c["vocab"]
    return torch.stack(rows, dim=-1)


def step_stats(config: dict, columns: dict) -> dict:
    """What one step's batch asks of the layers: the sparse stream's
    positions and the rows it touches."""
    sparse, _ = _fields(config)
    rows = table_rows(config, columns)
    return {"batch": rows.shape[0], "stream": rows.numel(),
            "touched": int(torch.unique(rows).numel()), "dim": sparse[0]["dim"] + 1}


def step_flops(config: dict, stats: dict) -> int:
    """The tower's GEMMs, forward and backward."""
    return bounds.train_flops(bounds.mlp_flops(stats["batch"], widths(config)))
