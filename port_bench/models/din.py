"""DIN as the port runs it (``recommender_system_tpu_torch.DIN``): the model
built from a configuration, its leaves and their initial draws, and what a
step's batch asks of each layer (its unmasked positions, its sparse
stream, its FLOPs). Each history column is a behaviour feature: the query
is the concatenation of their tables' embeddings of the target, each
position's key that of the history's, so the attention's width K is the
sum of their dims; the first history's padding is the mask."""
from __future__ import annotations

import torch

from .. import bounds
from ..generate import expand_columns


def _columns(config):
    cols = expand_columns(config)
    sparse = [c for c in cols if c["kind"] == "sparse"]
    hists = [c for c in cols if c["kind"] == "history"]
    dense = [c for c in cols if c["kind"] == "dense"]
    return sparse, hists, dense


def build(config: dict, traffic: dict, device, generator: torch.Generator):
    from recommender_system_tpu_torch import DIN
    from recommender_system_tpu_torch.utils.features import (DenseFeat, SparseFeat,
                                                             VarLenSparseFeat)

    sparse, hists, dense = _columns(config)
    std = config["embedding_init_std"]
    cols = [SparseFeat(c["name"], c["vocab"], c["dim"], init_std=std) for c in sparse]
    cols += [VarLenSparseFeat(SparseFeat(h["name"], h["vocab"], h["dim"],
                                         embedding_name=h["table"], init_std=std),
                              maxlen=traffic["history"]["maxlen"]) for h in hists]
    cols += [DenseFeat(c["name"], 1) for c in dense]
    return DIN(cols, behavior_feature_list=tuple(h["table"] for h in hists),
               att_hidden_units=tuple(config["att_hidden_units"]),
               att_activation=config["att_activation"],
               hidden_units=tuple(config["hidden_units"]),
               activation=config["tower_activation"], device=device, generator=generator)


def key_dim(config: dict) -> int:
    return sum(h["dim"] for h in _columns(config)[1])


def tower_widths(config: dict):
    sparse, hists, dense = _columns(config)
    behaviour = {h["table"] for h in hists}
    width = (sum(c["dim"] for c in sparse if c["name"] not in behaviour)
             + 2 * key_dim(config) + len(dense))
    return [width, *config["hidden_units"], 1]


def leaves(config: dict, traffic: dict) -> dict:
    sparse, _, _ = _columns(config)
    (dim,) = {c["dim"] for c in sparse}
    K, (H1, H2) = key_dim(config), config["att_hidden_units"]
    rows = sum(c["vocab"] for c in sparse)
    out = {f"embeddings.table_d{dim}": ((rows, dim), ("normal", config["embedding_init_std"])),
           "attention.w1": ((4 * K, H1), ("glorot",)), "attention.b1": ((H1,), ("zeros",)),
           "attention.w2": ((H1, H2), ("glorot",)), "attention.b2": ((H2,), ("zeros",)),
           "attention.w3": ((H2, 1), ("glorot",)), "attention.b3": ((1,), ("zeros",))}
    w = tower_widths(config)
    out["bn.weight"] = ((w[0],), ("ones",))
    out["bn.bias"] = ((w[0],), ("zeros",))
    for i, (a, b) in enumerate(zip(w[:-1], w[1:])):
        name = "deep.output" if i == len(w) - 2 else f"deep.dense_{i}"
        out[f"{name}.weight"] = ((b, a), ("glorot",))
        out[f"{name}.bias"] = ((b,), ("zeros",))
        if name != "deep.output":
            out[f"deep.dice_{i}.alpha"] = ((b,), ("zeros",))
    return out


def offsets(config: dict) -> dict:
    """Each sparse column's first row in the table, in the columns' order."""
    out, offset = {}, 0
    for c in _columns(config)[0]:
        out[c["name"]] = offset
        offset += c["vocab"]
    return out


def stream_rows(config: dict, columns: dict) -> torch.Tensor:
    """The table's rows a batch looks up, as the fused step streams them:
    the single-valued group, then each history (padding included)."""
    sparse, hists, _ = _columns(config)
    first = offsets(config)
    group = torch.stack([columns[c["name"]].long().clamp(0, c["vocab"] - 1) + first[c["name"]]
                         for c in sparse], dim=-1)
    history = [(columns[h["name"]].long().clamp(0, h["vocab"] - 1)
                + first[h["table"]]).reshape(-1) for h in hists]
    return torch.cat([group.reshape(-1), *history])


def step_stats(config: dict, columns: dict) -> dict:
    """What one step's batch asks of the layers: the attention's shape and
    unmasked positions, the sparse stream's positions and touched rows."""
    sparse, hists, _ = _columns(config)
    ids = columns[hists[0]["name"]]
    rows = stream_rows(config, columns)
    H1, H2 = config["att_hidden_units"]
    return {"batch": ids.shape[0], "T": ids.shape[1], "K": key_dim(config), "H1": H1,
            "H2": H2, "positions": int((ids != 0).sum()), "stream": rows.numel(),
            "touched": int(torch.unique(rows).numel()), "dim": sparse[0]["dim"]}


def step_flops(config: dict, stats: dict) -> int:
    """The scorer's products over the unmasked positions and the tower's
    GEMMs, forward and backward."""
    B = stats["batch"]
    forward = (bounds.din_scorer_flops(B, stats["K"], stats["H1"], stats["H2"],
                                       stats["positions"])
               + bounds.mlp_flops(B, tower_widths(config)))
    return bounds.train_flops(forward)
