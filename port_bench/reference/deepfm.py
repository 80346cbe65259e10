"""DeepFM's loss, plain (arXiv:1703.04247; the port's layout): each id's
row holds its factors and its first-order weight, the fields' ids offset
into one table by the fields' vocabularies in order; the logit is the
first-order sum (ids' weights, dense columns times their weights, a bias)
plus the FM's pairwise term over the field embeddings plus a relu tower
over the flattened field embeddings and the dense columns."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..generate import expand_columns
from .common import bce, matmul


def loss(w: dict, batch: dict, labels: torch.Tensor, config: dict,
         control: bool = False) -> torch.Tensor:
    """The mean loss of a batch. The tower's hidden layers in the precision
    the configuration states (bfloat16 operands and outputs; the control:
    float8 e4m3, one step below), every other product in float32 with TF32
    off (the control: TF32)."""
    if config["activation"] != "relu" or config["dropout"]:
        raise ValueError("the reference follows a relu tower without dropout")
    mm = matmul("tf32" if control else "float32")
    tower_mm = matmul(("fp8" if config["tower_dtype"] == "bfloat16" else "tf32")
                      if control else "float32")
    cols = expand_columns(config)
    names = [c["name"] for c in cols if c["kind"] == "sparse"]
    dense_names = [c["name"] for c in cols if c["kind"] == "dense"]
    vocabs = [c["vocab"] for c in cols if c["kind"] == "sparse"]
    (dim,) = {c["dim"] for c in cols if c["kind"] == "sparse"}
    table = w[f"unified.embeddings.table_d{dim + 1}"]
    firsts = [sum(vocabs[:f]) for f in range(len(vocabs))]
    rows = torch.stack([batch[n].long().clamp(0, v - 1) + first
                        for n, v, first in zip(names, vocabs, firsts)], dim=1)
    e = table[rows]                                   # [B, F, dim + 1]
    x_dense = torch.cat([batch[n].reshape(-1, 1) for n in dense_names], dim=1)
    first_order = (e[..., dim].sum(dim=1, keepdim=True) + mm(x_dense, w["unified.dense_w"])
                   + w["unified.bias"])
    v = e[..., :dim]
    s = v.sum(dim=1)
    fm = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=1, keepdim=True)
    h = torch.cat([v.reshape(v.shape[0], -1), x_dense], dim=1)
    bf16 = config["tower_dtype"] == "bfloat16" and not control
    for i in range(len(config["hidden_units"])):
        W, b = w[f"deep.dense_{i}.weight"], w[f"deep.dense_{i}.bias"]
        if bf16:
            # as stated: operands, bias and output in bfloat16, the sums in float32
            h = torch.relu(F.linear(h.to(torch.bfloat16), W.to(torch.bfloat16),
                                    b.to(torch.bfloat16)))
        else:
            h = torch.relu(tower_mm(h, W.t()) + b)
    deep = mm(h.float(), w["deep.output.weight"].t()) + w["deep.output.bias"]
    return bce(first_order + fm + deep, labels)

