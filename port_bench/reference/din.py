"""DIN's loss, plain (arXiv:1706.06978, as the port lays it out, DeepCTR's
layout): the target's embeddings in each behaviour feature's table,
concatenated, are the query; each unmasked history position's embeddings,
concatenated alike, a key, scored by an MLP over ``[q, k, q-k, q*k]`` (two
layers of the configured activation, then one output), the scores
softmax-normalised over the unmasked positions of the first history (a
masked one scores ``-(2**32) + 1``) and the keys pooled by them; ``[other
sparse, pooled, query, dense]`` goes through a BatchNorm and a Dice tower
to one logit. Dice: ``alpha (1 - p) x + p x`` with ``p =
sigmoid(batchnorm(x))`` over the batch, no scale or shift."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..generate import expand_columns
from .common import batchnorm, bce, matmul

NEG = -(2.0 ** 32) + 1


def loss(w: dict, batch: dict, labels: torch.Tensor, config: dict,
         control: bool = False) -> torch.Tensor:
    """The mean loss of a batch; every product in float32 (the control:
    TF32, one step below the stated float32 with TF32 off)."""
    mm = matmul("tf32" if control else "float32")
    cols = expand_columns(config)
    sparse = [c for c in cols if c["kind"] == "sparse"]
    hists = [c for c in cols if c["kind"] == "history"]
    dense = [c for c in cols if c["kind"] == "dense"]
    (dim,) = {c["dim"] for c in sparse}
    table = w[f"embeddings.table_d{dim}"]
    offsets, offset = {}, 0
    for c in sparse:
        offsets[c["name"]] = offset
        offset += c["vocab"]
    # F.embedding, not table[rows]: its backward sums a row's positions as
    # one segment, where indexing's takes them one by one, and every padded
    # position of a history reads the same row
    emb = {c["name"]: F.embedding(batch[c["name"]].long().clamp(0, c["vocab"] - 1)
                                  + offsets[c["name"]], table) for c in sparse}
    keys = torch.cat([F.embedding(batch[h["name"]].long().clamp(0, h["vocab"] - 1)
                                  + offsets[h["table"]], table) for h in hists], dim=-1)
    mask = batch[hists[0]["name"]] != 0
    behaviour = [h["table"] for h in hists]
    q = torch.cat([emb[t] for t in behaviour], dim=-1)
    B, T, K = keys.shape
    qt = q[:, None, :].expand(B, T, K)
    a = torch.cat([qt, keys, qt - keys, qt * keys], dim=-1).reshape(B * T, 4 * K)
    act = torch.sigmoid if config["att_activation"] == "sigmoid" else torch.relu
    h = act(mm(a, w["attention.w1"]) + w["attention.b1"])
    h = act(mm(h, w["attention.w2"]) + w["attention.b2"])
    score = (mm(h, w["attention.w3"]) + w["attention.b3"]).reshape(B, T)
    weight = torch.softmax(torch.where(mask, score, NEG), dim=-1)
    pooled = mm(weight[:, None, :], keys)[:, 0, :]
    parts = [emb[c["name"]] for c in sparse if c["name"] not in behaviour]
    parts += [pooled, q] + [batch[c["name"]].reshape(B, 1) for c in dense]
    x = batchnorm(torch.cat(parts, dim=-1), 1e-5, w["bn.weight"], w["bn.bias"])
    for i in range(len(config["hidden_units"])):
        x = mm(x, w[f"deep.dense_{i}.weight"].t()) + w[f"deep.dense_{i}.bias"]
        p = torch.sigmoid(batchnorm(x, 1e-9))
        alpha = w[f"deep.dice_{i}.alpha"]
        x = alpha * (1.0 - p) * x + p * x
    out = mm(x, w["deep.output.weight"].t()) + w["deep.output.bias"]
    return bce(out, labels)
