"""The one traffic generator: a pool of K-step groups made on the device from
the seed, by a configuration's columns and a traffic mix's parameters.

A configuration (``configs/<name>.json``) lists its columns, each of a kind:

- ``sparse``: ``vocab`` ids of one field (``count`` fields named
  ``name.format(i)``, ``i`` from 1, where ``count`` is given);
- ``history``: a behaviour sequence of ids of a sparse field's vocabulary,
  padded with id 0 after its last event;
- ``dense``: one float a row.

A sparse or history column with ``of`` is not drawn: its ids are those of
the column ``of`` names, each mapped to one id of this column's vocabulary
by a map drawn once a pool from the seed, uniform over ids 1..vocab-1 (an
item's category); id 0 maps to 0. Two columns of the same tables share
one map.

A traffic mix (``traffic/<name>.json``) gives how each kind is drawn:

- ``sparse``: ``law`` ``uniform`` (ids ``lowest_id``..vocab-1, the lowest
  1 unless given: id 0 is kept for a missing value) or ``zipf`` (rank r of
  those ids drawn with weight r**-exponent, each field's ranks scattered
  over its ids by a seeded permutation), and ``missing_share``, the share
  of a field's entries that are missing and read id 0;
- ``history``: ``maxlen`` (the padded length T), ids as ``sparse`` draws
  them, and the lengths: uniform on ``min_length``..``max_length``, or, with
  ``lengths`` ``prefixes``, the histories of a log in which a user with n
  events gives one sample for each prefix of 1..n-2 events (DIN's
  ``build_dataset``): n is at least ``min_events``, geometric above it with
  mean ``mean_events``, drawn in proportion to the n-2 samples it gives, and
  the prefix uniform on 1..n-2; a prefix longer than ``maxlen`` keeps its
  last ``maxlen`` events;
- ``dense``: ``law`` ``uniform`` (on [0, 1)) or ``normal``;
- ``labels``: ``positive_share``.

Every seed gives the same sizes, laws and shares; only the draws differ. A
group is ``(columns, labels)``: each column ``[K, B, ...]`` (int32 ids,
float32 values ``[K, B, 1]``), labels float32 ``[K, B]``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Group = Tuple[Dict[str, torch.Tensor], torch.Tensor]

# purposes a seed is split into, so that weights and traffic never share draws
PURPOSES = {"traffic": 1, "weights": 2}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on ``device`` for one purpose of one seed (any seed that
    fits 64 bits, negative ones too)."""
    words = np.random.SeedSequence([seed % 2 ** 64, PURPOSES[purpose]]).generate_state(
        2, dtype=np.uint32)
    state = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=device).manual_seed(state)


def expand_columns(config: dict) -> List[dict]:
    """The configuration's columns, a field group of ``count`` expanded."""
    out = []
    for col in config["columns"]:
        if "count" in col:
            for i in range(1, col["count"] + 1):
                one = {k: v for k, v in col.items() if k != "count"}
                one["name"] = col["name"].format(i)
                out.append(one)
        else:
            out.append(dict(col))
    return out


def _zipf_cdf(n: int, exponent: float, device) -> torch.Tensor:
    weights = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** -exponent
    cdf = torch.cumsum(weights, 0)
    return cdf / cdf[-1]


def draw_ids(vocab: int, shape, law: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Ids in ``law["lowest_id"]`` (1 unless given)..vocab-1 by ``law``, int64."""
    lowest = int(law.get("lowest_id", 1))
    n = vocab - lowest
    if law["law"] == "uniform":
        return torch.randint(lowest, vocab, shape, generator=gen, device=device)
    if law["law"] == "zipf":
        cdf = _zipf_cdf(n, float(law["exponent"]), device)
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
        ranks = torch.searchsorted(cdf, u.reshape(-1)).clamp_(max=n - 1).reshape(shape)
        scatter = torch.randperm(n, generator=gen, device=device) + lowest
        return scatter[ranks]
    raise ValueError(f"unknown id law {law['law']!r}")


def history_lengths(hist: dict, shape, gen: torch.Generator, device) -> torch.Tensor:
    """Each row's number of events, by the mix's ``history`` law, int64."""
    T = hist["maxlen"]
    if hist.get("lengths", "uniform") == "uniform":
        return torch.randint(hist["min_length"], hist["max_length"] + 1, shape,
                             generator=gen, device=device)
    if hist["lengths"] != "prefixes":
        raise ValueError(f"unknown history lengths {hist['lengths']!r}")
    lo, mean = hist["min_events"], float(hist["mean_events"])
    q = (mean - lo) / (mean - lo + 1)           # geometric above lo with that mean
    n = np.arange(lo, lo + 2000, dtype=np.float64)
    weight = (n - 2) * q ** (n - lo)            # a user gives n - 2 samples
    cdf = torch.tensor(np.cumsum(weight) / weight.sum(), device=device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    events = torch.tensor(n, device=device)[
        torch.searchsorted(cdf, u.reshape(-1)).clamp_(max=len(n) - 1)].reshape(shape)
    prefix = 1 + (torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
                  * (events - 2)).long()
    return prefix.clamp_(max=T)


def make_pool(config: dict, traffic: dict, seed: int, device, groups: int) -> List[Group]:
    """``groups`` groups of ``config["steps_per_call"]`` batches of
    ``config["batch"]`` rows, drawn from ``seed``."""
    k, batch = config["steps_per_call"], config["batch"]
    lead = (groups, k, batch)
    gen = generator(seed, "traffic", device)
    cols: Dict[str, torch.Tensor] = {}
    tables = {c["name"]: c.get("table", c["name"]) for c in expand_columns(config)}
    maps: Dict[tuple, torch.Tensor] = {}
    lengths = None   # one length a row, shared by its histories

    def mapped(col: dict, source: torch.Tensor) -> torch.Tensor:
        key = (tables[col["name"]], tables[col["of"]])
        if key not in maps:
            of = next(c for c in expand_columns(config) if c["name"] == col["of"])
            m = torch.randint(1, col["vocab"], (of["vocab"],), generator=gen, device=device)
            maps[key] = torch.cat([m.new_zeros(1), m[1:]])
        return maps[key][source.long()].to(torch.int32)

    for col in expand_columns(config):
        kind, name = col["kind"], col["name"]
        if kind == "sparse" and "of" in col:
            cols[name] = mapped(col, cols[col["of"]])
        elif kind == "sparse":
            law = traffic["sparse"]
            ids = draw_ids(col["vocab"], lead, law, gen, device)
            missing = float(law.get("missing_share", 0.0))
            if missing:
                drop = torch.rand(lead, generator=gen, device=device) < missing
                ids = torch.where(drop, torch.zeros_like(ids), ids)
            cols[name] = ids.to(torch.int32)
        elif kind == "history":
            hist = traffic["history"]
            T = hist["maxlen"]
            if "of" in col:
                cols[name] = mapped(col, cols[col["of"]])
                continue
            ids = draw_ids(col["vocab"], (*lead, T), traffic["sparse"], gen, device)
            if lengths is None:
                lengths = history_lengths(hist, lead, gen, device)
            pad = torch.arange(T, device=device) >= lengths[..., None]
            cols[name] = torch.where(pad, torch.zeros_like(ids), ids).to(torch.int32)
        elif kind == "dense":
            law = traffic["dense"]["law"]
            if law == "uniform":
                v = torch.rand((*lead, 1), generator=gen, device=device)
            elif law == "normal":
                v = torch.randn((*lead, 1), generator=gen, device=device)
            else:
                raise ValueError(f"unknown dense law {law!r}")
            cols[name] = v
        else:
            raise ValueError(f"unknown column kind {kind!r}")
    labels = (torch.rand(lead, generator=gen, device=device)
              < float(traffic["labels"]["positive_share"])).to(torch.float32)
    return [({name: v[g] for name, v in cols.items()}, labels[g]) for g in range(groups)]
