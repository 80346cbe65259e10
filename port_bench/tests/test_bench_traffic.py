"""The traffic generator: the same seed gives the same pool, every seed the
same sizes and shares; ids within each field's vocabulary, a category
fixed for each item, and the history lengths as the mixes state them."""
import math

import torch

from conftest import tiny
from port_bench import generate, harness


def pool(name, seed, groups=2, **cut):
    cell = harness.load_cell(name)
    cfg = dict(cell.config, **cut)
    return generate.make_pool(cfg, cell.traffic, seed, "cpu", groups), cell


def test_same_seed_same_pool_and_large_seeds():
    big = 2 ** 31 + 12345
    a, _ = pool("din.train.electronics", big, batch=256)
    b, _ = pool("din.train.electronics", big, batch=256)
    c, _ = pool("din.train.electronics", big + 1, batch=256)
    for (ca, la), (cb, lb), (cc, _) in zip(a, b, c):
        assert all(torch.equal(ca[k], cb[k]) for k in ca) and torch.equal(la, lb)
        assert not torch.equal(ca["hist_item_id"], cc["hist_item_id"])
    assert generate.generator(-5, "traffic", "cpu").initial_seed() >= 0


def test_ids_uniform_over_each_fields_vocabulary():
    groups, cell = pool("deepfm.train.criteo", 3, groups=1, batch=4096)
    columns = groups[0][0]
    for col in generate.expand_columns(cell.config):
        if col["kind"] != "sparse":
            continue
        ids = columns[col["name"]].reshape(-1).long()
        assert ids.min() >= 0 and ids.max() <= col["vocab"] - 1, col["name"]
    # a field of 3 values: each takes a third of the positions, a hot row
    c9 = torch.bincount(columns["C9"].reshape(-1).long(), minlength=3)
    assert len(c9) == 3 and (c9.double() / c9.sum() - 1 / 3).abs().max() < 0.02


def test_each_item_has_one_category():
    groups, cell = pool("din.train.electronics", 4, groups=2, batch=2048)
    seen = {}
    for columns, _ in groups:
        for item, cate in ((columns["item_id"], columns["cate_id"]),
                           (columns["hist_item_id"], columns["hist_cate_id"])):
            for i, c in zip(item.reshape(-1).tolist(), cate.reshape(-1).tolist()):
                assert seen.setdefault(i, c) == c
                assert (i == 0) == (c == 0)
    assert len(set(seen.values())) > 700           # spread over the 801 categories


def test_history_prefix_lengths():
    """Lengths 1..n-2 of users with n events, n >= 5 geometric above it with
    the mix's mean, drawn by the samples they give: the mean prefix is
    E[(n-2)(n-1)/2] / E[n-2]."""
    groups, cell = pool("din.train.electronics", 9, groups=1, batch=8192)
    h = cell.traffic["history"]
    hist = groups[0][0]["hist_item_id"]
    T = h["maxlen"]
    assert hist.shape[-1] == T
    lengths = (hist != 0).sum(-1)
    assert lengths.min() >= 1 and lengths.max() <= T
    q = (h["mean_events"] - h["min_events"]) / (h["mean_events"] - h["min_events"] + 1)
    ns = range(h["min_events"], 1000)
    p = [q ** (n - h["min_events"]) for n in ns]
    mean = (sum(pn * (n - 2) * (n - 1) / 2 for n, pn in zip(ns, p))
            / sum(pn * (n - 2) for n, pn in zip(ns, p)))
    assert abs(lengths.double().mean().item() - mean) < 0.05 * mean
    # padding only after the history
    assert torch.equal(hist != 0, torch.arange(T) < lengths[..., None])


def test_uniform_history_lengths():
    traffic = {"sparse": {"law": "uniform"}, "labels": {"positive_share": 0.5},
               "history": {"maxlen": 50, "min_length": 5, "max_length": 50}}
    lengths = generate.history_lengths(traffic["history"], (4096,),
                                       generate.generator(1, "traffic", "cpu"), "cpu")
    assert lengths.min() >= 5 and lengths.max() <= 50
    assert abs(lengths.double().mean().item() - 27.5) < 1.5


def test_zipf_head():
    law = {"law": "zipf", "exponent": 1.0}
    ids = generate.draw_ids(1001, (20000,), law, generate.generator(2, "traffic", "cpu"),
                            "cpu")
    top = torch.bincount(ids).max().item() / ids.numel()
    harmonic = sum(1.0 / r for r in range(1, 1001))
    assert abs(top - 1 / harmonic) < 0.01          # rank 1 draws 1/H(n) of the ids
    assert ids.min() >= 1 and ids.max() <= 1000


def test_pool_shapes():
    cell = tiny(harness.load_cell("deepfm.train.criteo"))
    groups = generate.make_pool(cell.config, cell.traffic, 1, "cpu", 3)
    cols, labels = groups[0]
    k, b = cell.config["steps_per_call"], cell.config["batch"]
    assert labels.shape == (k, b) and cols["I1"].shape == (k, b, 1)
    assert cols["C1"].dtype == torch.int32
    assert math.isclose(labels.mean().item(), 0.25, abs_tol=0.2)
