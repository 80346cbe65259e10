"""A cell's initial weights, made by the benchmark on the device from the
seed, in a few large draws: one normal draw for every leaf drawn normal,
one uniform draw for every glorot-uniform leaf, each then cut and scaled.
The program and the reference both start from these."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .generate import generator

# name -> (shape, init): ("normal", std), ("glorot",), ("zeros",), ("ones",)
LeafSpec = Dict[str, Tuple[Tuple[int, ...], tuple]]


def draw(leaves: LeafSpec, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = generator(seed, "weights", device)
    sizes = {kind: sum(math.prod(shape) for shape, init in leaves.values() if init[0] == kind)
             for kind in ("normal", "glorot")}
    flat = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
            "glorot": torch.rand(sizes["glorot"], generator=gen, device=device)}
    taken = {"normal": 0, "glorot": 0}
    out = {}
    for name, (shape, init) in leaves.items():
        kind, n = init[0], math.prod(shape)
        if kind in flat:
            part = flat[kind][taken[kind]: taken[kind] + n].view(shape)
            taken[kind] += n
            if kind == "normal":
                out[name] = part * init[1]
            else:
                # glorot_uniform: U(-l, l), l = sqrt(6 / (fan_in + fan_out))
                limit = math.sqrt(6.0 / sum(shape[:2]))
                out[name] = (part * 2 - 1) * limit
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out
