"""Where the port runs: the device of its entry points and the kernel rule.

- Entry points (the models ``DCN``, ``DeepFM``, ``DIN``, ``DIEN``,
  ``WideDeep``, ``NFM``, ``FM``, ``FNN``, ``DeepCrossing``, ``PNN``, ``AFM``,
  ``FFM``, ``DSSM`` and ``MMOE``, the layer ``FMLayer``, ``Scorer``,
  ``RetrievalIndex`` and ``Trainer``) run on the card unless the caller
  names another device; with no card and no device named they raise.
- A kernel wrapper launches its CUDA kernel for CUDA tensors and runs the
  kernel's plain PyTorch version for CPU tensors. Nothing else selects: the
  wrappers of the cross stack, the FM logit and the DIN attention pick
  between two kernels of their source by the shape (``ops/kernels.py``),
  never the plain version on the card, and so does the DIN attention's
  backward (``din_attention_backward``: its tile, wide or global kernel).
- Each wrapper counts its launches (``<wrapper>.launches``,
  ``<wrapper>.global_launches`` for a global kernel,
  ``din_attention_backward.wide_launches`` for the backward's wide kernel,
  and ``<wrapper>.long_launches`` for the sparse rules' long path).
  ``launch_counts`` and ``add_launches`` read and raise them all: a captured CUDA graph
  (``Trainer.make_multi_step``) counts nothing while it is captured and adds
  the launches it holds each time it is replayed.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the card; raises if there is none. Any other value is taken
    as the caller's explicit choice."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (run the plain version). Raises for tensors on
    different devices or on any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {device}")


# a wrapper's counts: every launch, and of them the global kernel's, the
# attention backward's wide kernel's and the long path's
COUNTS = ("launches", "global_launches", "wide_launches", "long_launches")


def _counted():
    """Every kernel wrapper (imported here: their modules import this one)."""
    from .embedding_grad import scatter_add_sorted
    from .fused_adagrad import fused_adagrad_apply, fused_adam_apply, fused_sgd_apply
    from .kernels import cross_fused, din_attention_backward, din_attention_fused, fm_fused

    return (cross_fused, fm_fused, din_attention_fused, din_attention_backward,
            fused_adagrad_apply, fused_sgd_apply, fused_adam_apply, scatter_add_sorted)


def launch_counts() -> Dict[str, int]:
    """Every wrapper's counts, keyed ``<wrapper>.launches``,
    ``<wrapper>.global_launches``, ``<wrapper>.wide_launches`` and
    ``<wrapper>.long_launches``, where the wrapper has them."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn in _counted()
            for attr in COUNTS if hasattr(fn, attr)}


def add_launches(counts: Mapping[str, int]) -> None:
    """Raise each count named in ``counts`` by its value (a negative value
    lowers it)."""
    wrappers = {fn.__name__: fn for fn in _counted()}
    for key, n in counts.items():
        name, attr = key.split(".")
        setattr(wrappers[name], attr, getattr(wrappers[name], attr) + n)
