"""DIN target attention (counterpart of ``recommender_system_tpu/ops/attention.py``).

``din_attention`` scores a behaviour sequence against a target query with a
2-hidden-layer MLP over ``[q, k, q-k, q*k]``, masks invalid steps, optionally
softmax-normalises, and pools the keys. It is ``din_attention_fused``
(``ops/kernels.py``): on the card a kernel of ``csrc/din_attention.cu`` at
every shape (the tiled kernel where ``din_kernel_takes``, else the global
kernel), and its backward that source's backward kernel
(``din_attention_backward``); on the CPU their plain versions.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from .kernels import din_attention_fused


def din_attention(query: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
                  w1, b1, w2, b2, w3, b3, activation: str = "sigmoid",
                  weight_normalization: bool = True, return_scores: bool = False,
                  use_pallas: Optional[bool] = None, dtype=None,
                  remat: bool = False) -> torch.Tensor:
    """``query [B, K]``, ``keys [B, T, K]``, ``mask [B, T]`` -> pooled
    ``[B, K]`` (or weights ``[B, T]``).

    ``use_pallas`` is accepted for the JAX package's signature and ignored:
    on the card it takes a kernel of ``csrc/din_attention.cu`` at every
    shape (the global kernel where ``din_kernel_takes`` is False). The
    kernels compute in f32, so ``dtype`` is ignored, as on the JAX package's
    kernel path. ``remat=True`` (the JAX package's hand-written backward,
    ``ops/din_vjp.py``, which saves only the inputs and the weights and
    recomputes the scorer) takes the same path as ``remat=False``: that is
    the design of ``din_attention_fused``'s backward here in either case, a
    kernel on the card and ``din_attention_backward_ref`` on the CPU.
    """
    if dtype is not None:
        warnings.warn("din_attention: the kernel computes in f32; "
                      f"dtype={dtype} is ignored", stacklevel=2)
    return din_attention_fused(query, keys, mask, w1, b1, w2, b2, w3, b3,
                               activation, weight_normalization, return_scores)
