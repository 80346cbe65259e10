"""The DIN attention's hand-written backward (counterpart of
``recommender_system_tpu/ops/din_vjp.py``).

The forward keeps only its inputs and the ``[B, T]`` attention weights; the
backward recomputes the scorer and takes the first layer's cotangents per
part of the ``[q, k, q-k, q*k]`` concat, the way the forward folds it::

    with w1 = [wq; wk; wm; wp],  A = wq+wm,  Bw = wk-wm,  P = wp:
      dh_pre @ A.T  -> dq          q.T    @ dh_pre -> dA  (= dwq)
      dh_pre @ Bw.T -> dkeys       keys.T @ dh_pre -> dBw (= dwk)
      dh_pre @ P.T  -> d(q*k)      (qk).T @ dh_pre -> dP  (= dwp)
      dwm = dA - dBw

so no ``[B, T, 4K]`` tensor exists in either direction. On the card this is
``din_attention_backward`` (``ops/kernels.py``), a kernel of
``csrc/din_attention.cu``, which ``din_attention_fused``'s backward launches;
``din_attention_backward_ref`` is its plain version, a line-for-line copy of
the JAX package's ``_din_remat_bwd``.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F


def _act_fns(activation):
    """(activation, its derivative taken from its output)."""
    if activation == "sigmoid":
        return torch.sigmoid, lambda a: a * (1.0 - a)
    if activation == "relu":
        return F.relu, lambda a: (a > 0).to(a.dtype)
    raise ValueError(activation)


def _scorer(query, keys, w1, b1, w2, b2, w3, b3, activation):
    """Concat-folded 2-hidden-layer scorer -> (logits [B, T], h1, h2, ck),
    the arithmetic of ``din_attention_ref`` (``ops/kernels.py``)."""
    act, _ = _act_fns(activation)
    K = keys.shape[-1]
    wq, wk, wm, wp = w1[:K], w1[K:2 * K], w1[2 * K:3 * K], w1[3 * K:]
    ck = torch.cat([keys, query[:, None, :] * keys], dim=-1)
    wkp = torch.cat([wk - wm, wp], dim=0)
    h_pre = (query @ (wq + wm))[:, None, :] + ck @ wkp
    h1 = act(h_pre + b1)
    h2 = act(h1 @ w2 + b2)
    logits = (h2 @ w3 + b3)[..., 0]
    return logits, h1, h2, ck


def din_attention_backward_ref(query, keys, mask, w1, b1, w2, b2, w3, b3, score, g,
                               activation: str = "sigmoid",
                               weight_normalization: bool = True,
                               return_scores: bool = False):
    """Plain version of the backward: the forward's inputs, its weights
    ``score [B, T]`` and the cotangent ``g`` of its output -> ``(dq, dkeys,
    dw1, db1, dw2, db2, dw3, db3)``. ``mask`` is bool, or float and valid
    where > 0.5; it gets no cotangent."""
    _, dact = _act_fns(activation)
    K = keys.shape[-1]

    # recompute the scorer
    _, h1, h2, ck = _scorer(query, keys, w1, b1, w2, b2, w3, b3, activation)
    wq, wk, wm, wp = w1[:K], w1[K:2 * K], w1[2 * K:3 * K], w1[3 * K:]
    wkp = torch.cat([wk - wm, wp], dim=0)
    valid = mask if mask.dtype == torch.bool else mask > 0.5

    if return_scores:
        dscore = g
        dkeys = torch.zeros_like(keys)
    else:
        dscore = torch.einsum("bk,btk->bt", g, keys)
        dkeys = score[:, :, None] * g[:, None, :]  # pooling cotangent

    if weight_normalization:
        dlogits = score * (dscore - torch.sum(score * dscore, dim=-1, keepdim=True))
        dlogits = torch.where(valid, dlogits, 0.0)
    else:
        dlogits = torch.where(valid, dscore, 0.0)

    # layer 3: logits = h2 @ w3 + b3
    db3 = torch.sum(dlogits)[None]
    dw3 = torch.einsum("bth,bt->h", h2, dlogits)[:, None]
    dh2 = dlogits[:, :, None] * w3[None, None, :, 0]
    du = dh2 * dact(h2)                                    # [B, T, H2]

    # layer 2: u = h1 @ w2 + b2
    db2 = torch.sum(du, dim=(0, 1))
    H1, H2 = w2.shape
    dw2 = h1.reshape(-1, H1).T @ du.reshape(-1, H2)
    dh1 = du @ w2.T
    dh_pre = dh1 * dact(h1)                                # [B, T, H1]
    db1 = torch.sum(dh_pre, dim=(0, 1))
    dp_sum = torch.sum(dh_pre, dim=1)                      # [B, H1]

    # layer 1, per concat part, the keys and q*k cotangents as one product
    # over [Bw; P] like the forward:
    #   dck = dh_pre @ [Bw; P].T  ->  dkeys_s = dck[..., :K], d(q*k) = dck[..., K:]
    #   dwkp = ck.T @ dh_pre      ->  dBw = dwkp[:K], dP = dwkp[K:]
    dq = dp_sum @ (wq + wm).T
    dck = dh_pre @ wkp.T                                   # [B, T, 2K]
    dkeys_s, dprod = dck[..., :K], dck[..., K:]
    dq = dq + torch.sum(dprod * keys, dim=1)
    dkeys = dkeys + dkeys_s + dprod * query[:, None, :]

    dA = query.T @ dp_sum
    dwkp = ck.reshape(-1, 2 * K).T @ dh_pre.reshape(-1, H1)
    dBw, dP = dwkp[:K], dwkp[K:]
    dw1 = torch.cat([dA, dBw, dA - dBw, dP], dim=0)
    return dq, dkeys, dw1, db1, dw2, db2, dw3, db3


def din_attention_remat(query, keys, mask, w1, b1, w2, b2, w3, b3,
                        activation: str = "sigmoid",
                        weight_normalization: bool = True,
                        return_scores: bool = False,
                        dtype_name=None):
    """DIN attention whose backward saves only the inputs and the weights and
    recomputes the scorer: ``din_attention_fused``, whose backward is this
    module's design on every device (the kernel on the card,
    ``din_attention_backward_ref`` on the CPU). The kernels compute in f32,
    so ``dtype_name`` (``None``, ``'bfloat16'`` or ``'float32'`` in the JAX
    package) is ignored."""
    if dtype_name is not None:
        warnings.warn("din_attention_remat: the kernel computes in f32; "
                      f"dtype_name={dtype_name!r} is ignored", stacklevel=2)
    from .kernels import din_attention_fused  # ops/kernels.py imports this module
    return din_attention_fused(query, keys, mask, w1, b1, w2, b2, w3, b3, activation,
                               weight_normalization, return_scores)
