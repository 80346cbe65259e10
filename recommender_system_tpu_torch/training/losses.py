"""Losses (counterpart of ``recommender_system_tpu/training/losses.py``):
binary cross entropy, the in-batch softmax with its log-Q correction, and
sampled softmax against an item table with uniform, frequency or adaptive
(learned unigram) negatives; and ``default_loss``, the JAX package's
``Trainer`` default from ``training/harness.py``, with ``logits_of``, how
``Trainer.predict`` and ``Scorer`` read a model's outputs.

The JAX package draws negatives from a ``jax.random`` key; the port draws
them from a caller's ``torch.Generator`` (``_draw_negatives``), so the two
draw different negatives from the same seed. ``_sampled_softmax_given`` is
the loss on negatives already drawn (with ``_log_q``'s corrections), which
the parity tests feed with the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.dispatch import resolve_device


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable binary cross entropy from logits (mean scalar);
    with ``weights``, the weighted sum over ``max(sum(weights), 1)``."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    # softplus as log(exp(x) + 1), as jax.nn.softplus computes it
    per = torch.logaddexp(logits, torch.zeros_like(logits)) - labels * logits
    if weights is not None:
        w = weights.reshape(-1).to(logits.dtype)
        return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(per)


def logits_of(outputs) -> torch.Tensor:
    """A model's logits from its outputs, as the JAX package's ``predict``
    and ``Scorer`` take them: the first element of a tuple (an auxiliary
    loss dropped), per-task logits concatenated on the last axis."""
    if isinstance(outputs, tuple):
        outputs = outputs[0]
    if isinstance(outputs, list):
        outputs = torch.cat(outputs, dim=-1)
    return outputs


def default_loss(outputs, labels: torch.Tensor, batch=None) -> torch.Tensor:
    """The ``Trainer``'s loss of a model's outputs: a ``(logits, aux)``
    tuple gives ``bce + aux`` (DIEN's auxiliary loss); a list of per-task
    logits needs ``[B, T]`` labels and gives the mean of the per-task BCEs;
    anything else is one logit per row and gives plain BCE. ``batch`` is
    unused (a custom ``loss_fn(outputs, labels, batch)`` may read it)."""
    if isinstance(outputs, tuple):
        logits, aux = outputs
        return bce_with_logits(logits, labels) + aux
    if isinstance(outputs, list):
        labels = torch.as_tensor(labels)
        if labels.dim() != 2 or labels.shape[-1] != len(outputs):
            raise ValueError(
                f"multi-task model with {len(outputs)} outputs needs labels "
                f"of shape [B, {len(outputs)}], got {tuple(labels.shape)}")
        total = 0.0
        for t, logit in enumerate(outputs):
            total = total + bce_with_logits(logit, labels[..., t])
        return total / len(outputs)
    return bce_with_logits(outputs, labels)


@dataclasses.dataclass(frozen=True)
class NegativeSampler:
    """Sampling config, as the JAX package's.

    ``sampler``: ``'inbatch'``, ``'uniform'``, ``'frequency'`` or
    ``'adaptive'``; ``item_probs``: the item frequency distribution
    ``[n_items]`` (frequency sampling and its log-Q correction), flattened
    by ``p ** distortion``. ``'adaptive'`` samples from unigram counts
    learned online: start them with ``init_adaptive_counts``, fold each
    batch's positives in with ``update_adaptive_counts`` and pass them to
    ``sampled_softmax_loss``. Any other ``sampler`` (or ``'frequency'``
    without ``item_probs``) draws uniformly.

    The frequency proposal is made from ``item_probs`` once a device, at
    its first use, and kept: later steps copy nothing from the host, so a
    captured step (``Trainer.multi_step`` on a card) can draw from it."""

    sampler: str = "inbatch"
    num_sampled: int = 255
    item_probs: Optional[np.ndarray] = None
    distortion: float = 1.0
    _proposals: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                         compare=False)


def init_adaptive_counts(n_items: int, device=None) -> torch.Tensor:
    """Learned-unigram state: one per item (a uniform proposal), on the
    card unless ``device`` names another (raises without one)."""
    return torch.ones(n_items, dtype=torch.float32, device=resolve_device(device))


def update_adaptive_counts(counts: torch.Tensor, pos_ids: torch.Tensor) -> torch.Tensor:
    """New counts with one batch of observed positive item ids folded in
    (``counts`` is left as it is)."""
    ids = pos_ids.reshape(-1).to(torch.int64)
    return counts.index_add(0, ids, torch.ones(ids.shape, dtype=counts.dtype,
                                               device=counts.device))


def inbatch_softmax_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                         item_ids: torch.Tensor, item_probs: Optional[torch.Tensor] = None,
                         temperature: float = 1.0) -> torch.Tensor:
    """In-batch sampled softmax with log-Q correction.

    ``logits = (U / temperature) @ V^T`` in float32, less ``log q(item)`` of
    each candidate where ``item_probs`` is given; row i's label is item i.
    A row's other copies of its own item are masked out of the denominator
    (set to -1e9), as in the JAX package."""
    u = user_emb / temperature
    logits = torch.matmul(u, item_emb.T)  # [B, B]
    ids = item_ids.reshape(-1)
    if item_probs is not None:
        q = item_probs[ids.to(torch.int64)]
        logits = logits - torch.log(torch.clamp(q, min=1e-12))[None, :]
    same = ids[None, :] == ids[:, None]
    eye = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    logits = torch.where(same & ~eye, -1e9, logits)  # mask duplicate positives
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.diagonal(log_probs))


def _proposal(sampler: NegativeSampler, adaptive_counts: Optional[torch.Tensor] = None,
             device=None) -> Optional[torch.Tensor]:
    """The sampler's proposal distribution ``p [n_items]`` (frequency or
    adaptive, flattened by ``distortion``), or None for uniform draws.
    ``'adaptive'`` without ``adaptive_counts`` raises ``ValueError``."""
    if sampler.sampler == "adaptive":
        if adaptive_counts is None:
            raise ValueError("adaptive sampling needs adaptive_counts "
                             "(init_adaptive_counts / update_adaptive_counts)")
        p = adaptive_counts ** sampler.distortion
    elif sampler.sampler == "frequency" and sampler.item_probs is not None:
        key = torch.device(device if device is not None else "cpu")
        if key not in sampler._proposals:
            p = torch.as_tensor(sampler.item_probs, dtype=torch.float32,
                                device=key) ** sampler.distortion
            sampler._proposals[key] = p / torch.sum(p)
        return sampler._proposals[key]
    else:
        return None
    return p / torch.sum(p)


def _log_q(p: Optional[torch.Tensor], n_items: int, ids: torch.Tensor) -> torch.Tensor:
    """The log-Q correction of ``ids`` under the proposal ``p``: ``log p``
    (clipped at 1e-12), or ``-log(n_items - 1)`` for uniform draws."""
    ids = ids.reshape(-1).to(torch.int64)
    if p is None:  # a fill, not a copy from the host: a captured step may run it
        return torch.full((ids.shape[0],), -math.log(float(n_items - 1)),
                          dtype=torch.float32, device=ids.device)
    return torch.log(torch.clamp(p[ids], min=1e-12))


def _draw_negatives(p: Optional[torch.Tensor], n_items: int, num_sampled: int,
                   generator: torch.Generator) -> torch.Tensor:
    """``num_sampled`` negatives from ``generator`` (on its device): from the
    proposal ``p``, or uniform on ``[1, n_items)`` where ``p`` is None."""
    if p is None:
        return torch.randint(1, n_items, (num_sampled,), generator=generator,
                             device=generator.device)
    return torch.multinomial(p, num_sampled, replacement=True, generator=generator)


def _sampled_softmax_given(user_emb: torch.Tensor, item_table: torch.Tensor,
                          pos_ids: torch.Tensor, neg_ids: torch.Tensor,
                          log_q_pos: torch.Tensor, log_q_neg: torch.Tensor,
                          temperature: float = 1.0) -> torch.Tensor:
    """Sampled softmax on negatives already drawn: each row's positive
    against the shared negatives, every logit less its log-Q correction."""
    u = user_emb / temperature
    pos_vec = item_table[pos_ids.reshape(-1).to(torch.int64)]  # [B, d]
    neg_vec = item_table[neg_ids.to(torch.int64)]  # [S, d]
    pos_logit = torch.sum(u * pos_vec, dim=-1, keepdim=True) - log_q_pos[:, None]
    neg_logit = torch.matmul(u, neg_vec.T) - log_q_neg[None, :]
    logits = torch.cat([pos_logit, neg_logit], dim=-1)  # [B, 1+S]
    return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (an index left out is the current one)."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def sampled_softmax_loss(user_emb: torch.Tensor, item_table: torch.Tensor,
                         pos_ids: torch.Tensor, sampler: NegativeSampler,
                         generator: torch.Generator, temperature: float = 1.0,
                         adaptive_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform, frequency or adaptive negative sampling against the item
    table ``[n_items, d]``: ``sampler.num_sampled`` negatives shared by
    every row, drawn from ``generator``, then ``_sampled_softmax_given``
    with their log-Q corrections. A generator on another device than the
    table, or ``'adaptive'`` without ``adaptive_counts``, raises
    ``ValueError``."""
    if not _same_device(generator.device, item_table.device):
        raise ValueError(f"the generator lies on {generator.device}, the item table "
                         f"on {item_table.device}: draw on the table's device")
    n_items = item_table.shape[0]
    p = _proposal(sampler, adaptive_counts, item_table.device)
    neg_ids = _draw_negatives(p, n_items, sampler.num_sampled, generator)
    return _sampled_softmax_given(user_emb, item_table, pos_ids, neg_ids,
                                  _log_q(p, n_items, pos_ids), _log_q(p, n_items, neg_ids),
                                  temperature)
