"""What every plain reference shares: products in a stated precision, the
binary cross entropy, batch normalisation, and the steps of a
configuration's optimizers followed from the initial weights. Plain
PyTorch, float32 with TF32 off; it imports nothing of the program.

``matmul(precision)`` computes a product in a precision:

- ``"float32"``: float32 operands, TF32 off (the reference itself);
- ``"tf32"``: each product's operands rounded to TF32 (10 mantissa bits),
  forward and backward: the control of a float32 configuration;
- ``"fp8"``: each operand scaled by its largest magnitude and rounded to
  float8 e4m3 (e5m2 for the backward's cotangents), the control of a
  bfloat16 tower.

The rounding is explicit, so a control reads alike on the card and on the
CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    return ((bits + 0x0FFF + odd) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX[dtype]
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Rounded(torch.autograd.Function):
    """``a @ b`` with both operands rounded by ``fwd``, and the backward's
    products with the cotangent rounded by ``bwd`` and the saved operands by
    ``fwd``."""

    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        ra, rb = fwd(a), fwd(b)
        ctx.save_for_backward(ra, rb)
        ctx.bwd = bwd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.bwd(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg, None, None


def matmul(precision: str) -> Callable:
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return lambda a, b: _Rounded.apply(a, b, round_tf32, round_tf32)
    if precision == "fp8":
        return lambda a, b: _Rounded.apply(a, b, round_fp8,
                                            lambda g: round_fp8(g, torch.float8_e5m2))
    raise ValueError(f"unknown precision {precision!r}")


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy from logits: softplus(z) - y z."""
    z = logits.reshape(-1)
    return torch.mean(torch.logaddexp(z, torch.zeros_like(z)) - labels.reshape(-1) * z)


def batchnorm(x: torch.Tensor, eps: float, weight=None, bias=None) -> torch.Tensor:
    """Batch normalisation with the batch's mean and biased variance."""
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).mean(dim=0)
    y = (x - mean) / torch.sqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def _adam(p, g, m, v, t: int, o: dict, rows=None) -> None:
    """One Adam step (optax's: moments, then ``p -= lr m_hat / (sqrt(v_hat)
    + eps)``, the bias corrections ``1 - b**t`` in float32); with ``rows``
    (lazy Adam) only those rows move, the rest keep ``p``, ``m`` and ``v``."""
    b1, b2 = o["b1"], o["b2"]
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    p_new = p - o["learning_rate"] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + o["eps"])
    if rows is not None:
        m_new, v_new, p_new = (torch.where(rows, new, old) for new, old in
                               ((m_new, m), (v_new, v), (p_new, p)))
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


# each rule's state: slot name -> its value at the start
SLOTS = {"sgd": {}, "adagrad": {"acc": "initial_accumulator_value"},
         "adam": {"m": 0.0, "v": 0.0}, "lazy_adam": {"m": 0.0, "v": 0.0}}


def _start(rule: dict, name: str):
    value = SLOTS[rule["name"]][name]
    return rule[value] if isinstance(value, str) else value


def follow(loss_fn: Callable, config: dict, weights: Dict[str, torch.Tensor],
           groups, tables, control: bool = False, fault: Optional[str] = None) -> dict:
    """Every step of ``groups`` (each ``(columns, labels)``, columns ``[K, B,
    ...]``, labels ``[K, B]``) in turn from ``weights``: the configuration's
    ``optimizer`` on every leaf but ``tables``, its ``embedding_optimizer``
    on those. Rules: ``sgd``, ``p -= lr g``; ``adagrad`` (optax's: ``acc +=
    g*g``, ``p -= lr g / sqrt(acc + eps)``; a table row no step touches has
    a zero gradient, so it keeps its value and its accumulator, as the fused
    sparse rule leaves it); ``adam``; ``lazy_adam``, Adam on the rows whose
    summed gradient is non-zero in some column, the other rows left as they
    are, the bias corrections at the global step.

    ``control`` computes each product one step below the precision the
    configuration states (``loss_fn``'s choice). ``fault`` plants a fault
    in the step for the limits' upper readings: ``"half_batch"`` leaves out
    the second half of each batch and takes the mean over the rest. Returns
    each step's loss; each leaf's first gradient norm, its change after
    the steps and the change of each of its optimizer's slots, as
    ``<leaf>.<slot>`` (float64 norms); and each leaf's number of elements."""
    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    rules = {n: config["embedding_optimizer"] if n in tables else config["optimizer"]
             for n in weights}
    state = {n: {s: torch.full_like(w, float(_start(rules[n], s)))
                 for s in SLOTS[rules[n]["name"]]} for n, w in weights.items()}
    losses, first, t = [], None, 0
    for columns, labels in groups:
        for s in range(labels.shape[0]):
            batch = {k: v[s] for k, v in columns.items()}
            y = labels[s]
            if fault == "half_batch":
                half = y.shape[0] // 2
                batch, y = {k: v[:half] for k, v in batch.items()}, y[:half]
            elif fault is not None:
                raise ValueError(f"unknown fault {fault!r}")
            loss = loss_fn(params, batch, y, config, control)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            t += 1
            with torch.no_grad():
                if first is None:
                    first = {n: float(g.double().norm()) for n, g in zip(params, grads)}
                for (n, p), g in zip(params.items(), grads):
                    rule, slots = rules[n], state[n]
                    lr = rule["learning_rate"]
                    if rule["name"] == "sgd":
                        p.sub_(lr * g)
                    elif rule["name"] == "adagrad":
                        slots["acc"].add_(g * g)
                        p.sub_(lr * g / torch.sqrt(slots["acc"] + rule["eps"]))
                    elif rule["name"] == "adam":
                        _adam(p, g, slots["m"], slots["v"], t, rule)
                    elif rule["name"] == "lazy_adam":
                        rows = (g != 0).any(dim=1, keepdim=True)
                        _adam(p, g, slots["m"], slots["v"], t, rule, rows)
                    else:
                        raise ValueError(f"unknown rule {rule['name']!r}")
                del grads
    with torch.no_grad():
        change = {n: float((p.double() - weights[n].double()).norm())
                  for n, p in params.items()}
        slots = {f"{n}.{s}": float((v.double() - float(_start(rules[n], s))).norm())
                 for n, st in state.items() for s, v in st.items()}
    return {"losses": losses, "grad": first, "change": change, "state": slots,
            "sizes": {n: w.numel() for n, w in weights.items()}}
