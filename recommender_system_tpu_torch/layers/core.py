"""Core building blocks: DNN tower, Dice/PReLU activations, prediction head
(counterparts of ``recommender_system_tpu/layers/core.py``).

Module and parameter names follow the JAX package (``dense_{i}``,
``bn_{i}``, ``dice_{i}``, ``prelu_{i}``, ``output``) so that ``convert.py``
maps each Flax parameter onto its counterpart by name. Dense layers are
``nn.Linear`` (weight ``[out, in]``, the transpose of Flax's kernel).

``BatchNorm`` is Flax's ``nn.BatchNorm`` (momentum 0.9): in train mode it
normalises with the batch statistics and moves its running statistics, in
eval mode it uses them. Dropout in train mode draws its mask from a
``torch.Generator`` that the caller passes to ``DNN.forward``, never from
torch's global generator.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import Mesh, all_reduce_sum


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the last axis, exactly.

    Train mode normalises with the batch's mean and its fast variance
    ``E[x^2] - E[x]^2`` clipped at 0, both over every axis but the last,
    and moves the running statistics to ``0.9 * old + 0.1 * batch`` (the
    momentum every caller in the JAX package sets), the variance biased as
    Flax keeps it (``nn.BatchNorm1d`` keeps
    it unbiased, so it cannot stand in). Eval mode normalises with the
    running statistics. Names as ``convert.py`` maps Flax's: ``weight``
    (Flax ``scale``), ``bias``, buffers ``running_mean`` and ``running_var``
    (``batch_stats`` ``mean`` and ``var``).

    Under a mesh (``mesh``, which the ``Trainer`` sets) train mode takes the
    global batch's moments, as GSPMD computes Flax's: each rank's means of
    ``x`` and ``x^2`` summed over ranks in one ``all_reduce_sum`` and
    divided by the rank count (every rank holds as many rows).
    """

    momentum = 0.9
    mesh: Optional[Mesh] = None

    def __init__(self, features: int, epsilon: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True, *, device: torch.device):
        super().__init__()
        self.epsilon = epsilon
        self.weight = (nn.Parameter(torch.ones(features, device=device))
                       if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean, mean2 = x.mean(dim=axes), torch.mean(x * x, dim=axes)
            if self.mesh is not None:
                mean, mean2 = all_reduce_sum(torch.stack([mean, mean2]), self.mesh) / self.mesh.n
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y


def glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax ``glorot_uniform`` for a ``[out, in]`` weight."""
    fan_out, fan_in = w.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.copy_(torch.empty(w.shape, device=generator.device)
            .uniform_(-limit, limit, generator=generator))


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax ``lecun_normal`` (the default Dense init) for a ``[out, in]``
    weight: a normal of variance ``1/fan_in`` truncated at two deviations."""
    fan_in = w.shape[1]
    # std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    w.copy_(t)


def dense(in_features: int, out_features: int, *, device: torch.device,
          generator: torch.Generator,
          init: Callable = lecun_normal_) -> nn.Linear:
    """``nn.Linear`` drawn from ``generator`` (bias zero, as Flax's Dense)."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features, device=device)
    with torch.no_grad():
        init(layer.weight, generator)
        layer.bias.zero_()
    return layer


class PReLU(nn.Module):
    """Parametric ReLU with per-channel slope, initialised to 0.25."""

    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25, device=device))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class Dice(nn.Module):
    """Data-adaptive activation from DIN: ``alpha*(1-p)*x + p*x`` with
    ``p = sigmoid(batchnorm(x))`` and a scale- and center-free BatchNorm."""

    def __init__(self, features: int, epsilon: float = 1e-9, *,
                 device: torch.device):
        super().__init__()
        # named as Flax names the inner BatchNorm of ``Dice``
        self.BatchNorm_0 = BatchNorm(features, epsilon=epsilon, use_scale=False,
                                     use_bias=False, device=device)
        self.alpha = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        p = torch.sigmoid(self.BatchNorm_0(x))
        return self.alpha * (1.0 - p) * x + p * x


def activation_fn(name: Optional[str]) -> Callable:
    """str -> stateless activation. 'dice' and 'prelu' are parametric and
    handled inside ``DNN``."""
    if name is None or name == "linear":
        return lambda x: x
    table = {
        "relu": F.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "elu": F.elu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "hard_sigmoid": F.hardsigmoid,
    }
    if name not in table:
        raise ValueError(f"Unknown activation {name!r}")
    return table[name]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout`` in train mode: keep each element with
    probability ``1 - rate`` and scale it by ``1 / (1 - rate)``, the mask
    drawn from ``generator``."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator: pass "
                         "generator= to the forward")
    keep_prob = 1.0 - rate
    keep = torch.empty(x.shape, device=x.device).bernoulli_(keep_prob,
                                                          generator=generator)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep.bool(), x / keep_prob, zero)


class DNN(nn.Module):
    """MLP tower with optional BN, dropout, parametric activations, linear head.

    ``output_dim=None`` returns the last hidden activation; otherwise a linear
    head of that width is appended. ``dtype=torch.bfloat16`` computes the
    hidden Dense layers in bf16 (input, weight and bias cast, as Flax's Dense
    with ``dtype`` does); the output head computes and returns f32.
    """

    def __init__(self, in_features: int, hidden_units: Sequence[int],
                 activation: str = "relu", dropout_rate: float = 0.0,
                 use_bn: bool = False, output_dim: Optional[int] = None,
                 output_activation: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"DNN's dtype is None (float32) or bfloat16, not {dtype}")
        self.hidden_units = tuple(hidden_units)
        self.activation = activation
        self.use_bn = use_bn
        self.output_dim = output_dim
        self.dtype = dtype
        self._act = (activation_fn(activation)
                     if activation not in ("dice", "prelu") else None)
        self._out_act = activation_fn(output_activation)
        width = in_features
        for i, units in enumerate(self.hidden_units):
            self.add_module(f"dense_{i}", dense(width, units, device=device,
                                                generator=generator,
                                                init=glorot_uniform_))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(units, device=device))
            if activation == "dice":
                self.add_module(f"dice_{i}", Dice(units, device=device))
            elif activation == "prelu":
                self.add_module(f"prelu_{i}", PReLU(units, device=device))
            width = units
        self.dropout_rate = dropout_rate
        self.out_features = width if output_dim is None else output_dim
        if output_dim is not None:
            self.output = dense(width, output_dim, device=device,
                                generator=generator, init=glorot_uniform_)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in train mode; it must lie
        on ``x``'s device. Eval mode, or a rate of 0, ignores it."""
        for i in range(len(self.hidden_units)):
            layer = getattr(self, f"dense_{i}")
            if self.dtype is None:
                x = layer(x)
            else:
                x = F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
                             layer.bias.to(self.dtype))
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            if self.activation == "dice":
                x = getattr(self, f"dice_{i}")(x)
            elif self.activation == "prelu":
                x = getattr(self, f"prelu_{i}")(x)
            else:
                x = self._act(x)
            if self.training and self.dropout_rate > 0.0:
                x = dropout(x, self.dropout_rate, generator)
        if self.output_dim is not None:
            x = self._out_act(self.output(x.to(torch.float32)))
        return x.to(torch.float32)


class PredictionLayer(nn.Module):
    """Task head: global bias + link function. ``task='binary'`` applies a
    sigmoid unless called with ``logits=True``."""

    def __init__(self, task: str = "binary", use_bias: bool = True, *,
                 device: torch.device):
        super().__init__()
        self.task = task
        self.global_bias = (nn.Parameter(torch.zeros(1, device=device))
                            if use_bias else None)

    def forward(self, x, logits: bool = False):
        if self.global_bias is not None:
            x = x + self.global_bias
        if self.task == "binary" and not logits:
            x = torch.sigmoid(x)
        return x.reshape(-1, 1) if x.dim() == 1 else x
