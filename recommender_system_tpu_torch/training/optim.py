"""Dense optimizers, written by hand to compute what optax computes.

``torch.optim.Adagrad`` does not match ``optax.adagrad``: it adds eps
outside the square root and starts the accumulator at 0. These classes
follow optax's order of operations, so that a run continues one of the JAX
package's (``convert.load_jax_opt_state``).

An optimizer holds no parameters: ``init(params)`` returns its state for a
``{name: tensor}`` dict, and ``update(params, grads, state, step)`` updates
the parameters and the state in place. ``learning_rate`` is a float or a
callable of the step (0 for the first update), as an optax schedule.
``DecayedWeights(optimizer, weight_decay)`` is ``optax.chain(
optax.add_decayed_weights(weight_decay), optimizer)``.

The values that change from step to step (the learning rate, Adam's bias
corrections) are ``scalars(step)``, computed on the host. ``update`` reads
them from ``scalars``, a float32 ``[n]`` tensor of those values on the
parameters' device, where the caller gives one (the ``Trainer`` does, so
that a captured CUDA graph of its steps reads each step's values from
device memory), else from ``scalars(step)``. On the CPU a float and a
float32 tensor of the same value give bitwise the same products and
quotients.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

LearningRate = Union[float, Callable[[int], float]]
State = Dict[str, Dict[str, torch.Tensor]]


def learning_rate_at(learning_rate: LearningRate, step: int) -> float:
    return float(learning_rate(step)) if callable(learning_rate) else learning_rate


def _read(optimizer, step: int, scalars: Optional[torch.Tensor]) -> Sequence:
    """The step's scalars: ``scalars``' entries as 0-d tensors where given,
    else ``optimizer.scalars(step)``."""
    return optimizer.scalars(step) if scalars is None else scalars.unbind(0)


class SGD:
    """``optax.sgd`` without momentum: ``p += -lr * g``. It keeps no state
    (optax's is two ``EmptyState``s)."""

    def __init__(self, learning_rate: LearningRate):
        self.learning_rate = learning_rate

    def init(self, params: Mapping[str, torch.Tensor]) -> State:
        return {n: {} for n in params}

    def scalars(self, step: int) -> Tuple[float]:
        return (learning_rate_at(self.learning_rate, step),)

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: State, step: int,
               scalars: Optional[torch.Tensor] = None) -> None:
        (lr,) = _read(self, step, scalars)
        neg_lr = -lr
        for name, p in params.items():
            p.add_(grads[name] * neg_lr)


class Adagrad:
    """``optax.adagrad``: ``sum_of_squares += g*g`` (starting at
    ``initial_accumulator_value``), then
    ``p += -lr * g * rsqrt(sum_of_squares + eps)`` where the sum is > 0."""

    def __init__(self, learning_rate: LearningRate,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.learning_rate = learning_rate
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init(self, params: Mapping[str, torch.Tensor]) -> State:
        return {n: {"sum_of_squares": torch.full_like(
            p, self.initial_accumulator_value, requires_grad=False)}
            for n, p in params.items()}

    def scalars(self, step: int) -> Tuple[float]:
        return (learning_rate_at(self.learning_rate, step),)

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: State, step: int,
               scalars: Optional[torch.Tensor] = None) -> None:
        (lr,) = _read(self, step, scalars)
        neg_lr = -lr
        for name, p in params.items():
            g = grads[name]
            acc = state[name]["sum_of_squares"]
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + self.eps), 0.0)
            p.add_((inv * g) * neg_lr)


class Adam:
    """``optax.adam``: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
    bias corrections at step + 1, ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, learning_rate: LearningRate = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> State:
        return {n: {"mu": torch.zeros_like(p, requires_grad=False),
                    "nu": torch.zeros_like(p, requires_grad=False)}
                for n, p in params.items()}

    def scalars(self, step: int) -> Tuple[float, float, float]:
        """``(lr, 1 - b1**t, 1 - b2**t)`` at ``t = step + 1``, the bias
        corrections in float32, as optax computes them."""
        count = np.float32(step + 1)
        return (learning_rate_at(self.learning_rate, step),
                float(np.float32(1) - np.float32(self.b1) ** count),
                float(np.float32(1) - np.float32(self.b2) ** count))

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: State, step: int,
               scalars: Optional[torch.Tensor] = None) -> None:
        lr, bc1, bc2 = _read(self, step, scalars)
        neg_lr = -lr
        for name, p in params.items():
            g = grads[name]
            mu, nu = state[name]["mu"], state[name]["nu"]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) * neg_lr)


class DecayedWeights:
    """``optax.chain(optax.add_decayed_weights(weight_decay), optimizer)``:
    ``g + weight_decay * p`` goes to ``optimizer`` in place of ``g``. It
    keeps the state of ``optimizer`` (optax's ``add_decayed_weights`` keeps
    an ``EmptyState``, which carries nothing)."""

    def __init__(self, optimizer, weight_decay: float):
        self.optimizer = optimizer
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> State:
        return self.optimizer.init(params)

    def scalars(self, step: int) -> Tuple[float, ...]:
        return self.optimizer.scalars(step)

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: State, step: int,
               scalars: Optional[torch.Tensor] = None) -> None:
        decayed = {name: g + self.weight_decay * params[name] for name, g in grads.items()}
        self.optimizer.update(params, decayed, state, step, scalars)
