"""Parametric interaction modules (counterparts of
``recommender_system_tpu/layers/interaction.py``).

Module and parameter names are the JAX package's, so that ``convert.py``
maps each Flax parameter onto its counterpart: Dense layers are
``nn.Linear`` (``weight [out, in]``, the transpose of Flax's kernel),
FGCNN's convolutions ``nn.Conv2d`` (``weight [out, in, kh, kw]``), and
``OuterProductLayer``'s ``kernel`` and ``MMoELayer``'s ``experts`` and
``gates`` stay in the JAX layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dispatch import DeviceLike, resolve_device
from ..ops.interactions import pairwise_inner, pairwise_outer
from ..ops.kernels import cross_fused, fm_fused
from ..parallel.mesh import Mesh, Placement, gather_peers, peers_to_rows, sharding_rule
from .core import activation_fn, dense, lecun_normal_


class FMLayer(nn.Module):
    """Full FM, first and second order, on a dense or one-hot input
    ``[B, D]``: ``w0 + x.w1 + 0.5 sum((x v)^2 - x^2 v^2)`` -> the raw logit
    ``[B, 1]``, through the ``fm_fused`` kernel on CUDA (its plain version
    on the CPU).

    Parameters ``w0 [1]`` (zeros), ``w1 [D, 1]`` and ``v [D, factor_dim]``
    (both ``normal(0, init_std)``, drawn from ``generator`` in that order).
    ``use_pallas`` is accepted for the JAX package's signature and ignored:
    on the card it takes a kernel of ``csrc/fm.cu`` at every shape (the
    global kernel where ``fm_kernel_takes`` is False). Runs on the card
    unless ``device`` names another."""

    def __init__(self, in_features: int, factor_dim: int, init_std: float = 0.05,
                 use_pallas: Optional[bool] = None, *, device: DeviceLike = None,
                 generator: torch.Generator):
        super().__init__()
        device = resolve_device(device)
        self.w0 = nn.Parameter(torch.zeros(1, device=device))
        self.w1 = nn.Parameter(
            (torch.randn(in_features, 1, generator=generator, device=generator.device)
             * init_std).to(device))
        self.v = nn.Parameter(
            (torch.randn(in_features, factor_dim, generator=generator,
                         device=generator.device) * init_std).to(device))

    def forward(self, x):
        return fm_fused(x, self.w1, self.v) + self.w0


class CrossNet(nn.Module):
    """DCN cross network stack: the L-layer recurrence in one ``cross_fused``
    kernel launch on CUDA. Parameters ``weights`` and ``biases`` are
    ``[L, D]``, drawn as ``normal(0, init_std)``."""

    def __init__(self, in_features: int, num_layers: int,
                 init_std: float = 0.05, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        shape = (num_layers, in_features)
        self.weights = nn.Parameter(
            (torch.randn(shape, generator=generator, device=generator.device)
             * init_std).to(device))
        self.biases = nn.Parameter(
            (torch.randn(shape, generator=generator, device=generator.device)
             * init_std).to(device))

    def forward(self, x):
        return cross_fused(x, self.weights, self.biases)


class InnerProductLayer(nn.Module):
    """PNN's inner products ``<e_i, e_j>``, ``i < j`` (no parameters):
    ``[B, F, k] -> [B, F(F-1)/2]``."""

    def forward(self, embeds):
        return pairwise_inner(embeds)


class OuterProductLayer(nn.Module):
    """PNN's kernel-weighted outer products: ``[B, F, k] -> [B, P]``.
    Parameter ``kernel [k, P, k]``, P = F(F-1)/2, in the JAX package's
    layout (``convert.py`` copies it as it is), ``normal(0, init_std)``."""

    def __init__(self, num_fields: int, embedding_dim: int, init_std: float = 0.05, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        pairs = num_fields * (num_fields - 1) // 2
        self.kernel = nn.Parameter(
            (torch.randn(embedding_dim, pairs, embedding_dim, generator=generator,
                         device=generator.device) * init_std).to(device))

    def forward(self, embeds):
        return pairwise_outer(embeds, self.kernel)


class AFMAttention(nn.Module):
    """Attention pooling over interaction pairs: ``att_w`` (Dense, relu),
    ``att_h`` (Dense to 1), a softmax over the pairs, the weighted sum:
    ``[B, P, k] -> [B, k]``."""

    def __init__(self, embedding_dim: int, attention_units: int, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.att_w = dense(embedding_dim, attention_units, device=device, generator=generator)
        self.att_h = dense(attention_units, 1, device=device, generator=generator)

    def forward(self, pair_embeds):
        score = self.att_h(F.relu(self.att_w(pair_embeds)))  # [B, P, 1]
        att = torch.softmax(score, dim=1)
        return torch.sum(att * pair_embeds, dim=1)


class ResBlock(nn.Module):
    """DeepCrossing's residual unit, ``relu(x + proj(MLP(x)))``: Dense
    layers ``dense_{i}`` with relu, then ``proj`` back to the input width."""

    def __init__(self, in_features: int, hidden_units: Sequence[int], *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.hidden_units = tuple(hidden_units)
        width = in_features
        for i, units in enumerate(self.hidden_units):
            self.add_module(f"dense_{i}", dense(width, units, device=device,
                                                generator=generator))
            width = units
        self.proj = dense(width, in_features, device=device, generator=generator)

    def forward(self, x):
        h = x
        for i in range(len(self.hidden_units)):
            h = F.relu(getattr(self, f"dense_{i}")(h))
        return F.relu(x + self.proj(h))


class FGCNN(nn.Module):
    """Feature-generation CNN: per stage a convolution over the fields
    (``conv_{i}``, kernel ``(kernel_width, 1)``, Flax's ``"SAME"`` padding,
    tanh), a max pool of ``(pooling_width, 1)`` that floors, and a Dense
    recombination (``recomb_{i}``, relu) into ``dnn_maps * H`` new fields:
    ``[B, F, k] -> [B, F_new, k]``. The recombination reads the pooled maps
    flattened as Flax's NHWC ``[B, H, k, C]``, so transplanted weights
    match. With 26 fields and the defaults the stages keep 13 and 6 rows,
    3 * 13 + 3 * 6 = 57 new fields."""

    def __init__(self, num_fields: int, embedding_dim: int,
                 filters: Sequence[int] = (14, 16), kernel_width: Sequence[int] = (7, 7),
                 dnn_maps: Sequence[int] = (3, 3), pooling_width: Sequence[int] = (2, 2), *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.stages = tuple(zip(filters, kernel_width, dnn_maps, pooling_width))
        k = embedding_dim
        h, channels = num_fields, 1
        self.out_fields = 0
        for i, (f, kw, maps, pw) in enumerate(self.stages):
            conv = nn.utils.skip_init(nn.Conv2d, channels, f, (kw, 1), padding="same",
                                      device=device)
            with torch.no_grad():
                # Flax's lecun_normal over the fan-in kh * kw * in
                flat = torch.empty(f, channels * kw, device=device)
                lecun_normal_(flat, generator)
                conv.weight.copy_(flat.reshape(conv.weight.shape))
                conv.bias.zero_()
            self.add_module(f"conv_{i}", conv)
            h, channels = h // pw, f
            self.add_module(f"recomb_{i}", dense(h * k * f, maps * h * k, device=device,
                                                 generator=generator))
            self.out_fields += maps * h

    def forward(self, embeds):  # [B, F, k]
        B, _, k = embeds.shape
        x = embeds[:, None, :, :]  # [B, 1, F, k] (NCHW)
        new_maps = []
        for i, (_, _, maps, pw) in enumerate(self.stages):
            x = torch.tanh(getattr(self, f"conv_{i}")(x))
            x = F.max_pool2d(x, kernel_size=(pw, 1), stride=(pw, 1))
            h = x.shape[2]
            flat = x.permute(0, 2, 3, 1).reshape(B, -1)  # Flax's NHWC order
            out = F.relu(getattr(self, f"recomb_{i}")(flat))
            new_maps.append(out.reshape(B, maps * h, k))
        return torch.cat(new_maps, dim=1)


class MMoELayer(nn.Module):
    """Multi-gate mixture of experts: ``[B, D] -> T`` task inputs ``[B, H]``.

    Parameters in the JAX package's layout (``convert.py`` copies them as
    they are), each ``normal(0, init_std)`` drawn from ``generator`` in this
    order: ``experts [D, H, E]``, ``expert_bias [H, E]``, ``gates [T, D,
    E]``, ``gate_bias [T, E]``. The experts are one einsum, relu; each
    task's gate a softmax over the experts; each task's input the gated sum
    of the experts' outputs.

    Expert parallelism (``shard``, which the ``Trainer`` calls on a mesh
    with a model axis): a rank keeps ``E / model`` experts (the last axis of
    ``experts`` and ``expert_bias``), computes them on its data group's
    rows (its model peers' rows, ``gather_peers``) and gets every expert's
    output on its own rows back from its peers (``peers_to_rows``). The
    gates stay replicated, on the rank's own rows."""

    def __init__(self, in_features: int, num_experts: int, expert_units: int,
                 num_tasks: int, use_expert_bias: bool = True, use_gate_bias: bool = True,
                 init_std: float = 0.05, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.num_tasks = num_tasks

        def normal(*shape):
            return nn.Parameter((torch.randn(shape, generator=generator,
                                             device=generator.device) * init_std).to(device))

        self.experts = normal(in_features, expert_units, num_experts)
        self.expert_bias = normal(expert_units, num_experts) if use_expert_bias else None
        self.gates = normal(num_tasks, in_features, num_experts)
        self.gate_bias = normal(num_tasks, num_experts) if use_gate_bias else None
        self.mesh: Optional[Mesh] = None
        self.placements: Dict[str, Placement] = {}

    def shard(self, mesh: Mesh) -> None:
        """Keep this rank's experts on a mesh with a model axis (the JAX
        package's ``expert_sharding``); a no-op where ``model == 1``."""
        if self.mesh is not None:
            raise ValueError("the experts are sharded already")
        if mesh.model == 1:
            return
        for name in ("experts", "expert_bias"):
            param = getattr(self, name)
            if param is None:
                continue
            placement = sharding_rule(name, tuple(param.shape), mesh)
            self.placements[name] = placement
            setattr(self, name, nn.Parameter(placement.shard(param.detach(), mesh)))
        self.mesh = mesh

    def forward(self, x):  # [B, D]
        rows = x if self.mesh is None else gather_peers(x, self.mesh.model_axis)
        expert_out = torch.einsum("bd,dhe->bhe", rows, self.experts)
        if self.expert_bias is not None:
            expert_out = expert_out + self.expert_bias
        expert_out = F.relu(expert_out)  # [B, H, E], or this rank's experts
        if self.mesh is not None:
            expert_out = peers_to_rows(expert_out, self.mesh.model_axis)
        gate_logits = torch.einsum("bd,tde->bte", x, self.gates)
        if self.gate_bias is not None:
            gate_logits = gate_logits + self.gate_bias
        gates = torch.softmax(gate_logits, dim=-1)  # [B, T, E]
        task_outs = torch.einsum("bhe,bte->bth", expert_out, gates)
        return [task_outs[:, t, :] for t in range(self.num_tasks)]


class TowerLayer(nn.Module):
    """A task's output tower: Dense layers ``dense_{i}`` with ``activation``,
    then a linear ``output`` of ``output_dim``."""

    def __init__(self, in_features: int, hidden_units: Sequence[int], output_dim: int,
                 activation: str = "relu", *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_units = tuple(hidden_units)
        self._act = activation_fn(activation)
        width = in_features
        for i, units in enumerate(self.hidden_units):
            self.add_module(f"dense_{i}", dense(width, units, device=device,
                                                generator=generator))
            width = units
        self.output = dense(width, output_dim, device=device, generator=generator)

    def forward(self, x):
        for i in range(len(self.hidden_units)):
            x = self._act(getattr(self, f"dense_{i}")(x))
        return self.output(x)
