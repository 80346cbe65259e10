"""Recurrent cells for interest evolution: GRU, attention-gated AUGRU and LSTM
(counterpart of ``recommender_system_tpu/ops/rnn.py``).

Plain PyTorch loops over T; the JAX package's are one ``lax.scan`` and have
no Pallas kernel either. Each step's gates come from the input projection
of all T steps, computed up front as one product, and one product of the
state a gate group.

Gate layout as the JAX package's (keras's): ``wx[:, :H]`` is the keep gate
z, ``[:, H:2H]`` the reset gate r, ``[:, 2H:]`` the candidate; the reset gate
multiplies the state before the candidate's ``wh[:, 2H:]`` product. A GRU
step is ``h = z*h + (1-z)*hh``; an AUGRU step scales the update amount by
the attention, ``u = att*(1-z); h = (1-u)*h + u*hh``, so that ``att = 0``
keeps the state. Both are written as ``torch.lerp``, which rounds within an
f32 unit of the JAX package's form. A masked step carries the state (and,
as the output, the previous state) unchanged.

``dtype`` casts the gate products' operands (inputs, state and weights) as
the JAX package's ``_gates`` does; the products accumulate in f32, the bias
is added in f32, and the carry and outputs stay f32. ``remat`` and
``unroll`` are accepted for the JAX package's signature and ignored:
autograd keeps every step's residuals (at B=8,192, T=50, H=32 about 0.2 GB
for a GRU), and wrapping the step in ``torch.utils.checkpoint`` would add
host work to a loop that already issues ~50 small steps.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn


class GRUParams(NamedTuple):
    wx: torch.Tensor  # [D, 3H]
    wh: torch.Tensor  # [H, 3H]
    bias: Optional[torch.Tensor] = None  # [3H]


class LSTMParams(NamedTuple):
    wx: torch.Tensor  # [D, 4H], gate order i, f, c, o (keras's)
    wh: torch.Tensor  # [H, 4H]
    bias: torch.Tensor  # [4H]


def input_scale(input_dim: int) -> float:
    """``1 / sqrt(input_dim)`` rounded as the JAX package computes it in
    f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(input_dim)))


def orthogonal_blocks(generator: torch.Generator, hidden: int, blocks: int) -> torch.Tensor:
    """``blocks`` orthogonal ``[hidden, hidden]`` blocks side by side, each
    as Flax's ``orthogonal()`` draws one (QR of a normal matrix, the signs
    of R's diagonal folded into Q), from ``generator`` on its device."""
    out = torch.empty(hidden, blocks * hidden, device=generator.device)
    for b in range(blocks):
        nn.init.orthogonal_(out[:, b * hidden:(b + 1) * hidden], generator=generator)
    return out


def init_gru_params(generator: torch.Generator, input_dim: int, hidden: int,
                    use_bias: bool = True, dtype: torch.dtype = torch.float32) -> GRUParams:
    """``wx`` uniform on ``±1/sqrt(input_dim)``, ``wh`` three orthogonal
    blocks, ``bias`` zeros, drawn from ``generator`` on its device."""
    scale = input_scale(input_dim)
    device = generator.device
    wx = torch.rand(input_dim, 3 * hidden, generator=generator, device=device) * (2 * scale) - scale
    wh = orthogonal_blocks(generator, hidden, 3)
    bias = torch.zeros(3 * hidden, dtype=dtype, device=device) if use_bias else None
    return GRUParams(wx.to(dtype), wh.to(dtype), bias)


def init_lstm_params(generator: torch.Generator, input_dim: int, hidden: int,
                     dtype: torch.dtype = torch.float32,
                     forget_bias: float = 1.0) -> LSTMParams:
    """``wx`` uniform on ``±1/sqrt(input_dim)``, ``wh`` four orthogonal
    blocks, ``bias`` zeros but ``forget_bias`` on the forget gate, drawn
    from ``generator`` on its device."""
    scale = input_scale(input_dim)
    device = generator.device
    wx = torch.rand(input_dim, 4 * hidden, generator=generator, device=device) * (2 * scale) - scale
    wh = orthogonal_blocks(generator, hidden, 4)
    bias = torch.zeros(4 * hidden, dtype=dtype, device=device)
    bias[hidden: 2 * hidden] = forget_bias
    return LSTMParams(wx.to(dtype), wh.to(dtype), bias)


def _dot(a: torch.Tensor, b: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``dtype`` and the products
    summed in f32, as ``jnp.dot(..., preferred_element_type=f32)``."""
    if dtype is None or dtype == torch.float32:
        return a @ b
    return a.to(dtype).float() @ b.to(dtype).float()


def _steps(params: GRUParams, inputs: torch.Tensor, mask: Optional[torch.Tensor],
           h0: Optional[torch.Tensor], dtype):
    """The shared front of ``gru`` and ``augru``: each step's input
    projection (bias added) split into its gate and candidate parts, the
    state's weights split alike, the per-step masks and the initial
    state."""
    B, T, _ = inputs.shape
    H = params.wh.shape[0]
    proj_x = _dot(inputs, params.wx, dtype)
    if params.bias is not None:
        proj_x = proj_x + params.bias
    px_zr, px_c = proj_x.split([2 * H, H], dim=-1)
    wh = params.wh if dtype is None else params.wh.to(dtype).float()
    wh_zr, wh_c = wh.split([2 * H, H], dim=1)
    h = (torch.zeros(B, H, dtype=torch.float32, device=inputs.device) if h0 is None
         else h0.to(torch.float32))
    masks = (None,) * T if mask is None else mask.to(torch.bool)[..., None].unbind(1)
    return zip(px_zr.unbind(1), px_c.unbind(1), masks), wh_zr, wh_c, h


def _gates(px_zr: torch.Tensor, px_c: torch.Tensor, h: torch.Tensor,
           wh_zr: torch.Tensor, wh_c: torch.Tensor, dtype):
    """Keep gate z and candidate hh of one step from its input projection's
    gate part ``px_zr [B, 2H]`` and candidate part ``px_c [B, H]``."""
    hc = h if dtype is None else h.to(dtype).float()
    z, r = torch.sigmoid(px_zr + hc @ wh_zr).chunk(2, dim=1)
    rh = r * h if dtype is None else (r * h).to(dtype).float()
    hh = torch.tanh(px_c + rh @ wh_c)
    return z, hh


def gru(params: GRUParams, inputs: torch.Tensor, mask: Optional[torch.Tensor] = None,
        h0: Optional[torch.Tensor] = None, dtype: Optional[torch.dtype] = None,
        remat: bool = True, unroll: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over ``inputs [B, T, D]`` with an optional ``mask [B, T]`` ->
    (outputs ``[B, T, H]``, final state ``[B, H]``), f32. ``remat`` and
    ``unroll`` are ignored (see the module docstring)."""
    steps, wh_zr, wh_c, h = _steps(params, inputs, mask, h0, dtype)
    outs = []
    for px_zr, px_c, m in steps:
        z, hh = _gates(px_zr, px_c, h, wh_zr, wh_c, dtype)
        h_new = torch.lerp(hh, h, z)  # z*h + (1-z)*hh: z is the keep gate
        h = h_new if m is None else torch.where(m, h_new, h)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def augru(params: GRUParams, inputs: torch.Tensor, att_scores: torch.Tensor,
          mask: Optional[torch.Tensor] = None, h0: Optional[torch.Tensor] = None,
          dtype: Optional[torch.dtype] = None, remat: bool = True,
          unroll: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention-gated GRU (DIEN's interest evolution): ``att_scores [B, T]``
    scales each step's update amount -> (outputs ``[B, T, H]``, final state
    ``[B, H]``), f32. ``remat`` and ``unroll`` are ignored."""
    steps, wh_zr, wh_c, h = _steps(params, inputs, mask, h0, dtype)
    atts = att_scores[..., None].unbind(1)
    outs = []
    for (px_zr, px_c, m), a in zip(steps, atts):
        z, hh = _gates(px_zr, px_c, h, wh_zr, wh_c, dtype)
        h_new = torch.lerp(h, hh, a * (1.0 - z))  # (1-u)*h + u*hh
        h = h_new if m is None else torch.where(m, h_new, h)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def lstm(params: LSTMParams, inputs: torch.Tensor,
         mask: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """LSTM over ``[B, T, D]`` -> (outputs ``[B, T, H]``, (h ``[B, H]``, c
    ``[B, H]``)), with the recurrent term in the forget gate (the JAX
    package's ``lstm``). A masked step carries h and c unchanged."""
    B, T, _ = inputs.shape
    H = params.wh.shape[0]
    xs = (inputs @ params.wx + params.bias).unbind(1)
    masks = (None,) * T if mask is None else mask.to(torch.bool)[..., None].unbind(1)
    h = torch.zeros(B, H, dtype=torch.float32, device=inputs.device)
    c = torch.zeros_like(h)
    outs = []
    for px, m in zip(xs, masks):
        gates = px + h @ params.wh
        i_f = torch.sigmoid(gates[:, :2 * H])
        i, f = i_f[:, :H], i_f[:, H:]
        g = torch.tanh(gates[:, 2 * H: 3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if m is not None:
            h_new, c_new = torch.where(m, h_new, h), torch.where(m, c_new, c)
        h, c = h_new, c_new
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)
