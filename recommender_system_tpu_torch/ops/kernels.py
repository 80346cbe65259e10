"""Hand-written CUDA kernels: build, binding and wrappers.

Each kernel source ``csrc/<name>.cu`` exposes a plain C function. It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at
first use (the hash covers the source and the flags, so an edited source is
rebuilt) and loaded with ``ctypes``. Nothing is built or loaded while this
module is imported.

Wrappers (see ``ops/dispatch.py``): a CUDA tensor launches the kernel, a CPU
tensor runs the kernel's plain version. Each wrapper counts its launches in
an integer attribute, ``<wrapper>.launches``, which only a launch raises.

``cross_fused``, ``fm_fused`` and ``din_attention_fused`` take every input the
JAX package computes: each makes its inputs contiguous float32, and each
source has, beside its fast kernels with their shared-memory and width
limits, a global kernel that takes the other shapes (the cross and FM ones
read the weights from global memory; the attention's stages them in shared
memory in chunks, on the tensor cores). Before the launch, each wrapper
asks its predicate (``cross_kernel_takes``, ``fm_kernel_takes``,
``din_kernel_takes``: True exactly where ``check_*_args`` would not raise)
which of the two entry points to call, and counts a launch of the global
kernel also in ``<wrapper>.global_launches``. A CUDA tensor never runs the
plain version; a build failure or a launch error raises.

- ``cross_fused`` (``csrc/cross.cu``), plain version ``cross_network``;
- ``fm_fused`` (``csrc/fm.cu``), plain version ``fm_ref``;
- ``din_attention_fused`` (``csrc/din_attention.cu``), plain version
  ``din_attention_ref``; its backward ``din_attention_backward`` (the same
  source: a tile kernel where ``din_backward_kernel_takes``, DIN's and
  DIEN's scorer; a wide kernel where ``din_backward_wide_takes``, K up to
  128 and any T at that scorer; else a global kernel at every shape the
  forward takes), plain version ``din_attention_backward_ref``
  (``ops/din_vjp.py``);
- ``fused_adagrad_apply``, ``fused_sgd_apply`` and ``fused_adam_apply``
  (``ops/fused_adagrad.py``) and ``scatter_add_sorted``
  (``ops/embedding_grad.py``), whose kernels are in ``csrc/sparse_rows.cu``;
  this module launches them. All four sum rows of ``SPARSE_CHUNK``
  positions or more in chunks (the long path, a second kernel every
  launch, on scratch from ``sparse_rows_scratch``), and count it in
  ``<wrapper>.long_launches``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .din_vjp import din_attention_backward_ref
from .dispatch import use_kernel
from .interactions import cross_network, fm_interaction
from .seqpool import NEG_INF

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_INT64, _FLOAT = ctypes.c_longlong, ctypes.c_float
# source name -> {C function: (argument types, return type)}; every pointer
# and the stream as c_void_p, or ctypes would pass a 32-bit int
SOURCES = {
    "cross": {"cross_forward": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
              "cross_global_forward": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT)},
    "fm": {"fm_forward": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
           "fm_global_forward": ([_PTR] * 5 + [_INT] * 3 + [_PTR], _INT)},
    "din_attention": {
        "din_attention_forward": ([_PTR] * 11 + [_INT] * 8 + [_PTR], _INT),
        "din_attention_global_forward": ([_PTR] * 11 + [_INT] * 8 + [_PTR], _INT),
        "din_attention_backward": ([_PTR] * 20 + [_INT] * 8 + [_PTR], _INT),
        "din_attention_backward_scratch": ([_INT] * 5, _INT64),
        "din_attention_wide_backward": ([_PTR] * 20 + [_INT] * 8 + [_PTR], _INT),
        "din_attention_wide_backward_scratch": ([_INT] * 5, _INT64),
        "din_attention_global_backward": ([_PTR] * 20 + [_INT] * 8 + [_PTR], _INT),
        "din_attention_global_backward_scratch": ([_INT] * 5, _INT64),
    },
    "sparse_rows": {
        "fused_adagrad_rows": ([_PTR] * 7 + [_INT64, _INT, _PTR, _FLOAT, _PTR], _INT),
        "fused_sgd_rows": ([_PTR] * 6 + [_INT64, _INT, _PTR, _PTR], _INT),
        "fused_adam_rows": ([_PTR] * 8 + [_INT64, _INT, _PTR] + [_FLOAT] * 5 + [_PTR], _INT),
        "scatter_add_rows": ([_PTR] * 6 + [_INT64, _INT, _PTR], _INT),
    },
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    if os.environ.get("CUDA_HOME"):
        return str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build() -> Dict[str, str]:
    """Compile every kernel source that has no library yet, one ``nvcc`` per
    source, all started together. Returns each compiled source's ``nvcc``
    output (``-Xptxas -v``: registers, shared memory, spills); raises with
    that output if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            continue
        partial = target.with_name(f"{target.name}.{os.getpid()}.part")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, partial, proc))
    logs = {}
    for name, target, partial, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{logs[name]}")
        os.replace(partial, target)
    return logs


def _library(name: str) -> ctypes.CDLL:
    if name not in _libraries:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in SOURCES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libraries[name] = lib
    return _libraries[name]


# ---------------------------------------------------------------------------
# DCN cross stack (csrc/cross.cu)
# ---------------------------------------------------------------------------

# shared memory one block may take on the H100 (227 KB)
MAX_SHARED_BYTES = 232_448
CROSS_MAX_DIM = 1024


def _cross_form_fault(x0: torch.Tensor, weights: torch.Tensor,
                      biases: torch.Tensor) -> Optional[Exception]:
    """What no kernel of ``csrc/cross.cu`` takes in these inputs, or None."""
    for t, what in ((x0, "x0"), (weights, "weights"), (biases, "biases")):
        if t.dtype != torch.float32:
            return TypeError(f"cross_fused kernel takes float32, {what} is {t.dtype}")
        if not t.is_contiguous():
            return ValueError(f"cross_fused kernel takes contiguous tensors, {what} is not")
    if x0.dim() != 2 or weights.dim() != 2 or weights.shape != biases.shape:
        return ValueError("cross_fused takes x0 [B, D], weights and biases [L, D]; "
                          f"got {tuple(x0.shape)}, {tuple(weights.shape)}, "
                          f"{tuple(biases.shape)}")
    B, D = x0.shape
    L = weights.shape[0]
    if weights.shape[1] != D:
        return ValueError(f"weights width {weights.shape[1]} != x0 width {D}")
    if not 0 < D < 2 ** 31 or B >= 2 ** 31 or L >= 2 ** 31:
        return ValueError(f"cross_fused kernels take 0 < D, B, L < 2**31, got "
                          f"B={B}, D={D}, L={L}")
    return None


def _cross_fault(x0: torch.Tensor, weights: torch.Tensor,
                 biases: torch.Tensor) -> Optional[Exception]:
    """Why the tile and stack kernels do not take these inputs, or None."""
    fault = _cross_form_fault(x0, weights, biases)
    if fault is not None:
        return fault
    L, D = weights.shape
    if D > CROSS_MAX_DIM:
        return ValueError(f"cross_fused kernel takes 0 < D <= {CROSS_MAX_DIM}, got {D}")
    if 2 * L * D * 4 > MAX_SHARED_BYTES:
        return ValueError(f"cross_fused kernel: L={L}, D={D} needs "
                          f"{2 * L * D * 4} bytes of shared memory, more than "
                          f"{MAX_SHARED_BYTES}")
    return None


def check_cross_args(x0: torch.Tensor, weights: torch.Tensor,
                     biases: torch.Tensor) -> None:
    """Raise on anything the tile and stack kernels do not take."""
    fault = _cross_fault(x0, weights, biases)
    if fault is not None:
        raise fault


def check_cross_global_args(x0: torch.Tensor, weights: torch.Tensor,
                            biases: torch.Tensor) -> None:
    """Raise on anything the global kernel does not take: it has no width
    or shared-memory limit."""
    fault = _cross_form_fault(x0, weights, biases)
    if fault is not None:
        raise fault


def cross_kernel_takes(x0: torch.Tensor, weights: torch.Tensor,
                       biases: torch.Tensor) -> bool:
    """True exactly where ``check_cross_args`` would not raise: the shapes,
    dtypes and layouts alone decide. Where it is False, ``cross_fused``
    launches the global kernel."""
    return _cross_fault(x0, weights, biases) is None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _cross_launch(x0: torch.Tensor, weights: torch.Tensor,
                  biases: torch.Tensor) -> torch.Tensor:
    fast = cross_kernel_takes(x0, weights, biases)
    (check_cross_args if fast else check_cross_global_args)(x0, weights, biases)
    out = torch.empty_like(x0)
    B, D = x0.shape
    if B == 0:
        return out
    entry = "cross_forward" if fast else "cross_global_forward"
    lib = _library("cross")
    with torch.cuda.device(x0.device):
        err = getattr(lib, entry)(x0.data_ptr(), weights.data_ptr(), biases.data_ptr(),
                                  out.data_ptr(), B, D, weights.shape[0], _stream(x0))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    cross_fused.launches += 1
    cross_fused.global_launches += not fast
    return out


class _CrossFused(torch.autograd.Function):
    """Forward: a kernel on CUDA, ``cross_network`` on the CPU. Backward:
    the VJP of ``cross_network`` recomputed from the saved inputs, as the
    JAX package's ``_cross_bwd`` does; there is no backward kernel."""

    @staticmethod
    def forward(ctx, x0, weights, biases):
        ctx.save_for_backward(x0, weights, biases)
        if use_kernel(x0, weights, biases):
            return _cross_launch(x0, weights, biases)
        return cross_network(x0, weights, biases)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = cross_network(*inputs)
        # with no layers the weights and biases take no part: zero gradients
        grads = torch.autograd.grad(out, inputs, grad, allow_unused=True)
        return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs))


def cross_fused(x0: torch.Tensor, weights: torch.Tensor,
                biases: torch.Tensor) -> torch.Tensor:
    """DCN cross stack ``x_{l+1} = x0 (x_l.w_l) + b_l + x_l`` -> ``[B, D]``
    float32, the whole stack in one kernel launch on CUDA: the tile or stack
    kernel where ``cross_kernel_takes``, else the global kernel. The inputs
    are made contiguous float32 first."""
    args = [t.to(torch.float32).contiguous() for t in (x0, weights, biases)]
    return _CrossFused.apply(*args)


cross_fused.launches = 0
cross_fused.global_launches = 0


# ---------------------------------------------------------------------------
# FM logit (csrc/fm.cu)
# ---------------------------------------------------------------------------

def fm_ref(x: torch.Tensor, w1: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x @ w1 + fm_interaction(x, v)`` -> ``[B, 1]``, as the
    JAX package's ``_fm_ref``."""
    return x @ w1 + fm_interaction(x, v)


# the shapes that csrc/fm.cu's register kernel (fm_rows_kernel) takes; its
# wide kernel (fm_wide_kernel) takes the others
FM_ROWS_MAX_DIM, FM_ROWS_FACTORS = 256, 8


def fm_shared_bytes(D: int, k: int) -> int:
    """Shared memory of a block of ``csrc/fm.cu`` for ``x [B, D]``, ``v [D,
    k]``, float32: for D <= 256 and k <= 8 the register kernel's v
    (transposed, 8 factors) and its two coefficients for ``32 * ceil(D /
    32)`` columns; else the wide kernel's v and v*v ``[k, D]`` and w1
    ``[D]``."""
    if D <= FM_ROWS_MAX_DIM and k <= FM_ROWS_FACTORS:
        return 4 * 32 * -(-D // 32) * (FM_ROWS_FACTORS + 2)
    return 4 * D * (2 * k + 1)


def fm_global_coef_floats(D: int, k: int) -> int:
    """Floats of the scratch that ``csrc/fm.cu``'s global kernel folds w1
    and v into: per group of 8 factors, rows a, c and v_0..v_7 over D
    rounded up to its chunk of 128 columns."""
    return -(-k // 8) * 10 * (-(-D // 128) * 128)


def _fm_form_fault(x: torch.Tensor, w1: torch.Tensor,
                   v: torch.Tensor) -> Optional[Exception]:
    """What no kernel of ``csrc/fm.cu`` takes in these inputs, or None."""
    for t, what in ((x, "x"), (w1, "w1"), (v, "v")):
        if t.dtype != torch.float32:
            return TypeError(f"fm_fused kernel takes float32, {what} is {t.dtype}")
        if not t.is_contiguous():
            return ValueError(f"fm_fused kernel takes contiguous tensors, {what} is not")
    if x.dim() != 2 or w1.dim() != 2 or v.dim() != 2:
        return ValueError("fm_fused takes x [B, D], w1 [D, 1] and v [D, k]; got "
                          f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(v.shape)}")
    B, D = x.shape
    k = v.shape[1]
    if tuple(w1.shape) != (D, 1) or v.shape[0] != D:
        return ValueError(f"fm_fused: x is [{B}, {D}], so w1 must be [{D}, 1] and v "
                          f"[{D}, k]; got {tuple(w1.shape)}, {tuple(v.shape)}")
    if D == 0 or k == 0:
        return ValueError(f"fm_fused kernel takes D > 0 and k > 0, got D={D}, k={k}")
    if B >= 2 ** 31 or D >= 2 ** 31 or k >= 2 ** 31:
        return ValueError(f"fm_fused kernels take B, D, k < 2**31, got B={B}, D={D}, k={k}")
    return None


def _fm_fault(x: torch.Tensor, w1: torch.Tensor, v: torch.Tensor) -> Optional[Exception]:
    """Why the rows and wide kernels do not take these inputs, or None."""
    fault = _fm_form_fault(x, w1, v)
    if fault is not None:
        return fault
    D, k = v.shape
    if fm_shared_bytes(D, k) > MAX_SHARED_BYTES:
        return ValueError(f"fm_fused kernel: D={D}, k={k} needs {fm_shared_bytes(D, k)} "
                          f"bytes of shared memory, more than {MAX_SHARED_BYTES}")
    return None


def check_fm_args(x: torch.Tensor, w1: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the rows and wide kernels do not take."""
    fault = _fm_fault(x, w1, v)
    if fault is not None:
        raise fault


def check_fm_global_args(x: torch.Tensor, w1: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the global kernel does not take: it has no
    shared-memory limit."""
    fault = _fm_form_fault(x, w1, v)
    if fault is not None:
        raise fault


def fm_kernel_takes(x: torch.Tensor, w1: torch.Tensor, v: torch.Tensor) -> bool:
    """True exactly where ``check_fm_args`` would not raise: the shapes,
    dtypes and layouts alone decide. Where it is False, ``fm_fused``
    launches the global kernel."""
    return _fm_fault(x, w1, v) is None


def _fm_launch(x: torch.Tensor, w1: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    fast = fm_kernel_takes(x, w1, v)
    (check_fm_args if fast else check_fm_global_args)(x, w1, v)
    B, D = x.shape
    out = torch.empty((B, 1), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    entry = "fm_forward" if fast else "fm_global_forward"
    k = v.shape[1]
    # the global kernel's folded coefficients
    scratch = () if fast else (torch.empty(fm_global_coef_floats(D, k), dtype=torch.float32,
                                           device=x.device),)
    lib = _library("fm")
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(*(t.data_ptr() for t in (x, w1, v, out, *scratch)),
                                  B, D, k, _stream(x))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    fm_fused.launches += 1
    fm_fused.global_launches += not fast
    return out


class _FmFused(torch.autograd.Function):
    """Forward: a kernel on CUDA, ``fm_ref`` on the CPU. Backward: the VJP
    of ``fm_ref`` recomputed from the saved inputs, as the JAX package's
    ``_fm_bwd`` does; there is no backward kernel."""

    @staticmethod
    def forward(ctx, x, w1, v):
        ctx.save_for_backward(x, w1, v)
        if use_kernel(x, w1, v):
            return _fm_launch(x, w1, v)
        return fm_ref(x, w1, v)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = fm_ref(*inputs)
        return torch.autograd.grad(out, inputs, grad)


def fm_fused(x: torch.Tensor, w1: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """FM logit without the global bias, ``x.w1 + 0.5 sum((xv)^2 - x^2 v^2)``
    -> ``[B, 1]`` float32, in one kernel launch on CUDA: the rows or wide
    kernel where ``fm_kernel_takes``, else the global kernel. The inputs are
    made contiguous float32 first."""
    return _FmFused.apply(*(t.to(torch.float32).contiguous() for t in (x, w1, v)))


fm_fused.launches = 0
fm_fused.global_launches = 0


# ---------------------------------------------------------------------------
# DIN target attention (csrc/din_attention.cu)
# ---------------------------------------------------------------------------

DIN_MAX_HIDDEN = 256
DIN_ACTIVATIONS = {"sigmoid": torch.sigmoid, "relu": F.relu}


def din_attention_ref(query: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
                      w1, b1, w2, b2, w3, b3, activation: str = "sigmoid",
                      weight_normalization: bool = True,
                      return_scores: bool = False) -> torch.Tensor:
    """Plain version: ``query [B, K]``, ``keys [B, T, K]``, ``mask [B, T]``
    (bool, or float and valid where > 0.5) -> pooled ``[B, K]`` (or the
    weights ``[B, T]``). The scorer MLP over ``[q, k, q-k, q*k]`` has its
    first layer folded exactly as the JAX package's ``din_attention_ref``
    folds it, ``q (Wq+Wm) + [k | q*k] [Wk-Wm ; Wp]``; a masked position
    scores ``NEG_INF`` before the softmax (or 0 without it)."""
    if activation not in DIN_ACTIVATIONS:
        raise ValueError(activation)
    act = DIN_ACTIVATIONS[activation]
    K = keys.shape[-1]
    wq, wk, wm, wp = w1[:K], w1[K:2 * K], w1[2 * K:3 * K], w1[3 * K:]
    ck = torch.cat([keys, query[:, None, :] * keys], dim=-1)
    wkp = torch.cat([wk - wm, wp], dim=0)
    h_pre = (query @ (wq + wm))[:, None, :] + ck @ wkp
    h = act(h_pre + b1)
    h = act(h @ w2 + b2)
    score = (h @ w3 + b3)[..., 0]
    valid = mask if mask.dtype == torch.bool else mask > 0.5
    if weight_normalization:
        score = torch.softmax(torch.where(valid, score, NEG_INF), dim=-1)
    else:
        score = torch.where(valid, score, 0.0)
    if return_scores:
        return score
    return torch.einsum("bt,btk->bk", score, keys)


# layer-1 tile counts that csrc/din_attention.cu instantiates, and the
# n-tiles of its layer-2 chunk: the kernel rounds H1 up to 8 * a count and
# H2 up to whole chunks, with zero weights past them
DIN_TILES1 = (2, 4, 6, 8, 10, 12, 16, 24, 32)
DIN_TILES2 = 5


def din_shared_bytes(T: int, K: int, H1: int, H2: int, rows: int = 1) -> int:
    """Shared memory of a block of ``csrc/din_attention.cu`` whose groups
    hold ``rows`` batch rows (``make_layout`` there; the kernel takes up to
    16 where they fit): both layers' weights split into TF32 big and small
    parts in fragment order, ``Wq + Wm`` and the biases; two buffers of a
    group's keys (rows padded to ``K`` rounded up to 8, plus 4), query and
    mask; the group's per-row term and scores. Each part is rounded up to 4
    floats."""
    def up(x: int, m: int = 4) -> int:
        return -(-x // m) * m

    tiles1 = min((t for t in DIN_TILES1 if 8 * t >= H1), default=DIN_TILES1[-1])
    S, K2, H1p, H2p = up(K, 8) + 4, up(2 * K, 8), 8 * tiles1, up(H2, 8 * DIN_TILES2)
    weights = (up(2 * K2 * H1p) + up(2 * H1p * H2p) + up(K * H1) + up(H1p)
               + 2 * up(H2p) + up(1))
    buffer = up(rows * T * S) + up(rows * K) + up(rows * T)
    return 4 * (weights + 2 * buffer + up(rows * H1p) + up(rows * T))


# h-chunk widths, in n-tiles, of the global kernel's instantiations; its
# z-chunks hold 5 n-tiles (40 columns) of H2
DIN_GLOBAL_TILES = (4, 8, 10, 16)
DIN_GLOBAL_ZTILES = 5


def din_global_threads(nh: int) -> int:
    """Threads of a block of the global kernel whose h-chunks hold ``nh``
    n-tiles: three warpgroups of 4 warps, or two for the widest h-chunk."""
    return 32 * (12 if nh <= 10 else 8)


def din_global_tiles(H1: int) -> int:
    """The global kernel's h-chunk width in n-tiles for ``H1``: the one that
    pads ``ceil(H1 / 8)`` the least, the widest on a tie."""
    need = -(-H1 // 8)
    return min(DIN_GLOBAL_TILES, key=lambda nh: (-(-need // nh) * nh, -nh))


def din_global_shared_bytes(K: int, H1: int, H2: int, rows: int = 1, jb: int = 1,
                            resident: bool = False) -> int:
    """Shared memory of a block of ``csrc/din_attention.cu``'s global kernel
    (``make_global_plan`` there) whose groups hold ``rows`` batch rows: the
    weights split into TF32 big and small parts as wgmma's K-major core
    matrices, either
    every chunk (``resident``) or one chunk of layer 1 (``jb`` 16-column
    blocks of K by one h-chunk of H1) and one block of layer 2 (the
    h-chunk's rows by a z-chunk of H2); the group's queries (K rounded up to
    16) and per-row terms (H1 rounded up to whole h-chunks); 4 floats a
    thread for the softmax's and the pooling's sums. Each part is rounded up
    to 4 floats. T takes none: the scores go to device memory."""
    def up(x: int) -> int:
        return -(-x // 4) * 4

    nh = din_global_tiles(H1)
    hchunks = -(-(-(-H1 // 8)) // nh)
    zt = DIN_GLOBAL_ZTILES
    zchunks = -(-(-(-H2 // 8)) // zt)
    nb = -(-K // 16)
    jb = nb if resident else jb
    jchunks = -(-nb // jb)
    c1, c2 = 128 * jb * 4 * nh, 128 * nh * zt
    weights = (up(c1 * hchunks * jchunks) + up(c2 * hchunks * zchunks) if resident
               else up(c1) + up(c2))
    return 4 * (weights + up(rows * 16 * nb) + up(rows * 8 * nh * hchunks)
                + up(4 * din_global_threads(nh)))


def _din_form_fault(query, keys, mask, w1, b1, w2, b2, w3, b3,
                    activation) -> Optional[Exception]:
    """What no kernel of ``csrc/din_attention.cu`` takes in these inputs, or
    None."""
    named = dict(query=query, keys=keys, mask=mask, w1=w1, b1=b1, w2=w2, b2=b2,
                 w3=w3, b3=b3)
    for what, t in named.items():
        if t.dtype != torch.float32:
            return TypeError(f"din_attention_fused kernel takes float32, {what} is {t.dtype}")
        if not t.is_contiguous():
            return ValueError(f"din_attention_fused kernel takes contiguous tensors, "
                              f"{what} is not")
    if activation not in DIN_ACTIVATIONS:
        return ValueError(f"din_attention_fused kernel takes activation sigmoid or relu, "
                          f"not {activation!r}")
    if keys.dim() != 3 or query.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        return ValueError("din_attention_fused takes query [B, K], keys [B, T, K], "
                          "w1 [4K, H1], w2 [H1, H2]; got "
                          f"{tuple(query.shape)}, {tuple(keys.shape)}, "
                          f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    B, T, K = keys.shape
    H1, H2 = w1.shape[1], w2.shape[1]
    want = dict(query=(B, K), mask=(B, T), w1=(4 * K, H1), b1=(H1,), w2=(H1, H2),
                b2=(H2,), w3=(H2, 1), b3=(1,))
    for what, shape in want.items():
        if tuple(named[what].shape) != shape:
            return ValueError(f"din_attention_fused: {what} has shape "
                              f"{tuple(named[what].shape)}, want {shape}")
    if T == 0 or K == 0 or H1 == 0 or H2 == 0:
        return ValueError(f"din_attention_fused kernel takes T, K, H1, H2 > 0, got "
                          f"{T}, {K}, {H1}, {H2}")
    if B >= 2 ** 31:
        return ValueError(f"din_attention_fused kernel takes B < 2**31, got {B}")
    return None


def _din_fault(query, keys, mask, w1, b1, w2, b2, w3, b3,
               activation) -> Optional[Exception]:
    """Why the tiled kernel does not take these inputs, or None."""
    fault = _din_form_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, activation)
    if fault is not None:
        return fault
    T, K = keys.shape[1:]
    H1, H2 = w1.shape[1], w2.shape[1]
    if not (H1 <= DIN_MAX_HIDDEN and H2 <= DIN_MAX_HIDDEN):
        return ValueError(f"din_attention_fused kernel takes hidden widths in "
                          f"1..{DIN_MAX_HIDDEN}, got {H1}, {H2}")
    need = din_shared_bytes(T, K, H1, H2)
    if need > MAX_SHARED_BYTES:
        return ValueError(f"din_attention_fused kernel: T={T}, K={K}, H1={H1}, H2={H2} "
                          f"needs {need} bytes of shared memory, more than "
                          f"{MAX_SHARED_BYTES}")
    return None


def _din_global_fault(query, keys, mask, w1, b1, w2, b2, w3, b3,
                      activation) -> Optional[Exception]:
    """Why the global kernel does not take these inputs, or None."""
    fault = _din_form_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, activation)
    if fault is not None:
        return fault
    K, H1, H2 = keys.shape[2], w1.shape[1], w2.shape[1]
    need = din_global_shared_bytes(K, H1, H2)
    if need > MAX_SHARED_BYTES:
        return ValueError(f"din_attention_fused global kernel: K={K}, H1={H1}, H2={H2} "
                          f"needs {need} bytes of shared memory at one row a group and "
                          f"one chunk, more than {MAX_SHARED_BYTES}")
    return None


def check_din_args(query, keys, mask, w1, b1, w2, b2, w3, b3, activation) -> None:
    """Raise on anything the tiled kernel does not take."""
    fault = _din_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, activation)
    if fault is not None:
        raise fault


def check_din_global_args(query, keys, mask, w1, b1, w2, b2, w3, b3, activation) -> None:
    """Raise on anything the global kernel does not take: no limit on T or
    the hidden widths; its least shared memory grows only with K and H1 (the
    query and the per-row term of one row, 4 (K + H1) bytes beside one
    chunk of each layer's weights, so K + H1 up to about 40,000)."""
    fault = _din_global_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, activation)
    if fault is not None:
        raise fault


def din_kernel_takes(query, keys, mask, w1, b1, w2, b2, w3, b3, activation) -> bool:
    """True exactly where ``check_din_args`` would not raise: the shapes,
    dtypes, layouts and the activation alone decide. Where it is False,
    ``din_attention_fused`` launches the global kernel."""
    return _din_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, activation) is None


def _din_launch(query, keys, mask, w1, b1, w2, b2, w3, b3, activation: str,
                weight_normalization: bool, return_scores: bool,
                save: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (the output, the weights [B, T] where ``save``, else None)."""
    tensors = (query, keys, mask, w1, b1, w2, b2, w3, b3)
    fast = din_kernel_takes(*tensors, activation)
    (check_din_args if fast else check_din_global_args)(*tensors, activation)
    B, T, K = keys.shape
    H1 = w1.shape[1]
    out = torch.empty((B, T if return_scores else K), dtype=torch.float32,
                      device=keys.device)
    # where it pools, the tiled kernel writes the weights through a pointer
    # that is null when serving; the global kernel scores into its scratch:
    # the per-row terms [B, H1], then the weights [B, T] (where it returns
    # the weights, it scores into the output)
    keep = save and not return_scores
    weights = (torch.empty((B, T), dtype=torch.float32, device=keys.device)
               if keep and fast else None)
    scratch = None if fast else torch.empty(B * (H1 + (0 if return_scores else T)),
                                            dtype=torch.float32, device=keys.device)
    if keep and not fast:
        weights = scratch[B * H1:].view(B, T)
    if return_scores and save:
        weights = out
    if B == 0:
        return out, weights
    entry = "din_attention_forward" if fast else "din_attention_global_forward"
    last = (weights.data_ptr() if keep else None) if fast else scratch.data_ptr()
    lib = _library("din_attention")
    with torch.cuda.device(keys.device):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (*tensors, out)), last,
            B, T, K, H1, w2.shape[1], int(activation == "relu"),
            int(weight_normalization), int(return_scores), _stream(keys))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    din_attention_fused.launches += 1
    din_attention_fused.global_launches += not fast
    return out, weights


def _din_backward_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                        activation, return_scores) -> Optional[Exception]:
    """Why the backward kernel does not take these inputs, or None: it takes
    every shape of the forward kernels, with the forward's weights and a
    cotangent of the output's shape, contiguous float32."""
    fault = _din_form_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, activation)
    if fault is not None:
        return fault
    B, T, K = keys.shape
    want = dict(weights=(B, T), grad=(B, T) if return_scores else (B, K))
    for what, t in (("weights", weights), ("grad", grad)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            return TypeError(f"din_attention_backward kernel takes contiguous float32 "
                             f"{what}, got {t.dtype}, contiguous={t.is_contiguous()}")
        if tuple(t.shape) != want[what]:
            return ValueError(f"din_attention_backward: {what} has shape {tuple(t.shape)}, "
                              f"want {want[what]}")
    return None


def check_din_backward_args(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                            activation, return_scores) -> None:
    """Raise on anything the backward's global kernel does not take. It has
    no limit of its own on the shapes: where a pass's activations, the
    weights or the running sums do not fit in shared memory, they live in
    device memory (``back_launch`` in ``csrc/din_attention.cu``)."""
    fault = _din_backward_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                                activation, return_scores)
    if fault is not None:
        raise fault


# the widths the backward's tile kernel takes (kTK, kTH1, kTH2 and kTM of
# csrc/din_attention.cu): K <= 32, a 80-40 scorer or narrower, and rows of
# at most 64 positions (a warpgroup's tile of 64 takes a pair of rows'
# unmasked positions, or each row's alone)
DIN_BACKWARD_TILE = dict(K=32, H1=80, H2=40, T=64)


def din_backward_kernel_takes(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                              activation, return_scores) -> bool:
    """True where ``din_attention_backward`` launches the tile kernel: the
    global kernel takes these inputs (``check_din_backward_args``) and they
    are within ``DIN_BACKWARD_TILE``. The shapes, dtypes, layouts and the
    activation alone decide, never the data; where it is False the global
    kernel runs."""
    if _din_backward_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                           activation, return_scores) is not None:
        return False
    T, K = keys.shape[1:]
    lim = DIN_BACKWARD_TILE
    return K <= lim["K"] and w1.shape[1] <= lim["H1"] and w2.shape[1] <= lim["H2"] \
        and T <= lim["T"]


# the widths the backward's wide kernel takes (csrc/din_attention.cu
# wide_takes): K <= 128 (padded to 32, 64 or 128) and a 80-40 scorer or
# narrower, at any T, where the tile kernel does not take the shape
DIN_BACKWARD_WIDE = dict(K=128, H1=80, H2=40)


def din_backward_wide_takes(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                            activation, return_scores) -> bool:
    """True where ``din_attention_backward`` launches the wide kernel: the
    global kernel takes these inputs, they are within
    ``DIN_BACKWARD_WIDE``, and the tile kernel does not take them
    (``din_backward_kernel_takes``). Shapes, dtypes, layouts and the
    activation alone decide, never the data."""
    if _din_backward_fault(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                           activation, return_scores) is not None:
        return False
    if din_backward_kernel_takes(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                                 activation, return_scores):
        return False
    lim = DIN_BACKWARD_WIDE
    return keys.shape[2] <= lim["K"] and w1.shape[1] <= lim["H1"] and w2.shape[1] <= lim["H2"]


def din_backward_route(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                       activation, return_scores) -> str:
    """Which backward kernel ``din_attention_backward`` launches for these
    inputs: ``"tile"``, ``"wide"`` or ``"global"``."""
    args = (query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad, activation, return_scores)
    if din_backward_kernel_takes(*args):
        return "tile"
    return "wide" if din_backward_wide_takes(*args) else "global"


def _din_backward_launch(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                         activation: str, weight_normalization: bool, return_scores: bool,
                         global_kernel: bool = False):
    """One launch of the backward: the kernel ``din_backward_route`` names,
    or the global kernel where ``global_kernel`` (which only a comparison of
    the kernels asks for). A plan or launch that fails raises."""
    tensors = (query, keys, mask, w1, b1, w2, b2, w3, b3)
    check_din_backward_args(*tensors, weights, grad, activation, return_scores)
    route = "global" if global_kernel else din_backward_route(*tensors, weights, grad,
                                                              activation, return_scores)
    entry = {"tile": "din_attention_backward", "wide": "din_attention_wide_backward",
             "global": "din_attention_global_backward"}[route]
    B, T, K = keys.shape
    H1, H2 = w1.shape[1], w2.shape[1]
    grads = [torch.empty_like(t) for t in (query, keys, w1, b1, w2, b2, w3, b3)]
    if B == 0:
        return tuple(g.zero_() for g in grads)
    lib = _library("din_attention")
    with torch.cuda.device(keys.device):
        floats = getattr(lib, entry + "_scratch")(B, T, K, H1, H2)
        if floats < 0:
            raise RuntimeError(f"{entry} has no plan for B={B}, T={T}, K={K}, H1={H1}, "
                               f"H2={H2}")
        scratch = torch.empty(floats, dtype=torch.float32, device=keys.device)
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (*tensors, weights, grad, *grads, scratch)),
            B, T, K, H1, H2, int(activation == "relu"), int(weight_normalization),
            int(return_scores), _stream(keys))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    din_attention_backward.launches += 1
    din_attention_backward.wide_launches += route == "wide"
    din_attention_backward.global_launches += route == "global"
    return tuple(grads)


def din_attention_backward(query, keys, mask, w1, b1, w2, b2, w3, b3, weights, grad,
                           activation: str = "sigmoid", weight_normalization: bool = True,
                           return_scores: bool = False):
    """The DIN attention's backward: the forward's inputs, its weights ``[B,
    T]`` and the output's cotangent ``grad`` -> ``(dq, dkeys, dw1, db1, dw2,
    db2, dw3, db3)``, the JAX package's ``_din_remat_bwd``. On CUDA one
    launch of a backward kernel of ``csrc/din_attention.cu`` at every
    shape (``din_backward_route``): the tile kernel where
    ``din_backward_kernel_takes`` (DIN's and DIEN's scorer), the wide
    kernel where ``din_backward_wide_takes`` (K up to 128, any T), counted
    also in ``wide_launches``, else the global kernel, counted also in
    ``global_launches`` (each sums its weight gradients in a fixed order,
    no atomics: two calls agree bitwise); on the CPU
    ``din_attention_backward_ref``."""
    tensors = [t.to(torch.float32).contiguous() for t in (query, keys, mask, w1, b1, w2, b2,
                                                         w3, b3, weights, grad)]
    if use_kernel(*tensors):
        return _din_backward_launch(*tensors, activation, weight_normalization, return_scores)
    return din_attention_backward_ref(*tensors, activation, weight_normalization,
                                      return_scores)


din_attention_backward.launches = 0
din_attention_backward.wide_launches = 0
din_attention_backward.global_launches = 0


class _DinAttentionFused(torch.autograd.Function):
    """Forward: a kernel on CUDA, ``din_attention_ref`` on the CPU; where a
    gradient is needed (``save``) it keeps its inputs and the ``[B, T]``
    weights. Backward: ``din_attention_backward``, the JAX package's
    ``ops/din_vjp.py`` design (the scorer recomputed from the saved inputs,
    the first layer's cotangents per part): its kernel on CUDA,
    ``din_attention_backward_ref`` on the CPU. The mask gets no cotangent."""

    @staticmethod
    def forward(ctx, query, keys, mask, w1, b1, w2, b2, w3, b3, activation,
                weight_normalization, return_scores, save):
        ctx.flags = (activation, weight_normalization, return_scores)
        tensors = (query, keys, mask, w1, b1, w2, b2, w3, b3)
        if use_kernel(*tensors):
            out, weights = _din_launch(*tensors, *ctx.flags, save)
        elif save and not return_scores:
            # the weights, and the pooling of din_attention_ref on them
            weights = din_attention_ref(*tensors, activation, weight_normalization, True)
            out = torch.einsum("bt,btk->bk", weights, keys)
        else:
            out = weights = din_attention_ref(*tensors, *ctx.flags)
        if save:
            ctx.save_for_backward(*tensors, weights)
        return out

    @staticmethod
    def backward(ctx, grad):
        *tensors, weights = ctx.saved_tensors
        dq, dk, *dw = din_attention_backward(*tensors, weights, grad, *ctx.flags)
        return (dq, dk, None, *dw, None, None, None, None)


def din_attention_fused(query: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
                        w1, b1, w2, b2, w3, b3, activation: str = "sigmoid",
                        weight_normalization: bool = True,
                        return_scores: bool = False) -> torch.Tensor:
    """DIN target attention -> pooled ``[B, K]`` (or weights ``[B, T]``), in
    one kernel launch on CUDA: the tiled kernel where ``din_kernel_takes``,
    else the global kernel. ``mask`` is bool or float (valid where > 0.5, as
    the TPU kernel reads it); the inputs are made contiguous float32. Where
    a gradient is needed the forward also keeps the weights, and the
    backward is one launch of ``din_attention_backward``."""
    args = [t.to(torch.float32).contiguous() for t in (query, keys, mask,
                                                        w1, b1, w2, b2, w3, b3)]
    save = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    return _DinAttentionFused.apply(*args, activation, weight_normalization,
                                    return_scores, save)


din_attention_fused.launches = 0
din_attention_fused.global_launches = 0


# ---------------------------------------------------------------------------
# Row updates from a sorted id stream (csrc/sparse_rows.cu)
# ---------------------------------------------------------------------------

def check_sparse_rows_args(slid: torch.Tensor, order: torch.Tensor,
                           ct: torch.Tensor, *rows: torch.Tensor) -> None:
    """Raise on anything the sparse row kernels do not take: ``slid`` and
    ``order`` int64 ``[N]``, ``ct`` float32 ``[N, dim]``, each table (the
    parameter and its state: one for SGD and the scatter-add, two for
    Adagrad, three for Adam) float32 ``[rows, dim]`` of one shape, all
    contiguous. The ids are not checked against the table's rows, which
    would need the host to read them: the lookup clamps them."""
    for t, what in ((slid, "slid"), (order, "order")):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"sparse row kernels take {what} as int64 [N], got "
                            f"{t.dtype} {tuple(t.shape)}")
    if ct.dtype != torch.float32 or ct.dim() != 2:
        raise TypeError(f"sparse row kernels take ct as float32 [N, dim], got "
                        f"{ct.dtype} {tuple(ct.shape)}")
    if not slid.shape == order.shape == ct.shape[:1]:
        raise ValueError(f"stream lengths differ: slid {tuple(slid.shape)}, order "
                         f"{tuple(order.shape)}, ct {tuple(ct.shape)}")
    for t in rows:
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != ct.shape[1]:
            raise ValueError(f"sparse row kernels take float32 [rows, {ct.shape[1]}] "
                             f"tables, got {t.dtype} {tuple(t.shape)}")
        if t.shape != rows[0].shape:
            raise ValueError(f"tables differ in shape: {[tuple(r.shape) for r in rows]}")
    for t in (slid, order, ct, *rows):
        if not t.is_contiguous():
            raise ValueError("sparse row kernels take contiguous tensors")
    if ct.shape[1] == 0 or ct.numel() >= 2 ** 62:
        raise ValueError(f"sparse row kernels take 0 < dim and N*dim < 2**62, "
                         f"got ct {tuple(ct.shape)}")


# the long path of the four sparse row rules: a segment of at least
# SPARSE_CHUNK positions is summed in chunks of SPARSE_CHUNK, whose
# sums SPARSE_SHARES shares add (kChunk, kLong and kShares of
# csrc/sparse_rows.cu; ``scatter_add_chunked_ref`` is the same order)
SPARSE_CHUNK = 256
SPARSE_SHARES = 8


def sparse_rows_scratch(n: int, dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The long path's scratch for a stream of ``n`` positions of width
    ``dim``: the chunks' partial sums, float32 ``[chunks, 2, dim]``, and
    the long segment that starts in each chunk, int64 ``[chunks]``, with
    ``chunks = ceil(n / SPARSE_CHUNK)``. The kernel fills what it reads."""
    chunks = -(-n // SPARSE_CHUNK)
    return (torch.empty(chunks, 2, dim, dtype=torch.float32, device=device),
            torch.empty(chunks, dtype=torch.int64, device=device))


def check_long_scratch(partial: torch.Tensor, starts: torch.Tensor,
                       slid: torch.Tensor, ct: torch.Tensor) -> None:
    """Raise unless ``(partial, starts)`` is ``sparse_rows_scratch``'s
    scratch for ``ct``'s stream, contiguous and on ``ct``'s device."""
    want = sparse_rows_scratch(slid.shape[0], ct.shape[1], "meta")
    for t, w, what in ((partial, want[0], "partial"), (starts, want[1], "starts")):
        if (t.dtype != w.dtype or t.shape != w.shape or not t.is_contiguous()
                or t.device != ct.device):
            raise ValueError(f"the long path's {what} scratch must be contiguous {w.dtype} "
                             f"{tuple(w.shape)} on {ct.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def check_hyper(hyper: torch.Tensor, param: torch.Tensor, n: int) -> None:
    """Raise unless ``hyper`` is a contiguous float32 tensor of ``n``
    values on ``param``'s device: the step's scalars that a sparse row
    kernel reads from device memory."""
    if (hyper.dtype != torch.float32 or hyper.numel() != n or not hyper.is_contiguous()
            or hyper.device != param.device):
        raise ValueError(f"sparse row kernels read the step's scalars from a contiguous "
                         f"float32 tensor of {n} on {param.device}, got {hyper.dtype} "
                         f"{tuple(hyper.shape)} on {hyper.device}")


def launch_fused_adagrad(param: torch.Tensor, acc: torch.Tensor,
                         slid: torch.Tensor, order: torch.Tensor,
                         ct: torch.Tensor, hyper: torch.Tensor, eps: float,
                         partial: torch.Tensor, starts: torch.Tensor) -> None:
    """``fused_adagrad_rows`` on CUDA tensors, in place on ``param`` and
    ``acc``; the kernel reads ``lr`` from ``hyper`` (``[lr]``, float32 on
    the card), and the long path uses ``sparse_rows_scratch``'s ``partial``
    and ``starts``. Raises if the launch fails."""
    check_sparse_rows_args(slid, order, ct, param, acc)
    check_hyper(hyper, param, 1)
    check_long_scratch(partial, starts, slid, ct)
    lib = _library("sparse_rows")
    with torch.cuda.device(param.device):
        err = lib.fused_adagrad_rows(slid.data_ptr(), order.data_ptr(), ct.data_ptr(),
                                     param.data_ptr(), acc.data_ptr(), partial.data_ptr(),
                                     starts.data_ptr(), slid.shape[0], ct.shape[1],
                                     hyper.data_ptr(), eps, _stream(param))
    if err != 0:
        raise RuntimeError(f"fused_adagrad_rows launch failed with CUDA error {err}")


def launch_scatter_add(out: torch.Tensor, slid: torch.Tensor,
                       order: torch.Tensor, ct: torch.Tensor,
                       partial: torch.Tensor, starts: torch.Tensor) -> None:
    """``scatter_add_rows`` on CUDA tensors into the zero-filled ``out``,
    the long path on ``sparse_rows_scratch``'s ``partial`` and ``starts``;
    raises if the launch fails."""
    check_sparse_rows_args(slid, order, ct, out)
    check_long_scratch(partial, starts, slid, ct)
    lib = _library("sparse_rows")
    with torch.cuda.device(out.device):
        err = lib.scatter_add_rows(slid.data_ptr(), order.data_ptr(), ct.data_ptr(),
                                   out.data_ptr(), partial.data_ptr(), starts.data_ptr(),
                                   slid.shape[0], ct.shape[1], _stream(out))
    if err != 0:
        raise RuntimeError(f"scatter_add_rows launch failed with CUDA error {err}")


def launch_fused_sgd(param: torch.Tensor, slid: torch.Tensor, order: torch.Tensor,
                     ct: torch.Tensor, hyper: torch.Tensor,
                     partial: torch.Tensor, starts: torch.Tensor) -> None:
    """``fused_sgd_rows`` on CUDA tensors, in place on ``param``; the kernel
    reads ``lr`` from ``hyper`` (``[lr]``), and the long path uses
    ``sparse_rows_scratch``'s ``partial`` and ``starts``. Raises if the
    launch fails."""
    check_sparse_rows_args(slid, order, ct, param)
    check_hyper(hyper, param, 1)
    check_long_scratch(partial, starts, slid, ct)
    lib = _library("sparse_rows")
    with torch.cuda.device(param.device):
        err = lib.fused_sgd_rows(slid.data_ptr(), order.data_ptr(), ct.data_ptr(),
                                 param.data_ptr(), partial.data_ptr(), starts.data_ptr(),
                                 slid.shape[0], ct.shape[1], hyper.data_ptr(), _stream(param))
    if err != 0:
        raise RuntimeError(f"fused_sgd_rows launch failed with CUDA error {err}")


def launch_fused_adam(param: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      slid: torch.Tensor, order: torch.Tensor, ct: torch.Tensor,
                      hyper: torch.Tensor, partial: torch.Tensor, starts: torch.Tensor, *,
                      b1: float, b2: float, eps: float) -> None:
    """``fused_adam_rows`` on CUDA tensors, in place on ``param``, ``m`` and
    ``v``; the kernel reads ``lr`` and the reciprocal bias corrections from
    ``hyper`` (``[lr, bc1, bc2]``), and the long path uses
    ``sparse_rows_scratch``'s ``partial`` and ``starts``. ``1 - b1`` and
    ``1 - b2`` are rounded to float32 once from the double, as the plain
    version's scalar products round them. Raises if the launch fails."""
    check_sparse_rows_args(slid, order, ct, param, m, v)
    check_hyper(hyper, param, 3)
    check_long_scratch(partial, starts, slid, ct)
    lib = _library("sparse_rows")
    with torch.cuda.device(param.device):
        err = lib.fused_adam_rows(slid.data_ptr(), order.data_ptr(), ct.data_ptr(),
                                  param.data_ptr(), m.data_ptr(), v.data_ptr(),
                                  partial.data_ptr(), starts.data_ptr(), slid.shape[0],
                                  ct.shape[1], hyper.data_ptr(), b1, b2, eps, 1.0 - b1,
                                  1.0 - b2, _stream(param))
    if err != 0:
        raise RuntimeError(f"fused_adam_rows launch failed with CUDA error {err}")
