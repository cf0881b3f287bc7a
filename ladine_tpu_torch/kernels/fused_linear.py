"""Fused member-stacked matmul + affine + softplus (+ gate): the eps layer.

Counterpart of ``ladine_tpu/kernels/fused_linear.py::fused_linear_act``.
At eval the timestep gate and BatchNorm of a ConditionalLinear layer fold
into a per-unit affine (a, c), so the layer is ``softplus((x @ W) * a + c)``
with an optional elementwise gate ``mult`` (the f (.) y conditioning).

The member axis leads every argument and is a grid dimension of the kernel
(``csrc/fused_linear.cu``): one launch covers all members. A CPU tensor
goes through :func:`fused_linear_act_plain`; a CUDA tensor goes through the
kernel, or the wrapper raises.

The kernel has three bodies, chosen by shape and dtype (:func:`plan`):
``small_k`` for K <= 16 in either dtype (lin1, K = 4: an outer product and
an elementwise pass), ``mma`` for larger K in bfloat16 (lin2 and lin3:
``mma.sync`` tiles of 160 rows x 128 columns, K split over a cluster pair of
blocks, each weight strip read once), ``simt`` for larger K in float32. Each
launch counts as one ``fused_linear_act``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ladine_tpu_torch.kernels import _build

_NAME = "fused_linear"
_KERNEL = "fused_linear_act"
SMALL_K = 16  # the largest K the small_k body takes
_BODIES = {"small_k": 0, "mma": 1, "simt": 2}  # the codes of csrc/fused_linear.cu


def fused_linear_act_plain(x, w, a, c, mult=None) -> torch.Tensor:
    """softplus((x @ w) * a + c) [* mult] with an fp32 product, in x.dtype.

    Leading (member) axes broadcast: x (..., R, K), w (..., K, N),
    a/c (..., N), mult (..., R, N)."""
    z = torch.matmul(x.float(), w.float()) * a.float().unsqueeze(-2) + c.float().unsqueeze(-2)
    out = F.softplus(z)
    if mult is not None:
        out = out * mult.float()
    return out.to(x.dtype)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.fused_linear_act_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w, a, c, mult):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{_KERNEL}: x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype or (mult is not None and mult.dtype != x.dtype):
        raise TypeError(f"{_KERNEL}: w and mult must have x's dtype {x.dtype}")
    if a.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"{_KERNEL}: a and c must be float32")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{_KERNEL}: x must be (M, R, K) and w (M, K, N)")
    m, r, k = x.shape
    if w.shape[:2] != (m, k):
        raise ValueError(f"{_KERNEL}: shapes x {tuple(x.shape)} and w {tuple(w.shape)} disagree")
    n = w.shape[2]
    if a.shape != (m, n) or c.shape != (m, n):
        raise ValueError(f"{_KERNEL}: a and c must be (M, N) = {(m, n)}")
    if mult is not None and mult.shape != (m, r, n):
        raise ValueError(f"{_KERNEL}: mult must be (M, R, N) = {(m, r, n)}")
    tensors = [x, w, a, c] + ([mult] if mult is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{_KERNEL}: all arguments must be on {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{_KERNEL}: arguments must be contiguous")
    if m > 65535 or (n + 63) // 64 > 65535:
        raise ValueError(f"{_KERNEL}: too many members or columns for the grid")
    return m, r, k, n


def plan(dtype: torch.dtype, k: int, n: int, aligned: bool):
    """(body, vec) of a call: the kernel body for K and the dtype, and
    whether its tiles move as 16-byte vectors. ``aligned``: every pointer is
    16-byte aligned. small_k needs N % 8 == 0 for vectors (8 outputs a
    thread); the GEMM bodies need K and N multiples of the 16-byte vector.
    Without vectors a body stages element by element: a dispatch by shape,
    not a fallback."""
    if k <= SMALL_K:
        return "small_k", aligned and n % 8 == 0
    vw = 16 // (2 if dtype == torch.bfloat16 else 4)
    return ("mma" if dtype == torch.bfloat16 else "simt"), aligned and k % vw == 0 and n % vw == 0


def fused_linear_act(
    x: torch.Tensor,
    w: torch.Tensor,
    a: torch.Tensor,
    c: torch.Tensor,
    mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softplus((x @ w) * a + c) [* mult] for every member at once.

    x: (M, R, K), w: (M, K, N), a/c: (M, N) float32, mult: (M, R, N) or
    None; x, w and mult share one dtype (float32 or bfloat16). Returns
    (M, R, N) in x.dtype. On the card the kernel body follows from K and
    the dtype (:func:`plan`): small_k for K <= 16, else mma in bfloat16 and
    simt in float32."""
    if x.device.type == "cpu":
        return fused_linear_act_plain(x, w, a, c, mult)
    m, r, k, n = _check(x, w, a, c, mult)
    out = torch.empty((m, r, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, a, c, mult, out) if t is not None)
    body, vec = plan(x.dtype, k, n, aligned)
    launch = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), c.data_ptr(),
            None if mult is None else mult.data_ptr(), out.data_ptr(),
            m, r, k, n, int(x.dtype == torch.bfloat16), int(vec), _BODIES[body], stream,
        )
    _build.check(err, _NAME, _KERNEL)
    _build.launch_counts[_KERNEL] += 1
    return out
