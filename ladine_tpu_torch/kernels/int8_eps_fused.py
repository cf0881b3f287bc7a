"""K5: the int8 eps in two kernel calls, lin1 in lin2's prologue and lin4
in lin3's epilogue.

Counterpart of ``ladine_tpu/kernels/int8_pallas.py::int8_eps_pallas_fused``
(``use_int8_pallas`` with ``pallas_fuse_ends``). Both calls cover all
members (``csrc/int8_eps_fused.cu``):

* :func:`int8_eps_l12`: h1 = f * softplus((y_in @ w1) * a1 + c1), its
  symmetric int8 codes (the lin1 pass, :func:`int8_lin1` alone), then lin2
  as in K4: (h2, hmax2).
* :func:`int8_eps_l34`: lin3 on the zero-point codes of h2, each h3 tile
  contracted with w4 at once: (M, R, C) float32, without lin4's bias.

A CPU tensor goes through the ``*_plain`` versions; a CUDA tensor goes
through the kernels, or the wrapper raises. Each pair is the CPU and CUDA
implementation of one custom op (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from ladine_tpu_torch.kernels import _build
from ladine_tpu_torch.kernels.int8 import Int8Layers, _folded, div, no_grad_if_enabled, quantize_rows, softplus
from ladine_tpu_torch.kernels.int8_linear import (
    check_activations,
    check_weight,
    gemm_plan,
    int8_linear_softplus_plain,
    same_device,
)

_NAME = "int8_eps_fused"
L12 = "int8_eps_fused_l12"
L34 = "int8_eps_fused_l34"
LIN1 = "int8_lin1"  # K5a's lin1 pass launched alone (its tests and timing)
_LIN1_MAX_K = 16 * 512  # 16 k a thread, one row a block of at most 512 threads


def lin1_threads(k: int) -> int:
    """Threads a block of K5a's lin1 pass: one row a block, 16 consecutive
    k a thread, rounded up to whole warps (256 at K = 4096). Raises on a K
    the kernel does not take."""
    if k % 16 != 0 or not 0 < k <= _LIN1_MAX_K:
        raise ValueError(f"{L12}: the lin1 pass takes K a multiple of 16 up to {_LIN1_MAX_K}, got K = {k}")
    return (k // 16 + 31) // 32 * 32


def _h1(f, y_in, w1, a1, c1) -> torch.Tensor:
    """``f * softplus((y_in @ w1) * a1 + c1)``, each product rounded to f's
    dtype. The Ci terms of ``y_in @ w1`` are summed in order, in float32 and
    without fused multiply-adds, as the kernel sums them."""
    y, w = y_in.float(), w1.float()
    z = y.new_zeros(y.shape[:-1] + w.shape[-1:])
    for i in range(y.shape[-1]):
        z = z + y[..., i:i + 1] * w[..., i:i + 1, :]
    return f * softplus(z * a1.unsqueeze(-2) + c1.unsqueeze(-2)).to(f.dtype)


def int8_lin1_plain(f, y_in, w1, a1, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5a's lin1 pass: the symmetric int8 codes of h1 and max|h1|
    (..., R, 1) float32."""
    h1 = _h1(f, y_in, w1, a1, c1).float()
    xmax = h1.abs().amax(-1, keepdim=True)
    return quantize_rows(h1, div(torch.clamp_min(xmax, 1e-8), 127.0), False), xmax


def int8_eps_l12_plain(f, y_in, w1, a1, c1, w_q2, s2, c2) -> Tuple[torch.Tensor, torch.Tensor]:
    """lin1 + softplus + gate, each rounded to f's dtype, then lin2 with
    symmetric activations from max|h1|: (h2 in f's dtype, hmax2 float32).
    f (..., R, K), y_in (..., R, Ci), w1 (..., Ci, K), a1/c1 (..., K)."""
    h1 = _h1(f, y_in, w1, a1, c1)
    return int8_linear_softplus_plain(h1, h1.float().abs().amax(-1, keepdim=True), w_q2, s2, c2)


def int8_eps_l34_plain(h2, hmax2, w_q3, s3, c3, colsum3, w4) -> torch.Tensor:
    """lin3 with zero-point activations from hmax2, rounded to h2's dtype,
    then ``@ w4`` (..., N, C) in float32."""
    h3, _ = int8_linear_softplus_plain(h2, hmax2, w_q3, s3, c3, colsum3)
    return torch.matmul(h3.float(), w4.float())


def _lib(symbol: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load(_NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_lin1(f, y_in, w1, a1, c1):
    """f (M, R, K) and y_in (M, R, Ci), w1 (M, Ci, K) in one type, a1/c1
    (M, K) float32, all contiguous and 16-byte aligned; returns (M, R, K,
    Ci, threads a block)."""
    m, r, k = check_activations(L12, f, None)
    ci = y_in.shape[-1]
    if y_in.dtype != f.dtype or w1.dtype != f.dtype:
        raise TypeError(f"{L12}: y_in and w1 must have f's dtype {f.dtype}")
    if tuple(y_in.shape) != (m, r, ci) or tuple(w1.shape) != (m, ci, k):
        raise ValueError(f"{L12}: y_in must be (M, R, Ci) and w1 (M, Ci, K) = {(m, ci, k)}")
    if not (y_in.is_contiguous() and w1.is_contiguous()) or w1.data_ptr() % 16 != 0:
        raise ValueError(f"{L12}: y_in and w1 must be contiguous, w1 16-byte aligned")
    for v in (a1, c1):
        if v.dtype != torch.float32 or tuple(v.shape) != (m, k) or not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{L12}: a1 and c1 must be contiguous 16-byte aligned float32 (M, K) = {(m, k)}")
    return m, r, k, ci, lin1_threads(k)


def int8_lin1(f, y_in, w1, a1, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_lin1_plain` for every member at once, K5a's lin1 pass
    launched alone (:func:`int8_eps_l12` runs it in the same call as lin2):
    returns the int8 codes (M, R, K) and max|h1| (M, R, 1) float32. The op
    ``torch.ops.ladine_tpu_torch.int8_lin1``."""
    return _lin1_op(f, y_in, w1, a1, c1)


def int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, c2) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_eps_l12_plain` for every member at once: f (M, R, K) and
    y_in (M, R, Ci), w1 (M, Ci, K) in one type (float32/bfloat16), a1/c1
    (M, K) and s2/c2 (M, N) float32, w_q2 (M, K, N) int8 stored
    K-contiguous. Returns h2 (M, R, N) in f's type, hmax2 (M, R, 1) float32.
    The op ``torch.ops.ladine_tpu_torch.int8_eps_l12``."""
    return _l12_op(f, y_in, w1, a1, c1, w_q2, s2, c2)


def int8_eps_l34(h2, hmax2, w_q3, s3, c3, colsum3, w4) -> torch.Tensor:
    """:func:`int8_eps_l34_plain` for every member at once: h2 (M, R, K)
    float32/bfloat16, hmax2 (M, R, 1) float32, w_q3 (M, K, N) int8 stored
    K-contiguous, s3/c3/colsum3 (M, N) float32, w4 (M, N, C) in h2's type.
    Returns (M, R, C) float32. The op
    ``torch.ops.ladine_tpu_torch.int8_eps_l34``."""
    return _l34_op(h2, hmax2, w_q3, s3, c3, colsum3, w4)


def _rows(*lead_shapes) -> tuple:
    return tuple(torch.broadcast_shapes(*lead_shapes))


@torch.library.custom_op(f"{_build.NAMESPACE}::int8_lin1", mutates_args=(), device_types="cpu")
def _lin1_op(f: Tensor, y_in: Tensor, w1: Tensor, a1: Tensor,
             c1: Tensor) -> Tuple[Tensor, Tensor]:
    return int8_lin1_plain(f, y_in, w1, a1, c1)


@_lin1_op.register_fake
def _(f, y_in, w1, a1, c1):
    shape = _rows(f.shape[:-1], y_in.shape[:-1])
    return f.new_empty(shape + (f.shape[-1],), dtype=torch.int8), f.new_empty(shape + (1,), dtype=torch.float32)


@_lin1_op.register_kernel("cuda")
def _lin1_launch(f, y_in, w1, a1, c1):
    m, r, k, ci, threads = _check_lin1(f, y_in, w1, a1, c1)
    same_device(L12, f, y_in, w1, a1, c1)
    xq = torch.empty((m, r, k), dtype=torch.int8, device=f.device)
    xmax = torch.empty((m, r, 1), dtype=torch.float32, device=f.device)
    if xq.numel() == 0:
        return xq, xmax
    launch = _lib("int8_lin1_launch", 7, 6)
    with torch.cuda.device(f.device):
        err = launch(
            f.data_ptr(), y_in.data_ptr(), w1.data_ptr(), a1.data_ptr(), c1.data_ptr(),
            xq.data_ptr(), xmax.data_ptr(), m, r, k, ci, threads, int(f.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, _NAME, LIN1)
    _build.launch_counts[LIN1] += 1
    return xq, xmax


@torch.library.custom_op(f"{_build.NAMESPACE}::int8_eps_l12", mutates_args=(), device_types="cpu")
def _l12_op(f: Tensor, y_in: Tensor, w1: Tensor, a1: Tensor, c1: Tensor, w_q2: Tensor, s2: Tensor,
            c2: Tensor) -> Tuple[Tensor, Tensor]:
    return int8_eps_l12_plain(f, y_in, w1, a1, c1, w_q2, s2, c2)


@_l12_op.register_fake
def _(f, y_in, w1, a1, c1, w_q2, s2, c2):
    shape = _rows(f.shape[:-2], w_q2.shape[:-2]) + (f.shape[-2],)
    return f.new_empty(shape + (w_q2.shape[-1],)), f.new_empty(shape + (1,), dtype=torch.float32)


@_l12_op.register_kernel("cuda")
def _l12_launch(f, y_in, w1, a1, c1, w_q2, s2, c2):
    m, r, k, ci, threads = _check_lin1(f, y_in, w1, a1, c1)
    n = check_weight(L12, w_q2, m, k, s2, c2)
    same_device(L12, f, y_in, w1, a1, c1, w_q2, s2, c2)
    h2 = torch.empty((m, r, n), dtype=f.dtype, device=f.device)
    hmax2 = torch.zeros((m, r, 1), dtype=torch.float32, device=f.device)
    if h2.numel() == 0:
        return h2, hmax2
    xq = torch.empty((m, r, k), dtype=torch.int8, device=f.device)
    xmax = torch.empty((m, r), dtype=torch.float32, device=f.device)
    plan = gemm_plan(m, r, k, n)
    launch = _lib("int8_eps_l12_launch", 12, 9)
    with torch.cuda.device(f.device):
        err = launch(
            f.data_ptr(), y_in.data_ptr(), w1.data_ptr(), a1.data_ptr(), c1.data_ptr(),
            xq.data_ptr(), xmax.data_ptr(), w_q2.data_ptr(), s2.data_ptr(), c2.data_ptr(),
            h2.data_ptr(), hmax2.data_ptr(), m, r, k, ci, n, threads, plan.row_tiles, plan.col_tiles,
            int(f.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, _NAME, L12)
    _build.launch_counts[L12] += 1
    return h2, hmax2


@torch.library.custom_op(f"{_build.NAMESPACE}::int8_eps_l34", mutates_args=(), device_types="cpu")
def _l34_op(h2: Tensor, hmax2: Tensor, w_q3: Tensor, s3: Tensor, c3: Tensor, colsum3: Tensor,
            w4: Tensor) -> Tensor:
    return int8_eps_l34_plain(h2, hmax2, w_q3, s3, c3, colsum3, w4)


@_l34_op.register_fake
def _(h2, hmax2, w_q3, s3, c3, colsum3, w4):
    shape = _rows(h2.shape[:-2], w_q3.shape[:-2], w4.shape[:-2]) + (h2.shape[-2], w4.shape[-1])
    return h2.new_empty(shape, dtype=torch.float32)


@_l34_op.register_kernel("cuda")
def _l34_launch(h2, hmax2, w_q3, s3, c3, colsum3, w4):
    m, r, k = check_activations(L34, h2, hmax2)
    n = check_weight(L34, w_q3, m, k, s3, c3, colsum3)
    if w4.dtype != h2.dtype:
        raise TypeError(f"{L34}: w4 must have h2's dtype {h2.dtype}")
    if w4.dim() != 3 or tuple(w4.shape[:2]) != (m, n) or not w4.is_contiguous():
        raise ValueError(f"{L34}: w4 must be contiguous (M, N, C) with (M, N) = {(m, n)}")
    same_device(L34, h2, hmax2, w_q3, s3, c3, colsum3, w4)
    n_out = w4.shape[2]
    out = torch.zeros((m, r, n_out), dtype=torch.float32, device=h2.device)
    if out.numel() == 0 or n == 0:
        return out
    xq = torch.empty((m, r, k), dtype=torch.int8, device=h2.device)
    plan = gemm_plan(m, r, k, n)
    launch = _lib("int8_eps_l34_launch", 9, 8)
    with torch.cuda.device(h2.device):
        err = launch(
            h2.data_ptr(), hmax2.data_ptr(), xq.data_ptr(), w_q3.data_ptr(), s3.data_ptr(),
            c3.data_ptr(), colsum3.data_ptr(), w4.data_ptr(), out.data_ptr(), m, r, k, n, n_out,
            plan.row_tiles, plan.col_tiles, int(h2.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, _NAME, L34)
    _build.launch_counts[L34] += 1
    return out


@no_grad_if_enabled
def int8_eps_pallas_fused(model, q: Int8Layers, f: torch.Tensor, y: torch.Tensor, t: int,
                          y_hat: torch.Tensor, table=None) -> torch.Tensor:
    """eps as two K5 launches: (M, R, F) f, (M, R, C) y and y_hat ->
    (M, R, C) float32. ``q`` is ``kernels.int8.quantize_member``'s output,
    ``table`` ``kernels.fused_eps.fold_table`` over all timesteps (or
    None). y, y_hat, w1 and w4 are cast to f's dtype, as the JAX kernel's
    operands are."""
    (a1, c1), (a2, c2), (a3, c3) = _folded(model, t, table)
    cdtype = f.dtype
    y_in = model.lin1_input(y, y_hat).to(cdtype)
    w_q2, w_scale2, _ = q["lin2"]
    h2, hmax2 = int8_eps_l12(f, y_in, model.lin1.linear.weight.to(cdtype), a1, c1,
                             w_q2, w_scale2 * a2, c2)
    w_q3, w_scale3, colsum3 = q["lin3"]
    out = int8_eps_l34(h2, hmax2, w_q3, w_scale3 * a3, c3, colsum3, model.lin4.weight.to(cdtype))
    return out + model.lin4.bias.float().unsqueeze(-2)
