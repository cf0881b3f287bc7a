"""K4: member-stacked int8 linear + dequant + softplus + row max.

Counterpart of ``ladine_tpu/kernels/int8_pallas.py::int8_linear_softplus``
and of its composition ``int8_eps_pallas``, the eps of ``use_int8_pallas``:
lin1 and lin4 stay plain PyTorch, lin2 (symmetric activations, from max|h1|)
and lin3 (zero-point 127, from lin2's row max) are one kernel launch each
for all members (``csrc/int8_linear.cu``).

A CPU tensor goes through :func:`int8_linear_softplus_plain`; a CUDA tensor
goes through the kernel, or the wrapper raises. Both are implementations of
one custom op (``kernels/_build.py``). The GEMM (``csrc/int8_gemm.cuh``) is
a TMA ring feeding s8 ``wgmma`` on a persistent grid; its schedule is
:func:`gemm_plan`, a pure function of the shape. It takes every shape the
wrappers take: K a positive multiple of 16 and 16-byte aligned operands
(TMA's tensor maps); anything else raises before a launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ladine_tpu_torch.kernels import _build, fused_linear
from ladine_tpu_torch.kernels.fused_linear import WgmmaPlan
from ladine_tpu_torch.kernels.int8 import (
    Int8Layers,
    _folded,
    _lin1,
    _lin4,
    div,
    int_matmul,
    no_grad_if_enabled,
    quantize_rows,
    softplus,
)

_NAME = "int8_linear"
_KERNEL = "int8_linear_softplus"
BODY = "wgmma"  # the GEMM's one body: TMA + s8 wgmma (csrc/int8_gemm.cuh)
TILE_ROWS, TILE_COLS = fused_linear.TILE_ROWS, fused_linear.TILE_COLS  # BM, BN of csrc/int8_gemm.cuh: 192 x 128
STEP_K = 128  # bytes of K a step (BK there): one TMA box of the 128-byte swizzle, four k32 products
SLABS = TILE_ROWS // 64  # consumer warpgroups of a block, one 64-row slab each


def gemm_plan(m: int, r: int, k: int, n: int) -> WgmmaPlan:
    """The int8 GEMM's schedule for M members of an (R, K) x (K, N)
    product: K1's persistent schedule (``fused_linear.wgmma_plan``) at
    STEP_K bytes of K a step. Tiles of TILE_ROWS x TILE_COLS of one member,
    row tile fastest, run whole on min(132, tiles) blocks a round at a time;
    the remainder tiles are split in K into ``chunks`` equal parts, and the
    last of a split tile's blocks adds the int32 partials (``work_bytes``:
    their workspace, 0 where none is split) and runs the epilogue."""
    return fused_linear.wgmma_plan(m, r, k, n, step_k=STEP_K)


def live_slabs(r: int, row0: int) -> int:
    """64-row slabs of the tile at ``row0`` with a row below R: the slabs
    the producer loads and the consumers multiply (rows past R inside a
    live slab arrive as zeros; a slab wholly past R is skipped)."""
    return min(SLABS, -(-(r - row0) // 64))


def int8_linear_softplus_plain(x, xmax, w_q, s, c, colsum=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softplus(int8(x) @ w_q [+ 127 colsum] * (xs * s) + c)`` in x.dtype,
    and its float32 row max. x (..., R, K), xmax (..., R, 1) (max|x|, or
    max x with ``colsum``: zero-point 127), w_q (..., K, N) int8, s, c,
    colsum (..., N) float32."""
    zp = colsum is not None
    xs = div(torch.clamp_min(xmax.float(), 1e-8), 254.0 if zp else 127.0)
    acc = int_matmul(quantize_rows(x.float(), xs, zp), w_q).float()
    if zp:
        acc = acc + 127.0 * colsum.unsqueeze(-2)
    h = softplus(acc * (xs * s.unsqueeze(-2)) + c.unsqueeze(-2)).to(x.dtype)
    return h, h.float().amax(-1, keepdim=True)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.int8_linear_softplus_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_activations(kernel: str, x: torch.Tensor, rows_max: Optional[torch.Tensor]):
    """(M, R, K) float32/bfloat16 rows the int8 kernels take, with their
    (M, R, 1) float32 row max; returns (M, R, K)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: activations must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{kernel}: activations must be (M, R, K), got {tuple(x.shape)}")
    m, r, k = x.shape
    if k % 16 != 0 or k == 0:
        raise ValueError(f"{kernel}: K = {k} must be a positive multiple of 16 (16-byte int8 rows for TMA)")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError(f"{kernel}: activations must be contiguous and 16-byte aligned")
    if rows_max is not None:
        if rows_max.dtype != torch.float32 or rows_max.shape != (m, r, 1) or not rows_max.is_contiguous():
            raise ValueError(f"{kernel}: the row max must be contiguous float32 (M, R, 1) = {(m, r, 1)}")
    if m > 65535:
        raise ValueError(f"{kernel}: too many members for the lin1 pass's grid")
    return m, r, k


def check_weight(kernel: str, w_q, m: int, k: int, *per_column) -> int:
    """An int8 (M, K, N) weight stored K-contiguous (``kernels.int8``'s
    layout) and its float32 (M, N) per-column vectors; returns N."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"{kernel}: the weight must be int8, got {w_q.dtype}")
    if w_q.dim() != 3 or tuple(w_q.shape[:2]) != (m, k):
        raise ValueError(f"{kernel}: the weight must be (M, K, N) with (M, K) = {(m, k)}")
    n = w_q.shape[2]
    if w_q.stride() != (n * k, 1, k):
        raise ValueError(f"{kernel}: the weight must be stored K-contiguous, as quantize_weight makes it")
    if w_q.data_ptr() % 16 != 0:
        raise ValueError(f"{kernel}: the weight must be 16-byte aligned (its TMA tensor map)")
    for v in per_column:
        if v is None:
            continue
        if v.dtype != torch.float32:
            raise TypeError(f"{kernel}: per-column scales and shifts must be float32, got {v.dtype}")
        if tuple(v.shape) != (m, n) or not v.is_contiguous():
            raise ValueError(f"{kernel}: per-column vectors must be contiguous (M, N) = {(m, n)}")
    return n


def schedule(p: WgmmaPlan) -> Tuple[int, ...]:
    """The plan's six ints as the C entries take them (``hopper::WgSched``)."""
    return p.row_tiles, p.col_tiles, p.steps, p.tiles, p.grid, p.chunks


def split_workspace(p: WgmmaPlan, device) -> Optional[torch.Tensor]:
    """The split tiles' workspace of a launch (its counts are zeroed by the
    launch), or None where no tile is split."""
    return torch.empty(p.work_bytes, dtype=torch.uint8, device=device) if p.work_bytes else None


def same_device(kernel: str, *tensors) -> None:
    dev = tensors[0].device
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError(f"{kernel}: all arguments must be on {dev}")


def int8_linear_softplus(
    x: torch.Tensor,
    xmax: torch.Tensor,
    w_q: torch.Tensor,
    s: torch.Tensor,
    c: torch.Tensor,
    colsum: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_linear_softplus_plain` for every member at once:
    x (M, R, K) float32/bfloat16, xmax (M, R, 1) float32, w_q (M, K, N)
    int8 stored K-contiguous, s/c/colsum (M, N) float32. Returns h (M, R, N)
    in x.dtype and hmax (M, R, 1) float32. The op
    ``torch.ops.ladine_tpu_torch.int8_linear_softplus``."""
    return _op(x, xmax, w_q, s, c, colsum)


@torch.library.custom_op(f"{_build.NAMESPACE}::{_KERNEL}", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, xmax: torch.Tensor, w_q: torch.Tensor, s: torch.Tensor, c: torch.Tensor,
        colsum: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    return int8_linear_softplus_plain(x, xmax, w_q, s, c, colsum)


@_op.register_fake
def _(x, xmax, w_q, s, c, colsum):
    shape = tuple(torch.broadcast_shapes(x.shape[:-2], w_q.shape[:-2])) + (x.shape[-2],)
    return x.new_empty(shape + (w_q.shape[-1],)), x.new_empty(shape + (1,), dtype=torch.float32)


@_op.register_kernel("cuda")
def _launch(x, xmax, w_q, s, c, colsum):
    m, r, k = check_activations(_KERNEL, x, xmax)
    n = check_weight(_KERNEL, w_q, m, k, s, c, colsum)
    same_device(_KERNEL, x, xmax, w_q, s, c, colsum)
    h = torch.empty((m, r, n), dtype=x.dtype, device=x.device)
    hmax = torch.zeros((m, r, 1), dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return h, hmax
    xq = torch.empty((m, r, k), dtype=torch.int8, device=x.device)
    p = gemm_plan(m, r, k, n)
    work = split_workspace(p, x.device)
    launch = _lib()
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), xmax.data_ptr(), xq.data_ptr(), w_q.data_ptr(), s.data_ptr(),
            c.data_ptr(), None if colsum is None else colsum.data_ptr(), h.data_ptr(),
            hmax.data_ptr(), None if work is None else work.data_ptr(), m, r, k, n, *schedule(p),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, _NAME, _KERNEL)
    _build.launch_counts[_KERNEL] += 1
    return h, hmax


@no_grad_if_enabled
def int8_eps_pallas(model, q: Int8Layers, f: torch.Tensor, y: torch.Tensor, t: int,
                    y_hat: torch.Tensor, table=None) -> torch.Tensor:
    """eps with lin2 and lin3 as K4 launches: (M, R, F) f, (M, R, C) y and
    y_hat -> (M, R, C) float32. ``q`` is ``kernels.int8.quantize_member``'s
    output, ``table`` ``kernels.fused_eps.fold_table`` over all timesteps
    (or None)."""
    (a1, c1), (a2, c2), (a3, c3) = _folded(model, t, table)
    h = _lin1(model, f, y, y_hat, a1, c1)
    hmax = h.abs().amax(-1, keepdim=True).float()
    w_q2, w_scale2, _ = q["lin2"]
    h, hmax = int8_linear_softplus(h, hmax, w_q2, w_scale2 * a2, c2)
    w_q3, w_scale3, colsum3 = q["lin3"]
    h, _ = int8_linear_softplus(h, hmax, w_q3, w_scale3 * a3, c3, colsum=colsum3)
    return _lin4(model, h)
