"""Fused member-stacked matmul + affine + softplus (+ gate): the eps layer.

Counterpart of ``ladine_tpu/kernels/fused_linear.py::fused_linear_act``.
At eval the timestep gate and BatchNorm of a ConditionalLinear layer fold
into a per-unit affine (a, c), so the layer is ``softplus((x @ W) * a + c)``
with an optional elementwise gate ``mult`` (the f (.) y conditioning).

The member axis leads every argument and is a grid dimension of the kernel
(``csrc/fused_linear.cu``): one launch covers all members. A CPU tensor
goes through :func:`fused_linear_act_plain`; a CUDA tensor goes through the
kernel, or the wrapper raises. Both are implementations of one custom op
(``kernels/_build.py``).

The kernel has five bodies, chosen by shape and dtype (:func:`plan`):
``small_k`` for K <= 16 in either dtype (lin1 up to 8 classes, K = 4 at 2:
an outer product and an elementwise pass); ``wgmma`` for larger K in
bfloat16 where K and N are multiples of 8 and every pointer is 16-byte
aligned (lin2 and lin3, the shapes a TMA tensor map describes): a TMA ring
fed by a producer warp, ``wgmma`` warpgroups of 64 rows x 128 columns and
a persistent grid of at most 132 blocks on the schedule of
:func:`wgmma_plan`. It replaces ``ladine_tpu/kernels/fused_linear.py:66``
for lin2/lin3; the bytes bound it at R = 160 rows a member (each weight
strip is read once) and the operations at R = 1400, and a split tile's
partials are summed in a fixed order, so two launches agree bit for bit.
``tf32x3`` is its float32 counterpart, for the float32 shapes a tensor map
describes (K and N multiples of 4, every pointer 16-byte aligned) above
K = :data:`SIMT_MAX_K` (lin2 and lin3 at the paper's widths): the same
tiles and schedule at :data:`TF32_STEP_K`, the product split as
x_hi w_hi + x_hi w_lo + x_lo w_hi on TF32 tensor cores (hi a value's top
19 bits, lo the rest rounded to TF32), which holds float32's 1e-4 where one
TF32 pass does not.
``mma`` takes the other bfloat16 shapes (K or N off 8, an unaligned
pointer; lin1 above 8 classes, K = 20 at 10: ``mma.sync`` tiles of 160
rows x 128 columns, K split over a cluster pair of blocks); ``simt`` the
other float32 shapes (K or N off 4, an unaligned pointer, and the small K
where it was measured faster: the digits' K = 64). lin1's gate
``mult`` is the float32 features beside bfloat16 x and w, since the JAX
kernel multiplies by them in float32: the bfloat16 bodies read a float32
gate at any K. Each launch counts as one ``fused_linear_act``.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ladine_tpu_torch.kernels import _build

_NAME = "fused_linear"
_KERNEL = "fused_linear_act"
SMALL_K = 16  # the largest K the small_k body takes
_BODIES = {"small_k": 0, "mma": 1, "simt": 2}  # the codes of csrc/fused_linear.cu
SMS = 132  # streaming multiprocessors of the H100 SXM: the wgmma body's most blocks
TILE_ROWS, TILE_COLS, STEP_K = 192, 128, 64  # BM, BN, BK of the wgmma body (wg_cfg)
TF32_STEP_K = 32  # BK of the tf32x3 body (tf_cfg): 128 bytes of float32 K, its tiles the wgmma body's
# float32 K up to this stays on simt: on an H100 SXM at 700 W simt was the
# faster body at every such shape examples/kernel_ab.py times (the digits'
# and the GMM check's K = N = 64: 0.0101-0.0104 against 0.0133 ms at
# R = 640, 0.0105-0.0106 against 0.0137-0.0138 at (1, 4100); K = 256:
# 0.0266-0.0267 against 0.0327; K = 1024, R = 160: 0.0819-0.0821 against
# 0.0935-0.0938), tf32x3 from K = 2048 (0.1785-0.1792 against
# 0.2826-0.2829 ms at R = 160)
SIMT_MAX_K = 1024
PART_FLOATS = TILE_ROWS * TILE_COLS  # a block's partial tile in the workspace
FLAG_BYTES = 1024  # the workspace's counts of the split tiles, before the partial tiles
SMEM_LIMIT = 232448  # the dynamic shared memory a block of the H100 may take
# tf32x3's shared memory: the barriers (128 bytes), the alignment of the
# rings to 1024, then 3 stages of x's three 64-row slabs with w_hi and w_lo
# (128 rows of K each), 2 stages of w as loaded (K x 128) and x_lo (three
# slabs)
TF32X3_SLABS_BYTES = 4 * TF32_STEP_K * TILE_ROWS
TF32X3_W_BYTES = 4 * TF32_STEP_K * TILE_COLS
TF32X3_SMEM_BYTES = 128 + 1024 + 3 * (TF32X3_SLABS_BYTES + 2 * TF32X3_W_BYTES) + 2 * TF32X3_W_BYTES \
    + TF32X3_SLABS_BYTES


class WgmmaPlan(NamedTuple):
    """A launch of the wgmma body (``csrc/fused_linear.cu``): tiles of
    TILE_ROWS x TILE_COLS of one member, row tile fastest, each ``steps``
    STEP_K-steps of K deep, on ``grid`` persistent blocks. Block b runs
    tiles b, b + grid, ... whole for ``tiles // grid`` rounds, every block
    of a round at the same K step; the last ``tiles % grid`` tiles are split
    in K into ``chunks`` equal parts, chunk q of remainder tile j run by
    block q * (tiles % grid) + j. ``work_bytes``: the workspace of the split
    tiles (a count each, then a partial tile a block; 0: none is split)."""

    row_tiles: int
    col_tiles: int
    steps: int
    tiles: int
    grid: int
    chunks: int
    work_bytes: int

    @property
    def waves(self) -> int:
        """Rounds of blocks: the whole-tile rounds, and the round of the
        remainder (``chunks`` times shallower where it is split)."""
        return -(-self.tiles // self.grid)

    @property
    def busy(self) -> float:
        """The share of grid x the longest block's steps that does work."""
        rounds, rem = divmod(self.tiles, self.grid)
        longest = rounds * self.steps + (-(-self.steps // self.chunks) if rem else 0)
        return self.tiles * self.steps / (self.grid * longest)


def wgmma_plan(m: int, r: int, k: int, n: int, step_k: int = STEP_K) -> WgmmaPlan:
    """The wgmma body's schedule for M members of an (R, K) x (K, N)
    product: a pure function of the shape, K in steps of ``step_k`` (the
    int8 GEMM's plan, ``kernels/int8_linear.py::gemm_plan``, is this one at
    its own step; its partial tiles are int32, of the same size). Whole tiles run in rounds of at
    most SMS blocks, the blocks of one weight strip's row tiles (row tile
    fastest) side by side, so they share the strip in L2. The remainder
    round splits its tiles in K over as many of the grid's blocks as it can
    fill evenly, so the last round is 1 / chunks as deep; at R <= TILE_ROWS
    each weight strip still leaves device memory once. The last block to
    finish a split tile sums it: no block waits for another."""
    row_tiles, col_tiles = -(-r // TILE_ROWS), -(-n // TILE_COLS)
    steps, tiles = -(-k // step_k), m * row_tiles * col_tiles
    grid = min(SMS, tiles)
    rem = tiles % grid
    chunks = min(grid // rem, steps) if rem else 1
    work = FLAG_BYTES + 4 * rem * chunks * PART_FLOATS if chunks > 1 else 0
    return WgmmaPlan(row_tiles, col_tiles, steps, tiles, grid, chunks, work)


def wgmma_segments(p: WgmmaPlan, block: int) -> Iterator[Tuple[int, int, int, int]]:
    """The (tile, first step, end step, split) segments block ``block``
    runs, in order: the walk of ``Segments`` in ``csrc/fused_linear.cu``.
    ``split``: the remainder index of a split tile, else -1."""
    rounds, rem = divmod(p.tiles, p.grid)
    for i in range(rounds):
        yield block + i * p.grid, 0, p.steps, -1
    if block < rem * p.chunks:
        q, j = divmod(block, rem)
        yield (rounds * p.grid + j, q * p.steps // p.chunks, (q + 1) * p.steps // p.chunks,
               j if p.chunks > 1 else -1)


def wgmma_tile(p: WgmmaPlan, tile: int) -> Tuple[int, int, int]:
    """(member, first row, first column) of a tile."""
    return (tile // (p.row_tiles * p.col_tiles), tile % p.row_tiles * TILE_ROWS,
            tile // p.row_tiles % p.col_tiles * TILE_COLS)


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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _wgmma_lib():
    fn = _build.load(_NAME).fused_linear_wgmma_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w, a, c, mult):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{_KERNEL}: x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"{_KERNEL}: w must have x's dtype {x.dtype}")
    if mult is not None and mult.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{_KERNEL}: mult must be float32 or x's dtype {x.dtype}, got {mult.dtype}")
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
    Those are the shapes a TMA tensor map describes, and they take
    ``wgmma`` in bfloat16 and, above :data:`SIMT_MAX_K`, ``tf32x3`` in
    float32; the rest (ragged K or N, a pointer off 16 bytes, float32 K up
    to :data:`SIMT_MAX_K`) take ``mma`` (bfloat16, staged element by element)
    or ``simt`` (float32): a dispatch by shape, not a fallback."""
    if k <= SMALL_K:
        return "small_k", aligned and n % 8 == 0
    vw = 16 // (2 if dtype == torch.bfloat16 else 4)
    vec = aligned and k % vw == 0 and n % vw == 0
    if dtype == torch.bfloat16:
        return ("wgmma", True) if vec else ("mma", False)
    return ("tf32x3", True) if vec and k > SIMT_MAX_K else ("simt", vec)


def fused_linear_act(
    x: torch.Tensor,
    w: torch.Tensor,
    a: torch.Tensor,
    c: torch.Tensor,
    mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softplus((x @ w) * a + c) [* mult] for every member at once.

    x: (M, R, K), w: (M, K, N), a/c: (M, N) float32, mult: (M, R, N) or
    None; x and w share one dtype (float32 or bfloat16), mult has it too or
    is float32 (lin1, whose gate is the float32 features), at any K.
    Returns (M, R, N) in x.dtype. On the card the kernel body follows from K,
    N, the dtype and the pointers' alignment (:func:`plan`): small_k for K <=
    16, else wgmma in bfloat16 and tf32x3 in float32 (mma and simt off the
    tensor-map shapes, simt at float32 K up to SIMT_MAX_K). The op
    ``torch.ops.ladine_tpu_torch.fused_linear_act``."""
    return _op(x, w, a, c, mult)


@torch.library.custom_op(f"{_build.NAMESPACE}::{_KERNEL}", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
        mult: Optional[torch.Tensor]) -> torch.Tensor:
    return fused_linear_act_plain(x, w, a, c, mult)


@_op.register_fake
def _(x, w, a, c, mult):
    lead = torch.broadcast_shapes(x.shape[:-2], w.shape[:-2])
    return x.new_empty(tuple(lead) + (x.shape[-2], w.shape[-1]))


@_op.register_kernel("cuda")
def _launch(x, w, a, c, mult):
    m, r, k, n = _check(x, w, a, c, mult)
    out = torch.empty((m, r, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, a, c, mult, out) if t is not None)
    body, vec = plan(x.dtype, k, n, aligned)
    ptrs = (x.data_ptr(), w.data_ptr(), a.data_ptr(), c.data_ptr(),
            None if mult is None else mult.data_ptr(), out.data_ptr())
    mult_f32 = int(mult is not None and mult.dtype != x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body in ("wgmma", "tf32x3"):
            p = wgmma_plan(m, r, k, n, STEP_K if body == "wgmma" else TF32_STEP_K)
            work = torch.empty(p.work_bytes, dtype=torch.uint8, device=x.device) if p.work_bytes else None
            err = _wgmma_lib()(
                *ptrs, None if work is None else work.data_ptr(), m, r, k, n, int(body == "wgmma"), mult_f32,
                p.row_tiles, p.col_tiles, p.steps, p.tiles, p.grid, p.chunks, stream,
            )
        else:
            err = _lib()(*ptrs, m, r, k, n, int(x.dtype == torch.bfloat16), mult_f32,
                         int(vec), _BODIES[body], stream)
    _build.check(err, _NAME, _KERNEL)
    _build.launch_counts[_KERNEL] += 1
    return out
