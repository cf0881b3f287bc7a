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
``small_k`` for K <= :data:`SMALL_K` in either dtype (lin1 up to 16
classes, K = 4 at 2: an outer product and an elementwise pass, on the grid
of :func:`small_k_plan`); it alone takes a gate of one row an image,
``mult`` (M, P, N) with P dividing R, row r gated by row r % P (the reverse
chain's trial-major rows, ``infer/engine.py``); ``wgmma`` for larger K in
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
pointer; lin1 above 16 classes, K = 34 at 17: ``mma.sync`` tiles of 160
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
SMALL_K = 32  # the largest K the small_k body takes
_BODIES = {"mma": 1, "simt": 2}  # the codes of csrc/fused_linear.cu's fused_linear_act_launch
SMS = 132  # streaming multiprocessors of the H100 SXM: the wgmma body's most blocks
# the small_k body (sk:: in csrc/fused_linear.cu): blocks of 128 threads, 8
# columns a thread; w's strip in registers up to K = 4, else in shared
# memory (at most SK_W_FLOATS fp32); a unit's x rows in shared memory (at
# most SK_X_FLOATS fp32); at most four blocks an SM (128 registers a
# thread), all resident at once: on an H100 this shape was faster than 256
# x 2 and 512 x 1 at the path's K = 4 (R = 20, 160, 1400) and a little
# slower at the digits' K = 20
SK_THREADS, SK_VEC, SK_REG_K, SK_X_FLOATS, SK_W_FLOATS = 128, 8, 4, 4096, 8192
SK_BLOCKS_PER_SM = 4
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


class SmallKPlan(NamedTuple):
    """A launch of the small_k body (``csrc/fused_linear.cu``): blocks of
    SK_THREADS threads, ``tx`` across a strip of 8 tx columns and ``groups``
    row groups; ``units`` = M x ``strips`` x ``splits`` (a member's strip,
    its image-major rows cut into ``splits`` runs), run by ``grid`` blocks
    in turn; ``smem_bytes`` of dynamic shared memory a block."""

    tx: int
    groups: int
    strips: int
    splits: int
    units: int
    grid: int
    smem_bytes: int


def small_k_plan(m: int, r: int, k: int, n: int) -> SmallKPlan:
    """The small_k body's grid for M members of an (R, K) x (K, N) layer: a
    pure function of the shape and the SMS. A strip is as wide as N allows up
    to 512 columns (narrower above K = SK_REG_K, where w's strip must fit
    SK_W_FLOATS). The rows of each (member, strip) are cut into as many runs
    as fill SK_BLOCKS_PER_SM blocks an SM, each run at least a row a row
    group, and into more where a run's x rows would pass SK_X_FLOATS. The
    grid is at most SMS x SK_BLOCKS_PER_SM blocks, so every block is
    resident at once."""
    tx = 1
    while tx < 64 and SK_VEC * tx < n:
        tx *= 2
    while k > SK_REG_K and tx > 1 and k * SK_VEC * tx > SK_W_FLOATS:
        tx //= 2
    groups, slots = SK_THREADS // tx, SMS * SK_BLOCKS_PER_SM
    strips = -(-n // (SK_VEC * tx))
    splits = max(1, min(slots // (m * strips), r // groups), -(-r // (SK_X_FLOATS // k)))
    units = m * strips * splits
    x_floats = -(-(-(-r // splits) * k) // 4) * 4
    smem = 4 * ((k * SK_VEC * tx if k > SK_REG_K else 0) + x_floats)
    return SmallKPlan(tx, groups, strips, splits, units, min(units, slots), smem)


def small_k_runs(p: SmallKPlan, r: int, gate_rows: int, n: int) -> Iterator[Tuple[int, int, list, int, int]]:
    """(block, member, rows, first column, end column) of each row group of
    each unit, in the kernel's walk: unit u = (member, strip, split) runs on
    block u % grid; its run of image-major rows q (q = i T + t, T = R /
    gate_rows trials, row r = t gate_rows + i) is cut evenly over the row
    groups, and ``rows`` lists a group's rows in its order."""
    trials, bn = r // gate_rows, SK_VEC * p.tx
    base, rem = divmod(r, p.splits)
    for u in range(p.units):
        pair, split = divmod(u, p.splits)
        member, strip = divmod(pair, p.strips)
        q0, size = split * base + min(split, rem), base + (split < rem)
        for g in range(p.groups):
            qa, qb = q0 + g * size // p.groups, q0 + (g + 1) * size // p.groups
            yield (u % p.grid, member, [(q % trials) * gate_rows + q // trials for q in range(qa, qb)],
                   strip * bn, min(strip * bn + bn, n))


def fused_linear_act_plain(x, w, a, c, mult=None) -> torch.Tensor:
    """softplus((x @ w) * a + c) [* mult] with an fp32 product, in x.dtype.

    Leading (member) axes broadcast: x (..., R, K), w (..., K, N),
    a/c (..., N), mult (..., P, N) with P dividing R: row r is gated by
    mult's row r % P (P = R: a gate a row)."""
    z = torch.matmul(x.float(), w.float()) * a.float().unsqueeze(-2) + c.float().unsqueeze(-2)
    out = F.softplus(z)
    if mult is not None:
        reps = x.shape[-2] // mult.shape[-2] if mult.shape[-2] else 1
        out = out * (mult.repeat(*(1,) * (mult.dim() - 2), reps, 1) if reps > 1 else mult).float()
    return out.to(x.dtype)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.fused_linear_act_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _small_k_lib():
    fn = _build.load(_NAME).fused_linear_small_k_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
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
    if mult is not None and (mult.dim() != 3 or mult.shape[0] != m or mult.shape[2] != n
                             or (mult.shape[1] != r and (mult.shape[1] == 0 or r % mult.shape[1]))):
        raise ValueError(f"{_KERNEL}: mult must be (M, P, N) with P dividing R, (M, R, N) = {(m, r, n)}; "
                         f"got {tuple(mult.shape)}")
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

    x: (M, R, K), w: (M, K, N), a/c: (M, N) float32, mult: (M, R, N), or
    (M, P, N) with P dividing R (row r gated by mult's row r % P: a gate
    row an image of the trial-major rows), or None; x and w share one dtype
    (float32 or bfloat16), mult has it too or is float32 (lin1, whose gate
    is the float32 features), at any K. Returns (M, R, N) in x.dtype. On the
    card the kernel body follows from K, N, the dtype and the pointers'
    alignment (:func:`plan`): small_k for K <= SMALL_K, else wgmma in
    bfloat16 and tf32x3 in float32 (mma and simt off the tensor-map shapes,
    simt at float32 K up to SIMT_MAX_K); only small_k takes P < R, and a
    CUDA call of another body with P < R raises.
    The op ``torch.ops.ladine_tpu_torch.fused_linear_act``."""
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
    gate_rows = r if mult is None else mult.shape[1]
    if gate_rows != r and body != "small_k":
        raise ValueError(f"{_KERNEL}: the {body} body takes a gate a row, (M, R, N) = {(m, r, n)}; "
                         f"a gate of {gate_rows} rows is for small_k (K <= {SMALL_K})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "small_k":
            p = small_k_plan(m, r, k, n)
            err = _small_k_lib()(*ptrs, m, r, gate_rows, k, n, int(x.dtype == torch.bfloat16), mult_f32, int(vec),
                                 p.tx, p.strips, p.splits, p.grid, stream)
        elif body in ("wgmma", "tf32x3"):
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
