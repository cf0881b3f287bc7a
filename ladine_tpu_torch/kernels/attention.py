"""Fused one-shot attention for the ViT guidance backbone.

Counterpart of ``ladine_tpu/kernels/attention.py::flash_attention``, on the
same (B, N, H, D) layout with scale D^-0.5: fp32 scores and softmax, the
probabilities cast to v's dtype, the output in q's dtype. A CPU tensor goes
through :func:`flash_attention_plain`; a CUDA tensor goes through the kernel
(``csrc/attention.cu``), or the wrapper raises. Both are implementations of
one custom op (``kernels/_build.py``).

The kernel has three bodies, chosen by :func:`attention_plan` from the
shape, the dtype and the layout:

* ``wgmma`` (bfloat16, D = 64, N <= 256, strides a TMA tensor map takes:
  every ViT-B/16 and DeiT head; D = 8, 16, ... 48 zero-padded to 64): TMA
  loads fed by a producer warp, one ``wgmma`` score product over the whole
  key axis in registers, p rounded to bfloat16 into the registers of the
  second ``wgmma`` product, on a persistent grid of at most 132 blocks.
* ``mma`` (the other bfloat16 shapes: N > 256, any other even D up to 128,
  other strides): ``mma.sync`` tiles; a head whose width is not a multiple
  of 16 (D = 12 in the digits ViT, embed 48 over 4 heads) is read at its
  real width and padded with zeros in shared memory, as the JAX kernel pads
  D to 128, and the kernel is given the real D's scale.
* ``simt`` (float32, D of whole 16-byte vectors): register-tiled fp32
  products on 128-row blocks (64 where fewer blocks would leave SMs idle),
  the softmax in fp32 in the plain version's order.

The op has a gradient (:func:`flash_attention_vjp`), so the white-box
attacks differentiate the ViT through it: the forward stays the kernel on a
CUDA tensor whether or not its inputs require grad, and the backward is the
attention VJP in plain PyTorch, with P recomputed from the saved q and k.
The JAX package has no backward kernel either: its gradient is XLA's
autodiff of the einsum attention.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ladine_tpu_torch.kernels import _build

_NAME = "attention"
_KERNEL = "flash_attention"
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    ct = torch.promote_types(q.dtype, torch.float32)  # float32, or float64 for float64 inputs
    s = torch.einsum("bnhd,bmhd->bhnm", q.to(ct), k.to(ct)) * q.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype), v).to(q.dtype)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor):
    """The gradients (dq, dk, dv) of ``sum(d_out * attention(q, k, v))``,
    each in its input's dtype:

        dV = P^T dO,  dS = P * (dO V^T - rowsum(dO V^T * P)),
        dQ = dS K D^-0.5,  dK = dS^T Q D^-0.5,

    on P = softmax(q k^T D^-0.5) recomputed from q and k, all in float32
    (float64 for float64 inputs). Plain matmuls on (B, H, N, D) views, not
    einsums: the attacks call this 12 times a step, and its host time is
    the step's. Each call adds one to ``vjp_runs["flash_attention"]``."""
    _build.vjp_runs[_KERNEL] += 1
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = (t.transpose(1, 2).to(ct) for t in (q, k, v, d_out))  # (B, H, N, D)
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(qf @ kf.transpose(-1, -2) * scale, dim=-1)
    dv = p.transpose(-1, -2) @ gf
    dp = gf @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = ds @ kf * scale
    dk = ds.transpose(-1, -2) @ qf * scale
    return dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _lib():
    lib = _build.load(_NAME)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
            + [ctypes.c_float] + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        smem = lib.flash_attention_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    return lib


SMS = 132  # streaming multiprocessors of the H100 SXM: the wgmma body's most blocks
ROUTES = {"wgmma": 0, "mma": 1, "simt": 2}  # the codes of csrc/attention.cu
WG_D, WG_KEY_STEP, WG_MAX_KEYS = 64, 16, 256  # the wgmma body's head width and key axis (namespace wg)
WG_CONSUMERS = 2  # its warpgroups that take query tiles
WG_STAGES = 2  # its ring of units' K, V and Q tiles
Q_TILE = 64  # query rows a tile of the bf16 bodies
MMA_KEY_CHUNK = 32  # the mma body's key chunk (KC)


class AttentionPlan(NamedTuple):
    """A launch of ``csrc/attention.cu``. ``route``: the body. ``dp``: the
    head width in shared memory (``wgmma``: 64; ``mma``: D padded to a
    multiple of 16). ``vb``: the ``mma`` body's copy width in bytes.
    ``keys``: the key axis in shared memory. Each (b, h) pair has
    ``q_tiles`` query tiles of ``rows`` rows; the ``wgmma`` body splits them
    into ``splits`` units of ``tpu`` tiles each and runs units b, b + grid,
    ... on ``grid`` persistent blocks, WG_STAGES units in its ring; the
    other bodies launch one block of ``threads`` a (tile, h, b), ``grid``
    blocks in all. ``smem_bytes``: a block's shared memory. ``late_v``: the
    ``simt`` body loads V into K's place as S is done with it (where K, V,
    the Q tile and the scores together would not fit)."""

    route: str
    dp: int
    vb: int
    keys: int
    rows: int
    q_tiles: int
    tpu: int
    splits: int
    units: int
    grid: int
    threads: int
    smem_bytes: int
    late_v: bool = False

    @property
    def rounds(self) -> int:
        """Tile times of the longest block: its units, times the tiles each
        consumer warpgroup takes in one (1 outside ``wgmma``)."""
        return -(-self.units // self.grid) * -(-self.tpu // WG_CONSUMERS) if self.units else 0


def _simt_ld(d: int) -> int:
    return d + (4 if (d // 4) % 2 == 0 else 0)  # an odd number of 16-byte vectors (simt::ld)


def _wgmma_split(pairs: int, q_tiles: int) -> Tuple[int, int]:
    """(splits, tiles a unit): the fewest tile rounds of the longest block,
    then the most blocks, then the fewest units (each unit reads its pair's
    K and V once)."""
    best = None
    for splits in range(1, q_tiles + 1):
        tpu = -(-q_tiles // splits)
        if -(-q_tiles // tpu) != splits:
            continue  # the same tiles a unit as fewer splits
        units = pairs * splits
        grid = min(SMS, units)
        key = (-(-units // grid) * -(-tpu // WG_CONSUMERS), -grid, units)
        if best is None or key < best[0]:
            best = (key, splits, tpu)
    return best[1], best[2]


def attention_plan(b: int, n: int, h: int, d: int, dtype: torch.dtype, vec: int = 16,
                   tma: bool = True) -> AttentionPlan:
    """The launch for (B, N, H, D) heads of ``dtype``: a pure function of
    the shape, the dtype, ``vec`` (the widest of 16, 8 and 4 bytes that
    divides the strides and the pointers) and ``tma`` (strides a TMA tensor
    map takes: 16-byte multiples, each outer one spanning the inner dims).
    bfloat16 at D = 64 (or 8, 16, ... 48, zero-padded to 64), N <= 256 with
    ``tma`` takes ``wgmma``; other bfloat16 shapes (an even D up to 128)
    ``mma``; float32 (D and the strides whole 16-byte vectors) ``simt``.
    Raises on anything else and where a block's shared memory would pass
    227 KB."""
    q_tiles = -(-n // Q_TILE)
    if dtype == torch.bfloat16:
        if d % 2 or not 2 <= d <= 128 or vec < 4:
            raise ValueError(f"{_KERNEL}: bfloat16 takes an even D up to 128, 4-byte aligned (the mma body "
                             f"pads it to a multiple of 16); got D = {d}, {vec}-byte strides")
        if d % 8 == 0 and d <= WG_D and n <= WG_MAX_KEYS and vec == 16 and tma:
            keys = max(WG_KEY_STEP, -(-n // WG_KEY_STEP) * WG_KEY_STEP)
            splits, tpu = _wgmma_split(b * h, q_tiles) if b * h and q_tiles else (1, max(q_tiles, 1))
            units = b * h * splits
            stage = 2 * keys * 2 * WG_D + tpu * Q_TILE * 2 * WG_D  # K, V and the unit's Q tiles
            return AttentionPlan("wgmma", WG_D, 16, keys, Q_TILE, q_tiles, tpu, splits, units, min(SMS, units),
                                 128 * (WG_CONSUMERS + 1), 128 + 1024 + WG_STAGES * stage)
        dp = -(-d // 16) * 16
        vb = min(vec, (2 * d) & -(2 * d), 16)
        keys = -(-n // MMA_KEY_CHUNK) * MMA_KEY_CHUNK
        route, rows, threads, late_v = "mma", Q_TILE, 128, False
        smem = (2 * keys + Q_TILE) * (dp + 8) * 2
    elif dtype == torch.float32:
        if d % 4 or vec < 16:
            raise ValueError(f"{_KERNEL}: D, the strides and the pointers must be multiples of 16 bytes")
        # 128 rows a block (K and V read once for 128 rows) where that still
        # makes two blocks an SM and fits, else 64; V after S where K, V, Q
        # and the scores together pass a block's shared memory
        route, dp, vb, keys = "simt", d, 16, n
        for rows in (128, 64):
            smem = ((2 * n + rows) * _simt_ld(d) + n * (rows + 4)) * 4
            late_v = smem > _MAX_SMEM
            if late_v:
                smem -= n * _simt_ld(d) * 4
            if rows == 64 or (b * h * -(-n // rows) >= 2 * SMS and smem <= _MAX_SMEM):
                break
        threads = 4 * rows  # 4 rows a thread, 16 threads a row
        q_tiles = -(-n // rows)
    else:
        raise TypeError(f"{_KERNEL}: q, k, v must share float32 or bfloat16; got {dtype}")
    if smem > _MAX_SMEM:
        raise ValueError(f"{_KERNEL}: K and V of N={n}, D={d} do not fit in shared memory ({route} body)")
    if b > 65535 or h > 65535:
        raise ValueError(f"{_KERNEL}: batch and heads must each be at most 65535 (grid)")
    units = q_tiles * h * b
    return AttentionPlan(route, dp, vb, keys, rows, q_tiles, 1, 1, units, units, threads, smem, late_v)


def _layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The strides (sb, sn, sh) in elements with a size-1 dim's stride made
    that of a packed layout, the widest copy vector in bytes (16, 8, 4 or
    less) that divides D, the strides and the pointers, and whether a TMA
    tensor map takes the layout."""
    b, n, h, d = q.shape
    sb, sn, sh, _ = q.stride()
    sh = sh if h > 1 else d
    sn = sn if n > 1 else h * sh
    sb = sb if b > 1 else n * sn
    es = q.element_size()
    vec = 16
    for x in (d * es, sb * es, sn * es, sh * es, *(t.data_ptr() for t in (q, k, v))):
        while vec > 1 and x % vec:
            vec //= 2
    tma = vec == 16 and d <= sh and h * sh <= sn and n * sn <= sb
    return (sb, sn, sh), vec, tma


def _check(q, k, v):
    """(B, N, H, D) of q, k and v that one of the bodies takes; raises
    otherwise."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{_KERNEL}: q, k, v must share one (B, N, H, D) shape")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{_KERNEL}: q, k, v must share float32 or bfloat16; got {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{_KERNEL}: q, k, v must be on one device")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(-1) != 1:
        raise ValueError(f"{_KERNEL}: q, k, v must share strides with a unit last stride")
    _, vec, tma = _layout(q, k, v)
    attention_plan(*q.shape, q.dtype, vec, tma)  # raises on what no body takes
    return tuple(q.shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) x3 -> (B, N, H, D) contiguous, scale = D^-0.5.

    On the card q, k and v share one dtype (float32 or bfloat16) and one
    stride pattern with a unit innermost stride, as the slices of a fused
    qkv projection do. In float32 D, the other strides and the data
    pointers are multiples of 16 bytes; in bfloat16 D is even and at most
    128, the strides and pointers multiples of 4 bytes
    (:func:`attention_plan`). The op
    ``torch.ops.ladine_tpu_torch.flash_attention``; its gradient is
    :func:`flash_attention_vjp`."""
    return _op(q, k, v)


@torch.library.custom_op(f"{_build.NAMESPACE}::{_KERNEL}", mutates_args=(), device_types="cpu")
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_attention_plain(q, k, v).contiguous()


@_op.register_fake
def _(q, k, v):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@_op.register_kernel("cuda")
def _launch(q, k, v):
    b, n, h, d = _check(q, k, v)
    (sb, sn, sh), vec, tma = _layout(q, k, v)
    p = attention_plan(b, n, h, d, q.dtype, vec, tma)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h, d, sb, sn, sh, d**-0.5,
            ROUTES[p.route], p.dp, p.vb, p.keys, p.rows, p.q_tiles, p.tpu, p.splits, p.units, p.grid,
            p.threads, int(p.late_v), stream,
        )
    _build.check(err, _NAME, _KERNEL)
    _build.launch_counts[_KERNEL] += 1
    return out


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, d_out):
    return flash_attention_vjp(*ctx.saved_tensors, d_out)


_op.register_autograd(_backward, setup_context=_setup_context)
