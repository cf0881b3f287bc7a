"""Fused one-shot attention for the ViT guidance backbone.

Counterpart of ``ladine_tpu/kernels/attention.py::flash_attention``, on the
same (B, N, H, D) layout with scale D^-0.5: fp32 scores and softmax, the
probabilities cast to v's dtype, the output in q's dtype. A CPU tensor goes
through :func:`flash_attention_plain`; a CUDA tensor goes through the kernel
(``csrc/attention.cu``), or the wrapper raises. Both are implementations of
one custom op (``kernels/_build.py``).

The kernel has two bodies, chosen by dtype (:func:`body`): bfloat16 runs
on the tensor cores (``mma.sync``) and takes D = 16, 32, ..., 128; float32
runs scalar FMA and takes any D of whole 16-byte vectors. A bfloat16 head
of another width up to 128 (D = 12 in the digits ViT, embed 48 over 4
heads) is zero-padded to the next multiple of 16 first (:func:`pad_heads`)
and the kernel is given the real D's scale, as the JAX kernel pads D to
128: zero columns add nothing to q k^T and give zero output columns, which
are sliced off.

The op has a gradient (:func:`flash_attention_vjp`), so the white-box
attacks differentiate the ViT through it: the forward stays the kernel on a
CUDA tensor whether or not its inputs require grad, and the backward is the
attention VJP in plain PyTorch, with P recomputed from the saved q and k.
The JAX package has no backward kernel either: its gradient is XLA's
autodiff of the einsum attention.
"""

from __future__ import annotations

import ctypes

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
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        smem = lib.flash_attention_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return lib


def padded_head_dim(dtype: torch.dtype, d: int) -> int:
    """The D the kernel runs for heads of width ``d``: the next multiple of
    16 in bfloat16 (the tensor-core body's k16 step), ``d`` in float32."""
    return -(-d // 16) * 16 if dtype == torch.bfloat16 else d


def pad_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k and v zero-padded in D to :func:`padded_head_dim`: new
    contiguous tensors, or the inputs themselves where D needs no padding."""
    def pad(t):
        extra = padded_head_dim(t.dtype, t.shape[-1]) - t.shape[-1]
        return torch.nn.functional.pad(t, (0, extra)) if extra else t

    return pad(q), pad(k), pad(v)


def body(dtype: torch.dtype, d: int) -> str:
    """The kernel body that takes (dtype, D): "mma" for bfloat16, "scalar"
    for float32; raises on a bfloat16 D the tensor-core body cannot take."""
    if dtype == torch.bfloat16:
        if d % 16 or not 16 <= d <= 128:
            raise ValueError(f"{_KERNEL}: bfloat16 needs D a multiple of 16 up to 128, got {d}")
        return "mma"
    return "scalar"


def _check(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{_KERNEL}: q, k, v must share one (B, N, H, D) shape")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{_KERNEL}: q, k, v must share float32 or bfloat16; got {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{_KERNEL}: q, k, v must be on one device")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(-1) != 1:
        raise ValueError(f"{_KERNEL}: q, k, v must share strides with a unit last stride")
    vw = 16 // q.element_size()
    if (q.shape[-1] % vw or any(s % vw for s in q.stride()[:3])
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"{_KERNEL}: D, the strides and the pointers must be multiples of 16 bytes")
    b, n, h, d = q.shape
    body(q.dtype, d)
    if b > 65535 or h > 65535:
        raise ValueError(f"{_KERNEL}: batch and heads must each be at most 65535 (grid)")
    return b, n, h, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) x3 -> (B, N, H, D) contiguous, scale = D^-0.5.

    On the card q, k and v share one dtype (float32 or bfloat16) and one
    stride pattern with a unit innermost stride, as the slices of a fused
    qkv projection do. In float32 D, the other strides and the data
    pointers are multiples of the kernel's 16-byte vector; in bfloat16 D is
    at most 128, and a D that is not a multiple of 16 runs on zero-padded
    copies (:func:`pad_heads`). The op
    ``torch.ops.ladine_tpu_torch.flash_attention``; its gradient is
    :func:`flash_attention_vjp`, on the unpadded tensors."""
    return _op(q, k, v)


@torch.library.custom_op(f"{_build.NAMESPACE}::{_KERNEL}", mutates_args=(), device_types="cpu")
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_attention_plain(q, k, v).contiguous()


@_op.register_fake
def _(q, k, v):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@_op.register_kernel("cuda")
def _launch(q, k, v):
    d = q.shape[-1]  # the real D: its scale, also where the heads are padded
    q, k, v = pad_heads(q, k, v)
    b, n, h, dp = _check(q, k, v)
    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = _lib()
    if lib.flash_attention_smem_bytes(n, dp, is_bf16) > _MAX_SMEM:
        raise ValueError(f"{_KERNEL}: K and V of N={n}, D={dp} do not fit in shared memory")
    out = torch.empty((b, n, h, dp), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :d].contiguous()
    sb, sn, sh, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, h, dp, sb, sn, sh, d**-0.5, is_bf16, stream,
        )
    _build.check(err, _NAME, _KERNEL)
    _build.launch_counts[_KERNEL] += 1
    return out if dp == d else out[..., :d].contiguous()


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, d_out):
    return flash_attention_vjp(*ctx.saved_tensors, d_out)


_op.register_autograd(_backward, setup_context=_setup_context)
