"""Fused one-shot attention for the ViT guidance backbone.

Counterpart of ``ladine_tpu/kernels/attention.py::flash_attention``, on the
same (B, N, H, D) layout with scale D^-0.5: fp32 scores and softmax, the
probabilities cast to v's dtype, the output in q's dtype. A CPU tensor goes
through :func:`flash_attention_plain`; a CUDA tensor goes through the kernel
(``csrc/attention.cu``), or the wrapper raises. Both are implementations of
one custom op (``kernels/_build.py``).

The kernel has two bodies, chosen by dtype (:func:`body`): bfloat16 runs
on the tensor cores (``mma.sync``) and takes D = 16, 32, ..., 128; float32
runs scalar FMA and takes any D of whole 16-byte vectors.
"""

from __future__ import annotations

import ctypes

import torch

from ladine_tpu_torch.kernels import _build

_NAME = "attention"
_KERNEL = "flash_attention"
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    d = q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * d**-0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype), v).to(q.dtype)


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
    qkv projection do; D, the other strides and the data pointers are
    multiples of the kernel's 16-byte vector; in bfloat16 D is a multiple of
    16 up to 128. The op ``torch.ops.ladine_tpu_torch.flash_attention``."""
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
    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = _lib()
    if lib.flash_attention_smem_bytes(n, d, is_bf16) > _MAX_SMEM:
        raise ValueError(f"{_KERNEL}: K and V of N={n}, D={d} do not fit in shared memory")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    sb, sn, sh, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, h, d, sb, sn, sh, d**-0.5, is_bf16, stream,
        )
    _build.check(err, _NAME, _KERNEL)
    _build.launch_counts[_KERNEL] += 1
    return out
