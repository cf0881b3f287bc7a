"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. This file imports no JAX, so it runs on
a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 differs from the plain version only in summation order
(1e-4); bf16 outputs are rounded to bf16 (2^-8 relative), so 1e-2.
"""

import numpy as np
import pytest
import torch

from ladine_tpu_torch.kernels import (
    flash_attention,
    flash_attention_plain,
    fused_linear_act,
    fused_linear_act_plain,
    launch_counts,
)
from torch_inputs import layer_inputs, qkv_views


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 9, 24, 17), (5, 160, 4, 4096), (2, 70, 256, 200), (3, 65, 72, 64)])
def test_fused_linear_act_kernel_matches_plain(cuda, dtype, shape):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(5), *shape))
    x, w, mult = x.to(dtype), w.to(dtype), mult.to(dtype)
    for m in (None, mult):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, m)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1
        ref = fused_linear_act_plain(x, w, a, c, m)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 4, 16), (3, 196, 12, 64), (1, 197, 2, 64)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, shape):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    _, (q, k, v) = qkv_views(np.random.default_rng(6), *shape)
    q, k, v = (t.to(cuda, dtype) for t in (q, k, v))
    q, k, v = (torch.stack([q, k, v], 2)[:, :, i] for i in range(3))  # strided again
    launch_counts.clear()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernels_raise_instead_of_falling_back(cuda):
    x = torch.zeros(1, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fused_linear_act(x, x.new_zeros(1, 8, 8), torch.zeros(1, 8, device=cuda),
                         torch.zeros(1, 8, device=cuda))
    q = torch.zeros(1, 4, 2, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
