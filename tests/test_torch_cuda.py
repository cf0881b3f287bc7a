"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. This file imports no JAX, so it runs on
a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 differs from the plain version only in summation order
(1e-4); bf16 outputs are rounded to bf16 (2^-8 relative), so 1e-2 (in
attention the probabilities are rounded to bf16 too, as in the plain
version, and can round apart where the sums differ in order). The int8
kernels pick the same int8 codes as their plain versions (same IEEE
division, round half to even) and sum them exactly in int32, so K4 differs
only where softplus rounds apart (1e-5 in fp32); K5's lin1 sums its 4 terms
in another order, which can flip one code of h1 (1e-3), and its lin4 sums
with atomics in no fixed order (1e-4).
"""

import numpy as np
import pytest
import torch

from ladine_tpu_torch.kernels import (
    flash_attention,
    flash_attention_plain,
    fused_linear_act,
    fused_linear_act_plain,
    int8_eps_l12,
    int8_eps_l12_plain,
    int8_eps_l34,
    int8_eps_l34_plain,
    int8_linear_softplus,
    int8_linear_softplus_plain,
    launch_counts,
)
from torch_inputs import int8_layer_inputs, layer_inputs, qkv_views


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [1, 64, 65, 196, 197, 300])
def test_flash_attention_bf16_mma_body_matches_plain(cuda, n, d):
    """The tensor-core body on strided qkv views: one and several 64-row
    query tiles, a ragged last tile, and more keys than one 32-key chunk."""
    _, (q, k, v) = qkv_views(np.random.default_rng(10), 2, n, 3, d)
    q, k, v = (torch.stack([q, k, v], 2).to(cuda, torch.bfloat16)[:, :, i] for i in range(3))
    launch_counts.clear()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1 and out.shape == (2, n, 3, d)
    _close(out, flash_attention_plain(q, k, v), 1e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_raises_on_d_24(cuda):
    q = torch.zeros(1, 4, 2, 24, device=cuda, dtype=torch.bfloat16)
    launch_counts.clear()
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention(q, q, q)
    assert launch_counts["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 20, 160, 161, 1400])
def test_fused_linear_act_mma_body_at_any_row_count(cuda, r):
    """lin2/lin3's shape (K = N = 4096, bf16) at row counts below, at and
    above one 160-row tile, with and without the gate."""
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(11), 2, r, 4096, 4096))
    x, w, mult = x.bfloat16(), w.bfloat16(), mult.bfloat16()
    for m in (None, mult):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, m)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1
        _close(out, fused_linear_act_plain(x, w, a, c, m), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 16])
@pytest.mark.parametrize("shape", [(5, 160, 4096), (2, 9, 17)], ids=["path", "ragged-N"])
def test_fused_linear_act_small_k_body_matches_plain(cuda, dtype, k, shape):
    m, r, n = shape
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(12), m, r, k, n))
    x, w, mult = x.to(dtype), w.to(dtype), mult.to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for g in (None, mult):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, g)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1
        _close(out, fused_linear_act_plain(x, w, a, c, g), tol)


INT8_SHAPES = [(5, 160, 4096, 4096), (5, 20, 256, 200), (2, 23, 96, 80), (1, 70, 512, 136)]


def _close(out, ref, tol):
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zp", [False, True], ids=["symmetric", "zero-point"])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_linear_softplus_kernel_matches_plain(cuda, dtype, zp, shape):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    x, xmax, w_q, s, c, colsum, _, _ = int8_layer_inputs(np.random.default_rng(7), *shape, cuda, dtype, zp)
    launch_counts.clear()
    h, hmax = int8_linear_softplus(x, xmax, w_q, s, c, colsum)
    torch.cuda.synchronize()
    assert launch_counts["int8_linear_softplus"] == 1
    ref_h, ref_m = int8_linear_softplus_plain(x, xmax, w_q, s, c, colsum)
    _close(h, ref_h, tol)
    _close(hmax, ref_m, tol)
    assert torch.equal(hmax, h.float().amax(-1, keepdim=True))  # the max of the stored values


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_eps_fused_kernels_match_plain(cuda, dtype, shape):
    m, r, k, n = shape
    rng = np.random.default_rng(8)
    # l12: lin1 (K = 4) + gate + lin2 (K -> K)
    f, _, w_q2, s2, c2, _, y_in, w1 = int8_layer_inputs(rng, m, r, k, k, cuda, dtype, False)
    a1, c1 = (torch.from_numpy(rng.uniform(0.5, 1.5, (m, k)).astype(np.float32)).to(cuda) for _ in range(2))
    launch_counts.clear()
    h2, hmax2 = int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, c2)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l12"] == 1
    ref_h2, ref_m2 = int8_eps_l12_plain(f, y_in, w1, a1, c1, w_q2, s2, c2)
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    _close(h2, ref_h2, tol)
    _close(hmax2, ref_m2, tol)

    # l34: lin3 (K -> N, zero-point) + lin4 (N -> 3), on the plain h2 so that it is held alone
    _, _, w_q3, s3, c3, cs3, _, _ = int8_layer_inputs(rng, m, r, k, n, cuda, dtype, True)
    w4 = torch.from_numpy(rng.standard_normal((m, n, 3)).astype(np.float32) * n**-0.5).to(cuda, dtype)
    out = int8_eps_l34(ref_h2, ref_m2, w_q3, s3, c3, cs3, w4)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l34"] == 1 and out.dtype == torch.float32
    ref = int8_eps_l34_plain(ref_h2, ref_m2, w_q3, s3, c3, cs3, w4)
    _close(out, ref, 1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_int8_kernels_raise_instead_of_falling_back(cuda):
    x, xmax, w_q, s, c, colsum, y_in, w1 = int8_layer_inputs(np.random.default_rng(9), 1, 20, 64, 32, cuda,
                                                             torch.float32, True)
    with pytest.raises(TypeError):  # float16 activations
        int8_linear_softplus(x.half(), xmax, w_q, s, c)
    with pytest.raises(ValueError, match="K-contiguous"):  # a row-major weight
        int8_linear_softplus(x, xmax, w_q.contiguous(), s, c)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_linear_softplus(x[:, :, :40].contiguous(), xmax, w_q[:, :40], s, c)
    with pytest.raises(TypeError):  # bf16 y_in beside fp32 f
        int8_eps_l12(x, y_in.bfloat16(), w1, s[:, :1].expand(1, 64).contiguous(),
                     c[:, :1].expand(1, 64).contiguous(), w_q, s, c)
    with pytest.raises(TypeError):  # w4 in another type than h2
        int8_eps_l34(x, xmax, w_q, s, c, colsum, torch.zeros(1, 32, 2, device=cuda, dtype=torch.bfloat16))
