"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. This file imports no JAX, so it runs on
a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 differs from the plain version only in summation order
(1e-4; K1's ``tf32x3`` body also drops the product of the two TF32 low
halves, ~2^-21 relative, and sums each stage on the tensor cores); bf16
outputs are rounded to bf16 (2^-8 relative), so 1e-2 (in
attention the probabilities are rounded to bf16 too, as in the plain
version, and can round apart where the sums differ in order). The int8
kernels pick the same int8 codes as their plain versions (same IEEE
division, round half to even) and sum them exactly in int32, so K4 differs
only where softplus rounds apart (1e-5 in fp32); K5's lin1 pass does the
plain version's float32 arithmetic in the same order, so its codes are equal
bit for bit, and its lin4 sums in another order than the plain product
(1e-4), but in a fixed one: two launches agree bit for bit at every N.

K3's gradient with the kernel's forward (the forward of a grad-requiring
call still launches the kernel) equals autograd of the plain version at the
ViT's shape, 1e-4 in fp32 and 2e-2 in bf16 (the plain version's backward
runs its einsums in bf16), and the op passes ``opcheck`` with inputs that
require grad.

The serving program on the card: each kernel's ``torch.library`` op passes
``opcheck`` with its CUDA implementation; a request replayed from the CUDA
graph of its batch shape equals the same request run eagerly, exactly, at
every preset and int8 flag;
concurrent callers of one graph each get their own rows; a bundle exported
on the card serves exactly as the live predictor; and N replays count N
times the launches captured.
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
    int8_lin1,
    int8_lin1_plain,
    int8_linear_softplus,
    int8_linear_softplus_plain,
    launch_counts,
)
from ladine_tpu_torch.kernels import attention as attn_mod
from ladine_tpu_torch.kernels import fused_linear as fl_mod
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
    """The tensor-core bodies on strided qkv views (``wgmma`` at D = 64 up
    to 256 keys, ``mma`` otherwise): one and several 64-row query tiles, a
    ragged last tile, and more keys than one 32-key chunk."""
    _, (q, k, v) = qkv_views(np.random.default_rng(10), 2, n, 3, d)
    q, k, v = (torch.stack([q, k, v], 2).to(cuda, torch.bfloat16)[:, :, i] for i in range(3))
    launch_counts.clear()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1 and out.shape == (2, n, 3, d)
    _close(out, flash_attention_plain(q, k, v), 1e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_pads_d_24_and_raises_above_128(cuda):
    """D = 24 in bf16 is no k16 step of the tensor-core body: the wrapper
    runs it on zero-padded heads of 32 (one launch); above 128 it raises
    before any launch."""
    q = torch.zeros(1, 4, 2, 24, device=cuda, dtype=torch.bfloat16)
    launch_counts.clear()
    out = flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1 and out.shape == q.shape and out.is_contiguous()
    q = torch.zeros(1, 4, 2, 136, device=cuda, dtype=torch.bfloat16)
    launch_counts.clear()
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention(q, q, q)
    assert launch_counts["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 24, 40])
@pytest.mark.parametrize("n", [16, 17, 197])
def test_flash_attention_bf16_pads_any_d_up_to_128(cuda, n, d):
    """F7: bf16 heads of a width that is not a multiple of 16 (the digits
    ViT's D = 12, at its 16 patches and 17 tokens) run on zero-padded
    copies with the real D's scale, against the plain version on the
    unpadded strided views; the gradient is the plain VJP on those views."""
    qkv, _ = qkv_views(np.random.default_rng(17), 4, n, 4, d)
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    launch_counts.clear()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1 and out.shape == (4, n, 4, d) and out.is_contiguous()
    ref = flash_attention_plain(q, k, v)
    _close(out, ref, 1e-2)
    d_out = torch.randn(4, n, 4, d, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    (got,) = torch.autograd.grad(out, qkv, d_out.bfloat16())
    (want,) = torch.autograd.grad(ref, qkv, d_out.bfloat16())
    _close(got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 20, 64, 65, 160, 161, 192, 1400])
def test_fused_linear_act_mma_body_at_any_row_count(cuda, r):
    """lin2/lin3's shape (K = N = 4096, bf16; the wgmma body) at row counts
    below, at and above one 64-row slab and one 192-row tile, on the path's
    five members (at R <= 192 a stream plan that splits tiles between
    blocks), with no gate, a bf16 gate and a float32 gate."""
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(11), 5, r, 4096, 4096))
    x, w = x.bfloat16(), w.bfloat16()
    assert fl_mod.plan(x.dtype, 4096, 4096, True) == ("wgmma", True)
    for m in (None, mult.bfloat16(), mult):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, m)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1
        _close(out, fused_linear_act_plain(x, w, a, c, m), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [20, 160, 1400])
def test_fused_linear_act_wgmma_body_is_deterministic(cuda, r):
    """Two launches on the same inputs give the same bits: a tile split
    between two blocks adds the partial of the one to the other's sum in a
    fixed order, with no float atomics."""
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(19), 5, r, 4096, 4096))
    x, w = x.bfloat16(), w.bfloat16()
    for m in (None, mult):
        first = fused_linear_act(x, w, a, c, m)
        second = fused_linear_act(x, w, a, c, m)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged-K", "ragged-N", "unaligned", "lin1-17-classes"])
def test_fused_linear_act_ragged_and_unaligned_take_the_mma_body(cuda, case):
    """Shapes a tensor map cannot describe stay on the mma body (staged
    element by element) and match the plain version."""
    m, r, k, n = {"ragged-K": (2, 33, 4100, 256), "ragged-N": (2, 33, 256, 4100), "unaligned": (2, 33, 256, 256),
                  "lin1-17-classes": (5, 160, 34, 4096)}[case]
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(23), m, r, k, n))
    x, w = x.bfloat16(), w.bfloat16()
    if case == "unaligned":  # x one element into its storage: 2 bytes off 16
        x = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)[1:1 + x.numel()].view(m, r, k).copy_(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, a, c, mult))
    assert aligned == (case != "unaligned")
    assert fl_mod.plan(x.dtype, k, n, aligned) == ("mma", False)
    for g in (None, mult):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, g)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1
        _close(out, fused_linear_act_plain(x, w, a, c, g), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", ["lin1", "lin2"])
def test_fused_linear_act_at_the_evidence_test_batch(cuda, dtype, layer):
    """The evidence run's test batch: 70 images x 20 trials = 1400 rows a
    member, five members; lin1 (K = 4, the float32 features as the gate:
    ``small_k``) and lin2/lin3 (K = N = 4096: ``wgmma`` in bf16, ``tf32x3``
    in float32)."""
    k = 4 if layer == "lin1" else 4096
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(21), 5, 1400, k, 4096))
    x, w = x.to(dtype), w.to(dtype)
    gate = mult if layer == "lin1" else None
    launch_counts.clear()
    out = fused_linear_act(x, w, a, c, gate)
    torch.cuda.synchronize()
    assert launch_counts["fused_linear_act"] == 1 and out.dtype == dtype and out.shape == (5, 1400, 4096)
    _close(out, fused_linear_act_plain(x, w, a, c, gate), 1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 20, 160, 161, 1400])
def test_fused_linear_act_tf32x3_body_at_any_row_count(cuda, r):
    """float32 lin2/lin3 (K = N = 4096; the tf32x3 body) on the path's five
    members at row counts in one slab, one row tile (split tiles) and the
    evidence batch, with and without a float32 gate: within float32's 1e-4
    of the plain version (a float32 product with TF32 off)."""
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(31), 5, r, 4096, 4096))
    assert fl_mod.plan(x.dtype, 4096, 4096, True) == ("tf32x3", True)
    for m in (None, mult):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, m)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1 and out.dtype == torch.float32
        _close(out, fused_linear_act_plain(x, w, a, c, m), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [160, 1400])
def test_fused_linear_act_tf32x3_body_is_deterministic(cuda, r):
    """Two launches of the tf32x3 body give the same bits: at R = 160 the
    remainder's tiles are split in K quarters and summed in chunk order;
    at R = 1400 none is split."""
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(37), 5, r, 4096, 4096))
    assert (fl_mod.wgmma_plan(5, r, 4096, 4096, fl_mod.TF32_STEP_K).chunks > 1) == (r == 160)
    for m in (None, mult):
        first = fused_linear_act(x, w, a, c, m)
        second = fused_linear_act(x, w, a, c, m)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged-K", "ragged-N", "unaligned", "lin1-17-classes", "digits", "k1028-n4",
                                  "k2048-n68"])
def test_fused_linear_act_float32_bodies_by_the_plan(cuda, case):
    """float32 shapes a tensor map cannot describe (K or N off 4, a pointer
    off 16 bytes) and K up to SIMT_MAX_K (the digits' lin2) take ``simt``,
    the others ``tf32x3`` (the smallest K and N it takes: one step past K's
    end and 124 columns past N's; a ragged column tile); each matches the
    plain version at 1e-4."""
    m, r, k, n = {"ragged-K": (2, 33, 4098, 256), "ragged-N": (2, 33, 1028, 4098), "unaligned": (2, 33, 2048, 256),
                  "lin1-17-classes": (5, 160, 34, 4096), "digits": (5, 640, 64, 64), "k1028-n4": (2, 9, 1028, 4),
                  "k2048-n68": (3, 200, 2048, 68)}[case]
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(41), m, r, k, n))
    if case == "unaligned":  # x one element into its storage: 4 bytes off 16
        x = torch.empty(x.numel() + 4, dtype=x.dtype, device=cuda)[1:1 + x.numel()].view(m, r, k).copy_(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, a, c, mult))
    assert aligned == (case != "unaligned")
    want = "tf32x3" if case in ("k1028-n4", "k2048-n68") else "simt"
    assert fl_mod.plan(x.dtype, k, n, aligned)[0] == want
    for g in (None, mult):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, g)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1
        _close(out, fused_linear_act_plain(x, w, a, c, g), 1e-4)


@pytest.mark.cuda
def test_fused_linear_act_tma_bodies_take_the_shared_memory_of_the_plan(cuda):
    """The shared memory of a tf32x3 block, as the kernel states it, is the
    module's (which the CPU tests hold under a block's limit)."""
    import ctypes

    fn = fl_mod._build.load("fused_linear").fused_linear_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert fn(0) == fl_mod.TF32X3_SMEM_BYTES <= fl_mod.SMEM_LIMIT
    assert fn(1) <= fl_mod.SMEM_LIMIT


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 160, 4096), (2, 9, 17), (1, 1, 8)], ids=["path", "ragged-N", "one-row"])
def test_fused_linear_act_small_k_body_takes_a_float32_gate(cuda, shape):
    """lin1 of the bf16 path: bf16 y_in and w1, the float32 features as the
    gate (the encoder's last BatchNorm returns float32, as flax's does)."""
    m, r, n = shape
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(13), m, r, 4, n))
    x, w = x.bfloat16(), w.bfloat16()
    launch_counts.clear()
    out = fused_linear_act(x, w, a, c, mult)
    torch.cuda.synchronize()
    assert launch_counts["fused_linear_act"] == 1 and out.dtype == torch.bfloat16
    _close(out, fused_linear_act_plain(x, w, a, c, mult), 1e-2)
    # above K = 32 the mma body takes the float32 gate too (F6)
    x2, w2, a2, c2, mult2 = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(14), m, r, 34, n))
    x2, w2 = x2.bfloat16(), w2.bfloat16()
    _close(fused_linear_act(x2, w2, a2, c2, mult2), fused_linear_act_plain(x2, w2, a2, c2, mult2), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [18, 20, 32, 64])
@pytest.mark.parametrize("shape", [(5, 640, 64), (5, 160, 4096), (2, 9, 17)], ids=["digits", "path", "ragged-N"])
def test_fused_linear_act_takes_a_float32_gate_above_k_16(cuda, shape, k):
    """F6: lin1 above 8 classes (K = 2C, 20 at the digits config's 10):
    bf16 y_in and w1 with the float32 features as the gate. K = 18-32 take
    the small_k body (lin1 up to 16 classes), K = 64 the wgmma body; each
    reads the gate in float32 and rounds once."""
    m, r, n = shape
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(18), m, r, k, n))
    x, w = x.bfloat16(), w.bfloat16()
    launch_counts.clear()
    out = fused_linear_act(x, w, a, c, mult)
    torch.cuda.synchronize()
    assert launch_counts["fused_linear_act"] == 1 and out.dtype == torch.bfloat16
    _close(out, fused_linear_act_plain(x, w, a, c, mult), 1e-2)


SMALL_K_CASES = {"path": (5, 160, 8, 4096), "ragged-N": (2, 9, 3, 17), "one-row": (1, 1, 1, 8),
                 "digits": (5, 640, 64, 64), "batch-1": (5, 20, 1, 4096), "evidence": (5, 1400, 70, 4096)}


def _small_k_inputs(cuda, rng, m, r, gate_rows, k, n, dtype):
    """lin1's inputs: y_in and w1 in ``dtype``, a and c, and the float32
    features as the gate a row an image (M, P, N) and repeated over the
    trial-major rows (M, R, N)."""
    x, w, a, c, _ = (torch.from_numpy(v).to(cuda) for v in layer_inputs(rng, m, r, k, n))
    f = torch.from_numpy(rng.standard_normal((m, gate_rows, n)).astype(np.float32)).to(cuda)
    rows = f.unsqueeze(1).expand(m, r // gate_rows, gate_rows, n).reshape(m, r, n).contiguous()
    return x.to(dtype), w.to(dtype), a, c, f, rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 16, 20, 32])
@pytest.mark.parametrize("case", list(SMALL_K_CASES))
def test_small_k_body_with_both_gate_layouts_matches_plain(cuda, dtype, k, case):
    """The small_k body (K <= 32) against its plain version at the path's
    shape, ragged N, one row, the digits' and the batch-1 and evidence
    shapes, with the gate a row an image and a row a row, and without one;
    the two gate layouts give the same bits, and a second launch too."""
    m, r, gate_rows, n = SMALL_K_CASES[case]
    x, w, a, c, f, rows = _small_k_inputs(cuda, np.random.default_rng(50), m, r, gate_rows, k, n, dtype)
    assert fl_mod.plan(dtype, k, n, True)[0] == "small_k"
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    outs = []
    for g in (f, rows, None):
        launch_counts.clear()
        out = fused_linear_act(x, w, a, c, g)
        torch.cuda.synchronize()
        assert launch_counts["fused_linear_act"] == 1 and out.dtype == dtype and out.shape == (m, r, n)
        _close(out, fused_linear_act_plain(x, w, a, c, g), tol)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], fused_linear_act(x, w, a, c, f))


@pytest.mark.cuda
def test_small_k_gate_rows_are_held_to_the_body_that_takes_them(cuda):
    """A gate of P < R rows goes to small_k only: another body raises, and so
    does a P that does not divide R; nothing falls back."""
    x, w, a, c, f, _ = _small_k_inputs(cuda, np.random.default_rng(52), 2, 12, 3, 40, 64, torch.bfloat16)
    assert fl_mod.plan(torch.bfloat16, 40, 64, True)[0] == "wgmma"
    with pytest.raises(ValueError, match="takes a gate a row"):
        fused_linear_act(x, w, a, c, f)
    x4, w4 = x[..., :4].contiguous(), w[:, :4].contiguous()
    with pytest.raises(ValueError, match="mult must be"):
        fused_linear_act(x4, w4, a, c, torch.zeros(2, 5, 64, device=cuda))


INT8_SHAPES = [(5, 160, 4096, 4096), (5, 20, 256, 200), (2, 23, 96, 80), (1, 70, 512, 136),
               (5, 161, 4096, 4096), (5, 1400, 4096, 4096)]


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


def _lin1_inputs(rng, m, r, k, ci, device, dtype):
    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    return (t(rng.standard_normal((m, r, k)), dtype), t(rng.random((m, r, ci)), dtype),
            t(rng.standard_normal((m, ci, k)) * 0.5, dtype), t(rng.uniform(0.5, 1.5, (m, k))),
            t(rng.standard_normal((m, k)) * 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [64, 4096, 8192])  # 8192: 512 threads, the most a block takes
@pytest.mark.parametrize("ci", [2, 4])
def test_int8_lin1_pass_codes_equal_plain(cuda, ci, k, dtype):
    """K5a's lin1 pass alone: the same int8 codes and max|h1| as its plain
    version, bit for bit (no tolerance: the same float32 arithmetic in the
    same order, IEEE division, round half to even)."""
    args = _lin1_inputs(np.random.default_rng(13), 2, 37, k, ci, cuda, dtype)
    launch_counts.clear()
    xq, xmax = int8_lin1(*args)
    torch.cuda.synchronize()
    assert launch_counts["int8_lin1"] == 1 and xq.dtype == torch.int8 and xmax.shape == (2, 37, 1)
    ref_q, ref_m = int8_lin1_plain(*args)
    assert torch.equal(xq, ref_q)
    assert torch.equal(xmax, ref_m)


@pytest.mark.cuda
def test_int8_lin1_pass_raises_on_a_k_it_does_not_take(cuda):
    """More than 512 threads a row (K > 8192): the wrappers raise before
    any launch instead of falling back."""
    k = 16 * 513
    f, y_in, w1, a1, c1 = _lin1_inputs(np.random.default_rng(14), 1, 2, k, 4, cuda, torch.bfloat16)
    w_q2 = torch.zeros(1, 8, k, dtype=torch.int8, device=cuda).transpose(1, 2)
    s2 = torch.ones(1, 8, device=cuda)
    launch_counts.clear()
    with pytest.raises(ValueError, match="lin1 pass takes K"):
        int8_lin1(f, y_in, w1, a1, c1)
    with pytest.raises(ValueError, match="lin1 pass takes K"):
        int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, s2)
    assert launch_counts["int8_lin1"] == 0 and launch_counts["int8_eps_fused_l12"] == 0


GEMM_SHAPES = [(2, r, 4096, 4096) for r in (1, 20, 160, 161, 1400)] + [
    (2, 20, 80, 200), (1, 161, 272, 136), (2, 23, 64, 136)]  # ragged N and K: K ends inside a 128-byte step



def _within_one_bf16_ulp(out, ref):
    """|out - ref| <= 2^-7 |ref|: at most one bf16 ulp apart (the int8 codes
    and int32 sums are exact; only a softplus rounding could differ)."""
    torch.testing.assert_close(out.float(), ref.float(), rtol=2**-7, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("zp", [False, True], ids=["symmetric", "zero-point"])
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=str)
def test_int8_gemm_through_k4_at_any_row_count_and_ragged_k_n(cuda, shape, zp):
    """The GEMM through K4 in bf16: one live slab, one row tile, split
    remainder tiles, and a ragged N and K, where K ends inside a step
    (kernels/int8_linear.py::gemm_plan)."""
    x, xmax, w_q, s, c, colsum, _, _ = int8_layer_inputs(np.random.default_rng(15), *shape, cuda,
                                                         torch.bfloat16, zp)
    launch_counts.clear()
    h, hmax = int8_linear_softplus(x, xmax, w_q, s, c, colsum)
    torch.cuda.synchronize()
    assert launch_counts["int8_linear_softplus"] == 1
    ref_h, ref_m = int8_linear_softplus_plain(x, xmax, w_q, s, c, colsum)
    _within_one_bf16_ulp(h, ref_h)
    _within_one_bf16_ulp(hmax, ref_m)
    assert torch.equal(hmax, h.float().amax(-1, keepdim=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=str)
def test_int8_eps_fused_gemm_at_any_row_count_and_ragged_k_n(cuda, shape):
    """K5a (lin1 pass + the GEMM's STORE epilogue) and K5b (the LIN4
    epilogue) in bf16 at the same shapes: h2 within one bf16 ulp, and lin4's
    sums within fp32 reordering (1e-4), the same bits at a second launch."""
    m, r, k, n = shape
    rng = np.random.default_rng(16)
    f, _, w_q2, s2, c2, _, y_in, w1 = int8_layer_inputs(rng, m, r, k, k, cuda, torch.bfloat16, False)
    a1, c1 = (torch.from_numpy(rng.uniform(0.5, 1.5, (m, k)).astype(np.float32)).to(cuda) for _ in range(2))
    launch_counts.clear()
    h2, hmax2 = int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, c2)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l12"] == 1
    ref_h2, ref_m2 = int8_eps_l12_plain(f, y_in, w1, a1, c1, w_q2, s2, c2)
    _within_one_bf16_ulp(h2, ref_h2)
    _within_one_bf16_ulp(hmax2, ref_m2)

    _, _, w_q3, s3, c3, cs3, _, _ = int8_layer_inputs(rng, m, r, k, n, cuda, torch.bfloat16, True)
    w4 = torch.from_numpy(rng.standard_normal((m, n, 2)).astype(np.float32) * n**-0.5).to(cuda, torch.bfloat16)
    out = int8_eps_l34(ref_h2, ref_m2, w_q3, s3, c3, cs3, w4)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l34"] == 1
    _close(out, int8_eps_l34_plain(ref_h2, ref_m2, w_q3, s3, c3, cs3, w4), 1e-4)
    assert torch.equal(out, int8_eps_l34(ref_h2, ref_m2, w_q3, s3, c3, cs3, w4))


@pytest.mark.cuda
def test_save_load_round_trip_on_the_card(cuda, tmp_path):
    """A bf16 predictor saved from the card and loaded back onto it predicts
    the same, bit for bit, on the same generator; loaded at ``serving`` with
    the K5 flags it runs K5a and K5b once a step."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch.models import init_random_

    gen = torch.Generator().manual_seed(4)
    geometry = dict(num_classes=2, num_members=2, vit_depth=2, img_size=32, patch_size=8, embed_dim=64,
                    num_heads=2, mlp_hidden_dims=(64, 32, 16))
    modules = []
    for build in (lambda **kw: L.SEViTGuidance(**geometry, **kw),
                  lambda **kw: L.ConditionalModel(2, 32 * 32 * 3, 64, 64, 2, 51, **kw)):
        cpu = build(device="cpu")
        init_random_(cpu, gen)
        modules.append(build(device=cuda, dtype=torch.bfloat16))  # BatchNorm and gates stay float32
        modules[-1].load_state_dict(cpu.state_dict())
    pred = L.Predictor(guidance=modules[0], model=modules[1], mc_trials=4, ddim_steps=0, device=cuda,
                       sched=L.DiffusionSchedule.create("linear", 50, device=cuda))
    images = np.random.default_rng(17).random((3, 32, 32, 3)).astype(np.float32)
    before = pred.predict(images, generator=torch.Generator(device=cuda).manual_seed(9))
    pred.save(str(tmp_path / "artifact"))
    loaded = L.Predictor.load(str(tmp_path / "artifact"), device=cuda)
    assert loaded.model.lin2.linear.weight.is_cuda and loaded.model.lin2.linear.weight.dtype == torch.bfloat16
    after = loaded.predict(images, generator=torch.Generator(device=cuda).manual_seed(9))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    fused = L.Predictor.load(str(tmp_path / "artifact"), preset="serving", use_int8_pallas=True,
                             pallas_fuse_ends=True, ddim_steps=5, device=cuda)
    fused.predict(images)  # captures the batch's graph (its eager warm-up launches too)
    launch_counts.clear()
    out = fused.predict(images)
    assert launch_counts["int8_eps_fused_l12"] == launch_counts["int8_eps_fused_l34"] == 5
    assert np.isfinite(out["probs"]).all()


# ---------------------------------------------------------------- serving program


def _op_cases_on(device):
    from ladine_tpu_torch.kernels.int8 import quantize_weight

    rng = np.random.default_rng(21)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)

    m, r, k, n = 2, 20, 64, 48
    bf16 = torch.bfloat16
    w_q, s = quantize_weight(t(m, k, n))
    colsum = w_q.sum(1, dtype=torch.int32).float()
    h = t(m, r, k).abs()
    qkv = t(2, 13, 3, 2, 32, dtype=bf16)
    return {
        "fused_linear_act": (t(m, r, k, dtype=bf16), t(m, k, n, dtype=bf16), t(m, n), t(m, n), None),
        "fused_linear_act-small-k": (t(m, r, 4, dtype=bf16), t(m, 4, n, dtype=bf16), t(m, n), t(m, n),
                                     t(m, r, n)),
        "flash_attention": (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
        "int8_linear_softplus": (h, h.amax(-1, keepdim=True), w_q, s, t(m, n), colsum),
        "int8_lin1": (t(m, r, k), t(m, r, 4), t(m, 4, k), t(m, k), t(m, k)),
        "int8_eps_l12": (t(m, r, k), t(m, r, 4), t(m, 4, k), t(m, k), t(m, k), w_q, s, t(m, n)),
        "int8_eps_l34": (h, h.amax(-1, keepdim=True), w_q, s, t(m, n), colsum, t(m, n, 2)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fused_linear_act", "fused_linear_act-small-k", "flash_attention",
                                  "int8_linear_softplus", "int8_lin1", "int8_eps_l12", "int8_eps_l34"])
def test_op_passes_opcheck_on_the_card(cuda, case):
    args = _op_cases_on(cuda)[case]
    result = torch.library.opcheck(getattr(torch.ops.ladine_tpu_torch, case.split("-")[0]), args)
    assert set(result.values()) == {"SUCCESS"}, result


SMALL = dict(num_classes=2, num_members=2, vit_depth=2, img_size=32, patch_size=8, embed_dim=64,
             num_heads=2, mlp_hidden_dims=(64, 32, 16))
PROGRAMS = {
    "parity-ddim5": dict(ddim_steps=5, use_int8=False),
    "serving": dict(ddim_steps=5, ddim_eta=1.0, use_int8=True),
    "fast": dict(ddim_steps=5, ddim_eta=1.0, use_int8=True, use_int8_encode=True),
    "serving-k4": dict(ddim_steps=5, ddim_eta=1.0, use_int8=True, use_int8_pallas=True),
    "serving-k5": dict(ddim_steps=5, ddim_eta=1.0, use_int8=True, use_int8_pallas=True, pallas_fuse_ends=True),
}


def _small_predictor(device, **kw):
    """A small bf16 predictor on the card (BatchNorm and gates float32)."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch.models import init_random_

    gen = torch.Generator().manual_seed(4)
    modules = []
    for build in (lambda **a: L.SEViTGuidance(**SMALL, **a),
                  lambda **a: L.ConditionalModel(2, 32 * 32 * 3, 64, 64, 2, 51, **a)):
        cpu = init_random_(build(device="cpu"), gen)
        modules.append(build(device=device, dtype=torch.bfloat16))
        modules[-1].load_state_dict(cpu.state_dict())
    return L.Predictor(guidance=modules[0], model=modules[1], mc_trials=4, device=device,
                       sched=L.DiffusionSchedule.create("linear", 50, device=device), **kw)


def _assert_request_equal(got, want):
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _eager(pred, images, noise):
    with torch.inference_mode():
        outs = pred._program(torch.as_tensor(images, device=pred.device), noise.to(pred.device))
    return dict(zip(("probs", "majority_vote", "piw", "mc_variance"), (o.cpu().numpy() for o in outs)))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_graph_replay_equals_the_eager_program(cuda, name, batch):
    pred = _small_predictor(cuda, **PROGRAMS[name])
    images = np.random.default_rng(batch).random((batch, 32, 32, 3)).astype(np.float32)
    noise = torch.randn(pred._program.noise_shape(batch), generator=torch.Generator().manual_seed(5))
    eager = _eager(pred, images, noise)
    for _ in range(2):  # the capture's call, then a replay
        _assert_request_equal(pred.predict(images, noise=noise), eager)


@pytest.mark.cuda
def test_replays_count_the_captured_launches(cuda):
    pred = _small_predictor(cuda, **PROGRAMS["serving-k5"])
    images = np.random.default_rng(2).random((3, 32, 32, 3)).astype(np.float32)
    launch_counts.clear()
    pred.predict(images)  # the eager warm-up launches; the capture launches nothing
    warm = dict(launch_counts)
    captured = pred._graphs.launches(torch.as_tensor(images), torch.zeros(pred._program.noise_shape(3)))
    assert captured == {"flash_attention": 2, "int8_eps_fused_l12": 5, "int8_eps_fused_l34": 5}
    assert warm == {k: 2 * v for k, v in captured.items()}  # warm-up + the first replay
    launch_counts.clear()
    for _ in range(4):
        pred.predict(images)
    assert dict(launch_counts) == {k: 4 * v for k, v in captured.items()}


@pytest.mark.cuda
def test_concurrent_callers_of_one_graph_get_their_own_rows(cuda):
    import threading

    pred = _small_predictor(cuda, **PROGRAMS["serving-k4"])
    rng = np.random.default_rng(8)
    requests = [rng.random((3, 32, 32, 3)).astype(np.float32) for _ in range(6)]
    noises = [torch.randn(pred._program.noise_shape(3), generator=torch.Generator().manual_seed(i))
              for i in range(6)]
    want = [_eager(pred, r, z) for r, z in zip(requests, noises)]
    got = [None] * 6

    def caller(i):
        for _ in range(3):
            got[i] = pred.predict(requests[i], noise=noises[i])

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        _assert_request_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["parity-ddim5", "serving-k5"])
def test_bundle_round_trip_on_the_card(cuda, tmp_path, name):
    from ladine_tpu_torch.infer import ExportedPredictor

    pred = _small_predictor(cuda, **PROGRAMS[name])
    pred.export_serving(str(tmp_path / "bundle"), batch_sizes=(1, 3))
    served = ExportedPredictor.load(str(tmp_path / "bundle"), device=cuda)
    assert served.weights["sched_betas"].is_cuda
    for b in (1, 3):
        images = np.random.default_rng(b).random((b, 32, 32, 3)).astype(np.float32)
        gen = lambda: torch.Generator(device=cuda).manual_seed(3)  # noqa: E731
        _assert_request_equal(served.predict(images, generator=gen()), pred.predict(images, generator=gen()))
    with pytest.raises(ValueError, match="exported on cuda and runs there only"):
        ExportedPredictor.load(str(tmp_path / "bundle"), device="cpu")


# ---------------------------------------------------------------- evaluation


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)], ids=["fp32", "bf16"])
def test_flash_attention_gradient_with_the_kernel_forward(cuda, dtype, tol):
    qkv, _ = qkv_views(np.random.default_rng(30), 2, 197, 12, 64)
    qkv = qkv.to(cuda, dtype).requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    d_out = torch.randn(2, 197, 12, 64, generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda).to(dtype)
    launch_counts.clear()
    out = flash_attention(q, k, v)
    assert launch_counts["flash_attention"] == 1 and out.requires_grad
    (got,) = torch.autograd.grad(out, qkv, d_out)
    (want,) = torch.autograd.grad(flash_attention_plain(q, k, v), qkv, d_out)
    assert launch_counts["flash_attention"] == 1  # the backward launches no forward kernel
    _close(got, want, tol)


@pytest.mark.cuda
def test_flash_attention_opcheck_with_grad_on_the_card(cuda):
    qkv, _ = qkv_views(np.random.default_rng(31), 2, 13, 2, 32)
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_(True)
    result = torch.library.opcheck(torch.ops.ladine_tpu_torch.flash_attention,
                                   (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["parity-ddim5", "serving-k5"])
def test_graphed_eval_batch_equals_the_eager_one(cuda, name):
    """A batch of the evaluator (every corruption, PGD on the ViT) through
    the CUDA graph of its batch shape equals the eager program on the same
    attacked images and draws; tail batches get graphs of their own."""
    from ladine_tpu_torch.infer import EvalConfig, make_eval_pipeline

    pred = _small_predictor(cuda)
    flags = {k: v for k, v in PROGRAMS[name].items() if k != "use_int8"}
    cfg = EvalConfig(mc_trials=4, temperature=0.2, noise_std=0.05, low_resolution=2, brightness=0.1,
                     contrast=0.8, cover=(0.05, 2), crop=0.1, attack_name="PGD", **flags)
    pipe = make_eval_pipeline(pred.guidance, pred.model, pred.sched, cfg, device=cuda)
    rng = np.random.default_rng(32)
    for b in (3, 2):
        images, labels = rng.random((b, 32, 32, 3)).astype(np.float32), rng.integers(0, 2, b)
        x, noise = pipe.prepare(images, labels, torch.Generator().manual_seed(b))
        eager = pipe.sample(x, noise, eager=True)
        for _ in range(2):  # the capture's call, then a replay
            graphed = pipe.sample(x, noise)
            assert torch.equal(graphed, eager)
        assert graphed.shape == (2, 4, b, 2) and torch.isfinite(graphed).all()


# ------------------------------------------------ guidance-free eps, backbones


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 160, 4096), (2, 9, 17)], ids=["path", "ragged-N"])
def test_fused_linear_act_small_k_at_k_2_takes_a_float32_gate(cuda, shape):
    """lin1 of a guidance-free member (``--no_cat_f_phi``): y_t alone, K = 2,
    bf16 rows of 4 bytes, the float32 features as the gate."""
    m, r, n = shape
    x, w, a, c, mult = (torch.from_numpy(v).to(cuda) for v in layer_inputs(np.random.default_rng(15), m, r, 2, n))
    x, w = x.bfloat16(), w.bfloat16()
    launch_counts.clear()
    out = fused_linear_act(x, w, a, c, mult)
    torch.cuda.synchronize()
    assert launch_counts["fused_linear_act"] == 1 and out.dtype == torch.bfloat16
    _close(out, fused_linear_act_plain(x, w, a, c, mult), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_eps_l12_at_ci_2_matches_plain(cuda, dtype):
    """K5a of a guidance-free member: the lin1 pass over Ci = 2, then lin2,
    at the path's shape; the lin1 codes equal the plain version's."""
    m, r, k = 5, 160, 4096
    rng = np.random.default_rng(16)
    f, _, w_q2, s2, c2, _, _, _ = int8_layer_inputs(rng, m, r, k, k, cuda, dtype, False)
    y_in = torch.from_numpy(rng.standard_normal((m, r, 2)).astype(np.float32)).to(cuda, dtype)
    w1 = torch.from_numpy(rng.standard_normal((m, 2, k)).astype(np.float32) * 0.5).to(cuda, dtype)
    a1, c1 = (torch.from_numpy(rng.uniform(0.5, 1.5, (m, k)).astype(np.float32)).to(cuda) for _ in range(2))
    codes, xmax = int8_lin1(f, y_in, w1, a1, c1)
    want_codes, want_max = int8_lin1_plain(f, y_in, w1, a1, c1)
    torch.cuda.synchronize()
    assert torch.equal(codes, want_codes) and torch.equal(xmax, want_max)
    launch_counts.clear()
    h2, hmax2 = int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, c2)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l12"] == 1
    ref_h2, ref_m2 = int8_eps_l12_plain(f, y_in, w1, a1, c1, w_q2, s2, c2)
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    _close(h2, ref_h2, tol)
    _close(hmax2, ref_m2, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 640, 64), (5, 160, 4096)], ids=["digits", "path"])
def test_int8_eps_l12_at_ci_20_matches_plain(cuda, shape, dtype):
    """K5a at 10 classes: the lin1 pass over Ci = 2C = 20 (codes equal to
    the plain version's), then lin2."""
    m, r, k = shape
    rng = np.random.default_rng(19)
    f, _, w_q2, s2, c2, _, _, _ = int8_layer_inputs(rng, m, r, k, k, cuda, dtype, False)
    y_in = torch.from_numpy(rng.random((m, r, 20)).astype(np.float32)).to(cuda, dtype)
    w1 = torch.from_numpy(rng.standard_normal((m, 20, k)).astype(np.float32) * 0.5).to(cuda, dtype)
    a1, c1 = (torch.from_numpy(rng.uniform(0.5, 1.5, (m, k)).astype(np.float32)).to(cuda) for _ in range(2))
    codes, xmax = int8_lin1(f, y_in, w1, a1, c1)
    want_codes, want_max = int8_lin1_plain(f, y_in, w1, a1, c1)
    torch.cuda.synchronize()
    assert torch.equal(codes, want_codes) and torch.equal(xmax, want_max)
    launch_counts.clear()
    h2, hmax2 = int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, c2)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l12"] == 1
    ref_h2, ref_m2 = int8_eps_l12_plain(f, y_in, w1, a1, c1, w_q2, s2, c2)
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    _close(h2, ref_h2, tol)
    _close(hmax2, ref_m2, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("classes", [3, 10])
@pytest.mark.parametrize("shape", [(5, 640, 64, 64), (5, 160, 4096, 4096)], ids=["digits", "path"])
def test_int8_eps_l34_at_more_than_two_classes(cuda, shape, classes):
    """K5b's lin4 epilogue above its 2 classes a pass (C = 10 takes 5
    passes), on float32 rows as ``serving`` stores them (1e-4: lin4 sums in
    another order than the plain product). The sum is in a fixed order at
    one column tile (the digits shape) and at 32 (the path's): calls agree
    bit for bit."""
    m, r, k, n = shape
    rng = np.random.default_rng(20)
    h2, hmax2, w_q3, s3, c3, cs3, _, _ = int8_layer_inputs(rng, m, r, k, n, cuda, torch.float32, True)
    w4 = torch.from_numpy(rng.standard_normal((m, n, classes)).astype(np.float32) * n**-0.5).to(cuda)
    launch_counts.clear()
    out = int8_eps_l34(h2, hmax2, w_q3, s3, c3, cs3, w4)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l34"] == 1 and out.shape == (m, r, classes)
    _close(out, int8_eps_l34_plain(h2, hmax2, w_q3, s3, c3, cs3, w4), 1e-4)
    assert all(torch.equal(out, int8_eps_l34(h2, hmax2, w_q3, s3, c3, cs3, w4)) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(30, 198, 12, 64), (30, 197, 16, 48)], ids=["deit-distilled", "convit-base"])
def test_flash_attention_fp32_forward_and_vjp_at_the_backbones_shapes(cuda, shape):
    """The stage-1 backbones train in float32: DeiT-distilled's 198 tokens
    (cls and distillation tokens) and ConViT-base's MHSA tail of 16 heads of
    D = 48, at batch 30; forward and gradient to 1e-4."""
    b, n, h, d = shape
    qkv, _ = qkv_views(np.random.default_rng(32), b, n, h, d)
    qkv = qkv.to(cuda).requires_grad_(True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    d_out = torch.randn(b, n, h, d, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    launch_counts.clear()
    out = flash_attention(q, k, v)
    assert launch_counts["flash_attention"] == 1
    _close(out, flash_attention_plain(q, k, v), 1e-4)
    (got,) = torch.autograd.grad(out, qkv, d_out)
    (want,) = torch.autograd.grad(flash_attention_plain(q, k, v), qkv, d_out)
    _close(got, want, 1e-4)


@pytest.mark.cuda
def test_capture_after_a_dropped_predictor_in_a_reference_cycle(cuda):
    """A predictor whose CUDA graph is garbage only to the cycle collector
    (dropped while in a reference cycle) is collected before the next
    capture, not inside it: freeing a graph's memory voids a capture."""
    import gc

    images = np.random.default_rng(3).random((3, 32, 32, 3)).astype(np.float32)
    for _ in range(3):
        old = _small_predictor(cuda, **PROGRAMS["serving-k5"])
        old.predict(images)  # captured
        old.cycle = old  # reachable only through itself once dropped
        del old
        gc.collect(0)  # only the youngest generation: the cycle may survive to the capture below
        new = _small_predictor(cuda, **PROGRAMS["serving-k5"])
        out = new.predict(images)
        assert np.isfinite(out["probs"]).all()


@pytest.mark.cuda
def test_parity_request_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """A (member 1, data 2) mesh of two ``gloo`` ranks on the one card, each
    serving 2 of the batch's 4 rows through its own CUDA graph: the outputs
    equal the one-process request of the same seed (votes exactly; probs,
    PIW and variance within rtol 1e-4, atol 1e-5), and each rank's replay
    launches K1 three times a step and K3 once a ViT block it runs."""
    import torch_mesh as TM

    one = TM.cuda_parity_case()  # builds the kernels before the ranks start
    got = TM.run_world(TM.cuda_parity_world, 2, tmp_path)
    np.testing.assert_array_equal(got["out"]["majority_vote"], one["out"]["majority_vote"])
    for k in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(got["out"][k], one["out"][k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert got["launches"] == one["launches"]
    assert got["launches"]["fused_linear_act"] == 3 * TM.T_STEPS


def _qkv_on_card(cuda, rng, b, n, h, d, dtype):
    """q, k, v as the strided slices of one fused qkv projection on the card."""
    qkv, _ = qkv_views(rng, b, n, h, d)
    qkv = qkv.to(cuda, dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 48, 64])
@pytest.mark.parametrize("n", [1, 64, 65, 196, 197, 198, 256, 300])
def test_flash_attention_bf16_bodies_by_the_plan(cuda, n, d):
    """bf16 at D = 64 (and ConViT's 48, zero-padded to 64 by TMA) up to 256
    keys runs the ``wgmma`` body; D = 12 (the digits ViT's 24-byte heads,
    no padded copies) and N = 300 the ``mma`` body: each against the plain
    version (1e-2), and a second launch bit for bit. The plan's shared
    memory is the kernel's own count."""
    q, k, v = _qkv_on_card(cuda, np.random.default_rng(n + d), 3, n, 4, d, torch.bfloat16)
    _, vec, tma = attn_mod._layout(q, k, v)
    p = attn_mod.attention_plan(3, n, 4, d, torch.bfloat16, vec, tma)
    assert p.route == ("wgmma" if d % 8 == 0 and n <= 256 else "mma")
    lib = attn_mod._lib()
    assert lib.flash_attention_smem_bytes(attn_mod.ROUTES[p.route], n, p.dp, p.keys, p.rows, p.tpu, 0) == p.smem_bytes
    launch_counts.clear()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1 and out.shape == (3, n, 4, d) and out.is_contiguous()
    _close(out, flash_attention_plain(q, k, v), 1e-2)
    assert torch.equal(out, flash_attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 70])
def test_flash_attention_wgmma_body_at_the_serving_batches(cuda, b):
    """The ViT's shape at batch 8 (query tiles split across 132 blocks) and
    at the evidence batch 70 (1680 units on 132 persistent blocks)."""
    q, k, v = _qkv_on_card(cuda, np.random.default_rng(b), b, 197, 12, 64, torch.bfloat16)
    assert attn_mod.attention_plan(b, 197, 12, 64, torch.bfloat16).grid == 132
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    _close(out, flash_attention_plain(q, k, v), 2e-2)
    assert torch.equal(out, flash_attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 48, 64])
@pytest.mark.parametrize("n", [16, 197, 198])
def test_flash_attention_fp32_register_tiled_body(cuda, n, d):
    """The ``simt`` body at the digits', ConViT's and ViT's head widths:
    1e-4 against the plain version, and a second launch bit for bit."""
    q, k, v = _qkv_on_card(cuda, np.random.default_rng(3 * n + d), 4, n, 3, d, torch.float32)
    assert attn_mod.attention_plan(4, n, 3, d, torch.float32).route == "simt"
    launch_counts.clear()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1
    _close(out, flash_attention_plain(q, k, v), 1e-4)
    assert torch.equal(out, flash_attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 375])
def test_flash_attention_fp32_loads_v_late_past_227_kb(cuda, n):
    """Past 263 keys at D = 64, K, V, the Q tile and the scores pass a
    block's shared memory: V comes after S, into K's place."""
    q, k, v = _qkv_on_card(cuda, np.random.default_rng(n), 2, n, 2, 64, torch.float32)
    p = attn_mod.attention_plan(2, n, 2, 64, torch.float32)
    assert p.route == "simt" and p.late_v
    assert attn_mod._lib().flash_attention_smem_bytes(2, n, 64, n, p.rows, 1, 1) == p.smem_bytes
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    _close(out, flash_attention_plain(q, k, v), 1e-4)


@pytest.mark.cuda
def test_int8_eps_l34_full_width_is_bit_reproducible(cuda):
    """D5: K5b at (5, 160, 4096) -> 4096 with lin4 N = 2, 32 column tiles:
    the tiles' sums meet in a fixed order, so launches agree bit for bit,
    also inside a CUDA graph (the last block resets its count)."""
    m, r, k, n = 5, 160, 4096, 4096
    rng = np.random.default_rng(40)
    h2, hmax2, w_q3, s3, c3, cs3, _, _ = int8_layer_inputs(rng, m, r, k, n, cuda, torch.bfloat16, True)
    w4 = torch.from_numpy(rng.standard_normal((m, n, 2)).astype(np.float32) * n**-0.5).to(cuda, torch.bfloat16)
    args = (h2, hmax2, w_q3, s3, c3, cs3, w4)
    first = int8_eps_l34(*args)
    _close(first, int8_eps_l34_plain(*args), 1e-4)
    assert all(torch.equal(first, int8_eps_l34(*args)) for _ in range(4))
    graph = torch.cuda.CUDAGraph()
    int8_eps_l34(*args)  # warm-up on the current stream
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = int8_eps_l34(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


REPEAT_SHAPES = [(5, 160, 4096, 4096), (5, 1400, 4096, 4096), (2, 23, 96, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REPEAT_SHAPES, ids=str)
def test_int8_store_kernels_repeat_bit_for_bit(cuda, shape, dtype):
    """K4 (both schemes) and K5a: the int32 sums are exact whatever the
    split (kernels/int8_linear.py::gemm_plan), the epilogue is element for
    element, and the row max an order-free atomicMax: a second launch gives
    the same h and hmax, bit for bit."""
    m, r, k, n = shape
    rng = np.random.default_rng(41)
    for zp in (False, True):
        x, xmax, w_q, s, c, colsum, y_in, w1 = int8_layer_inputs(rng, m, r, k, n, cuda, dtype, zp)
        first = int8_linear_softplus(x, xmax, w_q, s, c, colsum)
        again = int8_linear_softplus(x, xmax, w_q, s, c, colsum)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    f, _, w_q2, s2, c2, _, y_in, w1 = int8_layer_inputs(rng, m, r, k, k, cuda, dtype, False)
    a1, c1 = (torch.from_numpy(rng.uniform(0.5, 1.5, (m, k)).astype(np.float32)).to(cuda) for _ in range(2))
    launch_counts.clear()
    first = int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, c2)
    again = int8_eps_l12(f, y_in, w1, a1, c1, w_q2, s2, c2)
    torch.cuda.synchronize()
    assert launch_counts["int8_eps_fused_l12"] == 2
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REPEAT_SHAPES, ids=str)
def test_int8_eps_l34_repeats_and_replays_bit_for_bit(cuda, shape, dtype):
    """K5b: a second launch and a CUDA-graph replay give the same bits as
    the eager launch (rtol 0): the column tiles' lin4 sums meet in a fixed
    order at every split of the schedule, and the counts reset."""
    m, r, k, n = shape
    rng = np.random.default_rng(42)
    h2, hmax2, w_q3, s3, c3, cs3, _, _ = int8_layer_inputs(rng, m, r, k, n, cuda, dtype, True)
    w4 = torch.from_numpy(rng.standard_normal((m, n, 2)).astype(np.float32) * n**-0.5).to(cuda, dtype)
    args = (h2, hmax2, w_q3, s3, c3, cs3, w4)
    first = int8_eps_l34(*args)
    _close(first, int8_eps_l34_plain(*args), 1e-4 if dtype == torch.float32 else 1e-2)
    assert torch.equal(first, int8_eps_l34(*args))
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = int8_eps_l34(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, first, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [16, 1, 8])
def test_int8_gemm_takes_the_body_the_plan_names_at_any_weight_base(cuda, offset):
    """A weight whose base is 16-byte aligned but not at its storage's start
    runs the one body (TMA + s8 wgmma) and equals the plain version; a
    base off 16 bytes is refused by every int8 wrapper before any launch
    (kernels/int8_linear.py::check_weight), nothing falls back."""
    from ladine_tpu_torch.kernels import int8_linear as k4

    m, r, k, n = 2, 37, 4096, 256
    rng = np.random.default_rng(43)
    x, xmax, w_q, s, c, colsum, y_in, w1 = int8_layer_inputs(rng, m, r, k, n, cuda, torch.bfloat16, True)
    storage = torch.zeros(offset + w_q.numel() + 16, dtype=torch.int8, device=cuda)
    start = (16 - storage.data_ptr() % 16) % 16 + offset
    moved = storage[start:start + w_q.numel()].view(m, n, k).transpose(1, 2)
    moved.copy_(w_q)
    assert moved.stride() == w_q.stride() and moved.data_ptr() % 16 == offset % 16
    a1, c1 = (torch.from_numpy(rng.uniform(0.5, 1.5, (m, k)).astype(np.float32)).to(cuda) for _ in range(2))
    w4 = torch.zeros(m, n, 2, dtype=torch.bfloat16, device=cuda)
    launch_counts.clear()
    if offset % 16 == 0:
        assert k4.BODY == "wgmma" and k4.gemm_plan(m, r, k, n).grid == 4
        h, hmax = int8_linear_softplus(x, xmax, moved, s, c, colsum)
        torch.cuda.synchronize()
        assert launch_counts["int8_linear_softplus"] == 1
        ref_h, ref_m = int8_linear_softplus_plain(x, xmax, w_q, s, c, colsum)
        _within_one_bf16_ulp(h, ref_h)
        assert all(torch.equal(a, b) for a, b in zip((h, hmax), int8_linear_softplus(x, xmax, w_q, s, c, colsum)))
        return
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_linear_softplus(x, xmax, moved, s, c, colsum)
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_eps_l12(x, y_in, w1, a1, c1, moved, s, c)
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_eps_l34(x, xmax, moved, s, c, colsum, w4)
    assert sum(launch_counts.values()) == 0

