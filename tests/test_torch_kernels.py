"""The port's kernel wrappers against ladine_tpu's kernels on the CPU.

On the CPU each wrapper runs its plain version; the JAX functions run their
non-TPU branch, as tests/test_kernels.py runs them. Both sides compute in
float32 and differ only in summation order: rtol 1e-5 / atol 1e-6 for one
layer, 1e-4 / 1e-5 through the three-layer eps.

The kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.kernels import flash_attention as jax_flash_attention
from ladine_tpu.kernels import fused_eps as jax_fused_eps
from ladine_tpu.kernels import fused_linear_act as jax_fused_linear_act
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu_torch.kernels import (
    flash_attention,
    fused_eps,
    fused_linear_act,
    fused_linear_act_plain,
)
from ladine_tpu_torch.kernels import attention as attn_mod
from ladine_tpu_torch.kernels import fused_linear as fl_mod
from ladine_tpu_torch.models import ConditionalModel
from ladine_tpu_torch.utils import members_from_flax
from torch_inputs import layer_inputs, qkv_views
from torch_parity import j2t, jax_members, t2n


@pytest.mark.parametrize("shape", [(1, 9, 24, 17), (3, 20, 4, 40), (2, 33, 70, 65)])
@pytest.mark.parametrize("with_mult", [False, True])
def test_fused_linear_act_matches_jax(shape, with_mult):
    """Member-stacked (M, R, K) form, ragged R, K and N, against the JAX
    function applied member by member."""
    x, w, a, c, mult = layer_inputs(np.random.default_rng(0), *shape)
    out = fused_linear_act(j2t(x), j2t(w), j2t(a), j2t(c), j2t(mult) if with_mult else None)
    assert out.shape == shape[:2] + shape[3:] and out.dtype == torch.float32
    for i in range(shape[0]):
        ref = jax_fused_linear_act(jnp.asarray(x[i]), jnp.asarray(w[i]), jnp.asarray(a[i]),
                                   jnp.asarray(c[i]), jnp.asarray(mult[i]) if with_mult else None)
        np.testing.assert_allclose(t2n(out[i]), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_linear_act_plain_keeps_input_dtype():
    x, w, a, c, mult = layer_inputs(np.random.default_rng(1), 2, 5, 8, 6)
    out = fused_linear_act_plain(j2t(x).bfloat16(), j2t(w).bfloat16(), j2t(a), j2t(c))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(w=lambda w: w.double()), "must have x's dtype"),
        (dict(a=lambda a: a.double()), "a and c must be float32"),
        (dict(w=lambda w: w[:, :-1]), "disagree"),
        (dict(mult=lambda m: m[:, :-1]), "mult must be"),
        (dict(x=lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)), "contiguous"),
    ],
)
def test_fused_linear_act_rejects_what_the_kernel_cannot_take(bad, match):
    args = dict(zip("x w a c mult".split(), map(j2t, layer_inputs(np.random.default_rng(2), 2, 6, 8, 5))))
    for name, change in bad.items():
        args[name] = change(args[name])
    with pytest.raises((TypeError, ValueError), match=match):
        fl_mod._check(args["x"], args["w"], args["a"], args["c"], args["mult"])


def _eps_setup(members=3):
    jmodel = JaxConditionalModel(data_dim=48, feature_dim=16, hidden_dim=16, y_dim=2, n_steps=11)
    stacked = jax_members(jmodel, members, 48)
    model = ConditionalModel(members, 48, 16, 16, 2, 11, device="cpu")
    model.load_state_dict(members_from_flax(stacked))
    return jmodel, stacked, model


def _member(stacked, i):
    return jax.tree.map(lambda v: jnp.asarray(v[i]), stacked)


def test_fused_eps_matches_jax_fused_eps_and_flax_eps():
    jmodel, stacked, model = _eps_setup()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    y = rng.standard_normal((3, 5, 2)).astype(np.float32)
    yhat = rng.dirichlet([1, 1], size=(3, 5)).astype(np.float32)
    f_members = [np.asarray(jmodel.apply(_member(stacked, i), jnp.asarray(x), method="encode"))
                 for i in range(3)]
    f = j2t(np.stack(f_members))
    for t in (0, 5, 10):
        out = fused_eps(model, f, j2t(y), t, j2t(yhat))
        assert out.shape == (3, 5, 2)
        for i in range(3):
            v = _member(stacked, i)
            args = (jnp.asarray(f_members[i]), jnp.asarray(y[i]), jnp.asarray(t), jnp.asarray(yhat[i]))
            np.testing.assert_allclose(t2n(out[i]), np.asarray(jax_fused_eps(v, *args)),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(t2n(out[i]), np.asarray(jmodel.apply(v, *args, method="eps")),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda qkv: (qkv[:, :, 0].half(),) * 3, "float32 or bfloat16"),
        (lambda qkv: (qkv[:, :, 0], qkv[:, :, 1].contiguous(), qkv[:, :, 2]), "share strides"),
        (lambda qkv: (qkv[:, :, 0, :, :6],) * 3, "multiples of 16 bytes"),
        (lambda qkv: (qkv.flatten()[1:161].view(2, 5, 2, 8),) * 3, "multiples of 16 bytes"),
        (lambda qkv: (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :-1, 2]), "share one"),
    ],
    ids=["dtype", "strides", "ragged-D", "misaligned-pointer", "shape"],
)
def test_flash_attention_rejects_what_the_kernel_cannot_take(make, match):
    qkv, _ = qkv_views(np.random.default_rng(5), 2, 5, 2, 8)
    with pytest.raises((TypeError, ValueError), match=match):
        attn_mod._check(*make(qkv))
    b, n, h, d = attn_mod._check(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    assert (b, n, h, d) == (2, 5, 2, 8)


def test_flash_attention_matches_jax():
    qkv, (q, k, v) = qkv_views(np.random.default_rng(4), 2, 13, 4, 16)
    out = flash_attention(q, k, v)
    ref = jax_flash_attention(*(jnp.asarray(qkv[:, :, i].numpy()) for i in range(3)))
    assert out.shape == (2, 13, 4, 16)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "dtype, k, n, aligned, want",
    [
        (BF16, 4, 4096, True, ("small_k", True)),  # lin1 on the path
        (BF16, 4096, 4096, True, ("mma", True)),  # lin2 / lin3 on the path
        (F32, 4, 4096, True, ("small_k", True)),  # lin1 of the fp32 predictor
        (F32, 4096, 4096, True, ("simt", True)),
        (BF16, 2, 4096, True, ("small_k", True)),
        (BF16, 16, 4096, True, ("small_k", True)),
        (BF16, 17, 4096, True, ("mma", False)),  # K not a multiple of 8
        (F32, 16, 17, True, ("small_k", False)),  # N not a multiple of 8
        (BF16, 4096, 4096, False, ("mma", False)),  # a pointer off 16 bytes
        (BF16, 4, 4096, False, ("small_k", False)),
        (BF16, 24, 17, True, ("mma", False)),
        (F32, 24, 17, True, ("simt", False)),
        (BF16, 256, 200, True, ("mma", True)),
        (F32, 256, 200, True, ("simt", True)),
        (BF16, 72, 64, True, ("mma", True)),
        (F32, 40, 12, True, ("simt", True)),  # fp32's vector is 4 wide
    ],
)
def test_fused_linear_act_plan_is_a_function_of_shape_dtype_and_alignment(dtype, k, n, aligned, want):
    assert fl_mod.plan(dtype, k, n, aligned) == want


@pytest.mark.parametrize("r", [1, 20, 160, 161, 1400])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fused_linear_act_plan_ignores_the_row_count(r, dtype):
    """Rows only add row tiles: lin2/lin3 take the GEMM body at any R, and
    lin1 the small_k body, through the wrapper's own check of the shapes."""
    x, w, a, c, mult = (torch.zeros(s, dtype=dtype if i in (0, 1, 4) else F32)
                        for i, s in enumerate([(5, r, 4096), (5, 4096, 8), (5, 8), (5, 8), (5, r, 8)]))
    m, r_, k, n = fl_mod._check(x, w, a, c, mult)
    assert (m, r_) == (5, r)
    assert fl_mod.plan(dtype, k, n, True) == ("mma" if dtype == BF16 else "simt", True)
    assert fl_mod.plan(dtype, 4, n, True) == ("small_k", True)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_flash_attention_body_bf16_takes_d_multiple_of_16(d):
    assert attn_mod.body(BF16, d) == "mma"


@pytest.mark.parametrize("d", [4, 8, 24, 64, 100])
def test_flash_attention_body_f32_is_scalar_at_any_d(d):
    assert attn_mod.body(F32, d) == "scalar"


@pytest.mark.parametrize("d", [8, 24, 40, 136, 144])
def test_flash_attention_body_bf16_raises_off_the_tensor_core_shapes(d):
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        attn_mod.body(BF16, d)


def test_flash_attention_check_raises_on_bf16_d_24():
    """D = 24 in bf16 is whole 16-byte vectors but no k16 step: _check
    refuses it, while fp32 D = 8 (above) is taken."""
    qkv, _ = qkv_views(np.random.default_rng(5), 2, 5, 2, 24)
    qkv = qkv.bfloat16()
    with pytest.raises(ValueError, match="multiple of 16"):
        attn_mod._check(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    qkv, _ = qkv_views(np.random.default_rng(5), 2, 5, 2, 32)
    assert attn_mod._check(*(qkv.bfloat16()[:, :, i] for i in range(3))) == (2, 5, 2, 32)
