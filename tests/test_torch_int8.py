"""The port's int8 path against ladine_tpu's on the CPU: the quantizers
(bit-equal), the int8 matmul, eps, encoder and mapping heads, and the plain
versions of the K4/K5 kernels against the Pallas kernels run in interpret
mode (as tests/test_int8_pallas.py runs them).

Everything runs in float32 on the same numpy inputs. The int8 codes are
picked by the same IEEE division and round-half-to-even on both sides, so
they agree; what differs is the order of float32 sums in the float layers
(~1e-7 relative). Such a difference can move a value across a rounding
boundary and flip one int8 code, which moves its output by about one
quantization step times its weight: 1e-4 relative and absolute covers one
such flip at these widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.kernels import int8 as jint8
from ladine_tpu.kernels import int8_pallas as jpallas
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu_torch.kernels import int8 as tint8
from ladine_tpu_torch.kernels.int8_eps_fused import int8_eps_pallas_fused
from ladine_tpu_torch.kernels.int8_linear import int8_eps_pallas, int8_linear_softplus_plain
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from torch_parity import j2t, jax_members, t2n

TOL = dict(rtol=1e-4, atol=1e-4)  # one int8 code flip at a rounding boundary (module docstring)
M, D, FEAT, T = 3, 24, 32, 11


def _member(stacked, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), stacked)


@pytest.fixture(scope="module")
def members():
    jm = JaxConditionalModel(data_dim=D, feature_dim=FEAT, hidden_dim=FEAT, y_dim=2, n_steps=T)
    stacked = jax_members(jm, M, D)
    m = ConditionalModel(M, D, FEAT, FEAT, 2, T, device="cpu")
    m.load_state_dict(members_from_flax(stacked))
    return jm, stacked, m


@pytest.fixture(scope="module")
def eps_inputs():
    rng = np.random.default_rng(3)
    r = 7
    f = rng.standard_normal((M, r, FEAT)).astype(np.float32)
    y = rng.standard_normal((M, r, 2)).astype(np.float32)
    yhat = rng.dirichlet([1.0, 1.0], size=(M, r)).astype(np.float32)
    return f, y, yhat


@pytest.mark.parametrize("shape", [(96, 80), (37, 24), (3, 40, 16)])
def test_quantize_weight_is_bit_equal(shape):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.2).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero column takes the 1e-8 scale floor
    got_q, got_s = tint8.quantize_weight(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_q.transpose(-1, -2).is_contiguous()
    for i in np.ndindex(shape[:-2]):
        want_q, want_s = jint8.quantize_weight(jnp.asarray(w[i]))
        np.testing.assert_array_equal(got_q[i].numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s[i].numpy(), np.asarray(want_s))


def test_quantize_member_is_bit_equal_and_leaves_the_model(members):
    _, stacked, m = members
    before = {k: v.clone() for k, v in m.state_dict().items()}
    q = tint8.quantize_member(m)
    for i in range(M):
        want = jint8.quantize_member(_member(stacked, i))["int8"]
        for name in ("lin2", "lin3"):
            for got, ref in zip(q[name], want[name]):
                np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref), err_msg=name)
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("zp", [False, True], ids=["symmetric", "zero-point"])
def test_int8_matmul_matches_jax(zp):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((23, 96)).astype(np.float32)
    if zp:
        x = np.log1p(np.exp(x))
    w_q, w_s = jint8.quantize_weight(jnp.asarray(rng.standard_normal((96, 80)) * 0.2, jnp.float32))
    cs = jnp.sum(w_q.astype(jnp.int32), axis=0).astype(jnp.float32) if zp else None
    want = jint8.int8_matmul(jnp.asarray(x), w_q, w_s, cs)
    got = tint8.int8_matmul(torch.from_numpy(x), *(torch.from_numpy(np.array(v)) for v in (w_q, w_s)),
                            None if cs is None else j2t(cs))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_int_matmul_broadcasts_members_and_is_exact():
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (9, 40), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (3, 40, 24), dtype=torch.int8, generator=g)
    want = (a.double() @ b.double()).to(torch.int32)
    assert torch.equal(tint8.int_matmul(a, b), want)


@pytest.mark.parametrize("t", [0, 5, 10])
def test_int8_eps_matches_jax(members, eps_inputs, t):
    _, stacked, m = members
    f, y, yhat = eps_inputs
    got = tint8.int8_eps(m, tint8.quantize_member(m), *map(torch.from_numpy, (f, y)), t,
                         torch.from_numpy(yhat))
    for i in range(M):
        qv = jint8.quantize_member(_member(stacked, i))
        want = jint8.int8_eps(qv, jnp.asarray(f[i]), jnp.asarray(y[i]), jnp.asarray(t), jnp.asarray(yhat[i]))
        np.testing.assert_allclose(t2n(got[i]), np.asarray(want), **TOL)


@pytest.mark.parametrize("prequantized", [False, True], ids=["in-call", "resident"])
def test_int8_encode_matches_jax(members, prequantized):
    jm, stacked, m = members
    x = np.random.default_rng(2).random((5, D)).astype(np.float32)
    qenc = tint8.quantize_encoder(m) if prequantized else None
    got = tint8.int8_encode(m, torch.from_numpy(x), qenc)
    for i in range(M):
        v = _member(stacked, i)
        want = jint8.int8_encode(jint8.quantize_encoder(v) if prequantized else v, jnp.asarray(x))
        np.testing.assert_allclose(t2n(got[i]), np.asarray(want), **TOL)
        # int8 enc_lin1 stays close to the float encoder
        np.testing.assert_allclose(np.asarray(want), np.asarray(jm.apply(v, jnp.asarray(x), method="encode")),
                                   rtol=0.1, atol=0.1)


G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))


@pytest.mark.parametrize("ids", [(0, 1, 2), (2, 0)])
def test_int8_mapping_heads_match_jax(ids):
    jg = JaxGuidance(**G)
    images = np.random.default_rng(4).random((3, 16, 16, 3)).astype(np.float32)
    gvars = jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    g = SEViTGuidance(**G, device="cpu")
    g.load_state_dict(guidance_from_flax(jax.tree.map(np.asarray, gvars)))
    taps = jg.apply(gvars, jnp.asarray(images), ids, method="taps_subset")
    want = jint8.int8_mapping_heads(jint8.quantize_mapping_heads(gvars, ids), taps, ids)
    got_taps = g.taps_subset(torch.from_numpy(images), ids)
    np.testing.assert_allclose(t2n(got_taps), np.asarray(taps), rtol=1e-5, atol=1e-5)
    q = tint8.quantize_mapping_heads(g, ids)
    for i in ids:
        want_q = jint8.quantize_weight(gvars["params"][f"mlp{i}"]["linear1"]["Dense_0"]["kernel"])
        np.testing.assert_array_equal(q[i][0].numpy(), np.asarray(want_q[0]))
    got = tint8.int8_mapping_heads(g, got_taps, ids, q)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(t2n(tint8.int8_mapping_heads(g, got_taps, ids)), t2n(got), rtol=0, atol=0)


@pytest.mark.parametrize("zp", [False, True], ids=["symmetric", "zero-point"])
@pytest.mark.parametrize("r,k,n", [(23, 96, 80), (8, 64, 128)])
def test_int8_linear_softplus_plain_matches_jax_k4(zp, r, k, n):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((r, k)).astype(np.float32)
    if zp:
        x = np.log1p(np.exp(x))
    w_q, w_s = jint8.quantize_weight(jnp.asarray(rng.standard_normal((k, n)) * 0.2, jnp.float32))
    a = (rng.standard_normal(n) * 0.5 + 1.0).astype(np.float32)
    c = (rng.standard_normal(n) * 0.1).astype(np.float32)
    cs = jnp.sum(w_q.astype(jnp.int32), axis=0).astype(jnp.float32) if zp else None
    xmax = (x.max(1, keepdims=True) if zp else np.abs(x).max(1, keepdims=True)).astype(np.float32)
    s = w_s * a
    want_h, want_m = jpallas.int8_linear_softplus(jnp.asarray(x), jnp.asarray(xmax), w_q, s, jnp.asarray(c),
                                                  colsum=cs, block_r=8, block_n=128)
    tq = torch.from_numpy(np.ascontiguousarray(np.asarray(w_q).T)).T  # the port's K-contiguous layout
    got_h, got_m = int8_linear_softplus_plain(
        torch.from_numpy(x)[None], torch.from_numpy(xmax)[None], tq[None],
        j2t(s)[None], torch.from_numpy(c)[None], None if cs is None else j2t(cs)[None])
    assert got_h.shape == (1, r, n) and got_m.shape == (1, r, 1)
    np.testing.assert_allclose(t2n(got_h[0]), np.asarray(want_h), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t2n(got_m[0]), np.asarray(want_m), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(t2n(got_m[0, :, 0]), t2n(got_h[0].amax(-1)))


@pytest.mark.parametrize("fused", [False, True], ids=["k4", "k5-fused-ends"])
@pytest.mark.parametrize("t", [1, 9])
def test_int8_eps_kernels_plain_match_jax_pallas(members, eps_inputs, fused, t):
    _, stacked, m = members
    f, y, yhat = eps_inputs
    port = int8_eps_pallas_fused if fused else int8_eps_pallas
    ref = jpallas.int8_eps_pallas_fused if fused else jpallas.int8_eps_pallas
    got = port(m, tint8.quantize_member(m), *map(torch.from_numpy, (f, y)), t, torch.from_numpy(yhat))
    assert got.dtype == torch.float32 and got.shape == (M, f.shape[1], 2)
    for i in range(M):
        qv = jint8.quantize_member(_member(stacked, i))
        want = ref(qv, jnp.asarray(f[i]), jnp.asarray(y[i]), jnp.asarray(t), jnp.asarray(yhat[i]),
                   block_r=8, block_n=128)
        np.testing.assert_allclose(t2n(got[i]), np.asarray(want), **TOL)
