"""ladine_tpu_torch models against ladine_tpu's flax models on the CPU.

Weights go from the flax trees to the port through utils/convert.py. Both
sides run float32; LayerNorm, exact GELU and softmax are evaluated by two
libraries in different orders, so the ViT paths hold to rtol 1e-4 /
atol 1e-5, the dense-only paths to rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.utils import (
    guidance_from_flax,
    guidance_to_flax,
    members_from_flax,
    members_to_flax,
)
from torch_parity import j2t, jax_members, t2n

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))


@pytest.fixture(scope="module")
def guidance_pair():
    jg = JaxGuidance(**G)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    # the init leaves cls/pos at 0/small: perturb every leaf so no layout
    # mistake hides behind a zero or a symmetric tensor
    leaves, treedef = jax.tree.flatten(gvars)
    rng = np.random.default_rng(0)
    leaves = [v + 0.05 * rng.standard_normal(v.shape).astype(np.float32) for v in leaves]
    gvars = jax.tree.unflatten(treedef, leaves)
    g = SEViTGuidance(**G, device="cpu")
    g.load_state_dict(guidance_from_flax(gvars))
    return jg, gvars, g


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).random((2, 16, 16, 3)).astype(np.float32)


def _close(ours, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(t2n(ours), np.asarray(ref), rtol=rtol, atol=atol)


def test_vit_taps_and_full_forward_match(guidance_pair, images):
    jg, gvars, g = guidance_pair
    x, xt = jnp.asarray(images), j2t(images)
    taps = jg.apply(gvars, x, (1, 3), method=lambda m, x, d: m.vit.tap_features(x, d))
    ours = g.vit.tap_features(xt, (1, 3))
    assert len(ours) == 2 and ours[0].shape == (2, 4, 16)
    for a, b in zip(ours, taps):
        _close(a, b)
    logits = jg.apply(gvars, x, method=lambda m, x: m.vit(x))
    _close(g.vit(xt), logits)
    full, taps2 = g.vit.forward_with_taps(xt, (2,))
    ref_full, ref_taps = jg.apply(gvars, x, (2,), method=lambda m, x, d: m.vit.forward_with_taps(x, d))
    _close(full, ref_full)
    _close(taps2[0], ref_taps[0])


def test_patch_embed_order_matches_flax(guidance_pair, images):
    jg, gvars, g = guidance_pair
    ref = jg.apply(gvars, jnp.asarray(images), method=lambda m, x: m.vit.patch_embed(x))
    _close(g.vit.patch_embed(j2t(images)), ref, rtol=1e-5, atol=1e-6)


def test_mapping_mlp_matches(guidance_pair):
    jg, gvars, g = guidance_pair
    tap = np.random.default_rng(2).standard_normal((2, 4, 16)).astype(np.float32)
    ref = jg.apply(gvars, jnp.asarray(tap), method=lambda m, t: m.mlps[1](t))
    _close(g.mlps[1](j2t(tap)), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("indices", [(0, 1, 2), (2, 0), (1,), (3,), (0, 3, 2)])
def test_heads_subset_matches(guidance_pair, images, indices):
    jg, gvars, g = guidance_pair
    ref = jg.apply(gvars, jnp.asarray(images), indices, method="heads_subset")
    ours = g.heads_subset(j2t(images), indices)
    assert ours.shape == (len(indices), 2, 2)
    _close(ours, ref)


def test_taps_subset_matches(guidance_pair, images):
    jg, gvars, g = guidance_pair
    ref = jg.apply(gvars, jnp.asarray(images), (2, 0), method="taps_subset")
    _close(g.taps_subset(j2t(images), (2, 0)), ref)


def test_subset_index_errors(guidance_pair, images):
    _, _, g = guidance_pair
    x = j2t(images)
    with pytest.raises(ValueError, match="out of range 0..3"):
        g.heads_subset(x, (0, 4))
    with pytest.raises(ValueError, match="out of range"):
        g.heads_subset(x, (-1,))
    with pytest.raises(ValueError, match="full-ViT head has no tap"):
        g.taps_subset(x, (3,))
    with pytest.raises(ValueError, match="must be >= num_members"):
        SEViTGuidance(**{**G, "vit_depth": 2}, device="cpu")


@pytest.fixture(scope="module")
def member_pair():
    jm = JaxConditionalModel(data_dim=48, feature_dim=8, hidden_dim=8, y_dim=2, n_steps=21)
    stacked = jax_members(jm, 2, 48)
    model = ConditionalModel(2, 48, 8, 8, 2, 21, device="cpu")
    model.load_state_dict(members_from_flax(stacked))
    return jm, stacked, model


def test_encode_and_eps_match_with_channel_last_flatten(member_pair):
    jm, stacked, model = member_pair
    # an NHWC image whose 3 channels differ: a channel-first flatten would
    # feed enc_lin1 permuted rows
    rng = np.random.default_rng(3)
    img = rng.random((3, 4, 4, 3)).astype(np.float32) * np.array([1.0, -2.0, 0.5], np.float32)
    f = model.encode(j2t(img).reshape(3, -1))
    wrong = model.encode(j2t(img).permute(0, 3, 1, 2).reshape(3, -1))
    assert not torch.allclose(f, wrong, atol=1e-3)
    y = rng.standard_normal((2, 3, 2)).astype(np.float32)
    yhat = rng.dirichlet([1, 1], size=(2, 3)).astype(np.float32)
    eps = model.eps(f, j2t(y), 7, j2t(yhat))
    for i in range(2):
        v = jax.tree.map(lambda a: jnp.asarray(a[i]), stacked)
        ref_f = jm.apply(v, jnp.asarray(img.reshape(3, -1)), method="encode")
        _close(f[i], ref_f, rtol=1e-5, atol=1e-6)
        ref_eps = jm.apply(v, ref_f, jnp.asarray(y[i]), jnp.asarray(7), jnp.asarray(yhat[i]),
                           method="eps")
        _close(eps[i], ref_eps)


def test_conditional_model_rejects_guidance_free_eps():
    with pytest.raises(NotImplementedError, match="guidance"):
        ConditionalModel(2, 48, 8, 8, 2, 21, guidance=False, device="cpu")


def test_init_random_is_seeded_and_fills_every_tensor():
    def make(seed):
        g = SEViTGuidance(**G, device="cpu")
        m = ConditionalModel(2, 48, 8, 8, 2, 21, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        init_random_(g, gen)
        init_random_(m, gen)
        return {**{f"g.{k}": v for k, v in g.state_dict().items()},
                **{f"m.{k}": v for k, v in m.state_dict().items()}}

    a, b, c = make(0), make(0), make(1)
    for k in a:
        assert torch.isfinite(a[k]).all(), k
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["m.lin2.linear.weight"], c["m.lin2.linear.weight"])
    assert torch.equal(a["m.unetnorm1.running_var"], torch.ones(2, 8))


def test_weight_bridge_round_trip(guidance_pair, member_pair):
    _, gvars, g = guidance_pair
    back = guidance_to_flax(g.state_dict(), depth=3, n_mlps=3)
    jax.tree.map(np.testing.assert_array_equal, back, gvars)
    _, stacked, model = member_pair
    back = members_to_flax(model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, stacked)
    # a state_dict that went round the bridge loads strictly into a fresh model
    fresh = ConditionalModel(2, 48, 8, 8, 2, 21, device="cpu")
    fresh.load_state_dict(members_from_flax(back), strict=True)
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
