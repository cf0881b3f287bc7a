"""The whole serving slice: ladine_tpu_torch's Predictor.predict against
ladine_tpu's Predictor.predict on the CPU, on the same weights (carried by
utils/convert.py) and the same noise (the JAX sampler's draws, rebuilt and
injected).

Both run float32. The chain repeats the eps net 20 (ancestral) or 5 (DDIM)
times, so per-step differences of summation order (~1e-7 relative) can grow
along it: probs, PIW and variance hold to rtol 1e-4 / atol 1e-5, and the
vote must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ladine_tpu.infer import Predictor as JaxPredictor
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
import torch

from ladine_tpu_torch.infer import Predictor
from ladine_tpu_torch.infer.serve import PRESETS, call_seed
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from torch_parity import j2t, jax_ensemble_noise, jax_folded_noise, jax_members

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
T = 20


@pytest.fixture(scope="module")
def parts():
    jg = JaxGuidance(**G)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    jm = JaxConditionalModel(data_dim=768, feature_dim=8, hidden_dim=8, y_dim=2, n_steps=T + 1)
    stacked = jax_members(jm, 3, 768)
    g = SEViTGuidance(**G, device="cpu")
    g.load_state_dict(guidance_from_flax(gvars))
    m = ConditionalModel(3, 768, 8, 8, 2, T + 1, device="cpu")
    m.load_state_dict(members_from_flax(stacked))
    return dict(jg=jg, gvars=gvars, jm=jm, stacked=stacked, g=g, m=m)


def _pair(parts, **kw):
    ref = JaxPredictor(guidance=parts["jg"], guidance_vars=parts["gvars"], model=parts["jm"],
                       stacked_vars=parts["stacked"], sched=JaxSchedule.create("linear", T, 1e-4, 0.02),
                       temperature=0.2, mc_trials=2, **kw)
    ours = Predictor(guidance=parts["g"], model=parts["m"],
                     sched=DiffusionSchedule.create("linear", T, 1e-4, 0.02, device="cpu"),
                     temperature=0.2, mc_trials=2, device="cpu", **kw)
    return ref, ours


@pytest.mark.parametrize(
    "kw",
    [
        dict(ddim_steps=0),
        dict(ddim_steps=5, ddim_eta=1.0),
        dict(ddim_steps=5, ddim_eta=0.0, noise_prior=True),
        dict(ddim_steps=0, head_indices=(2, 0, 3)),
    ],
    ids=["ancestral", "ddim-eta1", "ddim-eta0-noise-prior", "ancestral-heads-with-vit"],
)
def test_predict_matches_jax_predictor(parts, kw):
    ref, ours = _pair(parts, **kw)
    images = np.random.default_rng(0).random((4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    n_draws = T if ours._tau is None else len(ours._tau)
    noise = jax_ensemble_noise(key, 3, 2, (4, 2), n_draws)
    want = ref.predict(images, key=key)
    got = ours.predict(images, noise=j2t(noise))
    assert got["probs"].shape == (4, 2) and got["majority_vote"].shape == (4,)
    np.testing.assert_array_equal(got["majority_vote"], np.asarray(want["majority_vote"]))
    for name in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_predict_seeds_each_call_afresh(parts):
    _, ours = _pair(parts, ddim_steps=5)
    images = np.random.default_rng(1).random((2, 16, 16, 3)).astype(np.float32)
    a, b = ours.predict(images), ours.predict(images)
    assert not np.allclose(a["probs"], b["probs"])
    np.testing.assert_allclose(a["probs"].sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("seed", [2**31, 2**32, 2**40], ids=["2^31", "2^32", "2^40"])
def test_predict_takes_any_seed(parts, seed):
    """Seeds the JAX Predictor takes (``PRNGKey(seed)``): the port mixes the
    seed and the call counter into one 64-bit generator seed."""
    jax_ref, ours = _pair(parts, ddim_steps=5, seed=seed)
    images = np.random.default_rng(4).random((2, 16, 16, 3)).astype(np.float32)
    jax_ref.predict(images)
    a, b = ours.predict(images), ours.predict(images)
    assert all(np.isfinite(v).all() for v in a.values())
    assert not np.allclose(a["probs"], b["probs"])
    assert call_seed(seed, 0) != call_seed(seed, 1) != call_seed(seed + 1, 1)


def test_head_indices_and_input_validation(parts):
    with pytest.raises(ValueError, match="must match the 3 stacked members"):
        _pair(parts, head_indices=(0, 1))
    with pytest.raises(ValueError, match="out of range"):
        _pair(parts, head_indices=(0, 1, 4))
    _, ours = _pair(parts, ddim_steps=5)
    with pytest.raises(ValueError, match="predict expects images"):
        ours.predict(np.zeros((2, 3, 16, 16), np.float32))


# The int8 operating points at DDIM-3. Both sides pick the same int8 codes
# (tests/test_torch_int8.py) and agree to ~1e-7 here; float32 sums in
# another order could still flip one code at a rounding boundary, which
# moves one eps value by about a quantization step (~1e-3 relative at these
# widths) and the aggregated outputs by less: rtol/atol 1e-3, and the vote
# must be equal.
INT8_CASES = {
    "serving": dict(PRESETS["serving"], ddim_steps=3),
    "fast": dict(PRESETS["fast"], ddim_steps=3),
    "fast-heads-with-vit": dict(PRESETS["fast"], ddim_steps=3, head_indices=(2, 0, 3)),
    "serving-int8-pallas": dict(PRESETS["serving"], ddim_steps=3, use_int8_pallas=True),
    "serving-int8-pallas-fuse-ends": dict(PRESETS["serving"], ddim_steps=3, use_int8_pallas=True,
                                          pallas_fuse_ends=True),
}


@pytest.mark.parametrize("name", sorted(INT8_CASES))
def test_int8_predict_matches_jax_predictor(parts, name):
    kw = INT8_CASES[name]
    before = {k: v.clone() for k, v in parts["m"].state_dict().items()}
    ref, ours = _pair(parts, **kw)
    images = np.random.default_rng(3).random((4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    # the JAX engine folds the trials into rows only under use_int8_pallas
    draws = jax_folded_noise if kw.get("use_int8_pallas") else jax_ensemble_noise
    noise = draws(key, 3, 2, (4, 2), len(ours._tau))
    want = ref.predict(images, key=key)
    got = ours.predict(images, noise=j2t(noise))
    np.testing.assert_array_equal(got["majority_vote"], np.asarray(want["majority_vote"]))
    for out in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(got[out], np.asarray(want[out]), rtol=1e-3, atol=1e-3, err_msg=out)
    # quantization keeps its int8 copies beside the float weights
    assert all(torch.equal(v, before[k]) for k, v in parts["m"].state_dict().items())


def test_int8_weights_are_quantized_once_at_construction(parts):
    _, fast = _pair(parts, **INT8_CASES["fast"])
    assert set(fast._qmember) == {"lin2", "lin3"} and fast._qenc[0].dtype == torch.int8
    assert sorted(fast._qheads) == [0, 1, 2]
    _, vit = _pair(parts, **INT8_CASES["fast-heads-with-vit"])
    assert vit._qheads is None and vit._qenc is not None  # the ViT head has no int8 form
    _, parity = _pair(parts, ddim_steps=0)
    assert parity._qmember is None and parity._qenc is None and parity._qheads is None


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        Predictor.from_preset("turbo")


def test_parity_preset_runs_the_full_chain(parts):
    p = Predictor.from_preset("parity", guidance=parts["g"], model=parts["m"],
                              sched=DiffusionSchedule.create("linear", T, device="cpu"),
                              mc_trials=2, device="cpu")
    assert p._tau is None
    out = p.predict(np.random.default_rng(2).random((2, 16, 16, 3)).astype(np.float32))
    assert np.isfinite(out["probs"]).all()
