"""The port's bf16 serving path against ladine_tpu's, on the CPU.

The JAX ``Predictor`` runs a bf16 ``SEViTGuidance``/``ConditionalModel``
with the JAX package's default float32 parameters; the port runs bf16
modules built from the same flax tree (``utils/convert.py``). The tree is
rounded to bf16 values first, so both hold the same numbers (a bf16
artifact), and the int8 weights quantized from them are the same. Noise is
the JAX sampler's, injected; the Pallas functions run as the JAX tests run
them on the CPU (interpret mode).

What must match (the storage dtypes of the reference):

* ``encode`` returns float32 on both sides (flax's BatchNorm promotes to its
  float32 statistics), equal here to the last bit.
* The int8 paths store their hidden rows in the features' dtype: float32 at
  ``serving`` (with ``use_int8_pallas`` and ``pallas_fuse_ends`` too), the
  compute dtype under ``use_int8_encode`` (``fast``). Their eps on the same
  inputs agrees to float32 rounding (1e-6).

Where a gap stays, it comes from a rounding point inside a kernel, and it is
held to a stated tolerance (measured max abs error in brackets):

* K1 (float eps): the flax ``Dense`` rounds ``x @ W + b`` and the timestep
  gate's product to bf16 before the BatchNorm, while K1's epilogue keeps them
  in float32, as the JAX Pallas K1 does: eps within one bf16 ulp of |eps|
  [0.00195 at |eps| ~ 1].
* K3 (guidance): the flax attention rounds its scores and softmax to bf16,
  K3 keeps them in float32, as the JAX Pallas K3 does: the heads' logits
  within one bf16 ulp [0.00195 at |logit| ~ 0.36].
* The predictor outputs carry those two along the chain (votes equal):
  parity [probs 8.0e-5, piw 6.2e-4, variance 4.6e-4] and DDIM-5 [1.3e-4,
  1.7e-3, 2.4e-3], held to 5e-3; serving [1.4e-4, 2.0e-4, 1.8e-4],
  ``use_int8_pallas`` and ``+ pallas_fuse_ends`` [1.3e-5, 1.6e-4, 8.9e-5],
  held to 1e-3, where the int8 eps itself is exact to float32 rounding and
  only the guidance gap is left (with bf16 rows, as before the port matched
  the reference's float32 rows, serving read [4.3e-4, 3.2e-3, 1.6e-3]);
  ``fast`` [1.9e-4, 1.1e-3, 5.9e-4], held to 3e-3 (its int8 heads and
  encoder on both sides, bf16 rows on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.infer import Predictor as JaxPredictor
from ladine_tpu.kernels import int8 as jint8
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu_torch.infer import Predictor
from ladine_tpu_torch.infer import engine
from ladine_tpu_torch.infer.serve import PRESETS
from ladine_tpu_torch.kernels import int8 as tint8
from ladine_tpu_torch.kernels import int8_eps_fused, int8_linear
from ladine_tpu_torch.kernels.fused_eps import fused_eps
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from torch_parity import j2t, jax_ensemble_noise, jax_folded_noise, jax_members

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
T, D, FEAT = 20, 768, 8
BF16 = torch.bfloat16
F32 = torch.float32


def _bf16_values(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def parts():
    init = jax.jit(JaxGuidance(**G).init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    gvars = _bf16_values(jax.tree.map(np.asarray, init))
    stacked = _bf16_values(jax_members(
        JaxConditionalModel(data_dim=D, feature_dim=FEAT, hidden_dim=FEAT, y_dim=2, n_steps=T + 1), 3, D))
    g = SEViTGuidance(**G, device="cpu", dtype=BF16)
    g.load_state_dict(guidance_from_flax(gvars))
    m = ConditionalModel(3, D, FEAT, FEAT, 2, T + 1, device="cpu", dtype=BF16)
    m.load_state_dict(members_from_flax(stacked))
    return dict(jg=JaxGuidance(**G, dtype=jnp.bfloat16), gvars=gvars, stacked=stacked, g=g, m=m,
                jm=JaxConditionalModel(data_dim=D, feature_dim=FEAT, hidden_dim=FEAT, y_dim=2,
                                       n_steps=T + 1, dtype=jnp.bfloat16))


def _member(stacked, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), stacked)


def _jax_encode(parts, x):
    jm = parts["jm"]
    return np.stack([np.asarray(jm.apply(_member(parts["stacked"], i), jnp.asarray(x), method="encode"))
                     for i in range(3)])


def test_encode_returns_float32_as_flax_does(parts):
    x = np.random.default_rng(0).random((4, D)).astype(np.float32)
    want = _jax_encode(parts, x)
    got = parts["m"].encode(torch.from_numpy(x))
    assert want.dtype == np.float32 and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_guidance_heads_within_one_bf16_ulp(parts):
    """K3's float32 scores against the flax attention's bf16 ones."""
    images = np.random.default_rng(3).random((4, 16, 16, 3)).astype(np.float32)
    want = np.asarray(parts["jg"].apply(parts["gvars"], jnp.asarray(images), (0, 1, 2),
                                        method="heads_subset"), np.float32)
    got = parts["g"].heads_subset(torch.from_numpy(images), (0, 1, 2)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2**-8, atol=2**-9 * np.abs(want).max())


@pytest.mark.parametrize("t", [1, 7, 19])
def test_eps_gaps_are_the_kernel_rounding_points(parts, t):
    """On the same float32 features: the float eps (K1, float32 epilogue)
    within one bf16 ulp of the flax eps (bf16 Dense and gate products), and
    the int8 eps (float32 rows) equal to float32 rounding."""
    rng = np.random.default_rng(5)
    f = np.repeat(_jax_encode(parts, rng.random((4, D)).astype(np.float32)), 2, axis=1)  # (3, 8, FEAT)
    y = rng.standard_normal((3, 8, 2)).astype(np.float32)
    yh = rng.dirichlet([1.0, 1.0], size=(3, 8)).astype(np.float32)
    m, jm = parts["m"], parts["jm"]
    members = [_member(parts["stacked"], i) for i in range(3)]
    args = [jnp.asarray(a) for a in (f, y, yh)]

    want = np.stack([np.asarray(jm.apply(v, args[0][i], args[1][i], jnp.asarray(t), args[2][i],
                                         method="eps"), np.float32) for i, v in enumerate(members)])
    got = fused_eps(m, torch.from_numpy(f), torch.from_numpy(y), t, torch.from_numpy(yh))
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2**-8 * np.abs(want).max())

    want8 = np.stack([np.asarray(jint8.int8_eps(jint8.quantize_member(v), args[0][i], args[1][i],
                                                jnp.asarray(t), args[2][i])) for i, v in enumerate(members)])
    got8 = tint8.int8_eps(m, tint8.quantize_member(m), torch.from_numpy(f), torch.from_numpy(y), t,
                          torch.from_numpy(yh))
    assert got8.dtype == F32
    np.testing.assert_allclose(got8.numpy(), want8, rtol=1e-6, atol=1e-6)


# preset and flags at DDIM-3 (int8) or the 20-step chain; the output
# tolerance (module docstring); where the int8 rows are seen, in which dtype
CASES = {
    "parity": (dict(ddim_steps=0), 5e-3, []),
    "ddim": (dict(ddim_steps=5, ddim_eta=1.0), 5e-3, []),
    "serving": (dict(PRESETS["serving"], ddim_steps=3), 1e-3,
                [(engine, "int8_eps", 2, F32), (tint8, "int8_matmul", 0, F32)]),
    "fast": (dict(PRESETS["fast"], ddim_steps=3), 3e-3, [(engine, "int8_eps", 2, BF16)]),
    "serving-int8-pallas": (dict(PRESETS["serving"], ddim_steps=3, use_int8_pallas=True), 1e-3,
                            [(int8_linear, "int8_linear_softplus", 0, F32)]),
    "serving-int8-pallas-fuse-ends": (
        dict(PRESETS["serving"], ddim_steps=3, use_int8_pallas=True, pallas_fuse_ends=True), 1e-3,
        [(int8_eps_fused, "int8_eps_l12", 0, F32), (int8_eps_fused, "int8_eps_l34", 0, F32)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_predict_matches_jax_predictor(parts, name, monkeypatch):
    kw, tol, row_checks = CASES[name]
    seen = {}
    for module, fn_name, arg, _ in row_checks:
        def spy(*args, _fn=getattr(module, fn_name), _key=fn_name, _arg=arg, **kwargs):
            seen.setdefault(_key, set()).add(args[_arg].dtype)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, fn_name, spy)
    ref = JaxPredictor(guidance=parts["jg"], guidance_vars=parts["gvars"], model=parts["jm"],
                       stacked_vars=parts["stacked"], sched=JaxSchedule.create("linear", T, 1e-4, 0.02),
                       temperature=0.2, mc_trials=2, **kw)
    ours = Predictor(guidance=parts["g"], model=parts["m"],
                     sched=DiffusionSchedule.create("linear", T, 1e-4, 0.02, device="cpu"),
                     temperature=0.2, mc_trials=2, device="cpu", **kw)
    images = np.random.default_rng(3).random((4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    draws = jax_folded_noise if kw.get("use_int8_pallas") else jax_ensemble_noise
    noise = draws(key, 3, 2, (4, 2), T if ours._tau is None else len(ours._tau))
    want = ref.predict(images, key=key)
    got = ours.predict(images, noise=j2t(noise))
    np.testing.assert_array_equal(got["majority_vote"], np.asarray(want["majority_vote"]))
    for out in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(got[out], np.asarray(want[out]), rtol=0, atol=tol, err_msg=out)
    assert seen == {fn_name: {dtype} for _, fn_name, _, dtype in row_checks}
