"""The port at 10 classes (``configs/digits.yml``'s class count) against
ladine_tpu on the CPU, on the same weights (``utils/convert.py``) and the
same draws (the JAX samplers', rebuilt and injected): the first port tests
above 2 classes.

At 10 classes lin1 takes K = 2C = 20 (on the card: the ``mma`` body with
the float32 gate, F6), K5a's lin1 pass sums 20 terms and K5b's lin4
epilogue takes 10 columns; here each wrapper runs its plain version and
the JAX Pallas functions run as the JAX tests run them on the CPU.

Tolerances, as the 2-class files state them and why:

* ``Predictor.predict`` in float32, the 20-step ancestral chain: probs,
  PIW and variance rtol 1e-4 / atol 1e-5 (summation order along the
  chain, ``tests/test_torch_serve.py``); int8 at DDIM-3 rtol/atol 1e-3 (a
  code can flip at a rounding boundary); votes equal.
* bf16 (the flax tree rounded to bf16 values on both sides): atol 5e-3 on
  the float DDIM-5 chain and 1e-3 at ``serving`` + K5, the kernel rounding points
  of ``tests/test_torch_bf16.py``; votes equal.
* A member train step from one JAX state with one-hot labels of 10 classes:
  loss rtol 1e-5, moments atol 1e-5, the step's gradient 1e-4 of JAX's in
  norm (``tests/torch_parity.py::assert_adam_step``).
* ``compute_report`` at 10 classes: 1e-6; the temperature fit 1e-4 in T and
  1e-5 in ECE, the vote-fraction limit 1e-6.
* Mapping heads of 10 outputs: train steps as the 2-class file holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.infer import Predictor as JaxPredictor
from ladine_tpu.infer import calibrate as jcal
from ladine_tpu.infer import evaluator as jev
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.models import ViT as JaxViT
from ladine_tpu.models.mlp import MappingMLP as JaxMLP
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu.train import classifier_trainer as JC
from ladine_tpu.train import diffusion_trainer as JT
from ladine_tpu.train.optim import make_optimizer as jax_make_optimizer
from ladine_tpu_torch.infer import Predictor
from ladine_tpu_torch.infer import calibrate as tcal
from ladine_tpu_torch.infer import evaluator as tev
from ladine_tpu_torch.infer.serve import PRESETS
from ladine_tpu_torch.models import ConditionalModel, MappingMLP, SEViTGuidance, ViT
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.train import classifier_trainer as C
from ladine_tpu_torch.train import diffusion_trainer as T
from ladine_tpu_torch.train.optim import make_optimizer
from ladine_tpu_torch.utils import (
    guidance_from_flax,
    guidance_to_flax,
    member_state_from_jax,
    members_from_flax,
    members_to_flax,
    train_state_from_jax,
    vit_from_flax,
)
from torch_parity import (
    assert_adam_step,
    j2t,
    jax_ensemble_noise,
    jax_folded_noise,
    jax_member_draws,
    key_bias_slices,
    one_torch_thread,  # noqa: F401 (autouse)
    t2n,
)

CLASSES, MEMBERS, STEPS, IMG = 10, 3, 20, 16
G = dict(num_classes=CLASSES, num_members=MEMBERS, vit_depth=3, img_size=IMG, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
DATA_DIM, FEAT = IMG * IMG * 3, 16
BF16 = torch.bfloat16


def _bf16_values(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def trees():
    """One guidance and three members at 10 classes (lin1 takes K = 20) as
    flax trees: initialized by the port from a seed (no JAX program to
    compile), the members' BatchNorm statistics drawn off their init
    values, and carried over by the bridges."""
    torch.manual_seed(0)
    g = SEViTGuidance(**G, device="cpu")
    m = ConditionalModel(MEMBERS, DATA_DIM, FEAT, FEAT, CLASSES, STEPS + 1, device="cpu")
    draw = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, stat in m.named_buffers():
            if name.endswith("running_mean"):
                stat.copy_(0.1 * torch.randn(stat.shape, generator=draw))
            elif name.endswith("running_var"):
                stat.copy_(0.5 + torch.rand(stat.shape, generator=draw))
    as_numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return as_numpy(guidance_to_flax(g.state_dict())), as_numpy(members_to_flax(m.state_dict()))


def _pair(trees, dtype, **kw):
    gvars, stacked = trees
    jdt = jnp.bfloat16 if dtype == BF16 else None
    if dtype == BF16:
        gvars, stacked = _bf16_values(gvars), _bf16_values(stacked)
    ref = JaxPredictor(guidance=JaxGuidance(**G, dtype=jdt), guidance_vars=gvars,
                       model=JaxConditionalModel(data_dim=DATA_DIM, feature_dim=FEAT, hidden_dim=FEAT,
                                                 y_dim=CLASSES, n_steps=STEPS + 1, dtype=jdt),
                       stacked_vars=stacked, sched=JaxSchedule.create("linear", STEPS, 1e-4, 0.02),
                       temperature=0.2, mc_trials=2, **kw)
    g = SEViTGuidance(**G, device="cpu", dtype=dtype)
    g.load_state_dict(guidance_from_flax(gvars))
    m = ConditionalModel(MEMBERS, DATA_DIM, FEAT, FEAT, CLASSES, STEPS + 1, device="cpu", dtype=dtype)
    m.load_state_dict(members_from_flax(stacked))
    ours = Predictor(guidance=g, model=m, sched=DiffusionSchedule.create("linear", STEPS, 1e-4, 0.02, device="cpu"),
                     temperature=0.2, mc_trials=2, device="cpu", **kw)
    return ref, ours


# name: (dtype, settings, tolerance as (rtol, atol))
CASES = {
    "parity": (torch.float32, dict(ddim_steps=0), (1e-4, 1e-5)),
    "serving": (torch.float32, dict(PRESETS["serving"], ddim_steps=3), (1e-3, 1e-3)),
    "fast": (torch.float32, dict(PRESETS["fast"], ddim_steps=3), (1e-3, 1e-3)),
    "serving-int8-pallas": (torch.float32, dict(PRESETS["serving"], ddim_steps=3, use_int8_pallas=True),
                            (1e-3, 1e-3)),
    "serving-int8-pallas-fuse-ends": (torch.float32, dict(PRESETS["serving"], ddim_steps=3, use_int8_pallas=True,
                                                          pallas_fuse_ends=True), (1e-3, 1e-3)),
    "bf16-ddim": (BF16, dict(ddim_steps=5, ddim_eta=1.0), (0, 5e-3)),
    "bf16-serving-int8-pallas-fuse-ends": (BF16, dict(PRESETS["serving"], ddim_steps=3, use_int8_pallas=True,
                                                      pallas_fuse_ends=True), (0, 1e-3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_predict_at_ten_classes_matches_jax_predictor(trees, name):
    dtype, kw, (rtol, atol) = CASES[name]
    ref, ours = _pair(trees, dtype, **kw)
    images = np.random.default_rng(3).random((4, IMG, IMG, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    draws = jax_folded_noise if kw.get("use_int8_pallas") else jax_ensemble_noise
    noise = draws(key, MEMBERS, 2, (4, CLASSES), STEPS if ours._tau is None else len(ours._tau))
    want = ref.predict(images, key=key)
    got = ours.predict(images, noise=j2t(noise))
    assert got["probs"].shape == (4, CLASSES)
    np.testing.assert_array_equal(got["majority_vote"], np.asarray(want["majority_vote"]))
    for out in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(got[out], np.asarray(want[out]), rtol=rtol, atol=atol, err_msg=out)


def test_member_step_with_one_hot_labels_of_ten_classes():
    """Two member steps, each from one JAX state, labels one-hot over 10
    classes (y0 and the prior mean are 10 wide, lin1 takes 20)."""
    steps, b, lr = 50, 16, 1e-3
    jm = JaxConditionalModel(data_dim=DATA_DIM, feature_dim=FEAT, hidden_dim=FEAT, y_dim=CLASSES,
                             n_steps=steps + 1)
    tx = jax_make_optimizer("Adam", lr)
    js = JT.create_member_state(jm, jax.random.PRNGKey(1), tx, batch_size=2)
    jstep = jax.jit(JT.make_member_step(jm, tx, JaxSchedule.create("linear", steps, 1e-4, 0.02)))
    compute = ConditionalModel(1, DATA_DIM, FEAT, FEAT, CLASSES, steps + 1, device="meta", dtype=torch.float32)
    step = T.make_member_step(compute, make_optimizer("Adam", lr),
                              DiffusionSchedule.create("linear", steps, 1e-4, 0.02, device="cpu"))
    stacked = lambda st: jax.tree.map(lambda v: v[None], st)  # noqa: E731
    rng = np.random.default_rng(2)
    pre_bn = ("enc_lin1.bias", "enc_lin2.bias", "enc_lin3.bias")
    for i in range(2):
        x = rng.standard_normal((b, DATA_DIM)).astype(np.float32)
        y0 = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, b)]
        yh = np.array(jax.nn.softmax(rng.standard_normal((b, CLASSES)).astype(np.float32)))
        key = jax.random.PRNGKey(10 + i)
        port = member_state_from_jax(stacked(js))
        js_new, jl = jstep(js, x, y0, yh, key)
        t, noise = jax_member_draws(key, b, steps, CLASSES)
        port, loss = step(port, torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(yh), t=t, noise=noise)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        old, ref = member_state_from_jax(stacked(js)), member_state_from_jax(stacked(js_new))
        assert_adam_step(port.params, port.opt_state["mu"], old.opt_state["mu"], ref.opt_state["mu"], ref.params,
                         lr, lead=1, zero_grad={k: ... for k in pre_bn})
        for slot in ("mu", "nu"):
            for k, v in ref.opt_state[slot].items():
                np.testing.assert_allclose(t2n(port.opt_state[slot][k]), t2n(v), rtol=0, atol=1e-5, err_msg=k)
        for k, v in ref.ema.items():
            np.testing.assert_allclose(t2n(port.ema[k]), t2n(v), rtol=0, atol=1e-5, err_msg=k)
        js = js_new


def _ten_class_samples(n=120, s=20, seed=0):
    """MC outputs near the one-hot vertices of 10 classes, 80 % of the rows
    near their label's, so that the temperature matters."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CLASSES, n)
    target = np.where((rng.random(n) < 0.8)[:, None], np.eye(CLASSES)[labels],
                      np.eye(CLASSES)[rng.integers(0, CLASSES, n)])
    return (target[None] + rng.normal(scale=0.3, size=(s, n, CLASSES))).astype(np.float32), labels


@pytest.mark.parametrize("num_members", [None, 4], ids=["no-members", "4-members"])
def test_compute_report_at_ten_classes_matches_jax(num_members):
    samples, labels = _ten_class_samples(seed=1)
    got = tev.compute_report(samples, labels, 0.2, num_members=num_members)
    want = jev.compute_report(samples, labels, 0.2, num_members=num_members)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "reliability":
            for part in ("count", "confidence", "accuracy"):
                np.testing.assert_allclose(got[k][part], w[part], rtol=1e-6, atol=1e-6, err_msg=part)
        elif k in ("samples", "labels"):
            np.testing.assert_array_equal(got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=k)


def test_temperature_fit_and_vote_fraction_limit_at_ten_classes():
    """The calibration of ``--calib``: Nelder-Mead on the cached samples,
    and the ECE at T = 1e-6 (``ece_vote_fraction_limit``, where the
    confidence is the MC vote fraction), which bounds the fit from below."""
    samples, labels = _ten_class_samples(n=200, s=40, seed=2)
    t, e = tcal.temperature_search(samples, labels)
    jt, je = jcal.temperature_search(samples, labels)
    assert abs(t - jt) <= 1e-4 and abs(e - je) <= 1e-5
    limit = tcal.calibration_objective(samples, labels, 1e-6)
    assert abs(limit - jcal.calibration_objective(samples, labels, 1e-6)) <= 1e-6
    assert e <= limit + 1e-6


def test_mapping_heads_of_ten_outputs_match_jax():
    """Two train steps of two mapping heads of 10 outputs behind a frozen
    two-block ViT, each from one JAX state, then the eval step's accuracies."""
    heads = 2
    vit_cfg = dict(num_classes=CLASSES, img_size=32, patch_size=8, embed_dim=32, depth=heads, num_heads=2)
    hidden, lr, b = (32, 16, 8), 5e-4, 16
    jv = JaxViT(**vit_cfg)
    vparams = jax.jit(jv.init)(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)))["params"]
    vit = ViT(**vit_cfg, device="cpu")
    vit.load_state_dict(vit_from_flax({"params": jax.tree.map(np.asarray, vparams)}))
    tx, opt = jax_make_optimizer("Adam", lr), make_optimizer("Adam", lr)
    jm = JaxMLP(num_classes=CLASSES, hidden_dims=hidden)
    js = JC.create_mapping_states(jm, jax.random.PRNGKey(1), tx, heads, num_patches=16, embed_dim=32)
    jstep = jax.jit(JC.make_mapping_train_step(jv, vparams, jm, tx, heads))
    jeval = jax.jit(JC.make_mapping_eval_step(jv, vparams, jm, heads))
    mlp = MappingMLP(16 * 32, CLASSES, hidden, device="meta")
    step = C.make_mapping_train_step(vit, mlp, opt, heads)
    evaluate = C.make_mapping_eval_step(vit, mlp, heads)
    rng = np.random.default_rng(2)
    for _ in range(2):
        images, labels = rng.random((b, 32, 32, 3), dtype=np.float32), rng.integers(0, CLASSES, b)
        port = train_state_from_jax(js, "mapping")
        new, jl, jacc = jstep(js, images, labels)
        port, losses, accs = step(port, torch.from_numpy(images), torch.from_numpy(labels))
        np.testing.assert_allclose(t2n(losses), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(t2n(accs), np.asarray(jacc), rtol=1e-5)
        old, ref = train_state_from_jax(js, "mapping"), train_state_from_jax(new, "mapping")
        assert_adam_step(port.params, port.opt_state["mu"], old.opt_state["mu"], ref.opt_state["mu"], ref.params,
                         lr, lead=1, zero_grad=key_bias_slices(port.params))
        js = new
    images, labels = rng.random((b, 32, 32, 3), dtype=np.float32), rng.integers(0, CLASSES, b)
    got = evaluate(train_state_from_jax(js, "mapping").params, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_array_equal(t2n(got), np.asarray(jeval(js.params, images, labels)))
