"""The port's diffusion trainer against ``ladine_tpu/train/diffusion_trainer.py``
on the CPU, at the widths of ``configs/synthetic_tiny.yml`` (images 32 x 32,
feature = hidden = 32, 50 timesteps, batch 16; the guidance ViT of embed 32,
patch 8, 5 blocks, 2 heads, MLPs 32-16-8).

Each step starts both sides from the same JAX train state (carried over
by ``utils/convert.py::member_state_from_jax`` before every step) and
gives both the JAX draws (``tests/torch_parity.py::jax_multi_draws``). In
float32, for each of 3 steps: losses agree to rel 1e-5; the new
parameters, running statistics, Adam's moments and count, the EMA and the
step to abs 1e-5. (Run free, the two drift apart through Adam: an element
stepped differently once changes every later gradient a little, and Adam
normalizes small gradients, so each step is compared from one state.)

Adam's moments are held to abs 1e-5, and the step's gradient, read off the
first moments (g = (mu_new - 0.9 mu_old) / 0.1), to 1e-4 of JAX's in norm,
a member at a time (``tests/torch_parity.py::assert_adam_step``). One
exception in the parameters, where Adam's step is ill-conditioned and both
frameworks are right: an element whose gradient in the step is at the
noise floor, |g| < 1e-6 (100 x Adam's eps). There Adam's step g/(|g| + eps)
turns a rounding difference of g into a step difference, so such elements
are held to Adam's largest step instead, 3.2 lr ((1 - b1)/sqrt(1 - b2)), so
6.4 lr between the two frameworks, and at most 1e-3 of a leaf (at least one
element) may use that room. The biases of enc_lin1, enc_lin2 and enc_lin3
feed a train-mode BatchNorm that subtracts the batch mean: their exact
gradient is zero, both frameworks compute rounding noise (|g| ~ 1e-9), and
they are left out of the count (and of the gradient check). Measured: in
the first member step, 3 of enc_lin1's 98304 weights, whose gradients read
-1.74e-8 in the port and -1.61e-8 in JAX, stepped 1.9e-5 apart; over every
step of this file at most 11 of enc_lin1's 294912 weights and 1 of lin2's
96 biases step apart. In the joint step the guidance ViT's key biases are
exact zeros too (softmax does not see a constant added to every key's
score).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.models import ConditionalModel as JaxModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu.ops.labels import one_hot_and_prototype as jax_one_hot
from ladine_tpu.train import diffusion_trainer as JT
from ladine_tpu.train.optim import make_optimizer as jax_make_optimizer
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.ops import DiffusionSchedule, antithetic_timesteps, one_hot_and_prototype, q_sample
from ladine_tpu_torch.train import diffusion_trainer as T
from ladine_tpu_torch.train.optim import make_optimizer
from ladine_tpu_torch.utils import guidance_from_flax, member_state_from_jax, members_from_flax
from ladine_tpu_torch.utils.convert import _guidance_table, _opt_from_optax, _param_entries
from torch_parity import assert_adam_step, j2t, jax_member_draws, jax_multi_draws, key_bias_slices, t2n

T_STEPS, B, IMG, LR = 50, 16, 32, 1e-3
DATA_DIM = IMG * IMG * 3
MEMBER = dict(feature_dim=32, hidden_dim=32, y_dim=2, n_steps=T_STEPS + 1)
GUIDANCE = dict(num_classes=2, num_members=3, vit_depth=5, img_size=IMG, patch_size=8, embed_dim=32,
                num_heads=2, mlp_hidden_dims=(32, 16, 8))
LOSS_REL, GRAD_REL = 2.3e-3, 2.6e-2  # measured bf16 gaps (test_bf16_member_step_against_the_jax_bf16_module)
PRE_BN = {"enc_lin1.bias": "enc_bn1", "enc_lin2.bias": "enc_bn2", "enc_lin3.bias": "norm"}


def jax_model(dtype=None):
    return JaxModel(data_dim=DATA_DIM, dtype=dtype, **MEMBER)


def port_model(members, dtype=torch.float32):
    """The compute module: its dtypes only (no storage)."""
    return ConditionalModel(members, DATA_DIM, MEMBER["feature_dim"], MEMBER["hidden_dim"], MEMBER["y_dim"],
                            MEMBER["n_steps"], device="meta", dtype=dtype)


def schedules():
    return (JaxSchedule.create("linear", T_STEPS, 1e-4, 0.02),
            DiffusionSchedule.create("linear", T_STEPS, 1e-4, 0.02, device="cpu"))


def batch(rng):
    images = rng.random((B, IMG, IMG, 3), dtype=np.float32)
    return images, rng.integers(0, 2, B)


def assert_step_matches(port, js_old, js_new):
    """The float32 bar of the module docstring, for one member step."""
    old, ref = member_state_from_jax(js_old), member_state_from_jax(js_new)
    assert_adam_step(port.params, port.opt_state["mu"], old.opt_state["mu"], ref.opt_state["mu"], ref.params,
                     LR, lead=1, zero_grad={k: ... for k in PRE_BN})
    for part in ("batch_stats", "ema"):
        for k, v in getattr(ref, part).items():
            np.testing.assert_allclose(t2n(getattr(port, part)[k]), t2n(v), rtol=0, atol=1e-5, err_msg=k)
    for slot in ("mu", "nu"):
        for k, v in ref.opt_state[slot].items():
            np.testing.assert_allclose(t2n(port.opt_state[slot][k]), t2n(v), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(port.opt_state["count"].numpy(), ref.opt_state["count"].numpy())
    np.testing.assert_array_equal(port.step.numpy(), ref.step.numpy())


# -------------------------------------------------------------- small pieces


def test_one_hot_and_prototype_matches_jax():
    labels = np.array([0, 1, 2, 1, 0])
    oh, proto = one_hot_and_prototype(torch.from_numpy(labels), 3)
    joh, jproto = jax_one_hot(jnp.asarray(labels), 3)
    np.testing.assert_array_equal(t2n(oh), np.asarray(joh))
    np.testing.assert_allclose(t2n(proto), np.asarray(jproto), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 6, 7])
def test_antithetic_timesteps_mirror(n):
    t = antithetic_timesteps(torch.Generator().manual_seed(n), n, 50, (3,))
    assert t.shape == (3, n) and t.dtype == torch.int64 and ((t >= 0) & (t < 50)).all()
    half = n // 2 + 1
    mirrored = t[:, half:]
    np.testing.assert_array_equal(mirrored.numpy(), 49 - t[:, : mirrored.shape[1]].numpy())


def test_q_sample_takes_a_timestep_per_row():
    _, sched = schedules()
    rng = np.random.default_rng(0)
    y0, y0_hat, noise = (torch.from_numpy(rng.standard_normal((2, 4, 2)).astype(np.float32)) for _ in range(3))
    t = torch.tensor([[0, 5, 49, 7], [3, 3, 1, 20]])
    got = q_sample(y0, y0_hat, sched, t, noise)
    for m in range(2):
        for r in range(4):
            want = q_sample(y0[m, r], y0_hat[m, r], sched, int(t[m, r]), noise[m, r])
            torch.testing.assert_close(got[m, r], want.reshape(2), rtol=0, atol=0)


def test_train_mode_forward_matches_flax():
    """One train-mode forward of 3 members at per-row timesteps: eps and the
    new running statistics equal flax's ``mutable=["batch_stats"]`` apply
    (rtol 1e-5, atol 1e-6)."""
    js = JT.create_member_states(jax_model(), jax.random.PRNGKey(0), jax_make_optimizer("Adam"), 3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, DATA_DIM)).astype(np.float32)
    y = rng.standard_normal((3, B, 2)).astype(np.float32)
    yh = jax.nn.softmax(jnp.asarray(rng.standard_normal((3, B, 2)), jnp.float32))
    t = rng.integers(0, T_STEPS + 1, (3, B))

    def one(params, bs, y, yh, t):
        return jax_model().apply({"params": params, "batch_stats": bs}, x, y, t, yh, train=True,
                                 mutable=["batch_stats"])

    eps, mutated = jax.vmap(one)(js.params, js.batch_stats, y, yh, jnp.asarray(t))
    model = ConditionalModel(3, DATA_DIM, 32, 32, 2, T_STEPS + 1, device="cpu")
    model.load_state_dict(members_from_flax(jax.tree.map(np.asarray, {"params": js.params,
                                                                      "batch_stats": js.batch_stats})))
    got, stats = model(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t), j2t(yh), train=True)
    np.testing.assert_allclose(t2n(got), np.asarray(eps), rtol=1e-5, atol=1e-6)
    want = members_from_flax(jax.tree.map(np.asarray, {"params": js.params, "batch_stats": mutated["batch_stats"]}))
    for k, v in stats.items():
        np.testing.assert_allclose(t2n(v), t2n(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_eval_forward_is_encode_then_eps():
    """``forward`` without ``train`` is the serving path: ``eps`` of
    ``encode`` at one int timestep (on the CPU, the kernels' plain versions)."""
    model = ConditionalModel(2, 12, 8, 8, 2, 11, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    x, y, yh = torch.randn(3, 12), torch.randn(2, 3, 2), torch.softmax(torch.randn(2, 3, 2), -1)
    torch.testing.assert_close(model(x, y, 4, yh), model.eps(model.encode(x), y, 4, yh), rtol=0, atol=0)


# ------------------------------------------------------------------ the steps


def member_batch(rng, members):
    x = rng.standard_normal((B, DATA_DIM)).astype(np.float32)
    y0 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    yh = np.array(jax.nn.softmax(rng.standard_normal((members, B, 2)).astype(np.float32)))
    return x, y0, yh


@pytest.mark.parametrize("noise_prior", [False, True], ids=["prior", "noise_prior"])
def test_member_step_matches_jax(noise_prior):
    jsched, sched = schedules()
    tx = jax_make_optimizer("Adam", LR)
    js = JT.create_member_state(jax_model(), jax.random.PRNGKey(1), tx, batch_size=2)
    jstep = jax.jit(JT.make_member_step(jax_model(), tx, jsched, noise_prior=noise_prior))
    step = T.make_member_step(port_model(1), make_optimizer("Adam", LR), sched, noise_prior=noise_prior)
    stacked = lambda st: jax.tree.map(lambda v: v[None], st)  # noqa: E731
    rng = np.random.default_rng(2)
    for i in range(3):
        x, y0, yh = member_batch(rng, 1)
        key = jax.random.PRNGKey(10 + i)
        port = member_state_from_jax(stacked(js))
        js_new, jl = jstep(js, x, y0, yh[0], key)
        t, noise = jax_member_draws(key, B, T_STEPS, 2)
        port, loss = step(port, torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(yh[0]), t=t, noise=noise)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert_step_matches(port, stacked(js), stacked(js_new))
        js = js_new


def test_multi_member_step_matches_jax():
    jsched, sched = schedules()
    tx = jax_make_optimizer("Adam", LR)
    js = JT.create_member_states(jax_model(), jax.random.PRNGKey(2), tx, 3)
    jstep = jax.jit(JT.make_multi_member_step(jax_model(), tx, jsched))
    step = T.make_multi_member_step(port_model(3), make_optimizer("Adam", LR), sched)
    rng = np.random.default_rng(3)
    for i in range(3):
        x, y0, yh = member_batch(rng, 3)
        key = jax.random.PRNGKey(20 + i)
        port = member_state_from_jax(js)
        js_new, jl = jstep(js, x, y0, yh, key)
        t, noise = jax_multi_draws(key, 3, B, T_STEPS, 2)
        port, losses = step(port, torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(yh), t=t, noise=noise)
        np.testing.assert_allclose(t2n(losses), np.asarray(jl), rtol=1e-5)
        assert_step_matches(port, js, js_new)
        js = js_new


@pytest.fixture(scope="module")
def guidance_pair():
    jg = JaxGuidance(**GUIDANCE)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))
    g = SEViTGuidance(**GUIDANCE, device="cpu")
    g.load_state_dict(guidance_from_flax(gvars))
    return jg, gvars, g


@pytest.mark.parametrize("heads,noise_prior", [(None, False), ((1,), True)], ids=["all_heads", "head1_noise_prior"])
def test_full_train_step_matches_jax(guidance_pair, heads, noise_prior):
    jg, gvars, g = guidance_pair
    jsched, sched = schedules()
    m = 3 if heads is None else len(heads)
    tx = jax_make_optimizer("Adam", LR)
    js = JT.create_member_states(jax_model(), jax.random.PRNGKey(3), tx, m)
    jstep = jax.jit(JT.make_full_train_step(jg, jax_model(), tx, jsched, m, 2, head_indices=heads,
                                            noise_prior=noise_prior))
    step = T.make_full_train_step(g, port_model(m), make_optimizer("Adam", LR), sched, m, 2,
                                  head_indices=heads, noise_prior=noise_prior)
    rng = np.random.default_rng(4)
    for i in range(3):
        images, labels = batch(rng)
        key = jax.random.PRNGKey(30 + i)
        port = member_state_from_jax(js)
        js_new, jl = jstep(js, gvars, images, labels, key)
        t, noise = jax_multi_draws(key, m, B, T_STEPS, 2)
        port, losses = step(port, torch.from_numpy(images), torch.from_numpy(labels), t=t, noise=noise)
        np.testing.assert_allclose(t2n(losses), np.asarray(jl), rtol=1e-5)
        assert_step_matches(port, js, js_new)
        js = js_new


def test_joint_train_step_matches_jax(guidance_pair):
    """The members as above; the guidance's cross-entropy loss to rel 1e-5,
    its new parameters by the same Adam bar and its Adam moments to abs
    1e-5, each step from the same state."""
    jg, gvars, g = guidance_pair
    jsched, sched = schedules()
    tx, aux = jax_make_optimizer("Adam", LR), jax_make_optimizer("Adam", LR)
    js = JT.create_member_states(jax_model(), jax.random.PRNGKey(4), tx, 3)
    gparams = jax.tree.map(jnp.asarray, gvars["params"])
    aux_state = aux.init(gparams)
    jstep = jax.jit(JT.make_joint_train_step(jg, jax_model(), tx, aux, jsched, 3, 2))
    p_aux_tx = make_optimizer("Adam", LR)
    step = T.make_joint_train_step(g, port_model(3), make_optimizer("Adam", LR), p_aux_tx, sched, 3, 2)
    table = _param_entries(_guidance_table(gvars["params"]))
    rng = np.random.default_rng(5)
    for i in range(3):
        images, labels = batch(rng)
        key = jax.random.PRNGKey(40 + i)
        port = member_state_from_jax(js)
        pg = guidance_from_flax({"params": jax.tree.map(np.asarray, gparams)})
        aux_old = _opt_from_optax(aux_state, table, i)
        p_aux = {k: v if k == "count" else {n: t.clone() for n, t in v.items()} for k, v in aux_old.items()}
        js_new, gparams, aux_state, jaux, jl = jstep(js, gparams, aux_state, images, labels, key)
        t, noise = jax_multi_draws(key, 3, B, T_STEPS, 2)
        port, pg, p_aux, paux, losses = step(port, pg, p_aux, torch.from_numpy(images), torch.from_numpy(labels),
                                             t=t, noise=noise)
        np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)
        np.testing.assert_allclose(t2n(losses), np.asarray(jl), rtol=1e-5)
        assert_step_matches(port, js, js_new)
        aux_new = _opt_from_optax(aux_state, table, i + 1)
        assert_adam_step(pg, p_aux["mu"], aux_old["mu"], aux_new["mu"],
                         guidance_from_flax({"params": jax.tree.map(np.asarray, gparams)}), LR,
                         zero_grad=key_bias_slices(pg))
        for slot in ("mu", "nu"):
            for k, v in aux_new[slot].items():
                np.testing.assert_allclose(t2n(p_aux[slot][k]), t2n(v), rtol=0, atol=1e-5, err_msg=f"{slot}/{k}")
        js = js_new


def test_bf16_member_step_against_the_jax_bf16_module():
    """bfloat16 compute (float32 masters, Adam and EMA) against flax's
    ``ConditionalModel(dtype=bfloat16)``, each step from the same state:
    the products round to bfloat16 in both (2^-8 relative) but sum in
    another order. Measured over 3 steps of 3 members: losses within
    LOSS_REL (relative) of each other and each leaf's gradient (from Adam's
    mu) within GRAD_REL of its norm; held to twice that. The JAX bfloat16
    gradient itself is 1.7-1.9 % from the JAX float32 one at these widths,
    so the two bfloat16 steps are as far apart as each is from float32."""
    jsched, sched = schedules()
    tx = jax_make_optimizer("Adam", LR)
    js = JT.create_member_states(jax_model(jnp.bfloat16), jax.random.PRNGKey(2), tx, 3)
    jstep = jax.jit(JT.make_multi_member_step(jax_model(jnp.bfloat16), tx, jsched))
    step = T.make_multi_member_step(port_model(3, torch.bfloat16), make_optimizer("Adam", LR), sched)
    rng = np.random.default_rng(3)
    worst_loss, worst_grad = 0.0, 0.0
    for i in range(3):
        x, y0, yh = member_batch(rng, 3)
        key = jax.random.PRNGKey(20 + i)
        port = member_state_from_jax(js)
        old = member_state_from_jax(js)
        js, jl = jstep(js, x, y0, yh, key)
        t, noise = jax_multi_draws(key, 3, B, T_STEPS, 2)
        port, losses = step(port, torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(yh), t=t, noise=noise)
        worst_loss = max(worst_loss, float(np.max(np.abs(t2n(losses) / np.asarray(jl) - 1))))
        ref = member_state_from_jax(js)
        for k, v in ref.opt_state["mu"].items():
            if k in PRE_BN:
                continue  # exact gradient zero: noise in both
            g_ref = (v - 0.9 * old.opt_state["mu"][k]) / 0.1
            g_port = (port.opt_state["mu"][k] - 0.9 * old.opt_state["mu"][k]) / 0.1
            worst_grad = max(worst_grad, float((g_port - g_ref).norm() / g_ref.norm()))
    assert worst_loss <= 2 * LOSS_REL and worst_grad <= 2 * GRAD_REL


# ------------------------------------------------------------------- hand-off


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "raw"])
def test_hand_off_builds_the_serving_module(use_ema):
    """After 2 steps the hand-off's module holds the debiased EMA (or the
    raw parameters) and the running statistics, in the asked dtype, and
    ``Predictor`` serves it."""
    from ladine_tpu_torch.infer import Predictor
    from ladine_tpu_torch.train.ema import ema_debias

    _, sched = schedules()
    model = port_model(2)
    tx = make_optimizer("Adam", LR)
    state = T.create_member_states(model, torch.Generator().manual_seed(0), tx, 2, device="cpu")
    step = T.make_multi_member_step(model, tx, sched)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, _ = step(state, torch.randn(B, DATA_DIM, generator=g), torch.eye(2)[torch.randint(0, 2, (B,), generator=g)],
                        torch.softmax(torch.randn(2, B, 2, generator=g), -1), g)
    for dtype in (torch.float32, torch.bfloat16):
        out = T.conditional_model_from_state(state, use_ema=use_ema, dtype=dtype, device="cpu")
        src = ema_debias(state.ema, 0.9999, state.step) if use_ema else state.params
        sd = out.state_dict()
        for k, v in src.items():
            assert sd[k].dtype == (torch.float32 if "bn" in k or "norm" in k or k.endswith("embed") else dtype), k
            torch.testing.assert_close(sd[k], v.to(sd[k].dtype), rtol=0, atol=0)
        for k, v in state.batch_stats.items():
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    guidance = SEViTGuidance(**{**GUIDANCE, "num_members": 2}, device="cpu")
    pred = Predictor(guidance=guidance, model=out, sched=sched, mc_trials=2, ddim_steps=5, device="cpu")
    res = pred.predict(np.random.default_rng(0).random((3, IMG, IMG, 3), dtype=np.float32))
    assert np.isfinite(res["probs"]).all() and res["probs"].shape == (3, 2)


def test_create_member_states_are_independent_and_reproducible():
    model = port_model(3)
    tx = make_optimizer("Adam", LR, lowmem=True)
    a = T.create_member_states(model, torch.Generator().manual_seed(7), tx, 3, lowmem=True, device="cpu")
    b = T.create_member_states(model, torch.Generator().manual_seed(7), tx, 3, lowmem=True, device="cpu")
    w = a.params["enc_lin1.weight"]
    assert w.shape == (3, DATA_DIM, 32) and w.dtype == torch.float32
    assert not torch.equal(w[0], w[1]) and torch.equal(w, b.params["enc_lin1.weight"])
    assert a.ema["lin1.embed"].dtype == torch.bfloat16 and a.opt_state["mu"]["lin2.linear.weight"].dtype == torch.bfloat16
    assert (a.batch_stats["norm.running_var"] == 1).all() and a.step.tolist() == [0, 0, 0]
    bound = DATA_DIM**-0.5
    assert w.abs().max() <= bound and ((a.params["lin1.embed"] >= 0) & (a.params["lin1.embed"] < 1)).all()


def test_lowmem_step_moves_everything_and_needs_a_generator():
    """A lowmem member step (bfloat16 Adam moments and EMA) moves the
    parameters, statistics, moments and counts; without a generator it
    refuses (its stochastic rounding has nothing to draw from)."""
    _, sched = schedules()
    model = port_model(2)
    tx = make_optimizer("Adam", LR, lowmem=True)
    state = T.create_member_states(model, torch.Generator().manual_seed(0), tx, 2, lowmem=True, device="cpu")
    before = {k: v.clone() for k, v in state.params.items()}
    step = T.make_multi_member_step(model, tx, sched)
    x, y0 = torch.randn(B, DATA_DIM), torch.eye(2)[torch.randint(0, 2, (B,))]
    yh = torch.full((2, B, 2), 0.5)
    t, noise = torch.randint(0, T_STEPS, (2, B)), torch.randn(2, B, 2)
    with pytest.raises(ValueError, match="generator"):
        step(state, x, y0, yh, t=t, noise=noise)
    state, losses = step(state, x, y0, yh, torch.Generator().manual_seed(1))
    assert torch.isfinite(losses).all() and state.step.tolist() == [1, 1]
    assert not torch.equal(before["lin2.linear.weight"], state.params["lin2.linear.weight"])
    assert (state.ema["lin2.linear.weight"] != 0).any() and (state.batch_stats["norm.running_mean"] != 0).any()
