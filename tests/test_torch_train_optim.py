"""The port's optimizers, schedules and bfloat16 low-memory state against
optax and ``ladine_tpu/train/{optim,lowmem}.py`` on the CPU.

Schedules agree with the JAX ones at float32 rounding (both evaluate in
float32 on an int32 count): rtol 1e-6 with atol 1e-6 of the base rate,
where ``1 + cos`` cancels. ``make_optimizer`` runs 5 updates of
the same parameters and gradients through both, unstacked and with 3
stacked members (the JAX side vmaps ``tx.update``, as the multi-member
step does) whose gradient norms straddle the clipping limit: parameters
and state agree to 1e-6 (the sums behind a clipping norm and Adam's
moments run in another order; each update moves a parameter by about
lr = 1e-2).

The bfloat16 state rounds stochastically from a torch generator, so it is
held to optax's float32 Adam and to ``ema_update`` by the statistics of
the rounding, with the tolerances stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ladine_tpu.train import lowmem as JL
from ladine_tpu.train import optim as JO
from ladine_tpu.train.ema import ema_update as jax_ema_update
from ladine_tpu_torch.train import lowmem as L
from ladine_tpu_torch.train import optim as O
from ladine_tpu_torch.train.ema import ema_update
from ladine_tpu_torch.utils.convert import _opt_from_optax
from torch_parity import j2t, t2n

SHAPES = {"w": (6, 5), "b": (5,), "g": (3, 2, 4)}


def _params(rng, lead=()):
    return {k: rng.standard_normal(lead + s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(rng, lead, norms):
    """Gradients whose global norm (per member when stacked) is ``norms``."""
    g = _params(rng, lead)
    sq = sum((v.reshape(*lead, -1) ** 2).sum(-1) for v in g.values())
    scale = np.asarray(norms, np.float32) / np.sqrt(sq)
    return {k: v * scale.reshape(scale.shape + (1,) * len(SHAPES[k])) for k, v in g.items()}


SCHEDULES = {
    "warmup_cosine": (lambda m: m.warmup_cosine(1e-3, 2, 10, 7, min_lr=1e-5), 100),
    "step_decay": (lambda m: m.step_decay(1e-3, 3, 0.5, 5), 200),
    "cosine_warm_restarts": (lambda m: m.cosine_warm_restarts(1e-3, 2, 5), 100),
    "cosine_warm_restarts_tmult2": (lambda m: m.cosine_warm_restarts(1e-3, 2, 5, t_mult=2, eta_min=1e-5), 100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    make, n = SCHEDULES[name]
    want = np.asarray(make(JO)(jnp.arange(n, dtype=jnp.int32)))
    got = t2n(make(O)(torch.arange(n, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def _jax_chain(name, clip, wd, lr):
    return JO.make_optimizer(name, lr, weight_decay=wd, grad_clip=clip)


def _run_both(name, clip, wd, lr_jax, lr_port, stacked):
    rng = np.random.default_rng(0)
    lead = (3,) if stacked else ()
    params = _params(rng, lead)
    tx, opt = _jax_chain(name, clip, wd, lr_jax), O.make_optimizer(name, lr_port, weight_decay=wd, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.vmap(tx.init)(jp) if stacked else tx.init(jp)
    update = jax.jit(jax.vmap(tx.update) if stacked else tx.update)
    pp = {k: j2t(v) for k, v in params.items()}
    ps = opt.init(pp, members=3 if stacked else None)
    for i in range(5):
        # members' norms straddle the limit 1.0; unstacked alternates
        g = _grads(rng, lead, [0.5, 2.0, 5.0] if stacked else [0.5, 3.0][i % 2])
        u, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(pp, {k: j2t(v) for k, v in g.items()}, ps)
    return jp, js, pp, ps


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked3"])
@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["nowd", "wd"])
@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", ["Adam", "AdamW", "RMSProp", "SGD"])
def test_make_optimizer_matches_optax(name, clip, wd, stacked):
    jp, js, pp, ps = _run_both(name, clip, wd, 1e-2, 1e-2, stacked)
    for k in SHAPES:
        np.testing.assert_allclose(t2n(pp[k]), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)
    table = [(k, ("params", k), None) for k in SHAPES]
    want = _opt_from_optax(js, table, np.full(3 if stacked else (), 5, np.int32))
    assert ps.keys() == want.keys()
    np.testing.assert_array_equal(ps["count"].numpy(), want["count"].numpy())
    for slot in set(ps) - {"count"}:
        for k in SHAPES:
            np.testing.assert_allclose(t2n(ps[slot][k]), t2n(want[slot][k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{slot}/{k}")


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_schedule_is_read_at_the_count_before_the_increment(name):
    """A schedule whose first value differs from every later one: the first
    update uses lr(0), as optax's ``scale_by_learning_rate`` does."""
    jp, js, pp, ps = _run_both(name, 1.0, 0.0, lambda c: jnp.where(c == 0, 1e-1, 1e-3),
                               lambda c: torch.where(c == 0, 1e-1, 1e-3), stacked=True)
    for k in SHAPES:
        np.testing.assert_allclose(t2n(pp[k]), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)


def test_each_member_is_clipped_by_its_own_norm():
    """Three stacked members with norms 0.5, 2 and 5 and limit 1: the first
    keeps its gradient, the others are scaled to norm 1; a norm over the
    stack (5.4) would have scaled all three."""
    rng = np.random.default_rng(3)
    g = {k: j2t(v) for k, v in _grads(rng, (3,), [0.5, 2.0, 5.0]).items()}
    scale = O.make_optimizer("SGD", 1.0, grad_clip=1.0).clip_scale(g, 3).flatten()
    np.testing.assert_allclose(scale.numpy(), [1.0, 0.5, 0.2], rtol=1e-6)


# ----------------------------------------------------------- bf16 low memory


def test_stochastic_rounding_is_unbiased():
    """Values between two bfloat16 neighbours, 20000 draws each: the mean
    of the draws is within 3 sigma of the float32 value, sigma =
    ulp * sqrt(p (1 - p) / n) with p the fraction of the ulp above the
    lower neighbour; every draw is one of the two neighbours."""
    base = torch.tensor([1.0, -3.0, 1e-3, 7.5e4]).bfloat16().float()
    ulp = torch.ldexp(torch.ones(4), torch.frexp(base).exponent - 8)
    frac = torch.tensor([0.1, 0.5, 0.77, 0.97])
    x = base + torch.sign(base) * frac * ulp
    n = 20000
    draws = L.bf16_stochastic_round(x.repeat(n, 1), torch.Generator().manual_seed(0)).float()
    sigma = ulp * torch.sqrt(frac * (1 - frac) / n)
    assert ((draws.mean(0) - x).abs() <= 3 * sigma).all(), (draws.mean(0) - x, sigma)
    assert ((draws == base) | (draws == base + torch.sign(base) * ulp)).all()


def test_stochastic_rounding_passes_representable_values_and_infinities():
    g = torch.Generator().manual_seed(1)
    x = torch.tensor([0.0, -0.0, 1.0, -2.5, 3.0e38, float("inf"), float("-inf")]).bfloat16().float()
    for _ in range(50):
        out = L.bf16_stochastic_round(x, g).float()
        assert torch.equal(out, x) and torch.equal(torch.signbit(out), torch.signbit(x))


def _nan_payloads():
    return torch.tensor([0x7FC00000, 0x7FFFFFFF, -1, 0x7F800001], dtype=torch.int32).view(torch.float32)


def test_nan_stays_nan_where_the_jax_rounding_wraps():
    """NaNs with every payload stay NaN in the port. The JAX rounding adds
    the bits before masking, so a payload near all ones carries out of the
    exponent: 0x7FFFFFFF becomes -0.0 and 0xFFFFFFFF +0.0 for most draws."""
    x = _nan_payloads().repeat(64)
    out = L.bf16_stochastic_round(x, torch.Generator().manual_seed(2))
    assert torch.isnan(out.float()).all()
    jax_out = np.asarray(JL.bf16_stochastic_round(jax.random.PRNGKey(0), jnp.asarray(x.numpy())), np.float32)
    assert not np.isnan(jax_out).all() and (jax_out == 0.0).any()


def test_members_and_runs_round_with_their_own_bits():
    """The port draws the rounding bits from the step's generator: two
    stacked members holding the same moments round differently, and so do
    two runs. The JAX ``scale_by_adam_bf16`` takes no key (a fixed seed and
    the count): two runs of the same update round alike."""
    g = torch.full((2, 4096), 1e-3)
    g[:, ::2] = 3e-3
    states = []
    for seed in (3, 4):
        opt = L.scale_by_adam_bf16()
        p = {"w": torch.zeros(2, 4096)}
        st = opt.init(p, members=2)
        opt.step(p, {"w": g}, st, torch.Generator().manual_seed(seed))
        states.append(st["nu"]["w"])
    assert not torch.equal(states[0][0], states[0][1])
    assert not torch.equal(states[0], states[1])
    tx = JL.scale_by_adam_bf16()
    p = {"w": jnp.zeros(4096)}
    runs = [tx.update({"w": jnp.asarray(g[0].numpy())}, tx.init(p), p)[1] for _ in range(2)]
    np.testing.assert_array_equal(np.asarray(runs[0].nu["w"], np.float32), np.asarray(runs[1].nu["w"], np.float32))


def test_adam_bf16_tracks_fp32_adam():
    """20 steps of ``adam_bf16`` against optax's float32 Adam from the same
    start on the same gradients: each moment store rounds within one
    bfloat16 ulp (2^-8 relative), unbiased, so the parameters stay within
    2e-3 of the float32 run (measured 4.6e-4; a step moves them by lr =
    1e-2) and the moments within 2 % of their scale (measured 1.1 %)."""
    rng = np.random.default_rng(4)
    params = _params(rng, (2,))
    tx = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.vmap(tx.init)(jp)
    opt = L.adam_bf16(1e-2)
    pp = {k: j2t(v) for k, v in params.items()}
    ps = opt.init(pp, members=2)
    g = torch.Generator().manual_seed(5)
    for _ in range(20):
        grads = _grads(rng, (2,), [1.0, 3.0])
        u, js = jax.vmap(tx.update)(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(pp, {k: j2t(v) for k, v in grads.items()}, ps, g)
    for k in SHAPES:
        assert ps["mu"][k].dtype == torch.bfloat16
        np.testing.assert_allclose(t2n(pp[k]), np.asarray(jp[k]), atol=2e-3, err_msg=k)
        mu, nu = np.asarray(js[0].mu[k]), np.asarray(js[0].nu[k])
        np.testing.assert_allclose(t2n(ps["mu"][k]), mu, atol=0.02 * np.abs(mu).max(), err_msg=k)
        np.testing.assert_allclose(t2n(ps["nu"][k]), nu, atol=0.02 * np.abs(nu).max(), err_msg=k)


def test_ema_update_sr_tracks_ema_update():
    """20 bfloat16 EMA updates at mu = 0.9 against the float32
    ``ema_update``: within 2 bfloat16 ulps of the float32 shadow."""
    rng = np.random.default_rng(6)
    ema32 = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    ema16 = L.ema_init_bf16({k: torch.zeros(s) for k, s in SHAPES.items()})
    g = torch.Generator().manual_seed(7)
    for _ in range(20):
        p = _params(rng)
        ema32 = jax_ema_update(ema32, jax.tree.map(jnp.asarray, p), 0.9)
        L.ema_update_sr(ema16, {k: j2t(v) for k, v in p.items()}, 0.9, g)
    for k in SHAPES:
        want = np.asarray(ema32[k])
        np.testing.assert_allclose(t2n(ema16[k]), want, atol=2 * 2.0**-8 * np.abs(want).max(), err_msg=k)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(8)
    e, p = _params(rng), _params(rng)
    want = jax_ema_update(jax.tree.map(jnp.asarray, e), jax.tree.map(jnp.asarray, p), 0.9999)
    got = {k: j2t(v) for k, v in e.items()}
    ema_update(got, {k: j2t(v) for k, v in p.items()}, 0.9999)
    for k in SHAPES:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_lowmem_optimizer_needs_a_generator():
    p = {"w": torch.zeros(3)}
    opt = O.make_optimizer("Adam", lowmem=True)
    with pytest.raises(ValueError, match="generator"):
        opt.step(p, {"w": torch.ones(3)}, opt.init(p))
