"""ladine_tpu_torch ops and metrics against ladine_tpu on the CPU.

Tolerances: both sides compute in float32 from the same float64 host
schedule, so schedule tensors must be equal; the samplers differ only in
how the two libraries evaluate the same float32 expressions (rtol 1e-5);
the oracle chain must return its y0 to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.metrics.classification import convert_to_prob as jax_convert_to_prob
from ladine_tpu.metrics.classification import majority_vote as jax_majority_vote
from ladine_tpu.ops import diffusion as jd
from ladine_tpu.ops.schedules import DiffusionSchedule as JaxSchedule
from ladine_tpu.ops.schedules import make_beta_schedule as jax_make_beta_schedule
from ladine_tpu_torch.metrics import convert_to_prob, majority_vote
from ladine_tpu_torch.ops import diffusion as td
from ladine_tpu_torch.ops.schedules import DiffusionSchedule, make_beta_schedule
from torch_parity import j2t, jax_loop_noise, t2n

SCHEDULES = ("linear", "const", "quad", "jsd", "sigmoid", "cosine", "cosine_reverse",
             "cosine_anneal")


@pytest.mark.parametrize("name", SCHEDULES)
def test_beta_schedules_match(name):
    np.testing.assert_array_equal(
        make_beta_schedule(name, 50, 1e-4, 0.02), jax_make_beta_schedule(name, 50, 1e-4, 0.02)
    )


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_schedule_create_matches(name):
    ours = DiffusionSchedule.create(name, 100, 1e-4, 0.02, device="cpu")
    ref = JaxSchedule.create(name, 100, 1e-4, 0.02)
    assert ours.num_timesteps == ref.num_timesteps == 100
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(t2n(a), np.asarray(b))


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown beta schedule"):
        make_beta_schedule("nope")


def _scheds(T=20):
    return DiffusionSchedule.create("linear", T, 1e-4, 0.02, device="cpu"), JaxSchedule.create(
        "linear", T, 1e-4, 0.02
    )


def test_p_sample_coefficients_and_q_sample():
    ours, ref = _scheds()
    for t in (1, 7, 19):
        for a, b in zip(td.p_sample_coefficients(ours, t), jd.p_sample_coefficients(ref, t)):
            np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-6)
    # the vectorised form the loop uses equals the per-step one
    vec = td.p_sample_coefficients(ours, torch.tensor([1, 7, 19]))
    for j, t in enumerate((1, 7, 19)):
        for a, b in zip(vec, td.p_sample_coefficients(ours, t)):
            assert float(a[j]) == float(b)

    rng = np.random.default_rng(0)
    y0, yh, nz = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3))
    t = np.array([0, 5, 11, 19])
    out = td.q_sample(j2t(y0), j2t(yh), ours, torch.from_numpy(t), j2t(nz))
    ref_out = jd.q_sample(jnp.asarray(y0), jnp.asarray(yh), ref, jnp.asarray(t), jnp.asarray(nz))
    np.testing.assert_allclose(t2n(out), np.asarray(ref_out), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("skip", ["uniform", "quad"])
def test_ddim_timesteps_match(skip):
    np.testing.assert_array_equal(
        td.ddim_timesteps(1000, 50, skip).numpy(), np.asarray(jd.ddim_timesteps(1000, 50, skip))
    )
    with pytest.raises(ValueError):
        td.ddim_timesteps(10, 5, "cubic")


def _oracle(sched, y0, m, lib):
    """eps that reproduces y0 exactly under the mean-shifted process."""
    sqrt = torch.sqrt if lib is torch else jnp.sqrt

    def eps_fn(y, t):
        ab = sched.alphas_bar[t]
        return (y - sqrt(ab) * y0 - (1.0 - sqrt(ab)) * m) / sqrt(1.0 - ab)

    return eps_fn


@pytest.mark.parametrize("sampler", ["ancestral", "ddim0", "ddim1"])
def test_sample_loops_match_jax_with_injected_noise(sampler):
    ours, ref = _scheds(T=20)
    rng = np.random.default_rng(1)
    y0 = rng.standard_normal((3, 2)).astype(np.float32)
    m = np.abs(rng.standard_normal((3, 2))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    if sampler == "ancestral":
        noise = jax_loop_noise(key, (3, 2), 20)
        got = td.p_sample_loop(_oracle(ours, j2t(y0), j2t(m), torch), j2t(m), ours, None, j2t(noise))
        want = jd.p_sample_loop(_oracle(ref, jnp.asarray(y0), jnp.asarray(m), jnp),
                                jnp.asarray(m), ref, key)
    else:
        eta = float(sampler[-1])
        tau = td.ddim_timesteps(20, 6)
        noise = jax_loop_noise(key, (3, 2), len(tau))
        got = td.ddim_sample_loop(_oracle(ours, j2t(y0), j2t(m), torch), j2t(m), ours, None,
                                  tau, eta, j2t(noise))
        want = jd.ddim_sample_loop(_oracle(ref, jnp.asarray(y0), jnp.asarray(m), jnp),
                                   jnp.asarray(m), ref, key, jd.ddim_timesteps(20, 6), eta)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2n(got), y0, rtol=1e-4, atol=1e-4)


def test_loop_rejects_misshapen_noise():
    ours, _ = _scheds(T=5)
    with pytest.raises(ValueError, match="noise must have shape"):
        td.p_sample_loop(lambda y, t: y, torch.zeros(2, 2), ours, None, torch.zeros(4, 2, 2))


def test_loop_generator_reproducible():
    ours, _ = _scheds(T=5)
    run = lambda s: td.p_sample_loop(  # noqa: E731
        lambda y, t: 0.1 * y, torch.zeros(3, 2), ours, torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_convert_to_prob_and_majority_vote_match():
    samples = np.random.default_rng(2).standard_normal((7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(convert_to_prob(j2t(samples), 0.2)),
        np.asarray(jax_convert_to_prob(jnp.asarray(samples), 0.2)), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        majority_vote(j2t(samples)).numpy(), np.asarray(jax_majority_vote(jnp.asarray(samples))))


def test_majority_vote_ties_go_to_smallest_class():
    # image 0: 2 votes for class 2 and 2 for class 0 -> 0; image 1: plurality
    # of class 0 -> 0; image 2: 2 for class 1 and 2 for class 2 -> 1
    onehot = np.eye(3, dtype=np.float32)
    votes = [[2, 0, 1], [0, 1, 2], [2, 2, 1], [0, 0, 2]]  # (S=4, B=3) argmax classes
    samples = onehot[np.array(votes)]  # (4, 3, 3)
    got = majority_vote(j2t(samples)).numpy()
    np.testing.assert_array_equal(got, [0, 0, 1])
    np.testing.assert_array_equal(got, np.asarray(jax_majority_vote(jnp.asarray(samples))))
