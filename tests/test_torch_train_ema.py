"""The port's EMA against ``ladine_tpu/train/ema.py`` on the CPU: the
update and the debiased read are the JAX package's (rtol 1e-6, atol 1e-7:
float32 rounding of averages of unit-scale values). The read keeps the JAX
package's bias (``ROADMAP.md`` §3 F4): with mu = 0.9999 in float32 the
update's weights sum to (1 - mu)_f32 / (1 - mu_f32) = 0.999834 of what the
read divides by, so both reads return 0.999834 of the average.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.train import ema as JE
from ladine_tpu_torch.train import ema as E
from torch_parity import j2t, t2n

MU = 0.9999
BIAS = float(np.float32(1.0 - MU)) / (1.0 - float(np.float32(MU)))  # 0.999834


def _tree(rng, lead=()):
    return {"w": rng.standard_normal(lead + (4, 3)).astype(np.float32),
            "b": rng.standard_normal(lead + (3,)).astype(np.float32)}


def _accumulate(params_seq, lead=()):
    """Both frameworks' accumulators after updating on each of params_seq."""
    je = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, params_seq[0]))
    pe = E.ema_init({k: j2t(v) for k, v in params_seq[0].items()})
    for p in params_seq:
        je = JE.ema_update(je, jax.tree.map(jnp.asarray, p), MU)
        E.ema_update(pe, {k: j2t(v) for k, v in p.items()}, MU)
    return je, pe


def test_ema_init_is_zero_and_fresh():
    p = {"w": torch.ones(3), "b": torch.ones(2)}
    e = E.ema_init(p)
    assert all((v == 0).all() and v.data_ptr() != p[k].data_ptr() for k, v in e.items())


@pytest.mark.parametrize("steps", [1, 3, 40])
def test_debiased_read_matches_jax(steps):
    rng = np.random.default_rng(steps)
    je, pe = _accumulate([_tree(rng) for _ in range(steps)])
    for k in pe:
        np.testing.assert_allclose(t2n(pe[k]), np.asarray(je[k]), rtol=1e-6, atol=1e-7)
    want = JE.ema_debias(je, MU, steps)
    got = E.ema_debias(pe, MU, steps)
    for k in got:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_debiased_read_at_step_1_keeps_the_reference_bias():
    """F4: after one update both reads give (1 - mu)_f32 / (1 - mu_f32) =
    0.999834 of the parameters, where the average is the parameters."""
    p = _tree(np.random.default_rng(0))
    je, pe = _accumulate([p])
    got, want = E.ema_debias(pe, MU, 1), JE.ema_debias(je, MU, 1)
    assert abs(BIAS - 0.999834) < 1e-6
    for k in p:
        np.testing.assert_allclose(t2n(got[k]), p[k] * BIAS, rtol=3e-7, atol=0)
        np.testing.assert_allclose(np.asarray(want[k]), p[k] * BIAS, rtol=3e-7, atol=0)


def test_step_zero_returns_the_accumulator():
    e = {"w": torch.full((2, 2), 0.5)}
    assert torch.equal(E.ema_debias(e, MU, 0)["w"], e["w"])


def test_ema_read_modes():
    e = {"w": torch.full((2,), 0.25)}
    assert E.ema_read(e, MU, 7, "legacy") is e
    np.testing.assert_allclose(t2n(E.ema_read(e, MU, 7, "zero")["w"]),
                               np.asarray(JE.ema_read({"w": jnp.full((2,), 0.25)}, MU, 7, "zero")["w"]),
                               rtol=1e-6)


def test_ema_params_from_ckpt_stacked_with_per_member_steps():
    """A stacked checkpoint whose three members took 1, 5 and 300 steps:
    each member debiased by its own count, as the JAX read vmaps."""
    rng = np.random.default_rng(1)
    ema = _tree(rng, (3,))
    steps = np.array([1, 5, 300], np.int32)
    meta = {"ema_init": "zero", "ema_rate": MU}
    want = JE.ema_params_from_ckpt({"ema": jax.tree.map(jnp.asarray, ema), "step": steps}, meta)
    got = E.ema_params_from_ckpt({"ema": {k: j2t(v) for k, v in ema.items()}, "step": torch.from_numpy(steps)}, meta)
    for k in ema:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=1e-6)
    legacy = {"ema": {k: j2t(v) for k, v in ema.items()}, "step": torch.from_numpy(steps)}
    assert E.ema_params_from_ckpt(legacy, {}) is legacy["ema"]
    with pytest.raises(ValueError, match="step"):
        E.ema_params_from_ckpt({"ema": legacy["ema"]}, meta)


def test_bf16_accumulator_reads_in_bf16():
    """A bfloat16 accumulator reads back in bfloat16, the product rounded
    once (the JAX read's ``astype``)."""
    e = {"w": torch.tensor([1e-4, -3e-4]).bfloat16()}
    got = E.ema_debias(e, MU, 1)["w"]
    assert got.dtype == torch.bfloat16
    want = (e["w"].float() * E.debias_scale(MU, 1)).bfloat16()
    assert torch.equal(got, want)
