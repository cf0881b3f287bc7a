"""The plain reference (portbench/reference/ladine.py) against the port's
``Predictor.predict(device="cpu")``, at ``configs/synthetic_tiny.yml``'s
widths, on the same weights, images and draws, at both presets."""

import numpy as np
import pytest
import torch

from pb_tiny import tiny_config
from portbench import judge
from portbench.families import ladine as family
from portbench.reference import ladine as reference


def _both(name, dtype, seed=20260001, batch=6):
    cfg = tiny_config(name, dtype)
    weights = family.make_weights(cfg, seed, "cpu")
    pred = family.build(cfg, weights, "cpu")
    images = family.image_pool(cfg, batch, seed, "cpu")
    z = family.noise(cfg, batch, seed, 0, "cpu")
    prog = family.outputs(pred.predict(images, noise=z))
    ref = reference.predict(cfg, *weights, torch.as_tensor(images), z, cfg.get("int_bits"))
    return prog, ref


@pytest.mark.parametrize("name", ["ladine_chestxray_parity_bf16", "ladine_chestxray_serving_int8"])
def test_reference_is_the_program_in_float32(name):
    """float32 on both sides: the same call to rounding."""
    prog, ref = _both(name, "float32")
    g = judge.gaps(prog, ref)
    assert g["probs_gap"] < 1e-4 and g["vote_gap"] == 0.0
    assert g["var_gap_max"] < 2e-3 and g["piw_gap_max"] < 2e-3, g
    assert np.array_equal(prog["vote"], ref["vote"])


@pytest.mark.parametrize("name", ["ladine_chestxray_parity_bf16", "ladine_chestxray_serving_int8"])
def test_bf16_program_departs_from_the_float32_reference_by_rounding(name):
    prog, ref = _both(name, "bfloat16")
    g = judge.gaps(prog, ref)
    assert 0.0 < g["var_gap"] < 2e-2, g


def test_reference_quantizes_as_the_serving_preset():
    """Per-column weight codes and scales equal the port's."""
    from ladine_tpu_torch.kernels.int8 import quantize_weight

    w = torch.randn(96, 40, generator=torch.Generator().manual_seed(3)) * 0.1
    q, scale = quantize_weight(w)
    assert torch.equal(reference.quantize(w, 8), (q.float() * scale).double())


def test_reference_rows_are_independent():
    """Rows of one call do not meet: the reference of a batch's rows is
    that of those rows alone (the judge concatenates rows of many calls)."""
    cfg = tiny_config("ladine_chestxray_serving_int8")
    g, s = family.make_weights(cfg, 5, "cpu")
    images = torch.as_tensor(family.image_pool(cfg, 4, 5, "cpu"))
    z = family.noise(cfg, 4, 5, 0, "cpu")
    whole = reference.predict(cfg, g, s, images, z, 8)
    part = reference.predict(cfg, g, s, images[1:3], z[:, :, :, 1:3], 8)
    for k in ("probs", "var", "piw"):
        np.testing.assert_allclose(whole[k][1:3], part[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("steps,expect", [(0, 1000), (50, 50), (10, 10)])
def test_draws_match_the_chain(steps, expect):
    cfg = dict(timesteps=1000, ddim_steps=steps)
    assert reference.n_draws(cfg) == expect
