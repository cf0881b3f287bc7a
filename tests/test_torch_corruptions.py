"""ladine_tpu_torch's corruption suite against ladine_tpu's on the CPU: each
corruption and ``apply_corruptions`` on the same seeded numpy images, with
the JAX package's own draws injected (``torch_parity.jax_corruption_draws``);
float32, within 1e-6 (the bilinear weights and the contrast means in
another summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.ops import corruptions as jcor
from ladine_tpu_torch.ops import corruptions as tcor
from torch_parity import jax_corruption_draws, one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6


def _images(seed=0, shape=(3, 16, 16, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size", [(8, 8), (16, 16), (5, 7), (24, 20), (1, 3)])
def test_bilinear_resize(size):
    x = _images(1)
    _close(tcor.bilinear_resize(torch.from_numpy(x), *size), jcor.bilinear_resize(jnp.asarray(x), *size))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_down_up_sample(k):
    x = _images(2)
    _close(tcor.down_up_sample(torch.from_numpy(x), k), jcor.down_up_sample(jnp.asarray(x), k))


@pytest.mark.parametrize("k", [-0.3, 0.1, 0.5])
def test_adjust_brightness(k):
    x = _images(3)
    _close(tcor.adjust_brightness(torch.from_numpy(x), k), jcor.adjust_brightness(jnp.asarray(x), k))


@pytest.mark.parametrize("k", [0.2, 0.8, 1.7])
def test_adjust_contrast(k):
    x = _images(4)
    _close(tcor.adjust_contrast(torch.from_numpy(x), k), jcor.adjust_contrast(jnp.asarray(x), k))


def test_add_noise_with_the_jax_draws():
    x = _images(5)
    key = jax.random.PRNGKey(3)
    want = jcor.add_noise(jnp.asarray(x), 0.05, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    _close(tcor.add_noise(torch.from_numpy(x), 0.05, noise=noise), want)


@pytest.mark.parametrize("cover", [(0.05, 2), (0.1, 3), (0.3, 2)], ids=str)
def test_random_cover_with_the_jax_draws(cover):
    """(0.3, 2) on 16x16 places 8x8 squares: candidates overlap often, so
    the first-free rule and the fall-back to candidate 0 are both taken."""
    x = _images(6)
    key = jax.random.PRNGKey(4)
    want = jcor.random_cover(jnp.asarray(x), *cover, jax.random.split(key, 3)[1])
    draws = jax_corruption_draws(key, x.shape, cover=cover)
    got = tcor.random_cover(torch.from_numpy(x), *cover, corners=draws["cover"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).any()


@pytest.mark.parametrize("k", [0.1, 0.25])
def test_random_crop_and_resize_with_the_jax_draws(k):
    x = _images(7)
    key = jax.random.PRNGKey(5)
    want = jcor.random_crop_and_resize(jnp.asarray(x), k, jax.random.split(key, 3)[2])
    draws = jax_corruption_draws(key, x.shape, crop=k)
    _close(tcor.random_crop_and_resize(torch.from_numpy(x), k, corners=draws["crop"]), want)


@pytest.mark.parametrize("through", ["random_crop_and_resize", "apply_corruptions"])
def test_crop_row_at_224_pixels_with_the_jax_draws(through):
    """The evidence run's crop row: a 201-pixel crop of each 224-pixel image
    resized back (k = 0.1), alone and through the evaluator's call."""
    x = _images(10, (8, 224, 224, 3))
    key = jax.random.PRNGKey(7)
    draws = jax_corruption_draws(key, x.shape, crop=0.1)
    if through == "random_crop_and_resize":
        want = jcor.random_crop_and_resize(jnp.asarray(x), 0.1, jax.random.split(key, 3)[2])
        got = tcor.random_crop_and_resize(torch.from_numpy(x), 0.1, corners=draws["crop"])
    else:
        want = jcor.apply_corruptions(jnp.asarray(x), key, crop=0.1)
        got = tcor.apply_corruptions(torch.from_numpy(x), crop=0.1, draws=draws)
    assert got.shape == x.shape and len({(int(t), int(l)) for t, l in zip(*draws["crop"])}) > 1
    _close(got, want)


ALL = dict(noise_std=0.05, low_resolution=2, brightness=0.1, contrast=0.8, cover=(0.05, 2), crop=0.1)


@pytest.mark.parametrize("kw", [ALL, dict(ALL, low_resolution=1, brightness=0.0), dict(contrast=1.0), {}],
                         ids=["all", "no-lowres-no-brightness", "contrast-1-is-off", "none"])
def test_apply_corruptions_with_the_jax_draws(kw):
    x = _images(8, (4, 16, 16, 3))
    key = jax.random.PRNGKey(6)
    want = jcor.apply_corruptions(jnp.asarray(x), key, **kw)
    draws = jax_corruption_draws(key, x.shape, kw.get("cover", (0.0, 0)), kw.get("crop", 0.0))
    got = tcor.apply_corruptions(torch.from_numpy(x), **kw, draws=draws)
    _close(got, want)
    if not kw or kw == dict(contrast=1.0):
        assert np.array_equal(got.numpy(), x)


def test_apply_corruptions_draws_from_a_generator():
    x = torch.from_numpy(_images(9))
    a = tcor.apply_corruptions(x, torch.Generator().manual_seed(1), **ALL)
    b = tcor.apply_corruptions(x, torch.Generator().manual_seed(1), **ALL)
    c = tcor.apply_corruptions(x, torch.Generator().manual_seed(2), **ALL)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == x.shape and torch.isfinite(a).all()
