"""The port's statistical check, and its copy of the synthetic data.

``ladine_tpu_torch/examples/gmm_posterior.py`` trains one member on the
1-D Gaussian mixture through the port's trainer and samples the grid
through the port's engine in five rows; on the CPU (the kernels' plain
versions) at the cut of ``tests/test_posterior_recovery.py`` (700 steps,
40 trials) every row's MAE against the analytic posterior must be below
that test's bound, 0.15 (measured on the CPU: ancestral 0.0155, the four DDIM
rows 0.044-0.045).
"""

import numpy as np
import pytest

from ladine_tpu.data import synthetic as JS
from ladine_tpu_torch.data import synthetic as S
from ladine_tpu_torch.examples.gmm_posterior import ROWS, run


def test_gmm_posterior_recovery():
    out = run(n_train_steps=700, mc_trials=40, verbose=False, device="cpu")
    assert np.isfinite(out["train"]["loss"])
    for name in ROWS:
        assert out[name]["mae"] < 0.15, f"{name}: posterior MAE {out[name]['mae']:.3f} too high"
    assert out["ancestral"]["mae"] < 0.05


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_data_equals_the_jax_package_copy(seed):
    a, b = S.Gaussians(seed=seed), JS.Gaussians(seed=seed)
    for x, y in zip(a.sample(33), b.sample(33)):
        np.testing.assert_array_equal(x, y)
    a, b = S.GaussianMixture1D(mu=(-1.0, 1.0), sigma=(0.6, 0.6), seed=seed), \
        JS.GaussianMixture1D(mu=(-1.0, 1.0), sigma=(0.6, 0.6), seed=seed)
    for x, y in zip(a.sample(50), b.sample(50)):
        np.testing.assert_array_equal(x, y)
    grid = np.linspace(-3, 3, 17, dtype=np.float32)
    np.testing.assert_array_equal(a.posterior(grid), b.posterior(grid))
    x = np.random.default_rng(seed).random((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(S.add_gaussian_noise(x, 0.1, 0.5, seed), JS.add_gaussian_noise(x, 0.1, 0.5, seed))
