"""Synthetic toy data (numpy only), the port's own copy of
``ladine_tpu/data/synthetic.py``: the same seeds give the same samples.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Gaussians:
    """Two-class 2-D Gaussian toy sampler: class 0 ~ N(mu0, s I), class 1 ~
    N(mu1, s I), balanced."""

    def __init__(
        self,
        mu0: Tuple[float, float] = (-2.0, -2.0),
        mu1: Tuple[float, float] = (2.0, 2.0),
        sigma: float = 1.0,
        seed: int = 0,
    ):
        self.mu = np.array([mu0, mu1], np.float32)
        self.sigma = sigma
        self.rng = np.random.default_rng(seed)

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        y = self.rng.integers(0, 2, size=n)
        x = self.mu[y] + self.sigma * self.rng.normal(size=(n, 2)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int64)


class GaussianMixture1D:
    """1-D two-component Gaussian mixture with its analytic class posterior
    p(y=1|x) (Bayes on the two component densities): a calibration ground
    truth."""

    def __init__(
        self,
        mu: Tuple[float, float] = (-1.0, 1.0),
        sigma: Tuple[float, float] = (0.5, 0.5),
        weights: Tuple[float, float] = (0.5, 0.5),
        seed: int = 0,
    ):
        self.mu = np.asarray(mu, np.float64)
        self.sigma = np.asarray(sigma, np.float64)
        self.w = np.asarray(weights, np.float64)
        self.rng = np.random.default_rng(seed)

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        y = (self.rng.random(n) < self.w[1]).astype(np.int64)
        x = self.mu[y] + self.sigma[y] * self.rng.normal(size=n)
        return x.astype(np.float32)[:, None], y

    def posterior(self, x: np.ndarray) -> np.ndarray:
        """p(y=1 | x), analytic."""
        x = np.asarray(x, np.float64).reshape(-1)
        dens = np.stack(
            [
                self.w[k]
                / (self.sigma[k] * np.sqrt(2 * np.pi))
                * np.exp(-0.5 * ((x - self.mu[k]) / self.sigma[k]) ** 2)
                for k in range(2)
            ]
        )
        return (dens[1] / dens.sum(axis=0)).astype(np.float32)


def add_gaussian_noise(x: np.ndarray, mean: float = 0.0, std: float = 1.0, seed: int = 0) -> np.ndarray:
    """The reference's AddGaussianNoise transform."""
    rng = np.random.default_rng(seed)
    return x + rng.normal(mean, std, size=x.shape).astype(x.dtype)
