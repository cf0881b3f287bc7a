"""Beta schedules and precomputed diffusion-schedule tensors.

Counterpart of ``ladine_tpu/ops/schedules.py``: the same 8 schedules,
computed once on the host in float64 and stored as float32 tensors on the
requested device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ladine_tpu_torch.device import resolve_device

_SCHEDULES = (
    "linear",
    "const",
    "quad",
    "jsd",
    "sigmoid",
    "cosine",
    "cosine_reverse",
    "cosine_anneal",
)


def make_beta_schedule(
    schedule: str = "linear",
    num_timesteps: int = 1000,
    start: float = 1e-5,
    end: float = 1e-2,
) -> np.ndarray:
    """Return betas of shape (num_timesteps,) as float64 numpy."""
    t = num_timesteps
    if schedule == "linear":
        betas = np.linspace(start, end, t)
    elif schedule == "const":
        betas = end * np.ones(t)
    elif schedule == "quad":
        betas = np.linspace(start**0.5, end**0.5, t) ** 2
    elif schedule == "jsd":
        # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(t, 1, t)
    elif schedule == "sigmoid":
        s = np.linspace(-6, 6, t)
        betas = 1.0 / (1.0 + np.exp(-s)) * (end - start) + start
    elif schedule in ("cosine", "cosine_reverse"):
        max_beta = 0.999
        cosine_s = 0.008

        def f(i):
            return math.cos((i / t + cosine_s) / (1 + cosine_s) * math.pi / 2) ** 2

        betas = np.array([min(1 - f(i + 1) / f(i), max_beta) for i in range(t)])
    elif schedule == "cosine_anneal":
        betas = np.array(
            [
                start + 0.5 * (end - start) * (1 - math.cos(i / (t - 1) * math.pi))
                for i in range(t)
            ]
        )
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}; one of {_SCHEDULES}")
    return betas.astype(np.float64)


class DiffusionSchedule(NamedTuple):
    """Precomputed schedule tensors, each of shape (T,), float32."""

    betas: torch.Tensor  # beta_t
    alphas: torch.Tensor  # 1 - beta_t
    alphas_bar: torch.Tensor  # prod alpha
    alphas_bar_sqrt: torch.Tensor  # sqrt(prod alpha)
    one_minus_alphas_bar_sqrt: torch.Tensor  # sqrt(1 - prod alpha)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(t.to(device) for t in self))

    @classmethod
    def create(
        cls,
        schedule: str = "linear",
        num_timesteps: int = 1000,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        device="cuda",
    ) -> "DiffusionSchedule":
        dev = resolve_device(device)
        betas = make_beta_schedule(schedule, num_timesteps, beta_start, beta_end)
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return cls(
            betas=f32(betas),
            alphas=f32(alphas),
            alphas_bar=f32(alphas_bar),
            alphas_bar_sqrt=f32(np.sqrt(alphas_bar)),
            one_minus_alphas_bar_sqrt=f32(np.sqrt(1.0 - alphas_bar)),
        )
