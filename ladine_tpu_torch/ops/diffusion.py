"""CARD-style conditional diffusion math on tensors.

Counterpart of ``ladine_tpu/ops/diffusion.py``. The JAX ``lax.scan`` over
timesteps becomes a Python loop; ``eps_fn(y, t)`` receives ``t`` as a Python
int, so a schedule lookup never waits on the device.

Noise comes from a ``torch.Generator`` or, when given, from an injected
``noise`` tensor whose leading axis is the draw index: entry 0 is the y_T
draw and entry i the draw of the i-th reverse step. The tests inject the
exact ``jax.random`` draws of the JAX sampler this way. Without injected
noise all draws are made in one call before the loop.

The coefficients of every reverse step come from a table computed once on
the schedule's device (:func:`ancestral_table`, :func:`ddim_table`), which
a caller may pass in: with a table and injected noise a loop copies
nothing from the host and never waits on the device, so it can be
captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ladine_tpu_torch.ops.schedules import DiffusionSchedule

EpsFn = Callable[[torch.Tensor, int], torch.Tensor]


def extract(arr: torch.Tensor, t, ndim: int) -> torch.Tensor:
    """Gather schedule entries at timesteps ``t``, shaped to broadcast
    against an ndim-dimensional batch tensor."""
    if not isinstance(t, torch.Tensor):
        return arr[int(t)].reshape((1,) * ndim)  # an int indexes on the device
    out = arr[t]
    return out.reshape(tuple(t.shape) + (1,) * (ndim - t.dim()))


def q_sample(
    y0: torch.Tensor,
    y0_hat: torch.Tensor,
    sched: DiffusionSchedule,
    t,
    noise: torch.Tensor,
) -> torch.Tensor:
    """``y_t = sqrt(ab_t) y_0 + (1 - sqrt(ab_t)) y_0_hat + sqrt(1-ab_t) eps``"""
    sab = extract(sched.alphas_bar_sqrt, t, y0.dim())
    somab = extract(sched.one_minus_alphas_bar_sqrt, t, y0.dim())
    return sab * y0 + (1.0 - sab) * y0_hat + somab * noise


class PSampleCoeffs(NamedTuple):
    """Reverse-step coefficients at timestep(s) t >= 1."""

    gamma0: torch.Tensor
    gamma1: torch.Tensor
    gamma2: torch.Tensor
    beta_hat_sqrt: torch.Tensor
    alpha_bar_sqrt: torch.Tensor  # sqrt(ab_t)
    one_minus_alpha_bar_sqrt: torch.Tensor  # sqrt(1-ab_t)


def p_sample_coefficients(sched: DiffusionSchedule, t) -> PSampleCoeffs:
    """gamma coefficients of the CARD posterior mean, for an int ``t`` or a
    tensor of timesteps. ``sqrt(ab_t)`` is recomputed as
    ``sqrt(1 - somab_t^2)``, as the reference does, so float32 rounding
    matches it."""
    if not isinstance(t, (int, torch.Tensor)):
        t = torch.as_tensor(t, device=sched.device)
    alpha_t = sched.alphas[t]
    somab_t = sched.one_minus_alphas_bar_sqrt[t]
    somab_tm1 = sched.one_minus_alphas_bar_sqrt[t - 1]
    sab_t = torch.sqrt(1.0 - somab_t**2)
    sab_tm1 = torch.sqrt(1.0 - somab_tm1**2)
    denom = somab_t**2
    gamma0 = (1.0 - alpha_t) * sab_tm1 / denom
    gamma1 = somab_tm1**2 * torch.sqrt(alpha_t) / denom
    gamma2 = 1.0 + (sab_t - 1.0) * (torch.sqrt(alpha_t) + sab_tm1) / denom
    beta_hat = somab_tm1**2 / denom * (1.0 - alpha_t)
    return PSampleCoeffs(gamma0, gamma1, gamma2, torch.sqrt(beta_hat), sab_t, somab_t)


def y0_reparam(y, eps, y_T_mean, alpha_bar_sqrt, one_minus_alpha_bar_sqrt):
    """Epsilon-reparameterization of y_0 under the mean-shifted process."""
    return (
        y - (1.0 - alpha_bar_sqrt) * y_T_mean - eps * one_minus_alpha_bar_sqrt
    ) / alpha_bar_sqrt


def p_sample_step(y, eps, y_T_mean, coeffs: PSampleCoeffs, z) -> torch.Tensor:
    """One ancestral reverse step t -> t-1 (t >= 1)."""
    y0 = y0_reparam(y, eps, y_T_mean, coeffs.alpha_bar_sqrt, coeffs.one_minus_alpha_bar_sqrt)
    mean = coeffs.gamma0 * y0 + coeffs.gamma1 * y + coeffs.gamma2 * y_T_mean
    return mean + coeffs.beta_hat_sqrt * z


def p_sample_final(y, eps, y_T_mean, sched: DiffusionSchedule) -> torch.Tensor:
    """Final deterministic step at array index t=0 (diffusion step 1 -> 0)."""
    somab = sched.one_minus_alphas_bar_sqrt[0]
    sab = torch.sqrt(1.0 - somab**2)
    return y0_reparam(y, eps, y_T_mean, sab, somab)


def _draws(n: int, like: torch.Tensor, generator, noise) -> torch.Tensor:
    shape = (n,) + tuple(like.shape)
    if noise is None:
        return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise must have shape {shape}; got {tuple(noise.shape)}")
    return noise.to(device=like.device, dtype=like.dtype)


def ancestral_table(sched: DiffusionSchedule) -> PSampleCoeffs:
    """The coefficients of the ancestral steps t = T-1 .. 1, in the loop's
    order, each (T-1,) on the schedule's device."""
    T = sched.num_timesteps
    return p_sample_coefficients(sched, torch.arange(T - 1, 0, -1, device=sched.device))


def p_sample_loop(
    eps_fn: EpsFn,
    y_T_mean: torch.Tensor,
    sched: DiffusionSchedule,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    table: Optional[PSampleCoeffs] = None,
) -> torch.Tensor:
    """Full ancestral reverse chain: ``y_T = z + y_T_mean``, steps
    t = T-1 .. 1, then the deterministic 1 -> 0 step. ``noise``, if given,
    has shape ``(T,) + y_T_mean.shape``; ``table`` is
    :func:`ancestral_table` (computed here when None)."""
    T = sched.num_timesteps
    z = _draws(T, y_T_mean, generator, noise)
    y = z[0] + y_T_mean
    coeffs = ancestral_table(sched) if table is None else table
    for i, t in enumerate(range(T - 1, 0, -1)):
        eps = eps_fn(y, t)
        c = PSampleCoeffs(*(v[i] for v in coeffs))
        y = p_sample_step(y, eps, y_T_mean, c, z[i + 1])
    return p_sample_final(y, eps_fn(y, 0), y_T_mean, sched)


def ddim_timesteps(num_timesteps: int, num_steps: int, skip_type: str = "uniform") -> torch.Tensor:
    """Increasing subsequence of array-timestep indices ending at 0 (int64,
    on the host)."""
    if skip_type == "uniform":
        tau = np.linspace(0, num_timesteps - 1, num_steps)
    elif skip_type == "quad":
        tau = np.linspace(0, np.sqrt(num_timesteps - 1), num_steps) ** 2
    else:
        raise ValueError(f"unknown skip_type {skip_type!r}")
    return torch.from_numpy(np.unique(tau.round().astype(np.int64)))


class DDIMCoeffs(NamedTuple):
    """Strided-step coefficients, one entry per step t -> s of the loop."""

    sab_t: torch.Tensor  # sqrt(ab_t)
    sab_s: torch.Tensor  # sqrt(ab_s)
    somab_t: torch.Tensor  # sqrt(1 - ab_t)
    sigma: torch.Tensor
    dir_coeff: torch.Tensor  # sqrt(1 - ab_s - sigma^2)


def ddim_table(sched: DiffusionSchedule, tau: Sequence[int], eta: float) -> DDIMCoeffs:
    """The coefficients of the strided steps over ``tau`` (see
    :func:`ddim_sample_loop`), in the loop's order, each (len(tau) - 1,)
    on the schedule's device."""
    tau = [int(v) for v in tau]
    dev = sched.device
    ab_t = sched.alphas_bar[torch.tensor(tau[1:][::-1], dtype=torch.long, device=dev)]
    ab_s = sched.alphas_bar[torch.tensor(tau[:-1][::-1], dtype=torch.long, device=dev)]
    sigma = (
        eta
        * torch.sqrt((1.0 - ab_s) / (1.0 - ab_t))
        * torch.sqrt(torch.clamp_min(1.0 - ab_t / ab_s, 0.0))
    )
    dir_coeff = torch.sqrt(torch.clamp_min(1.0 - ab_s - sigma**2, 0.0))
    return DDIMCoeffs(torch.sqrt(ab_t), torch.sqrt(ab_s), torch.sqrt(1.0 - ab_t), sigma, dir_coeff)


def ddim_sample_loop(
    eps_fn: EpsFn,
    y_T_mean: torch.Tensor,
    sched: DiffusionSchedule,
    generator: Optional[torch.Generator],
    tau: Sequence[int],
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    table: Optional[DDIMCoeffs] = None,
) -> torch.Tensor:
    """Strided (DDIM-style) reverse chain for the mean-shifted CARD process.

    For consecutive subsequence indices t > s:
        y_s = sqrt(ab_s) y0_hat + (1 - sqrt(ab_s)) m
              + sqrt(1 - ab_s - sigma^2) eps + sigma z,
        sigma = eta sqrt((1-ab_s)/(1-ab_t)) sqrt(1 - ab_t/ab_s).
    The last step returns the y_0 reparameterization. ``noise``, if given,
    has shape ``(len(tau),) + y_T_mean.shape``; ``table`` is
    :func:`ddim_table` of ``tau`` and ``eta`` (computed here when None).
    """
    tau = [int(v) for v in tau]
    z = _draws(len(tau), y_T_mean, generator, noise)
    y = z[0] + y_T_mean
    c = ddim_table(sched, tau, eta) if table is None else table
    for i, t in enumerate(tau[1:][::-1]):  # t_{n-1} .. t_1
        eps = eps_fn(y, t)
        y0 = y0_reparam(y, eps, y_T_mean, c.sab_t[i], c.somab_t[i])
        y = c.sab_s[i] * y0 + (1.0 - c.sab_s[i]) * y_T_mean + c.dir_coeff[i] * eps + c.sigma[i] * z[i + 1]
    return p_sample_final(y, eps_fn(y, tau[0]), y_T_mean, sched)


def antithetic_timesteps(
    generator: Optional[torch.Generator],
    n: int,
    num_timesteps: int,
    batch_shape: Sequence[int] = (),
    device=None,
) -> torch.Tensor:
    """Antithetic timestep sampling for training: draw n//2+1 uniform t,
    mirror them as T-1-t, truncate to n. ``batch_shape`` leads with
    independent draws (a member axis, say): int64 of shape
    ``(*batch_shape, n)``."""
    t_half = torch.randint(0, num_timesteps, (*batch_shape, n // 2 + 1),
                           generator=generator, device=device)
    return torch.cat([t_half, num_timesteps - 1 - t_half], dim=-1)[..., :n]
