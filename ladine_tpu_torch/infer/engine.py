"""Nested-ensemble inference engine.

Counterpart of ``ladine_tpu/infer/engine.py::nested_ensemble_sample``. The
JAX package vmaps over members and MC trials; here both axes are written
out: the reverse chain runs on y of shape (M, K*B, C), rows ordered
(trial, image), so each step is one eps call, three kernel launches, for
the whole ensemble. The encoder features are computed once per (member,
image) and repeated over the trials for lin1's gate, and the timestep gates
and BatchNorms are folded once per chain for every timestep.

The int8 variants (``use_int8_eps``, ``use_int8_pallas``, ``pallas_fuse_ends``,
``use_int8_encode``) keep that layout: the JAX package folds the trials into
rows only for ``use_int8_pallas``, so only its noise layout differs there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ladine_tpu_torch.kernels.fused_eps import fold_table
from ladine_tpu_torch.kernels.int8 import int8_encode, int8_eps, quantize_member
from ladine_tpu_torch.kernels.int8_eps_fused import int8_eps_pallas_fused
from ladine_tpu_torch.kernels.int8_linear import int8_eps_pallas
from ladine_tpu_torch.models.conditional import ConditionalModel
from ladine_tpu_torch.ops.diffusion import ddim_sample_loop, p_sample_loop
from ladine_tpu_torch.ops.schedules import DiffusionSchedule


def nested_ensemble_sample(
    model: ConditionalModel,
    x_flat: torch.Tensor,
    y0_hat_members: torch.Tensor,
    sched: DiffusionSchedule,
    mc_trials: int = 20,
    tau: Optional[Sequence[int]] = None,
    eta: float = 0.0,
    noise_prior: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    use_int8_eps: bool = False,
    use_int8_encode: bool = False,
    use_int8_pallas: bool = False,
    pallas_fuse_ends: bool = False,
    qmember=None,
    qenc=None,
    sampler_table=None,
) -> torch.Tensor:
    """All members' MC samples in one chain: (M, mc_trials, B, y_dim).

    Args:
        x_flat: (B, data_dim) flattened images.
        y0_hat_members: (M, B, y_dim) softmaxed guidance per member, both
            the eps conditioning and (unless ``noise_prior``) the prior mean.
        tau: strided timestep subsequence for the DDIM sampler; None = the
            full ancestral chain.
        noise: optional injected draws, (n_draws, M, mc_trials, B, y_dim)
            with n_draws = T (ancestral) or len(tau) (DDIM).
        use_int8_eps: int8 lin2/lin3 through ``torch._int_mm``
            (``kernels/int8.py``).
        use_int8_pallas: int8 lin2/lin3 through the K4 kernel; wins over
            ``use_int8_eps``. With ``pallas_fuse_ends`` the K5 kernels.
        use_int8_encode: int8 enc_lin1 (``kernels.int8.int8_encode``), arch
            ``linear`` only: the conv archs keep their float encoder, and
            ``Predictor`` asks for it only where the arch has enc_lin1.
        qmember, qenc: the resident int8 weights (``quantize_member``,
            ``quantize_encoder``); quantized in the call when None.
        sampler_table: the step coefficients (``ops.diffusion``'s
            ``ancestral_table``, or ``ddim_table`` of ``tau`` and ``eta``);
            computed in the call when None.
    """
    m, b, c = y0_hat_members.shape
    k = mc_trials
    # f's dtype is the dtype the int8 paths store their hidden rows in, as in
    # the JAX engine: float32 from encode (its last BatchNorm promotes), the
    # compute dtype under use_int8_encode
    if use_int8_encode:
        f = int8_encode(model, x_flat, qenc).to(model.enc_lin3.weight.dtype)
    else:
        f = model.encode(x_flat)  # (M, B, F) float32
    # materialized (the kernel reads it as lin1's gate): at B = 1 the reshape
    # of the expanded view would stay a stride-0 view
    f_rows = f.unsqueeze(1).expand(m, k, b, f.shape[-1]).reshape(m, k * b, f.shape[-1]).contiguous()
    yhat_rows = y0_hat_members.unsqueeze(1).expand(m, k, b, c).reshape(m, k * b, c)
    y_T_mean = torch.zeros_like(yhat_rows) if noise_prior else yhat_rows
    if noise is not None:
        noise = noise.reshape(noise.shape[0], m, k * b, c)

    n_steps = model.lin1.embed.shape[1]
    table = fold_table(model, torch.arange(n_steps, device=f.device))

    if use_int8_pallas or use_int8_eps:
        q = qmember if qmember is not None else quantize_member(model)
        impl = (int8_eps_pallas_fused if pallas_fuse_ends else int8_eps_pallas) \
            if use_int8_pallas else int8_eps

        def eps_fn(y, t):
            return impl(model, q, f_rows, y, t, yhat_rows, table).to(f.dtype)
    else:

        def eps_fn(y, t):
            return model.eps(f_rows, y, t, yhat_rows, table)

    if tau is None:
        out = p_sample_loop(eps_fn, y_T_mean, sched, generator, noise, sampler_table)
    else:
        out = ddim_sample_loop(eps_fn, y_T_mean, sched, generator, tau, eta, noise, sampler_table)
    return out.reshape(m, k, b, c)
