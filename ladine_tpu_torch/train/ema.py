"""Exponential moving average of parameters, zero-initialized and debiased
at read time.

Counterpart of ``ladine_tpu/train/ema.py``: ``shadow <- mu * shadow +
(1 - mu) * param`` on a zero accumulator, read as the accumulator over ``1 - mu^t``,
the Adam convention. Checkpoints
mark it ``meta["ema_init"] = "zero"``; a legacy copy-initialized shadow is
read as it is.

The read is the JAX package's, bias included: in float32 the update's
``mu`` and ``1 - mu`` round separately (0.9999 -> 0.99989998, 1 - 0.9999 ->
0.99999997e-4), so the weights of the average sum to ``(1 - mu)_f32 / (1 -
mu_f32) = 0.999834`` of the ``1 - mu_f32^t`` that the read divides by, and
the read returns 0.999834 of the average at every step (``ROADMAP.md`` §3
F4, a fault of the reference left for a later change to decide).

Parameters are dicts of tensors by name, stacked or not; ``step`` is the
update count, a scalar or one per member (the leading axis).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def ema_init(params: Tensors) -> Tensors:
    """Zero accumulator, fresh tensors (read through :func:`ema_debias`)."""
    return {k: torch.zeros_like(p) for k, p in params.items()}


@torch.no_grad()
def ema_update(ema: Tensors, params: Tensors, mu: float = 0.9999) -> None:
    """``shadow <- mu * shadow + (1 - mu) * param``, in place."""
    for k, e in ema.items():
        e.mul_(mu).add_(params[k], alpha=1.0 - mu)


def debias_scale(mu: float, step) -> torch.Tensor:
    """float32 factor of the read at ``step`` (shape of ``step``): ``1 / (1 -
    mu^t)`` in float32, as the JAX read computes it; 1 at step 0 (nothing
    averaged yet: the zero accumulator as it is)."""
    step = torch.as_tensor(step)
    denom = 1.0 - torch.pow(float(np.float32(mu)), step.float())
    return torch.where(step > 0, 1.0 / torch.clamp_min(denom, 1e-12), torch.ones_like(denom))


def ema_debias(ema: Tensors, mu: float, step) -> Tensors:
    """The debiased shadow, each leaf in its own dtype; ``step`` a scalar or
    per member (the leaves' leading axis)."""
    out = {}
    for k, e in ema.items():
        scale = debias_scale(mu, step).to(e.device)
        scale = scale.reshape(scale.shape + (1,) * (e.dim() - scale.dim()))
        out[k] = (e * scale).to(e.dtype)
    return out


def ema_read(ema: Tensors, mu: float, step, mode: str) -> Tensors:
    """The shadow-weight read: ``mode == "zero"`` debiases the zero-init
    accumulator; any other mode is a legacy copy-initialized shadow, usable
    as it is."""
    return ema_debias(ema, mu, step) if mode == "zero" else ema


def ema_params_from_ckpt(st: dict, meta: dict) -> Tensors:
    """EMA weights from a checkpoint's stacked states (``st["ema"]``,
    ``st["step"]`` one count per member), debiased iff
    ``meta["ema_init"] == "zero"``."""
    if meta.get("ema_init") != "zero":
        return st["ema"]
    step = st.get("step")
    if step is None:
        raise ValueError(
            "zero-init EMA checkpoint is missing the per-member 'step' "
            "counter needed for debiasing - re-save it or evaluate raw params"
        )
    return ema_read(st["ema"], float(meta.get("ema_rate", 0.9999)), step, "zero")
