"""Low-memory optimizer and EMA state: bfloat16 with stochastic rounding.

Counterpart of ``ladine_tpu/train/lowmem.py``. The Adam moments and the EMA
accumulator are stored in bfloat16 (the float32 master parameters stay), so
a member's state costs 14 bytes a parameter instead of 20. Their increments
are far below the bfloat16 ulp ((1 - b2) = 1e-3, (1 - mu) = 1e-4 of the
accumulator), so each store rounds up or down at random with the
probability of its distance to the two neighbours: unbiased, where
round-to-nearest would stall the accumulator.

Two departures from the JAX package, both deliberate (``ROADMAP.md`` §3):

* the rounding bits come from the training step's ``torch.Generator``, per
  element and so per member, where the JAX package derives them from a
  fixed seed 0 and the step count, shared by every member and every run;
* a NaN stays NaN; the JAX package's carry can turn a NaN whose payload is
  near all ones into -0.0.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Tensors = Dict[str, torch.Tensor]
CHUNK = 1 << 24  # elements of a leaf updated at once: temporaries stay small


def bf16_stochastic_round(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding: 16 uniform random bits
    are added to the 16 dropped low bits of the float32 pattern, and the
    top half is kept. Values whose low 16 bits are zero (every bfloat16,
    +-inf) come out unchanged for every draw; NaN stays NaN. The
    temporaries are int32 and int16 of x's size."""
    x = x.float().contiguous()
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device, dtype=torch.int32)
    # the sum carries into the top half only for NaN payloads, which are masked
    out = ((x.view(torch.int32) + noise) >> 16).to(torch.int16).view(torch.bfloat16)
    return out.masked_fill_(torch.isnan(x), float("nan"))


def adam_bf16(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
    """Adam with bfloat16 moments (L2 ``weight_decay`` before the moments),
    no clipping: the moment math runs in float32, the stores round
    stochastically."""
    from ladine_tpu_torch.train.optim import Optimizer

    return Optimizer("Adam", lr, weight_decay, b1, b2, eps, grad_clip=None, lowmem=True)


def scale_by_adam_bf16(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The Adam direction alone with bfloat16 moments: the update added to
    the parameters is ``m_hat / (sqrt(v_hat) + eps)`` (a step size of -1)."""
    return adam_bf16(-1.0, b1, b2, eps)


def ema_init_bf16(params: Tensors) -> Tensors:
    """Zero bfloat16 EMA accumulator, read through ``ema.ema_debias`` as the
    float32 one is (zero is exact in bfloat16)."""
    return {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device) for k, p in params.items()}


@torch.no_grad()
def ema_update_sr(ema: Tensors, params: Tensors, mu: float, generator: Optional[torch.Generator]) -> None:
    """``shadow <- mu * shadow + (1 - mu) * param`` in float32, stored in
    bfloat16 with stochastic rounding, in place, in chunks of
    ``CHUNK`` elements."""
    if generator is None:
        raise ValueError("ema_update_sr needs a generator for its stochastic rounding")
    for k, e in ema.items():
        ev, pv = e.view(-1), params[k].reshape(-1)
        for j in range(0, ev.numel(), CHUNK):
            ec, pc = ev[j:j + CHUNK], pv[j:j + CHUNK]
            ec.copy_(bf16_stochastic_round(mu * ec.float() + (1.0 - mu) * pc.float(), generator))
