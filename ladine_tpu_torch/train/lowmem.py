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

from typing import Dict, Iterator, Optional, Tuple

import torch

from ladine_tpu_torch.parallel.mesh import Window, leaf_window

Tensors = Dict[str, torch.Tensor]
CHUNK = 1 << 24  # elements of a leaf updated at once: temporaries stay small


def column_chunks(local: Tuple[int, int], window: Window) -> Iterator[Tuple[Tuple[int, int], Optional[slice], tuple]]:
    """The column chunks of a member-stacked leaf's whole (M, N) view, about
    ``CHUNK`` elements each, as a rank holding the (m, c) part ``local`` at
    ``window`` sees them: (the chunk's shape, this rank's columns of it in
    its own view or None, this rank's index into the chunk). Every chunk
    comes, held or not, so that each rank can draw every chunk's bits whole
    and the edges do not depend on the shard."""
    (m, c), w = local, window
    width = max(1, CHUNK // w.rows)
    rows = slice(w.row0, w.row0 + m)
    for j in range(0, w.cols, width):
        end = min(j + width, w.cols)
        lo, hi = max(j, w.col0), min(end, w.col0 + c)
        if lo < hi:
            yield (w.rows, end - j), slice(lo - w.col0, hi - w.col0), (rows, slice(lo - j, hi - j))
        else:
            yield (w.rows, end - j), None, None


def bf16_stochastic_round(x: torch.Tensor, generator: Optional[torch.Generator],
                          window: Optional[Tuple[Tuple[int, ...], tuple]] = None) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding: 16 uniform random bits
    are added to the 16 dropped low bits of the float32 pattern, and the
    top half is kept. Values whose low 16 bits are zero (every bfloat16,
    +-inf) come out unchanged for every draw; NaN stays NaN. The
    temporaries are int32 and int16 of x's size. ``window``: (shape,
    index): the bits are ``index`` of a draw of ``shape``, x's part of a
    whole that another rank holds the rest of (:func:`column_chunks`)."""
    x = x.float().contiguous()
    shape, index = window if window is not None else (x.shape, ...)
    noise = torch.randint(0, 1 << 16, shape, generator=generator, device=x.device, dtype=torch.int32)[index]
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


def stacked_view(t: torch.Tensor) -> torch.Tensor:
    """A leaf as (members, -1): its leading axis against the rest."""
    return t.view(t.shape[0] if t.dim() else 1, -1)


def skip_bits(shape, generator: Optional[torch.Generator], device) -> None:
    """Draw a chunk's bits that this rank does not hold, so that its
    generator stays in step with the ranks that do."""
    torch.randint(0, 1 << 16, shape, generator=generator, device=device, dtype=torch.int32)


@torch.no_grad()
def ema_update_sr(ema: Tensors, params: Tensors, mu: float, generator: Optional[torch.Generator],
                  mesh=None, fsdp=()) -> None:
    """``shadow <- mu * shadow + (1 - mu) * param`` in float32, stored in
    bfloat16 with stochastic rounding, in place, in the column chunks of
    each leaf's (members, -1) view (:func:`column_chunks`). On a ``mesh``
    the leaves are this rank's parts (``fsdp``: the names whose second axis
    shards over 'data'), and the bits are those one process would draw."""
    if generator is None:
        raise ValueError("ema_update_sr needs a generator for its stochastic rounding")
    for k, e in ema.items():
        ev, pv = stacked_view(e), stacked_view(params[k])
        for shape, mine, index in column_chunks(ev.shape, leaf_window(ev, mesh, k in fsdp)):
            if mine is None:
                skip_bits(shape, generator, e.device)
                continue
            ec, pc = ev[:, mine], pv[:, mine]
            ec.copy_(bf16_stochastic_round(mu * ec.float() + (1.0 - mu) * pc.float(), generator, (shape, index)))
