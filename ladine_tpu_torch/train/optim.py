"""Optimizers and learning-rate schedules with optax's arithmetic.

Counterpart of ``ladine_tpu/train/optim.py``. The JAX package builds optax
chains; here :class:`Optimizer` computes the same updates on plain tensors,
in place, without ``torch.optim``, whose rules differ from optax's:

* clipping by global norm leaves ``g`` as it is when ``|g| < max`` and
  scales it by ``max / |g|`` otherwise, with no epsilon;
* Adam: ``m / (1 - b1^n) / (sqrt(v / (1 - b2^n)) + eps)``, eps outside the
  root, at the count n after the increment; AdamW adds ``wd * p`` to that
  direction (decoupled, scaled by the learning rate); Adam with
  ``weight_decay`` adds ``wd * p`` to the gradient first (L2);
* RMSProp (decay 0.99): ``g * rsqrt(v + eps)``, eps inside the root, no
  bias correction;
* SGD: the momentum trace ``g + 0.9 * trace`` is the direction;
* a schedule is read at the count BEFORE the step's increment, so the first
  update uses ``lr(0)``.

Parameters, gradients and optimizer state are dicts of tensors by name.
Stacked members (a leading member axis M, ``init(..., members=M)``) are
independent models, as under the JAX package's vmap: each member is clipped
by its own global norm and keeps its own step count. Each leaf is updated
in column chunks of its (M, -1) view (``lowmem.CHUNK`` elements), so a
616 M-element leaf never needs a temporary of its own size.

Schedules take the count as an int32 tensor and evaluate in float32, as the
JAX schedules do on an int32 count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch

from ladine_tpu_torch.parallel.mesh import leaf_window, reduce_data
from ladine_tpu_torch.train.lowmem import bf16_stochastic_round, column_chunks, skip_bits

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]

_RMS_DECAY, _RMS_EPS = 0.99, 1e-8  # optax.rmsprop(lr, decay=0.99, eps=1e-8)


def warmup_cosine(base_lr: float, warmup_epochs: float, total_epochs: float, steps_per_epoch: int,
                  min_lr: float = 0.0) -> Schedule:
    """Linear warmup over ``warmup_epochs``, then a half-cycle cosine to
    ``min_lr`` at ``total_epochs``, at fractional epochs ``step /
    steps_per_epoch``."""

    def schedule(step):
        epoch = torch.as_tensor(step) / steps_per_epoch
        warm = base_lr * epoch / warmup_epochs
        cos = min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * (epoch - warmup_epochs) / (total_epochs - warmup_epochs)))
        return torch.where(epoch < warmup_epochs, warm, cos)

    return schedule


def step_decay(base_lr: float, step_size_epochs: int, gamma: float, steps_per_epoch: int) -> Schedule:
    """torch StepLR: ``lr * gamma^(epoch // step_size)``."""

    def schedule(step):
        epoch = torch.as_tensor(step) // steps_per_epoch
        return base_lr * torch.pow(gamma, (epoch // step_size_epochs).float())

    return schedule


def cosine_warm_restarts(base_lr: float, first_cycle_epochs: int, steps_per_epoch: int,
                         t_mult: int = 1, eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingWarmRestarts: cosine cycles of T_0, T_0 * t_mult,
    ... epochs."""

    def schedule(step):
        epoch = torch.as_tensor(step) / steps_per_epoch
        if t_mult == 1:
            t_cur = torch.remainder(epoch, first_cycle_epochs)
            t_i = first_cycle_epochs
        else:
            # the cycle n satisfies T_0 * (t_mult^n - 1) / (t_mult - 1) <= epoch
            n = torch.floor(torch.log(epoch / first_cycle_epochs * (t_mult - 1) + 1) / math.log(t_mult))
            start = first_cycle_epochs * (torch.pow(t_mult, n) - 1) / (t_mult - 1)
            t_cur = epoch - start
            t_i = first_cycle_epochs * torch.pow(t_mult, n)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + torch.cos(math.pi * t_cur / t_i))

    return schedule


@dataclass(frozen=True)
class Optimizer:
    """One of ``make_optimizer``'s chains: ``init`` makes its state,
    ``step`` applies one update to the parameters and the state in place.

    State: ``count`` (int32, () or (M,)) and, by name, ``mu`` and ``nu``
    (Adam, AdamW; bfloat16 with ``lowmem``), ``nu`` (RMSProp) or ``trace``
    (SGD)."""

    name: str = "Adam"
    lr: Union[float, Schedule] = 1e-3
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: Optional[float] = 1.0
    lowmem: bool = False

    def _slots(self):
        return {"Adam": ("mu", "nu"), "AdamW": ("mu", "nu"), "RMSProp": ("nu",), "SGD": ("trace",)}[self.name]

    def init(self, params: Tensors, members: Optional[int] = None) -> dict:
        """Zero state for ``params``; ``members``: the leading member axis
        of stacked parameters (one count and one clipping norm each)."""
        device = next(iter(params.values())).device
        count = torch.zeros(() if members is None else (members,), dtype=torch.int32, device=device)
        dtype = torch.bfloat16 if self.lowmem else None
        state = {"count": count}
        for slot in self._slots():
            state[slot] = {k: torch.zeros_like(p, dtype=dtype or p.dtype) for k, p in params.items()}
        return state

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The step size at ``count`` (float32, the count's shape)."""
        if callable(self.lr):
            return torch.as_tensor(self.lr(count), dtype=torch.float32, device=count.device)
        return torch.full(count.shape, self.lr, dtype=torch.float32, device=count.device)

    def clip_scale(self, grads: Tensors, members: int, mesh=None, fsdp=()) -> Optional[torch.Tensor]:
        """Each member's factor (members, 1): 1 where its global norm is
        below ``grad_clip``, else ``grad_clip / norm``. On a ``mesh`` the
        squares of the leaves in ``fsdp`` (this rank's columns of them) are
        summed over 'data' before the root."""
        if self.grad_clip is None:
            return None

        def sq(names):
            return sum((torch.linalg.vector_norm(grads[k].reshape(members, -1).float(), dim=1) ** 2
                        for k in names), torch.zeros(members, device=next(iter(grads.values())).device))

        total = sq([k for k in grads if k not in fsdp])
        if mesh is not None and fsdp:
            total = total + reduce_data(sq([k for k in grads if k in fsdp]), mesh)
        norm = torch.sqrt(total)
        return torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm).unsqueeze(1)

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: dict,
             generator: Optional[torch.Generator] = None, mesh=None, fsdp=()) -> None:
        """One update, in place. ``generator`` draws the stochastic
        rounding of ``lowmem`` state (required then). On a ``mesh``,
        ``params``, ``grads`` and ``state`` are this rank's member rows, and
        of the leaves named in ``fsdp`` its columns; ``grads`` are already
        summed over 'data'. The update and its bits are those of one
        process (:func:`~ladine_tpu_torch.train.lowmem.column_chunks`)."""
        if self.lowmem and generator is None:
            raise ValueError("a lowmem optimizer needs a generator for its stochastic rounding")
        count = state["count"]
        members = max(count.numel(), 1)
        col = lambda v: v.reshape(members, 1)  # noqa: E731
        scale = self.clip_scale(grads, members, mesh, fsdp)
        lr = col(self.learning_rate(count))
        n = (count + 1).float()
        bc1, bc2 = col(1 - torch.pow(self.b1, n)), col(1 - torch.pow(self.b2, n))
        slots = self._slots()
        for name, p in params.items():
            pv, gv = p.view(members, -1), grads[name].reshape(members, -1)
            sv = {s: state[s][name].view(members, -1) for s in slots}
            for shape, mine, index in column_chunks(pv.shape, leaf_window(pv, mesh, name in fsdp)):
                if mine is None:
                    if self.lowmem:
                        for _ in ("mu", "nu"):
                            skip_bits(shape, generator, p.device)
                    continue
                self._update(pv[:, mine], gv[:, mine], {s: v[:, mine] for s, v in sv.items()},
                             scale, lr, bc1, bc2, generator, (shape, index))
        count.add_(1)

    def _update(self, p, g, s, scale, lr, bc1, bc2, generator, window) -> None:
        g = g.float()
        if scale is not None:
            g = g * scale
        if self.weight_decay and self.name in ("Adam", "RMSProp"):
            g = g + self.weight_decay * p  # L2, before the moments
        if self.name in ("Adam", "AdamW"):
            m = (1 - self.b1) * g + self.b1 * s["mu"].float()
            v = (1 - self.b2) * (g * g) + self.b2 * s["nu"].float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.name == "AdamW":
                u = u + self.weight_decay * p
            self._store(s["mu"], m, generator, window)
            self._store(s["nu"], v, generator, window)
        elif self.name == "RMSProp":
            v = (1 - _RMS_DECAY) * (g * g) + _RMS_DECAY * s["nu"]
            u = g * torch.rsqrt(v + _RMS_EPS)
            s["nu"].copy_(v)
        else:  # SGD
            u = g + 0.9 * s["trace"]
            s["trace"].copy_(u)
        p.add_(u * -lr)

    def _store(self, slot, value, generator, window) -> None:
        slot.copy_(bf16_stochastic_round(value, generator, window) if self.lowmem else value)


def make_optimizer(
    name: str = "Adam",
    lr: Union[float, Schedule] = 1e-3,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    eps: float = 1e-8,
    grad_clip: Optional[float] = 1.0,
    lowmem: bool = False,
) -> Optimizer:
    """The reference's optimizers plus clipping by global norm: Adam (L2
    ``weight_decay``; ``lowmem``: bfloat16 moments with stochastic rounding,
    ``train/lowmem.py``), AdamW (decoupled decay), RMSProp (decay 0.99, eps
    1e-8, L2 ``weight_decay``) and SGD (momentum 0.9, no decay); b2 is
    0.999."""
    if name not in ("Adam", "AdamW", "RMSProp", "SGD"):
        raise NotImplementedError(f"Optimizer {name} not understood.")
    if name == "SGD":
        weight_decay = 0.0  # the reference's SGD takes none
    return Optimizer(name, lr, weight_decay, beta1, 0.999, eps, grad_clip, lowmem and name == "Adam")
