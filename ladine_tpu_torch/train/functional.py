"""Float32 master parameters, a module of the compute dtype, gradients.

The JAX package differentiates pure functions of parameter trees, and a
flax ``Dense(dtype=bf16)`` keeps float32 parameters and casts them at
compute. The trainers here do the same with dicts of float32 master tensors
(by ``state_dict`` name): :func:`call` runs a module on the masters cast to
that module's own tensor dtypes (``torch.func.functional_call``), so one
module of the compute dtype, even one on the ``meta`` device with no
storage, serves every step; :func:`value_and_grad` differentiates a
function of the masters. The module's own tensors and layout are never
touched, so serving stays as it is.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

Tensors = Dict[str, torch.Tensor]


def cast_like(module: nn.Module, tensors: Tensors) -> Tensors:
    """Each tensor cast to the dtype of the module's tensor of that name (no
    copy where they agree; under autograd the cast's gradient is the
    master's)."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    return {k: v.to(own[k].dtype) for k, v in tensors.items()}


def call(module: nn.Module, params: Tensors, *args, buffers: Optional[Tensors] = None, **kwargs):
    """``module(*args, **kwargs)`` on ``params`` cast by :func:`cast_like`
    and ``buffers`` as they are."""
    tensors = cast_like(module, params)
    tensors.update(buffers or {})
    return torch.func.functional_call(module, tensors, args, kwargs, strict=True)


def value_and_grad(fn: Callable[[Tensors], Tuple[torch.Tensor, object]], params: Tensors):
    """``fn(params) -> (loss, aux)`` and the gradient of ``loss.sum()``
    with respect to every tensor of ``params``: returns (loss detached,
    aux, grads by name). ``params`` are not modified and need not require
    grad."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, aux = fn(leaves)
        grads: List[torch.Tensor] = torch.autograd.grad(loss.sum(), list(leaves.values()))
    return loss.detach(), aux, dict(zip(leaves, grads))


def member_seeds(generator: torch.Generator, n: int) -> List[int]:
    """n seeds drawn from ``generator``: member k initializes from seed k
    alone, so a subset of members initializes as in the full stack."""
    return torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()


def stack_init(make: Callable[[torch.Generator], nn.Module], seeds: List[int], device,
               cut: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None) -> Tensors:
    """Float32 state-dict tensors of len(seeds) modules stacked on a leading
    axis. ``make(generator)`` builds and initializes one float32 module on
    ``device`` (a member-stacked module of one member, whose axis becomes a
    row of the stack, or a plain module); each is copied into the stack and
    freed before the next, so the stack is never held twice. ``cut(name,
    row)`` keeps a part of each row (a rank's columns on a mesh)."""
    out: Tensors = {}
    for i, seed in enumerate(seeds):
        one = make(torch.Generator(device=device).manual_seed(seed))
        member_axis = getattr(one, "members", None) == 1
        for k, v in one.state_dict().items():
            rows = v if member_axis else v.unsqueeze(0)
            if cut is not None:
                rows = cut(k, rows)
            if k not in out:
                out[k] = torch.empty((len(seeds),) + rows.shape[1:], dtype=rows.dtype, device=device)
            out[k][i:i + 1].copy_(rows)
        del one
    return out
