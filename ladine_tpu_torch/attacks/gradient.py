"""White-box gradient attacks through ``torch.autograd``.

Counterpart of ``ladine_tpu/attacks/gradient.py``: every attack is computed
against the classifier ``logits_fn`` (the full ViT forward in the
reference) with cross-entropy, images in [0, 1], with the foolbox 3.x
defaults the reference runs:

| reference mode | foolbox class                  | rel_stepsize | steps | random_start |
|----------------|--------------------------------|--------------|-------|--------------|
| FGSM           | LinfFastGradientAttack         | 1.0 (=eps)   | 1     | False        |
| PGD            | LinfProjectedGradientDescent   | 0.01/0.3     | 40    | True         |
| L2PGD          | L2ProjectedGradientDescent     | 0.025        | 50    | True         |
| BIM            | **L2**BasicIterativeAttack     | 0.2          | 10    | False        |
| LinfBIM        | LinfBasicIterativeAttack       | 0.2          | 10    | False        |

The step size is ``rel_stepsize * eps``. A random start draws from an
explicit ``generator`` on the images' device (Linf: uniform in the eps-box;
L2: uniform in the eps-ball, radius ~ U^(1/d)), or takes the injected start
point ``x_init``. ``logits_fn`` is any (B, H, W, C) -> (B, classes)
function of tensors; its parameters need not require grad.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def _ce_grad(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """d mean-CE / dx, in x's dtype (the loss itself in float32)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        loss = F.cross_entropy(logits_fn(xx).float(), labels.long())
        (g,) = torch.autograd.grad(loss, xx)
    return g


@torch.no_grad()
def _success(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits_fn(x), dim=-1) != labels


def _linf_project(adv, x, eps):
    return torch.minimum(torch.maximum(adv, x - eps), x + eps).clamp(0.0, 1.0)


def _l2_norm(t):
    return t.pow(2).sum(dim=(1, 2, 3), keepdim=True).sqrt()


def _l2_project(adv, x, eps):
    delta = adv - x
    factor = torch.clamp(eps / _l2_norm(delta).clamp_min(1e-12), max=1.0)
    return (x + delta * factor).clamp(0.0, 1.0)


def _l2_step(logits_fn, adv, x, labels, eps, alpha):
    g = _ce_grad(logits_fn, adv, labels)
    return _l2_project(adv + alpha * g / _l2_norm(g).clamp_min(1e-12), x, eps)


def linf_start(x: torch.Tensor, eps: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The Linf random start before its projection: ``x + U(-eps, eps)``."""
    return x + torch.empty_like(x).uniform_(-eps, eps, generator=generator)


def l2_start(x: torch.Tensor, eps: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The L2 random start before its clip: ``x + eps * r * u``, u a unit
    normal direction and r ~ U^(1/d) per image."""
    u = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    u = u / _l2_norm(u).clamp_min(1e-12)
    r = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device, dtype=x.dtype)
    return x + eps * r ** (1.0 / x[0].numel()) * u


def fgsm(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor,
         eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast Gradient Sign Method."""
    x = x.detach()
    g = _ce_grad(logits_fn, x, labels)
    adv = (x + eps * torch.sign(g)).clamp(0.0, 1.0)
    return adv, _success(logits_fn, adv, labels)


def pgd(
    logits_fn: LogitsFn,
    x: torch.Tensor,
    labels: torch.Tensor,
    eps: float,
    generator: Optional[torch.Generator] = None,
    steps: int = 40,
    rel_stepsize: float = 0.01 / 0.3,
    random_start: bool = True,
    x_init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linf projected gradient descent. The random start is
    ``x + U(-eps, eps)`` projected, or ``x_init`` projected."""
    x = x.detach()
    alpha = eps * rel_stepsize
    if x_init is None and random_start:
        x_init = linf_start(x, eps, generator)
    adv = x if x_init is None else _linf_project(x_init.to(x), x, eps)
    for _ in range(steps):
        g = _ce_grad(logits_fn, adv, labels)
        adv = _linf_project(adv + alpha * torch.sign(g), x, eps)
    return adv, _success(logits_fn, adv, labels)


def linf_bim(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor, eps: float,
             steps: int = 10, rel_stepsize: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linf Basic Iterative Method, the reference's ``LinfBIM`` mode: PGD
    with rel_stepsize 0.2, 10 steps, no random start."""
    return pgd(logits_fn, x, labels, eps, None, steps, rel_stepsize, random_start=False)


def l2_bim(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor, eps: float,
           steps: int = 10, rel_stepsize: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 Basic Iterative Method, the reference's ``BIM`` mode (foolbox's
    **L2** attack): normalized-gradient steps of 0.2 * eps, 10 steps, no
    random start, projection onto the L2 eps-ball."""
    x = x.detach()
    adv = x
    for _ in range(steps):
        adv = _l2_step(logits_fn, adv, x, labels, eps, eps * rel_stepsize)
    return adv, _success(logits_fn, adv, labels)


# the JAX package's alias for its first callers; make_attack routes the
# reference's mode names to the right norm
bim = linf_bim


def l2pgd(
    logits_fn: LogitsFn,
    x: torch.Tensor,
    labels: torch.Tensor,
    eps: float,
    generator: Optional[torch.Generator] = None,
    steps: int = 50,
    rel_stepsize: float = 0.025,
    random_start: bool = True,
    x_init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 projected gradient descent. The random start is
    ``clip(x + eps * r * u)`` with u a unit normal direction and r ~
    U^(1/d), or ``clip(x_init)``."""
    x = x.detach()
    if x_init is None and random_start:
        x_init = l2_start(x, eps, generator)
    adv = x if x_init is None else x_init.to(x).clamp(0.0, 1.0)
    for _ in range(steps):
        adv = _l2_step(logits_fn, adv, x, labels, eps, eps * rel_stepsize)
    return adv, _success(logits_fn, adv, labels)
