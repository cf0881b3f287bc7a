"""Carlini & Wagner L2 attack.

Counterpart of ``ladine_tpu/attacks/cw.py``, with the reference's foolbox
settings: ``L2CarliniWagnerAttack(binary_search_steps=6, steps=1000,
stepsize=0.01, confidence=0)``. Adam on w in tanh space, objective
||adv - x||^2 + c * max(Z_true - max Z_other + confidence, 0), the constant
c bisected per sample; the best adversarial image is the one of least L2
that fools. With ``epsilon`` the perturbation is clipped to the L2 eps-ball
and success judged on the clipped image (foolbox's second return, which the
reference consumes); ``epsilon=None`` returns the unclipped minimizer.

One forward a step: the forward that gives step i's gradient at
``to_image(w_i)`` also gives the success of step i-1's update, which the JAX
package reads from a second forward of the same image.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def cw_l2(
    logits_fn: LogitsFn,
    x: torch.Tensor,
    labels: torch.Tensor,
    binary_search_steps: int = 6,
    steps: int = 1000,
    stepsize: float = 0.01,
    confidence: float = 0.0,
    initial_const: float = 1e-3,
    epsilon: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    x, labels = x.detach(), labels.long()
    b = x.shape[0]
    dev = x.device
    x_atanh = torch.atanh(2.0 * x.clamp(1e-6, 1.0 - 1e-6) - 1.0)
    b1, b2, adam_eps = 0.9, 0.999, 1e-8

    def to_image(w):
        return (torch.tanh(w) + 1.0) / 2.0

    def l2_of(adv):
        return (adv - x).pow(2).sum(dim=(1, 2, 3))

    c = torch.full((b,), initial_const, device=dev)
    lo = torch.zeros((b,), device=dev)
    hi = torch.full((b,), 1e10, device=dev)
    best_adv = x.clone()
    best_l2 = torch.full((b,), float("inf"), device=dev)
    for _ in range(binary_search_steps):
        w = x_atanh.clone()
        m = torch.zeros_like(w)
        v = torch.zeros_like(w)
        found = torch.zeros((b,), dtype=torch.bool, device=dev)
        for i in range(steps + 1):
            with torch.enable_grad():
                w_ = w.detach().requires_grad_(i < steps)
                adv = to_image(w_)
                logits = logits_fn(adv).float()
                l2 = l2_of(adv)
            if i > 0:  # the outcome of step i-1's update, which made this w
                with torch.no_grad():
                    fooled = torch.argmax(logits, dim=-1) != labels
                    better = fooled & (l2 < best_l2)
                    best_adv = torch.where(better[:, None, None, None], adv, best_adv)
                    best_l2 = torch.where(better, l2, best_l2)
                    found |= fooled
            if i == steps:
                break
            with torch.enable_grad():
                onehot = torch.nn.functional.one_hot(labels, logits.shape[-1]).to(logits.dtype)
                z_true = (logits * onehot).sum(dim=-1)
                z_other = (logits - 1e9 * onehot).amax(dim=-1)
                f = torch.clamp(z_true - z_other + confidence, min=0.0)
                (g,) = torch.autograd.grad((l2 + c * f).sum(), w_)
            with torch.no_grad():
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mh = m / (1 - b1 ** (i + 1.0))
                vh = v / (1 - b2 ** (i + 1.0))
                w = w - stepsize * mh / (vh.sqrt() + adam_eps)
        # bisection on this round's outcome: a c that fooled becomes the
        # upper bound, one that failed the lower; x10 while unbounded
        new_hi = torch.where(found, torch.minimum(hi, c), hi)
        new_lo = torch.where(found, lo, torch.maximum(lo, c))
        c = torch.where(new_hi < 1e9, (new_lo + new_hi) / 2.0, c * 10.0)
        lo, hi = new_lo, new_hi
    if epsilon is not None:
        delta = best_adv - x
        norms = delta.pow(2).sum(dim=(1, 2, 3), keepdim=True).sqrt()
        factor = torch.clamp(epsilon / norms.clamp_min(1e-12), max=1.0)
        best_adv = (x + delta * factor).clamp(0.0, 1.0)
        with torch.no_grad():
            success = torch.argmax(logits_fn(best_adv), dim=-1) != labels
    else:
        success = torch.isfinite(best_l2)
    # unfooled samples keep the clean image
    return best_adv, success
