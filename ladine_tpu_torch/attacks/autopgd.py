"""APGD-CE (Auto-PGD with cross-entropy), the AutoAttack component the
reference runs for its AUTOPGD mode (Linf).

Counterpart of ``ladine_tpu/attacks/autopgd.py`` (Croce & Hein, ICML 2020,
Algorithm 1): momentum PGD with an automatic step size. At checkpoint
iterations, p_{j+1} = p_j + max(p_j - p_{j-1} - 0.03, 0.06) from (0, 0.22),
each sample's step is halved and its iterate reset to its best point if
(1) fewer than rho x interval of the steps since the last checkpoint
improved its objective (the paper's strict ``<``), or (2) its step was not
halved last time and its best objective did not improve. Step sizes and
counters are per sample.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ladine_tpu_torch.attacks.gradient import linf_start

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def _checkpoints(n_iter: int) -> np.ndarray:
    """(n_iter + 1,) flags: True at the checkpoint iterations."""
    ps = [0.0, 0.22]
    while ps[-1] < 1.0:
        ps.append(ps[-1] + max(ps[-1] - ps[-2] - 0.03, 0.06))
    pts = sorted({int(np.ceil(p * n_iter)) for p in ps if p <= 1.0})
    flags = np.zeros(n_iter + 1, bool)
    for p in pts:
        if 0 < p <= n_iter:
            flags[p] = True
    return flags


def apgd_ce(
    logits_fn: LogitsFn,
    x: torch.Tensor,
    labels: torch.Tensor,
    eps: float,
    generator: Optional[torch.Generator] = None,
    n_iter: int = 100,
    rho: float = 0.75,
    alpha_momentum: float = 0.75,
    x_init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x_init`` overrides the random start ``x + U(-eps, eps)`` (both are
    projected onto the eps-box and [0, 1])."""
    x, labels = x.detach(), labels.long()
    flags = _checkpoints(n_iter)
    interval_at = np.zeros(n_iter + 1, np.float32)  # steps since the previous checkpoint
    prev = 0
    for i in np.flatnonzero(flags):
        interval_at[i] = i - prev
        prev = i

    def ce(xx):
        logp = torch.log_softmax(logits_fn(xx).float(), dim=-1)
        return -logp.gather(1, labels[:, None])[:, 0]  # per-sample CE

    def grad(xx):
        with torch.enable_grad():
            xx = xx.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(ce(xx).sum(), xx)
        return g

    def project(z):
        return torch.minimum(torch.maximum(z, x - eps), x + eps).clamp(0.0, 1.0)

    def rows(mask):
        return mask[:, None, None, None]

    with torch.no_grad():
        if x_init is None:
            x_init = linf_start(x, eps, generator)
        x0 = project(x_init.to(x))
        f0 = ce(x0)
        eta = torch.full((x.shape[0], 1, 1, 1), 2.0 * eps, device=x.device)
        x1 = project(x0 + eta * torch.sign(grad(x0)))
        f1 = ce(x1)
        better1 = f1 > f0
        x_k, x_prev, f_k = x1, x0, f1
        x_best = torch.where(rows(better1), x1, x0)
        f_best = torch.maximum(f0, f1)
        f_last = f_best
        reduced = torch.zeros_like(better1)
        improved = better1.float()
        for k in range(2, n_iter + 1):
            z = project(x_k + eta * torch.sign(grad(x_k)))
            x_new = project(x_k + alpha_momentum * (z - x_k) + (1 - alpha_momentum) * (x_k - x_prev))
            f_new = ce(x_new)
            better = f_new > f_best
            x_best = torch.where(rows(better), x_new, x_best)
            f_best = torch.maximum(f_new, f_best)
            # steps where f(x^{k+1}) > f(x^k): the previous iterate, not the best
            improved = improved + (f_new > f_k).float()
            x_prev, x_k, f_k = x_k, x_new, f_new
            if flags[k]:
                halve = (improved < rho * max(float(interval_at[k]), 1.0)) | (~reduced & (f_last >= f_best))
                eta = torch.where(rows(halve), eta / 2.0, eta)
                # on halving, restart from the best point
                x_k = torch.where(rows(halve), x_best, x_k)
                x_prev = torch.where(rows(halve), x_best, x_prev)
                f_k = torch.where(halve, f_best, f_k)
                f_last, reduced, improved = f_best, halve, torch.zeros_like(improved)
        return x_best, torch.argmax(logits_fn(x_best), dim=-1) != labels
