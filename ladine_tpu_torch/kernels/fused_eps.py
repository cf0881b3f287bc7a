"""The eval-mode eps y-branch: the body of every reverse diffusion step.

Counterpart of ``ladine_tpu/kernels/fused_eps.py::fused_eps``. Each
(ConditionalLinear -> BatchNorm -> Softplus [-> f gate]) layer is one launch
of the fused kernel for all members (``kernels/fused_linear.py``): the
timestep gate and the eval BatchNorm fold into a per-member, per-unit affine
(a, c) of shape (M, N) for the step's t, and the f (.) y conditioning
rides lin1's epilogue. The samplers fold every timestep once per chain
(:func:`fold_table`), so a step launches only the layers. lin4 (N = y_dim) stays a
``torch.matmul`` plus bias, as the JAX package leaves it to ``jnp.dot``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ladine_tpu_torch.kernels.fused_linear import SMALL_K, fused_linear_act

_BN_EPS = 1e-5


def _fold(cl, bn, t):
    """(timestep gate, BN eval affine) -> float32 (a, c) such that
    layer(x) = softplus((x @ W) * a + c): each (M, N) for an int t, or
    (len(t), M, N) for a tensor of timesteps."""
    gamma = cl.embed.transpose(0, 1)[t]
    inv = bn.weight / torch.sqrt(bn.running_var + _BN_EPS)
    a = gamma * inv
    c = gamma * cl.linear.bias.float() * inv + bn.bias - bn.running_mean * inv
    return a, c


def fold_table(model, t) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """The folded (a, c) of lin1, lin2 and lin3 at timestep(s) t. A sampler
    computes them once for all timesteps (``t = torch.arange(n_steps)``) and
    passes the table to every step, which then folds nothing."""
    return tuple(
        _fold(cl, bn, t)
        for cl, bn in ((model.lin1, model.unetnorm1), (model.lin2, model.unetnorm2),
                       (model.lin3, model.unetnorm3))
    )


def fused_eps(model, f: torch.Tensor, y: torch.Tensor, t: int, y_hat: torch.Tensor,
              table=None) -> torch.Tensor:
    """(M, P, F) features + (M, R, C) y_t + int t + (M, R, C) guidance ->
    (M, R, C) eps, for a stacked ``models.conditional.ConditionalModel``;
    a model without guidance takes y_t alone into lin1 (K = C) and ignores
    y_hat. The features are a row each (P = R) or a row an image of the
    trial-major rows (P dividing R: row r takes feature row r % P), which
    lin1 reads as its gate; where lin1's K is past the small_k body's,
    whose GEMM bodies read a gate a row, they are repeated to R rows here.
    ``table``: :func:`fold_table` over all timesteps, or None to fold for t."""
    if table is None:
        (a1, c1), (a2, c2), (a3, c3) = fold_table(model, t)
    else:
        (a1, c1), (a2, c2), (a3, c3) = ((a[t], c[t]) for a, c in table)
    w1 = model.lin1.linear.weight
    y_in = model.lin1_input(y, y_hat).to(w1.dtype)
    if f.shape[-2] != y_in.shape[-2] and y_in.shape[-1] > SMALL_K:
        f = f.repeat(1, y_in.shape[-2] // f.shape[-2], 1)
    h = fused_linear_act(y_in, w1, a1, c1, mult=f)
    h = fused_linear_act(h, model.lin2.linear.weight, a2, c2)
    h = fused_linear_act(h, model.lin3.linear.weight, a3, c3)
    return model.lin4(h)
