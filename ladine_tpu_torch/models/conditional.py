"""The epsilon_theta noise-estimator network, members stacked.

Counterpart of ``ladine_tpu/models/conditional.py::ConditionalModel`` for
the ``linear`` encoder arch. The JAX package stacks the members' variable
trees and vmaps; here every parameter carries a leading member axis M, so
the encoder is a batched ``torch.matmul`` and ``eps`` is one kernel launch
per layer for all members (``kernels/fused_eps.py``).

Train mode (``forward(..., train=True)``) is plain PyTorch, as flax's is
XLA's: per-row timestep gates, and BatchNorm on the batch's own statistics
with flax's running update (:meth:`StackedBatchNorm.train_forward`). The
trainer (``train/diffusion_trainer.py``) keeps float32 master parameters
and calls a module of the compute dtype through
``torch.func.functional_call`` with the masters cast to that module's
tensor dtypes, as a flax ``Dense(dtype=...)`` casts its float32 parameters
at compute; the module's own layout, and so serving, is unchanged.

Dense weights keep the flax layout ``(M, in, out)``, which is the layout the
eps kernel reads. BatchNorm parameters, running statistics and the timestep
gates are float32 whatever the compute dtype. As flax's BatchNorm does, the
eval affine promotes its input to float32 and returns float32, so ``encode``
gives float32 features in every compute dtype; the next ``StackedLinear``
casts its input to the weight dtype, as a flax ``Dense(dtype=...)`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.kernels.fused_eps import fused_eps

_BN_EPS = 1e-5  # torch BatchNorm1d default
# flax's momentum weights the OLD running value (torch's momentum 0.1 the new)
_BN_MOMENTUM = 0.9


def _frozen(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype), requires_grad=False)


class StackedLinear(nn.Module):
    """M dense layers: out[m] = x[m] @ weight[m] + bias[m]."""

    def __init__(self, members: int, in_features: int, out_features: int, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.weight = _frozen(members, in_features, out_features, device=device, dtype=dtype)
        self.bias = _frozen(members, out_features, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, in) shared by all members, or (M, B, in) -> (M, B, out)."""
        x = x.to(self.weight.dtype)
        return torch.matmul(x, self.weight) + self.bias.unsqueeze(-2)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = self.in_features**-0.5  # torch nn.Linear default
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)


class StackedBatchNorm(nn.Module):
    """M eval-mode BatchNorm1d layers over (M, B, N) inputs, eps 1e-5."""

    def __init__(self, members: int, features: int, device=None):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = _frozen(members, features, **f32)
        self.bias = _frozen(members, features, **f32)
        self.register_buffer("running_mean", torch.empty(members, features, **f32))
        self.register_buffer("running_var", torch.empty(members, features, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's order: (x - mean) * (scale * rsqrt(var + eps)) + bias
        mul = torch.rsqrt(self.running_var + _BN_EPS) * self.weight
        y = (x.float() - self.running_mean.unsqueeze(-2)) * mul.unsqueeze(-2)
        return y + self.bias.unsqueeze(-2)

    def train_forward(self, x: torch.Tensor):
        """Train mode with flax's semantics: each member's statistics over the
        batch axis of (M, B, N), in float32, by the fast variance
        ``E[x^2] - E[x]^2`` clipped at 0 (biased), both to normalize and for
        the running update ``0.9 * running + 0.1 * batch``. Returns the
        float32 output and the new (running_mean, running_var), detached."""
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=1, keepdim=True) - mean * mean, 0.0)
        y = (xf - mean) * (torch.rsqrt(var + _BN_EPS) * self.weight.unsqueeze(-2))
        y = y + self.bias.unsqueeze(-2)
        m = _BN_MOMENTUM
        new_mean = m * self.running_mean + (1 - m) * mean.detach().squeeze(1)
        new_var = m * self.running_var + (1 - m) * var.detach().squeeze(1)
        return y, new_mean, new_var

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class ConditionalLinear(nn.Module):
    """Linear + per-timestep multiplicative gate ``embed[t]`` (M members).

    At eval the gate folds with the following BatchNorm into the eps
    kernel's affine (``kernels/fused_eps.py``)."""

    def __init__(self, members: int, in_features: int, out_features: int, n_steps: int,
                 device=None, dtype=None):
        super().__init__()
        self.linear = StackedLinear(members, in_features, out_features, device, dtype)
        self.embed = _frozen(members, n_steps, out_features, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Train mode: ``embed[t] * linear(x)`` with per-row timesteps t of
        shape (M, B); the gate takes the output's dtype, as in flax."""
        out = self.linear(x)
        members = torch.arange(t.shape[0], device=t.device).unsqueeze(1)
        return self.embed[members, t].to(out.dtype) * out

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embed.uniform_(0.0, 1.0, generator=generator)  # reference init U[0, 1)


class ConditionalModel(nn.Module):
    """epsilon_theta(x, y_t, t, y_hat) for M stacked members, arch 'linear'.

    ``encode`` maps flat images (B, data_dim) to features (M, B, feature_dim)
    once per image; ``eps`` is the per-step y-branch on (M, R, .) rows."""

    def __init__(
        self,
        members: int = 5,
        data_dim: int = 150528,
        feature_dim: int = 4096,
        hidden_dim: int = 4096,
        y_dim: int = 2,
        n_steps: int = 1001,
        guidance: bool = True,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if not guidance:
            raise NotImplementedError("the port's eps takes the guidance y_hat (guidance=True)")
        dev = resolve_device(device)
        self.members, self.data_dim, self.y_dim = members, data_dim, y_dim
        self.feature_dim, self.hidden_dim, self.n_steps = feature_dim, hidden_dim, n_steps
        lin = lambda i, o: StackedLinear(members, i, o, dev, dtype)  # noqa: E731
        bn = lambda n: StackedBatchNorm(members, n, dev)  # noqa: E731
        cl = lambda i, o: ConditionalLinear(members, i, o, n_steps, dev, dtype)  # noqa: E731
        self.enc_lin1, self.enc_bn1 = lin(data_dim, hidden_dim), bn(hidden_dim)
        self.enc_lin2, self.enc_bn2 = lin(hidden_dim, hidden_dim), bn(hidden_dim)
        self.enc_lin3, self.norm = lin(hidden_dim, feature_dim), bn(feature_dim)
        self.lin1, self.unetnorm1 = cl(2 * y_dim, feature_dim), bn(feature_dim)
        self.lin2, self.unetnorm2 = cl(feature_dim, feature_dim), bn(feature_dim)
        self.lin3, self.unetnorm3 = cl(feature_dim, feature_dim), bn(feature_dim)
        self.lin4 = lin(feature_dim, y_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, data_dim) flat images -> (M, B, feature_dim) float32 features.

        Images are flattened channel-last (NHWC ``reshape(B, -1)``), as the
        JAX package flattens them."""
        h = F.softplus(self.enc_bn1(self.enc_lin1(x)))
        h = F.softplus(self.enc_bn2(self.enc_lin2(h)))
        return self.norm(self.enc_lin3(h))

    def eps(self, f: torch.Tensor, y: torch.Tensor, t: int, y_hat: torch.Tensor,
            table=None) -> torch.Tensor:
        """features (M, R, F), y_t (M, R, C), int t, guidance (M, R, C) ->
        eps (M, R, C) in the compute dtype. ``table``: the folded gates of
        every timestep (``kernels.fused_eps.fold_table``), or None."""
        return fused_eps(self, f, y, t, y_hat, table)

    def forward(self, x: torch.Tensor, y: torch.Tensor, t, y_hat: torch.Tensor, train: bool = False):
        """epsilon_theta(x, y_t, t, y_hat): flat images (B, data_dim), y_t and
        y_hat (M, B, C).

        Eval (int t): ``eps(encode(x), ...)``, the kernels' path. Train (t of
        shape (M, B), one timestep a row): plain PyTorch on the batch's
        statistics; returns ``(eps, new_batch_stats)``, the running
        statistics by buffer name, as flax's ``mutable=["batch_stats"]``."""
        if not train:
            return self.eps(self.encode(x), y, t, y_hat)
        stats = {}

        def bn(name, h):
            out, stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = \
                getattr(self, name).train_forward(h)
            return out

        h = F.softplus(bn("enc_bn1", self.enc_lin1(x)))
        h = F.softplus(bn("enc_bn2", self.enc_lin2(h)))
        f = bn("norm", self.enc_lin3(h))
        h = F.softplus(bn("unetnorm1", self.lin1(torch.cat([y, y_hat], dim=-1), t)))
        h = F.softplus(bn("unetnorm2", self.lin2(f * h, t)))
        h = F.softplus(bn("unetnorm3", self.lin3(h, t)))
        return self.lin4(h), stats
