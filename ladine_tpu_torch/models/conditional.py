"""The epsilon_theta noise-estimator network, members stacked.

Counterpart of ``ladine_tpu/models/conditional.py::ConditionalModel``. The
JAX package stacks the members' variable trees and vmaps; here every
parameter carries a leading member axis M, so the ``linear`` encoder is a
batched ``torch.matmul`` and ``eps`` is one kernel launch per layer for all
members (``kernels/fused_eps.py``). The conv archs (``simple``, ``lenet``,
``lenet5``, ``fashioncnn``, ``resnet18``, ``resnet50``;
``models/encoders.py``) keep their encoder's tensors stacked the same way
(:class:`StackedModule`) and run it once per member; ``encode`` runs once
per image, off the reverse chain, so eps is the same for every arch.

``guidance=False`` (the reference's ``--no_cat_f_phi``) conditions lin1 on
y_t alone: lin1 is ``y_dim -> feature_dim`` and a y_hat given to ``eps`` is
ignored, as in the JAX module.

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

import functools
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.kernels.fused_eps import fused_eps
from ladine_tpu_torch.models.encoders import ARCHS, image_shape_of, make_encoder, pop_batch_stats
from ladine_tpu_torch.parallel.mesh import batch_moments

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
        y = (x.to(mul.dtype) - self.running_mean.unsqueeze(-2)) * mul.unsqueeze(-2)
        return y + self.bias.unsqueeze(-2)

    def train_forward(self, x: torch.Tensor):
        """Train mode with flax's semantics: each member's statistics over the
        batch axis of (M, B, N), in float32 (or float64 where the layer is), by the fast variance
        ``E[x^2] - E[x]^2`` clipped at 0 (biased), both to normalize and for
        the running update ``0.9 * running + 0.1 * batch``. Returns the
        float32 output and the new (running_mean, running_var), detached.
        Inside ``parallel.mesh.global_batch`` the statistics are those of
        the global batch."""
        xf = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        mean, mean_sq = batch_moments(xf, 1, keepdim=True)
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
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


class StackedModule(nn.Module):
    """M copies of one module with their tensors stacked on a leading member
    axis, under the module's own state-dict names. ``forward`` runs member
    m on the m-th slice of every tensor (``torch.func.functional_call`` on a
    template without storage) and stacks the outputs on a leading axis; in
    train mode it also returns each BatchNorm's new running statistics
    (``models.encoders.pop_batch_stats``), stacked."""

    def __init__(self, make: Callable[..., nn.Module], members: int, device=None):
        super().__init__()
        self.members = members
        object.__setattr__(self, "_make", make)
        object.__setattr__(self, "template", make(device="meta"))
        for name, child in make(device="meta").named_children():
            self.add_module(name, child)
        for mod in self.modules():
            for store in (mod._parameters, mod._buffers):
                for name, t in list(store.items()):
                    if t is not None and mod is not self:
                        stacked = torch.empty((members,) + tuple(t.shape), dtype=t.dtype, device=device)
                        store[name] = nn.Parameter(stacked, requires_grad=False) \
                            if isinstance(t, nn.Parameter) else stacked
        self.names = tuple(self.template.state_dict())

    def _tensor(self, name: str) -> torch.Tensor:
        # attribute lookup, so that functional_call's swapped tensors are seen
        return functools.reduce(getattr, name.split("."), self)

    def forward(self, x: torch.Tensor, train: bool = False):
        tensors = {k: self._tensor(k) for k in self.names}
        outs, stats = [], []
        for m in range(self.members):
            outs.append(torch.func.functional_call(self.template, {k: v[m] for k, v in tensors.items()},
                                                   (x,), {"train": train}))
            if train:
                stats.append(pop_batch_stats(self.template))
        out = torch.stack(outs)
        if not train:
            return out
        return out, {k: torch.stack([s[k] for s in stats]) for k in stats[0]}

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Each member initialized as a fresh module of its own
        (``models/initializers.py``), one after the other from ``generator``."""
        from ladine_tpu_torch.models.initializers import init_random_

        for m in range(self.members):
            one = init_random_(self._make(device=self._tensor(self.names[0]).device), generator).state_dict()
            for k in self.names:
                self._tensor(k)[m].copy_(one[k])


class ConditionalModel(nn.Module):
    """epsilon_theta(x, y_t, t, y_hat) for M stacked members.

    ``encode`` maps images to features (M, B, feature_dim) once per image
    (``linear`` and ``simple``: flat (B, data_dim); the other archs: NHWC
    (B, H, W, C), the square image of ``data_dim`` values that
    ``models.encoders.image_shape_of`` gives); ``eps`` is the per-step
    y-branch on (M, R, .) rows. The conv encoders compute in float32 whatever ``dtype`` is, as
    the JAX ones (built without a dtype) do."""

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
        arch: str = "linear",
    ):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown encoder arch {arch!r}")
        dev = resolve_device(device)
        self.members, self.data_dim, self.y_dim = members, data_dim, y_dim
        self.feature_dim, self.hidden_dim, self.n_steps = feature_dim, hidden_dim, n_steps
        self.guidance, self.arch = guidance, arch
        lin = lambda i, o: StackedLinear(members, i, o, dev, dtype)  # noqa: E731
        bn = lambda n: StackedBatchNorm(members, n, dev)  # noqa: E731
        cl = lambda i, o: ConditionalLinear(members, i, o, n_steps, dev, dtype)  # noqa: E731
        if arch == "linear":
            self.image_shape = None
            self.enc_lin1, self.enc_bn1 = lin(data_dim, hidden_dim), bn(hidden_dim)
            self.enc_lin2, self.enc_bn2 = lin(hidden_dim, hidden_dim), bn(hidden_dim)
            self.enc_lin3 = lin(hidden_dim, feature_dim)
        else:
            self.image_shape = image_shape_of(data_dim)
            self.encoder_x = StackedModule(functools.partial(make_encoder, arch, feature_dim, self.image_shape,
                                                             dtype=torch.float32), members, dev)
        self.norm = bn(feature_dim)
        self.lin1, self.unetnorm1 = cl((2 if guidance else 1) * y_dim, feature_dim), bn(feature_dim)
        self.lin2, self.unetnorm2 = cl(feature_dim, feature_dim), bn(feature_dim)
        self.lin3, self.unetnorm3 = cl(feature_dim, feature_dim), bn(feature_dim)
        self.lin4 = lin(feature_dim, y_dim)

    def like(self, members: int, device, dtype: Optional[torch.dtype]) -> "ConditionalModel":
        """A new model of this one's geometry, arch and guidance."""
        return ConditionalModel(members, self.data_dim, self.feature_dim, self.hidden_dim, self.y_dim,
                                self.n_steps, self.guidance, device, dtype, self.arch)

    def _images(self, x: torch.Tensor) -> torch.Tensor:
        if self.arch != "simple" and x.dim() != 4:
            raise ValueError(
                f"ConditionalModel(arch={self.arch!r}) encodes NHWC images (B, H, W, C), got shape "
                f"{tuple(x.shape)}. The Predictor flattens its images, as the JAX Predictor does, so it "
                "serves the archs 'linear' and 'simple' only")
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Images -> (M, B, feature_dim) float32 features. ``linear`` takes
        flat images (B, data_dim), flattened channel-last (NHWC
        ``reshape(B, -1)``) as the JAX package flattens them."""
        if self.arch != "linear":
            return self.norm(self.encoder_x(self._images(x)))
        h = F.softplus(self.enc_bn1(self.enc_lin1(x)))
        h = F.softplus(self.enc_bn2(self.enc_lin2(h)))
        return self.norm(self.enc_lin3(h))

    def eps(self, f: torch.Tensor, y: torch.Tensor, t: int, y_hat: Optional[torch.Tensor] = None,
            table=None) -> torch.Tensor:
        """features (M, R, F), y_t (M, R, C), int t, guidance (M, R, C) ->
        eps (M, R, C) in the compute dtype. ``table``: the folded gates of
        every timestep (``kernels.fused_eps.fold_table``), or None.
        Without guidance ``y_hat`` is ignored."""
        return fused_eps(self, f, y, t, y_hat, table)

    def lin1_input(self, y: torch.Tensor, y_hat: Optional[torch.Tensor]) -> torch.Tensor:
        """lin1's input: [y_t, y_hat] with guidance, y_t alone without."""
        if not self.guidance:
            return y
        if y_hat is None:
            raise ValueError("guidance=True requires y_hat")
        return torch.cat([y, y_hat], dim=-1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, t, y_hat: Optional[torch.Tensor] = None,
                train: bool = False):
        """epsilon_theta(x, y_t, t, y_hat): images as :meth:`encode` takes
        them, y_t and y_hat (M, B, C).

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

        if self.arch == "linear":
            h = F.softplus(bn("enc_bn1", self.enc_lin1(x)))
            h = F.softplus(bn("enc_bn2", self.enc_lin2(h)))
            f = bn("norm", self.enc_lin3(h))
        else:
            h, enc_stats = self.encoder_x(self._images(x), train=True)
            stats.update({f"encoder_x.{k}": v for k, v in enc_stats.items()})
            f = bn("norm", h)
        h = F.softplus(bn("unetnorm1", self.lin1(self.lin1_input(y, y_hat), t)))
        h = F.softplus(bn("unetnorm2", self.lin2(f * h, t)))
        h = F.softplus(bn("unetnorm3", self.lin3(h, t)))
        return self.lin4(h), stats
