"""Diffusion-member training: the CARD epsilon-matching objective.

Counterpart of ``ladine_tpu/train/diffusion_trainer.py``: antithetic
timesteps, the guidance softmax as both the conditioning and the prior mean,
a ``q_sample`` forward draw, the MSE on epsilon, clipping at 1.0 and Adam
(``train/optim.py``), then the EMA (``train/ema.py``; bfloat16 with
``lowmem``, ``train/lowmem.py``).

The port's members are stacked on a leading axis in one module, so the
multi-member step is the natural form: every member takes its own draws,
BatchNorm statistics, clipping norm and step count, as under the JAX
package's vmap, and the member step is the case M = 1. The state holds
float32 master parameters; the forward runs a ``ConditionalModel`` of the
compute dtype on them (``train/functional.py``), which may live on the
``meta`` device.

Random draws come from a ``torch.Generator`` on the state's device (t and
the noise, then the stochastic rounding of ``lowmem`` state), or are
injected: ``t`` (M, B) and ``noise`` (M, B, C), the layout in which the
tests inject the JAX package's draws. Every function updates the state in
place and returns it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.models.conditional import ConditionalModel
from ladine_tpu_torch.models.guidance import SEViTGuidance
from ladine_tpu_torch.models.initializers import init_random_
from ladine_tpu_torch.ops.diffusion import antithetic_timesteps, q_sample
from ladine_tpu_torch.ops.labels import one_hot_and_prototype
from ladine_tpu_torch.ops.schedules import DiffusionSchedule
from ladine_tpu_torch.train import functional as Fn
from ladine_tpu_torch.train.ema import debias_scale, ema_init, ema_update
from ladine_tpu_torch.train.lowmem import ema_init_bf16, ema_update_sr
from ladine_tpu_torch.train.optim import Optimizer, Tensors


@dataclass
class MemberTrainState:
    """Everything of M stacked members: float32 master ``params`` and
    ``batch_stats`` (the BatchNorms' running statistics) by the
    ``ConditionalModel`` state-dict names, the optimizer state, the EMA
    accumulator (float32, or bfloat16 with ``lowmem``) and the update count
    of each member, ``step`` (M,) int32."""

    params: Tensors
    batch_stats: Tensors
    opt_state: dict
    ema: Tensors
    step: torch.Tensor


def create_member_states(
    model: ConditionalModel,
    generator: torch.Generator,
    tx: Optimizer,
    num_members: int,
    lowmem: bool = False,
    device="cuda",
) -> MemberTrainState:
    """Stacked states for ``num_members`` members of ``model``'s geometry,
    each initialized from its own seed drawn from ``generator`` (torch's
    default Linear init, U[0, 1) gates, identity BatchNorms), one member at
    a time. ``lowmem``: the bfloat16 EMA accumulator (pair it with
    ``make_optimizer(..., lowmem=True)``)."""
    dev = resolve_device(device)
    geometry = (model.data_dim, model.feature_dim, model.hidden_dim, model.y_dim, model.n_steps)

    def one(g):
        return init_random_(ConditionalModel(1, *geometry, device=dev, dtype=torch.float32), g)

    tensors = Fn.stack_init(one, Fn.member_seeds(generator, num_members), dev)
    stats = {k: v for k, v in tensors.items() if k.endswith(("running_mean", "running_var"))}
    params = {k: v for k, v in tensors.items() if k not in stats}
    return MemberTrainState(
        params=params,
        batch_stats=stats,
        opt_state=tx.init(params, members=num_members),
        ema=ema_init_bf16(params) if lowmem else ema_init(params),
        step=torch.zeros(num_members, dtype=torch.int32, device=dev),
    )


def create_member_state(model: ConditionalModel, generator: torch.Generator, tx: Optimizer,
                        lowmem: bool = False, device="cuda") -> MemberTrainState:
    """One member's state: the stack of one."""
    return create_member_states(model, generator, tx, 1, lowmem, device)


def _draws(generator, t, noise, shape, num_timesteps, device):
    m, n, c = shape
    if (t is None or noise is None) and generator is None:
        raise ValueError("pass a generator, or inject both t and noise")
    if t is None:
        t = antithetic_timesteps(generator, n, num_timesteps, (m,), device=device)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    return t.to(device), noise.to(device=device, dtype=torch.float32)


def make_multi_member_step(
    model: ConditionalModel,
    tx: Optimizer,
    sched: DiffusionSchedule,
    ema_rate: float = 0.9999,
    noise_prior: bool = False,
) -> Callable:
    """All members advance on the same batch, each conditioned on its own
    guidance head:

        step(states, x_flat (B, D), y0 (B, C), y0_hat_members (M, B, C),
             generator=None, t=None, noise=None) -> (states, losses (M,))

    ``model`` is the compute module (its tensors' dtypes are the compute
    dtypes). ``noise_prior`` zeroes the forward process's prior mean and
    keeps the y0_hat conditioning."""

    def step(state: MemberTrainState, x_flat, y0, y0_hat, generator=None, t=None, noise=None):
        dev = x_flat.device
        y0_hat = y0_hat.float()
        t, noise = _draws(generator, t, noise, tuple(y0_hat.shape), sched.num_timesteps, dev)
        y_T_mean = torch.zeros_like(y0_hat) if noise_prior else y0_hat
        y_t = q_sample(y0.float().expand_as(y0_hat), y_T_mean, sched, t, noise)

        def loss_fn(params):
            eps, stats = Fn.call(model, params, x_flat, y_t, t, y0_hat,
                                 buffers=state.batch_stats, train=True)
            return ((noise - eps.float()) ** 2).mean(dim=(1, 2)), stats

        losses, stats, grads = Fn.value_and_grad(loss_fn, state.params)
        tx.step(state.params, grads, state.opt_state, generator)
        del grads
        state.batch_stats = stats
        # the accumulator's dtype selects the rule: bfloat16 state rounds
        # stochastically ((1 - mu) increments are below its ulp)
        if next(iter(state.ema.values())).dtype == torch.bfloat16:
            ema_update_sr(state.ema, state.params, ema_rate, generator)
        else:
            ema_update(state.ema, state.params, ema_rate)
        state.step.add_(1)
        return state, losses

    return step


def make_member_step(
    model: ConditionalModel,
    tx: Optimizer,
    sched: DiffusionSchedule,
    ema_rate: float = 0.9999,
    noise_prior: bool = False,
) -> Callable:
    """One member's step (a state of one member):

        step(state, x_flat, y0, y0_hat (B, C), generator=None, t=None (B,),
             noise=None (B, C)) -> (state, loss)"""
    multi = make_multi_member_step(model, tx, sched, ema_rate, noise_prior)

    def step(state, x_flat, y0, y0_hat, generator=None, t=None, noise=None):
        lead = lambda v: None if v is None else v.unsqueeze(0)  # noqa: E731
        state, losses = multi(state, x_flat, y0, y0_hat.unsqueeze(0), generator, lead(t), lead(noise))
        return state, losses[0]

    return step


def _heads(num_members: int, head_indices: Optional[Sequence[int]]) -> tuple:
    """The guidance heads that condition the stacked members: ``head_indices``
    (one index reproduces the reference's per-member run) or 0..M-1."""
    return tuple(int(i) for i in head_indices) if head_indices is not None else tuple(range(num_members))


def make_full_train_step(
    guidance: SEViTGuidance,
    model: ConditionalModel,
    tx: Optimizer,
    sched: DiffusionSchedule,
    num_members: int,
    num_classes: int,
    ema_rate: float = 0.9999,
    head_indices: Optional[Sequence[int]] = None,
    noise_prior: bool = False,
) -> Callable:
    """The whole step: images through the frozen guidance (no grad), then
    the diffusion update of every member:

        step(states, images NHWC, labels, generator=None, t=None, noise=None)
            -> (states, losses (M,))

    ``head_indices`` selects the heads that condition the members (default
    0..M-1; one index reproduces the reference's per-member run, with a
    state of one member); the guidance runs ``heads_subset``, whose heads
    equal its full forward's, so the ViT runs only to the deepest tap."""
    multi = make_multi_member_step(model, tx, sched, ema_rate, noise_prior)
    idx = _heads(num_members, head_indices)

    def step(states, images, labels, generator=None, t=None, noise=None):
        with torch.no_grad():
            y0_hat = torch.softmax(guidance.heads_subset(images, idx), dim=-1)
        y0, _ = one_hot_and_prototype(labels, num_classes)
        return multi(states, images.reshape(images.shape[0], -1), y0, y0_hat, generator, t, noise)

    return step


def make_joint_train_step(
    guidance: SEViTGuidance,
    model: ConditionalModel,
    tx: Optimizer,
    aux_tx: Optimizer,
    sched: DiffusionSchedule,
    num_members: int,
    num_classes: int,
    ema_rate: float = 0.9999,
    head_indices: Optional[Sequence[int]] = None,
    noise_prior: bool = False,
) -> Callable:
    """Joint training of the members and the guidance classifier: a
    cross-entropy step on all K+1 guidance heads with ``aux_tx``, then the
    members' step conditioned on the updated guidance (no grad):

        step(states, gparams, aux_opt_state, images, labels, generator=None,
             t=None, noise=None)
            -> (states, gparams, aux_opt_state, aux_loss, losses (M,))

    ``gparams`` are the guidance's float32 masters by state-dict name;
    ``guidance`` is its compute module."""
    multi = make_multi_member_step(model, tx, sched, ema_rate, noise_prior)
    idx = list(_heads(num_members, head_indices))

    def aux_loss_fn(params, images, labels):
        logp = torch.log_softmax(Fn.call(guidance, params, images), dim=-1)  # (K+1, B, C)
        index = labels.reshape(1, -1, 1).expand(logp.shape[0], -1, 1)
        return -logp.gather(-1, index).mean(), None

    def step(states, gparams, aux_opt_state, images, labels, generator=None, t=None, noise=None):
        aux_loss, _, grads = Fn.value_and_grad(lambda p: aux_loss_fn(p, images, labels), gparams)
        aux_tx.step(gparams, grads, aux_opt_state, generator)
        del grads
        with torch.no_grad():
            y0_hat = torch.softmax(Fn.call(guidance, gparams, images), dim=-1)[idx]
        y0, _ = one_hot_and_prototype(labels, num_classes)
        states, losses = multi(states, images.reshape(images.shape[0], -1), y0, y0_hat, generator, t, noise)
        return states, gparams, aux_opt_state, aux_loss, losses

    return step


@torch.no_grad()
def conditional_model_from_state(
    state: MemberTrainState,
    use_ema: bool = True,
    ema_rate: float = 0.9999,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> ConditionalModel:
    """The hand-off from training to serving: a ``ConditionalModel`` of
    ``dtype`` (the layout ``Predictor`` takes) holding the state's debiased
    EMA (``use_ema``) or raw parameters, with its running statistics. The
    EMA is debiased a member at a time, straight into the module."""
    p = state.params
    m, data_dim, hidden = p["enc_lin1.weight"].shape
    model = ConditionalModel(m, data_dim, p["enc_lin3.weight"].shape[2], hidden, p["lin4.weight"].shape[2],
                             p["lin1.embed"].shape[1], device=device, dtype=dtype)
    target = model.state_dict()
    scale = debias_scale(ema_rate, state.step).tolist()
    for k, v in target.items():
        if k in state.batch_stats:
            v.copy_(state.batch_stats[k])
        elif not use_ema:
            v.copy_(p[k])
        else:
            e = state.ema[k]
            for i in range(m):
                # the JAX read rounds the product to the accumulator's dtype
                v[i].copy_((e[i].float() * scale[i]).to(e.dtype))
    return model
