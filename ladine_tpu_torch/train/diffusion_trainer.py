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

On a ``mesh`` (``parallel/``) a state holds this rank's member rows, and
of the leaves named in ``fsdp`` (``parallel.fsdp_plan``) its columns of
axis 1; the steps take the whole batch and every rank the same generator.
A step draws t and the noise whole and slices them, runs its member rows
on its batch rows, with the BatchNorm statistics of the global batch, sums
the gradients over 'data' and divides by its size (each rank's loss is the
mean of its rows; the BatchNorms' all-reduce already carries the other
ranks' paths back), gathers FSDP leaves whole for the forward and keeps its
columns of their gradients, and returns the whole losses on every rank.
The joint step's guidance and its optimizer stay whole on every rank, their
cross-entropy gradient summed over 'data' likewise.
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
from ladine_tpu_torch.parallel.mesh import (
    data_slice,
    gather_data,
    gather_members,
    global_batch,
    member_slice,
    mesh_shape,
    reduce_data,
    reduce_scatter_data,
    shard_data,
)
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
    mesh=None,
    fsdp=(),
) -> MemberTrainState:
    """Stacked states for ``num_members`` members of ``model``'s geometry,
    each initialized from its own seed drawn from ``generator`` (torch's
    default Linear init, U[0, 1) gates, identity BatchNorms), one member at
    a time. ``lowmem``: the bfloat16 EMA accumulator (pair it with
    ``make_optimizer(..., lowmem=True)``). On a ``mesh`` every rank draws
    every seed and makes its member rows alone, keeping its columns of the
    ``fsdp`` leaves: the parts of the one-process state."""
    dev = resolve_device(device)
    fsdp = frozenset(fsdp)

    def one(g):
        return init_random_(model.like(1, dev, torch.float32), g)

    seeds = Fn.member_seeds(generator, num_members)
    cut = None
    if mesh is not None:
        seeds = seeds[member_slice(mesh, num_members)]
        cut = lambda k, v: shard_data(v, mesh, dim=1) if k in fsdp else v  # noqa: E731
    tensors = Fn.stack_init(one, seeds, dev, cut)
    stats = {k: v for k, v in tensors.items() if k.endswith(("running_mean", "running_var"))}
    params = {k: v for k, v in tensors.items() if k not in stats}
    return MemberTrainState(
        params=params,
        batch_stats=stats,
        opt_state=tx.init(params, members=len(seeds)),
        ema=ema_init_bf16(params) if lowmem else ema_init(params),
        step=torch.zeros(len(seeds), dtype=torch.int32, device=dev),
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


def _rows(mesh, members: int, batch: int):
    """This rank's (member rows, batch rows): everything without a mesh."""
    if mesh is None:
        return slice(None), slice(None)
    return member_slice(mesh, members), data_slice(mesh, batch)


def _member_update(model, tx, sched, ema_rate, noise_prior, mesh, fsdp) -> Callable:
    """The members' update on this rank's inputs:

        update(state, x_flat (b, D), y0 (b, C), y0_hat (m, b, C), shape,
               generator, t, noise) -> (state, losses (M,))

    with the whole (M, B, C) ``shape``: t and noise, drawn or injected,
    are whole and sliced here."""
    fsdp = frozenset(fsdp)
    d = 1 if mesh is None else mesh_shape(mesh)[1]
    if mesh is not None:
        # the forward runs this rank's member rows
        model = model.like(model.members // mesh_shape(mesh)[0], "meta", model.lin2.linear.weight.dtype)

    def whole(tensors):  # the FSDP leaves gathered (none without a mesh)
        return {k: gather_data(v, mesh, dim=1) if k in fsdp else v for k, v in tensors.items()}

    def update(state: MemberTrainState, x_flat, y0, y0_hat, shape, generator, t, noise):
        dev = x_flat.device
        y0_hat = y0_hat.float()
        t, noise = _draws(generator, t, noise, shape, sched.num_timesteps, dev)
        rows, cols = _rows(mesh, shape[0], shape[1])
        t, noise = t[rows, cols], noise[rows, cols]
        y_T_mean = torch.zeros_like(y0_hat) if noise_prior else y0_hat
        y_t = q_sample(y0.float().expand_as(y0_hat), y_T_mean, sched, t, noise)
        buffers = whole(state.batch_stats)

        def loss_fn(params):
            eps, stats = Fn.call(model, params, x_flat, y_t, t, y0_hat, buffers=buffers, train=True)
            return ((noise - eps.float()) ** 2).mean(dim=(1, 2)), stats

        with global_batch(mesh):
            losses, stats, grads = Fn.value_and_grad(loss_fn, whole(state.params))
        if mesh is not None:
            grads = {k: (reduce_scatter_data(g, mesh, 1) if k in fsdp else reduce_data(g, mesh)).div_(d)
                     for k, g in grads.items()}
            stats = {k: shard_data(v, mesh, dim=1) if k in fsdp else v for k, v in stats.items()}
            losses = gather_members(reduce_data(losses, mesh).div_(d), mesh)
        tx.step(state.params, grads, state.opt_state, generator, mesh, fsdp)
        del grads
        state.batch_stats = stats
        # the accumulator's dtype selects the rule: bfloat16 state rounds
        # stochastically ((1 - mu) increments are below its ulp)
        if next(iter(state.ema.values())).dtype == torch.bfloat16:
            ema_update_sr(state.ema, state.params, ema_rate, generator, mesh, fsdp)
        else:
            ema_update(state.ema, state.params, ema_rate)
        state.step.add_(1)
        return state, losses

    return update


def make_multi_member_step(
    model: ConditionalModel,
    tx: Optimizer,
    sched: DiffusionSchedule,
    ema_rate: float = 0.9999,
    noise_prior: bool = False,
    mesh=None,
    fsdp=(),
) -> Callable:
    """All members advance on the same batch, each conditioned on its own
    guidance head:

        step(states, x_flat (B, D), y0 (B, C), y0_hat_members (M, B, C),
             generator=None, t=None, noise=None) -> (states, losses (M,))

    ``model`` is the compute module of the M members (its tensors' dtypes
    are the compute dtypes). ``noise_prior`` zeroes the forward process's
    prior mean and keeps the y0_hat conditioning. ``mesh``, ``fsdp``: the
    module docstring; the inputs stay whole."""
    update = _member_update(model, tx, sched, ema_rate, noise_prior, mesh, fsdp)

    def step(state: MemberTrainState, x_flat, y0, y0_hat, generator=None, t=None, noise=None):
        rows, cols = _rows(mesh, y0_hat.shape[0], x_flat.shape[0])
        return update(state, x_flat[cols], y0[cols], y0_hat[rows, cols], tuple(y0_hat.shape),
                      generator, t, noise)

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
    mesh=None,
    fsdp=(),
) -> Callable:
    """The whole step: images through the frozen guidance (no grad), then
    the diffusion update of every member:

        step(states, images NHWC, labels, generator=None, t=None, noise=None)
            -> (states, losses (M,))

    ``head_indices`` selects the heads that condition the members (default
    0..M-1; one index reproduces the reference's per-member run, with a
    state of one member); the guidance runs ``heads_subset``, whose heads
    equal its full forward's, so the ViT runs only to the deepest tap. On a
    ``mesh`` the guidance runs every head on this rank's batch rows, as on
    one device, and its member rows take theirs."""
    update = _member_update(model, tx, sched, ema_rate, noise_prior, mesh, fsdp)
    idx = _heads(num_members, head_indices)

    def step(states, images, labels, generator=None, t=None, noise=None):
        b = images.shape[0]
        rows, cols = _rows(mesh, len(idx), b)
        images, labels = images[cols], labels[cols]
        with torch.no_grad():  # every head, as on one device; this rank's members condition
            y0_hat = torch.softmax(guidance.heads_subset(images, idx), dim=-1)[rows]
        y0, _ = one_hot_and_prototype(labels, num_classes)
        return update(states, images.reshape(images.shape[0], -1), y0, y0_hat,
                      (len(idx), b, y0.shape[1]), generator, t, noise)

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
    mesh=None,
    fsdp=(),
) -> Callable:
    """Joint training of the members and the guidance classifier: a
    cross-entropy step on all K+1 guidance heads with ``aux_tx``, then the
    members' step conditioned on the updated guidance (no grad):

        step(states, gparams, aux_opt_state, images, labels, generator=None,
             t=None, noise=None)
            -> (states, gparams, aux_opt_state, aux_loss, losses (M,))

    ``gparams`` are the guidance's float32 masters by state-dict name;
    ``guidance`` is its compute module. On a ``mesh`` they and the aux
    state are whole on every rank; the cross-entropy gradient is summed over
    'data'."""
    update = _member_update(model, tx, sched, ema_rate, noise_prior, mesh, fsdp)
    idx = list(_heads(num_members, head_indices))
    d = 1 if mesh is None else mesh_shape(mesh)[1]

    def aux_loss_fn(params, images, labels):
        logp = torch.log_softmax(Fn.call(guidance, params, images), dim=-1)  # (K+1, B, C)
        index = labels.reshape(1, -1, 1).expand(logp.shape[0], -1, 1)
        return -logp.gather(-1, index).mean(), None

    def step(states, gparams, aux_opt_state, images, labels, generator=None, t=None, noise=None):
        b = images.shape[0]
        rows, cols = _rows(mesh, len(idx), b)
        images, labels = images[cols], labels[cols]
        aux_loss, _, grads = Fn.value_and_grad(lambda p: aux_loss_fn(p, images, labels), gparams)
        if mesh is not None:
            grads = {k: reduce_data(g, mesh).div_(d) for k, g in grads.items()}
            aux_loss = reduce_data(aux_loss, mesh).div_(d)
        aux_tx.step(gparams, grads, aux_opt_state, generator)
        del grads
        with torch.no_grad():
            y0_hat = torch.softmax(Fn.call(guidance, gparams, images), dim=-1)[idx[rows]]
        y0, _ = one_hot_and_prototype(labels, num_classes)
        states, losses = update(states, images.reshape(images.shape[0], -1), y0, y0_hat,
                                (len(idx), b, y0.shape[1]), generator, t, noise)
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
    EMA is debiased a member at a time, straight into the module. The
    geometry is read off the state: arch ``linear`` (a conv arch's
    parameters do not hold the image size), guidance from lin1's width."""
    p = state.params
    if "enc_lin1.weight" not in p:
        raise ValueError("conditional_model_from_state reads the geometry of arch 'linear' states only")
    m, data_dim, hidden = p["enc_lin1.weight"].shape
    y_dim = p["lin4.weight"].shape[2]
    model = ConditionalModel(m, data_dim, p["enc_lin3.weight"].shape[2], hidden, y_dim, p["lin1.embed"].shape[1],
                             guidance=p["lin1.linear.weight"].shape[1] == 2 * y_dim, device=device, dtype=dtype)
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
