"""Stage-1 trainers: the ViT fine-tune and the mapping MLPs.

Counterpart of ``ladine_tpu/train/classifier_trainer.py``:

* the stage-1 fine-tune (the reference: timm ViT-B/16 with a fresh class
  head, AdamW lr 1e-4 wd 0.1, StepLR(10, 0.5), cross-entropy), of the ViT
  or any backbone of ``models/backbones.py`` and ``models/encoders.py``
  (``ResNet``); a BatchNorm backbone carries its running statistics in
  ``TrainState.batch_stats``, updated by every train step as flax's
  ``mutable=["batch_stats"]`` updates them;
* the mapping MLPs: MLP k on the frozen ViT's bare-patch tap after block
  k+1 (Adam, StepLR(20, 0.5), cross-entropy). One tapped ViT forward feeds
  all K MLPs, whose parameters are stacked on a leading axis and run as one
  batched GEMM a layer (``models/mlp.py::stacked_forward``), each member
  clipped and counted on its own.

The states hold float32 master parameters by state-dict name; the forward
runs the given module of the compute dtype on them
(``train/functional.py``). The ViT forward goes through K3
(``kernels/attention.py``), whose gradient is its registered VJP. Every
function updates the state in place and returns it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.models.encoders import pop_batch_stats
from ladine_tpu_torch.models.initializers import init_random_
from ladine_tpu_torch.models.mlp import MappingMLP, stacked_forward
from ladine_tpu_torch.models.vit import ViT
from ladine_tpu_torch.train import functional as Fn
from ladine_tpu_torch.train.optim import Optimizer, Tensors


@dataclass
class TrainState:
    """Float32 master ``params``, the optimizer state and the update count
    (stacked members: a leading axis on every tensor and one count
    each); ``batch_stats``, a BatchNorm backbone's running statistics by
    state-dict name (None without BatchNorm)."""

    params: Tensors
    opt_state: dict
    step: torch.Tensor
    batch_stats: Optional[Tensors] = None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of integer ``labels`` over every leading
    axis, in the logits' dtype."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.unsqueeze(-1)).mean()


def _accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float()


# ---------------------------------------------------------------- ViT stage


def create_vit_state(vit: nn.Module, generator: torch.Generator, tx: Optimizer, device="cuda") -> TrainState:
    """A fresh float32 backbone of ``vit``'s geometry, initialized as its
    JAX family is (``models/initializers.py``), and its optimizer state;
    a BatchNorm backbone's running statistics start at (0, 1)."""
    dev = resolve_device(device)
    fresh = copy.deepcopy(vit).to_empty(device=dev).float()
    init_random_(fresh, generator)
    params = {k: v.detach() for k, v in fresh.named_parameters()}
    stats = {k: v.detach() for k, v in fresh.named_buffers()} or None
    return TrainState(params=params, opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev), batch_stats=stats)


def make_vit_train_step(vit: nn.Module, tx: Optimizer) -> Callable:
    """step(state, images NHWC, labels) -> (state, loss, accuracy), with
    ``vit`` the compute module (any backbone), run in train mode."""

    def step(state: TrainState, images, labels):
        def loss_fn(params):
            logits = Fn.call(vit, params, images, buffers=state.batch_stats, train=True)
            return cross_entropy(logits, labels), (logits.detach(), pop_batch_stats(vit))

        loss, (logits, stats), grads = Fn.value_and_grad(loss_fn, state.params)
        tx.step(state.params, grads, state.opt_state)
        state.step.add_(1)
        if state.batch_stats is not None:
            state.batch_stats = stats
        return state, loss, _accuracy(logits, labels).mean()

    return step


def make_vit_eval_step(vit: nn.Module) -> Callable:
    """step(params, images, labels, batch_stats=None) -> number of correct
    predictions (eval mode: running statistics)."""

    @torch.no_grad()
    def step(params, images, labels, batch_stats=None):
        return _accuracy(Fn.call(vit, params, images, buffers=batch_stats), labels).sum()

    return step


# ------------------------------------------------------------ mapping stage


def _mlp_dims(mlp: MappingMLP):
    layers = list(mlp.layers)
    return layers[0].in_features, layers[-1].out_features, tuple(l.out_features for l in layers[:-1])


def create_mapping_states(
    mlp: MappingMLP,
    generator: torch.Generator,
    tx: Optimizer,
    num_members: int,
    member_indices: Optional[Sequence[int]] = None,
    device="cuda",
) -> TrainState:
    """Independent float32 inits of K MLPs of ``mlp``'s geometry, stacked.
    Member k initializes from the k-th of ``num_members`` seeds drawn from
    ``generator``, so ``member_indices`` (a subset) initializes each member
    as the full stack does."""
    dev = resolve_device(device)
    in_dim, num_classes, hidden = _mlp_dims(mlp)
    seeds = Fn.member_seeds(generator, num_members)
    if member_indices is not None:
        seeds = [seeds[k] for k in member_indices]

    def one(g):
        return init_random_(MappingMLP(in_dim, num_classes, hidden, device=dev, dtype=torch.float32), g)

    params = Fn.stack_init(one, seeds, dev)
    k = len(seeds)
    return TrainState(params=params, opt_state=tx.init(params, members=k),
                      step=torch.zeros(k, dtype=torch.int32, device=dev))


def _depths(num_members: int, member_indices: Optional[Sequence[int]]):
    members = tuple(member_indices) if member_indices is not None else tuple(range(num_members))
    if list(members) != sorted(set(members)):
        raise ValueError(f"member_indices must increase (the taps come in depth order); got {members}")
    return tuple(k + 1 for k in members)


def _taps(vit: ViT, images, depths) -> torch.Tensor:
    with torch.no_grad():
        return torch.stack(vit.tap_features(images, depths))  # (K, B, N, D)


def make_mapping_train_step(
    vit: ViT,
    mlp: MappingMLP,
    tx: Optimizer,
    num_members: int,
    member_indices: Optional[Sequence[int]] = None,
) -> Callable:
    """One step of the K mapping MLPs on their taps from one frozen-ViT
    forward (``vit`` holds its weights; member k taps after block k+1):

        step(states, images NHWC, labels) -> (states, losses (K,), accs (K,))

    ``mlp`` is the compute module (its dtype); ``member_indices`` an
    increasing subset of the members."""
    depths = _depths(num_members, member_indices)

    def step(states: TrainState, images, labels):
        taps = _taps(vit, images, depths)

        def loss_fn(params):
            logits = stacked_forward(Fn.cast_like(mlp, params), taps)  # (K, B, C)
            logp = torch.log_softmax(logits, dim=-1)
            index = labels.reshape(1, -1, 1).expand(logits.shape[0], -1, 1)
            return -logp.gather(-1, index).mean(dim=(1, 2)), logits.detach()

        losses, logits, grads = Fn.value_and_grad(loss_fn, states.params)
        tx.step(states.params, grads, states.opt_state)
        states.step.add_(1)
        return states, losses, _accuracy(logits, labels).mean(dim=1)

    return step


def make_mapping_eval_step(
    vit: ViT,
    mlp: MappingMLP,
    num_members: int,
    member_indices: Optional[Sequence[int]] = None,
) -> Callable:
    """step(stacked_params, images, labels) -> correct predictions (K,)."""
    depths = _depths(num_members, member_indices)

    @torch.no_grad()
    def step(stacked_params, images, labels):
        logits = stacked_forward(Fn.cast_like(mlp, stacked_params), _taps(vit, images, depths))
        return _accuracy(logits, labels).sum(dim=1)

    return step
