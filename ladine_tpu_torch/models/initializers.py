"""Seeded random initialization of the port's models, in place, on their
own device.

The reference trains with torch's default ``nn.Linear`` and ``Conv2d`` init
(U(+-1/sqrt(fan_in)) for weight and bias) and U[0, 1) timestep gates;
LayerNorm and BatchNorm start at the identity, the ViT position embedding
at N(0, 0.02) and the cls token at 0. The modules the JAX package builds
from plain flax layers follow flax's defaults: a ``FlaxConv`` and a
``DenseGeneral`` take lecun-normal weights (a normal truncated at two
standard deviations, scaled to variance 1/fan_in) and zero biases. With a
CUDA generator the weights are drawn on the card, so a full-width model
never passes through the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ladine_tpu_torch.models.conditional import (
    ConditionalLinear,
    StackedBatchNorm,
    StackedLinear,
    StackedModule,
)
from ladine_tpu_torch.models.encoders import BatchNorm, DenseGeneral, FlaxConv

# the standard deviation of a unit normal truncated to (-2, 2): lecun_normal
# divides by it so the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def _init_own(mod: nn.Module, generator) -> None:
    """The tensors ``mod`` holds itself (not its children's)."""
    from ladine_tpu_torch.models.backbones import GPSA, ConViT, DeiT
    from ladine_tpu_torch.models.vit import ViT

    if isinstance(mod, FlaxConv):
        _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
        if mod.bias is not None:
            mod.bias.zero_()
    elif isinstance(mod, (nn.Linear, nn.Conv2d)):
        bound = 1.0 / math.sqrt(mod.weight[0].numel())  # 1/sqrt(fan_in)
        mod.weight.uniform_(-bound, bound, generator=generator)
        if mod.bias is not None:
            mod.bias.uniform_(-bound, bound, generator=generator)
    elif isinstance(mod, DenseGeneral):
        _lecun_normal_(mod.kernel, math.prod(mod.kernel.shape[:mod.in_axes]), generator)
        mod.bias.zero_()
    elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
        mod.weight.fill_(1.0)
        mod.bias.zero_()
        if isinstance(mod, BatchNorm):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    elif isinstance(mod, (ViT, DeiT)):
        for name in ("cls_token", "dist_token"):
            if getattr(mod, name, None) is not None:
                getattr(mod, name).zero_()
        mod.pos_embed.normal_(0.0, 0.02, generator=generator)
    elif isinstance(mod, ConViT):
        mod.pos_embed.normal_(0.0, 0.02, generator=generator)
        if mod.cls_token is not None:
            mod.cls_token.normal_(0.0, 0.02, generator=generator)
    elif isinstance(mod, GPSA):
        mod.gating_param.fill_(1.0)
    elif isinstance(mod, (StackedLinear, StackedBatchNorm, ConditionalLinear, StackedModule)):
        mod.reset_parameters(generator)


def init_random_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initializes every tensor of ``module`` in place, in the order of its
    modules (a ``StackedModule`` member by member, as a whole)."""
    _init_own(module, generator)
    if not isinstance(module, StackedModule):
        for child in module.children():
            init_random_(child, generator)
    return module
