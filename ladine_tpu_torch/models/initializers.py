"""Seeded random initialization of the port's models, in place, on their
own device.

The reference trains with torch's default ``nn.Linear`` init
(U(+-1/sqrt(fan_in)) for weight and bias) and U[0, 1) timestep gates;
LayerNorm and BatchNorm start at the identity, the ViT position embedding
at N(0, 0.02) and the cls token at 0. With a CUDA generator the weights are
drawn on the card, so a full-width model never passes through the host.
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
)
from ladine_tpu_torch.models.vit import ViT


@torch.no_grad()
def init_random_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())  # 1/sqrt(fan_in)
            mod.weight.uniform_(-bound, bound, generator=generator)
            mod.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, ViT):
            mod.cls_token.zero_()
            mod.pos_embed.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, (StackedLinear, StackedBatchNorm, ConditionalLinear)):
            mod.reset_parameters(generator)
    return module
