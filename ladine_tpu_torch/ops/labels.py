"""Label casting (counterpart of ``ladine_tpu/ops/labels.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def one_hot_and_prototype(
    labels: torch.Tensor,
    num_classes: int,
    label_min: float = 0.001,
    label_max: float = 0.999,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (one_hot, prototype_logits), both float32.

    The prototype is ``logit(normalize_l1(clip(one_hot, min, max)))``, the
    reference's soft label."""
    classes = torch.arange(num_classes, device=labels.device)
    one_hot = (labels.unsqueeze(-1) == classes).to(torch.float32)
    clipped = one_hot.clamp(label_min, label_max)
    normed = clipped / clipped.sum(dim=-1, keepdim=True)
    return one_hot, torch.log(normed) - torch.log1p(-normed)
