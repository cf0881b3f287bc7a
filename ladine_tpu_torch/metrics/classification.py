"""Prediction aggregation: the two metrics on the serving path.

Counterpart of ``convert_to_prob`` and ``majority_vote`` in
``ladine_tpu/metrics/classification.py``.
"""

from __future__ import annotations

import torch


def convert_to_prob(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """softmax(-(logits - 1)^2 / T): distance-to-one-hot probability map."""
    d = -((logits - 1.0) ** 2) / temperature
    return torch.softmax(d, dim=-1)


def majority_vote(samples: torch.Tensor) -> torch.Tensor:
    """(S, B, C) MC sample logits -> (B,) plurality class of per-sample argmax.

    Ties go to the smaller class index: ``torch.argmax`` returns the first
    maximum, as the reference's sorted ``torch.unique`` + argmax does."""
    votes = torch.argmax(samples, dim=-1)  # (S, B)
    num_classes = samples.shape[-1]
    classes = torch.arange(num_classes, device=samples.device)
    counts = (votes[..., None] == classes).sum(dim=0)  # (B, C)
    return torch.argmax(counts, dim=-1)
