"""Prediction aggregation and calibration metrics.

Counterpart of ``ladine_tpu/metrics/classification.py``:

* ``convert_to_prob``: softmax(-(l - 1)^2 / T), the distance-softmax map;
* ``majority_vote``: the plurality class of the MC samples' argmax;
* ``ensemble_confidence``: the mean of ``convert_to_prob`` over samples;
* ``accuracy_topk``: timm-style top-k accuracy in percent;
* ``ece`` and ``reliability_bins``: torchmetrics
  ``MulticlassCalibrationError(n_bins, norm='l1')`` binning over the max-prob
  confidence, ``idx = clip(ceil(conf * n) - 1, 0, n - 1)`` (a confidence on
  a bin edge falls in the lower bin);
* ``nll`` and ``brier``.

They take tensors and compute in the tensors' dtype (float32 for the
evaluator's samples, as the JAX package does).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def convert_to_prob(logits: torch.Tensor, temperature) -> torch.Tensor:
    """softmax(-(logits - 1)^2 / T): distance-to-one-hot probability map.
    ``temperature`` is a number or a tensor (differentiable)."""
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


def ensemble_confidence(samples: torch.Tensor, temperature) -> torch.Tensor:
    """(S, B, C) -> (B, C): mean of convert_to_prob over all MC samples."""
    return convert_to_prob(samples, temperature).mean(dim=0)


def accuracy_topk(output: torch.Tensor, target: torch.Tensor,
                  topk: Sequence[int] = (1,)) -> Tuple[torch.Tensor, ...]:
    """timm-style top-k accuracy in percent; ties keep the lower class
    first (a stable sort, as ``jnp.argsort``)."""
    maxk = min(max(topk), output.shape[1])
    order = torch.argsort(-output, dim=1, stable=True)[:, :maxk]  # (B, maxk)
    correct = order == target[:, None]
    return tuple(correct[:, : min(k, maxk)].sum() * 100.0 / target.shape[0] for k in topk)


def _bins(probs: torch.Tensor, labels: torch.Tensor, n_bins: int):
    """Per-bin (count, sum of confidences, sum of accuracies)."""
    conf, pred = probs.max(dim=-1)
    acc = (pred == labels).to(probs.dtype)
    idx = (torch.ceil(conf * n_bins).to(torch.int64) - 1).clamp(0, n_bins - 1)
    zeros = torch.zeros(n_bins, dtype=probs.dtype, device=probs.device)
    return (zeros.index_add(0, idx, torch.ones_like(conf)), zeros.index_add(0, idx, conf),
            zeros.index_add(0, idx, acc))


def ece(probs: torch.Tensor, labels: torch.Tensor, n_bins: int = 10) -> torch.Tensor:
    """Expected calibration error, l1 norm, uniform confidence bins:
    sum_b (n_b / N) * |mean_acc_b - mean_conf_b|; an empty bin adds 0."""
    count, sum_conf, sum_acc = _bins(probs, labels, n_bins)
    nonempty = count > 0
    denom = count.clamp_min(1)
    mean_conf = torch.where(nonempty, sum_conf / denom, 0.0)
    mean_acc = torch.where(nonempty, sum_acc / denom, 0.0)
    return ((mean_acc - mean_conf).abs() * count / probs.shape[0]).sum()


def reliability_bins(probs: torch.Tensor, labels: torch.Tensor, n_bins: int = 10):
    """Per-bin (count, mean confidence, accuracy), the data behind the ECE
    and a reliability diagram; an empty bin reads 0.0. Same binning as
    :func:`ece`."""
    count, sum_conf, sum_acc = _bins(probs, labels, n_bins)
    denom = count.clamp_min(1)
    return count, sum_conf / denom, sum_acc / denom


def nll(probs: torch.Tensor, labels: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Mean negative log-likelihood of the true class (the reference takes
    the log of the probabilities; ``eps`` guards exact zeros)."""
    p = probs.gather(1, labels[:, None].long())[:, 0]
    return -torch.log(p + eps).mean()


def brier(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean squared error between the probability vector and the one-hot
    label (multi-class Brier score)."""
    classes = torch.arange(probs.shape[-1], device=probs.device)
    onehot = (labels[:, None] == classes).to(probs.dtype)
    return ((probs - onehot) ** 2).sum(dim=-1).mean()
