"""Uncertainty metrics over MC sample sets.

Counterpart of ``ladine_tpu/metrics/uncertainty.py``:

* ``piw_per_class``: the prediction-interval width (2.5/97.5 percentiles,
  linear interpolation, as ``jnp.quantile`` and ``torch.quantile``) at each
  instance's predicted class, averaged per predicted class and split by
  correct / incorrect; NaN for an empty group (a mean of nothing).
* ``mc_variance_per_class``: the across-sample variance (ddof 1) at each
  class's own coordinate, averaged over the instances predicted as that
  class that are / are not truly of it; 0.0 for an empty group (the
  reference fills zeros and overwrites only non-empty groups).
* ``ttest_certainty`` and ``pavpu``: host-side (numpy, scipy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def piw_per_class(
    samples: torch.Tensor,
    predicted: torch.Tensor,
    labels: torch.Tensor,
    q_lo: float = 2.5,
    q_hi: float = 97.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, B, C) samples -> two (C,) per-class mean PIWs, for correct and
    incorrect predictions."""
    lo = torch.quantile(samples, q_lo / 100.0, dim=0)  # (B, C)
    hi = torch.quantile(samples, q_hi / 100.0, dim=0)
    pred_piw = (hi - lo).gather(1, predicted[:, None])[:, 0]  # (B,)
    classes = torch.arange(samples.shape[-1], device=samples.device)
    correct = predicted == labels

    def group_mean(mask):
        cls_mask = (predicted[:, None] == classes) & mask[:, None]
        count = cls_mask.sum(dim=0)
        total = (pred_piw[:, None] * cls_mask).sum(dim=0)
        return torch.where(count > 0, total / count.clamp_min(1), torch.nan)

    return group_mean(correct), group_mean(~correct)


def mc_variance_per_class(
    samples: torch.Tensor,
    predicted: torch.Tensor,
    labels: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, B, C) samples -> two (C,) per-class mean variances, for correct
    and incorrect predictions, at each class's own coordinate."""
    var = samples.var(dim=0, correction=1)  # (B, C)
    classes = torch.arange(samples.shape[-1], device=samples.device)
    is_pred = predicted[:, None] == classes  # (B, C)
    is_label = labels[:, None] == classes

    def group_mean(m):
        count = m.sum(dim=0)
        return torch.where(count > 0, (var * m).sum(dim=0) / count.clamp_min(1), 0.0)

    return group_mean(is_pred & is_label), group_mean(is_pred & ~is_label)


def ttest_certainty(samples, alpha: float = 0.05):
    """Per-instance paired t-test certainty flag (the reference's dead
    path): is the mean MC logit of the winning class significantly above
    the runner-up at level ``alpha``?

    samples: (S, B, C). Returns (certain (B,) bool, p_values (B,)), numpy."""
    s = np.asarray(samples)
    mean = s.mean(axis=0)  # (B, C)
    order = np.argsort(-mean, axis=1)
    top, second = order[:, 0], order[:, 1]
    b = s.shape[1]
    a_col = s[:, np.arange(b), top]
    b_col = s[:, np.arange(b), second]
    try:
        from scipy import stats

        _, p = stats.ttest_rel(a_col, b_col, axis=0)
    except ImportError:  # normal-approx fallback
        d = a_col - b_col
        t = d.mean(0) / (d.std(0, ddof=1) / np.sqrt(d.shape[0]) + 1e-12)
        from math import erf, sqrt

        p = np.array([2 * (1 - 0.5 * (1 + erf(abs(ti) / sqrt(2)))) for ti in t])
    return p < alpha, p


def pavpu(probs, labels, uncertain_mask, conf_threshold: float = 0.5):
    """PAvPU (Patch Accuracy vs Patch Uncertainty, the reference's dead
    path): (n_accurate_certain + n_inaccurate_uncertain) / N.

    uncertain_mask: (B,) bool, e.g. the negation of ``ttest_certainty``."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    unc = np.asarray(uncertain_mask)
    accurate = probs.argmax(-1) == labels
    n_ac = np.sum(accurate & ~unc)
    n_iu = np.sum(~accurate & unc)
    return float((n_ac + n_iu) / len(labels))
