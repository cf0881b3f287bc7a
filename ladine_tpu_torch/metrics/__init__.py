from ladine_tpu_torch.metrics.classification import (
    accuracy_topk,
    brier,
    convert_to_prob,
    ece,
    ensemble_confidence,
    majority_vote,
    nll,
    reliability_bins,
)
from ladine_tpu_torch.metrics.uncertainty import (
    mc_variance_per_class,
    pavpu,
    piw_per_class,
    ttest_certainty,
)

__all__ = [
    "accuracy_topk",
    "brier",
    "convert_to_prob",
    "ece",
    "ensemble_confidence",
    "majority_vote",
    "mc_variance_per_class",
    "nll",
    "pavpu",
    "piw_per_class",
    "reliability_bins",
    "ttest_certainty",
]
