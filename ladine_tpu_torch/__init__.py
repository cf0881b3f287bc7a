"""ladine_tpu_torch: the PyTorch/CUDA port of ladine_tpu for NVIDIA Hopper.

Serving path of the nested-ensemble classifier: ViT-B/16 guidance taps ->
mapping MLPs -> member-stacked CARD diffusion chains -> aggregated
prediction with uncertainty. The eps layer and the ViT attention run as
CUDA kernels written for sm_90a (``csrc/``); every entry point runs on the
card unless it is given ``device="cpu"``.
"""

from ladine_tpu_torch.infer import Predictor, nested_ensemble_sample
from ladine_tpu_torch.kernels import flash_attention, fused_eps, fused_linear_act
from ladine_tpu_torch.metrics import convert_to_prob, majority_vote
from ladine_tpu_torch.models import ConditionalModel, MappingMLP, SEViTGuidance, ViT
from ladine_tpu_torch.ops import DiffusionSchedule, make_beta_schedule

__all__ = [
    "ConditionalModel",
    "DiffusionSchedule",
    "MappingMLP",
    "Predictor",
    "SEViTGuidance",
    "ViT",
    "convert_to_prob",
    "flash_attention",
    "fused_eps",
    "fused_linear_act",
    "majority_vote",
    "make_beta_schedule",
    "nested_ensemble_sample",
]
