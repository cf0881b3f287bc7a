"""ladine_tpu_torch: the PyTorch/CUDA port of ladine_tpu for NVIDIA Hopper.

Serving path of the nested-ensemble classifier: ViT-B/16 guidance taps ->
mapping MLPs -> member-stacked CARD diffusion chains -> aggregated
prediction with uncertainty; and its robust evaluation (corruptions,
white-box attacks on the ViT, the metric report, temperature calibration).
The eps layer and the ViT attention run as CUDA kernels written for sm_90a
(``csrc/``); every entry point runs on the card unless it is given
``device="cpu"``.

The names below load on first use, so that importing one submodule (the
bundle loader ``infer/exported.py``, say) brings in no model code.
"""

import importlib

_EXPORTS = {
    "ATTACKS": "ladine_tpu_torch.attacks",
    "ConditionalModel": "ladine_tpu_torch.models",
    "DiffusionSchedule": "ladine_tpu_torch.ops",
    "EvalConfig": "ladine_tpu_torch.infer",
    "ExportedPredictor": "ladine_tpu_torch.infer",
    "MappingMLP": "ladine_tpu_torch.models",
    "Predictor": "ladine_tpu_torch.infer",
    "SEViTGuidance": "ladine_tpu_torch.models",
    "ViT": "ladine_tpu_torch.models",
    "apply_attack": "ladine_tpu_torch.attacks",
    "apply_corruptions": "ladine_tpu_torch.ops",
    "compute_report": "ladine_tpu_torch.infer",
    "convert_to_prob": "ladine_tpu_torch.metrics",
    "evaluate_ensemble": "ladine_tpu_torch.infer",
    "flash_attention": "ladine_tpu_torch.kernels",
    "fused_eps": "ladine_tpu_torch.kernels",
    "fused_linear_act": "ladine_tpu_torch.kernels",
    "majority_vote": "ladine_tpu_torch.metrics",
    "make_attack": "ladine_tpu_torch.attacks",
    "make_beta_schedule": "ladine_tpu_torch.ops",
    "make_eval_pipeline": "ladine_tpu_torch.infer",
    "nested_ensemble_sample": "ladine_tpu_torch.infer",
    "temperature_search": "ladine_tpu_torch.infer",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
