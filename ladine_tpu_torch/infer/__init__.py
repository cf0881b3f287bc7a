"""The serving and evaluation layer. Names load on first use:
``ExportedPredictor`` serves a bundle without importing the model code that
``Predictor`` and the evaluator need."""

import importlib

_EXPORTS = {
    "EvalConfig": "ladine_tpu_torch.infer.evaluator",
    "ExportedPredictor": "ladine_tpu_torch.infer.exported",
    "MicroBatcher": "ladine_tpu_torch.infer.batching",
    "PRESETS": "ladine_tpu_torch.infer.serve",
    "Predictor": "ladine_tpu_torch.infer.serve",
    "calibration_objective": "ladine_tpu_torch.infer.calibrate",
    "compute_report": "ladine_tpu_torch.infer.evaluator",
    "evaluate_ensemble": "ladine_tpu_torch.infer.evaluator",
    "make_eval_pipeline": "ladine_tpu_torch.infer.evaluator",
    "nested_ensemble_sample": "ladine_tpu_torch.infer.engine",
    "temperature_search": "ladine_tpu_torch.infer.calibrate",
    "tune_temperature_nll": "ladine_tpu_torch.infer.calibrate",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
