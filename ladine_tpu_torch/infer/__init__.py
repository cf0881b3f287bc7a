"""The serving layer. Names load on first use: ``ExportedPredictor`` serves
a bundle without importing the model code that ``Predictor`` needs."""

import importlib

_EXPORTS = {
    "ExportedPredictor": "ladine_tpu_torch.infer.exported",
    "MicroBatcher": "ladine_tpu_torch.infer.batching",
    "PRESETS": "ladine_tpu_torch.infer.serve",
    "Predictor": "ladine_tpu_torch.infer.serve",
    "nested_ensemble_sample": "ladine_tpu_torch.infer.engine",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
