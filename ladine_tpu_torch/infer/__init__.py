from ladine_tpu_torch.infer.batching import MicroBatcher
from ladine_tpu_torch.infer.engine import nested_ensemble_sample
from ladine_tpu_torch.infer.serve import PRESETS, Predictor

__all__ = ["PRESETS", "MicroBatcher", "Predictor", "nested_ensemble_sample"]
