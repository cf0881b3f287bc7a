from ladine_tpu_torch.metrics.classification import convert_to_prob, majority_vote

__all__ = ["convert_to_prob", "majority_vote"]
