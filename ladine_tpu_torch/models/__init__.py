from ladine_tpu_torch.models.conditional import ConditionalModel
from ladine_tpu_torch.models.guidance import SEViTGuidance
from ladine_tpu_torch.models.initializers import init_random_
from ladine_tpu_torch.models.mlp import MappingMLP
from ladine_tpu_torch.models.vit import ViT

__all__ = ["ConditionalModel", "MappingMLP", "SEViTGuidance", "ViT", "init_random_"]
