"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with
a plain PyTorch version that serves CPU tensors only."""

from ladine_tpu_torch.kernels._build import launch_counts
from ladine_tpu_torch.kernels.attention import flash_attention, flash_attention_plain
from ladine_tpu_torch.kernels.fused_eps import fused_eps
from ladine_tpu_torch.kernels.fused_linear import fused_linear_act, fused_linear_act_plain

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "fused_eps",
    "fused_linear_act",
    "fused_linear_act_plain",
    "launch_counts",
]
