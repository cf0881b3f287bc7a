"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with
a plain PyTorch version that serves CPU tensors only."""

from ladine_tpu_torch.kernels._build import launch_counts
from ladine_tpu_torch.kernels.attention import flash_attention, flash_attention_plain
from ladine_tpu_torch.kernels.fused_eps import fused_eps
from ladine_tpu_torch.kernels.fused_linear import fused_linear_act, fused_linear_act_plain
from ladine_tpu_torch.kernels.int8_eps_fused import (
    int8_eps_l12,
    int8_eps_l12_plain,
    int8_eps_l34,
    int8_eps_l34_plain,
    int8_eps_pallas_fused,
    int8_lin1,
    int8_lin1_plain,
)
from ladine_tpu_torch.kernels.int8_linear import (
    int8_eps_pallas,
    int8_linear_softplus,
    int8_linear_softplus_plain,
)

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "fused_eps",
    "fused_linear_act",
    "fused_linear_act_plain",
    "int8_eps_l12",
    "int8_eps_l12_plain",
    "int8_eps_l34",
    "int8_eps_l34_plain",
    "int8_eps_pallas",
    "int8_eps_pallas_fused",
    "int8_lin1",
    "int8_lin1_plain",
    "int8_linear_softplus",
    "int8_linear_softplus_plain",
    "launch_counts",
]
