from ladine_tpu_torch.ops.diffusion import (
    ddim_sample_loop,
    ddim_timesteps,
    p_sample_coefficients,
    p_sample_loop,
    q_sample,
)
from ladine_tpu_torch.ops.schedules import DiffusionSchedule, make_beta_schedule

__all__ = [
    "DiffusionSchedule",
    "ddim_sample_loop",
    "ddim_timesteps",
    "make_beta_schedule",
    "p_sample_coefficients",
    "p_sample_loop",
    "q_sample",
]
