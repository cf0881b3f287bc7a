from ladine_tpu_torch.ops.corruptions import (
    add_noise,
    adjust_brightness,
    adjust_contrast,
    apply_corruptions,
    bilinear_resize,
    down_up_sample,
    random_cover,
    random_crop_and_resize,
)
from ladine_tpu_torch.ops.diffusion import (
    antithetic_timesteps,
    ddim_sample_loop,
    ddim_timesteps,
    p_sample_coefficients,
    p_sample_loop,
    q_sample,
)
from ladine_tpu_torch.ops.labels import one_hot_and_prototype
from ladine_tpu_torch.ops.schedules import DiffusionSchedule, make_beta_schedule

__all__ = [
    "DiffusionSchedule",
    "add_noise",
    "adjust_brightness",
    "adjust_contrast",
    "antithetic_timesteps",
    "apply_corruptions",
    "bilinear_resize",
    "down_up_sample",
    "random_cover",
    "random_crop_and_resize",
    "ddim_sample_loop",
    "ddim_timesteps",
    "make_beta_schedule",
    "one_hot_and_prototype",
    "p_sample_coefficients",
    "p_sample_loop",
    "q_sample",
]
