"""Training: the diffusion members (member, multi-member, full and joint
steps), the ViT fine-tune and the mapping MLPs, on optax-exact optimizers
and schedules, the debiased EMA and bfloat16 low-memory state."""

from ladine_tpu_torch.train.classifier_trainer import (
    TrainState,
    create_mapping_states,
    create_vit_state,
    cross_entropy,
    make_mapping_eval_step,
    make_mapping_train_step,
    make_vit_eval_step,
    make_vit_train_step,
)
from ladine_tpu_torch.train.diffusion_trainer import (
    MemberTrainState,
    conditional_model_from_state,
    create_member_state,
    create_member_states,
    make_full_train_step,
    make_joint_train_step,
    make_member_step,
    make_multi_member_step,
)
from ladine_tpu_torch.train.ema import (
    debias_scale,
    ema_debias,
    ema_init,
    ema_params_from_ckpt,
    ema_read,
    ema_update,
)
from ladine_tpu_torch.train.lowmem import (
    adam_bf16,
    bf16_stochastic_round,
    ema_init_bf16,
    ema_update_sr,
    scale_by_adam_bf16,
)
from ladine_tpu_torch.train.optim import (
    Optimizer,
    cosine_warm_restarts,
    make_optimizer,
    step_decay,
    warmup_cosine,
)

__all__ = [
    "MemberTrainState",
    "Optimizer",
    "TrainState",
    "adam_bf16",
    "bf16_stochastic_round",
    "conditional_model_from_state",
    "cosine_warm_restarts",
    "create_mapping_states",
    "create_member_state",
    "create_member_states",
    "create_vit_state",
    "cross_entropy",
    "debias_scale",
    "ema_debias",
    "ema_init",
    "ema_init_bf16",
    "ema_params_from_ckpt",
    "ema_read",
    "ema_update",
    "ema_update_sr",
    "make_full_train_step",
    "make_joint_train_step",
    "make_mapping_eval_step",
    "make_mapping_train_step",
    "make_member_step",
    "make_multi_member_step",
    "make_optimizer",
    "make_vit_eval_step",
    "make_vit_train_step",
    "scale_by_adam_bf16",
    "step_decay",
    "warmup_cosine",
]
