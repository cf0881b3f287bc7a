from ladine_tpu_torch.utils.assemble import (
    assemble_guidance,
    export_guidance_stage1,
    split_guidance,
    validate_guidance_tree,
)
from ladine_tpu_torch.utils.checkpoint import (
    best_checkpoint_name,
    load_checkpoint,
    load_checkpoint_meta,
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from ladine_tpu_torch.utils.convert import (
    guidance_from_flax,
    guidance_to_flax,
    member_state_from_jax,
    members_from_flax,
    mlp_from_flax,
    members_to_flax,
    module_from_flax,
    module_to_flax,
    train_state_from_jax,
    vit_from_flax,
)
from ladine_tpu_torch.utils.logging import ScalarLogger, device_memory_stats, setup_logging, trace

__all__ = [
    "ScalarLogger", "assemble_guidance", "best_checkpoint_name", "device_memory_stats", "export_guidance_stage1",
    "guidance_from_flax", "guidance_to_flax", "load_checkpoint", "load_checkpoint_meta", "load_train_state",
    "member_state_from_jax", "members_from_flax", "members_to_flax", "mlp_from_flax", "module_from_flax",
    "module_to_flax", "save_checkpoint",
    "save_train_state", "setup_logging", "split_guidance", "train_state_from_jax", "trace",
    "validate_guidance_tree", "vit_from_flax",
]
