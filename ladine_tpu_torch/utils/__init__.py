from ladine_tpu_torch.utils.convert import (
    guidance_from_flax,
    guidance_to_flax,
    member_state_from_jax,
    members_from_flax,
    members_to_flax,
    train_state_from_jax,
    vit_from_flax,
)

__all__ = ["guidance_from_flax", "guidance_to_flax", "member_state_from_jax", "members_from_flax",
           "members_to_flax", "train_state_from_jax", "vit_from_flax"]
