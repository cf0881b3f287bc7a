from ladine_tpu_torch.utils.convert import (
    guidance_from_flax,
    guidance_to_flax,
    members_from_flax,
    members_to_flax,
)

__all__ = ["guidance_from_flax", "guidance_to_flax", "members_from_flax", "members_to_flax"]
