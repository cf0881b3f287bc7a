"""SEViT guidance: frozen ViT + K mapping MLPs -> K+1 guidance heads.

Counterpart of ``ladine_tpu/models/guidance.py::SEViTGuidance`` for the
serving path: ``heads_subset`` and ``taps_subset``. Head i (0..K-1) is
mapping MLP i applied to the bare-patch features after ViT blocks 0..i;
head K is the full ViT classification forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.models.mlp import MappingMLP
from ladine_tpu_torch.models.vit import ViT


class SEViTGuidance(nn.Module):
    def __init__(
        self,
        num_classes: int = 2,
        num_members: int = 5,
        vit_depth: int = 12,
        img_size: int = 224,
        patch_size: int = 16,
        embed_dim: int = 768,
        num_heads: int = 12,
        mlp_hidden_dims: Sequence[int] = (4096, 2048, 128),
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if vit_depth < num_members:
            raise ValueError(
                f"vit_depth ({vit_depth}) must be >= num_members "
                f"({num_members}): member i taps after block i"
            )
        dev = resolve_device(device)
        self.num_members = num_members
        self.img_size = img_size
        self.vit = ViT(num_classes, img_size, patch_size, embed_dim, vit_depth, num_heads,
                       device=dev, dtype=dtype)
        in_dim = self.vit.num_patches * embed_dim
        self.mlps = nn.ModuleList(
            MappingMLP(in_dim, num_classes, mlp_hidden_dims, device=dev, dtype=dtype)
            for _ in range(num_members)
        )

    def taps_subset(self, x: torch.Tensor, indices: Sequence[int]) -> torch.Tensor:
        """ViT tap features for the requested MAPPING heads:
        (len(indices), B, num_patches, embed_dim), in the given order."""
        indices = tuple(int(i) for i in indices)
        for i in indices:
            if not 0 <= i < self.num_members:
                raise ValueError(
                    f"taps_subset takes mapping head ids 0..{self.num_members - 1}, "
                    f"got {i} (the full-ViT head has no tap)"
                )
        mlp_ids = sorted(set(indices))
        taps = self.vit.tap_features(x, tuple(i + 1 for i in mlp_ids))
        by_id = dict(zip(mlp_ids, taps))
        return torch.stack([by_id[i] for i in indices], dim=0)

    def heads_subset(self, x: torch.Tensor, indices: Sequence[int]) -> torch.Tensor:
        """Only the requested guidance heads: (len(indices), B, C), in the
        given order (0..K-1 = mapping heads, K = full-ViT head). The
        transformer runs only to the deepest requested tap."""
        indices = tuple(int(i) for i in indices)
        k_full = self.num_members
        for i in indices:
            if not 0 <= i <= k_full:
                raise ValueError(
                    f"head index {i} out of range 0..{k_full} "
                    f"({self.num_members} mapping heads + the full-ViT head)"
                )
        mlp_ids = sorted({i for i in indices if i < k_full})
        depths = tuple(i + 1 for i in mlp_ids)
        outs = {}
        if mlp_ids and k_full in indices:
            outs[k_full], taps = self.vit.forward_with_taps(x, depths)
        elif mlp_ids:
            taps = self.vit.tap_features(x, depths)
        else:
            outs[k_full], taps = self.vit(x), []
        for i, tap in zip(mlp_ids, taps):
            outs[i] = self.mlps[i](tap)
        return torch.stack([outs[i] for i in indices], dim=0)
