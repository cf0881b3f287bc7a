"""ViT-B/16 (timm ``vit_base_patch16_224`` layout) with intermediate-block
taps for the SEViT guidance path.

Counterpart of ``ladine_tpu/models/vit.py``. The public input stays NHWC, as
in the JAX package; the patch convolution runs on NCHW internally and the
patches come out in the order of flax's ``(B, 14, 14, E).reshape``.
LayerNorm eps is 1e-6 and GELU is exact (timm). Attention goes through the
port's ``flash_attention`` kernel.

The tap path runs the blocks on the BARE patch embedding, with no cls token
and no position embedding, as the reference does for the mapping MLPs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.kernels.attention import flash_attention

_LN_EPS = 1e-6


class Attention(nn.Module):
    """Multi-head self-attention, timm layout (fused qkv, bias=True)."""

    def __init__(self, dim: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])  # (b, n, h, d)
        return self.proj(out.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block: x += attn(ln(x)); x += mlp(ln(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS, **kw)
        self.attn = Attention(dim, num_heads, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """ViT-B/16 by default (embed 768, 12 blocks, 12 heads, patch 16)."""

    def __init__(
        self,
        num_classes: int = 2,
        img_size: int = 224,
        patch_size: int = 16,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.embed_dim = embed_dim
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + 1, embed_dim, **kw))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, **kw) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=_LN_EPS, **kw)
        self.head = nn.Linear(embed_dim, num_classes, **kw)
        self.requires_grad_(False)

    def patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, num_patches, embed_dim)."""
        x = x.permute(0, 3, 1, 2).to(self.patch_proj.weight.dtype)
        return self.patch_proj(x).flatten(2).transpose(1, 2)

    def _classify(self, patches: torch.Tensor) -> torch.Tensor:
        cls = self.cls_token.expand(patches.shape[0], -1, -1)
        h = torch.cat([cls, patches], dim=1) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        return self.head(self.norm(h)[:, 0])

    def _taps(self, patches: torch.Tensor, depths: Sequence[int]) -> List[torch.Tensor]:
        h, taps = patches, []
        for i in range(max(depths)):
            h = self.blocks[i](h)
            if (i + 1) in depths:
                taps.append(h)
        return taps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Full classification forward: (B, H, W, 3) -> (B, num_classes).
        ``train`` is taken for the trainers' one signature and ignored (no
        layer depends on it), as in the JAX ViT."""
        return self._classify(self.patch_embed(x))

    def tap_features(self, x: torch.Tensor, depths: Sequence[int]) -> List[torch.Tensor]:
        """For each block count d in ``depths`` (increasing), the
        (B, num_patches, embed_dim) output of blocks[0..d-1] on the bare
        patch embedding, all from one pass."""
        return self._taps(self.patch_embed(x), depths)

    def forward_with_taps(
        self, x: torch.Tensor, depths: Sequence[int]
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Full-forward logits plus the taps, sharing the patch embedding."""
        patches = self.patch_embed(x)
        return self._classify(patches), self._taps(patches, depths)
