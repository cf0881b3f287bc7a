"""The stage-1 backbones beyond the ViT and the ResNets: DeiT, ConViT and
EfficientNetV2.

Counterpart of ``ladine_tpu/models/backbones.py``, name for name:

* :class:`DeiT`: deit_base_patch16_224 is a ViT-B/16 (the recipe differs,
  not the topology); ``distilled`` adds a distillation token and a second
  head, and the two heads are always averaged, as the JAX module does.
* :class:`ConViT`: GPSA blocks first (patches only), then the cls token
  joins for the plain-MHSA tail at block ``local_layers``; when
  ``depth <= local_layers`` a mean token is prepended at the end instead.
* :class:`EfficientNetV2` s/m/l: fused-MBConv then SE-MBConv stages, a 1x1
  head conv, global pooling, the classifier; BatchNorm eps 1e-3, and flax's
  asymmetric ``"SAME"`` padding on the stride-2 convs
  (``models.encoders.FlaxConv``).

Every module takes NHWC images and ``train`` (BatchNorm's mode, else
ignored). DeiT's blocks and ConViT's MHSA tail are the port's ViT
``Block``/``Attention`` (``models/vit.py``), so their attention runs K3
(``kernels/attention.py``) on the card. GPSA mixes two softmaxes and
renormalizes: not the function K3 computes, so it stays plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.models.encoders import BatchNorm, FlaxConv
from ladine_tpu_torch.models.vit import Attention, Block, _LN_EPS


def _patch_embed(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, patches, E), patches row-major as flax's
    ``(B, h, w, E).reshape``."""
    return conv(x.permute(0, 3, 1, 2).to(conv.weight.dtype)).flatten(2).transpose(1, 2)


# --------------------------------------------------------------------- DeiT


class DeiT(nn.Module):
    """deit_base_patch16_224(-distilled)."""

    def __init__(self, num_classes: int = 2, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, distilled: bool = False, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.distilled = distilled
        n_prefix = 2 if distilled else 1
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **kw))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **kw)) if distilled else None
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + n_prefix, embed_dim, **kw))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, **kw) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=_LN_EPS, **kw)
        self.head = nn.Linear(embed_dim, num_classes, **kw)
        self.head_dist = nn.Linear(embed_dim, num_classes, **kw) if distilled else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _patch_embed(self.patch_proj, x)
        toks = [self.cls_token] + ([self.dist_token] if self.distilled else [])
        h = torch.cat([t.expand(h.shape[0], -1, -1) for t in toks] + [h], dim=1) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        h = self.norm(h)
        logits = self.head(h[:, 0])
        if self.distilled:
            logits = (logits + self.head_dist(h[:, 1])) / 2.0  # timm's eval: the heads averaged
        return logits


# -------------------------------------------------------------------- ConViT


class GPSA(nn.Module):
    """Gated positional self-attention: a per-head sigmoid gate mixes the
    content attention with a learned positional attention over relative
    patch offsets, then each row is renormalized."""

    def __init__(self, dim: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.qk = nn.Linear(dim, 2 * dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.pos_proj = nn.Linear(3, num_heads, **kw)
        self.gating_param = nn.Parameter(torch.ones(num_heads, **kw))
        self.proj = nn.Linear(dim, dim, **kw)

    @staticmethod
    def rel_indices(num_patches: int, device=None, dtype=torch.float32) -> torch.Tensor:
        """(1, N, N, 3): (dx, dy, dx^2 + dy^2) between every pair of patches
        of the row-major grid."""
        side = int(num_patches**0.5)
        idx = torch.arange(num_patches, device=device)
        rows, cols = (idx // side).to(torch.float32), (idx % side).to(torch.float32)
        ddx = cols[None, :] - cols[:, None]
        ddy = rows[None, :] - rows[:, None]
        return torch.stack([ddx, ddy, ddx**2 + ddy**2], dim=-1)[None].to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qk = self.qk(x).reshape(b, n, 2, self.num_heads, head_dim)
        q, k = qk[:, :, 0], qk[:, :, 1]
        v = self.v(x).reshape(b, n, self.num_heads, head_dim)
        content = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * head_dim**-0.5, dim=-1)
        pos_score = self.pos_proj(self.rel_indices(n, x.device, x.dtype))  # (1, n, n, H)
        pos = torch.softmax(pos_score.permute(0, 3, 1, 2), dim=-1)
        g = torch.sigmoid(self.gating_param.to(x.dtype))[None, :, None, None]
        attn = (1.0 - g) * content + g * pos
        attn = attn / attn.sum(dim=-1, keepdim=True)
        return self.proj(torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c))


class ConViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, use_gpsa: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS, **kw)
        self.attn = GPSA(dim, num_heads, **kw) if use_gpsa else Attention(dim, num_heads, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS, **kw)
        self.fc1 = nn.Linear(dim, 4 * dim, **kw)
        self.fc2 = nn.Linear(4 * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ConViT(nn.Module):
    """convit_base: 16 heads, GPSA in the first ``local_layers`` blocks."""

    def __init__(self, num_classes: int = 2, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 16, local_layers: int = 10, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.local_layers = local_layers
        num_patches = (img_size // patch_size) ** 2
        self.patch_proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches, embed_dim, **kw))
        # created where the JAX module creates it: only if a block takes it
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **kw)) if depth > local_layers else None
        self.blocks = nn.ModuleList(ConViTBlock(embed_dim, num_heads, i < local_layers, **kw) for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=_LN_EPS, **kw)
        self.head = nn.Linear(embed_dim, num_classes, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _patch_embed(self.patch_proj, x) + self.pos_embed
        for i, blk in enumerate(self.blocks):
            if i == self.local_layers:
                h = torch.cat([self.cls_token.expand(h.shape[0], -1, -1), h], dim=1)
            h = blk(h)
        if len(self.blocks) <= self.local_layers:  # degenerate small configs
            h = torch.cat([h.mean(dim=1, keepdim=True), h], dim=1)
        return self.head(self.norm(h)[:, 0])


# -------------------------------------------------------------- EfficientNetV2

# (expansion, out_channels, blocks, stride, fused, se_ratio) per stage
EFFNETV2_STAGES = {
    "s": [(1, 24, 2, 1, True, 0.0), (4, 48, 4, 2, True, 0.0),
          (4, 64, 4, 2, True, 0.0), (4, 128, 6, 2, False, 0.25),
          (6, 160, 9, 1, False, 0.25), (6, 256, 15, 2, False, 0.25)],
    "m": [(1, 24, 3, 1, True, 0.0), (4, 48, 5, 2, True, 0.0),
          (4, 80, 5, 2, True, 0.0), (4, 160, 7, 2, False, 0.25),
          (6, 176, 14, 1, False, 0.25), (6, 304, 18, 2, False, 0.25),
          (6, 512, 5, 1, False, 0.25)],
    "l": [(1, 32, 4, 1, True, 0.0), (4, 64, 7, 2, True, 0.0),
          (4, 96, 7, 2, True, 0.0), (4, 192, 10, 2, False, 0.25),
          (6, 224, 19, 1, False, 0.25), (6, 384, 25, 2, False, 0.25),
          (6, 640, 7, 1, False, 0.25)],
}
_EFF_BN_EPS = 1e-3


class _SE(nn.Module):
    def __init__(self, channels: int, se_channels: int, device=None, dtype=None):
        super().__init__()
        self.reduce = FlaxConv(channels, se_channels, 1, device=device, dtype=dtype)
        self.expand = FlaxConv(se_channels, channels, 1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.reduce(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.expand(s))


class _MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expansion: int, stride: int, fused: bool, se_ratio: float,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        mid = in_ch * expansion
        bn = lambda c: BatchNorm(c, _EFF_BN_EPS, device=device, dtype=dtype)  # noqa: E731
        self.fused, self.residual = fused, stride == 1 and in_ch == out_ch
        self.pointwise = not fused and expansion != 1
        if fused:
            self.conv_exp = FlaxConv(in_ch, mid, 3, stride, same=True, **kw)
            self.bn1 = bn(mid)
        else:
            if self.pointwise:
                self.conv_pw = FlaxConv(in_ch, mid, 1, **kw)
                self.bn1 = bn(mid)
            self.conv_dw = FlaxConv(mid, mid, 3, stride, same=True, groups=mid, **kw)
            self.bn2 = bn(mid)
            self.se = _SE(mid, max(1, int(in_ch * se_ratio)), device, dtype) if se_ratio > 0 else None
        self.conv_proj = FlaxConv(mid, out_ch, 1, **kw)
        self.bn3 = bn(out_ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        if self.fused:
            h = F.silu(self.bn1(self.conv_exp(h), train))
        else:
            if self.pointwise:
                h = F.silu(self.bn1(self.conv_pw(h), train))
            h = F.silu(self.bn2(self.conv_dw(h), train))
            if self.se is not None:
                h = self.se(h)
        h = self.bn3(self.conv_proj(h), train)
        return h + x if self.residual else h


class EfficientNetV2(nn.Module):
    """efficientnetv2_{s,m,l}: stem 3x3/2 -> fused-MBConv and SE-MBConv
    stages -> 1x1 head conv (1280 x ``width_mult``) -> global pooling ->
    classifier. ``width_mult``/``depth_mult`` shrink it (tests, the demo)."""

    def __init__(self, num_classes: int = 2, variant: str = "l", stem_width: Optional[int] = None,
                 width_mult: float = 1.0, depth_mult: float = 1.0, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        stages = EFFNETV2_STAGES[variant]
        w = lambda c: max(8, int(c * width_mult))  # noqa: E731
        d = lambda n: max(1, int(round(n * depth_mult)))  # noqa: E731
        stem = stem_width or w(stages[0][1])
        self.stem_conv = FlaxConv(3, stem, 3, 2, same=True, bias=False, **kw)
        self.stem_bn = BatchNorm(stem, _EFF_BN_EPS, **kw)
        in_ch, self.block_names = stem, []
        for si, (exp, out_c, blocks, stride, fused, se) in enumerate(stages):
            for bi in range(d(blocks)):
                name = f"stage{si}_block{bi}"
                setattr(self, name, _MBConv(in_ch, w(out_c), exp, stride if bi == 0 else 1, fused, se, **kw))
                self.block_names.append(name)
                in_ch = w(out_c)
        head_w = max(int(1280 * width_mult), in_ch)
        self.head_conv = FlaxConv(in_ch, head_w, 1, bias=False, **kw)
        self.head_bn = BatchNorm(head_w, _EFF_BN_EPS, **kw)
        self.classifier = nn.Linear(head_w, num_classes, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).to(self.stem_conv.weight.dtype)
        h = F.silu(self.stem_bn(self.stem_conv(h), train))
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        h = F.silu(self.head_bn(self.head_conv(h), train))
        return self.classifier(h.mean(dim=(2, 3)))
