"""Test-time corruption suite.

Counterpart of ``ladine_tpu/ops/corruptions.py``: NHWC float images in
[0, 1], the reference's fixed order noise -> low resolution -> brightness
-> contrast -> cover -> crop, each stage under the reference's enable
condition. The stages run on the images' device.

Every random stage takes its draws from an explicit ``torch.Generator`` on
the images' device, or as injected tensors (``draws``); the tests inject
the JAX package's own draws:

* noise: the standard normals, of the images' shape;
* cover: ``(tops, lefts)``, ints of shape (B, n, num_candidates), each
  region's candidate corners;
* crop: ``(tops, lefts)``, ints of shape (B,).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def add_noise(images: torch.Tensor, noise_std: float, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive Gaussian pixel noise, not clipped (as the reference)."""
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, device=images.device, dtype=images.dtype)
    return images + noise.to(images) * noise_std


def _axis_weights(out_size: int, in_size: int, images: torch.Tensor):
    """One axis's source indices and weights, in the JAX package's float32
    arithmetic on the host: weights from the unclamped half-pixel source
    coordinate, indices clamped to the image."""
    scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    src = (torch.arange(out_size, dtype=torch.float32) + 0.5) * scale - 0.5
    i0 = torch.floor(src)
    frac = (src - i0).to(images.dtype)
    lo, hi = i0.clamp(0, in_size - 1).long(), (i0 + 1).clamp(0, in_size - 1).long()
    return lo.to(images.device), hi.to(images.device), frac.to(images.device)


def bilinear_resize(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers and no antialiasing, the
    semantics of ``F.interpolate(mode='bilinear', align_corners=False)``,
    computed as the JAX package does: separable gathers, rows then columns.
    ``F.interpolate`` itself rounds the coordinates and the blend otherwise
    (3.6e-6 apart at 201 -> 224 pixels). NHWC in and out."""
    y0, y1, wy = _axis_weights(out_h, images.shape[1], images)
    x0, x1, wx = _axis_weights(out_w, images.shape[2], images)
    rows = images[:, y0] * (1.0 - wy)[None, :, None, None] + images[:, y1] * wy[None, :, None, None]
    return rows[:, :, x0] * (1.0 - wx)[None, None, :, None] + rows[:, :, x1] * wx[None, None, :, None]


def down_up_sample(images: torch.Tensor, k: int) -> torch.Tensor:
    """Downsample by the integer factor k (floor), then back up."""
    b, h, w, c = images.shape
    return bilinear_resize(bilinear_resize(images, h // k, w // k), h, w)


def adjust_brightness(images: torch.Tensor, k: float) -> torch.Tensor:
    """Add k to all pixels, clip to [0, 1]."""
    return (images + k).clamp(0.0, 1.0)


def adjust_contrast(images: torch.Tensor, k: float) -> torch.Tensor:
    """Scale deviations from the per-image mean by k, clip to [0, 1]."""
    means = images.mean(dim=(1, 2, 3), keepdim=True)
    return (means + (images - means) * k).clamp(0.0, 1.0)


def random_cover(images: torch.Tensor, k: float, n: int, generator: Optional[torch.Generator] = None,
                 num_candidates: int = 32, corners: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Black out n non-overlapping squares, each of fraction k of the image
    area. For each region, ``num_candidates`` candidate corners are drawn,
    and the first that does not overlap the squares placed so far is taken
    (candidate 0 when all overlap), as in the JAX package."""
    b, h, w, c = images.shape
    side = int((k * h * w) ** 0.5)
    if side == 0 or n == 0:
        return images
    dev = images.device
    if corners is None:
        shape = (b, n, num_candidates)
        corners = (torch.randint(0, h - side + 1, shape, generator=generator, device=dev),
                   torch.randint(0, w - side + 1, shape, generator=generator, device=dev))
    tops, lefts = (t.to(dev) for t in corners)
    rows = torch.arange(h, device=dev)[None, None, :, None]
    cols = torch.arange(w, device=dev)[None, None, None, :]
    mask = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    batch = torch.arange(b, device=dev)
    for j in range(n):
        t, l = tops[:, j, :, None, None], lefts[:, j, :, None, None]
        cand = (rows >= t) & (rows < t + side) & (cols >= l) & (cols < l + side)  # (B, nc, H, W)
        overlaps = (cand & mask[:, None]).any(dim=-1).any(dim=-1)  # (B, nc)
        first_free = torch.argmin(overlaps.to(torch.uint8), dim=1)  # first False, else 0
        mask = mask | cand[batch, first_free]
    return images * (~mask[..., None]).to(images.dtype)


def random_crop_and_resize(images: torch.Tensor, k: float, generator: Optional[torch.Generator] = None,
                           corners: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Per-image random square crop of side (1-k)*W, resized back to the
    image size bilinearly."""
    b, h, w, c = images.shape
    crop = int(w * (1.0 - k))
    if corners is None:
        corners = (torch.randint(0, h - crop + 1, (b,), generator=generator, device=images.device),
                   torch.randint(0, w - crop + 1, (b,), generator=generator, device=images.device))
    tops, lefts = (t.tolist() for t in corners)
    return torch.cat([bilinear_resize(images[i:i + 1, t:t + crop, l:l + crop], h, w)
                      for i, (t, l) in enumerate(zip(tops, lefts))])


def apply_corruptions(
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise_std: float = 0.0,
    low_resolution: int = 1,
    brightness: float = 0.0,
    contrast: float = 1.0,
    cover: Tuple[float, int] = (0.0, 0),
    crop: float = 0.0,
    draws: Optional[Dict[str, object]] = None,
) -> torch.Tensor:
    """The reference's fixed corruption order with its enable conditions
    (noise > 0, low resolution > 1, brightness != 0, contrast != 1, cover
    k > 0 and n > 0, crop > 0). ``draws`` may hold injected ``"noise"``,
    ``"cover"`` and ``"crop"`` draws (module docstring); the others come from
    ``generator``, in the order of the stages."""
    draws = draws or {}
    if noise_std > 0.0:
        images = add_noise(images, noise_std, generator, draws.get("noise"))
    if low_resolution > 1:
        images = down_up_sample(images, low_resolution)
    if brightness != 0.0:
        images = adjust_brightness(images, brightness)
    if contrast != 1.0:
        images = adjust_contrast(images, contrast)
    if cover[0] > 0.0 and cover[1] > 0:
        images = random_cover(images, cover[0], cover[1], generator, corners=draws.get("cover"))
    if crop > 0.0:
        images = random_crop_and_resize(images, crop, generator, corners=draws.get("crop"))
    return images
