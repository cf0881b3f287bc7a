"""Seeded numpy inputs shared by the CPU and the on-card kernel tests (no
JAX here: the on-card tests run where JAX is not installed)."""

import numpy as np
import torch


def layer_inputs(rng, m, r, k, n):
    x = rng.standard_normal((m, r, k)).astype(np.float32)
    w = (rng.standard_normal((m, k, n)) * k**-0.5).astype(np.float32)
    a = rng.standard_normal((m, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    mult = rng.standard_normal((m, r, n)).astype(np.float32)
    return x, w, a, c, mult


def qkv_views(rng, b, n, h, d, dtype=np.float32):
    """q, k, v as the strided slices of one fused qkv projection."""
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d)).astype(dtype))
    return qkv, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
