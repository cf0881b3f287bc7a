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


def int8_layer_inputs(rng, m, r, k, n, device, dtype, zero_point):
    """Inputs of one member-stacked int8 layer (K4, K5): activations x
    (M, R, K) with their row max (max x for the zero-point scheme, on
    softplus-like non-negative x; max|x| otherwise), a (M, K, N) int8
    weight stored K-contiguous with its scale folded into s, c and colsum
    (M, N); and lin1's y_in (M, R, 4) and w1 (M, 4, K)."""
    from ladine_tpu_torch.kernels.int8 import quantize_weight

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    x = rng.standard_normal((m, r, k))
    if zero_point:
        x = np.log1p(np.exp(x))
    x = t(x, dtype)
    xf = x.float()
    xmax = (xf.amax(-1, keepdim=True) if zero_point else xf.abs().amax(-1, keepdim=True)).contiguous()
    w_q, scale = quantize_weight(t(rng.standard_normal((m, k, n)) * k**-0.5))
    s = (scale * t(rng.uniform(0.5, 1.5, (m, n)))).contiguous()
    c = t(rng.standard_normal((m, n)) * 0.5)
    colsum = w_q.sum(dim=1, dtype=torch.int32).float() if zero_point else None
    y_in = t(rng.random((m, r, 4)), dtype)
    w1 = t(rng.standard_normal((m, 4, k)) * 0.5, dtype)
    return x, xmax, w_q, s, c, colsum, y_in, w1
