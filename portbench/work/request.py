"""The operations of one whole LaDiNE ``predict`` call, by precision, from
the configuration's shapes alone (whatever kernels implement them): the
guidance (the ViT tap path to the deepest member's block and the mapping
MLPs), the member encoders, and every eps call of the reverse chain.
Elementwise work, the sampler's steps and the aggregation are left out:
they are under a thousandth of the products."""

from collections import Counter

import numpy as np

PRECISION = {"bfloat16": "bf16", "float32": "fp32"}


def guidance_ops(cfg, batch: int) -> int:
    e, p = cfg["embed_dim"], cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2
    rows = batch * n
    ops = 2 * rows * 3 * p * p * e  # the patch projection
    block = 2 * rows * e * 3 * e + 4 * batch * n * n * e + 2 * rows * e * e + 2 * 2 * rows * e * 4 * e
    ops += cfg["num_members"] * block  # blocks 0 .. M-1
    dims = [n * e, *cfg["mlp_hidden_dims"], cfg["num_classes"]]
    ops += cfg["num_members"] * sum(2 * batch * a * b for a, b in zip(dims[:-1], dims[1:]))
    return ops


def encoder_ops(cfg, batch: int) -> int:
    d, h, f = cfg["data_dim"], cfg["hidden_dim"], cfg["feature_dim"]
    return cfg["num_members"] * 2 * batch * (d * h + h * h + h * f)


def eps_calls(cfg) -> int:
    """T for the ancestral chain (T - 1 steps and the last eps), the number
    of strided steps for DDIM (the same: the steps and the last eps)."""
    if not cfg["ddim_steps"]:
        return cfg["timesteps"]
    return len(np.unique(np.round(np.linspace(0, cfg["timesteps"] - 1, cfg["ddim_steps"]))))


def ops(cfg, batch: int) -> Counter:
    """Operations of one call of ``batch`` images, by precision (the keys
    of ``portbench.peaks.OPS_PER_S``)."""
    p = PRECISION[cfg["dtype"]]
    out = Counter({p: guidance_ops(cfg, batch) + encoder_ops(cfg, batch)})
    m, f, c = cfg["num_members"], cfg["feature_dim"], cfg["num_classes"]
    r = cfg["mc_trials"] * batch
    n = eps_calls(cfg)
    ends = 2 * m * r * (2 * c * f + f * c) * n  # lin1 and lin4
    middle = 2 * 2 * m * r * f * f * n  # lin2 and lin3
    if cfg.get("int_bits"):
        out["fp32"] += ends  # the int8 eps keeps lin1 and lin4 in float32
        out["int8"] += middle
    else:
        out[p] += ends + middle
    return out
