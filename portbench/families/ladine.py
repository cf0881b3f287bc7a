"""The LaDiNE family: weights from a seed, the port's predictor, the draws.

A configuration file whose ``family`` is ``ladine`` is run through this
file. Everything the benchmark hands to the program and to the reference
is made here from ``--seed``, on the device, in a few large calls:

* ``make_weights``: every tensor of the guidance (ViT-B/16 and the mapping
  MLPs) and of the stacked members, under the port's state-dict names, in
  the dtype the configuration serves them in. One normal draw a dtype, cut
  into the tensors, each then scaled to its fan-in (so every layer's
  activations stay of order one) or mapped to its own distribution.
* ``build``: ``Predictor.from_preset`` on modules made on the meta device
  and given those tensors by name, as ``Predictor.load`` does.
* ``noise``: the sampler's draws of one call, one ``torch.randn`` from a
  generator seeded by (seed, stream, index).
* ``image_pool``: the request images, 8-bit grey levels as a chest X-ray
  is stored, repeated over the three channels the model reads.

``reference`` runs ``portbench/reference/ladine.py`` on the same tensors,
also as the configuration's control (``control`` in its file) where that
is the reference at a lower precision: fewer bits for lin2 and lin3
(``reference_int_bits``), or every product on float8 operands
(``reference_fp8``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import ladine as reference_model

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_CHUNK = 1 << 30  # elements a draw: four calls for the full-width weights
_ALIGN = 512  # bytes: each tensor starts where PyTorch's caching allocator would start it


def stream_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed for one stream of a run."""
    return int(np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, *path: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, *path))
    return gen


# Streams of a run's draws
WEIGHTS, POOL, NOISE = 1, 2, 3


def weight_specs(cfg) -> Tuple[List[tuple], List[tuple]]:
    """(name, shape, dtype, kind) of the guidance's and the members'
    tensors. kind: ("fan_in", fan_in, gain) a weight N(0, gain / fan_in);
    ("scale", s) N(0, s^2); ("one", s) 1 + N(0, s^2); ("var", s) exp of
    N(0, s^2), a positive variance; "uniform" U(0, 1), the timestep gates
    as the reference initializes them."""
    dt = DTYPES[cfg["dtype"]]
    f32 = torch.float32
    e, p, img = cfg["embed_dim"], cfg["patch_size"], cfg["image_size"]
    n_patch = (img // p) ** 2
    c = cfg["num_classes"]
    g = [("vit.cls_token", (1, 1, e), dt, ("scale", 0.02)),
         ("vit.pos_embed", (1, n_patch + 1, e), dt, ("scale", 0.02)),
         ("vit.patch_proj.weight", (e, 3, p, p), dt, ("fan_in", 3 * p * p, 1.0)),
         ("vit.patch_proj.bias", (e,), dt, ("scale", 0.1))]
    for i in range(cfg["vit_depth"]):
        b = f"vit.blocks.{i}."
        g += [(b + "norm1.weight", (e,), dt, ("one", 0.1)), (b + "norm1.bias", (e,), dt, ("scale", 0.1)),
              (b + "attn.qkv.weight", (3 * e, e), dt, ("fan_in", e, 1.0)),
              (b + "attn.qkv.bias", (3 * e,), dt, ("scale", 0.1)),
              (b + "attn.proj.weight", (e, e), dt, ("fan_in", e, 1.0)),
              (b + "attn.proj.bias", (e,), dt, ("scale", 0.1)),
              (b + "norm2.weight", (e,), dt, ("one", 0.1)), (b + "norm2.bias", (e,), dt, ("scale", 0.1)),
              (b + "mlp.fc1.weight", (4 * e, e), dt, ("fan_in", e, 1.0)),
              (b + "mlp.fc1.bias", (4 * e,), dt, ("scale", 0.1)),
              (b + "mlp.fc2.weight", (e, 4 * e), dt, ("fan_in", 4 * e, 1.0)),
              (b + "mlp.fc2.bias", (e,), dt, ("scale", 0.1))]
    g += [("vit.norm.weight", (e,), dt, ("one", 0.1)), ("vit.norm.bias", (e,), dt, ("scale", 0.1)),
          ("vit.head.weight", (c, e), dt, ("fan_in", e, 1.0)), ("vit.head.bias", (c,), dt, ("scale", 0.1))]
    dims = [n_patch * e, *cfg["mlp_hidden_dims"], c]
    for i in range(cfg["num_members"]):
        for j, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            gain = 2.0 if j < len(dims) - 2 else 1.0  # He gain before a ReLU
            g += [(f"mlps.{i}.layers.{j}.weight", (d_out, d_in), dt, ("fan_in", d_in, gain)),
                  (f"mlps.{i}.layers.{j}.bias", (d_out,), dt, ("scale", 0.1))]

    m, d, h, f, steps = (cfg["num_members"], cfg["data_dim"], cfg["hidden_dim"], cfg["feature_dim"],
                         cfg["timesteps"] + 1)

    def lin(name, d_in, d_out):
        return [(f"{name}.weight", (m, d_in, d_out), dt, ("fan_in", d_in, 1.0)),
                (f"{name}.bias", (m, d_out), dt, ("scale", 0.1))]

    def bn(name, n):
        return [(f"{name}.weight", (m, n), f32, ("one", 0.1)), (f"{name}.bias", (m, n), f32, ("scale", 0.1)),
                (f"{name}.running_mean", (m, n), f32, ("scale", 0.1)),
                (f"{name}.running_var", (m, n), f32, ("var", 0.2))]

    s = lin("enc_lin1", d, h) + bn("enc_bn1", h) + lin("enc_lin2", h, h) + bn("enc_bn2", h)
    s += lin("enc_lin3", h, f) + bn("norm", f)
    for k, (name, d_in) in enumerate((("lin1", 2 * c), ("lin2", f), ("lin3", f))):
        s += [(f"{name}.embed", (m, steps, f), f32, "uniform")]
        s += lin(f"{name}.linear", d_in, f) + bn(f"unetnorm{k + 1}", f)
    s += lin("lin4", f, c)
    return g, s


@torch.no_grad()
def make_weights(cfg, seed: int, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(guidance, members) tensors by name, from ``seed``: views of one
    flat normal draw a dtype, each 512-byte aligned (the kernels' TMA bodies
    need 16 bytes and take another body otherwise), transformed in place."""
    g_specs, m_specs = weight_specs(cfg)
    specs = g_specs + m_specs
    gen = generator(device, seed, WEIGHTS)
    out = {}
    for dtype in sorted({sp[2] for sp in specs}, key=str):
        group = [sp for sp in specs if sp[2] == dtype]
        step = _ALIGN // dtype.itemsize
        starts, total = [], 0
        for sp in group:
            starts.append(total)
            total += -(-math.prod(sp[1]) // step) * step
        flat = torch.empty(total, dtype=dtype, device=device)
        for i in range(0, total, _CHUNK):
            flat[i:i + _CHUNK].normal_(generator=gen)
        for (name, shape, _, kind), offset in zip(group, starts):
            t = flat[offset:offset + math.prod(shape)].view(shape)
            if kind == "uniform":
                t.copy_(torch.special.ndtr(t))
            elif kind[0] == "fan_in":
                t.mul_(math.sqrt(kind[2] / kind[1]))
            elif kind[0] == "scale":
                t.mul_(kind[1])
            elif kind[0] == "one":
                t.mul_(kind[1]).add_(1.0)
            elif kind[0] == "var":
                t.mul_(kind[1]).exp_()
            out[name] = t
    return {k[0]: out[k[0]] for k in g_specs}, {k[0]: out[k[0]] for k in m_specs}


def build(cfg, weights, device):
    """The port's predictor at the configuration's preset, on the weights."""
    from ladine_tpu_torch import ConditionalModel, DiffusionSchedule, Predictor, SEViTGuidance

    dt = DTYPES[cfg["dtype"]]
    g_state, m_state = weights
    guidance = SEViTGuidance(
        num_classes=cfg["num_classes"], num_members=cfg["num_members"], vit_depth=cfg["vit_depth"],
        img_size=cfg["image_size"], patch_size=cfg["patch_size"], embed_dim=cfg["embed_dim"],
        num_heads=cfg["num_heads"], mlp_hidden_dims=tuple(cfg["mlp_hidden_dims"]), device="meta", dtype=dt)
    guidance.load_state_dict(g_state, assign=True)
    model = ConditionalModel(
        cfg["num_members"], data_dim=cfg["data_dim"], feature_dim=cfg["feature_dim"],
        hidden_dim=cfg["hidden_dim"], y_dim=cfg["num_classes"], n_steps=cfg["timesteps"] + 1,
        device="meta", dtype=dt, arch=cfg["arch"])
    model.load_state_dict(m_state, assign=True)
    sched = DiffusionSchedule.create(cfg["beta_schedule"], cfg["timesteps"], cfg["beta_start"], cfg["beta_end"],
                                     device=device)
    settings = dict(cfg.get("settings", {}), ddim_steps=cfg["ddim_steps"], ddim_eta=cfg["ddim_eta"])
    return Predictor.from_preset(cfg["preset"], guidance=guidance, model=model, sched=sched,
                                 mc_trials=cfg["mc_trials"], temperature=cfg["temperature"], device=device,
                                 **settings)


def noise_shape(cfg, batch: int) -> tuple:
    return (reference_model.n_draws(cfg), cfg["num_members"], cfg["mc_trials"], batch, cfg["num_classes"])


def noise(cfg, batch: int, seed: int, index: int, device, stream: int = NOISE) -> torch.Tensor:
    """The sampler's draws of call ``index`` of ``stream``."""
    return torch.randn(noise_shape(cfg, batch), generator=generator(device, seed, stream, index), device=device)


def image_pool(cfg, size: int, seed: int, device) -> np.ndarray:
    """``size`` distinct grey images (size, H, W, 3) float32 in [0, 1] on
    the host."""
    s = cfg["image_size"]
    levels = torch.randint(0, 256, (size, s, s, 1), generator=generator(device, seed, POOL), device=device)
    return (levels.float() / 255.0).expand(size, s, s, 3).contiguous().cpu().numpy()


def reference(cfg, seed: int, images: np.ndarray, draws: torch.Tensor, device, int_bits=None, fp8=False):
    """The reference's outputs on the weights of ``seed``, made again."""
    g, s = make_weights(cfg, seed, device)
    bits = cfg.get("int_bits") if int_bits is None else int_bits
    return reference_model.predict(cfg, g, s, torch.as_tensor(images, device=device), draws.to(device), bits, fp8)


def as_outputs(ref) -> Dict[str, np.ndarray]:
    """The reference's outputs as a predictor gives them: the interval
    width and the variance of its own vote."""
    rows = np.arange(len(ref["vote"]))
    return dict(probs=ref["probs"], vote=ref["vote"], piw=ref["piw"][rows, ref["vote"]],
                var=ref["var"][rows, ref["vote"]])


def outputs(out) -> Dict[str, np.ndarray]:
    """A predictor's outputs under the names the judge reads."""
    return dict(probs=np.asarray(out["probs"], np.float64), vote=np.asarray(out["majority_vote"]),
                piw=np.asarray(out["piw"], np.float64), var=np.asarray(out["mc_variance"], np.float64))
