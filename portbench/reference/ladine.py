"""Plain PyTorch reference of one LaDiNE ``predict`` call.

What the benchmark's ``correct`` is judged against. It follows the
published method (arXiv 2310.15952; the reference repository's
``classification_train_separately.py`` and its CARD sampler), written out
from the equations in float32 with TF32 off, one member at a time, and it
imports nothing of the measured program. It takes the weights the benchmark
made (tensors by their state-dict names), the images and the sampler's
draws, and works out everything else itself: the schedule and the step
coefficients in float64, the timestep gates and BatchNorms unfolded, and
for an int8 configuration the quantized weights and activations.

    out = predict(cfg, guidance, members, images, noise)

``images`` (B, H, W, 3) float32; ``noise`` (n_draws, M, mc_trials, B, C),
draw 0 the y_T draw and draw i that of the i-th reverse step, the trials
outer and the images inner in the chain's rows. Returns per image the mean
tempered probability ``probs`` (B, C), the vote counts of the MC samples'
argmax ``counts`` (B, C), the majority vote, and per class the 95 %
interval width ``piw`` and the variance ``var`` (B, C), all float64.

``int_bits`` quantizes lin2 and lin3 of the eps network as the ``serving``
preset states (``quantize``): per output channel symmetric weights, per row
activations, symmetric for lin2 and with a zero point for lin3, whose input
is a softplus and so non-negative. 8 is the configuration's own; a lower
count is the control of an int8 configuration.

``fp8`` rounds both operands of every product (the patch projection, every
linear layer, both attention products, the encoders and the eps layers) to
float8 e4m3, scaled per row of the left operand and per column of the
right: the control of a bfloat16 configuration.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6  # ViT LayerNorm (timm)
BN_EPS = 1e-5  # BatchNorm1d


def no_tf32() -> None:
    """float32 products in float32 on the card, for the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3, scaled so that each slice along ``dim``
    spans the format's range (448)."""
    scale = torch.clamp_min(x.abs().amax(dim, keepdim=True) / 448.0, 1e-30)
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(a, b):
    """a (..., K) @ b (..., K, N) in float32."""
    return a @ b


def mm_fp8(a, b):
    """The same product on float8 operands."""
    return e4m3(a, -1) @ e4m3(b, -2)


def linear(x, w, b, mm=mm):
    """``nn.Linear`` layout: w (out, in)."""
    return mm(x, _f(w).T) + _f(b)


def layer_norm(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * _f(w) + _f(b)


def batch_norm(state, name: str, m: int, x):
    """Eval BatchNorm of member ``m``: running statistics, affine."""
    mean, var = state[f"{name}.running_mean"][m], state[f"{name}.running_var"][m]
    return (x - mean) / torch.sqrt(var + BN_EPS) * state[f"{name}.weight"][m] + state[f"{name}.bias"][m]


# ------------------------------------------------------------------ guidance


def patch_embed(g, images, patch: int, mm=mm):
    """(B, H, W, 3) -> (B, patches, E): the patch convolution as a product
    over (channel, row, column) vectors, patches row-major."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, (h // patch) * (w // patch), c * patch * patch)
    wt = _f(g["vit.patch_proj.weight"])
    return mm(x, wt.reshape(wt.shape[0], -1).T) + _f(g["vit.patch_proj.bias"])


def vit_block(g, i: int, x, heads: int, mm=mm):
    """Pre-norm transformer block i: attention then the GELU MLP, each added."""
    p = f"vit.blocks.{i}."
    b, n, e = x.shape
    d = e // heads
    h = layer_norm(x, g[p + "norm1.weight"], g[p + "norm1.bias"])
    qkv = linear(h, g[p + "attn.qkv.weight"], g[p + "attn.qkv.bias"], mm).reshape(b, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, heads, n, d)
    att = mm(torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1), v)
    x = x + linear(att.transpose(1, 2).reshape(b, n, e), g[p + "attn.proj.weight"], g[p + "attn.proj.bias"], mm)
    h = layer_norm(x, g[p + "norm2.weight"], g[p + "norm2.bias"])
    h = F.gelu(linear(h, g[p + "mlp.fc1.weight"], g[p + "mlp.fc1.bias"], mm))
    return x + linear(h, g[p + "mlp.fc2.weight"], g[p + "mlp.fc2.bias"], mm)


def mapping_mlp(g, i: int, tap, layers: int, mm=mm):
    """Mapping MLP i on a tap flattened patch-major: ReLU between layers."""
    x = tap.reshape(tap.shape[0], -1)
    for j in range(layers):
        x = linear(x, g[f"mlps.{i}.layers.{j}.weight"], g[f"mlps.{i}.layers.{j}.bias"], mm)
        if j < layers - 1:
            x = torch.relu(x)
    return x


def guidance(cfg, g, images, mm=mm):
    """y0_hat (M, B, C): member i is conditioned on the softmax of mapping
    MLP i, which reads the bare patch embedding after ViT blocks 0..i."""
    x = patch_embed(g, images, cfg["patch_size"], mm)
    layers = len(cfg["mlp_hidden_dims"]) + 1
    probs = []
    for i in range(cfg["num_members"]):
        x = vit_block(g, i, x, cfg["num_heads"], mm)
        probs.append(torch.softmax(mapping_mlp(g, i, x, layers, mm), dim=-1))
    return torch.stack(probs)


# ------------------------------------------------------------------ members


def encode(s, m: int, x_flat, mm=mm):
    """Member m's ``linear`` encoder: (B, D) -> (B, F)."""
    h = F.softplus(batch_norm(s, "enc_bn1", m, mm(x_flat, _f(s["enc_lin1.weight"][m])) + _f(s["enc_lin1.bias"][m])))
    h = F.softplus(batch_norm(s, "enc_bn2", m, mm(h, _f(s["enc_lin2.weight"][m])) + _f(s["enc_lin2.bias"][m])))
    return batch_norm(s, "norm", m, mm(h, _f(s["enc_lin3.weight"][m])) + _f(s["enc_lin3.bias"][m]))


def quantize(w: torch.Tensor, bits: int):
    """Symmetric codes of a (K, N) weight per output column and their
    scales, dequantized, float64."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp_min(w.abs().amax(0) / qmax, 1e-8)
    return (torch.round(w / scale).clamp(-qmax, qmax) * scale).double()


def quantized_rows(x: torch.Tensor, bits: int, non_negative: bool):
    """Per-row codes of x dequantized, float64: symmetric, or for a
    non-negative x with the zero point at the bottom of the code range."""
    qmax = 2 ** (bits - 1) - 1
    if non_negative:
        scale = torch.clamp_min(x.amax(-1, keepdim=True) / (2 * qmax), 1e-8)
        q = (torch.round(x / scale) - qmax).clamp(-qmax, qmax) + qmax
    else:
        scale = torch.clamp_min(x.abs().amax(-1, keepdim=True) / qmax, 1e-8)
        q = torch.round(x / scale).clamp(-qmax, qmax)
    return q.double() * scale.double()


class Member:
    """The eps network of one member, its weights in float32 (lin2 and lin3
    dequantized when ``int_bits``)."""

    def __init__(self, s, m: int, int_bits: Optional[int], mm=mm):
        self.s, self.m, self.int_bits, self.mm = s, m, int_bits, mm
        self.w = {n: _f(s[f"{n}.linear.weight"][m]) for n in ("lin1", "lin2", "lin3")}
        self.b = {n: _f(s[f"{n}.linear.bias"][m]) for n in ("lin1", "lin2", "lin3")}
        if int_bits:
            self.wq = {n: quantize(self.w[n], int_bits) for n in ("lin2", "lin3")}
        self.w4, self.b4 = _f(s["lin4.weight"][m]), _f(s["lin4.bias"][m])

    def _product(self, name: str, h):
        if not self.int_bits or name == "lin1":
            return self.mm(h, self.w[name])
        x = quantized_rows(h, self.int_bits, non_negative=name == "lin3")
        return (x @ self.wq[name]).float()

    def layer(self, name: str, norm: str, h, t: int):
        gate = self.s[f"{name}.embed"][self.m, t]
        z = (self._product(name, h) + self.b[name]) * gate
        return F.softplus(batch_norm(self.s, norm, self.m, z))

    def eps(self, f_rows, y, y_hat, t: int):
        h = self.layer("lin1", "unetnorm1", torch.cat([y, y_hat], dim=-1), t) * f_rows
        h = self.layer("lin2", "unetnorm2", h, t)
        h = self.layer("lin3", "unetnorm3", h, t)
        return self.mm(h, self.w4) + self.b4


# ------------------------------------------------------------------ sampler


def schedule(cfg) -> np.ndarray:
    """alpha_bar_t of the linear beta schedule, float64."""
    if cfg["beta_schedule"] != "linear":
        raise ValueError(f"the reference has the linear schedule only, not {cfg['beta_schedule']!r}")
    betas = np.linspace(cfg["beta_start"], cfg["beta_end"], cfg["timesteps"])
    return np.cumprod(1.0 - betas)


def ddim_tau(timesteps: int, steps: int) -> list:
    """The strided steps, uniform, increasing, ending at 0."""
    return sorted({int(v) for v in np.round(np.linspace(0, timesteps - 1, steps))})


def reparam(y, eps, mean, ab: float):
    """y_0 from y_t and eps under the mean-shifted process."""
    return (y - (1 - math.sqrt(ab)) * mean - eps * math.sqrt(1 - ab)) / math.sqrt(ab)


def chain(cfg, net: Member, f_rows, y_hat, z):
    """One member's reverse chain over its (trials x images) rows: the
    ancestral chain (``ddim_steps`` 0) or the strided one with eta."""
    ab = schedule(cfg)
    y = z[0] + y_hat
    steps = cfg["ddim_steps"]
    if not steps:
        for i, t in enumerate(range(len(ab) - 1, 0, -1)):
            eps = net.eps(f_rows, y, y_hat, t)
            alpha, ab_t, ab_p = ab[t] / ab[t - 1], ab[t], ab[t - 1]
            g0 = (1 - alpha) * math.sqrt(ab_p) / (1 - ab_t)
            g1 = (1 - ab_p) * math.sqrt(alpha) / (1 - ab_t)
            g2 = 1 + (math.sqrt(ab_t) - 1) * (math.sqrt(alpha) + math.sqrt(ab_p)) / (1 - ab_t)
            var = (1 - ab_p) / (1 - ab_t) * (1 - alpha)
            y = g0 * reparam(y, eps, y_hat, ab_t) + g1 * y + g2 * y_hat + math.sqrt(var) * z[i + 1]
        return reparam(y, net.eps(f_rows, y, y_hat, 0), y_hat, ab[0])
    tau = ddim_tau(len(ab), steps)
    eta = cfg["ddim_eta"]
    for i, (t, s) in enumerate(zip(tau[1:][::-1], tau[:-1][::-1])):
        eps = net.eps(f_rows, y, y_hat, t)
        y0 = reparam(y, eps, y_hat, ab[t])
        sigma = eta * math.sqrt((1 - ab[s]) / (1 - ab[t])) * math.sqrt(max(1 - ab[t] / ab[s], 0.0))
        direction = math.sqrt(max(1 - ab[s] - sigma**2, 0.0))
        y = math.sqrt(ab[s]) * y0 + (1 - math.sqrt(ab[s])) * y_hat + direction * eps + sigma * z[i + 1]
    return reparam(y, net.eps(f_rows, y, y_hat, tau[0]), y_hat, ab[tau[0]])


def n_draws(cfg) -> int:
    return len(ddim_tau(cfg["timesteps"], cfg["ddim_steps"])) if cfg["ddim_steps"] else cfg["timesteps"]


# ------------------------------------------------------------------ the call


def aggregate(samples: torch.Tensor, temperature: float) -> Dict[str, np.ndarray]:
    """(S, B, C) MC samples -> the outputs, float64."""
    x = samples.double()
    probs = torch.softmax(-((x - 1.0) ** 2) / temperature, dim=-1).mean(0)
    c = x.shape[-1]
    counts = (x.argmax(-1)[..., None] == torch.arange(c, device=x.device)).sum(0)
    lo, hi = torch.quantile(x, 0.025, dim=0), torch.quantile(x, 0.975, dim=0)
    out = dict(probs=probs, counts=counts, vote=counts.argmax(-1), piw=hi - lo, var=x.var(0, correction=1))
    return {k: v.cpu().numpy() for k, v in out.items()}


@torch.no_grad()
def predict(cfg, g, s, images: torch.Tensor, noise: torch.Tensor, int_bits: Optional[int] = None,
            fp8: bool = False):
    """The outputs of one call; see the module docstring."""
    no_tf32()
    product = mm_fp8 if fp8 else mm
    images = _f(images)
    m_count, k = cfg["num_members"], cfg["mc_trials"]
    b, c = images.shape[0], cfg["num_classes"]
    if tuple(noise.shape) != (n_draws(cfg), m_count, k, b, c):
        raise ValueError(f"noise has shape {tuple(noise.shape)}")
    y_hat = guidance(cfg, g, images, product)
    x_flat = images.reshape(b, -1)
    samples = []
    for m in range(m_count):
        f_rows = encode(s, m, x_flat, product).repeat(k, 1)  # row t * B + i: image i
        rows_hat = y_hat[m].repeat(k, 1)
        z = _f(noise[:, m]).reshape(noise.shape[0], k * b, c)
        samples.append(chain(cfg, Member(s, m, int_bits, product), f_rows, rows_hat, z).reshape(k, b, c))
    return aggregate(torch.cat(samples), cfg["temperature"])
