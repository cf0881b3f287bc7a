"""The int8 inference path: int8 weights, per-row int8 activations.

Counterpart of ``ladine_tpu/kernels/int8.py``. Weights are quantized per
output channel once (symmetric max-abs, /127); activations per row at every
call, symmetric, or with a fixed zero-point of 127 (/254) for the
non-negative softplus outputs, where ``x @ W = xs * (q @ W_q + 127 *
colsum(W_q)) * w_scale``. The products run in int32.

Here the int8 GEMM is ``torch._int_mm`` (:func:`int_matmul`), as the JAX
package leaves it to XLA; the hand-written kernels of the reverse chain are
``kernels/int8_linear.py`` and ``kernels/int8_eps_fused.py``.

Every int8 weight here is a ``(..., K, N)`` tensor stored K-contiguous (its
transpose is contiguous): the layout cuBLAS's int8 GEMM and the kernels'
s8 ``wgmma`` read. Quantization goes member by member and in row chunks, so
no float copy of a whole stacked weight is ever made, and it never writes to
the model: the float weights stay as they are.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ladine_tpu_torch.kernels.fused_eps import _BN_EPS, fold_table

_CHUNK_ELEMS = 1 << 24  # rows quantized at a time: at most 64 MB of float32 temporaries


def softplus(z: torch.Tensor) -> torch.Tensor:
    """``max(z, 0) + log1p(exp(-|z|))``: jax.nn.softplus's formula, and the
    CUDA kernels' epilogue."""
    return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-z.abs()))


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` by an IEEE division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead, which
    can land one ulp away and so pick another int8 scale and code than the
    JAX package and the kernels do."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _k_contiguous(shape, device) -> torch.Tensor:
    """An empty int8 ``(..., K, N)`` tensor whose transpose is contiguous."""
    return torch.empty(shape[:-2] + (shape[-1], shape[-2]), dtype=torch.int8,
                       device=device).transpose(-1, -2)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float -> (int8 (..., K, N) stored K-contiguous, float32
    per-output-channel scale (..., N)). Bit-equal to the JAX package's."""
    *lead, k, n = w.shape
    w_q = _k_contiguous(tuple(w.shape), w.device)
    scale = torch.empty(tuple(lead) + (n,), dtype=torch.float32, device=w.device)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    for idx in itertools.product(*map(range, lead)):
        wm, qm = w[idx], w_q[idx]
        # max |w| is exact in any float type, so the cast can come after it
        sm = torch.clamp_min(div(wm.abs().amax(0).float(), 127.0), 1e-8)
        scale[idx] = sm
        for k0 in range(0, k, step):
            qm[k0:k0 + step] = torch.round(wm[k0:k0 + step].float() / sm).clamp_(-127, 127).to(torch.int8)
    return w_q, scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (..., R, K) @ int8 (..., K, N) -> int32 (..., R, N), exact.

    Leading axes broadcast (a 2-D ``a`` against member-stacked ``b``). One
    ``torch._int_mm`` per leading index. cuBLAS's int8 GEMM takes more than
    16 rows and K, N multiples of 8, so on the card the operands are
    zero-padded to that where they fall short; padding adds zero products."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    r, k = a.shape[-2:]
    n = b.shape[-1]
    out = torch.empty(tuple(lead) + (r, n), dtype=torch.int32, device=a.device)
    a = a.expand(tuple(lead) + (r, k))
    b = b.expand(tuple(lead) + (k, n))
    pad_r = max(0, 17 - r) if a.is_cuda else 0
    pad_k = (-k) % 8 if a.is_cuda else 0
    pad_n = (-n) % 8 if a.is_cuda else 0
    for idx in itertools.product(*map(range, lead)):
        am, bm = a[idx], b[idx]
        if pad_r or pad_k:
            am = F.pad(am, (0, pad_k, 0, pad_r))
        if pad_k or pad_n:
            bm = F.pad(bm.transpose(0, 1), (0, pad_k, 0, pad_n)).transpose(0, 1)
        out[idx] = torch._int_mm(am, bm)[:r, :n]
    return out


def quantize_rows(x: torch.Tensor, xs: torch.Tensor, zero_point: bool) -> torch.Tensor:
    """int8 codes of float32 ``x`` at per-row scales ``xs``:
    ``clip(round(x / xs) [- 127], -127, 127)``, rounding half to even."""
    q = torch.round(x / xs)
    if zero_point:
        q = q - 127.0
    return q.clamp_(-127, 127).to(torch.int8)


def int8_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    w_colsum: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., R, K) float @ int8 (..., K, N) -> (..., R, N) float32, with
    per-row dynamic activation quantization. With ``w_colsum`` the
    activation is taken as non-negative: zero-point 127, scale max / 254."""
    x = x.float()
    if w_colsum is None:
        xs = torch.clamp_min(div(x.abs().amax(-1, keepdim=True), 127.0), 1e-8)
        acc = int_matmul(quantize_rows(x, xs, False), w_q).float()
    else:
        xs = torch.clamp_min(div(x.amax(-1, keepdim=True), 254.0), 1e-8)
        acc = int_matmul(quantize_rows(x, xs, True), w_q).float() + 127.0 * w_colsum.unsqueeze(-2)
    return acc * xs * w_scale.unsqueeze(-2)


Int8Layers = Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _state(src) -> Mapping[str, torch.Tensor]:
    """A module's tensors by name (its state dict: no copies), or a mapping
    of the same names as it is, such as an artifact's tree."""
    return src.state_dict() if isinstance(src, torch.nn.Module) else src


def no_grad_if_enabled(fn):
    """``torch.no_grad()`` around ``fn`` where grad is on, and nothing where
    it is off already: ``torch.export`` records each grad-mode switch it
    traces as a node and re-emits the whole graph for each one, which for a
    switch in every step of a chain was most of an int8 program's export."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)

    return wrapper


@torch.no_grad()
def quantize_member(model) -> Int8Layers:
    """int8 lin2 and lin3 of a stacked ``ConditionalModel`` (or of its state
    dict): ``{"lin2": (w_q (M, K, N), scale (M, N), colsum (M, N)), "lin3":
    ...}``, colsum the float32 per-column sum of w_q."""
    state = _state(model)
    q = {}
    for name in ("lin2", "lin3"):
        w_q, scale = quantize_weight(state[f"{name}.linear.weight"])
        colsum = w_q.sum(dim=-2, dtype=torch.int32).float()
        q[name] = (w_q, scale, colsum)
    return q


def _lin1(model, f, y, y_hat, a1, c1) -> torch.Tensor:
    """lin1 of the int8 eps: ``f * softplus((y_in @ w1) * a1 + c1)``, the
    softplus rounded to f's dtype before the gate, as the JAX package."""
    y_in = model.lin1_input(y, y_hat).float()
    z = torch.matmul(y_in, model.lin1.linear.weight.float())
    h = softplus(z * a1.unsqueeze(-2) + c1.unsqueeze(-2)).to(f.dtype)
    return f * h


def _lin4(model, h) -> torch.Tensor:
    return torch.matmul(h.float(), model.lin4.weight.float()) + model.lin4.bias.float().unsqueeze(-2)


def _folded(model, t, table):
    return fold_table(model, t) if table is None else tuple((a[t], c[t]) for a, c in table)


@no_grad_if_enabled
def int8_eps(model, q: Int8Layers, f: torch.Tensor, y: torch.Tensor, t: int,
             y_hat: torch.Tensor, table=None) -> torch.Tensor:
    """eps with int8 lin2/lin3 (:func:`int8_matmul`); lin1, lin4 and the
    affines in float32. (M, R, F) f, (M, R, C) y and y_hat -> (M, R, C)
    float32. The hidden activations are stored in f's dtype; ``table`` is
    ``kernels.fused_eps.fold_table`` over all timesteps, or None."""
    (a1, c1), (a2, c2), (a3, c3) = _folded(model, t, table)
    h = _lin1(model, f, y, y_hat, a1, c1)
    for name, a, c in (("lin2", a2, c2), ("lin3", a3, c3)):
        w_q, w_scale, colsum = q[name]
        z = int8_matmul(h, w_q, w_scale, colsum if name == "lin3" else None) * a.unsqueeze(-2) \
            + c.unsqueeze(-2)
        h = softplus(z).to(f.dtype)
    return _lin4(model, h)


# ---------------------------------------------------------------- encoder


@torch.no_grad()
def quantize_encoder(model) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 enc_lin1 of a stacked ``ConditionalModel`` (or of its state
    dict): (w_q (M, D, H), scale (M, H)). The float weight stays in the
    model."""
    return quantize_weight(_state(model)["enc_lin1.weight"])


def _bn_eval_affine(dense_bias, bn):
    """(dense bias, eval BatchNorm) -> float32 (a, c) with
    ``bn(x @ W + b) = (x @ W) * a + c``."""
    inv = bn.weight / torch.sqrt(bn.running_var + _BN_EPS)
    return inv, (dense_bias.float() - bn.running_mean) * inv + bn.bias


@no_grad_if_enabled
def int8_encode(model, x: torch.Tensor, qenc=None) -> torch.Tensor:
    """``ConditionalModel.encode`` with int8 enc_lin1 (symmetric
    activations): (B, D) flat images -> (M, B, F) float32. ``qenc`` is
    :func:`quantize_encoder`'s output, or None to quantize in the call."""
    w_q, w_scale = qenc if qenc is not None else quantize_encoder(model)
    a1, c1 = _bn_eval_affine(model.enc_lin1.bias, model.enc_bn1)
    h = softplus(int8_matmul(x, w_q, w_scale) * a1.unsqueeze(-2) + c1.unsqueeze(-2))
    a2, c2 = _bn_eval_affine(model.enc_lin2.bias, model.enc_bn2)
    h = softplus(torch.matmul(h, model.enc_lin2.weight.float()) * a2.unsqueeze(-2) + c2.unsqueeze(-2))
    h = torch.matmul(h, model.enc_lin3.weight.float()) + model.enc_lin3.bias.float().unsqueeze(-2)
    an, cn = _bn_eval_affine(torch.zeros_like(model.norm.bias), model.norm)
    return h * an.unsqueeze(-2) + cn.unsqueeze(-2)


# ---------------------------------------------------------- mapping heads


@torch.no_grad()
def quantize_mapping_heads(guidance, mlp_ids: Sequence[int]) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """int8 first layers of the requested mapping heads of an
    ``SEViTGuidance`` (or of its state dict): ``{i: (w_q (K, N), scale
    (N,))}``; an ``nn.Linear`` weight is the (N, K) transpose."""
    state = _state(guidance)
    return {
        i: quantize_weight(state[f"mlps.{i}.layers.0.weight"].transpose(0, 1))
        for i in sorted({int(i) for i in mlp_ids})
    }


@no_grad_if_enabled
def int8_mapping_heads(guidance, taps: torch.Tensor, mlp_ids: Sequence[int],
                       qheads=None) -> torch.Tensor:
    """Mapping heads with int8 first layers (symmetric activations), the
    rest in float32 with ReLU: (len(ids), B, P, E) taps -> (len(ids), B, C)
    float32 logits. ``qheads`` is :func:`quantize_mapping_heads`'s output,
    or None to quantize in the call."""
    if qheads is None:
        qheads = quantize_mapping_heads(guidance, mlp_ids)
    outs = []
    for tap, i in zip(taps, mlp_ids):
        layers = guidance.mlps[int(i)].layers
        w_q, w_scale = qheads[int(i)]
        x = tap.reshape(tap.shape[0], -1).float()
        x = torch.relu(int8_matmul(x, w_q, w_scale) + layers[0].bias.float())
        for layer in layers[1:-1]:
            x = torch.relu(x @ layer.weight.float().T + layer.bias.float())
        outs.append(x @ layers[-1].weight.float().T + layers[-1].bias.float())
    return torch.stack(outs, dim=0)
