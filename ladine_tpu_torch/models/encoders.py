"""The alternate image encoders: ``ConditionalModel``'s ``encoder_x`` archs
other than ``linear``, the ResNet backbones and the trajectory classifier.

Counterpart of ``ladine_tpu/models/encoders.py``. Every encoder takes NHWC
float images, as the JAX modules do, and computes in NCHW inside;
``SimpleEncoder`` flattens (flat or NHWC input). Where the JAX module
flattens a feature map it flattens channel-last, so the port permutes back
to NHWC before it flattens.

The JAX modules name their submodules by class and count (``TorchConv_0``,
``BatchNorm_1``, ``TorchLinear_2``, ...), in call order. The port's
submodules carry the same names, so the weight bridge
(``utils/convert.py``) is a walk of the names, and a shape fixed at call
time in flax (a flattened width, a residual projection) is fixed here at
construction from the input's shape.

BatchNorm follows flax (:class:`BatchNorm`): in train mode the batch's
biased variance ``E[x^2] - E[x]^2`` normalizes and feeds the running update
``0.9 * running + 0.1 * batch``, and the new statistics are returned by
:func:`pop_batch_stats` rather than written into the buffers, as flax's
``mutable=["batch_stats"]`` returns them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ladine_tpu_torch.parallel.mesh import batch_moments

_BN_EPS = 1e-5  # torch BatchNorm default, the reference's
_BN_MOMENTUM = 0.9  # flax's: the weight of the OLD running value
_LN_EPS = 1e-6  # flax LayerNorm default


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis, dim 1 of (B, C) or
    (B, C, H, W). Parameters and statistics are float32; the output is
    float32 (flax promotes), or ``dtype`` where one is given (flax's
    ``BatchNorm(dtype=...)``). In train mode inside
    ``parallel.mesh.global_batch`` the statistics are the global batch's."""

    def __init__(self, features: int, eps: float = _BN_EPS, device=None, dtype=None):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.eps, self.out_dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("running_mean", torch.zeros(features, **f32))
        self.register_buffer("running_var", torch.ones(features, **f32))
        self.batch_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if train:
            dims = [0] + list(range(2, x.dim()))
            mean, mean_sq = batch_moments(xf, dims)
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            m = _BN_MOMENTUM
            self.batch_stats = (m * self.running_mean + (1 - m) * mean.detach(),
                                m * self.running_var + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean.reshape(shape)) * (torch.rsqrt(var + self.eps) * self.weight).reshape(shape)
        y = y + self.bias.reshape(shape)
        return y if self.out_dtype is None else y.to(self.out_dtype)


def pop_batch_stats(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics that the last train-mode call of ``module``
    computed, by state-dict name (``{bn}.running_mean``/``running_var``);
    clears them. Empty when no :class:`BatchNorm` ran in train mode."""
    out = {}
    for name, mod in module.named_modules():
        if isinstance(mod, BatchNorm) and mod.batch_stats is not None:
            prefix = f"{name}." if name else ""
            out[f"{prefix}running_mean"], out[f"{prefix}running_var"] = mod.batch_stats
            mod.batch_stats = None
    return out


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class TorchConv(nn.Conv2d):
    """The JAX package's ``TorchConv``: a conv with torch's default init
    (U(+-1/sqrt(fan_in)) weight and bias); symmetric padding only."""


class FlaxConv(nn.Conv2d):
    """A plain flax ``nn.Conv``: lecun-normal weight and zero bias at init
    (``models/initializers.py``), and flax's ``"SAME"`` padding where
    ``same``: ``(k - 1 + (out - 1) * s - (n - 1))`` split low-first, so a
    stride-2 3x3 conv on an even size pads nothing on top and left and one
    row and column on bottom and right (torch's ``padding=1`` would shift
    every window)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, same: bool = False,
                 groups: int = 1, bias: bool = True, device=None, dtype=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0, groups=groups, bias=bias,
                         device=device, dtype=dtype)
        self.same = same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.same:
            pads = []
            for n, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size), reversed(self.stride)):
                total = max((math.ceil(n / s) - 1) * s + k - n, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        return super().forward(x)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W * C), channel-last as flax flattens."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _conv_out(n: int, k: int, s: int = 1, pad: int = 0) -> int:
    return (n + 2 * pad - k) // s + 1


class SimpleEncoder(nn.Module):
    """arch ``simple``: flat -> 300 -> 100 -> out, BatchNorm + ReLU."""

    def __init__(self, in_dim: int, out_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.TorchLinear_0 = nn.Linear(in_dim, 300, **kw)
        self.BatchNorm_0 = BatchNorm(300, device=device)
        self.TorchLinear_1 = nn.Linear(300, 100, **kw)
        self.BatchNorm_1 = BatchNorm(100, device=device)
        self.TorchLinear_2 = nn.Linear(100, out_dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.BatchNorm_0(self.TorchLinear_0(x), train))
        x = torch.relu(self.BatchNorm_1(self.TorchLinear_1(x), train))
        return self.TorchLinear_2(x)


class LeNet(nn.Module):
    """tanh LeNet with average pooling, on (H, W, C) images."""

    def __init__(self, num_classes: int = 10, image_shape: Sequence[int] = (28, 28, 1),
                 n_input_padding: int = 2, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, w, c = image_shape
        self.TorchConv_0 = TorchConv(c, 6, 5, padding=n_input_padding, **kw)
        self.TorchConv_1 = TorchConv(6, 16, 5, **kw)
        self.TorchConv_2 = TorchConv(16, 120, 5, **kw)
        size = [_conv_out(_conv_out(_conv_out(n, 5, pad=n_input_padding) // 2, 5) // 2, 5) for n in (h, w)]
        self.TorchLinear_0 = nn.Linear(120 * size[0] * size[1], 84, **kw)
        self.TorchLinear_1 = nn.Linear(84, num_classes, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.avg_pool2d(torch.tanh(self.TorchConv_0(_to_nchw(x))), 2)
        x = F.avg_pool2d(torch.tanh(self.TorchConv_1(x)), 2)
        x = _flatten_nhwc(torch.tanh(self.TorchConv_2(x)))
        return self.TorchLinear_1(torch.tanh(self.TorchLinear_0(x)))


class LeNet5(nn.Module):
    """LeNet-5 with BatchNorm, on (H, W, C) images."""

    def __init__(self, num_classes: int = 10, image_shape: Sequence[int] = (28, 28, 1),
                 n_input_padding: int = 2, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, w, c = image_shape
        self.TorchConv_0 = TorchConv(c, 6, 5, padding=n_input_padding, **kw)
        self.BatchNorm_0 = BatchNorm(6, device=device)
        self.TorchConv_1 = TorchConv(6, 16, 5, **kw)
        self.BatchNorm_1 = BatchNorm(16, device=device)
        size = [_conv_out(_conv_out(n, 5, pad=n_input_padding) // 2, 5) // 2 for n in (h, w)]
        self.TorchLinear_0 = nn.Linear(16 * size[0] * size[1], 120, **kw)
        self.TorchLinear_1 = nn.Linear(120, 84, **kw)
        self.TorchLinear_2 = nn.Linear(84, num_classes, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.avg_pool2d(torch.relu(self.BatchNorm_0(self.TorchConv_0(_to_nchw(x)), train)), 2)
        x = F.avg_pool2d(torch.relu(self.BatchNorm_1(self.TorchConv_1(x), train)), 2)
        x = torch.relu(self.TorchLinear_0(_flatten_nhwc(x)))
        return self.TorchLinear_2(torch.relu(self.TorchLinear_1(x)))


class FashionCNN(nn.Module):
    """Two conv blocks and a linear head (three with ``use_for_guidance``),
    on (H, W, C) images."""

    def __init__(self, out_dim: int = 10, image_shape: Sequence[int] = (28, 28, 1),
                 use_for_guidance: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, w, c = image_shape
        self.TorchConv_0 = TorchConv(c, 32, 3, padding=1, **kw)
        self.BatchNorm_0 = BatchNorm(32, device=device)
        self.TorchConv_1 = TorchConv(32, 64, 3, **kw)
        self.BatchNorm_1 = BatchNorm(64, device=device)
        size = [_conv_out(n // 2, 3) // 2 for n in (h, w)]
        flat = 64 * size[0] * size[1]
        self.use_for_guidance = use_for_guidance
        if use_for_guidance:
            self.TorchLinear_0 = nn.Linear(flat, 600, **kw)
            self.TorchLinear_1 = nn.Linear(600, 120, **kw)
            self.TorchLinear_2 = nn.Linear(120, out_dim, **kw)
        else:
            self.TorchLinear_0 = nn.Linear(flat, out_dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.max_pool2d(torch.relu(self.BatchNorm_0(self.TorchConv_0(_to_nchw(x)), train)), 2)
        x = F.max_pool2d(torch.relu(self.BatchNorm_1(self.TorchConv_1(x), train)), 2)
        x = self.TorchLinear_0(_flatten_nhwc(x))
        if self.use_for_guidance:
            x = self.TorchLinear_2(self.TorchLinear_1(x))
        return x


class SimNet(nn.Module):
    """conv-pool-conv-pool feature extractor: (B, H, W, C) -> flat
    channel-last features."""

    def __init__(self, in_channels: int = 1, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.TorchConv_0 = TorchConv(in_channels, 32, 5, **kw)
        self.TorchConv_1 = TorchConv(32, 64, 5, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.max_pool2d(torch.relu(self.TorchConv_0(_to_nchw(x))), 2)
        x = F.max_pool2d(torch.relu(self.TorchConv_1(x)), 2)
        return _flatten_nhwc(x)


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.TorchConv_0 = TorchConv(in_ch, features, 3, stride=stride, padding=1, **kw)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.TorchConv_1 = TorchConv(features, features, 3, padding=1, **kw)
        self.BatchNorm_1 = BatchNorm(features, device=device)
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.TorchConv_2 = TorchConv(in_ch, features, 1, stride=stride, **kw)
            self.BatchNorm_2 = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.TorchConv_0(x), train))
        y = self.BatchNorm_1(self.TorchConv_1(y), train)
        residual = self.BatchNorm_2(self.TorchConv_2(x), train) if self.project else x
        return torch.relu(y + residual)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.TorchConv_0 = TorchConv(in_ch, features, 1, **kw)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.TorchConv_1 = TorchConv(features, features, 3, stride=stride, padding=1, **kw)
        self.BatchNorm_1 = BatchNorm(features, device=device)
        self.TorchConv_2 = TorchConv(features, features * 4, 1, **kw)
        self.BatchNorm_2 = BatchNorm(features * 4, device=device)
        self.project = stride != 1 or in_ch != features * 4
        if self.project:
            self.TorchConv_3 = TorchConv(in_ch, features * 4, 1, stride=stride, **kw)
            self.BatchNorm_3 = BatchNorm(features * 4, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.TorchConv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.TorchConv_1(y), train))
        y = self.BatchNorm_2(self.TorchConv_2(y), train)
        residual = self.BatchNorm_3(self.TorchConv_3(x), train) if self.project else x
        return torch.relu(y + residual)


_RESNETS = {"resnet18": ([2, 2, 2, 2], _BasicBlock), "resnet50": ([3, 4, 6, 3], _Bottleneck)}


class ResNet(nn.Module):
    """torchvision-layout ResNet18/50 classifier on (B, H, W, C) images.
    ``head=False`` builds it without the classifier, as the JAX module is
    when it is only ever called with ``return_features``."""

    def __init__(self, num_classes: int = 2, arch: str = "resnet18", in_channels: int = 3,
                 head: bool = True, device=None, dtype=None):
        super().__init__()
        if arch not in _RESNETS:
            raise ValueError(f"unknown resnet arch {arch!r}")
        blocks_per, block_cls = _RESNETS[arch]
        kw = dict(device=device, dtype=dtype)
        self.TorchConv_0 = TorchConv(in_channels, 64, 7, stride=2, padding=3, bias=False, **kw)
        self.BatchNorm_0 = BatchNorm(64, device=device)
        in_ch, n = 64, 0
        for i, n_blocks in enumerate(blocks_per):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"{block_cls.__name__}_{n}", block_cls(in_ch, 64 * 2**i, stride, **kw))
                in_ch, n = 64 * 2**i * block_cls.expansion, n + 1
        self.n_blocks, self.block_name, self.features = n, block_cls.__name__, in_ch
        if head:
            self.TorchLinear_0 = nn.Linear(in_ch, num_classes, **kw)

    def forward(self, x: torch.Tensor, train: bool = False, return_features: bool = False) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(self.TorchConv_0(_to_nchw(x)), train))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, as flax's max_pool
        for n in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{n}")(x, train)
        x = x.mean(dim=(2, 3))  # global average pool
        if return_features:
            return x
        return self.TorchLinear_0(x)


class ResNetEncoder(nn.Module):
    """ResNet backbone + a linear projection to ``feature_dim``."""

    def __init__(self, feature_dim: int = 128, arch: str = "resnet18", in_channels: int = 3,
                 device=None, dtype=None):
        super().__init__()
        self.ResNet_0 = ResNet(1, arch, in_channels, head=False, device=device, dtype=dtype)
        self.TorchLinear_0 = nn.Linear(self.ResNet_0.features, feature_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.TorchLinear_0(self.ResNet_0(x, train, return_features=True))


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` as the attention below uses it: ``kernel`` in
    flax's layout (in..., out...) with lecun-normal init, ``bias`` (out...)
    zero; ``in_axes`` trailing input axes are contracted."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int], device=None, dtype=None):
        super().__init__()
        self.in_axes = len(in_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(*out_shape, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = list(range(x.dim() - self.in_axes, x.dim()))
        return torch.tensordot(x, self.kernel, dims=(dims, list(range(self.in_axes)))) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` with its defaults: query,
    key and value projections to (heads, dim / heads), softmax of the
    scaled products in float32, and the output projection."""

    def __init__(self, dim: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        head = (num_heads, dim // num_heads)
        self.query = DenseGeneral((dim,), head, **kw)
        self.key = DenseGeneral((dim,), head, **kw)
        self.value = DenseGeneral((dim,), head, **kw)
        self.out = DenseGeneral(head, (dim,), **kw)

    def forward(self, q_in: torch.Tensor, kv_in: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv_in = q_in if kv_in is None else kv_in
        q, k, v = self.query(q_in), self.key(kv_in), self.value(kv_in)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1).to(v.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class TrajectoryClassifier(nn.Module):
    """Classifies a diffusion trajectory (B, seq_len, d_model) guided by an
    image feature (B, ...): an encoder-decoder transformer of ``num_layers``
    (self-attention, cross-attention to the projected feature, MLP), then
    an MLP head over the flattened outputs."""

    def __init__(self, num_classes: int = 10, feature_dim: int = 151296, seq_len: int = 20,
                 d_model: int = 10, num_heads: int = 2, num_layers: int = 4, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_layers = num_layers
        self.TorchLinear_0 = nn.Linear(feature_dim, d_model, **kw)
        for i in range(num_layers):
            setattr(self, f"ln_s{i}", nn.LayerNorm(d_model, eps=_LN_EPS, **kw))
            setattr(self, f"self{i}", MultiHeadDotProductAttention(d_model, num_heads, **kw))
            setattr(self, f"ln_c{i}", nn.LayerNorm(d_model, eps=_LN_EPS, **kw))
            setattr(self, f"cross{i}", MultiHeadDotProductAttention(d_model, num_heads, **kw))
            setattr(self, f"ln_f{i}", nn.LayerNorm(d_model, eps=_LN_EPS, **kw))
            setattr(self, f"ff1_{i}", nn.Linear(d_model, 4 * d_model, **kw))
            setattr(self, f"ff2_{i}", nn.Linear(4 * d_model, d_model, **kw))
        self.TorchLinear_1 = nn.Linear(seq_len * d_model, 128, **kw)
        self.TorchLinear_2 = nn.Linear(128, 64, **kw)
        self.TorchLinear_3 = nn.Linear(64, num_classes, **kw)

    def forward(self, trajectory: torch.Tensor, x_feature: torch.Tensor, train: bool = False) -> torch.Tensor:
        mem = torch.relu(self.TorchLinear_0(x_feature.reshape(x_feature.shape[0], -1)))[:, None, :]
        h = trajectory
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}{i}")  # noqa: E731
            h = h + layer("self")(layer("ln_s")(h))
            h = h + layer("cross")(layer("ln_c")(h), mem)
            f = layer("ff1_")(layer("ln_f")(h))
            h = h + layer("ff2_")(torch.relu(f))
        h = torch.relu(self.TorchLinear_1(h.reshape(h.shape[0], -1)))
        return self.TorchLinear_3(torch.relu(self.TorchLinear_2(h)))


def image_shape_of(data_dim: int) -> Tuple[int, int, int]:
    """The (H, W, C) of a square image of ``data_dim`` values: 3 channels
    where that divides, else 1 (150528 -> (224, 224, 3), 784 -> (28, 28, 1))."""
    for c in (3, 1):
        side = math.isqrt(data_dim // c)
        if data_dim % c == 0 and side * side * c == data_dim:
            return side, side, c
    raise ValueError(f"data_dim {data_dim} is not a square image of 1 or 3 channels")


ARCHS = ("linear", "simple", "lenet", "lenet5", "fashioncnn", "resnet18", "resnet50")


def make_encoder(arch: str, feature_dim: int, image_shape: Sequence[int], device=None, dtype=None) -> nn.Module:
    """``ConditionalModel``'s ``encoder_x`` for a conv arch: (H, W, C) images
    (``simple``: their flat values) -> (B, feature_dim)."""
    h, w, c = image_shape
    kw = dict(device=device, dtype=dtype)
    if arch == "simple":
        return SimpleEncoder(h * w * c, feature_dim, **kw)
    if arch == "lenet":
        return LeNet(feature_dim, image_shape, **kw)
    if arch == "lenet5":
        return LeNet5(feature_dim, image_shape, **kw)
    if arch == "fashioncnn":
        return FashionCNN(feature_dim, image_shape, **kw)
    if arch in ("resnet18", "resnet50"):
        return ResNetEncoder(feature_dim, arch, c, **kw)
    raise ValueError(f"unknown encoder arch {arch!r}")
