"""Mapping network: intermediate ViT features -> class logits.

Counterpart of ``ladine_tpu/models/mlp.py::MappingMLP``:
196*768 -> 4096 -> 2048 -> 128 -> num_classes with ReLU and no dropout. The
(B, 196, 768) tap is flattened patch-major, then channel.

:func:`stacked_forward` runs K such MLPs whose state-dict tensors are
stacked on a leading axis, one batched GEMM a layer: the mapping trainer's
form, as the JAX trainer vmaps over stacked parameter trees.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ladine_tpu_torch.device import resolve_device


class MappingMLP(nn.Module):
    def __init__(
        self,
        in_dim: int = 196 * 768,
        num_classes: int = 2,
        hidden_dims: Sequence[int] = (4096, 2048, 128),
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        dims = (in_dim, *hidden_dims, num_classes)
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=dev, dtype=dtype) for i, o in zip(dims[:-1], dims[1:])
        )
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def stacked_forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """K MLPs at once: ``params`` holds a ``MappingMLP`` state dict's tensors
    (``layers.{j}.weight`` (K, out, in), ``layers.{j}.bias`` (K, out)) and
    x is (K, B, ...), each member's input flattened per row -> (K, B, C).
    Each layer casts its input to the weight's dtype, as ``nn.Linear`` in a
    module of that dtype does."""
    n_layers = sum(k.endswith(".weight") for k in params)
    x = x.reshape(x.shape[0], x.shape[1], -1)
    for j in range(n_layers):
        w, b = params[f"layers.{j}.weight"], params[f"layers.{j}.bias"]
        x = torch.baddbmm(b.unsqueeze(1), x.to(w.dtype), w.transpose(1, 2))
        if j < n_layers - 1:
            x = torch.relu(x)
    return x
