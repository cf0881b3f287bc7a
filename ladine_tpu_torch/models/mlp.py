"""Mapping network: intermediate ViT features -> class logits.

Counterpart of ``ladine_tpu/models/mlp.py::MappingMLP``:
196*768 -> 4096 -> 2048 -> 128 -> num_classes with ReLU and no dropout. The
(B, 196, 768) tap is flattened patch-major, then channel.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
