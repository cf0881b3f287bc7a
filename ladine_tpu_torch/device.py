"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card it raises instead of quietly running on the CPU: the CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
