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


def cli_device(device: str) -> torch.device:
    """:func:`resolve_device` for a command line: without a card, an exit
    with a message instead of a traceback."""
    try:
        return resolve_device(device)
    except RuntimeError:
        raise SystemExit(f"--device {device}: CUDA is not available on this machine; pass --device cpu "
                         "to run on the CPU") from None
