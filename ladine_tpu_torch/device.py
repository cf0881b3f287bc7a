"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card it raises instead of quietly running on the CPU: the CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do.

On the card the port computes float32 in float32, as the JAX package's
float32 paths do: resolving a CUDA device turns TF32 off for matmuls and
for cuDNN's convolutions (torch's default lets cuDNN use TF32), forward
and backward, for the process.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def cli_device(device: str) -> torch.device:
    """:func:`resolve_device` for a command line: without a card, an exit
    with a message instead of a traceback."""
    try:
        return resolve_device(device)
    except RuntimeError:
        raise SystemExit(f"--device {device}: CUDA is not available on this machine; pass --device cpu "
                         "to run on the CPU") from None


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or "cpu": written
    beside every number a run keeps."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
