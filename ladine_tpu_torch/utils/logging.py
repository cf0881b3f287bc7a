"""Observability: structured logging, scalar metrics, memory and profiles.

Counterpart of ``ladine_tpu/utils/logging.py``:

* ``setup_logging``: stream + file handler (``stdout.txt``) with the same
  format, on the ``ladine_tpu_torch`` logger (its records also reach the
  root logger's handlers, where the JAX package's stop);
* ``ScalarLogger``: an append-only ``scalars.jsonl`` (always on) with a
  TensorBoard mirror where ``torch.utils.tensorboard`` imports;
* ``device_memory_stats``: each card's memory in use and at its peak, from
  ``torch.cuda.memory_stats``;
* ``trace``: a ``torch.profiler`` trace of the block, written as a Chrome
  trace into the directory.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

FORMAT = "%(levelname)s - %(filename)s - %(asctime)s - %(message)s"
LOGGER = "ladine_tpu_torch"


def setup_logging(log_dir: Optional[str] = None, verbose: str = "INFO") -> logging.Logger:
    logger = logging.getLogger(LOGGER)
    logger.setLevel(getattr(logging, verbose.upper(), logging.INFO))
    # records still propagate to the root logger (an application's own
    # handlers there, or pytest's capture, see them too)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(FORMAT))
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "stdout.txt"))
        fh.setFormatter(logging.Formatter(FORMAT))
        logger.addHandler(fh)
    return logger


class ScalarLogger:
    """Append-only scalars.jsonl, one ``{"tag", "value", "step", "ts"}``
    object a line; mirrored to TensorBoard where it imports."""

    def __init__(self, log_dir: Optional[str], use_tensorboard: bool = True):
        self.log_dir = log_dir
        self._file = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tensorboard"))

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        if self._file:
            self._file.write(
                json.dumps({"tag": tag, "value": float(value), "step": int(global_step), "ts": time.time()})
                + "\n"
            )
            self._file.flush()
        if self._tb:
            self._tb.add_scalar(tag, value, global_step)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._tb:
            self._tb.close()
            self._tb = None


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Each visible card's memory in GiB: in use now and at its peak
    (``torch.cuda.memory_stats``); empty without CUDA."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": stats.get("allocated_bytes.all.current", 0) / 2**30,
            "peak_bytes_gib": stats.get("allocated_bytes.all.peak", 0) / 2**30,
        }
    return out


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where there is
    a card), written to ``log_dir/trace.json`` (open it in Perfetto or
    ``chrome://tracing``)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
