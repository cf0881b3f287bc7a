"""Serving an AOT bundle, and the request steps every predictor shares.

Counterpart of ``ladine_tpu/infer/serve.py::ExportedPredictor``. A bundle
(``Predictor.export_serving``) is a directory:

    programs/serving_b{B}.pt2   one torch.export program per batch size B
    weights/                    the run weights (utils/checkpoint.py) and the
                                meta (kind "exported_predictor")

:class:`ExportedPredictor` serves it with no model code and no tracing:
this module imports the kernels' ops, which the programs call, and none of
``ladine_tpu_torch.models``. On the card each batch size runs as one CUDA
graph (``infer/graphs.py``). A bundle runs on the device type it was
exported on and refuses any other, as the JAX bundle is platform-locked.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

import ladine_tpu_torch.kernels  # noqa: F401  (registers the ops the programs call)
from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.graphs import GraphCache
from ladine_tpu_torch.utils.checkpoint import load_checkpoint, load_checkpoint_meta

PROGRAMS, WEIGHTS = "programs", "weights"
OUTPUTS = ("probs", "majority_vote", "piw", "mc_variance")


def program_path(bundle: str, batch: int) -> str:
    return os.path.join(bundle, PROGRAMS, f"serving_b{int(batch)}.pt2")


def call_seed(seed: int, counter: int) -> int:
    """The generator seed of one ``predict`` call: ``seed`` and the call
    counter mixed into 64 bits (``numpy.random.SeedSequence``), for any
    non-negative ints. The JAX package folds the counter into
    ``PRNGKey(seed)``; the draws differ, the property is the same: distinct
    (seed, counter) pairs give distinct streams."""
    return int(np.random.SeedSequence([int(seed), int(counter)]).generate_state(1, np.uint64)[0])


def request_images(images, img_size: int) -> torch.Tensor:
    """(B, img, img, 3) images -> a float32 host tensor; raises on another shape."""
    s = img_size
    if images.ndim != 4 or tuple(images.shape[1:]) != (s, s, 3):
        raise ValueError(f"predict expects images of shape (B, {s}, {s}, 3); got {tuple(images.shape)}")
    return torch.as_tensor(images, dtype=torch.float32)


def request_noise(shape, device: torch.device, generator: Optional[torch.Generator],
                  noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The sampler's draws of one request: the injected ``noise`` (checked
    against ``shape``), or one ``torch.randn`` on ``device`` from
    ``generator``, all draws at once, as the samplers draw them."""
    shape = tuple(shape)
    if noise is None:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise must have shape {shape}; got {tuple(noise.shape)}")
    return noise.to(torch.float32)


def run_request(program: Callable, graphs: Optional[GraphCache], device: torch.device,
                images: torch.Tensor, noise: torch.Tensor) -> Dict[str, np.ndarray]:
    """One request through ``program``: as a CUDA graph of its batch shape
    when there are ``graphs`` (on the card), else eagerly; numpy outputs."""
    if graphs is not None:
        outs = graphs(images, noise)
    else:
        outs = program(images.to(device), noise.to(device))
    return {k: v.cpu().numpy() for k, v in zip(OUTPUTS, outs)}


@dataclasses.dataclass
class ExportedPredictor:
    """Serve a ``Predictor.export_serving`` bundle: loaded ``torch.export``
    programs and the run weights. No model classes, no tracing: the served
    program is the one that was exported (and validated).

    Fixed batch sizes: ``predict`` dispatches on the request's batch size
    and refuses sizes the bundle does not carry (front it with a
    ``MicroBatcher`` over ``MicroBatcher.bucket_sizes(cap)``, or export the
    sizes you serve)."""

    programs: Dict[int, Any]  # batch size -> the loaded program's module
    weights: Dict[str, torch.Tensor]
    settings: Dict[str, Any]
    img_size: int
    noise_shape: Tuple[int, ...]  # (n_draws, members, mc_trials, y_dim)
    seed: int = 0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._graphs = GraphCache(self._run, self.device) if self.device.type == "cuda" else None
        self._counter = itertools.count()

    @classmethod
    def load(cls, path: str, device="cuda") -> "ExportedPredictor":
        """A bundle written by ``Predictor.export_serving``, served on
        ``device``; raises on a plain predictor artifact, on a bundle without
        programs, and on a bundle exported on another device type."""
        dev = resolve_device(device)
        meta = load_checkpoint_meta(os.path.join(path, WEIGHTS))
        if meta.get("kind") != "exported_predictor":
            raise ValueError(f"{path} is not an export_serving bundle (kind: {meta.get('kind', 'unknown')})")
        if meta["device_type"] != dev.type:
            raise ValueError(f"bundle {path} was exported on {meta['device_type']} and runs there only, "
                             f"not on {dev.type}: export it on the device type you serve on")
        programs = {}
        for p in glob.glob(os.path.join(path, PROGRAMS, "serving_b*.pt2")):
            b = int(os.path.basename(p)[len("serving_b"):-len(".pt2")])
            programs[b] = torch.export.load(p).module()
        if not programs:
            raise ValueError(f"no serving programs under {path}/{PROGRAMS}")
        weights, _ = load_checkpoint(os.path.join(path, WEIGHTS), map_location=dev)
        return cls(programs=programs, weights=weights, settings=meta["settings"],
                   img_size=int(meta["img_size"]), noise_shape=tuple(meta["noise_shape"]),
                   seed=int(meta.get("seed", 0)), device=dev)

    def _run(self, images: torch.Tensor, noise: torch.Tensor):
        return self.programs[images.shape[0]](self.weights, images, noise)

    @torch.inference_mode()
    def predict(self, images, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
        """images: (B, H, W, 3) float32 in [0, 1], B one of the bundle's
        batch sizes. ``generator`` and ``noise`` as in ``Predictor.predict``."""
        x = request_images(images, self.img_size)
        b = x.shape[0]
        if b not in self.programs:
            raise ValueError(f"bundle has programs for batch sizes {sorted(self.programs)}, got {b}: "
                             f"pad or split the request, or re-export with batch_sizes=({b},)")
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(call_seed(self.seed, next(self._counter)))
        n, m, k, c = self.noise_shape
        z = request_noise((n, m, k, b, c), self.device, generator, noise)
        return run_request(self._run, self._graphs, self.device, x, z)
