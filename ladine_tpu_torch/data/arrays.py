"""In-memory array datasets with the ImageFolder batch API.

The port's own copy of ``ladine_tpu/data/arrays.py``: wrap (images, labels)
numpy arrays and get the ``batches`` / ``load_indices`` interface the
trainers and the evaluator consume, with the reference's MNIST-family
transforms as functions of a numpy batch and a numpy generator (ToTensor
scale, per-channel normalize, random rotation, repeat to 3 channels,
resize). Everything here is numpy on the host; the same seed gives the
same batches as the JAX package. ``resize_to`` runs the port's
``ops/corruptions.py::bilinear_resize`` on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """(N, H, W, C) float or uint8 images + (N,) integer labels."""

    images: np.ndarray
    labels: np.ndarray
    transform: Optional[Callable[[np.ndarray, np.random.Generator], np.ndarray]] = None

    def __post_init__(self):
        assert len(self.images) == len(self.labels)
        if self.images.dtype == np.uint8:
            self.images = self.images.astype(np.float32) / 255.0
        if self.images.ndim == 3:  # (N, H, W) -> single channel
            self.images = self.images[..., None]
        self.labels = np.asarray(self.labels, np.int64)
        # the class index space is 0..max(label), so a split missing a class
        # still sizes models right and classes[label] stays a valid lookup
        self.classes = list(range(int(self.labels.max()) + 1)) if len(self.labels) else []

    def __len__(self) -> int:
        return len(self.images)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def load_indices(self, indices: Sequence[int], rng: Optional[np.random.Generator] = None) -> np.ndarray:
        batch = self.images[np.asarray(indices)]
        if self.transform is not None:
            # no rng given: fresh OS-seeded randomness (a fixed default would
            # repeat the "random" augmentation every call); batches() passes
            # its own seeded rng for reproducible epochs
            batch = self.transform(batch, rng if rng is not None else np.random.default_rng())
        return batch

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 0,  # in memory: prefetch does nothing
        with_indices: bool = False,
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self)
        rng = np.random.default_rng(seed)
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        if drop_last:
            order = order[: (n // batch_size) * batch_size]
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            out = (self.load_indices(idx, rng), self.labels[idx])
            yield out + (idx,) if with_indices else out


def normalize(mean, std) -> Callable:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def t(batch, rng):
        return (batch - mean) / std

    return t


def repeat_channels(n: int = 3) -> Callable:
    """1 channel -> n channels (the reference's x.repeat(3, 1, 1) for the ViT)."""

    def t(batch, rng):
        return np.repeat(batch, n, axis=-1) if batch.shape[-1] == 1 else batch

    return t


def random_rotate(max_degrees: float = 45.0) -> Callable:
    """Per-image random rotation (RotatedMNIST); order 0 (nearest
    neighbour), torchvision RandomRotation's default interpolation."""

    def t(batch, rng):
        from scipy.ndimage import rotate as _rot

        out = np.empty_like(batch)
        for i in range(len(batch)):
            deg = rng.uniform(-max_degrees, max_degrees)
            out[i] = _rot(batch[i], deg, reshape=False, order=0, mode="constant")
        return out

    return t


def resize_to(h: int, w: int) -> Callable:
    """Bilinear resize of an NHWC numpy batch (half-pixel centers, no
    antialiasing), on the CPU."""

    def t(batch, rng):
        import torch

        from ladine_tpu_torch.ops.corruptions import bilinear_resize

        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
        return bilinear_resize(x, h, w).contiguous().numpy()

    return t


def compose(*transforms: Callable) -> Callable:
    def t(batch, rng):
        for f in transforms:
            batch = f(batch, rng)
        return batch

    return t
