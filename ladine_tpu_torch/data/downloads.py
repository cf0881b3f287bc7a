"""Ingestion for the reference's download-served corpora: MNIST,
FashionMNIST, RotatedMNIST, PathMNIST.

The port's own copy of ``ladine_tpu/data/downloads.py``. The reference
fetches these with torchvision/medmnist downloads; this reads the same
standard files from local disk only, never the network:

    {root}/MNIST/raw/{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]
    {root}/FashionMNIST/raw/...                        (same idx layout)
    {root}/pathmnist.npz                               (medmnist layout:
        {train,val,test}_images / {train,val,test}_labels)

``load_mnist_family`` gives :class:`ArrayDataset` splits with the
reference's transform stacks:

* MNIST / FashionMNIST: grayscale -> 3 channels, resize, [0, 1] scale. The
  reference loader has no branch for these two, so 'train' and 'valid' are
  a disjoint fixed-seed 90/10 carve of the training corpus (neither touches
  t10k), the JAX package's convention.
* RotatedMNIST: RandomRotation(45) on train, RandomRotation(90) on
  valid/test, before the resize; valid is the TRAIN corpus under
  test-strength rotation (a reference quirk, kept).
* PathMNIST: 28x28 RGB; 'grayscaled' (luma, then a 3-channel repeat) or
  'none'; labels are squeezed to scalars.

Transforms run per batch inside :meth:`ArrayDataset.load_indices`, so the
images stay at their native 28x28 until batch time.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

from ladine_tpu_torch.data.arrays import (
    ArrayDataset,
    compose,
    random_rotate,
    repeat_channels,
    resize_to,
)

MNIST_FAMILY = ("MNIST", "FashionMNIST", "RotatedMNIST", "PathMNIST")


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(
        f"{path}[.gz] not found. This environment has no network access; "
        "place the standard artifact there (the file torchvision's "
        "download=True would fetch) and retry."
    )


def read_idx(path: str) -> np.ndarray:
    """Read an IDX-format array (the MNIST wire format), plain or gzipped."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        if dtype_code != 0x08:  # unsigned byte — the only type MNIST uses
            raise ValueError(f"{path}: unsupported IDX dtype 0x{dtype_code:02x}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(shape)


def load_idx_split(raw_dir: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N,28,28), labels (N,)) from an MNIST-layout raw dir."""
    stem = "train" if train else "t10k"
    images = read_idx(os.path.join(raw_dir, f"{stem}-images-idx3-ubyte"))
    labels = read_idx(os.path.join(raw_dir, f"{stem}-labels-idx1-ubyte"))
    return images, labels


def load_pathmnist_split(root: str, split: str) -> Tuple[np.ndarray, np.ndarray]:
    """medmnist pathmnist.npz: {split}_images (N,28,28,3) + labels (N,1)."""
    path = os.path.join(root, "pathmnist.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found. This environment has no network access; "
            "place the medmnist pathmnist.npz there and retry."
        )
    z = np.load(path)
    key = {"train": "train", "valid": "val", "test": "test"}[split]
    # squeeze (N,1) label columns to scalars (the reference's
    # CustomTargetTransform, dataset.py:244-248)
    return z[f"{key}_images"], np.asarray(z[f"{key}_labels"]).reshape(-1)


def _luma_3ch(batch: np.ndarray, rng) -> np.ndarray:
    """torchvision Grayscale(num_output_channels=3) on RGB input: ITU-R 601
    luma, repeated to 3 channels."""
    if batch.shape[-1] == 3:
        g = (batch[..., 0] * 0.2989 + batch[..., 1] * 0.587 + batch[..., 2] * 0.114)
        batch = g[..., None]
    return np.repeat(batch, 3, axis=-1)


def load_mnist_family(
    name: str,
    root: str,
    split: str,
    preprocess: str = "grayscaled",
    image_size: Tuple[int, int] = (224, 224),
) -> ArrayDataset:
    """One split of a download-served corpus as an :class:`ArrayDataset`
    (reference ``data_loader`` branches, mapping/data/dataset.py:172-263).

    ``split`` is 'train' | 'valid' | 'test'. MNIST/FashionMNIST have no
    separate validation corpus in the wire format, and no reference
    convention to follow (the reference loader rejects them) — so 'train'
    and 'valid' are a disjoint fixed-seed 90/10 carve of the training
    corpus: temperature fitting / model selection never see training or
    test instances. RotatedMNIST keeps the reference's own quirk: 'valid'
    is the FULL train corpus under test-strength rotation
    (dataset.py:258-263: valid uses ``train=True``)."""
    if name not in MNIST_FAMILY:
        raise ValueError(f"{name!r} is not one of {MNIST_FAMILY}")
    if split not in ("train", "valid", "test"):
        raise ValueError(f"bad split {split!r}")

    if name == "PathMNIST":
        images, labels = load_pathmnist_split(root, split)
        stages = []
        if preprocess == "grayscaled":
            stages.append(_luma_3ch)
        elif preprocess != "none":
            raise ValueError("PathMNIST preprocess must be grayscaled|none")
        stages.append(resize_to(*image_size))
        return ArrayDataset(images, labels, transform=compose(*stages))

    raw_dir = os.path.join(
        root, "FashionMNIST" if name == "FashionMNIST" else "MNIST", "raw"
    )
    images, labels = load_idx_split(raw_dir, train=split != "test")
    if name in ("MNIST", "FashionMNIST") and split != "test":
        # disjoint 90/10 train/valid carve (fixed seed): the idx wire format
        # has no validation corpus and t10k must stay untouched by
        # selection/calibration. Full-train 'valid' would fit the
        # calibration temperature on training data.
        perm = np.random.default_rng(1742).permutation(len(labels))
        n_val = len(labels) // 10
        idx = np.sort(perm[:n_val] if split == "valid" else perm[n_val:])
        images, labels = images[idx], labels[idx]
    stages = [repeat_channels(3)]  # 1ch -> 3ch
    if name == "RotatedMNIST":
        # rotation BEFORE resize, on the native 28x28 (the Compose order)
        stages.append(random_rotate(45.0 if split == "train" else 90.0))
    stages.append(resize_to(*image_size))
    return ArrayDataset(images, labels, transform=compose(*stages))
