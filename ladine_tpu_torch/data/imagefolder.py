"""ImageFolder data pipeline: directory-tree datasets -> batched NHWC arrays.

The port's own copy of ``ladine_tpu/data/imagefolder.py``, in place of the
reference's torchvision ImageFolder + DataLoader: PIL decode and resize in
a thread pool, batches prefetched in the background so that host IO
overlaps the card's work, channel-last float32 numpy output. PIL (Pillow)
is imported only when an image is decoded; a machine without it can read
array corpora (``data/downloads.py``) but not ImageFolder trees.

Semantics kept:
* class indices by sorted directory name (torchvision's rule);
* splits in ``training/ validation/ testing`` subdirectories;
* ``grayscaled`` = 3-channel grayscale + resize + [0, 1] scale;
  ``standardized`` = resize + [0, 1] scale + per-channel normalize with the
  pinned constants (or freshly computed, ``compute_mean_std``);
* adversarial datasets (``Test_attacks_{name}/``): resize + scale only;
* ``drop_last`` (the reference's test loaders drop the tail batch).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ladine_tpu_torch.data.constants import IMAGE_SIZE, NORM_STATS

# torchvision IMG_EXTENSIONS (datasets/folder.py) — .tif/.ppm/.pgm matter for
# medical corpora; .gif is NOT accepted by torchvision and so not here either
_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")

SPLIT_DIRS = {"train": "training", "valid": "validation", "test": "testing"}


def _find_classes(directory: str) -> List[str]:
    classes = sorted(
        e.name for e in os.scandir(directory) if e.is_dir() and not e.name.startswith(".")
    )
    if not classes:
        raise FileNotFoundError(f"no class directories under {directory}")
    return classes


def _list_samples(directory: str) -> Tuple[List[str], np.ndarray, List[str]]:
    classes = _find_classes(directory)
    paths: List[str] = []
    labels: List[int] = []
    for idx, cls in enumerate(classes):
        cls_dir = os.path.join(directory, cls)
        for root, _, files in sorted(os.walk(cls_dir)):
            for f in sorted(files):
                if f.lower().endswith(_EXTS):
                    paths.append(os.path.join(root, f))
                    labels.append(idx)
    return paths, np.asarray(labels, np.int64), classes


def _load_image(
    path: str, size: Tuple[int, int], grayscale: bool
) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        if grayscale:
            img = img.convert("L").convert("RGB")
        else:
            img = img.convert("RGB")
        # PIL BILINEAR matches torchvision Resize on PIL inputs
        img = img.resize((size[1], size[0]), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0  # HWC, [0, 1]
    return arr


@dataclass
class ImageFolderDataset:
    """A split of an ImageFolder tree, decoded lazily.

    preprocess: 'grayscaled' | 'standardized' | 'raw'
    (raw = resize + [0,1] scale only — the attack-dataset transform).
    """

    root: str
    preprocess: str = "grayscaled"
    image_size: Tuple[int, int] = IMAGE_SIZE
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None
    num_workers: int = 8
    # keep decoded float32 images in RAM across epochs: PIL decode+resize of
    # a split costs seconds per epoch while the accelerator's work is ~1 s —
    # "auto" caches whenever the whole split fits in ~2 GB
    cache_decoded: Any = "auto"
    paths: List[str] = field(init=False)
    labels: np.ndarray = field(init=False)
    classes: List[str] = field(init=False)

    def __post_init__(self):
        if self.preprocess not in ("grayscaled", "standardized", "raw"):
            raise ValueError(f"invalid preprocess {self.preprocess!r}")
        self.paths, self.labels, self.classes = _list_samples(self.root)
        if self.preprocess == "standardized" and (self.mean is None or self.std is None):
            raise ValueError("standardized preprocess requires mean/std")
        if self.cache_decoded == "auto":
            per_img = self.image_size[0] * self.image_size[1] * 3 * 4
            self.cache_decoded = len(self.paths) * per_img <= 2_000_000_000
        object.__setattr__(self, "_decode_cache", {} if self.cache_decoded else None)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def _pool(self) -> ThreadPoolExecutor:
        """Persistent decode pool (a fresh pool per batch would spawn and
        join num_workers OS threads hundreds of thousands of times over a
        long training run)."""
        pool = getattr(self, "_decode_pool", None)
        if pool is None:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            object.__setattr__(self, "_decode_pool", pool)
        return pool

    def load_indices(self, indices: Sequence[int]) -> np.ndarray:
        gray = self.preprocess == "grayscaled"
        cache = self._decode_cache
        if cache is None:
            imgs = list(
                self._pool().map(lambda i: _load_image(self.paths[i], self.image_size, gray), indices)
            )
        else:
            missing = [i for i in indices if i not in cache]
            if missing:
                for i, arr in zip(missing, self._pool().map(
                        lambda i: _load_image(self.paths[i], self.image_size, gray),
                        missing)):
                    cache[i] = arr
            imgs = [cache[i] for i in indices]
        batch = np.stack(imgs)  # (B, H, W, 3) — a fresh copy; cache stays clean
        if self.preprocess == "standardized":
            batch = (batch - self.mean) / self.std
        return batch

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        with_indices: bool = False,
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield (images, labels[, dataset_indices]) with background prefetch
        of the next batches, overlapping decode with device compute.
        ``with_indices`` additionally yields each batch's sample indices —
        used to align precomputed per-sample tensors (e.g. frozen-guidance
        predictions) with shuffled batches."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if drop_last:
            order = order[: (n // batch_size) * batch_size]
        chunks = [order[i : i + batch_size] for i in range(0, len(order), batch_size)]

        with ThreadPoolExecutor(max_workers=1) as loader:
            futures = [
                loader.submit(self.load_indices, chunk) for chunk in chunks[:prefetch]
            ]
            for i, chunk in enumerate(chunks):
                if i + prefetch < len(chunks):
                    futures.append(loader.submit(self.load_indices, chunks[i + prefetch]))
                images = futures.pop(0).result()
                if with_indices:
                    yield images, self.labels[chunk], chunk
                else:
                    yield images, self.labels[chunk]


def compute_mean_std(dataset: ImageFolderDataset, batch_size: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Mean of per-image channel means/stds over the split — the reference's
    on-the-fly statistic (chest_x_ray_dataset.py:55-70 averages per-image
    mean and per-image std, NOT the global pixel stats)."""
    total_mean = np.zeros(3, np.float64)
    total_std = np.zeros(3, np.float64)
    n = len(dataset)
    for i in range(0, n, batch_size):
        batch = dataset.load_indices(range(i, min(i + batch_size, n)))
        total_mean += batch.mean(axis=(1, 2)).sum(axis=0)
        total_std += batch.std(axis=(1, 2), ddof=1).sum(axis=0)
    return (total_mean / n).astype(np.float32), (total_std / n).astype(np.float32)


def load_split(
    root_dir: str,
    dataset_name: str,
    split: str,
    preprocess: str = "grayscaled",
    use_precal_mean_std: bool = True,
    image_size: Tuple[int, int] = IMAGE_SIZE,
) -> ImageFolderDataset:
    """Open one split of a named dataset (reference ``data_loader``,
    chest_x_ray_dataset.py:9-192)."""
    from ladine_tpu_torch.data.constants import base_dataset

    base = base_dataset(dataset_name)
    mean = std = None
    if preprocess == "standardized":
        if use_precal_mean_std:
            mean, std = NORM_STATS[base]
        else:
            train = ImageFolderDataset(
                os.path.join(root_dir, SPLIT_DIRS["train"]),
                preprocess="raw",
                image_size=image_size,
            )
            mean, std = compute_mean_std(train)
    return ImageFolderDataset(
        os.path.join(root_dir, SPLIT_DIRS[split]),
        preprocess=preprocess,
        image_size=image_size,
        mean=mean,
        std=std,
    )


def load_attack_split(
    root_dir: str, attack_name: str, image_size: Tuple[int, int] = IMAGE_SIZE
) -> ImageFolderDataset:
    """Pre-generated adversarial test set ``Test_attacks_{name}/``
    (chest_x_ray_dataset.py:196-227): resize + [0,1] scale only."""
    return ImageFolderDataset(
        os.path.join(root_dir, f"Test_attacks_{attack_name}"),
        preprocess="raw",
        image_size=image_size,
    )
