"""What the stage-1 command lines share: the demo's separable batches, the
dataset splits by name, and the device batch."""

from __future__ import annotations

import numpy as np
import torch


def demo_batches(num_classes: int, img: int, n: int = 4, b: int = 8, seed: int = 0):
    """Separable synthetic images (class-dependent brightness), so the demo
    can learn: the JAX stage-1 CLIs', numpy for numpy."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        labels = rng.integers(0, num_classes, b)
        images = rng.random((b, img, img, 3)) * 0.1 + labels[:, None, None, None] * 0.5
        yield images.astype(np.float32), labels


class Splits:
    """``batches(split, batch_size, shuffle, seed)`` over the demo batches
    or the named dataset's splits (opened once each)."""

    def __init__(self, args, img: int):
        self.args, self.img, self._open = args, img, {}
        if not args.demo:
            self.dataset("train")

    def dataset(self, split: str):
        from ladine_tpu_torch.data import open_dataset

        if split not in self._open:
            a = self.args
            self._open[split] = open_dataset(a.dataset, a.dataroot, split, a.preprocess,
                                             image_size=(self.img, self.img))
        return self._open[split]

    def steps_per_epoch(self, batch_size: int) -> int:
        return 4 if self.args.demo else max(1, -(-len(self.dataset("train")) // batch_size))

    def batches(self, split: str, batch_size: int, shuffle: bool = False, seed: int = 0):
        if self.args.demo:
            return demo_batches(self.args.num_classes, self.img, seed=seed)
        return self.dataset(split).batches(batch_size, shuffle=shuffle, seed=seed)


def to_device(images, labels, device):
    return (torch.as_tensor(np.asarray(images), dtype=torch.float32).to(device),
            torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(device))


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
