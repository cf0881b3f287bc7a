"""A synthetic 2-class 224x224 ImageFolder in the ChestXRay layout
(``training``/``validation``/``testing`` x ``NORMAL``/``TUBERCULOSIS``,
``img_%04d.png``): the port's copy of ``scripts/make_synth_medical.py``,
with its flags, its random stream and its pixels, written through
``data/png.py`` so that no Pillow is needed.

Every image holds the same two feature types, soft Gaussian blobs and
oriented high-frequency ridge patches; the class signal is only the
mixture rate: an image draws a ridge fraction r (NORMAL r ~ Beta(1.5, 6),
TUBERCULOSIS r ~ Beta(6, 1.5)) and makes each of its 8 features a ridge
with probability r, else a blob. The ridge count is BetaBinomial with
overlapping classes, so the Bayes-optimal accuracy is ~91.2 %
(:func:`bayes_accuracy`). Noise sigma ~ U(0.05, 0.12) and feature
amplitude ~ U(0.12, 0.30) vary per image; each image is recentred to mean
0.5. ``--label_noise`` draws that fraction of training images from the
other class's prior.

    python -m ladine_tpu_torch.examples.make_synth_medical --out DIR [--n 250] [--test_n 600]
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from ladine_tpu_torch.data import png

# class-conditional ridge-fraction priors; NORMAL ~ Beta(A, B), TB ~ Beta(B, A)
BETA_A, BETA_B = 1.5, 6.0
N_FEATURES = 8
CLASSES = ("NORMAL", "TUBERCULOSIS")


def bayes_accuracy() -> float:
    """Bayes-optimal accuracy of the ridge count, the only class signal:
    1 - 0.5 * sum_k min(P0(k), P1(k)) over the BetaBinomial counts."""
    from scipy.stats import betabinom

    k = np.arange(N_FEATURES + 1)
    p0 = betabinom.pmf(k, N_FEATURES, BETA_A, BETA_B)
    p1 = betabinom.pmf(k, N_FEATURES, BETA_B, BETA_A)
    return float(1.0 - 0.5 * np.minimum(p0, p1).sum())


def _blob(rng, img, amp):
    yy, xx = np.mgrid[0:224, 0:224]
    cy, cx = rng.uniform(30, 194, 2)
    sig = rng.uniform(12, 30)
    img += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
    return img


def _ridge(rng, img, amp):
    yy, xx = np.mgrid[0:224, 0:224]
    cy, cx = rng.uniform(30, 194, 2)
    sig = rng.uniform(12, 30)
    theta = rng.uniform(0, np.pi)
    freq = rng.uniform(0.25, 0.45)  # high-frequency stripes
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    mask = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
    img += amp * mask * np.sin(2 * np.pi * freq * u)
    return img


def make_image(cls: int, rng) -> np.ndarray:
    """One (224, 224, 3) uint8 image of class ``cls`` from ``rng``."""
    noise_sigma = rng.uniform(0.05, 0.12)
    amp = rng.uniform(0.12, 0.30)
    img = rng.normal(0.45, noise_sigma, (224, 224))
    r = rng.beta(BETA_A, BETA_B) if cls == 0 else rng.beta(BETA_B, BETA_A)
    for _ in range(N_FEATURES):
        img = _ridge(rng, img, amp) if rng.random() < r else _blob(rng, img, amp)
    img = img - img.mean() + 0.5  # brightness-matched: intensity alone carries no signal
    img = np.clip(img, 0.0, 1.0)
    return (np.repeat(img[..., None], 3, -1) * 255).astype(np.uint8)


def split_counts(n: int, test_n: Optional[int] = None) -> Dict[str, int]:
    """Images a class in each split, as the JAX script's flags give them."""
    return {"training": n, "validation": n * 3 // 10, "testing": test_n if test_n is not None else n * 3 // 10}


def write_corpus(out: str, counts: Dict[str, int], seed: int = 0, label_noise: float = 0.0) -> None:
    """The tree into ``out``, ``counts[split]`` images a class, drawn in the
    JAX script's order (training, validation, testing; NORMAL then
    TUBERCULOSIS; image by image) from one ``default_rng(seed)``. The PNGs
    are compressed on a few threads while the next images are drawn."""
    rng = np.random.default_rng(seed)
    with ThreadPoolExecutor(max_workers=4) as pool:
        pending = []
        for split, n in counts.items():
            for cls_idx, cls in enumerate(CLASSES):
                d = os.path.join(out, split, cls)
                os.makedirs(d, exist_ok=True)
                for i in range(n):
                    gen_cls = cls_idx
                    if split == "training" and rng.random() < label_noise:
                        gen_cls = 1 - cls_idx  # image from the other class's prior
                    pending.append(pool.submit(png.write, make_image(gen_cls, rng),
                                               os.path.join(d, f"img_{i:04d}.png")))
        for f in pending:
            f.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--n", type=int, default=250, help="train images per class")
    ap.add_argument("--test_n", type=int, default=None,
                    help="test images per class (default n*3//10); the stream draws training, validation, "
                         "then testing, so a larger test split keeps the other two as they were")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label_noise", type=float, default=0.0,
                    help="fraction of training labels flipped (validation and testing stay clean)")
    args = ap.parse_args(argv)
    counts = split_counts(args.n, args.test_n)
    write_corpus(args.out, counts, args.seed, args.label_noise)
    print(f"wrote {args.out}: " + ", ".join(f"{k}={2 * v}" for k, v in counts.items())
          + f"; Bayes-optimal accuracy {100 * bayes_accuracy():.2f}%"
          + (f"; train label noise {args.label_noise}" if args.label_noise else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
