"""scikit-learn's bundled handwritten digits as an MNIST-layout IDX tree:
the corpus of the port's real-data run (``examples/run_digits.py``).

The port's own copy of ``scripts/make_digits_corpus.py``, byte for byte
the same files. ``load_digits`` ships inside scikit-learn: 1,797 scanned
handwritten digits (the UCI "Optical Recognition of Handwritten Digits"
set; 8x8, 17 gray levels, 10 classes), so nothing is downloaded. The gray
levels are scaled to 0..255, and a seeded 80/20 class-stratified split
writes train to ``train-*`` and test to ``t10k-*`` under
``{out}/MNIST/raw/``, which ``data/downloads.py`` reads (plain or
gzipped); its 'valid' split is a fixed 90/10 carve of train.

The gzipped tree is committed under ``examples/data/digits`` (the machine
with the card has no scikit-learn), written by

    python -m ladine_tpu_torch.examples.make_digits_corpus \\
        --out ladine_tpu_torch/examples/data/digits --gzip
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import sys

import numpy as np

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "digits")
FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte", "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def idx_bytes(arr: np.ndarray) -> bytes:
    """One uint8 IDX file: magic 0x0803 (images) or 0x0801 (labels), the
    big-endian dimensions, then the bytes."""
    head = struct.pack(">I", 0x00000800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    return head + arr.astype(np.uint8).tobytes()


def split(labels: np.ndarray, seed: int = 0, test_frac: float = 0.2) -> np.ndarray:
    """The test mask: for each class in turn, a seeded permutation of its
    members, of which the first ``int(n * test_frac)`` (at least one)."""
    rng = np.random.default_rng(seed)
    test_idx = []
    for c in range(10):
        members = np.flatnonzero(labels == c)
        members = members[rng.permutation(len(members))]
        test_idx.extend(members[: max(1, int(len(members) * test_frac))])
    mask = np.zeros(len(labels), bool)
    mask[np.asarray(test_idx)] = True
    return mask


def corpus_files(images: np.ndarray, labels: np.ndarray, test: np.ndarray) -> dict:
    """{file name: IDX bytes} of the four files, ``test`` the test mask."""
    arrays = (images[~test], labels[~test], images[test], labels[test])
    return {name: idx_bytes(a) for name, a in zip(FILES, arrays)}


def write(out: str, files: dict, gzipped: bool = False) -> str:
    """Writes ``files`` under ``{out}/MNIST/raw``; gzipped with no name
    and no time in the header, so the same bytes give the same file."""
    raw = os.path.join(out, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    for name, data in files.items():
        if gzipped:
            with open(os.path.join(raw, name + ".gz"), "wb") as f, \
                    gzip.GzipFile(filename="", mode="wb", fileobj=f, mtime=0) as z:
                z.write(data)
        else:
            with open(os.path.join(raw, name), "wb") as f:
                f.write(data)
    return raw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--test_frac", type=float, default=0.2)
    ap.add_argument("--gzip", action="store_true", help="write *-ubyte.gz")
    args = ap.parse_args(argv)
    from sklearn.datasets import load_digits

    d = load_digits()
    images = np.round(d.images / 16.0 * 255.0).astype(np.uint8)  # 0..16 gray levels -> 0..255
    labels = d.target.astype(np.uint8)
    test = split(labels, args.seed, args.test_frac)
    raw = write(args.out, corpus_files(images, labels, test), args.gzip)
    print(f"wrote {raw}: train={int((~test).sum())} test={int(test.sum())} (8x8, 10 classes, real scanned digits)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
