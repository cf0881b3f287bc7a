"""Dataset-name routing shared by every CLI entry point.

The port's own copy of ``ladine_tpu/data/router.py``: one router gives the
three stages the same name surface.

* ``...Atk{FGSM,...}``     -> pre-generated adversarial ImageFolder split
* MNIST_FAMILY names       -> local idx/npz files (downloads.py)
* anything else            -> ChestXRay-layout ImageFolder (imagefolder.py)
"""

from __future__ import annotations

from typing import Tuple

from ladine_tpu_torch.data.constants import IMAGE_SIZE
from ladine_tpu_torch.data.downloads import MNIST_FAMILY, load_mnist_family
from ladine_tpu_torch.data.imagefolder import load_attack_split, load_split


def open_dataset(
    name: str,
    root: str,
    split: str,
    preprocess: str = "grayscaled",
    image_size: Tuple[int, int] = IMAGE_SIZE,
):
    """Open one split of any dataset the framework knows by name."""
    if "Atk" in name:
        return load_attack_split(root, name.split("Atk")[1], image_size)
    if name in MNIST_FAMILY:
        # PathMNIST supports grayscaled|none (dataset.py:172-210); any
        # non-grayscale request maps to 'none' (RGB as-is). The 1-channel
        # corpora are always grayscale->3ch.
        pre = "grayscaled" if preprocess == "grayscaled" else "none"
        return load_mnist_family(
            name, root, split,
            preprocess=pre if name == "PathMNIST" else "grayscaled",
            image_size=image_size,
        )
    return load_split(root, name, split, preprocess=preprocess,
                      image_size=image_size)
