"""Dataset registry and pinned normalization constants.

The port's own copy of ``ladine_tpu/data/constants.py``: the channel means
and standard deviations of each training split, the calibrated
distance-softmax temperatures, and the dataset-name routing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGE_SIZE: Tuple[int, int] = (224, 224)

# channel means/stds computed on each training split (reference values)
NORM_STATS = {
    "ChestXRay": (
        np.array([0.5094, 0.5234, 0.5289], np.float32),
        np.array([0.2189, 0.2225, 0.2244], np.float32),
    ),
    "ISICSkinCancer": (
        np.array([0.7187, 0.5684, 0.5464], np.float32),
        np.array([0.1212, 0.1325, 0.1434], np.float32),
    ),
}

# calibrated distance-softmax temperatures (reference values)
CALIBRATED_TEMPERATURE = {
    "ChestXRay": 0.1737,
    "ISICSkinCancer": 0.3162,
}

ATTACK_NAMES = ("FGSM", "PGD", "BIM", "AUTOPGD", "CW")


def base_dataset(name: str) -> str:
    """Map variant names (XAtkFGSM, XValidate, ...) to the base dataset."""
    for base in ("ChestXRay", "ISICSkinCancer"):
        if name == base or name.startswith(base):
            return base
    raise ValueError(f"unknown dataset {name!r}")


def dataset_split_for(name: str) -> str:
    """Which split a dataset-name variant evaluates on: plain -> test,
    ``*Validate`` -> valid, ``*Atk*`` -> the pregenerated attack folder."""
    if "Atk" in name:
        return "attack"
    if name.endswith("Validate"):
        return "valid"
    return "test"
