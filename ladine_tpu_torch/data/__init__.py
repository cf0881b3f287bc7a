"""Datasets on the host (numpy): ImageFolder trees, local MNIST-family
files, in-memory arrays, and the synthetic toys; ``open_dataset`` routes by
name."""

from ladine_tpu_torch.data.arrays import (
    ArrayDataset,
    compose,
    normalize,
    random_rotate,
    repeat_channels,
    resize_to,
)
from ladine_tpu_torch.data.constants import (
    ATTACK_NAMES,
    CALIBRATED_TEMPERATURE,
    IMAGE_SIZE,
    NORM_STATS,
    base_dataset,
    dataset_split_for,
)
from ladine_tpu_torch.data.downloads import (
    MNIST_FAMILY,
    load_idx_split,
    load_mnist_family,
    load_pathmnist_split,
    read_idx,
)
from ladine_tpu_torch.data.imagefolder import (
    ImageFolderDataset,
    compute_mean_std,
    load_attack_split,
    load_split,
)
from ladine_tpu_torch.data.router import open_dataset
from ladine_tpu_torch.data.synthetic import Gaussians, GaussianMixture1D, add_gaussian_noise

__all__ = [
    "ATTACK_NAMES", "ArrayDataset", "CALIBRATED_TEMPERATURE", "GaussianMixture1D", "Gaussians",
    "IMAGE_SIZE", "ImageFolderDataset", "MNIST_FAMILY", "NORM_STATS", "add_gaussian_noise",
    "base_dataset", "compose", "compute_mean_std", "dataset_split_for", "load_attack_split",
    "load_idx_split", "load_mnist_family", "load_pathmnist_split", "load_split", "normalize",
    "open_dataset", "random_rotate", "read_idx", "repeat_channels", "resize_to",
]
