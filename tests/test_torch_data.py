"""The port's data package (``ladine_tpu_torch/data/``) against the JAX
package's, on the same files and seeds.

Both are numpy on the host, so batches, shuffles, labels and indices are
held bit-equal; the resize (the same bilinear gathers on both sides) is
held to 1e-6 absolute. Files are written into ``tmp_path``: idx (plain and
gzipped), a medmnist ``pathmnist.npz``, and an ImageFolder tree of PNGs
(with PIL, which the port imports only to decode).
"""

import gzip
import struct

import numpy as np
import pytest

import ladine_tpu.data as J
import ladine_tpu_torch.data as T
from ladine_tpu.ops.corruptions import bilinear_resize as jax_resize

RESIZE_TOL = 1e-6


def write_idx(path, arr, gz=False):
    arr = np.asarray(arr, np.uint8)
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    with (gzip.open if gz else open)(path + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.tobytes())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("data_root")
    rng = np.random.default_rng(0)
    for family, gz in (("MNIST", True), ("FashionMNIST", False)):
        raw = root / family / "raw"
        raw.mkdir(parents=True)
        for stem, n in (("train", 24), ("t10k", 8)):
            write_idx(str(raw / f"{stem}-images-idx3-ubyte"), rng.integers(0, 255, (n, 28, 28)), gz=gz)
            write_idx(str(raw / f"{stem}-labels-idx1-ubyte"), rng.integers(0, 10, (n,)), gz=gz)
    z = {}
    for key, n in (("train", 12), ("val", 6), ("test", 6)):
        z[f"{key}_images"] = rng.integers(0, 255, (n, 28, 28, 3), dtype=np.uint8)
        z[f"{key}_labels"] = rng.integers(0, 9, (n, 1))
    np.savez(root / "pathmnist.npz", **z)
    for split in ("training", "validation", "testing", "Test_attacks_FGSM"):
        for cls_idx, cls in enumerate(["NORMAL", "TUBERCULOSIS"]):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(3):
                arr = rng.integers(0, 40, size=(20, 24, 3)) + cls_idx * 140
                Image.fromarray(arr.astype(np.uint8)).save(d / f"i{i}.png")
    return str(root)


def _batches(ds, **kw):
    return list(ds.batches(**kw))


def _assert_same_batches(got, want, tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if tol:
            np.testing.assert_allclose(g[0], w[0], rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(g[0], w[0])
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_constants_equal_jax():
    assert T.IMAGE_SIZE == J.IMAGE_SIZE and T.ATTACK_NAMES == J.ATTACK_NAMES
    assert T.CALIBRATED_TEMPERATURE == J.CALIBRATED_TEMPERATURE
    for k in J.NORM_STATS:
        for a, b in zip(T.NORM_STATS[k], J.NORM_STATS[k]):
            np.testing.assert_array_equal(a, b)
    for name in ("ChestXRay", "ChestXRayValidate", "ISICSkinCancerAtkPGD", "ISICSkinCancer"):
        assert T.base_dataset(name) == J.base_dataset(name)
        assert T.dataset_split_for(name) == J.dataset_split_for(name)
    with pytest.raises(ValueError):
        T.base_dataset("PathMNIST")


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_array_dataset_batches_equal_jax(shuffle, drop_last):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (23, 8, 8), dtype=np.uint8)
    labels = rng.integers(0, 3, 23)
    # a transform that draws: the rotation's angles come from the batches' own rng
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    tj = J.compose(J.repeat_channels(3), J.random_rotate(30.0), J.normalize(mean, std))
    tt = T.compose(T.repeat_channels(3), T.random_rotate(30.0), T.normalize(mean, std))
    dj, dt = J.ArrayDataset(images, labels, tj), T.ArrayDataset(images, labels, tt)
    assert len(dt) == len(dj) and dt.num_classes == dj.num_classes and dt.classes == dj.classes
    kw = dict(batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=7, with_indices=True)
    _assert_same_batches(_batches(dt, **kw), _batches(dj, **kw))


@pytest.mark.parametrize("shape,out", [((3, 28, 28, 3), (224, 224)), ((2, 16, 20, 3), (8, 6)),
                                       ((1, 7, 5, 1), (13, 17))])
def test_resize_to_matches_jax_bilinear(shape, out):
    batch = np.random.default_rng(2).random(shape, dtype=np.float32)
    got = T.resize_to(*out)(batch, None)
    want = np.asarray(jax_resize(batch, *out))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


def test_read_idx_plain_and_gzipped(root, tmp_path):
    arr = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    for gz in (False, True):
        p = str(tmp_path / f"a{int(gz)}-idx3-ubyte")
        write_idx(p, arr, gz=gz)
        np.testing.assert_array_equal(T.read_idx(p), arr)
        np.testing.assert_array_equal(T.read_idx(p), J.read_idx(p))
    with pytest.raises(FileNotFoundError, match="no network access"):
        T.read_idx(str(tmp_path / "missing"))


@pytest.mark.parametrize("name,split,pre", [
    ("MNIST", "train", "grayscaled"), ("MNIST", "valid", "grayscaled"), ("MNIST", "test", "grayscaled"),
    ("FashionMNIST", "train", "grayscaled"), ("RotatedMNIST", "valid", "grayscaled"),
    ("PathMNIST", "train", "grayscaled"), ("PathMNIST", "valid", "none"), ("PathMNIST", "test", "grayscaled"),
])
def test_mnist_family_equals_jax(root, name, split, pre):
    dt = T.load_mnist_family(name, root, split, preprocess=pre, image_size=(16, 16))
    dj = J.load_mnist_family(name, root, split, preprocess=pre, image_size=(16, 16))
    np.testing.assert_array_equal(dt.labels, dj.labels)
    kw = dict(batch_size=4, shuffle=True, seed=3, with_indices=True)
    _assert_same_batches(_batches(dt, **kw), _batches(dj, **kw), tol=RESIZE_TOL)
    imgs, labels = T.load_pathmnist_split(root, "test")
    assert imgs.shape == (6, 28, 28, 3) and labels.shape == (6,)


def test_pathmnist_missing_file_names_the_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="pathmnist.npz"):
        T.load_pathmnist_split(str(tmp_path), "train")


@pytest.mark.parametrize("pre", ["grayscaled", "standardized"])
def test_image_folder_equals_jax(root, pre):
    dt = T.load_split(root, "ChestXRay", "train", preprocess=pre, image_size=(16, 16))
    dj = J.load_split(root, "ChestXRay", "train", preprocess=pre, image_size=(16, 16))
    assert dt.classes == dj.classes == ["NORMAL", "TUBERCULOSIS"] and len(dt) == len(dj) == 6
    assert [p.split("data_root")[-1] for p in dt.paths] == [p.split("data_root")[-1] for p in dj.paths]
    kw = dict(batch_size=4, shuffle=True, seed=1, with_indices=True)
    _assert_same_batches(_batches(dt, **kw), _batches(dj, **kw))
    mt, st = T.compute_mean_std(dt)
    mj, sj = J.compute_mean_std(dj)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(st, sj)


def test_attack_split_and_routing_by_name(root):
    at = T.load_attack_split(root, "FGSM", (16, 16))
    aj = J.load_attack_split(root, "FGSM", (16, 16))
    np.testing.assert_array_equal(at.load_indices([0, 5]), aj.load_indices([0, 5]))
    for name, split, kind in (("ChestXRay", "valid", "ImageFolderDataset"),
                              ("ChestXRayAtkFGSM", "test", "ImageFolderDataset"),
                              ("MNIST", "train", "ArrayDataset"), ("PathMNIST", "test", "ArrayDataset")):
        dt = T.open_dataset(name, root, split, image_size=(16, 16))
        dj = J.open_dataset(name, root, split, image_size=(16, 16))
        assert type(dt).__name__ == type(dj).__name__ == kind
        assert type(dt).__module__.startswith("ladine_tpu_torch.")
        assert len(dt) == len(dj)
        np.testing.assert_allclose(dt.load_indices([0, 1]) if kind == "ImageFolderDataset"
                                   else next(dt.batches(2))[0],
                                   dj.load_indices([0, 1]) if kind == "ImageFolderDataset"
                                   else next(dj.batches(2))[0], rtol=0, atol=RESIZE_TOL)
