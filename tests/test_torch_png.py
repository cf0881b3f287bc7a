"""The port's PNG reader and writer (``ladine_tpu_torch/data/png.py``)
against Pillow, bit for bit, on the CPU, and the ImageFolder decode that
uses them against the JAX package's PIL path.

* Pillow's own PNGs (L, RGB, RGBA, random content with smooth rows, so its
  adaptive encoder picks several filters) read as Pillow reads them, and
  PNGs whose rows use each of the five filter types in turn.
* The port's PNGs read back by Pillow.
* Pillow's luma (``convert("L")``) on every RGB triple.
* ``imagefolder._load_image`` in ``grayscaled`` and RGB form: without
  Pillow, the PNG path (at the stored size) against the JAX package's PIL
  path, and another size raises the ImportError it raised before; with
  Pillow, PIL decodes every image, as before.
* ``load_split`` on a tree written by the JAX script
  ``scripts/make_synth_medical.py`` equals ``ladine_tpu.data.imagefolder``'s
  arrays, with Pillow blocked for the port.
* Out-of-scope PNGs (16-bit, palette, interlaced) and broken ones raise a
  ``ValueError`` naming the file.
"""

import importlib.util
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from ladine_tpu.data import imagefolder as jax_imagefolder
from ladine_tpu_torch.data import imagefolder, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"L": 1, "RGB": 3, "RGBA": 4}


def _content(rng, h, w, c):
    """Random pixels with ramps and repeated rows, so that Pillow's
    adaptive encoder picks more than one filter type."""
    a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    a[::3] = np.linspace(0, 255, w, dtype=np.uint8)[None, :, None]
    a[1::4] = a[0]
    a[:, ::5] = a[:, :1]
    return a


def _idat_filters(path):
    blob = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">II", data[:8])
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    w, h = header
    raw = zlib.decompress(idat)
    stride = len(raw) // h
    return {raw[y * stride] for y in range(h)}


def _filtered_png(a, path):
    """``a`` (H, W, C) as a PNG whose row y uses filter type y % 5."""
    h, w, c = a.shape
    x = a.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        kind, line = y % 5, x[y]
        up = x[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out += bytes([kind]) + ((line - pred) % 256).astype(np.uint8).tobytes()
    colour = {1: 0, 3: 2, 4: 6}[c]

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + chunk(b"tEXt", b"Comment\x00ancillary") + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


def _pil_pixels(path):
    a = np.asarray(Image.open(path))
    return a[..., None] if a.ndim == 2 else a


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reads_pillows_pngs_bit_for_bit(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    a = _content(rng, 41, 37, MODES[mode])
    path = str(tmp_path / "pil.png")
    Image.fromarray(a[..., 0] if mode == "L" else a, mode).save(path)
    assert len(_idat_filters(path)) >= 3
    assert np.array_equal(png.read(path), _pil_pixels(path))
    assert np.array_equal(png.read(path), a)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_undoes_all_five_filters_as_pillow_does(mode, tmp_path):
    a = np.random.default_rng(7).integers(0, 256, (23, 19, MODES[mode]), dtype=np.uint8)
    path = str(tmp_path / "filtered.png")
    _filtered_png(a, path)
    assert _idat_filters(path) == {0, 1, 2, 3, 4}
    assert np.array_equal(_pil_pixels(path), a)
    assert np.array_equal(png.read(path), a)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pillow_reads_the_ports_pngs(mode, tmp_path):
    a = np.random.default_rng(3).integers(0, 256, (17, 29, MODES[mode]), dtype=np.uint8)
    path = str(tmp_path / "port.png")
    png.write(a[..., 0] if mode == "L" else a, path)
    with Image.open(path) as im:
        assert im.mode == mode and im.size == (29, 17)
    assert np.array_equal(_pil_pixels(path), a)
    assert np.array_equal(png.read(path), a)


def test_luma_is_pillows_on_every_rgb_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    assert np.array_equal(png.to_grayscale_rgb(rgb), np.repeat(want[..., None], 3, -1))
    rgba = np.concatenate([rgb[:256], np.full((256, 4096, 1), 77, np.uint8)], -1)
    assert np.array_equal(png.to_grayscale_rgb(rgba)[..., 0], np.asarray(Image.fromarray(rgba).convert("L")))
    assert np.array_equal(png.to_rgb(rgba), rgb[:256])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("grayscale", [True, False], ids=["grayscaled", "rgb"])
def test_load_image_matches_the_pil_path(mode, grayscale, tmp_path, monkeypatch):
    a = _content(np.random.default_rng(11), 24, 24, MODES[mode])
    path = str(tmp_path / "img.png")
    Image.fromarray(a[..., 0] if mode == "L" else a, mode).save(path)
    want = jax_imagefolder._load_image(path, (24, 24), grayscale)
    monkeypatch.setitem(sys.modules, "PIL", None)  # the PNG path needs no Pillow
    got = imagefolder._load_image(path, (24, 24), grayscale)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ImportError):  # another size: PIL's resize, as before
        imagefolder._load_image(path, (16, 16), grayscale)
    monkeypatch.undo()
    assert np.array_equal(imagefolder._load_image(path, (16, 16), grayscale),
                          jax_imagefolder._load_image(path, (16, 16), grayscale))

    def no_png_reader(_):
        raise AssertionError("data/png.py read an image while Pillow imports")

    monkeypatch.setattr(png, "read", no_png_reader)  # where Pillow imports, it decodes every image
    assert np.array_equal(imagefolder._load_image(path, (24, 24), grayscale), want)


def test_load_split_on_the_jax_scripts_tree_matches_the_jax_package(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_make_synth", os.path.join(REPO, "scripts",
                                                                                  "make_synth_medical.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["make_synth_medical.py", "--out", str(tmp_path), "--n", "4", "--test_n", "3"])
    script.main()
    for split in ("train", "valid", "test"):
        want = jax_imagefolder.load_split(str(tmp_path), "ChestXRay", split)
        batches_want = list(want.batches(5))
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "PIL", None)
            got = imagefolder.load_split(str(tmp_path), "ChestXRay", split)
            batches_got = list(got.batches(5))
        assert got.classes == want.classes == ["NORMAL", "TUBERCULOSIS"] and len(got) == len(want)
        for (xg, yg), (xw, yw) in zip(batches_got, batches_want, strict=True):
            assert np.array_equal(xg, xw) and np.array_equal(yg, yw)


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


@pytest.mark.parametrize("case", ["16-bit", "palette", "interlaced", "crc", "truncated", "not-png"])
def test_out_of_scope_or_broken_pngs_raise_naming_the_file(case, tmp_path):
    path = str(tmp_path / f"{case}.png")
    if case == "16-bit":
        Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999).save(path)
    elif case == "palette":
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert("P").save(path)
    elif case == "interlaced":
        with open(path, "wb") as f:
            f.write(png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1))
                    + _chunk(b"IDAT", zlib.compress(b"\x00" * 60)) + _chunk(b"IEND", b""))
    else:
        png.write(np.zeros((8, 8, 3), np.uint8), path)
        blob = bytearray(open(path, "rb").read())
        if case == "crc":
            blob[40] ^= 1  # a byte of IDAT's data
        elif case == "truncated":
            blob = blob[:-20]
        else:
            blob[1] = ord("Q")
        open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match=path.replace(".", r"\.")):
        png.read(path)
    header = png.read_header(path)
    assert (header is None) == (case == "not-png")
    assert header is None or header.in_scope == (case not in ("16-bit", "palette", "interlaced"))
