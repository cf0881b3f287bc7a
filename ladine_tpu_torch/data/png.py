"""A PNG writer and reader on ``zlib`` and numpy alone, for machines
without Pillow.

Scope: 8-bit, non-interlaced images of colour type 0 (L), 2 (RGB) and 6
(RGBA). The reader undoes all five scanline filters (Pillow's encoder
picks one a row), checks every chunk's CRC, skips ancillary chunks and
raises a ``ValueError`` that names the file on anything else. The writer
writes one IDAT of unfiltered rows (filter 0) at zlib level 6, Pillow's
default.

``to_rgb`` and ``to_grayscale_rgb`` give the pixels that Pillow's
``convert("RGB")`` and ``convert("L").convert("RGB")`` give, bit for bit:
Pillow's luma is ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``
(``libImaging/Convert.c``), alpha dropped.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


class Header(NamedTuple):
    width: int
    height: int
    bit_depth: int
    colour_type: int
    interlace: int

    @property
    def in_scope(self) -> bool:
        return self.bit_depth == 8 and self.colour_type in CHANNELS and self.interlace == 0


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode(arr: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1, 3, 4 -> the bytes of a PNG."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOUR_TYPE or 0 in arr.shape[:2]:
        raise ValueError(f"PNG pixels must be (H, W) or (H, W, 1|3|4), got shape {arr.shape}")
    h, w, c = arr.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = arr.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(arr: np.ndarray, path: str) -> None:
    """:func:`encode` ``arr`` into the file ``path``."""
    data = encode(arr)
    with open(path, "wb") as f:
        f.write(data)


def read_header(path: str) -> Optional[Header]:
    """The IHDR of the PNG file ``path``, or None if it does not start as
    a PNG does."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 33 or head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        return None
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", head[16:29])
    return Header(w, h, depth, colour, interlace)


def _unfilter(data: bytes, h: int, w: int, c: int, path: str) -> np.ndarray:
    stride = w * c
    if len(data) != h * (1 + stride):
        raise ValueError(f"{path}: {len(data)} bytes of image data, want {h * (1 + stride)}")
    rows = np.frombuffer(data, np.uint8).reshape(h, 1 + stride)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the first
    for y in range(h):
        kind, line, prior = rows[y, 0], rows[y, 1:], out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            out[y + 1] = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            out[y + 1] = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour's result
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                a = cur[i - c] if i >= c else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    ul = up[i - c] if i >= c else 0
                    p = a + b - ul
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - ul)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else ul)
                    cur[i] = (cur[i] + pred) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {kind} in row {y}")
    return out[1:].reshape(h, w, c)


def read(path: str) -> np.ndarray:
    """The pixels of the PNG file ``path``: (H, W, C) uint8, C = 1 (L), 3
    (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(blob):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        crc = blob[pos + 8 + length:pos + 12 + length]
        if len(data) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + data):
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{path}: PNG IHDR of {length} bytes")
            header = Header(*struct.unpack(">IIBBBBB", data)[:4], data[12])
            if not header.in_scope or data[10] or data[11]:
                raise ValueError(f"{path}: PNG of bit depth {header.bit_depth}, colour type "
                                 f"{header.colour_type}, interlace {header.interlace}; this reader takes 8-bit, "
                                 "non-interlaced L, RGB and RGBA")
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # a critical chunk other than IHDR, IDAT, IEND (PLTE among them)
            raise ValueError(f"{path}: PNG critical chunk {kind!r} is outside this reader's scope")
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    return _unfilter(data, header.height, header.width, CHANNELS[header.colour_type], path)


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3) as Pillow's ``convert("RGB")``."""
    if pixels.shape[-1] == 1:
        return np.repeat(pixels, 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def to_grayscale_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3) as Pillow's
    ``convert("L").convert("RGB")``."""
    if pixels.shape[-1] == 1:
        luma = pixels[..., 0]
    else:
        p = pixels.astype(np.uint32)
        luma = ((p[..., 0] * 19595 + p[..., 1] * 38470 + p[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
    return np.repeat(luma[..., None], 3, axis=-1)
