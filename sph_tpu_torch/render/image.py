"""Frames as the host holds them: an [H, W, 3] uint8 array, written as a PNG
with zlib and struct alone (signature, IHDR, one IDAT, IEND), so the port
needs no imaging library. `Frame` stands where the JAX package returns a
PIL image: `np.asarray(frame)` gives its pixels and `frame.save(path)`
writes it."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def frame_bytes(img) -> np.ndarray:
    """An [H, W, 3] float image in [0, 1] (tensor on any device, or array)
    as host uint8: clip, ×255, truncate — the JAX package's conversion. The
    conversion runs where the image is, so only bytes cross to the host."""
    t = (img if isinstance(img, torch.Tensor)
         else torch.from_numpy(np.array(img, np.float32)))
    return (torch.clamp(t, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """PNG bytes of an [H, W, 3] uint8 array: 8-bit RGB, every scanline
    with filter 0 (none)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * 3)], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(arr: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def read_png(path: str) -> np.ndarray:
    """The [H, W, 3] uint8 pixels of a PNG this module wrote (8-bit RGB,
    not interlaced, filter 0 on every row); anything else is refused."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not 8-bit RGB without interlace: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()


class Frame:
    """A rendered frame on the host: [H, W, 3] uint8 pixels."""

    def __init__(self, pixels: np.ndarray):
        self.pixels = np.ascontiguousarray(pixels, dtype=np.uint8)

    def __array__(self, dtype=None, copy=None):
        if dtype is not None and np.dtype(dtype) != self.pixels.dtype:
            return self.pixels.astype(dtype)
        return self.pixels.copy() if copy else self.pixels

    def save(self, path: str) -> None:
        write_png(self.pixels, path)
