"""Minimal PNG/PFM image IO (no external deps).

Port of merian_quake_tpu/utils/image.py (a copy: the port imports nothing
of the JAX package). Equivalent role to merian's Image Write node
(PNG/HDR dumps, default_config.json:436-462); PFM stands in for HDR float
dumps. A tensor is read back to the host once, at the call.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def save_png(path: str, img) -> None:
    """img: uint8 [H, W, 3|4] or float in [0,1] (converted)."""
    img = _host(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def load_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit, color types 2/6, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = ct = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ct, _, _, interlace = struct.unpack(">IIBBBBB", body)
            assert depth == 8 and ct in (2, 6) and interlace == 0
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    c = {2: 3, 6: 4}[ct]
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    for i in range(h):
        ft = raw[i * (stride + 1)]
        line = np.frombuffer(
            raw[i * (stride + 1) + 1 : (i + 1) * (stride + 1)], np.uint8
        ).copy()
        if ft == 0:
            pass
        elif ft == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ft == 1:  # sub
            for j in range(c, stride):
                line[j] = (int(line[j]) + int(line[j - c])) & 0xFF
        elif ft == 3:  # average
            for j in range(stride):
                left = int(line[j - c]) if j >= c else 0
                line[j] = (int(line[j]) + (left + int(prev[j])) // 2) & 0xFF
        elif ft == 4:  # paeth
            for j in range(stride):
                a = int(line[j - c]) if j >= c else 0
                b = int(prev[j])
                cc = int(prev[j - c]) if j >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[j] = (int(line[j]) + pr) & 0xFF
        else:
            raise ValueError(f"filter {ft}")
        out[i] = line
        prev = line
    return out.reshape(h, w, c)


def save_pfm(path: str, img) -> None:
    """HDR float dump (PF format, little-endian)."""
    img = np.asarray(_host(img), np.float32)[..., :3]
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(img[::-1].tobytes())


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1].copy()
