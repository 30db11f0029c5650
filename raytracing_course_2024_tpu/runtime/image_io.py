"""Image output: binary PPM (P6) and PNG.

Reference: src/main.rs:75-95. One deliberate fix: the reference opens the PPM
with ``append(true)`` so reruns concatenate images into one file
(src/main.rs:62-66, flagged in SURVEY.md section 2.1); we truncate.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ppm(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) u8."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"255\n")
        f.write(np.ascontiguousarray(img).tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, dims, maxval separated by whitespace
    parts = []
    i = 0
    while len(parts) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":  # comment
            while data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        parts.append(data[i:j])
        i = j
    i += 1  # single whitespace after maxval
    assert parts[0] == b"P6", "only binary PPM supported"
    w, h = int(parts[1]), int(parts[2])
    return np.frombuffer(data, np.uint8, count=w * h * 3, offset=i).reshape(h, w, 3)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) u8 -> 8-bit RGB PNG (stdlib zlib, filter type 0)."""
    h, w, _ = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, 3 * w)],
        axis=1,
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG written by ``write_png`` (8-bit RGB, filter type 0)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not supported")
    return rows[:, 1:].reshape(h, w, 3)
