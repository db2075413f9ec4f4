"""Sample persistence: image grids as PNG files and decoded text as lines
(``mopoe_mimic_tpu/utils/save_samples.py``; the grid is
``mopoe_mimic_tpu/utils/plotting.py:22-32``'s ``_to_grid``).

The PNG is written with the standard library (``zlib`` and ``struct``):
8-bit grayscale or RGB, one IDAT chunk, filter type 0 on every scanline.
The JAX module needs PIL and saves ``.npy`` without it; the port needs
neither.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_grid(images: np.ndarray, per_row: int = 8) -> np.ndarray:
    """[N, H, W, C] → one [H', W', C] grid in [0, 1]."""
    n, h, w, c = images.shape
    per_row = min(per_row, n)
    rows = (n + per_row - 1) // per_row
    grid = np.zeros((rows * h, per_row * w, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, per_row)
        grid[r * h: (r + 1) * h, col * w: (col + 1) * w] = images[i]
    # untrained eval-mode BN can emit non-finite pixels early in training
    return np.clip(np.nan_to_num(grid), 0.0, 1.0)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(pixels: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, 1] (grayscale) or [H, W, 3] (RGB) → a PNG file."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, not {pixels.dtype}")
    if pixels.ndim == 3 and pixels.shape[-1] == 1:
        pixels = pixels[..., 0]
    if pixels.ndim == 2:
        color = 0
    elif pixels.ndim == 3 and pixels.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"PNG pixels of shape {pixels.shape}: not grayscale or RGB")
    h, w = pixels.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_samples_img_to_file(images: np.ndarray, fn: str, img_per_row: int = 8) -> None:
    """[N, H, W, C] floats in [0, 1], or uint8 in [0, 255] (the compact
    serving wire format) → one PNG grid."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    grid = _to_grid(images, per_row=img_per_row)
    Path(fn).parent.mkdir(parents=True, exist_ok=True)
    with open(fn, "wb") as f:
        f.write(png_bytes((grid * 255).astype(np.uint8)))


def write_samples_text_to_file(sentences: List[List[str]], fn: str) -> None:
    Path(fn).parent.mkdir(parents=True, exist_ok=True)
    with open(fn, "w") as f:
        for toks in sentences:
            f.write("".join(toks).rstrip("&") + "\n")
