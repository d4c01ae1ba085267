"""PPM (P3) image output with the reference's exact tone-map.

Matches ``write_color`` (reference src/render.cpp:11-20): per channel the
sample *mean* is gamma-2 corrected (sqrt), clamped to [0, 0.999], scaled
by 256 and truncated to int.  Image row 0 is the top scanline.  Output is
byte-identical to ``rtow_tpu.utils.ppm.write_ppm(use_native=False)``.
"""
from __future__ import annotations

import io
from typing import IO

import numpy as np


def tonemap(mean_image: np.ndarray) -> np.ndarray:
    """Mean radiance (H, W, 3) float -> (H, W, 3) uint8-range ints."""
    c = np.sqrt(np.maximum(np.asarray(mean_image, dtype=np.float64), 0.0))
    return (256.0 * np.clip(c, 0.0, 0.999)).astype(np.int32)


def write_ppm(out: IO[str], mean_image: np.ndarray) -> None:
    """Write a P3 ASCII PPM of the mean radiance image."""
    h, w, _ = mean_image.shape
    ints = tonemap(mean_image)
    buf = io.StringIO()
    buf.write(f"P3\n{w} {h}\n255\n")
    flat = ints.reshape(-1, 3)
    lines = "\n".join(f"{r} {g} {b}" for r, g, b in flat)
    buf.write(lines + "\n")
    out.write(buf.getvalue())


def read_ppm(inp: IO[str]) -> np.ndarray:
    """Parse a P3 PPM back to (H, W, 3) int array."""
    tokens: list[str] = []
    for line in inp:
        line = line.split("#", 1)[0]
        tokens.extend(line.split())
    if tokens[0] != "P3":
        raise ValueError(f"not a P3 ppm (magic={tokens[0]!r})")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval <= 0:
        raise ValueError("bad maxval")
    data = np.array(tokens[4 : 4 + 3 * w * h], dtype=np.int32)
    return data.reshape(h, w, 3)
