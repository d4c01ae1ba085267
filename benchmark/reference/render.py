"""The reference's pixels of a rendered frame, for a sample of the frame
drawn from the seed.

Which path renders a scene decides which random numbers its pixels
draw, so the sample follows it: for the whole-frame render, whole tile
rows (a row's pool replays only whole); for the sorted wavefront, single
pixels, each with all its samples.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .camera import generator_rays, make_camera, packed
from .integrate import (
    CHUNK_SEED_STRIDE, TILE_ROWS, WAVEFRONT_MIN_TRIS, chunk_generator,
    pool_pixels, pool_rows, trace_lanes, wavefront_chunks,
)
from .tracer import build_scene


class Sample(NamedTuple):
    """The pixels compared: image rows and columns (n,), and the tile rows
    (whole-frame render) or pixel ids (wavefront) they come from."""
    rows: np.ndarray
    cols: np.ndarray
    tile_rows: np.ndarray
    pixel_ids: np.ndarray


def wavefront_path(inputs: dict) -> bool:
    return len(inputs["triangles"]["material"]) > WAVEFRONT_MIN_TRIS


def draw_sample(inputs: dict, width: int, height: int, rng,
                tile_rows: int, pixels: int) -> Sample:
    """``tile_rows`` distinct tile rows that hold image pixels (the
    whole-frame render), or ``pixels`` distinct pixels (the wavefront),
    drawn from ``rng``."""
    if wavefront_path(inputs):
        ids = np.sort(rng.choice(width * height, size=min(pixels, width
                                                          * height),
                                 replace=False))
        return Sample(ids // width, ids % width, np.zeros(0, np.int64), ids)
    tiles_x = -(-width // 128)
    n_rows = tiles_x * -(-height // TILE_ROWS) * TILE_ROWS
    rows = np.arange(n_rows)
    prow = (rows // TILE_ROWS // tiles_x) * TILE_ROWS + rows % TILE_ROWS
    valid = rows[prow < height]
    pick = np.sort(rng.choice(valid, size=min(tile_rows, valid.size),
                              replace=False))
    px = pool_pixels(pick, width, height)
    return Sample(px[:, 0], px[:, 1], pick, np.zeros(0, np.int64))


def render_sample(inputs: dict, camera: dict, sample: Sample, *, seed: int,
                  width: int, height: int, spp: int, max_depth: int,
                  device, dtype=torch.float32) -> np.ndarray:
    """The mean radiance (n, 3) float64 of the sample's pixels."""
    scene = build_scene(inputs, device, dtype)
    cam = make_camera(camera, device, dtype)
    if not wavefront_path(inputs):
        acc = pool_rows(scene, packed(cam), sample.tile_rows, seed=seed,
                        width=width, height=height, spp=spp,
                        max_depth=max_depth)
        lanes = pool_pixels(sample.tile_rows, width, height)[:, 2]
        sums = acc.reshape(3, -1)[:, torch.as_tensor(lanes, device=device)]
        return sums.T.float().cpu().numpy().astype(np.float64) / spp
    ppc, ids = wavefront_chunks(width, height, spp)
    where = np.empty(width * height, np.int64)
    where[ids[:width * height]] = np.arange(width * height)
    pos = where[sample.pixel_ids]
    out = np.zeros((len(pos), 3), np.float64)
    for g in np.unique(pos // ppc):
        chunk_ids = torch.as_tensor(ids[g * ppc:(g + 1) * ppc], device=device)
        lane_pix = chunk_ids.repeat_interleave(spp)
        o, d, tm = generator_rays(cam, chunk_generator(device, seed, int(g)),
                                  lane_pix, width, height)
        mine = np.nonzero(pos // ppc == g)[0]
        slot = pos[mine] % ppc
        lanes = torch.as_tensor((slot[:, None] * spp + np.arange(spp))
                                .reshape(-1), device=device)
        paths = trace_lanes(scene, o[lanes], d[lanes], tm[lanes], lanes,
                            seed + int(g) * CHUNK_SEED_STRIDE, max_depth)
        # Summed over each pixel's samples as (3, pixels, samples) rows.
        rad = paths.radiance.T.contiguous().reshape(3, len(mine), spp)
        sums = rad.sum(dim=2).T.float()
        out[mine] = sums.cpu().numpy().astype(np.float64) / spp
    return out
