"""The reference's integrators: the paths of given lanes, and the
whole-frame render's work pool replayed for given tile rows.

Which numbers a lane draws is part of what a rendered image is, and the
port's three paths fix it differently:

* the gradient path and the sorted wavefront (meshes of more than
  16,384 triangles): one lane per (pixel, sample), camera rays from a
  ``torch.Generator``, bounce ``k`` of a lane salted with step ``k``
  (:func:`trace_lanes`);
* the whole-frame render (sphere scenes and smaller meshes): the work
  pool of each 128-pixel row of a 8 x 128 tile, every draw salted with
  the row's iteration count (:func:`pool_rows`).  Rows are independent,
  so a sample of rows replays exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .camera import counter_ray
from .rng import M32, lane_hash, step_salt
from .tracer import Scene, bounce

#: The whole-frame render's tile: 8 rows of 128 pixels.
TILE_ROWS, LANES = 8, 128
TILE = TILE_ROWS * LANES
#: Its work pool: items of ``POOL_CHUNK`` samples, handed out every
#: ``POOL_K`` iterations.
POOL_CHUNK, POOL_K = 16, 4
#: Meshes with more triangles than this take the sorted wavefront.
WAVEFRONT_MIN_TRIS = 16384
#: The sorted wavefront's chunks: ``RAYS_PER_BATCH // spp`` pixels, the
#: chunk's seed ``seed + chunk * CHUNK_SEED_STRIDE``.
RAYS_PER_BATCH = 1 << 18
CHUNK_SEED_STRIDE = 7919


class Paths(NamedTuple):
    """Lanes' radiance (L, 3); for each bounce, the material whose albedo
    scaled the lane's throughput there or -1 (L, max_depth + 1); the sky
    colour the lane's path ended in, or 0 (L, 3)."""
    radiance: torch.Tensor
    scaled: torch.Tensor
    sky: torch.Tensor


def trace_lanes(scene: Scene, origin, direction, time, lane_ids, seed: int,
                max_depth: int) -> Paths:
    """Each lane's path, bounce ``k`` salted with ``step_salt(seed, k)``
    and drawn from the lane's id (``lane_ids``, int64)."""
    dtype = origin.dtype
    n = lane_ids.numel()
    dev = origin.device
    one = torch.ones(n, dtype=dtype, device=dev)
    zero = torch.zeros(n, dtype=dtype, device=dev)
    state = [*origin.unbind(1), *direction.unbind(1), time, one, one, one,
             zero, zero, zero]
    lane = lane_hash(lane_ids.long())
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    scaled = torch.full((n, max_depth + 1), -1, dtype=torch.int64,
                        device=dev)
    sky = torch.zeros((n, 3), dtype=dtype, device=dev)
    live = torch.arange(n, device=dev)
    for it in range(max_depth + 1):
        if not live.numel():
            break
        new, can, new_depth, mat, s = bounce(
            scene, tuple(v[live] for v in state), lane[live],
            step_salt(seed, it), depth[live], max_depth)
        for j, v in enumerate(new):
            state[j] = state[j].index_put((live,), v)
        depth = depth.index_put((live,), new_depth)
        scaled[live, it] = mat
        sky[live] = sky[live] + s
        live = live[can]
    return Paths(torch.stack(state[10:13], dim=1), scaled, sky)


def wavefront_chunks(width: int, height: int, spp: int):
    """(pixels per chunk, the frame's pixel ids in chunk order, padded with
    the last pixel) of the sorted wavefront's frame: chunks of Morton
    (z-) ordered pixels."""
    n_pixels = width * height
    ppc = min(max(RAYS_PER_BATCH // spp, 1), n_pixels)
    ppc = max(ppc, -(-TILE // spp))
    n_chunks = -(-n_pixels // ppc)
    rows = np.arange(height, dtype=np.uint32)[:, None]
    cols = np.arange(width, dtype=np.uint32)[None, :]

    def spread(x):
        x = (x | (x << 8)) & np.uint32(0x00FF00FF)
        x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
        x = (x | (x << 2)) & np.uint32(0x33333333)
        return (x | (x << 1)) & np.uint32(0x55555555)

    order = np.argsort((spread(cols) | (spread(rows) << 1)).ravel())
    ids = np.full(n_chunks * ppc, n_pixels - 1, np.int64)
    ids[:n_pixels] = order
    return ppc, ids


def chunk_generator(device, seed: int, chunk: int) -> torch.Generator:
    """The camera rays' generator of a wavefront chunk."""
    return torch.Generator(device).manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | chunk)


# ---------------------------------------------------------------------------
# The whole-frame render's work pool.


def _flush(acc, rad, cur, take):
    """Adds each taking lane's radiance to its column's sum: the row's
    taking lanes at a column summed in lane order, then added."""
    rows = torch.nonzero(take.any(dim=1)).flatten()
    if not rows.numel():
        return
    cur_r, take_r = cur[rows], take[rows]
    lane = torch.arange(LANES, device=cur.device)
    before = ((cur_r[:, :, None] == cur_r[:, None, :]) & take_r[:, None, :]
              & (lane[None, None, :] < lane[None, :, None]))
    rank = torch.where(take_r, before.sum(dim=2), -1)
    s = torch.zeros((3,) + cur_r.shape, dtype=acc.dtype, device=cur.device)
    for k in range(int(rank.max()) + 1):
        r, i = torch.nonzero(rank == k, as_tuple=True)
        c = cur_r[r, i]
        s[:, r, c] = s[:, r, c] + rad[:, rows[r], i]
    acc[:, rows] = acc[:, rows] + s


def pool_rows(scene: Scene, cam: list, tile_rows, *, seed: int, width: int,
              height: int, spp: int, max_depth: int):
    """Radiance sums (3, R, 128) of the whole-frame render's tile rows
    ``tile_rows`` (R ints: tile * 8 + row within the tile).

    Each row's queue holds ``ceil(spp / POOL_CHUNK) * 128`` items, item i
    being column i % 128 with chunk i // 128's samples (none off the
    image); lane c starts on item c.  Every ``POOL_K`` iterations the
    lanes that are dead with no samples left flush their radiance and take
    the next items in lane order; then idle lanes with samples left start
    a camera ray through their column, and every live lane bounces.  The
    draws of iteration ``it`` are salted with ``step_salt(seed, it)``."""
    dev = scene.albedo.device
    dtype = scene.albedo.dtype
    rows_t = torch.as_tensor(np.asarray(tile_rows, np.int64), device=dev)
    n_rows = rows_t.numel()
    tiles_x = -(-width // LANES)
    pid = rows_t // TILE_ROWS
    prow = (pid // tiles_x) * TILE_ROWS + rows_t % TILE_ROWS
    pcol0 = (pid % tiles_x) * LANES
    col = torch.arange(LANES, device=dev, dtype=torch.int64).expand(
        n_rows, LANES)
    lane = lane_hash(((pid * TILE)[:, None] + (rows_t % TILE_ROWS)[:, None]
                      * LANES + col) & M32).flatten()
    row_ok = (prow < height)[:, None]
    n_items = -(-spp // POOL_CHUNK) * LANES

    def budget(c, chunk):
        ok = row_ok & (pcol0[:, None] + c < width)
        left = torch.as_tensor(spp - chunk * POOL_CHUNK, device=dev)
        left = left.clamp(0, POOL_CHUNK)
        return torch.where(ok, left, 0)

    inv_w = float(np.float32(1.0) / np.float32(width - 1))
    inv_h = float(np.float32(1.0) / np.float32(height - 1))
    frow = (height - 1 - prow).to(dtype).repeat_interleave(LANES)
    pcol_lane = pcol0.repeat_interleave(LANES)
    n = n_rows * LANES
    zeros = torch.zeros(n, dtype=dtype, device=dev)
    state = [zeros.clone() for _ in range(13)]
    state[3] = state[3] + 1.0
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    rem = budget(col, 0).flatten()
    cur = col.flatten().clone()
    nxt = torch.full((n_rows,), LANES, dtype=torch.int64, device=dev)
    acc = torch.zeros((3, n_rows, LANES), dtype=dtype, device=dev)

    def radiance():
        return torch.stack(state[10:13]).view(3, n_rows, LANES)

    it = 0
    while True:
        busy = (alive | (rem > 0)).view(n_rows, LANES).any(dim=1)
        if not bool((busy | (nxt < n_items)).any()):
            break
        salt = step_salt(seed, it)
        if it % POOL_K == 0:
            done = (~alive & (rem == 0)).view(n_rows, LANES)
            off = torch.cumsum(done, dim=1) - done.long()
            item = nxt[:, None] + off
            take = done & (item < n_items)
            _flush(acc, radiance(), cur.view(n_rows, LANES), take)
            flat = take.flatten()
            for ch in (10, 11, 12):
                state[ch] = torch.where(flat, 0.0, state[ch])
            new_col = item % LANES
            cur = torch.where(flat, new_col.flatten(), cur)
            rem = torch.where(flat, budget(new_col, item // LANES).flatten(),
                              rem)
            nxt = nxt + take.sum(dim=1)
        need = ~alive & (rem > 0)
        sub = torch.nonzero(need).flatten()
        if sub.numel():
            fcol = (pcol_lane[sub] + cur[sub]).to(dtype)
            ray = counter_ray(cam, lane[sub], salt, fcol, frow[sub], inv_w,
                              inv_h, dtype)
            for j, v in enumerate(ray):
                state[j] = state[j].index_put((sub,), v.to(dtype))
            for j in (7, 8, 9):
                state[j] = state[j].index_put(
                    (sub,), torch.ones_like(sub, dtype=dtype))
            depth = depth.index_put((sub,), torch.zeros_like(
                sub, dtype=torch.int32))
            rem = rem - need.to(rem.dtype)
        live = torch.nonzero(alive | need).flatten()
        if live.numel():
            new, can, new_depth, _, _ = bounce(
                scene, tuple(v[live] for v in state), lane[live], salt,
                depth[live], max_depth)
            for j, v in enumerate(new):
                state[j] = state[j].index_put((live,), v)
            alive = alive.index_put((live,), can)
            depth = depth.index_put((live,), new_depth)
        it += 1
    _flush(acc, radiance(), cur.view(n_rows, LANES),
           torch.ones((n_rows, LANES), dtype=torch.bool, device=dev))
    return acc


def pool_pixels(tile_rows, width: int, height: int):
    """(image row, image column, lane) of every in-image pixel of tile
    rows ``tile_rows``, lane indexing the (R * 128) flattened row lanes."""
    tiles_x = -(-width // LANES)
    out = []
    for i, r in enumerate(tile_rows):
        pid = r // TILE_ROWS
        prow = (pid // tiles_x) * TILE_ROWS + r % TILE_ROWS
        pcol0 = (pid % tiles_x) * LANES
        if prow >= height:
            continue
        for c in range(min(LANES, width - pcol0)):
            out.append((prow, pcol0 + c, i * LANES + c))
    return np.asarray(out, np.int64).reshape(-1, 3)
