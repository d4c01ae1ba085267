"""The persistent whole-frame megakernel (K1) and its plain PyTorch
version (the port of ``rtow_tpu/ops/pallas_megakernel.py``'s ``_kernel``
with both its schedulers).

``render_blocks`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/megakernel.cu``, on a CPU tensor it runs
``render_blocks_reference``, and on anything else it raises.  Both
compute what the Pallas kernel ``_kernel`` computes, under the scheduler
that the ``pool`` argument names.  Under the drain-balanced work pool
(``pool=True``, the default and the JAX package's production scheduler,
:1492-1615) each image row's 128 pixels x ``spp`` samples form a queue
of (column, ``pool_chunk``-sample) items that the row's idle lanes take
every ``pool_k`` iterations, flushing their radiance into per-pixel
sums.  Under the classic scheduler (``pool=False``) every lane of an
8x128-pixel tile owns one pixel and loops until that pixel has ``spp``
samples.  Either way a lane loops: regenerate a thin-lens, time-jittered
camera ray when idle, then advance one bounce (``ops/bounce.py``: the
sphere sweep, then the flat triangle sweep for meshes of up to 16,384
triangles; Lambertian / metal / dielectric scatter, sky or flat
background on a miss; with the scene's lit features, :class:`Lit`).
Outputs are per-pixel radiance SUMS in the kernel's block layout: three
(n_tiles * 8, 128) float32 planes.

Random numbers are the JAX kernel's stateless counter hash, bit for bit
(``utils/rng.py``): lane id ``pix = tile * 1024 + row * 128 + col``,
salt ``mix(seed + it * 40503)``, draw ``mix(lane ^ (salt + draw *
0x9E3779B9))``.  Under the classic scheduler a lane takes exactly one
step per iteration of its tile's loop until it is done, so ``it`` is the
lane's own step count and a per-lane loop replays the JAX kernel's
stream exactly.  Under the pool ``it`` is the row's iteration count,
which idle lanes advance too: rows are independent (each has its own
queue), so a per-row loop replays the stream exactly.

Each lane slab-tests a triangle block's box before it sweeps the block,
and each sphere group's box (``tables.sphere_groups``,
``bounce.nearest_sphere_culled``); the TPU culls per tile.  A culled
block or group holds nothing the ray can hit, so the winner does not
change.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.rng import M32, hash_uniform, lane_hash, step_salt
from . import _cuda
from .bounce import bounce_lanes
from .lights import LIGHT_COLS, TWO_PI
from .tables import (
    LANES, TILE, TILE_ROWS, Lit, TriTable, background_args, camera_shutter,
    check_counter, check_lit, check_table, check_tris, k1_tables, lit_args,
    lit_rows, n_tiles_for, pack_camera, pack_meta, scene_lit, sphere_groups,
)

#: Shared memory the pool's instances stage beside the tables: each lane's
#: column and radiance (16 B), then a take mask and a count per warp, for
#: the block's 256 threads (``PoolStage`` in ``csrc/megakernel.cu``).
POOL_STAGE_BYTES = 256 * 16 + 8 * 4 * 2

_F32 = torch.float32


def render_blocks_reference(
    tbl: torch.Tensor,
    cam: torch.Tensor,
    meta: Tuple[int, ...],
    n_tiles: int,
    *,
    background: Union[str, tuple] = "sky",
    steps: Optional[torch.Tensor] = None,
    tris: Optional[TriTable] = None,
    tests: Optional[torch.Tensor] = None,
    lit: Lit = Lit(),
    shadows: Optional[torch.Tensor] = None,
    cull: bool = True,
    pool: bool = True,
    pool_chunk: int = 16,
    pool_k: int = 4,
    slots: Optional[torch.Tensor] = None,
    spheres: Optional[torch.Tensor] = None,
    progress: Optional["ProgressCounter"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the megakernel, on ``tbl``'s device.

    The classic scheduler runs the per-lane loop vectorised over a chunk
    of lanes at a time, dropping lanes as they finish; the pool runs the
    per-row loop vectorised over every row (:func:`_trace_pool`).  Both
    sweep the spheres group by group, as the kernel does
    (``bounce.nearest_sphere_culled``).  Same inputs and outputs as
    :func:`render_blocks`; ``progress`` gets every tile row at the end."""
    seed, width, height, _n_pixels, tile0, spp, max_depth = meta
    dev = tbl.device
    cam_f = [float(x) for x in cam.detach().cpu()]
    groups = sphere_groups(tbl, (cam_f[19], cam_f[19] + cam_f[20]))
    # box tests, triangle tests, shadow rays, sphere-group box tests,
    # sphere rows swept
    tally = [0, 0, 0, 0, 0]
    kw = dict(seed=seed, width=width, height=height, spp=spp,
              max_depth=max_depth, background=background, tris=tris,
              tally=tally, lit=lit, cull=cull, groups=groups)
    if pool:
        out, n_steps, n_slots = _trace_pool(tbl, cam_f, n_tiles, tile0,
                                            pool_chunk, pool_k, **kw)
    else:
        out, n_steps, n_slots = _trace_classic(tbl, cam_f, n_tiles, tile0,
                                               **kw)
    if steps is not None:
        steps += n_steps
    if slots is not None:
        slots += n_slots
    if tests is not None:
        tests += torch.tensor(tally[:2], device=dev)
    if shadows is not None:
        shadows += tally[2]
    if spheres is not None:
        spheres += torch.tensor(tally[3:], device=dev)
    if progress is not None:
        progress.add(n_tiles * TILE_ROWS)
    planes = out.view(3, n_tiles * TILE_ROWS, LANES)
    return planes[0], planes[1], planes[2]


def _trace_classic(tbl, cam, n_tiles, tile0, *, seed, width, height, spp,
                   max_depth, background, tris, tally, lit, cull, groups):
    """The classic scheduler: (radiance sums (3, n_tiles * 1024), ray
    steps, lane slots = 32 x each warp's longest loop)."""
    dev = tbl.device
    n_lanes = n_tiles * TILE
    out = torch.zeros((3, n_lanes), dtype=_F32, device=dev)
    its = torch.zeros(n_lanes, dtype=torch.int64, device=dev)

    g = torch.arange(n_lanes, device=dev, dtype=torch.int64)
    tiles_x = -(-width // LANES)
    pid = tile0 + g // TILE
    row = (g % TILE) // LANES
    col = g % LANES
    prow = (pid // tiles_x) * TILE_ROWS + row
    pcol = (pid % tiles_x) * LANES + col
    in_img = (prow < height) & (pcol < width)
    pix = (pid * TILE + row * LANES + col) & M32
    lanes = torch.nonzero(in_img).flatten() if spp > 0 else g[:0]
    # Lanes per chunk: the pair temporaries are (chunk, 128) float32, so
    # 2**20 lanes take about 0.5 GB each on the card.
    chunk = 1 << 20 if dev.type == "cuda" else 1 << 16
    n_steps = 0
    for start in range(0, lanes.numel(), chunk):
        idx = lanes[start:start + chunk]
        out[:, idx], its[idx], n = _trace_lanes(
            tbl, cam, pix[idx], prow[idx], pcol[idx], seed=seed,
            width=width, height=height, spp=spp, max_depth=max_depth,
            background=background, tris=tris, tally=tally, lit=lit,
            cull=cull, groups=groups)
        n_steps += n
    n_slots = 32 * int(its.view(-1, 32).amax(dim=1).sum())
    return out, n_steps, n_slots


def _trace_lanes(tbl, cam, pix, prow, pcol, *, seed, width, height, spp,
                 max_depth, background, tris, tally, lit, cull, groups):
    """(radiance sums (3, L) of lanes ``pix`` after ``spp`` samples, each
    lane's step count, ray steps taken)."""
    dev = tbl.device
    n = pix.numel()
    out = torch.zeros((3, n), dtype=_F32, device=dev)
    its = torch.zeros(n, dtype=torch.int64, device=dev)
    inv_w = float(np.float32(1.0) / np.float32(width - 1))
    inv_h = float(np.float32(1.0) / np.float32(height - 1))

    # Lane state, compacted to the unfinished lanes after every step;
    # ``idx`` maps it back to the lane's slot in ``out``.  ``code`` is
    # the alive code: 0 dead, 1 alive, 2 alive after a diffuse scatter
    # (which only next-event estimation tells apart).
    idx = torch.arange(n, device=dev)
    lane = lane_hash(pix)
    fcol = pcol.to(_F32)
    frow = (height - 1 - prow).to(_F32)
    zeros = torch.zeros(n, dtype=_F32, device=dev)
    ox = oy = oz = dy = dz = tm = tpr = tpg = tpb = rr = rg = rb = zeros
    dx = zeros + 1.0
    code = torch.zeros(n, dtype=torch.int32, device=dev)
    bounce = torch.zeros(n, dtype=torch.int32, device=dev)
    started = torch.zeros(n, dtype=torch.int32, device=dev)

    it = steps = 0
    while idx.numel():
        salt = step_salt(seed, it)
        # ---- regeneration: idle lanes (all have samples left) -------
        need = code == 0
        nox, noy, noz, ndx, ndy, ndz, ntm = camera_ray(
            cam, lane, salt, fcol, frow, inv_w, inv_h)
        ox = torch.where(need, nox, ox)
        oy = torch.where(need, noy, oy)
        oz = torch.where(need, noz, oz)
        dx = torch.where(need, ndx, dx)
        dy = torch.where(need, ndy, dy)
        dz = torch.where(need, ndz, dz)
        tm = torch.where(need, ntm, tm)
        tpr = torch.where(need, 1.0, tpr)
        tpg = torch.where(need, 1.0, tpg)
        tpb = torch.where(need, 1.0, tpb)
        bounce = torch.where(need, 0, bounce)
        started = started + need.to(torch.int32)
        # A regenerated lane starts a camera path: no diffuse flag.
        from_diffuse = (code > 1) & ~need if lit.nee_kinds else None

        # ---- one bounce for every lane (all are alive now) ----------
        state, code, bounce = bounce_lanes(
            tbl, tris, (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg,
                        rb), lane, salt, bounce, max_depth, background,
            lit=lit, from_diffuse=from_diffuse, tally=tally, cull=cull,
            groups=groups)
        (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
        code = code.to(torch.int32)
        it += 1
        steps += idx.numel()

        done = (code == 0) & (started == spp)
        if bool(done.any()):
            out[:, idx[done]] = torch.stack([rr[done], rg[done], rb[done]])
            its[idx[done]] = it
            keep = ~done
            idx, lane, fcol, frow = idx[keep], lane[keep], fcol[keep], frow[keep]
            ox, oy, oz, dx, dy, dz, tm = (
                v[keep] for v in (ox, oy, oz, dx, dy, dz, tm))
            tpr, tpg, tpb, rr, rg, rb = (
                v[keep] for v in (tpr, tpg, tpb, rr, rg, rb))
            code, bounce, started = code[keep], bounce[keep], started[keep]
    return out, its, steps


def camera_ray(cam, lane, salt, fcol, frow, inv_w, inv_h):
    """A thin-lens, time-jittered camera ray through pixel column ``fcol``
    and flipped row ``frow`` (the kernel's regeneration, :1618-1639):
    origin xyz, direction xyz, time."""
    (cox, coy, coz, cux, cuy, cuz, cvx, cvy, cvz, llx, lly, llz,
     chx, chy, chz, cwx, cwy, cwz, lens_r, t0, dt) = cam
    s = (fcol + hash_uniform(lane, salt, 0)) * inv_w
    t = (frow + hash_uniform(lane, salt, 1)) * inv_h
    rad_l = lens_r * torch.sqrt(hash_uniform(lane, salt, 2))
    th = TWO_PI * hash_uniform(lane, salt, 3)
    lx = rad_l * torch.cos(th)
    ly = rad_l * torch.sin(th)
    nox = cox + lx * cux + ly * cvx
    noy = coy + lx * cuy + ly * cvy
    noz = coz + lx * cuz + ly * cvz
    return (nox, noy, noz, llx + s * chx + t * cwx - nox,
            lly + s * chy + t * cwy - noy, llz + s * chz + t * cwz - noz,
            t0 + hash_uniform(lane, salt, 4) * dt)


def _pool_flush(acc, rad, cur, take):
    """Adds each taking lane's radiance to its pixel's sum, in place:
    ``acc`` and ``rad`` (3, R, 128), ``cur`` (R, 128) the lanes' columns,
    ``take`` (R, 128) which lanes flush.  Column c of row r gets the
    radiance of the row's taking lanes at c summed in lane order from 0,
    then added to ``acc`` -- the order ``csrc/megakernel.cu`` sums in (the
    JAX kernel's ``acc + ch @ onehot``, :1584-1596)."""
    rows = torch.nonzero(take.any(dim=1)).flatten()
    if not rows.numel():
        return
    cur_r, take_r = cur[rows], take[rows]
    lane = torch.arange(LANES, device=cur.device)
    # rank[r, i]: the taking lanes before lane i at lane i's column.
    before = ((cur_r[:, :, None] == cur_r[:, None, :]) & take_r[:, None, :]
              & (lane[None, None, :] < lane[None, :, None]))
    rank = torch.where(take_r, before.sum(dim=2), -1)
    s = torch.zeros((3,) + cur_r.shape, dtype=_F32, device=cur.device)
    for k in range(int(rank.max()) + 1):
        r, i = torch.nonzero(rank == k, as_tuple=True)
        c = cur_r[r, i]
        s[:, r, c] = s[:, r, c] + rad[:, rows[r], i]
    acc[:, rows] = acc[:, rows] + s


def _trace_pool(tbl, cam, n_tiles, tile0, pool_chunk, pool_k, *, seed, width,
                height, spp, max_depth, background, tris, tally, lit, cull,
                groups):
    """The work pool (``_kernel`` with ``RTOW_POOL=1``, :1492-1615,
    :1689-1726), one loop over all rows at once: (radiance sums (3,
    n_tiles * 1024), ray steps, lane slots = 128 x each row's
    iterations).

    Row r's queue holds ``ceil(spp / chunk) * 128`` items; item i is
    column i % 128, chunk i // 128, with ``clip(spp - chunk * chunk_size,
    0, chunk_size)`` samples (none off the image).  Lane c starts on item
    c; the row's counter starts at 128.  At every iteration ``it`` with
    ``it % k == 0`` the lanes that are dead with no samples left take the
    next items in lane order (an exclusive prefix sum), flushing their
    radiance into their current column's sum first.  Then idle lanes
    with samples left regenerate a camera ray through their current
    column, and every live lane advances one bounce.  A row runs while a
    lane is alive or has samples left or its queue is not drained; a
    final flush adds every lane's radiance."""
    dev = tbl.device
    n_rows = n_tiles * TILE_ROWS
    rows = torch.arange(n_rows, device=dev, dtype=torch.int64)
    tiles_x = -(-width // LANES)
    pid = tile0 + rows // TILE_ROWS
    prow = (pid // tiles_x) * TILE_ROWS + rows % TILE_ROWS
    pcol0 = (pid % tiles_x) * LANES
    col = torch.arange(LANES, device=dev, dtype=torch.int64).expand(
        n_rows, LANES)
    lane = lane_hash(((pid * TILE)[:, None] + (rows % TILE_ROWS)[:, None]
                      * LANES + col) & M32).flatten()
    row_ok = (prow < height)[:, None]
    n_items = -(-spp // pool_chunk) * LANES

    def budget(c, chunk):
        ok = row_ok & (pcol0[:, None] + c < width)
        left = torch.as_tensor(spp - chunk * pool_chunk, device=dev)
        return torch.where(ok, left.clamp(0, pool_chunk), 0)

    inv_w = float(np.float32(1.0) / np.float32(width - 1))
    inv_h = float(np.float32(1.0) / np.float32(height - 1))
    frow = (height - 1 - prow).to(_F32).repeat_interleave(LANES)
    pcol_lane = pcol0.repeat_interleave(LANES)
    n = n_rows * LANES
    zeros = torch.zeros(n, dtype=_F32, device=dev)
    # state: ox oy oz dx dy dz tm tpr tpg tpb rr rg rb, per lane.
    state = [zeros.clone() for _ in range(13)]
    state[3] += 1.0
    code = torch.zeros(n, dtype=torch.int32, device=dev)
    bounce = torch.zeros(n, dtype=torch.int32, device=dev)
    rem = budget(col, 0).flatten()
    cur = col.flatten().clone()
    nxt = torch.full((n_rows,), LANES, dtype=torch.int64, device=dev)
    acc = torch.zeros((3, n_rows, LANES), dtype=_F32, device=dev)
    row_its = torch.zeros(n_rows, dtype=torch.int64, device=dev)

    def radiance():
        return torch.stack(state[10:13]).view(3, n_rows, LANES)

    it = steps = 0
    while True:
        busy = ((code != 0) | (rem > 0)).view(n_rows, LANES).any(dim=1)
        going = busy | (nxt < n_items)
        if not bool(going.any()):
            break
        row_its += going
        salt = step_salt(seed, it)
        if it % pool_k == 0:
            # ---- hand-out: idle lanes take items, flushing first --------
            done = ((code == 0) & (rem == 0)).view(n_rows, LANES)
            off = torch.cumsum(done, dim=1) - done.long()
            item = nxt[:, None] + off
            take = done & (item < n_items)
            _pool_flush(acc, radiance(), cur.view(n_rows, LANES), take)
            flat = take.flatten()
            for ch in (10, 11, 12):
                state[ch] = torch.where(flat, 0.0, state[ch])
            new_col = item % LANES
            cur = torch.where(flat, new_col.flatten(), cur)
            rem = torch.where(flat, budget(new_col, item // LANES).flatten(),
                              rem)
            nxt = nxt + take.sum(dim=1)
        # ---- regeneration through the lane's current column -------------
        need = (code == 0) & (rem > 0)
        sub = torch.nonzero(need).flatten()
        if sub.numel():
            fcol = (pcol_lane[sub] + cur[sub]).to(_F32)
            ray = camera_ray(cam, lane[sub], salt, fcol, frow[sub], inv_w,
                             inv_h)
            for j, v in enumerate(ray):
                state[j] = state[j].index_put((sub,), v)
            for j in (7, 8, 9):
                state[j] = state[j].index_put(
                    (sub,), torch.ones_like(sub, dtype=_F32))
            bounce = bounce.index_put((sub,), torch.zeros_like(
                sub, dtype=torch.int32))
            rem = rem - need.to(rem.dtype)
        # ---- one bounce of the live lanes -------------------------------
        live = torch.nonzero((code != 0) | need).flatten()
        if live.numel():
            from_diffuse = ((code[live] > 1) & ~need[live]
                            if lit.nee_kinds else None)
            new, new_code, new_bounce = bounce_lanes(
                tbl, tris, tuple(v[live] for v in state), lane[live], salt,
                bounce[live], max_depth, background, lit=lit,
                from_diffuse=from_diffuse, tally=tally, cull=cull,
                groups=groups)
            for j, v in enumerate(new):
                state[j] = state[j].index_put((live,), v)
            code = code.index_put((live,), new_code.to(torch.int32))
            bounce = bounce.index_put((live,), new_bounce.to(torch.int32))
        steps += live.numel()
        it += 1
    _pool_flush(acc, radiance(), cur.view(n_rows, LANES),
               torch.ones((n_rows, LANES), dtype=torch.bool, device=dev))
    return acc.view(3, -1), steps, LANES * int(row_its.sum())


def render_blocks(
    tbl: torch.Tensor,
    cam: torch.Tensor,
    meta: Tuple[int, ...],
    n_tiles: int,
    *,
    background: Union[str, tuple] = "sky",
    steps: Optional[torch.Tensor] = None,
    tris: Optional[TriTable] = None,
    tests: Optional[torch.Tensor] = None,
    lit: Lit = Lit(),
    shadows: Optional[torch.Tensor] = None,
    cull: bool = True,
    pool: bool = True,
    pool_chunk: int = 16,
    pool_k: int = 4,
    slots: Optional[torch.Tensor] = None,
    spheres: Optional[torch.Tensor] = None,
    progress: Optional["ProgressCounter"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radiance sums of tiles ``tile0 .. tile0 + n_tiles - 1`` as three
    (n_tiles * 8, 128) float32 planes (``render_blocks_pallas``, :2004).

    ``tbl``, ``tris``: the sphere table and the triangle table or None
    (swept flat, block by block) from ``tables.k1_tables``; ``cam``:
    (21,) vector from ``tables.pack_camera``; ``meta``: the scalars from
    ``tables.pack_meta``.  A CUDA ``tbl`` launches the CUDA kernel (and
    counts the launch in ``render_blocks.launches``); a CPU ``tbl`` runs
    :func:`render_blocks_reference`; any other device raises.  Stats
    counters, int64 on ``tbl``'s device: ``steps`` (1,) gets the ray
    steps (bounces) of the render added to it, ``tests`` (2,) the block
    box tests and the triangle tests (the shadow sweeps' included),
    ``shadows`` (1,) the NEE shadow rays.  ``lit``: the lit features and
    their light and volume rows (``tables.scene_lit``); a launch with any
    of them runs a lit instance and is also counted in
    ``render_blocks.lit_launches``.  ``cull`` False makes the triangles
    two-sided (``render_blocks_pallas(cull=False)``, :2013).

    The scheduler: the work pool where ``pool`` is True (the default),
    with items of ``pool_chunk`` samples handed out every ``pool_k``
    iterations (the JAX package's defaults, 16 and 4,
    ``pallas_megakernel.py:1511-1516``), the classic one where it is
    False (the JAX kernel's other scheduler, which the parity tests
    hold).  A chunk or period below 1 raises.  A pool launch is also
    counted in ``render_blocks.pool_launches``.  ``slots`` (1,) gets the
    lane slots added to it, the lane-iterations a launch holds lanes for:
    128 x each row's iterations under the pool, 32 x each warp's longest
    loop under the classic scheduler; ``steps / slots`` is the occupancy.

    The spheres are swept group by group: each ray slab-tests the boxes
    of the table's groups of ``SPHERE_GROUP`` rows
    (``tables.sphere_groups``, swept over the camera's shutter)
    and sweeps the groups it enters, which leaves every winner as the
    brute-force sweep finds it.  ``spheres`` (2,) gets the group box
    tests and the sphere rows swept added to it.  ``progress``, a
    :class:`ProgressCounter` (CUDA only), gets each 128-pixel tile row
    added as its block finishes, while the launch runs."""
    if pool_chunk < 1 or pool_k < 1:
        raise ValueError(f"pool chunk {pool_chunk} and period {pool_k} must "
                         f"be >= 1")
    check_lit(lit, tbl)
    check_table(tbl, "megakernel",
                staged=(lit_rows(lit) * LIGHT_COLS * 4
                        + (POOL_STAGE_BYTES if pool else 0)))
    if tris is not None:
        check_tris(tris, tbl, "megakernel")
    check_counter(tests, 2, tbl, "tests")
    if cam.dtype != _F32 or tuple(cam.shape) != (21,) \
            or not cam.is_contiguous() or cam.device != tbl.device:
        raise ValueError("camera must be a contiguous (21,) float32 tensor "
                         "on the table's device")
    if len(meta) != 7 or n_tiles < 1:
        raise ValueError(f"bad meta {meta} / n_tiles {n_tiles}")
    check_counter(steps, 1, tbl, "steps")
    check_counter(shadows, 1, tbl, "shadows")
    check_counter(slots, 1, tbl, "slots")
    check_counter(spheres, 2, tbl, "spheres")
    seed, width, height, _n_pixels, tile0, spp, max_depth = meta
    if pool and -(-spp // pool_chunk) * LANES >= 1 << 31:
        raise ValueError(f"spp {spp} makes more pool items than int32 holds")
    if tbl.device.type == "cpu":
        return render_blocks_reference(
            tbl, cam, meta, n_tiles, background=background, steps=steps,
            tris=tris, tests=tests, lit=lit, shadows=shadows, cull=cull,
            pool=pool, pool_chunk=pool_chunk, pool_k=pool_k,
            slots=slots, spheres=spheres, progress=progress)
    groups = sphere_groups(tbl, camera_shutter(cam))
    lib = _lib()
    use_sky, (bgr, bgg, bgb) = background_args(background)
    out = torch.empty((3, n_tiles * TILE_ROWS, LANES), dtype=_F32,
                      device=tbl.device)
    err = lib.rtow_megakernel(
        tbl.data_ptr(), tbl.shape[0], groups.data_ptr(), groups.shape[0],
        None if tris is None else tris.tbl.data_ptr(),
        None if tris is None else tris.boxes.data_ptr(),
        0 if tris is None else tris.n_blocks,
        0 if tris is None else tris.block,
        0 if tris is None else tris.count,
        cam.data_ptr(), seed, width, height,
        tile0, spp, max_depth, n_tiles, int(use_sky), bgr, bgg, bgb,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        None if steps is None else steps.data_ptr(),
        None if tests is None else tests.data_ptr(),
        None if shadows is None else shadows.data_ptr(),
        None if spheres is None else spheres.data_ptr(),
        *lit_args(lit, tbl), int(cull), int(pool), pool_chunk,
        pool_k, None if slots is None else slots.data_ptr(),
        None if progress is None else progress.dev_ptr,
        *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "megakernel")
    render_blocks.launches += 1
    render_blocks.lit_launches += lit.any
    render_blocks.pool_launches += bool(pool)
    return out[0], out[1], out[2]


#: Kernel launches made by :func:`render_blocks` in this process, those of
#: them that ran a lit instance, and those that ran the pool scheduler.
render_blocks.launches = 0
render_blocks.lit_launches = 0
render_blocks.pool_launches = 0


def unblock_image(r, g, b, *, width: int, height: int) -> torch.Tensor:
    """Block rows (tiles * 8, 128) x3 -> (H * W, 3) image order
    (``unblock_image``, :2143)."""
    tiles_x = -(-width // LANES)
    tiles_y = -(-height // TILE_ROWS)

    def unblock(x):
        img = x.reshape(tiles_y, tiles_x, TILE_ROWS, LANES)
        img = img.permute(0, 2, 1, 3).reshape(tiles_y * TILE_ROWS,
                                              tiles_x * LANES)
        return img[:height, :width].reshape(-1)

    return torch.stack([unblock(r), unblock(g), unblock(b)], dim=-1)


def render_spheres(scene, camera, seed: int, *, width: int, height: int,
                   spp: int, max_depth: int, roulette: bool = False,
                   cull: bool = True, pool: bool = True) -> torch.Tensor:
    """Whole-frame render of a sphere or small-mesh scene -> (n_pixels,
    3) radiance sums (``render_spheres_pallas``, :2163); ``cull`` False
    makes the triangles two-sided; ``pool`` False runs the classic
    scheduler (:func:`render_blocks`)."""
    tbl, tris = k1_tables(scene)
    meta = pack_meta(seed, width=width, height=height, spp=spp,
                     max_depth=max_depth)
    r, g, b = render_blocks(tbl, pack_camera(camera), meta,
                            n_tiles_for(width, height),
                            background=scene.background, tris=tris,
                            lit=scene_lit(scene, nee=scene.has_emissive,
                                          roulette=roulette),
                            cull=cull, pool=pool)
    return unblock_image(r, g, b, width=width, height=height)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/megakernel.cu``, built at first use, with its C entry
    points declared."""
    lib = _cuda.load("megakernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtow_megakernel.argtypes = [p, i, p, i, p, p, i, i, i, p, i, i,
                                    i, i, i, i, i, i, f, f, f, p, p, p, p,
                                    p, p, p, p, i, i, i, i, i, i, i, i, i,
                                    i, i, i, p, p, i, p]
    lib.rtow_megakernel.restype = i
    lib.rtow_progress_alloc.argtypes = [i, ctypes.POINTER(p),
                                        ctypes.POINTER(p)]
    lib.rtow_progress_alloc.restype = i
    return lib


class ProgressCounter:
    """A count of finished 128-pixel tile rows that :func:`render_blocks`
    adds to while a launch runs: one uint32 of mapped, pinned host memory
    (``rtow_progress_alloc`` in ``csrc/megakernel.cu``), which each block
    of K1 adds its rows to with a system-scope atomic and the host reads
    without a synchronisation.  The plain version adds every row at the
    end."""

    def __init__(self, host: int, dev_ptr: int):
        self._cell = ctypes.c_uint32.from_address(host)
        self.dev_ptr = dev_ptr

    @property
    def value(self) -> int:
        return self._cell.value

    def reset(self) -> None:
        self._cell.value = 0

    def add(self, rows: int) -> None:
        self._cell.value += rows


@functools.lru_cache(maxsize=None)
def progress_counter(device_index: int) -> ProgressCounter:
    """The process's :class:`ProgressCounter` on card ``device_index``,
    allocated at first use (and kept: it is 4 bytes).  Raises if the
    mapped allocation fails."""
    lib = _lib()
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    err = lib.rtow_progress_alloc(device_index, ctypes.byref(host),
                                  ctypes.byref(dev))
    if err:
        raise RuntimeError(
            f"mapped host memory for the ticker: CUDA error {err} "
            f"({lib.rtow_cuda_error_string(err).decode()})")
    return ProgressCounter(host.value, dev.value)
