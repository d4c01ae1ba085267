"""The persistent whole-frame megakernel for sphere scenes, and its plain
PyTorch version (the port of the sphere half of
``rtow_tpu/ops/pallas_megakernel.py``).

``render_blocks`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/megakernel.cu``, on a CPU tensor it runs
``render_blocks_reference``, and on anything else it raises.  Both
compute what the Pallas kernel ``_kernel`` computes under its classic
scheduler (``RTOW_POOL=0``): every lane of an 8x128-pixel tile owns one
pixel and loops until that pixel has ``spp`` samples — regenerate a
thin-lens, time-jittered camera ray when idle, then advance one bounce
(sphere sweep, Lambertian / metal / dielectric scatter, sky or flat
background on a miss).  Outputs are per-pixel radiance SUMS in the
kernel's block layout: three (n_tiles * 8, 128) float32 planes.

Random numbers are the JAX kernel's stateless counter hash, bit for bit:
lane id ``pix = tile * 1024 + row * 128 + col``, salt
``mix(seed + it * 40503)`` with ``it`` the lane's own step count, draw
``mix(lane ^ (salt + draw * 0x9E3779B9))``.  Under the classic
scheduler a lane takes exactly one step per iteration of its tile's
loop until it is done, so ``it`` depends only on the lane's own history,
and a per-lane loop replays the JAX kernel's stream exactly.

The sphere table keeps the JAX package's Morton order, so the nearest
hit resolves ties the same way: the winner is the first minimal ``t`` in
table order.

The plain bounce is shared with the gradient path's plain versions
(``ops/grad.py``), as ``csrc/bounce.cuh`` is shared by the kernels:
:func:`lane_hash`, :func:`step_salt`, :func:`draw_scatter`,
:func:`nearest_sphere`, :func:`winner_rows`, :func:`shade` and
:func:`background_args`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import _cuda

TILE_ROWS = 8
LANES = 128
TILE = TILE_ROWS * LANES
#: Spheres per Morton block (table rows are padded to a multiple).
SPHERE_BLOCK = 128

# Sphere-table columns.
(_C0X, _C0Y, _C0Z, _DCX, _DCY, _DCZ, _R, _ALR, _ALG, _ALB, _FUZZ, _IR,
 _KIND) = range(13)
TBL_COLS = 16

# float32-exact constants (the JAX kernel's np.float32 values).
_INV24 = 1.0 / (1 << 24)
_TWO_PI = float(np.float32(2.0 * np.pi))
T_MIN = float(np.float32(1e-3))
BIG = float(np.float32(3.0e38))
_EPS12 = float(np.float32(1e-12))

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SALT_STRIDE = 40503

#: Material kind codes as they sit in the table's float column.
_METAL = 1.0
_DIELECTRIC = 2.0

#: Largest table the kernel's shared memory holds (227 KB per block on
#: Hopper): 3,632 spheres.
MAX_TABLE_BYTES = 232448

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Counter RNG.  torch has no logical right shift on uint32 on the CPU, so
# the hash runs on int64 tensors (or Python ints) holding uint32 values.


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix(x):
    """murmur3 finalizer (``pallas_megakernel._mix``, :112)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform(lane, salt, draw: int) -> torch.Tensor:
    """U[0,1) per lane from (lane, salt, draw) (``_uniform``, :122)."""
    h = mix(lane ^ ((salt + ((draw * _GOLDEN) & _M32)) & _M32))
    return (h >> 8).to(_F32) * _INV24


def draw_scatter(lane, salt):
    """The bounce's draws: a unit vector and the dielectric choice
    (``_draw_scatter``, :1225)."""
    uz = 1.0 - 2.0 * uniform(lane, salt, 5)
    uu = uniform(lane, salt, 6)
    uxy = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
    uph = _TWO_PI * uu
    return (uxy * torch.cos(uph), uxy * torch.sin(uph), uz,
            uniform(lane, salt, 7))


def step_salt(seed: int, it: int) -> int:
    """The salt of step ``it``: K1's per-lane step count, the gradient
    bounce's scan step."""
    return mix((seed + it * _SALT_STRIDE) & _M32)


def lane_hash(lane_id):
    """A lane's hashed id from its integer id (``_lane_u32``)."""
    return mix(_mul32(lane_id & _M32, _GOLDEN))


# ---------------------------------------------------------------------------
# Host tables and packing.


def build_sphere_table(scene) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere tables ((Npad, 16) params, (NB, 8) block AABBs) on the
    scene's device (``build_sphere_table``, :134).

    Rows are in Morton order of the spheres' motion-swept bounds;
    padding rows have r = 0 and a far-away center, so they are never
    hit.  The block boxes are the JAX kernel's culling boxes; the CUDA
    kernel sweeps every row and does not read them."""
    sp = scene.spheres
    mats = scene.materials
    n = sp.radius.shape[0]
    npad = -(-n // SPHERE_BLOCK) * SPHERE_BLOCK
    dev = sp.radius.device

    r_abs = sp.radius.abs()[:, None]
    c1 = sp.center0 + sp.dcenter
    smin = torch.minimum(sp.center0, c1) - r_abs
    smax = torch.maximum(sp.center0, c1) + r_abs
    cent = 0.5 * (smin + smax)
    order = morton_order(smin.amin(dim=0), smax.amax(dim=0), cent)
    c0 = sp.center0[order]
    dc = sp.dcenter[order]
    mid = sp.material[order].long()
    smin, smax = smin[order], smax[order]

    tbl = torch.stack([
        c0[:, 0], c0[:, 1], c0[:, 2],
        dc[:, 0], dc[:, 1], dc[:, 2],
        sp.radius[order],
        mats.albedo[mid, 0], mats.albedo[mid, 1], mats.albedo[mid, 2],
        mats.fuzz[mid], mats.ir[mid], mats.kind[mid].to(_F32),
        mats.albedo2[mid, 0], mats.albedo2[mid, 1], mats.albedo2[mid, 2],
    ], dim=1).to(_F32)
    pad = torch.zeros((npad - n, TBL_COLS), dtype=_F32, device=dev)
    pad[:, _C0X] = 1.0e9
    tbl = torch.cat([tbl, pad])

    big = 1.0e30
    bmin = torch.cat([smin, torch.full((npad - n, 3), big, device=dev)])
    bmax = torch.cat([smax, torch.full((npad - n, 3), -big, device=dev)])
    nb = npad // SPHERE_BLOCK
    blk_min = bmin.reshape(nb, SPHERE_BLOCK, 3).amin(dim=1)
    blk_max = bmax.reshape(nb, SPHERE_BLOCK, 3).amax(dim=1)
    pad_eps = 1e-4 + 1e-4 * (blk_max - blk_min).abs()
    boxes = torch.cat([blk_min - pad_eps, blk_max + pad_eps,
                       torch.zeros((nb, 2), dtype=_F32, device=dev)], dim=1)
    return tbl, boxes.to(_F32)


def morton_order(cmin: torch.Tensor, cmax: torch.Tensor,
                 cent: torch.Tensor) -> torch.Tensor:
    """Stable Morton (z-order) permutation of centroids (``_morton_order``,
    :191).  The sort is stable, as ``jnp.argsort`` is: static covers have
    equal codes."""
    return torch.argsort(_morton_codes(cmin, cmax, cent), stable=True)


def _morton_codes(cmin, cmax, cent) -> torch.Tensor:
    """30-bit Morton codes of centroids quantised over robust (5th-95th
    percentile) bounds."""
    plo = torch.quantile(cent, 0.05, dim=0)
    phi = torch.quantile(cent, 0.95, dim=0)
    ok = (phi - plo) > 1e-9
    lo = torch.where(ok, plo, cmin)
    hi = torch.where(ok, phi, cmax)
    ext = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((cent - lo) / ext * 1023.0, 0.0, 1023.0).to(torch.int64)

    def spread(x):  # interleave 10 bits with two zero bits each
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def pack_camera(camera) -> torch.Tensor:
    """The kernel's (21,) float32 camera vector (:2062-2070)."""
    c = camera
    return torch.stack([
        c.origin[0], c.origin[1], c.origin[2],
        c.u[0], c.u[1], c.u[2],
        c.v[0], c.v[1], c.v[2],
        c.lower_left[0], c.lower_left[1], c.lower_left[2],
        c.horizontal[0], c.horizontal[1], c.horizontal[2],
        c.vertical[0], c.vertical[1], c.vertical[2],
        c.lens_radius, c.t0, c.t1 - c.t0,
    ]).to(_F32)


def pack_meta(seed: int, *, width: int, height: int, spp: int,
              max_depth: int, tile0: int = 0) -> Tuple[int, ...]:
    """The kernel's scalars (:2071-2075):
    (seed, W, H, n_pixels, tile0, spp, max_depth), each an int32."""
    meta = (int(seed), int(width), int(height), int(width) * int(height),
            int(tile0), int(spp), int(max_depth))
    for v in meta:
        if not -(1 << 31) <= v < (1 << 31):
            raise ValueError(f"kernel scalar {v} does not fit in int32")
    if width < 1 or height < 1 or spp < 0 or max_depth < 0 or tile0 < 0:
        raise ValueError(f"bad render scalars {meta}")
    return meta


def n_tiles_for(width: int, height: int) -> int:
    return -(-width // LANES) * -(-height // TILE_ROWS)


def background_args(background) -> Tuple[bool, Tuple[float, float, float]]:
    if background == "sky":
        return True, (0.0, 0.0, 0.0)
    r, g, b = (float(np.float32(x)) for x in background)
    return False, (r, g, b)


# ---------------------------------------------------------------------------
# The plain version.


def render_blocks_reference(
    tbl: torch.Tensor,
    cam: torch.Tensor,
    meta: Tuple[int, ...],
    n_tiles: int,
    *,
    background: Union[str, tuple] = "sky",
    steps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the megakernel, on ``tbl``'s device.

    Runs the per-lane loop vectorised over a chunk of lanes at a time,
    dropping lanes as they finish.  Same inputs and outputs as
    :func:`render_blocks`."""
    seed, width, height, _n_pixels, tile0, spp, max_depth = meta
    dev = tbl.device
    n_lanes = n_tiles * TILE
    out = torch.zeros((3, n_lanes), dtype=_F32, device=dev)

    g = torch.arange(n_lanes, device=dev, dtype=torch.int64)
    tiles_x = -(-width // LANES)
    pid = tile0 + g // TILE
    row = (g % TILE) // LANES
    col = g % LANES
    prow = (pid // tiles_x) * TILE_ROWS + row
    pcol = (pid % tiles_x) * LANES + col
    in_img = (prow < height) & (pcol < width)
    pix = (pid * TILE + row * LANES + col) & _M32
    lanes = torch.nonzero(in_img).flatten() if spp > 0 else g[:0]
    cam_f = [float(x) for x in cam.detach().cpu()]
    # Lanes per chunk: the pair temporaries are (chunk, 128) float32, so
    # 2**20 lanes take about 0.5 GB each on the card.
    chunk = 1 << 20 if dev.type == "cuda" else 1 << 16
    for start in range(0, lanes.numel(), chunk):
        idx = lanes[start:start + chunk]
        out[:, idx], n = _trace_lanes(
            tbl, cam_f, pix[idx], prow[idx], pcol[idx], seed=seed,
            width=width, height=height, spp=spp, max_depth=max_depth,
            background=background)
        if steps is not None:
            steps += n
    planes = out.view(3, n_tiles * TILE_ROWS, LANES)
    return planes[0], planes[1], planes[2]


def _trace_lanes(tbl, cam, pix, prow, pcol, *, seed, width, height, spp,
                 max_depth, background):
    """(radiance sums (3, L) of lanes ``pix`` after ``spp`` samples, ray
    steps taken)."""
    (cox, coy, coz, cux, cuy, cuz, cvx, cvy, cvz, llx, lly, llz,
     chx, chy, chz, cwx, cwy, cwz, lens_r, t0, dt) = cam
    dev = tbl.device
    n = pix.numel()
    out = torch.zeros((3, n), dtype=_F32, device=dev)
    inv_w = float(np.float32(1.0) / np.float32(width - 1))
    inv_h = float(np.float32(1.0) / np.float32(height - 1))

    # Lane state, compacted to the unfinished lanes after every step;
    # ``idx`` maps it back to the lane's slot in ``out``.
    idx = torch.arange(n, device=dev)
    lane = lane_hash(pix)
    fcol = pcol.to(_F32)
    frow = (height - 1 - prow).to(_F32)
    zeros = torch.zeros(n, dtype=_F32, device=dev)
    ox = oy = oz = dy = dz = tm = tpr = tpg = tpb = rr = rg = rb = zeros
    dx = zeros + 1.0
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    bounce = torch.zeros(n, dtype=torch.int32, device=dev)
    started = torch.zeros(n, dtype=torch.int32, device=dev)

    it = steps = 0
    while idx.numel():
        salt = step_salt(seed, it)
        # ---- regeneration: idle lanes (all have samples left) -------
        need = ~alive
        s = (fcol + uniform(lane, salt, 0)) * inv_w
        t = (frow + uniform(lane, salt, 1)) * inv_h
        rad_l = lens_r * torch.sqrt(uniform(lane, salt, 2))
        th = _TWO_PI * uniform(lane, salt, 3)
        lx = rad_l * torch.cos(th)
        ly = rad_l * torch.sin(th)
        nox = cox + lx * cux + ly * cvx
        noy = coy + lx * cuy + ly * cvy
        noz = coz + lx * cuz + ly * cvz
        ox = torch.where(need, nox, ox)
        oy = torch.where(need, noy, oy)
        oz = torch.where(need, noz, oz)
        dx = torch.where(need, llx + s * chx + t * cwx - nox, dx)
        dy = torch.where(need, lly + s * chy + t * cwy - noy, dy)
        dz = torch.where(need, llz + s * chz + t * cwz - noz, dz)
        tm = torch.where(need, t0 + uniform(lane, salt, 4) * dt, tm)
        tpr = torch.where(need, 1.0, tpr)
        tpg = torch.where(need, 1.0, tpg)
        tpb = torch.where(need, 1.0, tpb)
        bounce = torch.where(need, 0, bounce)
        started = started + need.to(torch.int32)

        # ---- one bounce for every lane (all are alive now) ----------
        a = dx * dx + dy * dy + dz * dz
        best_t, best_k = nearest_sphere(tbl, ox, oy, oz, dx, dy, dz, tm, a,
                                         1.0 / a)
        state, alive, bounce = shade(
            (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb),
            winner_rows(tbl, best_t, best_k), draw_scatter(lane, salt),
            best_t, torch.ones_like(need), bounce, max_depth, background)
        (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
        it += 1
        steps += idx.numel()

        done = ~alive & (started == spp)
        if bool(done.any()):
            out[:, idx[done]] = torch.stack([rr[done], rg[done], rb[done]])
            keep = ~done
            idx, lane, fcol, frow = idx[keep], lane[keep], fcol[keep], frow[keep]
            ox, oy, oz, dx, dy, dz, tm = (
                v[keep] for v in (ox, oy, oz, dx, dy, dz, tm))
            tpr, tpg, tpb, rr, rg, rb = (
                v[keep] for v in (tpr, tpg, tpb, rr, rg, rb))
            alive, bounce, started = alive[keep], bounce[keep], started[keep]
    return out, steps


def nearest_sphere(tbl, ox, oy, oz, dx, dy, dz, tm, a, inv_a):
    """(best_t, best_k) over the whole table, block by block, with the
    JAX kernel's tie rule (``_sphere_block_sweep``, :558-588): inside a
    block the first minimal t wins, across blocks only a strictly
    smaller t replaces the winner."""
    best_t = torch.full_like(ox, BIG)
    best_k = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    o3x, o3y, o3z = ox[:, None], oy[:, None], oz[:, None]
    d3x, d3y, d3z = dx[:, None], dy[:, None], dz[:, None]
    tm3, a3, inva3 = tm[:, None], a[:, None], inv_a[:, None]
    for b0 in range(0, tbl.shape[0], SPHERE_BLOCK):
        blk = tbl[b0:b0 + SPHERE_BLOCK]
        ocx = o3x - (blk[:, _C0X] + tm3 * blk[:, _DCX])
        ocy = o3y - (blk[:, _C0Y] + tm3 * blk[:, _DCY])
        ocz = o3z - (blk[:, _C0Z] + tm3 * blk[:, _DCZ])
        r_ = blk[:, _R]
        h = ocx * d3x + ocy * d3y + ocz * d3z
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
        disc = h * h - a3 * cc
        pos = disc > 0.0
        sq = torch.sqrt(torch.where(pos, disc, 1.0))
        near = (-h - sq) * inva3
        far = (-h + sq) * inva3
        bt3 = best_t[:, None]
        near_ok = (near >= T_MIN) & (near <= bt3)
        far_ok = (far >= T_MIN) & (far <= bt3)
        t_pair = torch.where(near_ok, near, far)
        t_pair = torch.where(pos & (near_ok | far_ok), t_pair, BIG)
        bk = torch.argmin(t_pair, dim=1)
        bt = torch.gather(t_pair, 1, bk[:, None])[:, 0]
        upd = bt < best_t
        best_t = torch.where(upd, bt, best_t)
        best_k = torch.where(upd, bk + b0, best_k)
    return best_t, best_k


def winner_rows(tbl, best_t, best_k) -> torch.Tensor:
    """(L, 13) table rows of the sweep's winners, 0 where nothing was hit
    (the JAX sweep's winner fetch)."""
    return torch.where((best_t < BIG)[:, None], tbl[best_k, :13], 0.0)


def shade(state, w, draws, best_t, alive, bounce, max_depth, background):
    """The differentiable half of a bounce (``_hit_basics`` +
    ``_shade_pure``, :891-1222, sphere subset): winner rows -> new state.

    ``state`` is the 13-tuple (ox oy oz dx dy dz tm tpr tpg tpb rr rg rb),
    ``w`` the (L, 13) winner rows from :func:`winner_rows`, ``draws``
    from :func:`draw_scatter`, ``best_t`` the sweep's t, ``alive`` a bool
    mask and ``bounce`` the int32 bounce counts.  Returns (new 13-tuple
    with ``tm`` passed through, ``can``, new ``bounce``).  Dead lanes pass
    through; a live miss adds throughput * background and retires; a live
    hit at ``max_depth`` retires; every other live hit scatters.

    The intersection t is re-derived from the winner's parameters, so
    autograd through this function gives the exact geometry gradient.
    Every branch that is computed and then not selected is guarded
    ("safe where"), so it puts no NaN into the gradient."""
    (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
    (c0x, c0y, c0z, dcx, dcy, dcz, r_, alr, alg, alb, fuzz, ir,
     kind) = w.unbind(1)
    uvx, uvy, uvz, choice = draws
    use_sky, bg = background_args(background)
    hit = best_t < BIG
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a

    # ---- hit record: t re-derived from the winner's parameters ------
    ocx = ox - (c0x + tm * dcx)
    ocy = oy - (c0y + tm * dcy)
    ocz = oz - (c0z + tm * dcz)
    h = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
    disc = h * h - a * cc
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    near = (-h - sq) * inv_a
    far = (-h + sq) * inv_a
    root_is_near = (near - best_t).abs() <= (far - best_t).abs()
    t_hit = torch.where(hit, torch.where(root_is_near, near, far), 1.0)
    px = ox + t_hit * dx
    py = oy + t_hit * dy
    pz = oz + t_hit * dz
    r_abs = torch.where(r_ == 0.0, 1.0, r_.abs())
    nx = (px - (c0x + tm * dcx)) / r_abs
    ny = (py - (c0y + tm * dcy)) / r_abs
    nz = (pz - (c0z + tm * dcz)) / r_abs
    front = (dx * nx + dy * ny + dz * nz < 0.0) ^ (r_ < 0.0)
    flip = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip

    # Lambertian: n + unit (degenerate -> n).
    lamx, lamy, lamz = nx + uvx, ny + uvy, nz + uvz
    degen = lamx * lamx + lamy * lamy + lamz * lamz < _EPS12
    lamx = torch.where(degen, nx, lamx)
    lamy = torch.where(degen, ny, lamy)
    lamz = torch.where(degen, nz, lamz)

    # Metal: reflect(raw d) + fuzz * unit (no horizon check — reference).
    ddn2 = 2.0 * (dx * nx + dy * ny + dz * nz)
    mrx = dx - ddn2 * nx + fuzz * uvx
    mry = dy - ddn2 * ny + fuzz * uvy
    mrz = dz - ddn2 * nz + fuzz * uvz

    # Dielectric: Schlick + total internal reflection, + fuzz.  sin_t
    # only feeds the TIR test; its epsilon floor keeps sqrt'(0) out of
    # the gradient at normal incidence (pallas_megakernel.py:1056-1059).
    inv_dlen = 1.0 / torch.sqrt(a)
    udx, udy, udz = dx * inv_dlen, dy * inv_dlen, dz * inv_dlen
    cos_t = torch.minimum(-(udx * nx + udy * ny + udz * nz),
                          torch.ones_like(a))
    sin_t = torch.sqrt(torch.maximum(1.0 - cos_t * cos_t,
                                     torch.full_like(a, _EPS12)))
    ir_safe = torch.where(ir > 0.0, ir, 1.0)
    ratio = torch.where(front, 1.0 / ir_safe, ir_safe)
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    refl_p = r0 + (1.0 - r0) * omc2 * omc2 * omc
    must_reflect = cannot | (refl_p > choice)
    k_raw = 1.0 - ratio * ratio * (1.0 - cos_t * cos_t)
    k_ok = k_raw > 0.0
    sqk = torch.where(k_ok, torch.sqrt(torch.where(k_ok, k_raw, 1.0)), 0.0)
    rfx = ratio * udx + (ratio * cos_t - sqk) * nx
    rfy = ratio * udy + (ratio * cos_t - sqk) * ny
    rfz = ratio * udz + (ratio * cos_t - sqk) * nz
    udn2 = 2.0 * (udx * nx + udy * ny + udz * nz)
    dix = torch.where(must_reflect, udx - udn2 * nx, rfx) + fuzz * uvx
    diy = torch.where(must_reflect, udy - udn2 * ny, rfy) + fuzz * uvy
    diz = torch.where(must_reflect, udz - udn2 * nz, rfz) + fuzz * uvz

    is_metal = kind == _METAL
    is_diel = kind == _DIELECTRIC
    sdx = torch.where(is_metal, mrx, torch.where(is_diel, dix, lamx))
    sdy = torch.where(is_metal, mry, torch.where(is_diel, diy, lamy))
    sdz = torch.where(is_metal, mrz, torch.where(is_diel, diz, lamz))
    atr = torch.where(is_diel, 1.0, alr)
    atg = torch.where(is_diel, 1.0, alg)
    atb = torch.where(is_diel, 1.0, alb)

    # ---- background for live lanes that missed ----------------------
    missed = alive & ~hit
    if use_sky:  # the reference's sky gradient
        sky_t = 0.5 * (dy * (1.0 / torch.sqrt(a)) + 1.0)
        skyr = 1.0 - sky_t + sky_t * 0.5
        skyg = 1.0 - sky_t + sky_t * 0.7
        skyb = 1.0
    else:
        skyr, skyg, skyb = bg
    rr = rr + torch.where(missed, tpr * skyr, 0.0)
    rg = rg + torch.where(missed, tpg * skyg, 0.0)
    rb = rb + torch.where(missed, tpb * skyb, 0.0)

    # ---- advance (depth is checked after the hit) -------------------
    can = alive & hit & (bounce < max_depth)
    ox = torch.where(can, px, ox)
    oy = torch.where(can, py, oy)
    oz = torch.where(can, pz, oz)
    dx = torch.where(can, sdx, dx)
    dy = torch.where(can, sdy, dy)
    dz = torch.where(can, sdz, dz)
    tpr = torch.where(can, tpr * atr, tpr)
    tpg = torch.where(can, tpg * atg, tpg)
    tpb = torch.where(can, tpb * atb, tpb)
    bounce = bounce + can.to(torch.int32)
    return ((ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb), can,
            bounce)


# ---------------------------------------------------------------------------
# The wrapper.


def check_table(tbl: torch.Tensor, kernel: str, copies: int = 1) -> None:
    """Raise unless ``tbl`` is a table the kernel ``kernel`` takes: a
    contiguous (k*128, 16) float32 tensor on the CPU (the plain version)
    or on a CUDA device, where ``copies`` times its bytes must fit in a
    block's shared memory and it must be 16-byte aligned."""
    if tbl.dtype != _F32 or tbl.dim() != 2 or tbl.shape[1] != TBL_COLS \
            or tbl.shape[0] % SPHERE_BLOCK or not tbl.is_contiguous():
        raise ValueError(
            f"sphere table must be a contiguous (k*{SPHERE_BLOCK}, "
            f"{TBL_COLS}) float32 tensor, got {tuple(tbl.shape)} {tbl.dtype}")
    if tbl.device.type == "cpu":
        return
    if tbl.device.type != "cuda":
        raise ValueError(f"no {kernel} for device {tbl.device}")
    nbytes = copies * tbl.numel() * 4
    if nbytes > MAX_TABLE_BYTES:
        raise ValueError(
            f"{tbl.shape[0]} table rows ({nbytes} bytes) exceed the "
            f"{kernel}'s shared-memory table ({MAX_TABLE_BYTES} bytes)")
    if tbl.data_ptr() % 16:
        raise ValueError("sphere table must be 16-byte aligned")


def render_blocks(
    tbl: torch.Tensor,
    cam: torch.Tensor,
    meta: Tuple[int, ...],
    n_tiles: int,
    *,
    background: Union[str, tuple] = "sky",
    steps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radiance sums of tiles ``tile0 .. tile0 + n_tiles - 1`` as three
    (n_tiles * 8, 128) float32 planes (``render_blocks_pallas``, :2004).

    ``tbl``: (Npad, 16) sphere table from :func:`build_sphere_table`;
    ``cam``: (21,) vector from :func:`pack_camera`; ``meta``: the
    scalars from :func:`pack_meta`.  A CUDA ``tbl`` launches the CUDA
    kernel (and counts the launch in ``render_blocks.launches``); a CPU
    ``tbl`` runs :func:`render_blocks_reference`; any other device
    raises.  ``steps``, a (1,) int64 tensor on ``tbl``'s device, gets
    the ray steps (bounces) of the render added to it (a stats
    counter)."""
    check_table(tbl, "megakernel")
    if cam.dtype != _F32 or tuple(cam.shape) != (21,) \
            or not cam.is_contiguous() or cam.device != tbl.device:
        raise ValueError("camera must be a contiguous (21,) float32 tensor "
                         "on the table's device")
    if len(meta) != 7 or n_tiles < 1:
        raise ValueError(f"bad meta {meta} / n_tiles {n_tiles}")
    if steps is not None and (steps.dtype != torch.int64
                              or tuple(steps.shape) != (1,)
                              or steps.device != tbl.device):
        raise ValueError("steps must be a (1,) int64 tensor on the table's "
                         "device")
    if tbl.device.type == "cpu":
        return render_blocks_reference(tbl, cam, meta, n_tiles,
                                       background=background, steps=steps)
    lib = _lib()
    seed, width, height, _n_pixels, tile0, spp, max_depth = meta
    use_sky, (bgr, bgg, bgb) = background_args(background)
    out = torch.empty((3, n_tiles * TILE_ROWS, LANES), dtype=_F32,
                      device=tbl.device)
    err = lib.rtow_megakernel(
        tbl.data_ptr(), tbl.shape[0], cam.data_ptr(), seed, width, height,
        tile0, spp, max_depth, n_tiles, int(use_sky), bgr, bgg, bgb,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        None if steps is None else steps.data_ptr(),
        *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "megakernel")
    render_blocks.launches += 1
    return out[0], out[1], out[2]


#: Kernel launches made by :func:`render_blocks` in this process.
render_blocks.launches = 0


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
                   spp: int, max_depth: int) -> torch.Tensor:
    """Whole-frame render -> (n_pixels, 3) radiance sums
    (``render_spheres_pallas``, :2163)."""
    tbl, _boxes = build_sphere_table(scene)
    meta = pack_meta(seed, width=width, height=height, spp=spp,
                     max_depth=max_depth)
    r, g, b = render_blocks(tbl, pack_camera(camera), meta,
                            n_tiles_for(width, height),
                            background=scene.background)
    return unblock_image(r, g, b, width=width, height=height)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/megakernel.cu``, built at first use, with its C entry
    points declared."""
    lib = _cuda.load("megakernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtow_megakernel.argtypes = [p, i, p, i, i, i, i, i, i, i, i, f, f, f,
                                    p, p, p, p, i, p]
    lib.rtow_megakernel.restype = i
    return lib
