"""The plain bounce that the plain versions of K1, K3, K4 and K5 share, as
the kernels share ``csrc/bounce.cuh`` (the port of
``pallas_megakernel.py``'s ``_bounce_core`` and its parts, :444-1430).

A bounce of live lanes: the sweep of the sphere table, then of the
triangle table (:func:`nearest_sphere`, :func:`nearest_sphere_culled`,
:func:`nearest_triangle`), the winners' rows (:func:`winners`), the hit
record re-derived from them (:func:`hit_basics`), the volume event
(:func:`volume_event`), next-event estimation with its shadow sweep
(:func:`nee_contrib`) and the shade (:func:`shade`), chained for K1 and
K3 by :func:`bounce_lanes`; the gradient path (``ops/grad.py``) chains
the same parts itself, around autograd.  Lane state is the 13-tuple ox
oy oz dx dy dz tm tpr tpg tpb rr rg rb; :func:`lane_state` packs camera
rays into it.  The random numbers are the counter hash of
``utils/rng.py``.  Triangles are one-sided unless a caller passes
``cull=False`` (K1 and K3, as the JAX kernels take ``cull``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.materials import marble_t
from ..utils.rng import hash_uniform
from .lights import TWO_PI, light_pdf_toward, sample_light_dirs
from .tables import (
    _C0X, _C0Y, _C0Z, _DCX, _DCY, _DCZ, _R, SPHERE_BLOCK, SPHERE_GROUP,
    SUPER, TBL_COLS, TILE, TRI_PARAMS, Lit, TriTable, background_args,
)
from .volumes import sample_volume_event, volume_transmittance

# float32-exact constants (the JAX kernel's np.float32 values).
T_MIN = float(np.float32(1e-3))
BIG = float(np.float32(3.0e38))
_EPS12 = float(np.float32(1e-12))
_DET_MIN = float(np.float32(1e-6))

#: Material kind codes as they sit in the table's float column.
_METAL = 1.0
_DIELECTRIC = 2.0
_EMISSIVE = 3.0
_CHECKER = 4.0
_NOISE = 5.0

# The lit bounce's constants (float32, as the JAX kernel rounds them).
_INV_PI = float(np.float32(1.0 / np.pi))
_HALF_INV_PI = float(np.float32(0.5 / np.pi))
_QUARTER_INV_PI = float(np.float32(0.25 / np.pi))
#: The shadow ray must reach this fraction of the light's distance.
_SHADOW_FRAC = float(np.float32(1.0 - 1e-3))
#: Russian roulette (rtow_tpu/ops/integrator.py:55-57): from this many
#: scatters on, with this survival floor.
RR_START = 3
RR_PMIN = float(np.float32(0.05))

_F32 = torch.float32


def draw_scatter(lane, salt):
    """The bounce's draws: a unit vector and the dielectric choice
    (``_draw_scatter``, :1225)."""
    uz = 1.0 - 2.0 * hash_uniform(lane, salt, 5)
    uu = hash_uniform(lane, salt, 6)
    uxy = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
    uph = TWO_PI * uu
    return (uxy * torch.cos(uph), uxy * torch.sin(uph), uz,
            hash_uniform(lane, salt, 7))


def lane_state(rays, n_lanes: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first bounce's (cont, ints) for ``n_lanes`` camera rays
    (``render_pixels_kernel``'s lane set-up, pallas_grad.py:931-950), as
    the gradient bounce and the sorted wavefront start their lanes: lanes
    padded to a multiple of 1,024, padding lanes dead with direction
    (0, 0, 1), throughput 1, radiance 0, lane id = index.  ``rays`` (a
    camera's ``Rays``) may hold tensors or numpy arrays."""
    n = -(-n_lanes // TILE) * TILE

    def lanes(x, width):
        x = torch.as_tensor(x, dtype=_F32, device=device)
        if tuple(x.shape) != ((n_lanes, width) if width else (n_lanes,)):
            raise ValueError(f"rays must hold {n_lanes} lanes, got "
                             f"{tuple(x.shape)}")
        return x

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((n - n_lanes,), fill, dtype=_F32,
                                        device=device)])

    origin = lanes(rays.origin, 3)
    direction = lanes(rays.direction, 3)
    one = torch.ones(n, dtype=_F32, device=device)
    zero = torch.zeros(n, dtype=_F32, device=device)
    cont = torch.stack([
        pad(origin[:, 0]), pad(origin[:, 1]), pad(origin[:, 2]),
        pad(direction[:, 0]), pad(direction[:, 1]),
        pad(direction[:, 2], fill=1.0), pad(lanes(rays.time, 0)),
        one, one, one, zero, zero, zero,
    ])
    lane_id = torch.arange(n, dtype=torch.int32, device=device)
    ints = torch.stack([(lane_id < n_lanes).to(torch.int32),
                        torch.zeros_like(lane_id), lane_id])
    return cont, ints


def bounce_lanes(tbl, tris, state, lane, salt, bounce, max_depth, background,
                 *, lit: Lit = Lit(), from_diffuse=None, tally=None,
                 flat: bool = True, cull: bool = True,
                 groups: Optional[torch.Tensor] = None):
    """One bounce of live lanes in ``_bounce_core``'s order (:1358-1430):
    the sweep; the volume event; next-event estimation with its shadow
    sweep (from ``t_init`` = the light's distance less 0.1%, counted in
    ``tally`` as the main sweep is); then :func:`shade`.  ``state``: the
    13-tuple; ``lane``: the lanes' hashed ids; ``from_diffuse``: the
    previous bounce's diffuse flags (with NEE).  Both triangle sweeps go
    down the table's hierarchy unless ``flat`` (K1 sweeps flat, K3
    descends: :func:`nearest_triangle`); ``cull`` False makes triangles
    two-sided.  Both sphere sweeps test every row, or with ``groups``,
    the boxes from :func:`sphere_groups` (K1), only the groups each ray
    enters (:func:`nearest_sphere_culled`,
    counted in ``tally``).  Returns (new 13-tuple, alive code, bounce)."""
    ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb = state

    def spheres(*ray, t_init=None):
        if groups is None:
            return nearest_sphere(tbl, *ray, t_init=t_init)
        return nearest_sphere_culled(tbl, groups, *ray, t_init=t_init,
                                     tally=tally)

    a = dx * dx + dy * dy + dz * dz
    npad = tbl.shape[0]
    best_t, best_k = spheres(ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a)
    if tris is not None:
        best_t, best_k = nearest_triangle(
            tris, ox, oy, oz, dx, dy, dz, best_t, best_k, npad, flat=flat,
            cull=cull, tally=tally)
    w, tri = winners(tbl, tris, best_t, best_k,
                     cols=TBL_COLS if lit.checker else 13)
    draws = draw_scatter(lane, salt)
    alive = torch.ones_like(best_t, dtype=torch.bool)
    v_event = volume_event(state, draws, lane, salt, best_t, lit)
    basics = hit_basics(state, w, best_t, tri=tri, checker=lit.checker,
                        cull=cull)
    if lit.nee_kinds:
        nee_us = (hash_uniform(lane, salt, 8), hash_uniform(lane, salt, 9),
                  hash_uniform(lane, salt, 10))
        (px, py, pz), (ldx, ldy, ldz), thresh, contrib, nee_act = nee_contrib(
            state, basics, alive, bounce, max_depth, nee_us, lit, v_event)
        sub = torch.nonzero(nee_act).flatten()
        if tally is not None:
            tally[2] += sub.numel()
        if sub.numel():
            sx, sy, sz, lx, ly, lz = (v[sub] for v in (px, py, pz, ldx, ldy,
                                                       ldz))
            la = lx * lx + ly * ly + lz * lz
            s_t, s_k = spheres(sx, sy, sz, lx, ly, lz, tm[sub], la, 1.0 / la,
                               t_init=thresh[sub])
            if tris is not None:
                s_t, _ = nearest_triangle(tris, sx, sy, sz, lx, ly, lz, s_t,
                                          s_k, npad, flat=flat, cull=cull,
                                          tally=tally)
            add = s_t >= thresh[sub]
            rr, rg, rb = (
                ch.index_put((sub,), ch[sub] + torch.where(add, c[sub], 0.0))
                for ch, c in zip((rr, rg, rb), contrib))
            state = (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb)
    return shade(state, w, draws, best_t, alive, bounce, max_depth,
                 background, tri=tri, basics=basics, lit=lit,
                 from_diffuse=from_diffuse, v_event=v_event,
                 rr_u=hash_uniform(lane, salt, 11) if lit.roulette else None)


def volume_event(state, draws, lane, salt, best_t, lit: Lit):
    """The free-flight event of ``lit``'s media before the surface at
    ``best_t`` (one uniform per volume at salts 16 on), or None without
    media: (v_hit, t_v, albedo rgb, the isotropic direction xyz), as
    :func:`nee_contrib` and :func:`shade` take it."""
    if not lit.vol_kinds:
        return None
    us = [hash_uniform(lane, salt, 16 + j) for j in range(len(lit.vol_kinds))]
    v_hit, v_t, (v_ar, v_ag, v_ab) = sample_volume_event(
        lit.volumes(), lit.vol_kinds, us, *state[:6], best_t)
    uvx, uvy, uvz, _choice = draws
    return (v_hit, v_t, v_ar, v_ag, v_ab, uvx * 0.5, uvy * 0.5, uvz * 0.5)


def _sphere_roots(rows, ox, oy, oz, dx, dy, dz, tm, a, inv_a):
    """(disc > 0, near root, far root) of rays (o, d, tm) against sphere
    table rows, broadcast: a block of rows against (L, 1) rays, or each
    lane's winner row against (L,) rays.  Where disc <= 0 the roots read
    the root of 1, so no NaN reaches a gradient."""
    ocx = ox - (rows[..., _C0X] + tm * rows[..., _DCX])
    ocy = oy - (rows[..., _C0Y] + tm * rows[..., _DCY])
    ocz = oz - (rows[..., _C0Z] + tm * rows[..., _DCZ])
    r_ = rows[..., _R]
    h = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
    disc = h * h - a * cc
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    return pos, (-h - sq) * inv_a, (-h + sq) * inv_a


def nearest_sphere(tbl, ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_init=None):
    """(best_t, best_k) over the whole table, block by block, with the
    JAX kernel's tie rule (``_sphere_block_sweep``, :558-588): inside a
    block the first minimal t wins, across blocks only a strictly
    smaller t replaces the winner.  ``t_init`` (the shadow sweep's
    threshold) seeds best_t in place of BIG."""
    best_t = torch.full_like(ox, BIG) if t_init is None else t_init.clone()
    best_k = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    o3x, o3y, o3z = ox[:, None], oy[:, None], oz[:, None]
    d3x, d3y, d3z = dx[:, None], dy[:, None], dz[:, None]
    tm3, a3, inva3 = tm[:, None], a[:, None], inv_a[:, None]
    for b0 in range(0, tbl.shape[0], SPHERE_BLOCK):
        pos, near, far = _sphere_roots(tbl[b0:b0 + SPHERE_BLOCK], o3x, o3y,
                                       o3z, d3x, d3y, d3z, tm3, a3, inva3)
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


def box_entered(box, org, inv, best_t, idx):
    """Lanes of ``idx`` whose ray (origins ``org``, inverse directions
    ``inv``, each an xyz triple of (L,) tensors) enters ``box`` (8 floats:
    min xyz, max xyz) inside [T_MIN, best_t] (``_box_enter_exit``, :444;
    fmin / fmax ignore a NaN from 0 * inf, as the kernels' fminf / fmaxf
    do)."""
    return idx[box_enters(box, [o[idx] for o in org], [i[idx] for i in inv],
                          best_t[idx])]


def box_enters(box, org, inv, best_t) -> torch.Tensor:
    """:func:`box_entered` as a mask over every lane of ``org``."""
    t0 = [(box[a] - org[a]) * inv[a] for a in range(3)]
    t1 = [(box[3 + a] - org[a]) * inv[a] for a in range(3)]
    lo = [torch.fmin(p, q) for p, q in zip(t0, t1)]
    hi = [torch.fmax(p, q) for p, q in zip(t0, t1)]
    t_min = torch.tensor(T_MIN, dtype=_F32, device=best_t.device)
    enter = torch.fmax(torch.fmax(lo[0], lo[1]), torch.fmax(lo[2], t_min))
    exit_ = torch.fmin(torch.fmin(hi[0], hi[1]), torch.fmin(hi[2], best_t))
    return exit_ > enter


def nearest_sphere_culled(tbl, groups: torch.Tensor, ox, oy, oz, dx, dy,
                          dz, tm, a, inv_a, t_init=None,
                          tally: Optional[list] = None):
    """:func:`nearest_sphere` over the row groups each ray enters (K1's
    cull, ``nearest_sphere_culled`` in ``csrc/bounce.cuh``), ``groups``
    the boxes from :func:`sphere_groups`: group by
    group in table order, a lane slab-tests the group's box with its
    current best t and takes the group's rows only where its ray enters
    the box, the first minimal t winning inside a group and only a
    strictly smaller one across groups.  Every row's swept bound lies in
    its group's box, so (best_t, best_k) is the brute-force sweep's, bit
    for bit.  Vectorised over the lanes: each row's hit t (the kernel's
    row test before its compare with the best t) and each group's first
    minimum are computed for every lane up front, then the groups are
    walked in order.  ``tally`` (a list of at least 5 counts) gets the
    box tests added to entry 3 and the rows swept to entry 4, as the
    kernel counts them."""
    n, w = ox.shape[0], SPHERE_GROUP
    best_t = torch.full_like(ox, BIG) if t_init is None else t_init.clone()
    best_k = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    if not tbl.shape[0]:  # no spheres: no groups
        return best_t, best_k
    o3x, o3y, o3z = ox[:, None], oy[:, None], oz[:, None]
    d3x, d3y, d3z = dx[:, None], dy[:, None], dz[:, None]
    tm3, a3, inva3 = tm[:, None], a[:, None], inv_a[:, None]
    g_t, g_k = [], []
    for b0 in range(0, tbl.shape[0], SPHERE_BLOCK):
        pos, near, far = _sphere_roots(tbl[b0:b0 + SPHERE_BLOCK], o3x, o3y,
                                       o3z, d3x, d3y, d3z, tm3, a3, inva3)
        v = torch.where(near >= T_MIN, near, far)
        t = torch.where(pos & (v >= T_MIN), v, BIG)
        t, k = t.view(n, -1, w).min(dim=2)
        g_t.append(t)
        g_k.append(k)
    g_t, g_k = torch.cat(g_t, dim=1), torch.cat(g_k, dim=1)
    org, inv = (ox, oy, oz), (1.0 / dx, 1.0 / dy, 1.0 / dz)
    rows = torch.zeros((), dtype=torch.int64, device=ox.device)
    for g, box in enumerate(groups.tolist()):
        enters = box_enters(box, org, inv, best_t)
        rows += enters.sum()
        upd = enters & (g_t[:, g] < best_t)
        best_t = torch.where(upd, g_t[:, g], best_t)
        best_k = torch.where(upd, g_k[:, g] + g * w, best_k)
    if tally is not None:
        tally[3] += n * groups.shape[0]
        tally[4] += int(rows) * w
    return best_t, best_k


def nearest_triangle(tris: TriTable, ox, oy, oz, dx, dy, dz, best_t, best_k,
                     base: int, *, flat: bool = False, cull: bool = True,
                     tally: Optional[list] = None):
    """Go on with a sweep's (best_t, best_k) over the triangle table
    (``_sweep_all``'s triangle half, :612-835): Moller-Trumbore in the
    determinant form of ``_mt_rows`` with the backface cull (without
    ``cull``, either side where ``|det|`` clears the floor, :676-679),
    winner ids ``base + row``.  Returns new (best_t, best_k).

    Each lane slab-tests a box with its current best_t and goes down only
    where its ray enters it: hyper-blocks, then their super-blocks, then
    their blocks, as fixed-order nested loops over the levels the table
    has (``flat`` tests every block box and skips the upper levels, as
    K1 does).  Inside a block the first minimal t wins, across blocks
    only a strictly smaller one: the JAX sweep's tie rule.  ``tally``,
    a list [box tests, triangle tests], gets the work added to it, as
    the kernels count it (padding rows past ``tris.count`` are not
    tested)."""
    best_t, best_k = best_t.clone(), best_k.clone()
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    org = (ox, oy, oz)
    tb = tris.block
    if flat or not tris.n_super:
        levels = [tris.boxes.tolist()]
    elif tris.n_hyper:
        levels = [tris.hypers.tolist(), tris.supers.tolist(),
                  tris.boxes.tolist()]
    else:
        levels = [tris.supers.tolist(), tris.boxes.tolist()]

    def entered(box, idx):
        if tally is not None:
            tally[0] += idx.numel()
        return box_entered(box, org, inv, best_t, idx)

    def sweep(b, idx):
        rows = min(tb, tris.count - b * tb)
        if rows <= 0:
            return
        if tally is not None:
            tally[1] += idx.numel() * rows
        blk = tris.tbl[b * tb:b * tb + rows]
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) = (
            blk[:, c][None, :] for c in range(9))
        nxb = e1y * e2z - e1z * e2y
        nyb = e1z * e2x - e1x * e2z
        nzb = e1x * e2y - e1y * e2x
        # Bounded pair temporaries: (chunk, rows) float32 each.
        chunk = 1 << 16
        for start in range(0, idx.numel(), chunk):
            sub = idx[start:start + chunk]
            ux, uy, uz = ox[sub, None], oy[sub, None], oz[sub, None]
            vx, vy, vz = dx[sub, None], dy[sub, None], dz[sub, None]
            det = -(vx * nxb + vy * nyb + vz * nzb)
            det_ok = (det if cull else det.abs()) >= _DET_MIN
            invdet = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0),
                                 0.0)
            aox, aoy, aoz = ux - v0x, uy - v0y, uz - v0z
            daox = aoy * vz - aoz * vy
            daoy = aoz * vx - aox * vz
            daoz = aox * vy - aoy * vx
            u = (e2x * daox + e2y * daoy + e2z * daoz) * invdet
            v = -(e1x * daox + e1y * daoy + e1z * daoz) * invdet
            tt = (aox * nxb + aoy * nyb + aoz * nzb) * invdet
            bt_sub = best_t[sub]
            ok = (det_ok & (tt >= T_MIN) & (tt <= bt_sub[:, None])
                  & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
            t_pair = torch.where(ok, tt, BIG)
            bk = torch.argmin(t_pair, dim=1)
            bt = torch.gather(t_pair, 1, bk[:, None])[:, 0]
            upd = bt < bt_sub
            best_t[sub] = torch.where(upd, bt, bt_sub)
            best_k[sub] = torch.where(upd, bk + base + b * tb, best_k[sub])

    def descend(level, first, count, idx):
        for i in range(first, first + count):
            sub = entered(levels[level][i], idx)
            if not sub.numel():
                continue
            if level + 1 < len(levels):
                descend(level + 1, i * SUPER, SUPER, sub)
            else:
                sweep(i, sub)

    lanes = torch.arange(ox.numel(), device=ox.device)
    descend(0, 0, len(levels[0]), lanes)
    return best_t, best_k


def winners(tbl, tris: Optional[TriTable], best_t, best_k, cols: int = 13):
    """The winner rows :func:`shade` takes: (sphere rows (L, cols), 16
    columns with textures, and for a scene with triangles (triangle rows
    (L, 15), is_tri) else None).  Each is 0 where the winner is of the
    other kind or nothing was hit, as the JAX sweep's deferred winner
    fetch leaves them."""
    if tris is None:
        return torch.where((best_t < BIG)[:, None], tbl[best_k, :cols],
                           0.0), None
    npad = tbl.shape[0]
    hit = best_t < BIG
    is_tri = best_k >= npad
    rows = torch.zeros((best_k.numel(), cols), dtype=_F32,
                       device=best_k.device)
    if npad:
        rows = torch.where((hit & ~is_tri)[:, None],
                           tbl[best_k.clamp(max=npad - 1), :cols], 0.0)
    trows = torch.where((hit & is_tri)[:, None],
                        tris.tbl[(best_k - npad).clamp(min=0), :TRI_PARAMS],
                        0.0)
    return rows, (trows, is_tri)


class Basics(NamedTuple):
    """The hit record (``_hit_basics``'s tuple)."""
    hit: torch.Tensor
    t_hit: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    front: torch.Tensor
    alr: torch.Tensor
    alg: torch.Tensor
    alb: torch.Tensor
    fuzz: torch.Tensor
    ir: torch.Tensor
    kind: torch.Tensor
    a: torch.Tensor


def hit_basics(state, w, best_t, tri=None, checker=False,
               cull=True) -> Basics:
    """The hit record re-derived from the winner's parameters
    (``_hit_basics``, :891-995): t (the sphere's root nearer the sweep's
    best_t; a triangle's (ao . n) / det), the point, the unit normal
    against the ray (a triangle's is the unit cross(e1, e2), always
    front-facing, as in the reference, src/common-model.cpp:122; without
    ``cull`` it is turned toward the ray, :965-968), and the winner's
    material.  ``checker`` (``w`` then has 16 columns)
    turns the CHECKER and NOISE albedos into the texture's value at the
    point.  Without ``tri`` no triangle operation runs, so sphere scenes
    shade exactly as before."""
    (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
    (c0x, c0y, c0z, dcx, dcy, dcz, r_, alr, alg, alb, fuzz, ir,
     kind) = w[:, :13].unbind(1)
    hit = best_t < BIG
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a

    # ---- t re-derived from the winner's parameters -------------------
    _pos, near, far = _sphere_roots(w, ox, oy, oz, dx, dy, dz, tm, a, inv_a)
    root_is_near = (near - best_t).abs() <= (far - best_t).abs()
    t_hit = torch.where(hit, torch.where(root_is_near, near, far), 1.0)
    if tri is not None:
        trows, is_tri = tri
        (tv0x, tv0y, tv0z, te1x, te1y, te1z, te2x, te2y, te2z, talr, talg,
         talb, tfuzz, tir, tkind) = trows.unbind(1)
        tnxb = te1y * te2z - te1z * te2y
        tnyb = te1z * te2x - te1x * te2z
        tnzb = te1x * te2y - te1y * te2x
        tdet = -(dx * tnxb + dy * tnyb + dz * tnzb)
        tdet_safe = torch.where(tdet.abs() > _EPS12, tdet, 1.0)
        t_tri = ((ox - tv0x) * tnxb + (oy - tv0y) * tnyb
                 + (oz - tv0z) * tnzb) / tdet_safe
        t_hit = torch.where(hit & is_tri, t_tri, t_hit)
        alr = torch.where(is_tri, talr, alr)
        alg = torch.where(is_tri, talg, alg)
        alb = torch.where(is_tri, talb, alb)
        fuzz = torch.where(is_tri, tfuzz, fuzz)
        ir = torch.where(is_tri, tir, ir)
        kind = torch.where(is_tri, tkind, kind)
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
    if tri is not None:
        # 1/sqrt where JAX has rsqrt: CUDA's rsqrtf is not IEEE, and the
        # kernels and this version must round alike.
        tl2 = tnxb * tnxb + tnyb * tnyb + tnzb * tnzb
        tl_ok = tl2 > 0.0
        tinv = torch.where(tl_ok, 1.0 / torch.sqrt(torch.where(tl_ok, tl2, 1.0)),
                           0.0)
        tnx, tny, tnz = tnxb * tinv, tnyb * tinv, tnzb * tinv
        if not cull:
            tflip = torch.where(dx * tnx + dy * tny + dz * tnz < 0.0, 1.0,
                                -1.0)
            tnx, tny, tnz = tnx * tflip, tny * tflip, tnz * tflip
        nx = torch.where(is_tri, tnx, nx)
        ny = torch.where(is_tri, tny, ny)
        nz = torch.where(is_tri, tnz, nz)
        front = is_tri | front
    if checker:
        # Textured albedos (spheres only): the second colour in columns
        # 13-15, the scale in the ir column.
        al2r, al2g, al2b = w[:, 13], w[:, 14], w[:, 15]
        sp = torch.sin(ir * px) * torch.sin(ir * py) * torch.sin(ir * pz)
        odd = (kind == _CHECKER) & (sp < 0.0)
        alr = torch.where(odd, al2r, alr)
        alg = torch.where(odd, al2g, alg)
        alb = torch.where(odd, al2b, alb)
        noise = kind == _NOISE
        mt = marble_t(px, py, pz, ir)
        alr = torch.where(noise, alr + (al2r - alr) * mt, alr)
        alg = torch.where(noise, alg + (al2g - alg) * mt, alg)
        alb = torch.where(noise, alb + (al2b - alb) * mt, alb)
    return Basics(hit, t_hit, px, py, pz, nx, ny, nz, front, alr, alg, alb,
                  fuzz, ir, kind, a)


def _is_diffuse(kind):
    """Lambertian, checker or noise: the kinds NEE samples from."""
    return (kind == 0.0) | (kind == _CHECKER) | (kind == _NOISE)


def nee_contrib(state, basics: Basics, alive, bounce, max_depth, nee_us,
                lit: Lit, v_event=None):
    """Next-event estimation short of the shadow ray's visibility
    (``_nee_contrib``, :1244-1326): the light sample from the hit point
    (or from the volume event's point, with the isotropic phase), the
    MIS balance weight against the scatter strategy, the shadow ray's
    medium transmittance.  Returns ((px, py, pz), (ldx, ldy, ldz),
    thresh, (cr, cg, cb), nee_act): the shadow ray, the distance it must
    reach, and the contribution to add where it does."""
    (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, _rr, _rg, _rb) = state
    b = basics
    px, py, pz = b.px, b.py, b.pz
    pick, u1, u2 = nee_us
    v_act = None
    if v_event is not None:
        v_act = alive & v_event[0] & (bounce < max_depth)
        px = torch.where(v_act, ox + v_event[1] * dx, px)
        py = torch.where(v_act, oy + v_event[1] * dy, py)
        pz = torch.where(v_act, oz + v_event[1] * dz, pz)
    ldx, ldy, ldz, t_l, (w0, w1, w2), l_pdf = sample_light_dirs(
        lit.lights(), lit.nee_kinds, pick, u1, u2, px, py, pz, tm)
    nee_act = alive & b.hit & (bounce < max_depth) & _is_diffuse(b.kind)
    if v_event is not None:
        nee_act = (nee_act & ~v_event[0]) | v_act
    thresh = t_l * _SHADOW_FRAC
    cos_t = torch.clamp(b.nx * ldx + b.ny * ldy + b.nz * ldz, min=0.0)
    phase = cos_t * _INV_PI
    factor = cos_t
    nar, nag, nab = b.alr, b.alg, b.alb
    if v_event is not None:
        phase = torch.where(v_act, _QUARTER_INV_PI, phase)
        factor = torch.where(v_act, 0.25, factor)
        nar = torch.where(v_act, v_event[2], nar)
        nag = torch.where(v_act, v_event[3], nag)
        nab = torch.where(v_act, v_event[4], nab)
    w_l = l_pdf / torch.clamp(l_pdf + phase, min=_EPS12)
    if lit.vol_kinds:
        factor = factor * volume_transmittance(
            lit.volumes(), lit.vol_kinds, px, py, pz, ldx, ldy, ldz, t_l)
    cw = factor * w_l
    contrib = (tpr * nar * w0 * cw, tpg * nag * w1 * cw, tpb * nab * w2 * cw)
    return (px, py, pz), (ldx, ldy, ldz), thresh, contrib, nee_act


def shade(state, w, draws, best_t, alive, bounce, max_depth, background,
          tri=None, *, basics: Optional[Basics] = None, lit: Lit = Lit(),
          from_diffuse=None, v_event=None, rr_u=None):
    """The differentiable half of a bounce (``_shade_pure``,
    :998-1222): winner rows -> new state.

    ``state`` is the 13-tuple (ox oy oz dx dy dz tm tpr tpg tpb rr rg rb),
    ``w`` the sphere winner rows from :func:`winners`, ``draws`` from
    :func:`draw_scatter`, ``best_t`` the sweep's t, ``alive`` a bool mask
    and ``bounce`` the int32 bounce counts; ``tri``, for a scene with triangles, is (triangle winner rows
    (L, 15), is_tri) from :func:`winners`; ``basics`` the hit record if
    it was already taken (:func:`hit_basics`).  Returns (new 13-tuple
    with ``tm`` passed through, ``can``, new ``bounce``).  Dead lanes pass
    through; a live miss adds throughput * background and retires; a live
    hit at ``max_depth`` retires; every other live hit scatters.

    The lit features (``lit``; all off by default, and then no lit
    operation runs): an EMISSIVE hit adds throughput * emit (weighted
    against the light sample with ``from_diffuse``, the previous
    bounce's diffuse flags, under NEE) and retires, at any depth;
    ``v_event`` (v_hit, v_t, albedo rgb, direction xyz) overrides the
    surface and the sky with a volume scatter; ``rr_u`` plays Russian
    roulette past ``RR_START`` scatters.  Under NEE ``can`` is the alive
    code (0 dead, 1 alive, 2 alive after a diffuse or volume scatter).

    The intersection t is re-derived from the winner's parameters, so
    autograd through this function gives the exact geometry gradient.
    Every branch that is computed and then not selected is guarded
    ("safe where"), so it puts no NaN into the gradient."""
    (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
    uvx, uvy, uvz, choice = draws
    use_sky, bg = background_args(background)
    if basics is None:
        basics = hit_basics(state, w, best_t, tri=tri, checker=lit.checker)
    (hit, t_hit, px, py, pz, nx, ny, nz, front, alr, alg, alb, fuzz, ir,
     kind, a) = basics

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

    if v_event is not None:
        v_hit = v_event[0] & alive
        v_can = v_hit & (bounce < max_depth)
        # The free-flight point on the incoming ray.
        vpx = ox + v_event[1] * dx
        vpy = oy + v_event[1] * dy
        vpz = oz + v_event[1] * dz
    else:
        v_hit = v_can = torch.zeros_like(alive)

    # ---- background for live lanes that missed ----------------------
    missed = alive & ~hit & ~v_hit
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
    can = alive & hit & (bounce < max_depth) & ~v_hit
    if lit.emissive:
        # An emissive hit adds throughput * emit and retires the lane,
        # whatever its depth; under NEE a diffuse-scattered ray's hit is
        # weighted against the light sample (balance heuristic, the
        # scatter pdf recovered as |d| / (2 pi) from the raw n + unit
        # direction).
        is_emis = kind == _EMISSIVE
        lit_hit = alive & hit & is_emis & ~v_hit
        w_emit = 1.0
        if from_diffuse is not None:
            p_l = light_pdf_toward(lit.lights(), lit.nee_kinds, ox, oy, oz,
                                   dx, dy, dz, t_hit, tm)
            p_b = torch.sqrt(a) * _HALF_INV_PI
            w_emit = torch.where(from_diffuse,
                                 p_b / torch.clamp(p_b + p_l, min=_EPS12), 1.0)
        rr = rr + torch.where(lit_hit, tpr * alr * w_emit, 0.0)
        rg = rg + torch.where(lit_hit, tpg * alg * w_emit, 0.0)
        rb = rb + torch.where(lit_hit, tpb * alb * w_emit, 0.0)
        can = can & ~is_emis
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
    if v_event is not None:
        # A volume scatter: to the free-flight point, the isotropic
        # direction, the medium's albedo; one bounce of the budget.
        ox = torch.where(v_can, vpx, ox)
        oy = torch.where(v_can, vpy, oy)
        oz = torch.where(v_can, vpz, oz)
        dx = torch.where(v_can, v_event[5], dx)
        dy = torch.where(v_can, v_event[6], dy)
        dz = torch.where(v_can, v_event[7], dz)
        tpr = torch.where(v_can, tpr * v_event[2], tpr)
        tpg = torch.where(v_can, tpg * v_event[3], tpg)
        tpb = torch.where(v_can, tpb * v_event[4], tpb)
        bounce = bounce + v_can.to(torch.int32)
    if rr_u is not None:
        # Russian roulette on the post-increment bounce count: a lane past
        # RR_START scatters survives with p = clamp(max throughput
        # channel, RR_PMIN, 1), boosted by 1 / p.
        p = torch.clamp(torch.maximum(torch.maximum(tpr, tpg), tpb),
                        RR_PMIN, 1.0)
        consider = (can | v_can) & (bounce > RR_START)
        kill = consider & (rr_u >= p)
        boost = torch.where(consider & ~kill, 1.0 / p, 1.0)
        tpr, tpg, tpb = tpr * boost, tpg * boost, tpb * boost
        can = can & ~kill
        v_can = v_can & ~kill
    if from_diffuse is not None:
        can = can.to(torch.int32) * torch.where(_is_diffuse(kind), 2, 1)
        can = torch.where(v_can, 2, can)
    elif v_event is not None:
        can = can | v_can
    return ((ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb), can,
            bounce)

