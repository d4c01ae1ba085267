"""The plain lit path tracer: the Cornell box's semantics, in plain
PyTorch, for the lit cells' checks.

The bounce is the books' (*The Next Week*'s emissive quad light, *The
Rest of Your Life*'s light sampling) as the port's semantics round it,
in the order :mod:`.tracer` keeps for the unlit bounce:

* a hit on an emissive material adds throughput x emission and ends the
  path, at any depth; after a diffuse scatter the emission is weighted
  by the balance heuristic against the light sample, with the scatter's
  pdf taken as |d| / (2 pi) of the raw n + unit direction, and the
  light's as the sum of the solid-angle pdfs over K of the lights whose
  first hit along d lies within 1e-3 max(t, 1) of the path's hit; after
  anything else it is weighted 1;
* next-event estimation at every diffuse hit below the depth cap: draws
  8, 9 and 10 pick a light row and a point on its triangle (the square
  root warp), the shadow ray from the hit point toward it is swept
  against every sphere and triangle up to ``t_l (1 - 1e-3)``, and where
  nothing is hit before that, throughput x albedo x emission x the
  geometry term x cos x the light's balance weight is added;
* the lamp's triangles are one-sided, as every triangle is: they shine
  on the side their winding faces, and rays from behind pass them;
* a miss adds throughput x the flat background (black) and ends.

The nearest hit is :func:`.tracer.nearest`'s, every triangle tested,
independent of the program.  Departures from the books: the sphere is a mirror; light
sampling is the port's two-sample estimator (one light sample and one
scatter sample a diffuse hit, each balance-weighted), where *The Rest of
Your Life* draws one sample from a mixture pdf; the materials are
Lambertian, metal and emissive only (no glass, no textures, no media,
no sphere lights); the first shadow-ray hit is any surface, lamp
included, strictly before the threshold.

Two integrators, as :mod:`.integrate` has them:

* :func:`pool_rows_lit`, the whole-frame render's work pool replayed
  for given tile rows (the schedule of :func:`.integrate.pool_rows`,
  with the alive code 2 after a diffuse scatter);
* :func:`trace_lanes_lit`, the gradient path's lanes, recording what
  each bounce adds so the train check can take the radiance as a
  product of albedo rows (:func:`radiance`): the paths do not depend on
  the albedos, the lamp's row included.

Precision: float32 with TF32 off (:func:`float32_only`); the control
runs the same code in bfloat16.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .camera import counter_ray, generator_rays, make_camera, packed
from .integrate import (
    LANES, POOL_CHUNK, POOL_K, TILE, TILE_ROWS, _flush, pool_pixels,
)
from .rng import M32, lane_hash, scatter_draws, step_salt, uniform
from .tracer import (
    BIG, EPS12, LAMBERTIAN, METAL, Hit, Scene, _triangle_t, build_scene,
    nearest_sphere,
)

EMISSIVE = 3
#: The shadow ray's reach: the light's distance less 0.1%.
SHADOW_FRAC = float(np.float32(1.0 - 1e-3))
PI = float(np.float32(np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
HALF_INV_PI = float(np.float32(0.5 / np.pi))


@contextlib.contextmanager
def float32_only():
    """TF32 off for matrix products and convolutions while open."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class LitScene(NamedTuple):
    """The tracer's scene (its emissive rows built as Lambertian, which
    its sweep does not read), each material's true kind, the flat
    background, and the light rows: each emissive triangle's v0, e1,
    e2 and area, and its material."""
    base: Scene
    kind: torch.Tensor
    background: tuple
    lv0: torch.Tensor
    le1: torch.Tensor
    le2: torch.Tensor
    area: torch.Tensor
    light_mat: torch.Tensor


def build_lit_scene(inputs: dict, device, dtype) -> LitScene:
    """The reference's lit scene from the benchmark's inputs, cast once
    to ``dtype``; the light rows are the emissive triangles in index
    order, each area half the length of cross(e1, e2)."""
    kinds = np.asarray(inputs["materials"]["kind"], np.int64)
    if not set(kinds.tolist()) <= {LAMBERTIAN, METAL, EMISSIVE}:
        raise NotImplementedError(f"material kinds {sorted(set(kinds))}: "
                                  f"the lit reference has Lambertian, metal "
                                  f"and emissive only")
    sph_mat = np.asarray(inputs["spheres"]["material"], np.int64)
    if (kinds[sph_mat] == EMISSIVE).any():
        raise NotImplementedError("the lit reference has triangle lights "
                                  "only")
    background = inputs.get("background", "sky")
    if isinstance(background, str):
        raise NotImplementedError("the lit reference renders a flat "
                                  "background only")
    mats = dict(inputs["materials"])
    mats["kind"] = np.where(kinds == EMISSIVE, LAMBERTIAN, kinds)
    base = build_scene({**inputs, "materials": mats, "background": "sky"},
                       device, dtype)
    tri_mat = np.asarray(inputs["triangles"]["material"], np.int64)
    ids = torch.as_tensor(np.nonzero(kinds[tri_mat] == EMISSIVE)[0],
                          device=device)
    if not ids.numel():
        raise ValueError("the lit reference needs a light")
    nb = base.nb[ids]
    area = 0.5 * torch.sqrt(nb[:, 0] * nb[:, 0] + nb[:, 1] * nb[:, 1]
                            + nb[:, 2] * nb[:, 2])
    return LitScene(base, torch.as_tensor(kinds, device=device),
                    tuple(float(x) for x in background), base.v0[ids],
                    base.e1[ids], base.e2[ids], area, base.tri_mat[ids])


def nearest(S: Scene, o, d, tm, a, inv_a, chunk: int = 1 << 17) -> Hit:
    """:func:`.tracer.nearest` for a scene of a few triangles: every
    sphere and every triangle tested (the same tests, without the
    triangle groups, which only cull); the nearest t wins, a sphere on
    equal t, then the lower index."""
    t_s, k_s = nearest_sphere(S, o, d, tm, a, inv_a, chunk)
    every = torch.arange(S.tri_mat.numel(), device=t_s.device)[None, :]
    t_t = torch.empty_like(t_s)
    k_t = torch.empty_like(k_s)
    for s in range(0, t_s.numel(), chunk):
        sl = slice(s, s + chunk)
        tt = _triangle_t(S, every, tuple(v[sl, None] for v in o),
                         tuple(v[sl, None] for v in d), t_s[sl, None])
        t_t[sl], k_t[sl] = tt.min(dim=1)
    is_tri = t_t < t_s
    return Hit(torch.where(is_tri, t_t, t_s), is_tri,
               torch.where(is_tri, k_t, k_s))


def _light_normal(e1, e2):
    """A light's unnormalised normal cross(e1, e2) and its length (its
    square floored at 1e-24)."""
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    return nx, ny, nz, torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                              min=1e-24))


def sample_light(L: LitScene, pick, u1, u2, px, py, pz):
    """A point on a light picked by ``pick``, from the shading points ->
    (unit direction xyz, distance, geometry term x K, the strategy's
    solid-angle pdf, the light's material)."""
    n = L.area.numel()
    k = torch.clamp((pick * n).to(torch.int32), max=n - 1).long()
    v0x, v0y, v0z = L.lv0[k].unbind(1)
    e1, e2 = L.le1[k], L.le2[k]
    e1x, e1y, e1z = e1.unbind(1)
    e2x, e2y, e2z = e2.unbind(1)
    area = L.area[k]
    su = torch.sqrt(torch.clamp(u1, min=1e-12))
    bu = 1.0 - su
    bv = u2 * su
    tox = v0x + bu * e1x + bv * e2x - px
    toy = v0y + bu * e1y + bv * e2y - py
    toz = v0z + bu * e1z + bv * e2z - pz
    d2 = tox * tox + toy * toy + toz * toz
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    inv_d = 1.0 / d
    sx, sy, sz = tox * inv_d, toy * inv_d, toz * inv_d
    nx, ny, nz, nlen = _light_normal(e1, e2)
    cos_a = -(sx * nx + sy * ny + sz * nz) / nlen
    ok = cos_a > 1e-6
    geo = torch.where(ok, cos_a * area * n / (PI * torch.clamp(d2, min=1e-12)),
                      0.0)
    pdf = torch.where(ok, d2 / torch.clamp(cos_a * area * n, min=1e-12), 0.0)
    return (sx, sy, sz), torch.clamp(d, min=1e-4), geo, pdf, L.light_mat[k]


def light_pdf_toward(L: LitScene, o, d, t_hit):
    """The light strategy's pdf of the direction ``d`` from ``o`` whose
    path hits at ``t_hit`` (in units of the raw ``d``): the sum, in light
    order, of the pdfs over K of the lights whose first hit along ``d``
    lies within 1e-3 max(t, 1) of the hit (front sides only)."""
    n = L.area.numel()
    dx, dy, dz = d
    dlen = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    inv_l = 1.0 / dlen
    # Rays down the rows, lights across the columns.
    dx, dy, dz = ((v * inv_l)[:, None] for v in d)
    ox, oy, oz = (v[:, None] for v in o)
    t_hit = (t_hit * dlen)[:, None]
    v0x, v0y, v0z = L.lv0.unbind(1)
    e1x, e1y, e1z = L.le1.unbind(1)
    e2x, e2y, e2z = L.le2.unbind(1)
    px_ = dy * e2z - dz * e2y
    py_ = dz * e2x - dx * e2z
    pz_ = dx * e2y - dy * e2x
    det = e1x * px_ + e1y * py_ + e1z * pz_
    inv = 1.0 / torch.where(det.abs() < 1e-12, 1.0, det)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px_ + sy * py_ + sz * pz_) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t_k = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ((det >= 1e-6) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t_k > 0.0))
    nx, ny, nz, nlen = _light_normal(L.le1, L.le2)
    cos_a = -(dx * nx + dy * ny + dz * nz) / nlen
    pdf_k = (t_k * t_k) / torch.clamp(cos_a * L.area * n, min=1e-12)
    match = ok & ((t_k - t_hit).abs() <= 1e-3 * torch.clamp(t_hit, min=1.0))
    terms = torch.where(match, pdf_k, 0.0)
    pdf = torch.zeros_like(t_hit[:, 0])
    for k in range(n):
        pdf = pdf + terms[:, k]
    return pdf


class Added(NamedTuple):
    """What a bounce adds to each lane's radiance, as a product of albedo
    rows: the material that scaled its throughput (or -1); the emissive
    hit's weight and material (or 0 and -1); the light sample's scalar
    weight (geometry x cos x balance weight where the shadow ray gets
    through, else 0), the hit's material and the light's material."""
    scaled: torch.Tensor
    emit_w: torch.Tensor
    emit_mat: torch.Tensor
    nee_w: torch.Tensor
    nee_hit: torch.Tensor
    nee_light: torch.Tensor


def lit_bounce(L: LitScene, state, code, lane, salt: int, depth,
               max_depth: int):
    """One bounce of live lanes: ``state`` the 13-tuple (ox oy oz dx dy dz
    tm tpr tpg tpb rr rg rb), ``code`` their alive codes (2 after a
    diffuse scatter), ``lane`` their hashed ids, ``depth`` their bounce
    counts.  Returns (new state, new code: 0 dead, 1 alive, 2 alive after
    a diffuse scatter, new depth, :class:`Added`)."""
    S = L.base
    ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb = state
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    hit = nearest(S, (ox, oy, oz), (dx, dy, dz), tm, a, inv_a)
    is_hit = hit.t < BIG
    sph = torch.where(is_hit & ~hit.is_tri, hit.index, 0)
    tri = torch.where(is_hit & hit.is_tri, hit.index, 0)

    # The hit record: the sphere's root nearer the sweep's t, or the
    # triangle's plane; the point; the unit normal against the ray (a
    # triangle's is its winding's).
    c = S.c0[sph] + tm[:, None] * S.dc[sph]
    cx, cy, cz = c.unbind(1)
    r_ = S.radius[sph]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    h = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
    disc = h * h - a * cc
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    near = (-h - sq) * inv_a
    far = (-h + sq) * inv_a
    t_hit = torch.where((near - hit.t).abs() <= (far - hit.t).abs(), near,
                        far)
    v0x, v0y, v0z = S.v0[tri].unbind(1)
    tnx, tny, tnz = S.nb[tri].unbind(1)
    tdet = -(dx * tnx + dy * tny + dz * tnz)
    tdet_safe = torch.where(tdet.abs() > EPS12, tdet, 1.0)
    t_tri = ((ox - v0x) * tnx + (oy - v0y) * tny
             + (oz - v0z) * tnz) / tdet_safe
    t_hit = torch.where(hit.is_tri, t_tri, t_hit)
    t_hit = torch.where(is_hit, t_hit, 1.0)
    px = ox + t_hit * dx
    py = oy + t_hit * dy
    pz = oz + t_hit * dz
    r_abs = torch.where(r_ == 0.0, 1.0, r_.abs())
    nx = (px - cx) / r_abs
    ny = (py - cy) / r_abs
    nz = (pz - cz) / r_abs
    front = (dx * nx + dy * ny + dz * nz < 0.0) ^ (r_ < 0.0)
    flip = torch.where(front, 1.0, -1.0).to(a.dtype)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    l2 = tnx * tnx + tny * tny + tnz * tnz
    l_ok = l2 > 0.0
    inv_l = torch.where(l_ok, 1.0 / torch.sqrt(torch.where(l_ok, l2, 1.0)),
                        0.0)
    nx = torch.where(hit.is_tri, tnx * inv_l, nx)
    ny = torch.where(hit.is_tri, tny * inv_l, ny)
    nz = torch.where(hit.is_tri, tnz * inv_l, nz)
    mat = torch.where(hit.is_tri, S.tri_mat[tri], S.sph_mat[sph])
    kind = L.kind[mat]
    alr, alg, alb = S.albedo[mat].unbind(1)
    fuzz = S.fuzz[mat]
    uvx, uvy, uvz, _choice = scatter_draws(lane, salt, a.dtype)
    diffuse = kind == LAMBERTIAN
    below = depth < max_depth

    # Next-event estimation, its shadow ray swept only where it is cast.
    nee = is_hit & below & diffuse
    (ldx, ldy, ldz), t_l, geo, l_pdf, l_mat = sample_light(
        L, uniform(lane, salt, 8, a.dtype), uniform(lane, salt, 9, a.dtype),
        uniform(lane, salt, 10, a.dtype), px, py, pz)
    thresh = t_l * SHADOW_FRAC
    cos_t = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
    w_l = l_pdf / torch.clamp(l_pdf + cos_t * INV_PI, min=EPS12)
    cw = cos_t * w_l
    sub = torch.nonzero(nee).flatten()
    add = torch.zeros_like(nee)
    if sub.numel():
        so = (px[sub], py[sub], pz[sub])
        sd = (ldx[sub], ldy[sub], ldz[sub])
        la = sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2]
        shadow = nearest(S, so, sd, tm[sub], la, 1.0 / la)
        add[sub] = shadow.t >= thresh[sub]
    er, eg, eb = S.albedo[l_mat].unbind(1)
    rr = rr + torch.where(add, tpr * alr * (er * geo) * cw, 0.0)
    rg = rg + torch.where(add, tpg * alg * (eg * geo) * cw, 0.0)
    rb = rb + torch.where(add, tpb * alb * (eb * geo) * cw, 0.0)

    # A miss adds throughput x background and ends.
    missed = ~is_hit
    bgr, bgg, bgb = L.background
    rr = rr + torch.where(missed, tpr * bgr, 0.0)
    rg = rg + torch.where(missed, tpg * bgg, 0.0)
    rb = rb + torch.where(missed, tpb * bgb, 0.0)

    # An emissive hit adds throughput x emission and ends, balanced
    # against the light sample after a diffuse scatter.
    lit_hit = is_hit & (kind == EMISSIVE)
    w_emit = torch.ones_like(a)
    after = torch.nonzero(lit_hit & (code > 1)).flatten()
    if after.numel():
        p_l = light_pdf_toward(
            L, (ox[after], oy[after], oz[after]),
            (dx[after], dy[after], dz[after]), t_hit[after])
        p_b = torch.sqrt(a[after]) * HALF_INV_PI
        w_emit[after] = p_b / torch.clamp(p_b + p_l, min=EPS12)
    rr = rr + torch.where(lit_hit, tpr * alr * w_emit, 0.0)
    rg = rg + torch.where(lit_hit, tpg * alg * w_emit, 0.0)
    rb = rb + torch.where(lit_hit, tpb * alb * w_emit, 0.0)

    # Lambertian: the normal plus a unit vector (the normal if
    # degenerate); metal: the mirror direction of the raw direction plus
    # fuzz.
    lamx, lamy, lamz = nx + uvx, ny + uvy, nz + uvz
    degen = lamx * lamx + lamy * lamy + lamz * lamz < EPS12
    lamx = torch.where(degen, nx, lamx)
    lamy = torch.where(degen, ny, lamy)
    lamz = torch.where(degen, nz, lamz)
    ddn2 = 2.0 * (dx * nx + dy * ny + dz * nz)
    is_metal = kind == METAL
    sdx = torch.where(is_metal, dx - ddn2 * nx + fuzz * uvx, lamx)
    sdy = torch.where(is_metal, dy - ddn2 * ny + fuzz * uvy, lamy)
    sdz = torch.where(is_metal, dz - ddn2 * nz + fuzz * uvz, lamz)

    can = is_hit & below & (kind != EMISSIVE)
    state = (torch.where(can, px, ox), torch.where(can, py, oy),
             torch.where(can, pz, oz), torch.where(can, sdx, dx),
             torch.where(can, sdy, dy), torch.where(can, sdz, dz), tm,
             torch.where(can, tpr * alr, tpr),
             torch.where(can, tpg * alg, tpg),
             torch.where(can, tpb * alb, tpb), rr, rg, rb)
    new_code = can.to(code.dtype) * torch.where(diffuse, 2, 1).to(code.dtype)
    none = torch.full_like(mat, -1)
    added = Added(
        scaled=torch.where(can, mat, none),
        emit_w=torch.where(lit_hit, w_emit, 0.0),
        emit_mat=torch.where(lit_hit, mat, none),
        nee_w=torch.where(add, geo * cw, 0.0),
        nee_hit=torch.where(add, mat, none),
        nee_light=torch.where(add, l_mat, none))
    return state, new_code, depth + can.to(depth.dtype), added


# ---------------------------------------------------------------------------
# The whole-frame render's work pool.


def pool_rows_lit(L: LitScene, cam: list, tile_rows, *, seed: int,
                  width: int, height: int, spp: int, max_depth: int):
    """Radiance sums (3, R, 128) of the whole-frame render's tile rows
    ``tile_rows``: :func:`.integrate.pool_rows`' schedule (the queue of
    (column, chunk) items, the hand-out every ``POOL_K`` iterations with
    its flush in lane order, a camera ray for each idle lane with
    samples left, the draws of iteration ``it`` salted with
    ``step_salt(seed, it)``) over :func:`lit_bounce`.  A freshly started
    lane's code is 1; a lane keeps the code its last bounce gave it."""
    S = L.base
    dev = S.albedo.device
    dtype = S.albedo.dtype
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
        return torch.where(ok, left.clamp(0, POOL_CHUNK), 0)

    inv_w = float(np.float32(1.0) / np.float32(width - 1))
    inv_h = float(np.float32(1.0) / np.float32(height - 1))
    frow = (height - 1 - prow).to(dtype).repeat_interleave(LANES)
    pcol_lane = pcol0.repeat_interleave(LANES)
    n = n_rows * LANES
    state = torch.zeros((13, n), dtype=dtype, device=dev)
    state[3] = 1.0
    code = torch.zeros(n, dtype=torch.int32, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    rem = budget(col, 0).flatten()
    cur = col.flatten().clone()
    nxt = torch.full((n_rows,), LANES, dtype=torch.int64, device=dev)
    acc = torch.zeros((3, n_rows, LANES), dtype=dtype, device=dev)

    def radiance():
        return state[10:13].view(3, n_rows, LANES)

    it = 0
    while True:
        busy = ((code != 0) | (rem > 0)).view(n_rows, LANES).any(dim=1)
        if not bool((busy | (nxt < n_items)).any()):
            break
        salt = step_salt(seed, it)
        if it % POOL_K == 0:
            done = ((code == 0) & (rem == 0)).view(n_rows, LANES)
            off = torch.cumsum(done, dim=1) - done.long()
            item = nxt[:, None] + off
            take = done & (item < n_items)
            _flush(acc, radiance(), cur.view(n_rows, LANES), take)
            flat = take.flatten()
            state[10:13] = torch.where(flat, 0.0, state[10:13])
            new_col = item % LANES
            cur = torch.where(flat, new_col.flatten(), cur)
            rem = torch.where(flat, budget(new_col, item // LANES).flatten(),
                              rem)
            nxt = nxt + take.sum(dim=1)
        need = (code == 0) & (rem > 0)
        sub = torch.nonzero(need).flatten()
        if sub.numel():
            fcol = (pcol_lane[sub] + cur[sub]).to(dtype)
            ray = counter_ray(cam, lane[sub], salt, fcol, frow[sub], inv_w,
                              inv_h, dtype)
            state[0:7, sub] = torch.stack(ray).to(dtype)
            state[7:10, sub] = 1.0
            depth = depth.index_put((sub,), torch.zeros_like(
                sub, dtype=torch.int32))
            code = code.index_put((sub,), torch.ones_like(
                sub, dtype=torch.int32))
            rem = rem - need.to(rem.dtype)
        live = torch.nonzero(code != 0).flatten()
        if live.numel():
            new, new_code, new_depth, _ = lit_bounce(
                L, state[:, live].unbind(0), code[live], lane[live], salt,
                depth[live], max_depth)
            state[:, live] = torch.stack(new)
            code = code.index_put((live,), new_code)
            depth = depth.index_put((live,), new_depth)
        it += 1
    _flush(acc, radiance(), cur.view(n_rows, LANES),
           torch.ones((n_rows, LANES), dtype=torch.bool, device=dev))
    return acc


def render_sample_lit(inputs: dict, camera: dict, tile_rows, *, seed: int,
                      width: int, height: int, spp: int, max_depth: int,
                      device, dtype=torch.float32) -> np.ndarray:
    """The mean radiance (n, 3) float64 of every in-image pixel of the
    tile rows ``tile_rows`` (in :func:`.integrate.pool_pixels`' order)."""
    with float32_only():
        L = build_lit_scene(inputs, device, dtype)
        cam = make_camera(camera, device, dtype)
        acc = pool_rows_lit(L, packed(cam), tile_rows, seed=seed,
                            width=width, height=height, spp=spp,
                            max_depth=max_depth)
    lanes = pool_pixels(tile_rows, width, height)[:, 2]
    sums = acc.reshape(3, -1)[:, torch.as_tensor(lanes, device=device)]
    return sums.T.float().cpu().numpy().astype(np.float64) / spp


# ---------------------------------------------------------------------------
# The gradient path's lanes and the albedo fit.


def trace_lanes_lit(L: LitScene, origin, direction, time, lane_ids,
                    seed: int, max_depth: int):
    """What each bounce of each lane's path adds (:class:`Added` of (L,
    max_depth + 1) each), bounce ``k`` salted with ``step_salt(seed,
    k)``, every lane starting with code 1."""
    dtype = origin.dtype
    n = lane_ids.numel()
    dev = origin.device
    one = torch.ones(n, dtype=dtype, device=dev)
    zero = torch.zeros(n, dtype=dtype, device=dev)
    state = torch.stack([*origin.unbind(1), *direction.unbind(1), time, one,
                         one, one, zero, zero, zero])
    lane = lane_hash(lane_ids.long())
    code = torch.ones(n, dtype=torch.int32, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    cols = max_depth + 1
    rec = Added(*(torch.zeros((n, cols), dtype=dtype, device=dev)
                  if f in ("emit_w", "nee_w")
                  else torch.full((n, cols), -1, dtype=torch.int64, device=dev)
                  for f in Added._fields))
    live = torch.arange(n, device=dev)
    for it in range(cols):
        if not live.numel():
            break
        new, new_code, new_depth, added = lit_bounce(
            L, state[:, live].unbind(0), code[live], lane[live],
            step_salt(seed, it), depth[live], max_depth)
        state[:, live] = torch.stack(new)
        code = code.index_put((live,), new_code)
        depth = depth.index_put((live,), new_depth)
        for r, v in zip(rec, added):
            r[live, it] = v
        live = live[new_code > 0]
    return rec


def radiance(rec: Added, albedo: torch.Tensor) -> torch.Tensor:
    """Each lane's radiance (L, 3) under ``albedo`` (M, 3): at each
    bounce, the throughput so far times the emissive hit's row times its
    weight, plus the hit's row times the light's row times the light
    sample's weight; then the throughput times the row that scaled it."""
    def row(mat, other=0.0):
        # index_select: its backward adds the rows' cotangents with one
        # index_add, where indexing's would sum each row's lanes in turn.
        return torch.where((mat >= 0)[:, None],
                           albedo.index_select(0, mat.clamp(min=0)), other)

    tp = torch.ones((rec.scaled.shape[0], 3), dtype=albedo.dtype,
                    device=albedo.device)
    out = torch.zeros_like(tp)
    for k in range(rec.scaled.shape[1]):
        out = out + tp * (rec.emit_w[:, k, None] * row(rec.emit_mat[:, k])
                          + rec.nee_w[:, k, None] * row(rec.nee_hit[:, k])
                          * row(rec.nee_light[:, k]))
        tp = tp * row(rec.scaled[:, k], 1.0)
    return out


def start_albedo(inputs: dict, start) -> np.ndarray:
    """The fit's first albedos: the true rows with ``start``'s [row,
    (r, g, b)] pairs put in."""
    albedo = np.array(inputs["materials"]["albedo"], np.float64)
    for i, rgb in start:
        albedo[int(i)] = rgb
    return albedo


def steps_lit(inputs: dict, camera: dict, *, width: int, height: int,
              spp: int, max_depth: int, seed: int, target_seed: int,
              feed_seeds, start, lr: float, device,
              dtype=torch.float32) -> dict:
    """The fit's first ``len(feed_seeds)`` steps from :func:`start_albedo`
    toward a target rendered with the true albedos from
    ``target_seed``'s generator: each step renders every pixel (``spp``
    lanes each, camera rays from its generator), takes the mean squared
    error and descends every albedo row by SGD -> {"losses": [...],
    "albedo": [A0, A1, ...] (M, 3) float64, "grad": the first step's
    gradient}."""
    with float32_only():
        L = build_lit_scene(inputs, device, dtype)
        cam = make_camera(camera, device, dtype)
        n_pix = width * height
        pix = torch.arange(n_pix, device=device).repeat_interleave(spp)
        lane_ids = torch.arange(pix.numel(), device=device)

        def paths_of(gen_seed: int) -> Added:
            gen = torch.Generator(device).manual_seed(int(gen_seed))
            o, d, tm = generator_rays(cam, gen, pix, width, height)
            return trace_lanes_lit(L, o, d, tm, lane_ids, seed, max_depth)

        def image(rec, albedo):
            return radiance(rec, albedo).reshape(n_pix, spp, 3).mean(dim=1)

        with torch.no_grad():
            target = image(paths_of(target_seed), L.base.albedo)
        albedo = torch.as_tensor(start_albedo(inputs, start)).to(device,
                                                                 dtype)
        out = {"losses": [], "albedo": [albedo], "grad": None}
        for gen_seed in feed_seeds:
            rec = paths_of(gen_seed)
            a = albedo.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = torch.mean((image(rec, a) - target) ** 2)
                (grad,) = torch.autograd.grad(loss, [a])
            albedo = (a - lr * grad).detach()
            out["losses"].append(float(loss.detach()))
            out["albedo"].append(albedo)
            if out["grad"] is None:
                out["grad"] = grad
    out["albedo"] = [x.double().cpu().numpy() for x in out["albedo"]]
    out["grad"] = out["grad"].double().cpu().numpy()
    return out
