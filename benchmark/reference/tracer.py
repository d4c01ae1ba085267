"""The plain path tracer: one bounce of many lanes, in plain PyTorch.

The semantics are the book's (*Ray Tracing in One Weekend*): spheres
that may move over the shutter, one-sided triangles, Lambertian, metal
and dielectric materials, the sky gradient on a miss, the depth checked
after the hit.  The arithmetic follows the order in which the port's
semantics round it, so a float32 bounce gives the same bits.

The nearest hit is found independently of the program: every sphere is
tested (the scenes hold a few hundred), and triangles through the
reference's own two-level grouping (:class:`TriangleGroups`), built here
from the vertices.  The nearest t wins; on equal t a sphere wins over a
triangle, then the lower index.

``dtype`` is float32 for the reference; the control runs the same code
in bfloat16.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .rng import scatter_draws

T_MIN = float(np.float32(1e-3))
BIG = float(np.float32(3.0e38))
EPS12 = float(np.float32(1e-12))
DET_MIN = float(np.float32(1e-6))
LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
#: Triangles per leaf group, and leaf groups per top group.
GROUP = 32
_NO_INDEX = 1 << 62


class Scene(NamedTuple):
    """The reference's scene on a device: material rows (kind, albedo,
    fuzz, ir), spheres (centre at t = 0, its motion, radius, material),
    triangles (v0, edges, the unnormalised normal, material) and the
    triangle groups, or None without triangles."""
    kind: torch.Tensor
    albedo: torch.Tensor
    fuzz: torch.Tensor
    ir: torch.Tensor
    c0: torch.Tensor
    dc: torch.Tensor
    radius: torch.Tensor
    sph_mat: torch.Tensor
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    nb: torch.Tensor
    tri_mat: torch.Tensor
    groups: Optional["TriangleGroups"]


def build_scene(inputs: dict, device, dtype) -> Scene:
    """The reference's scene from the benchmark's inputs (numpy float64
    arrays, cast once to ``dtype``)."""
    def real(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype)

    def index(x):
        return torch.as_tensor(np.asarray(x, np.int64)).to(device)

    mats, sph, tri = inputs["materials"], inputs["spheres"], inputs["triangles"]
    kinds = set(int(k) for k in mats["kind"])
    if not kinds <= {LAMBERTIAN, METAL, DIELECTRIC}:
        raise NotImplementedError(f"material kinds {sorted(kinds)}: the "
                                  f"reference has Lambertian, metal and "
                                  f"dielectric only")
    if inputs.get("background", "sky") != "sky":
        raise NotImplementedError("the reference renders the sky only")
    c0 = np.asarray(sph["center0"], np.float64).reshape(-1, 3)
    c1 = np.asarray(sph["center1"], np.float64).reshape(-1, 3)
    verts = real(np.asarray(tri["verts"], np.float64).reshape(-1, 3, 3))
    v0 = verts[:, 0]
    e1 = verts[:, 1] - v0
    e2 = verts[:, 2] - v0
    nb = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    return Scene(
        kind=real(mats["kind"]), albedo=real(mats["albedo"]),
        fuzz=real(np.clip(np.asarray(mats["fuzz"], np.float64), 0.0, 1.0)),
        ir=real(mats["ir"]), c0=real(c0), dc=real(c1 - c0),
        radius=real(sph["radius"]), sph_mat=index(sph["material"]),
        v0=v0, e1=e1, e2=e2, nb=nb, tri_mat=index(tri["material"]),
        groups=TriangleGroups(verts) if verts.shape[0] else None)


# ---------------------------------------------------------------------------
# Nearest hit.


def nearest_sphere(scene: Scene, o, d, tm, a, inv_a, chunk: int):
    """(t, index) of each ray's nearest sphere, every sphere tested; BIG
    and 0 where none is hit."""
    n = o[0].shape[0]
    best_t = torch.full((n,), BIG, dtype=o[0].dtype, device=o[0].device)
    best_k = torch.zeros((n,), dtype=torch.int64, device=o[0].device)
    if not scene.radius.numel():
        return best_t, best_k
    cx, cy, cz = scene.c0.unbind(1)
    dcx, dcy, dcz = scene.dc.unbind(1)
    r_ = scene.radius
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        ox, oy, oz = (v[sl, None] for v in o)
        dx, dy, dz = (v[sl, None] for v in d)
        tm3, a3, inva3 = tm[sl, None], a[sl, None], inv_a[sl, None]
        ocx = ox - (cx + tm3 * dcx)
        ocy = oy - (cy + tm3 * dcy)
        ocz = oz - (cz + tm3 * dcz)
        h = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
        disc = h * h - a3 * cc
        pos = disc > 0.0
        sq = torch.sqrt(torch.where(pos, disc, 1.0))
        near = (-h - sq) * inva3
        far = (-h + sq) * inva3
        t = torch.where(near >= T_MIN, near, far)
        t = torch.where(pos & (t >= T_MIN), t, BIG)
        bk = torch.argmin(t, dim=1)
        best_t[sl] = torch.gather(t, 1, bk[:, None])[:, 0]
        best_k[sl] = bk
    return best_t, best_k


def _enters(lo, hi, org, inv, best_t):
    """Slab test of boxes (lo, hi: (..., 3)) against rays (org, inv:
    3-tuples broadcast against them) that must be entered before
    ``best_t``.  NaN-safe where a direction component is 0."""
    tn = tf = None
    for ax in range(3):
        t0 = (lo[..., ax] - org[ax]) * inv[ax]
        t1 = (hi[..., ax] - org[ax]) * inv[ax]
        a, b = torch.fmin(t0, t1), torch.fmax(t0, t1)
        tn = a if tn is None else torch.fmax(tn, a)
        tf = b if tf is None else torch.fmin(tf, b)
    return (tn <= tf) & (tf >= 0.0) & (tn <= best_t)


class TriangleGroups:
    """Triangles in the Morton order of their centroids, in leaf groups of
    ``GROUP`` and top groups of ``GROUP`` leaves, each with a box padded
    by 1e-4 + 1e-4 x its extent: a ray that hits a triangle before its
    best t enters both of the triangle's boxes."""

    def __init__(self, verts: torch.Tensor):
        m = verts.shape[0]
        v = verts.float()
        tmin, tmax = v.amin(dim=1), v.amax(dim=1)
        cent = 0.5 * (tmin + tmax)
        lo, hi = cent.amin(dim=0), cent.amax(dim=0)
        q = ((cent - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0)
        q = q.clamp(0, 1023).long()
        code = torch.zeros(m, dtype=torch.int64, device=verts.device)
        for bit in range(10):
            for ax in range(3):
                code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
        order = torch.argsort(code, stable=True)
        n_leaf = -(-m // GROUP)
        n_top = -(-n_leaf // GROUP)
        pad = n_top * GROUP * GROUP - m
        #: Triangle index of each slot of the leaves, -1 for padding.
        self.slots = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64,
                                                  device=verts.device)])
        big = 1.0e30
        smin = torch.cat([tmin[order], torch.full((pad, 3), big,
                                                  device=verts.device)])
        smax = torch.cat([tmax[order], torch.full((pad, 3), -big,
                                                  device=verts.device)])

        def boxes(lo, hi, k):
            return (lo.reshape(-1, k, 3).amin(dim=1),
                    hi.reshape(-1, k, 3).amax(dim=1))

        def padded(lo, hi):
            # A group of padding only gets a box at +infinity, which no ray
            # enters (an inverted box would pass the slab test).
            empty = (lo > hi).any(dim=1, keepdim=True)
            eps = 1e-4 + 1e-4 * (hi - lo).abs()
            return (torch.where(empty, torch.inf, lo - eps),
                    torch.where(empty, torch.inf, hi + eps))

        leaf_lo, leaf_hi = boxes(smin, smax, GROUP)
        top_lo, top_hi = padded(*boxes(leaf_lo, leaf_hi, GROUP))
        leaf_lo, leaf_hi = padded(leaf_lo, leaf_hi)
        dtype = verts.dtype
        self.leaf_lo, self.leaf_hi = leaf_lo.to(dtype), leaf_hi.to(dtype)
        self.top_lo, self.top_hi = top_lo.to(dtype), top_hi.to(dtype)


def nearest_triangle(scene: Scene, o, d, best_t, chunk: int):
    """(t, index) of each ray's nearest triangle hit strictly before
    ``best_t``; ``best_t`` and -1 where there is none.  On equal t the
    lowest index wins."""
    g = scene.groups
    n = best_t.shape[0]
    dev = best_t.device
    out_t = best_t.clone()
    out_k = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if g is None or not n:
        return out_t, out_k
    inv = tuple(1.0 / v for v in d)
    span = torch.arange(GROUP, device=dev)
    found = []  # (ray, t, index) of each (ray, leaf) pair with a hit
    for s in range(0, n, chunk):
        rows = torch.arange(s, min(s + chunk, n), device=dev)
        hit = _enters(g.top_lo, g.top_hi, tuple(v[rows, None] for v in o),
                      tuple(v[rows, None] for v in inv),
                      best_t[rows, None])
        r1, t1 = torch.nonzero(hit, as_tuple=True)
        r1 = rows[r1]
        leaf = t1[:, None] * GROUP + span
        hit = _enters(g.leaf_lo[leaf], g.leaf_hi[leaf],
                      tuple(v[r1, None] for v in o),
                      tuple(v[r1, None] for v in inv), best_t[r1, None])
        p, j = torch.nonzero(hit, as_tuple=True)
        ray, lf = r1[p], leaf[p, j]
        # The triangles of each (ray, leaf) pair, a bounded block at a time.
        step = max(1, (1 << 22) // GROUP)
        for q in range(0, ray.numel(), step):
            rq, lq = ray[q:q + step], lf[q:q + step]
            tri = g.slots[lq[:, None] * GROUP + span]
            tt = _triangle_t(scene, tri.clamp(min=0),
                             tuple(v[rq, None] for v in o),
                             tuple(v[rq, None] for v in d), best_t[rq, None])
            tt = torch.where(tri >= 0, tt, BIG)
            pt = tt.min(dim=1).values
            pk = torch.where(tt == pt[:, None], tri, _NO_INDEX).amin(dim=1)
            keep = pt < best_t[rq]
            found.append((rq[keep], pt[keep], pk[keep]))
    if not found:
        return out_t, out_k
    ray = torch.cat([f[0] for f in found])
    pt = torch.cat([f[1] for f in found])
    pk = torch.cat([f[2] for f in found])
    out_t.scatter_reduce_(0, ray, pt, "amin")
    win = pt == out_t[ray]
    idx = torch.full((n,), _NO_INDEX, dtype=torch.int64, device=dev)
    idx.scatter_reduce_(0, ray[win], pk[win], "amin")
    return out_t, torch.where(idx < _NO_INDEX, idx, -1)


def _triangle_t(scene: Scene, tri, o, d, bt):
    """Moller-Trumbore in the determinant form, one-sided: the hit t of
    rays (o, d: (P, 1) each) against triangles ``tri`` (P, k), BIG where
    the ray misses or the hit is not before ``bt``."""
    v0x, v0y, v0z = (scene.v0[tri, i] for i in range(3))
    e1x, e1y, e1z = (scene.e1[tri, i] for i in range(3))
    e2x, e2y, e2z = (scene.e2[tri, i] for i in range(3))
    nxb, nyb, nzb = (scene.nb[tri, i] for i in range(3))
    ux, uy, uz = o
    vx, vy, vz = d
    det = -(vx * nxb + vy * nyb + vz * nzb)
    det_ok = det >= DET_MIN
    invdet = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    aox, aoy, aoz = ux - v0x, uy - v0y, uz - v0z
    daox = aoy * vz - aoz * vy
    daoy = aoz * vx - aox * vz
    daoz = aox * vy - aoy * vx
    u = (e2x * daox + e2y * daoy + e2z * daoz) * invdet
    v = -(e1x * daox + e1y * daoy + e1z * daoz) * invdet
    tt = (aox * nxb + aoy * nyb + aoz * nzb) * invdet
    ok = (det_ok & (tt >= T_MIN) & (tt <= bt) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0))
    return torch.where(ok, tt, BIG)


class Hit(NamedTuple):
    """A bounce's nearest hit: t (BIG on a miss), whether it is a
    triangle, and the sphere's or triangle's index."""
    t: torch.Tensor
    is_tri: torch.Tensor
    index: torch.Tensor


def nearest(scene: Scene, o, d, tm, a, inv_a, chunk: int = 1 << 16) -> Hit:
    t_s, k_s = nearest_sphere(scene, o, d, tm, a, inv_a, chunk)
    t_t, k_t = nearest_triangle(scene, o, d, t_s, chunk)
    is_tri = k_t >= 0
    return Hit(torch.where(is_tri, t_t, t_s), is_tri,
               torch.where(is_tri, k_t, k_s))


# ---------------------------------------------------------------------------
# One bounce.


def bounce(scene: Scene, state, lane, salt: int, depth, max_depth: int):
    """One bounce of live lanes: ``state`` the 13-tuple (ox oy oz dx dy dz
    tm tpr tpg tpb rr rg rb), ``lane`` their hashed ids, ``depth`` their
    bounce counts.  Returns (new state, scattered, new depth, the
    material whose albedo scaled the throughput or -1, the sky colour
    added on a miss or 0)."""
    ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb = state
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    hit = nearest(scene, (ox, oy, oz), (dx, dy, dz), tm, a, inv_a)
    is_hit = hit.t < BIG
    sph = torch.where(is_hit & ~hit.is_tri, hit.index, 0)
    tri = torch.where(is_hit & hit.is_tri, hit.index, 0)
    zero = torch.zeros_like(a)

    # The sphere's root nearer the sweep's t, its point and normal.
    if scene.radius.numel():
        c = scene.c0[sph] + tm[:, None] * scene.dc[sph]
        cx, cy, cz = c.unbind(1)
        r_ = scene.radius[sph]
    else:
        cx = cy = cz = r_ = zero
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    h = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
    disc = h * h - a * cc
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    near = (-h - sq) * inv_a
    far = (-h + sq) * inv_a
    t_hit = torch.where((near - hit.t).abs() <= (far - hit.t).abs(), near,
                        far)
    if scene.groups is not None:
        v0x, v0y, v0z = scene.v0[tri].unbind(1)
        tnx, tny, tnz = scene.nb[tri].unbind(1)
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
    if scene.groups is not None:
        l2 = tnx * tnx + tny * tny + tnz * tnz
        l_ok = l2 > 0.0
        inv_l = torch.where(l_ok, 1.0 / torch.sqrt(torch.where(l_ok, l2, 1.0)),
                            0.0)
        nx = torch.where(hit.is_tri, tnx * inv_l, nx)
        ny = torch.where(hit.is_tri, tny * inv_l, ny)
        nz = torch.where(hit.is_tri, tnz * inv_l, nz)
        front = hit.is_tri | front
    mat = torch.where(hit.is_tri, scene.tri_mat[tri] if scene.groups
                      is not None else 0, scene.sph_mat[sph] if
                      scene.radius.numel() else 0)
    kind = scene.kind[mat]
    alr, alg, alb = scene.albedo[mat].unbind(1)
    fuzz, ir = scene.fuzz[mat], scene.ir[mat]

    uvx, uvy, uvz, choice = scatter_draws(lane, salt, a.dtype)
    # Lambertian: the normal plus a unit vector (the normal if degenerate).
    lamx, lamy, lamz = nx + uvx, ny + uvy, nz + uvz
    degen = lamx * lamx + lamy * lamy + lamz * lamz < EPS12
    lamx = torch.where(degen, nx, lamx)
    lamy = torch.where(degen, ny, lamy)
    lamz = torch.where(degen, nz, lamz)
    # Metal: the mirror direction of the raw direction plus fuzz.
    ddn2 = 2.0 * (dx * nx + dy * ny + dz * nz)
    mrx = dx - ddn2 * nx + fuzz * uvx
    mry = dy - ddn2 * ny + fuzz * uvy
    mrz = dz - ddn2 * nz + fuzz * uvz
    # Dielectric: Schlick's reflectance, total internal reflection.
    inv_dlen = 1.0 / torch.sqrt(a)
    udx, udy, udz = dx * inv_dlen, dy * inv_dlen, dz * inv_dlen
    cos_t = torch.minimum(-(udx * nx + udy * ny + udz * nz),
                          torch.ones_like(a))
    sin_t = torch.sqrt(torch.maximum(1.0 - cos_t * cos_t,
                                     torch.full_like(a, EPS12)))
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
    is_metal, is_diel = kind == METAL, kind == DIELECTRIC
    sdx = torch.where(is_metal, mrx, torch.where(is_diel, dix, lamx))
    sdy = torch.where(is_metal, mry, torch.where(is_diel, diy, lamy))
    sdz = torch.where(is_metal, mrz, torch.where(is_diel, diz, lamz))
    atr = torch.where(is_diel, 1.0, alr)
    atg = torch.where(is_diel, 1.0, alg)
    atb = torch.where(is_diel, 1.0, alb)

    # A miss adds throughput x sky and ends the path.
    missed = ~is_hit
    sky_t = 0.5 * (dy * (1.0 / torch.sqrt(a)) + 1.0)
    skyr = 1.0 - sky_t + sky_t * 0.5
    skyg = 1.0 - sky_t + sky_t * 0.7
    skyb = torch.ones_like(sky_t)
    rr = rr + torch.where(missed, tpr * skyr, 0.0)
    rg = rg + torch.where(missed, tpg * skyg, 0.0)
    rb = rb + torch.where(missed, tpb * skyb, 0.0)
    sky = torch.stack([torch.where(missed, skyr, 0.0),
                       torch.where(missed, skyg, 0.0),
                       torch.where(missed, skyb, 0.0)], dim=1)

    # A hit below the depth limit scatters; one at the limit ends.
    can = is_hit & (depth < max_depth)
    state = (torch.where(can, px, ox), torch.where(can, py, oy),
             torch.where(can, pz, oz), torch.where(can, sdx, dx),
             torch.where(can, sdy, dy), torch.where(can, sdz, dz), tm,
             torch.where(can, tpr * atr, tpr),
             torch.where(can, tpg * atg, tpg),
             torch.where(can, tpb * atb, tpb), rr, rg, rb)
    scaled = torch.where(can & ~is_diel, mat, -1)
    return state, can, depth + can.to(depth.dtype), scaled, sky
