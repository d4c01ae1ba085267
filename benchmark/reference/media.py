"""The plain media path tracer: the Cornell smoke's semantics, in plain
PyTorch, differentiable in the media's densities and albedos, for the
media cell's check.

The bounce is :mod:`.lit`'s (the walls, the one-sided lamp, next-event
estimation with the balance heuristic, a flat background) with *The Next
Week*'s constant-density medium, as the port's semantics round it:

* each medium is a box turned about y and moved; a ray is taken into the
  box's local frame (the inverse turn of its offset from the box's
  translation) and slab-tested there;
* free flight: at every bounce each medium draws one uniform (draw 16 +
  j for medium j), its distance ``-ln u / density / |d|`` from where the
  ray enters the box, that entry clipped to [1e-3, the surface's t]; the
  nearest event that lands inside its medium's clipped interval wins and
  takes the place of the surface hit;
* a volume scatter moves the ray to the event's point, turns it to the
  isotropic direction (the bounce's unit vector, halved) and multiplies
  the throughput by the medium's albedo; below the depth cap it counts a
  bounce, at the cap the path ends there;
* next-event estimation from every diffuse hit and every volume event
  below the depth cap: a light sample (:func:`.lit.sample_light`) toward
  which the shadow ray is swept against every triangle up to ``t_l (1 -
  1e-3)``; where it gets through, throughput x albedo (the medium's at an
  event) x emission x the geometry term x (cos at a surface, 1/4 at an
  event, the isotropic phase over pi) x the media's transmittance
  ``exp(-sum density x overlap)`` along [0, t_l] x the light's balance
  weight, the scatter's pdf against it cos / pi at a surface and 1 / (4
  pi) at an event;
* a lamp hit after a diffuse or volume scatter is balanced against the
  light sample, the scatter's pdf |d| / (2 pi) of the raw direction (1 /
  (4 pi) for the halved isotropic one).

The gradient: :func:`steps_media` takes the first steps of the density
and albedo fit.  A density moves the paths (the event's point, and every
later segment from it; the shadow ray's transmittance), so the lanes are
re-traced under autograd, block by block: a no-grad pass traces every
lane, recording each bounce's discrete choices (:class:`Choices`: the
surface winner, the winning medium, the shadow ray's visibility) and
giving the image, the loss and each lane's cotangent; each block is then
traced again with those choices replayed and its backward adds into the
gradient.  Like the port and the JAX package, the density gradient
carries the derivatives of the event's distance and of the
transmittance, not that of the probability that the event happens (the
event bit is replayed, ROADMAP R6).

Departures from the book: light sampling (the book samples no light);
one uniform per medium per bounce, the nearest event winning, where the
book's ``constant_medium`` draws a distance at each boundary crossing;
the media are rotated boxes only, the surfaces Lambertian triangles and
one emissive material (no spheres, metal, glass or textures); the lamp
is one-sided.

Precision: float32 with TF32 off (:func:`.lit.float32_only`); the control
runs the same code in bfloat16.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .camera import generator_rays, make_camera
from .lit import (
    EMISSIVE, HALF_INV_PI, INV_PI, SHADOW_FRAC, LitScene, build_lit_scene,
    float32_only, light_pdf_toward, nearest, sample_light,
)
from .rng import lane_hash, scatter_draws, step_salt, uniform
from .tracer import BIG, EPS12, LAMBERTIAN

QUARTER_INV_PI = float(np.float32(0.25 / np.pi))
#: An event's interval starts no nearer than this.
T_EVENT = float(np.float32(1e-3))
#: A lane's event distance where no medium has one.
NO_EVENT = float(np.float32(1e30))
#: The fitted leaves, under the port's names.
DENSITY, ALBEDO = "volumes.density", "volumes.albedo"


class MediaScene(NamedTuple):
    """The lit scene and the media's boxes: local corners (V, 3), the
    turn about y in radians (V,) and the translation (V, 3)."""
    lit: LitScene
    lo: torch.Tensor
    hi: torch.Tensor
    angle: torch.Tensor
    shift: torch.Tensor


class Choices(NamedTuple):
    """A bounce's discrete choices, as the no-grad pass made them: the
    surface sweep's winner (hit, the triangle's index), the medium whose
    event won (-1: none) and whether the shadow ray got through."""
    hit: torch.Tensor
    index: torch.Tensor
    medium: torch.Tensor
    visible: torch.Tensor


def build_media_scene(inputs: dict, device, dtype) -> MediaScene:
    """The reference's media scene from the benchmark's inputs, cast once
    to ``dtype`` (each turn converted to radians in float64 first)."""
    if len(inputs["spheres"]["radius"]):
        raise NotImplementedError("the media reference has triangles only")
    kinds = set(int(k) for k in inputs["materials"]["kind"])
    if not kinds <= {LAMBERTIAN, EMISSIVE}:
        raise NotImplementedError(f"material kinds {sorted(kinds)}: the "
                                  f"media reference has Lambertian and "
                                  f"emissive only")
    v = inputs["volumes"]
    if list(v["kind"]) != ["r"] * len(v["kind"]):
        raise NotImplementedError("the media reference has rotated boxes "
                                  "only")

    def real(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(device=device,
                                                             dtype=dtype)

    return MediaScene(build_lit_scene(inputs, device, dtype),
                      real(v["p_min"]), real(v["p_max"]),
                      real(np.radians(np.asarray(v["rotate_y"], np.float64))),
                      real(v["translate"]))


def leaves_of(inputs: dict, device, dtype) -> dict:
    """The media's true densities (V,) and albedos (V, 3)."""
    v = inputs["volumes"]
    return {k: torch.as_tensor(np.asarray(v[f], np.float64)).to(device,
                                                                dtype)
            for k, f in ((DENSITY, "density"), (ALBEDO, "albedo"))}


def interval(M: MediaScene, k: int, ox, oy, oz, dx, dy, dz):
    """(t0, t1, valid) of rays against medium ``k``'s box, in units of
    the raw direction: the ray taken into the box's frame, then the slab
    test (a direction component under 1e-24 taken as +-1e-24)."""
    c, s = torch.cos(M.angle[k]), torch.sin(M.angle[k])
    tx, ty, tz = M.shift[k].unbind(0)
    wx, wy, wz = ox - tx, oy - ty, oz - tz
    lox, loz = c * wx - s * wz, s * wx + c * wz
    ldx, ldz = c * dx - s * dz, s * dx + c * dz
    lo, hi = M.lo[k].unbind(0), M.hi[k].unbind(0)

    def slab(o, d, a, b):
        tiny = torch.where(d < 0, -1e-24, 1e-24)
        inv = 1.0 / torch.where(d.abs() < 1e-24, tiny, d)
        ta, tb = (a - o) * inv, (b - o) * inv
        return torch.minimum(ta, tb), torch.maximum(ta, tb)

    ax0, ax1 = slab(lox, ldx, lo[0], hi[0])
    ay0, ay1 = slab(wy, dy, lo[1], hi[1])
    az0, az1 = slab(loz, ldz, lo[2], hi[2])
    t0 = torch.maximum(torch.maximum(ax0, ay0), az0)
    t1 = torch.minimum(torch.minimum(ax1, ay1), az1)
    return t0, t1, t0 < t1


def transmittance(M: MediaScene, density, ox, oy, oz, dx, dy, dz, t_max):
    """exp(-sum_k density_k x overlap_k x |d|) over [0, t_max] of the
    rays: what the media let through along a shadow ray."""
    dlen = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    tau = torch.zeros_like(ox)
    for k in range(M.lo.shape[0]):
        t0, t1, valid = interval(M, k, ox, oy, oz, dx, dy, dz)
        overlap = torch.clamp(torch.minimum(t1, t_max)
                              - torch.clamp(t0, min=0.0), min=0.0)
        tau = tau + torch.where(valid, density[k] * overlap * dlen, 0.0)
    return torch.exp(-tau)


def media_bounce(M: MediaScene, density, albedo, state, code, lane,
                 salt: int, depth, max_depth: int,
                 choices: Optional[Choices] = None):
    """One bounce of every lane of ``state`` (the 13-tuple ox oy oz dx dy
    dz tm tpr tpg tpb rr rg rb; ``code`` 0 dead, 1 alive, 2 alive after a
    diffuse or volume scatter; ``lane`` the hashed ids; ``depth`` the
    bounce counts), dead lanes passing through.  ``choices`` None makes
    the bounce's choices (the sweeps without autograd); given, it
    replays them.  Returns (new state, new code, new depth, the
    choices)."""
    L = M.lit
    S = L.base
    ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb = state
    dtype = ox.dtype
    alive = code > 0
    a = dx * dx + dy * dy + dz * dz
    making = choices is None
    if making:
        hit, index, t_surf = _surface(S, alive, (ox, oy, oz), (dx, dy, dz),
                                      tm, a)
    else:
        hit, index = choices.hit, choices.index

    # The hit record: the winner's plane, the point, its unit normal.
    tri = torch.where(hit, index, 0)
    v0x, v0y, v0z = S.v0[tri].unbind(1)
    tnx, tny, tnz = S.nb[tri].unbind(1)
    tdet = -(dx * tnx + dy * tny + dz * tnz)
    tdet_safe = torch.where(tdet.abs() > EPS12, tdet, 1.0)
    t_tri = ((ox - v0x) * tnx + (oy - v0y) * tny
             + (oz - v0z) * tnz) / tdet_safe
    t_hit = torch.where(hit, t_tri, 1.0)
    px = ox + t_hit * dx
    py = oy + t_hit * dy
    pz = oz + t_hit * dz
    l2 = tnx * tnx + tny * tny + tnz * tnz
    l_ok = l2 > 0.0
    inv_l = torch.where(l_ok, 1.0 / torch.sqrt(torch.where(l_ok, l2, 1.0)),
                        0.0)
    nx, ny, nz = tnx * inv_l, tny * inv_l, tnz * inv_l
    mat = S.tri_mat[tri]
    kind = L.kind[mat]
    alr, alg, alb = S.albedo[mat].unbind(1)
    uvx, uvy, uvz, _choice = scatter_draws(lane, salt, dtype)

    # Free flight: each medium's distance from its clipped entry; the
    # nearest inside its interval wins, before the surface.
    dlen = torch.sqrt(torch.clamp(a, min=1e-24))
    t_v = torch.full_like(ox, NO_EVENT)
    medium = torch.full_like(index, -1) if making else choices.medium
    for k in range(M.lo.shape[0]):
        t0, t1, valid = interval(M, k, ox, oy, oz, dx, dy, dz)
        t_in = torch.clamp(t0, min=T_EVENT)
        sigma = torch.clamp(density[k], min=1e-12).expand_as(ox)
        t_k = t_in + (-torch.log(torch.clamp(
            uniform(lane, salt, 16 + k, dtype), min=1e-12)) / sigma / dlen)
        if making:
            t_out = torch.minimum(t1, t_surf)
            win = (alive & valid & (t_in < t_out) & (t_k < t_out)
                   & (t_k < t_v))
            medium = torch.where(win, k, medium)
        else:
            win = medium == k
        t_v = torch.where(win, t_k, t_v)
    v_hit = medium >= 0
    var, vag, vab = torch.where(
        v_hit[:, None], albedo.index_select(0, medium.clamp(min=0)),
        0.0).unbind(1)

    # Next-event estimation from a diffuse hit or a volume event.
    below = depth < max_depth
    v_act = v_hit & below
    qx = torch.where(v_act, ox + t_v * dx, px)
    qy = torch.where(v_act, oy + t_v * dy, py)
    qz = torch.where(v_act, oz + t_v * dz, pz)
    (ldx, ldy, ldz), t_l, geo, l_pdf, l_mat = sample_light(
        L, uniform(lane, salt, 8, dtype), uniform(lane, salt, 9, dtype),
        uniform(lane, salt, 10, dtype), qx, qy, qz)
    nee = (alive & hit & below & (kind == LAMBERTIAN) & ~v_hit) | v_act
    thresh = t_l * SHADOW_FRAC
    cos_t = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
    phase = torch.where(v_act, QUARTER_INV_PI, cos_t * INV_PI)
    factor = torch.where(v_act, 0.25, cos_t)
    nar = torch.where(v_act, var, alr)
    nag = torch.where(v_act, vag, alg)
    nab = torch.where(v_act, vab, alb)
    w_l = l_pdf / torch.clamp(l_pdf + phase, min=EPS12)
    cw = factor * transmittance(M, density, qx, qy, qz, ldx, ldy, ldz,
                                t_l) * w_l
    if making:
        visible = _visible(S, nee, (qx, qy, qz), (ldx, ldy, ldz), tm, thresh)
    else:
        visible = choices.visible
    er, eg, eb = S.albedo[l_mat].unbind(1)
    rr = rr + torch.where(visible, tpr * nar * (er * geo) * cw, 0.0)
    rg = rg + torch.where(visible, tpg * nag * (eg * geo) * cw, 0.0)
    rb = rb + torch.where(visible, tpb * nab * (eb * geo) * cw, 0.0)

    # A miss adds throughput x background and ends.
    missed = alive & ~hit & ~v_hit
    bgr, bgg, bgb = L.background
    rr = rr + torch.where(missed, tpr * bgr, 0.0)
    rg = rg + torch.where(missed, tpg * bgg, 0.0)
    rb = rb + torch.where(missed, tpb * bgb, 0.0)

    # A lamp hit adds throughput x emission and ends, balanced against
    # the light sample after a diffuse or volume scatter.
    lit_hit = alive & hit & (kind == EMISSIVE) & ~v_hit
    p_l = light_pdf_toward(L, (ox, oy, oz), (dx, dy, dz), t_hit)
    p_b = torch.sqrt(a) * HALF_INV_PI
    w_emit = torch.where(code > 1, p_b / torch.clamp(p_b + p_l, min=EPS12),
                         1.0)
    rr = rr + torch.where(lit_hit, tpr * alr * w_emit, 0.0)
    rg = rg + torch.where(lit_hit, tpg * alg * w_emit, 0.0)
    rb = rb + torch.where(lit_hit, tpb * alb * w_emit, 0.0)

    # A diffuse scatter: n + unit (degenerate -> n); a volume scatter:
    # to the event's point, the halved unit vector, the medium's albedo.
    lamx, lamy, lamz = nx + uvx, ny + uvy, nz + uvz
    degen = lamx * lamx + lamy * lamy + lamz * lamz < EPS12
    can = alive & hit & below & ~v_hit & (kind == LAMBERTIAN)
    v_can = v_act
    state = (
        torch.where(v_can, ox + t_v * dx, torch.where(can, px, ox)),
        torch.where(v_can, oy + t_v * dy, torch.where(can, py, oy)),
        torch.where(v_can, oz + t_v * dz, torch.where(can, pz, oz)),
        torch.where(v_can, uvx * 0.5, torch.where(
            can, torch.where(degen, nx, lamx), dx)),
        torch.where(v_can, uvy * 0.5, torch.where(
            can, torch.where(degen, ny, lamy), dy)),
        torch.where(v_can, uvz * 0.5, torch.where(
            can, torch.where(degen, nz, lamz), dz)),
        tm,
        torch.where(v_can, tpr * var, torch.where(can, tpr * alr, tpr)),
        torch.where(v_can, tpg * vag, torch.where(can, tpg * alg, tpg)),
        torch.where(v_can, tpb * vab, torch.where(can, tpb * alb, tpb)),
        rr, rg, rb)
    new_code = torch.where(can | v_can, 2, 0).to(code.dtype)
    new_depth = depth + (can | v_can).to(depth.dtype)
    return state, new_code, new_depth, Choices(hit, index, medium, visible)


def _surface(S, alive, o, d, tm, a):
    """(hit, triangle index, t: BIG where nothing is hit) of the live
    lanes' rays, without autograd."""
    with torch.no_grad():
        hit = torch.zeros_like(alive)
        index = torch.zeros(alive.shape, dtype=torch.int64,
                            device=alive.device)
        t = torch.full_like(o[0], BIG)
        sub = torch.nonzero(alive).flatten()
        if sub.numel():
            aa = a[sub]
            h = nearest(S, tuple(v[sub] for v in o), tuple(v[sub] for v in d),
                        tm[sub], aa, 1.0 / aa)
            hit[sub] = h.t < BIG
            index[sub] = h.index
            t[sub] = h.t
    return hit, index, t


def _visible(S, nee, q, l, tm, thresh):
    """Whether each NEE lane's shadow ray from ``q`` along ``l`` reaches
    ``thresh`` unblocked, without autograd."""
    with torch.no_grad():
        out = torch.zeros_like(nee)
        sub = torch.nonzero(nee).flatten()
        if sub.numel():
            so = tuple(v[sub] for v in q)
            sd = tuple(v[sub] for v in l)
            la = sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2]
            shadow = nearest(S, so, sd, tm[sub], la, 1.0 / la)
            out[sub] = shadow.t >= thresh[sub]
    return out


def trace_media(M: MediaScene, leaves: dict, rays, lane_ids, seed: int,
                max_depth: int, replay: Optional[List[Choices]] = None):
    """Each lane's radiance (L, 3) of the rays (origin (L, 3), direction
    (L, 3), time (L,)), bounce ``k`` salted with ``step_salt(seed, k)``,
    and each bounce's choices: made (``replay`` None), or replayed."""
    origin, direction, time = rays
    n = lane_ids.numel()
    dtype = origin.dtype
    one = torch.ones(n, dtype=dtype, device=origin.device)
    zero = torch.zeros_like(one)
    state = (*origin.unbind(1), *direction.unbind(1), time, one, one, one,
             zero, zero, zero)
    lane = lane_hash(lane_ids.long())
    code = torch.ones(n, dtype=torch.int32, device=origin.device)
    depth = torch.zeros_like(code)
    made = []
    for it in range(max_depth + 1 if replay is None else len(replay)):
        if replay is None and not bool((code > 0).any()):
            break
        state, code, depth, ch = media_bounce(
            M, leaves[DENSITY], leaves[ALBEDO], state, code, lane,
            step_salt(seed, it), depth, max_depth,
            None if replay is None else replay[it])
        made.append(ch)
    return torch.stack(state[10:13], dim=1), made


#: Lanes a block traces at once: under autograd, ~1 GB of saved tensors
#: on the card.
BLOCK = {"cuda": 1 << 18, "cpu": 1 << 14}


def _blocks(rays, seed: int, max_depth: int):
    """The ``trace_media`` arguments of each block of the rays' lanes."""
    n = rays[0].shape[0]
    step = BLOCK[rays[0].device.type]
    lane_ids = torch.arange(n, device=rays[0].device)
    return [dict(rays=tuple(r[s:s + step] for r in rays),
                 lane_ids=lane_ids[s:s + step], seed=seed,
                 max_depth=max_depth) for s in range(0, n, step)]


def render_image(M: MediaScene, leaves: dict, rays, *, spp: int, seed: int,
                 max_depth: int) -> torch.Tensor:
    """Each pixel's mean radiance (P, 3), without autograd."""
    with torch.no_grad():
        rad = torch.cat([trace_media(M, leaves, **b)[0]
                         for b in _blocks(rays, seed, max_depth)])
    return rad.reshape(-1, spp, 3).mean(dim=1)


def loss_and_grad(M: MediaScene, leaves: dict, rays, target, *, spp: int,
                  seed: int, max_depth: int):
    """(the mean squared error of the image against ``target`` (P, 3),
    its gradient in ``leaves``): a pass over every lane without autograd,
    then each block re-traced under it with its choices replayed and its
    lanes' cotangents pulled back."""
    blocks = _blocks(rays, seed, max_depth)
    with torch.no_grad():
        traced = [trace_media(M, leaves, **b) for b in blocks]
        img = torch.cat([rad for rad, _ in traced]).reshape(-1, spp, 3).mean(
            dim=1)
        loss = torch.mean((img - target) ** 2)
    # d loss / d lane radiance: each pixel's 2 (img - target) / (P x 3),
    # shared by its spp lanes.
    cot = (2.0 * (img - target) / img.numel() / spp).repeat_interleave(
        spp, dim=0).split([rad.shape[0] for rad, _ in traced])
    watched = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    keys = list(watched)
    total = [torch.zeros_like(watched[k]) for k in keys]
    for b, (_, replay), c in zip(blocks, traced, cot):
        with torch.enable_grad():
            rad, _ = trace_media(M, watched, replay=replay, **b)
            g = torch.autograd.grad((rad * c).sum(),
                                    [watched[k] for k in keys])
        total = [t + gk for t, gk in zip(total, g)]
    return loss, dict(zip(keys, total))


def start_leaves(start: dict, device, dtype) -> dict:
    """The fit's first leaves from the configuration's ``start``."""
    return {k: torch.as_tensor(np.asarray(start[k], np.float64)).to(device,
                                                                    dtype)
            for k in (DENSITY, ALBEDO)}


def camera_rays(cam, gen_seed: int, width: int, height: int, spp: int,
                device):
    """Every pixel's ``spp`` camera rays, in (pixel, sample) order, from
    ``gen_seed``'s generator."""
    pix = torch.arange(width * height, device=device).repeat_interleave(spp)
    gen = torch.Generator(device).manual_seed(int(gen_seed))
    return generator_rays(cam, gen, pix, width, height)


def steps_media(inputs: dict, camera: dict, *, width: int, height: int,
                spp: int, max_depth: int, seed: int, target_seed: int,
                feed_seeds, start: dict, lr: float, device,
                dtype=torch.float32) -> dict:
    """The fit's first ``len(feed_seeds)`` steps from ``start`` toward a
    target rendered at the true leaves from ``target_seed``'s generator:
    each step renders every pixel (``spp`` lanes each, camera rays from
    its generator), takes the mean squared error and descends the
    densities and albedos by SGD -> {"losses": [...], "state": [{leaf:
    (V,) or (V, 3) float64}, ...], "grad": the first step's {leaf:
    gradient}}."""
    with float32_only():
        M = build_media_scene(inputs, device, dtype)
        cam = make_camera(camera, device, dtype)
        kw = dict(spp=spp, seed=seed, max_depth=max_depth)
        target = render_image(M, leaves_of(inputs, device, dtype),
                              camera_rays(cam, target_seed, width, height,
                                          spp, device), **kw)
        leaves = start_leaves(start, device, dtype)
        out = {"losses": [], "state": [leaves], "grad": None}
        for gen_seed in feed_seeds:
            rays = camera_rays(cam, gen_seed, width, height, spp, device)
            loss, g = loss_and_grad(M, leaves, rays, target, **kw)
            leaves = {k: (v - lr * g[k]).detach() for k, v in leaves.items()}
            out["losses"].append(float(loss))
            out["state"].append(leaves)
            if out["grad"] is None:
                out["grad"] = g
    out["state"] = [{k: v.double().cpu().numpy() for k, v in s.items()}
                    for s in out["state"]]
    out["grad"] = {k: v.double().cpu().numpy() for k, v in out["grad"].items()}
    return out
