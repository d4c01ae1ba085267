"""K1's culled sphere sweep on the CPU: the row groups' sweep against the
brute-force one.

K1 (``csrc/megakernel.cu``) slab-tests the boxes of the sphere table's
Morton-ordered row groups (``megakernel.sphere_groups``, of
``SPHERE_GROUP`` = 16 rows each) and sweeps only the groups a ray enters
before its current best t; its plain version is
``megakernel.nearest_sphere_culled``.  Inside a group the rows and the strict ``<`` are the brute-force sweep's, and a
group skipped holds no row hit below the best t, so the culled sweep must
give the brute-force ``nearest_sphere``'s (t, k) bit for bit, on every ray:
camera rays, random rays, rays grazing group boxes and spheres, and
shadow rays from hit points with a finite ``t_init`` (the NEE sweep's
threshold), on the static and the moving cover, each laid out from four
seeds (four ball fields, so four Morton tables and sets of group boxes).
Also: every row's motion-swept bound (over the camera's shutter) lies in
its group's box, and the counters (box tests, rows swept) equal a count
made here in numpy float32, ray by ray.
"""
import functools

import numpy as np
import pytest
import torch

from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import cover_scene
from rtow_tpu_torch.ops import bounce as bn
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.ops import tables as tb
from rtow_tpu_torch.utils.rng import lane_hash, mix, step_salt

N_RAYS, SEED = 1024, 3
#: The cover's layout seeds: each lays out another ball field.
SCENE_SEEDS = (0, 1, 2, 3)


@functools.lru_cache(maxsize=None)
def _cover(moving, scene_seed=0):
    scene, cam = cover_scene(Config(device="cpu", moving_spheres=moving,
                                    image_width=64, seed=scene_seed))
    tbl, _ = tb.build_sphere_table(scene)
    return scene, cam, tbl


def _camera_rays(cam, n):
    """Camera rays as K1 regenerates them (lens and shutter jitter)."""
    vec = [float(x) for x in tb.pack_camera(cam)]
    g = torch.arange(n, dtype=torch.int64)
    side = int(np.sqrt(n))
    lane = lane_hash(g)
    salt = step_salt(SEED, 0)
    fcol = (g % side).to(torch.float32)
    frow = (g // side).to(torch.float32)
    inv = float(np.float32(1.0) / np.float32(side - 1))
    return mk.camera_ray(vec, lane, salt, fcol, frow, inv, inv)


def _sweep_both(tbl, groups, ray, t_init=None):
    ox, oy, oz, dx, dy, dz, tm = ray
    a = dx * dx + dy * dy + dz * dz
    brute = bn.nearest_sphere(tbl, ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a,
                              t_init=t_init)
    tally = [0] * 5
    culled = bn.nearest_sphere_culled(tbl, groups, ox, oy, oz, dx, dy, dz,
                                      tm, a, 1.0 / a, t_init=t_init,
                                      tally=tally)
    return brute, culled, tally


def _rays(scene, cam, tbl, kind):
    """(ray 7-tuple of (n,) float32 tensors, t_init or None) of one kind."""
    rng = np.random.default_rng(SEED)
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if kind == "camera":
        return _camera_rays(cam, N_RAYS), None
    n = N_RAYS
    sp = scene.spheres
    c0, r = sp.center0.numpy(), np.abs(sp.radius.numpy())
    small = np.nonzero(r < 10.0)[0]
    tm = rng.uniform(0.0, 1.0, n)
    if kind == "random":  # from around the ball field, any direction
        org = rng.uniform([-12.0, 0.05, -12.0], [12.0, 3.0, 12.0], (n, 3))
        d = rng.standard_normal((n, 3))
    elif kind == "graze":
        # Half aimed at group-box corners and edges, half tangent to a
        # sphere at time tm (|d| x distance off by ~1e-6 of the radius).
        org = rng.uniform([-12.0, 0.05, -12.0], [12.0, 3.0, 12.0], (n, 3))
        boxes = tb.sphere_groups(tbl).numpy()
        boxes = boxes[boxes[:, 0] < boxes[:, 3]]
        b = boxes[rng.integers(0, len(boxes), n // 2)]
        pick = rng.integers(0, 2, (n // 2, 3))
        corner = np.where(pick == 0, b[:, 0:3], b[:, 3:6])
        edge = rng.integers(0, 3, n // 2)
        mix = rng.uniform(0.0, 1.0, n // 2)
        corner[np.arange(n // 2), edge] = (
            b[np.arange(n // 2), edge] * (1 - mix)
            + b[np.arange(n // 2), 3 + edge] * mix)
        k = small[rng.integers(0, len(small), n - n // 2)]
        c = c0[k] + tm[n // 2:, None] * sp.dcenter.numpy()[k]
        to_c = c - org[n // 2:]
        u = rng.standard_normal((len(k), 3))
        u -= (u * to_c).sum(1, keepdims=True) / (to_c * to_c).sum(
            1, keepdims=True) * to_c
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        side = r[k, None] * (1.0 + rng.uniform(-1e-6, 1e-6, (len(k), 1)))
        d = np.concatenate([corner - org[:n // 2], c + side * u
                            - org[n // 2:]])
    else:  # shadow rays from the camera rays' hits, a finite t_init
        ray = _camera_rays(cam, n)
        ox, oy, oz, dx, dy, dz, tmc = ray
        a = dx * dx + dy * dy + dz * dz
        t, _ = bn.nearest_sphere(tbl, *ray, a, 1.0 / a)
        t = torch.where(t < bn.BIG, t, 1.0)
        org = np.stack([(o + t * dd).numpy() for o, dd in
                        ((ox, dx), (oy, dy), (oz, dz))], axis=1)
        d = rng.standard_normal((n, 3))
        d[:, 1] = np.abs(d[:, 1])  # toward the sky, through the field
        tm = tmc.numpy()
        t_init = f32(rng.uniform(0.05, 20.0, n) * (1.0 - 1e-3))
        return tuple(f32(x) for x in (*org.T, *d.T, tm)), t_init
    return tuple(f32(x) for x in (*org.T, *d.T, tm)), None


@pytest.mark.parametrize("scene_seed", SCENE_SEEDS)
@pytest.mark.parametrize("kind", ["camera", "random", "graze", "shadow"])
@pytest.mark.parametrize("moving", [True, False], ids=["moving", "static"])
def test_culled_sweep_bit_identical_to_brute_force(moving, kind, scene_seed):
    scene, cam, tbl = _cover(moving, scene_seed)
    ray, t_init = _rays(scene, cam, tbl, kind)
    groups = tb.sphere_groups(tbl, tb.camera_shutter(tb.pack_camera(cam)))
    (bt, bk), (ct, ck), tally = _sweep_both(tbl, groups, ray, t_init)
    assert torch.equal(ck, bk)
    assert torch.equal(ct.view(torch.int32), bt.view(torch.int32))
    # The rays reach the table, and the cull skips rows.
    hit = float(((bt < (bn.BIG if t_init is None else t_init))
                 ).float().mean())
    assert 0.02 < hit <= 1.0, hit
    n_groups = tbl.shape[0] // tb.SPHERE_GROUP
    assert tally[3] == n_groups * N_RAYS
    assert 0 < tally[4] < tbl.shape[0] * N_RAYS


@pytest.mark.parametrize("scene_seed", SCENE_SEEDS)
@pytest.mark.parametrize("shutter", [(0.0, 1.0), (-0.5, 1.5)],
                         ids=["unit", "wide"])
@pytest.mark.parametrize("moving", [True, False], ids=["moving", "static"])
def test_rows_inside_their_group_box(moving, shutter, scene_seed):
    scene, _, tbl = _cover(moving, scene_seed)
    width = tb.SPHERE_GROUP
    boxes = tb.sphere_groups(tbl, shutter).numpy()
    assert boxes.shape == (tbl.shape[0] // width, 8)
    t = tbl.numpy().astype(np.float64)
    n = scene.n_spheres
    times = np.linspace(min(shutter[0], 0.0), max(shutter[1], 1.0), 9)
    for k in range(n):
        box = boxes[k // width]
        for tm in times:
            c = t[k, 0:3] + tm * t[k, 3:6]
            r = abs(t[k, 6])
            assert np.all(box[0:3] <= c - r) and np.all(c + r <= box[3:6]), (
                k, tm)
    # Padding rows are left out: a group of padding only lies at +inf,
    # where no ray enters it.
    rng = np.random.default_rng(SEED)
    org = tuple(torch.from_numpy(x) for x in rng.uniform(
        -20.0, 20.0, (3, N_RAYS)).astype(np.float32))
    inv = tuple(1.0 / torch.from_numpy(x) for x in rng.standard_normal(
        (3, N_RAYS)).astype(np.float32))
    lanes = torch.arange(N_RAYS)
    for g in range(-(-n // width), len(boxes)):
        assert np.all(boxes[g, 0:6] == np.inf)
        assert bn.box_entered(boxes[g].tolist(), org, inv,
                              torch.full((N_RAYS,), bn.BIG),
                              lanes).numel() == 0


def _numpy_count(tbl, groups, ray, t_init):
    """(box tests, rows swept) of the culled sweep, ray by ray in numpy
    float32: the kernel's slab test and row test, in table order."""
    f = np.float32
    T = tbl.numpy()
    B = groups.numpy()
    w = tb.SPHERE_GROUP
    ox, oy, oz, dx, dy, dz, tm = (v.numpy() for v in ray)
    boxes = rows = 0
    for i in range(ox.shape[0]):
        o = np.array([ox[i], oy[i], oz[i]], f)
        d = np.array([dx[i], dy[i], dz[i]], f)
        a = f(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        inv_a = f(f(1.0) / a)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = f(1.0) / d
        bt = f(bn.BIG) if t_init is None else f(t_init[i])
        for g in range(B.shape[0]):
            boxes += 1
            with np.errstate(invalid="ignore", over="ignore"):
                t0 = (B[g, 0:3] - o) * inv
                t1 = (B[g, 3:6] - o) * inv
            lo, hi = np.fmin(t0, t1), np.fmax(t0, t1)
            enter = np.fmax(np.fmax(lo[0], lo[1]), np.fmax(lo[2],
                                                          f(bn.T_MIN)))
            exit_ = np.fmin(np.fmin(hi[0], hi[1]), np.fmin(hi[2], bt))
            if not exit_ > enter:
                continue
            rows += w
            for k in range(g * w, (g + 1) * w):
                c = T[k, 0:3] + tm[i] * T[k, 3:6]
                oc = o - c
                h = f(f(f(oc[0] * d[0]) + f(oc[1] * d[1])) + f(oc[2] * d[2]))
                cc = f(f(f(f(oc[0] * oc[0]) + f(oc[1] * oc[1]))
                         + f(oc[2] * oc[2])) - f(T[k, 6] * T[k, 6]))
                disc = f(f(h * h) - f(a * cc))
                if not disc > 0:
                    continue
                sq = np.sqrt(disc)
                near = f(f(-h - sq) * inv_a)
                v = near if near >= bn.T_MIN else f(f(-h + sq) * inv_a)
                if v >= bn.T_MIN and v < bt:
                    bt = v
    return boxes, rows


@pytest.mark.parametrize("scene_seed", SCENE_SEEDS)
@pytest.mark.parametrize("kind", ["camera", "shadow"])
def test_counters_equal_a_numpy_count(kind, scene_seed):
    scene, cam, tbl = _cover(True, scene_seed)
    ray, t_init = _rays(scene, cam, tbl, kind)
    ray = tuple(v[:96] for v in ray)
    t_init = None if t_init is None else t_init[:96]
    groups = tb.sphere_groups(tbl)
    _, _, tally = _sweep_both(tbl, groups, ray, t_init)
    assert tuple(tally[3:]) == _numpy_count(tbl, groups, ray, t_init)


def test_ground_group_entered_by_rays_at_the_ground():
    """The r = 1000 ground sphere's group box spans the ball field, so
    every camera ray that hits the ground, and every ray leaving the
    ground in any direction, sweeps that group (``chip_smoke.py`` bounds
    its share of the rows swept by its width times the sweeps)."""
    scene, cam, tbl = _cover(True)
    ground = int(torch.nonzero(tbl[:, tb._R] == 1000.0))
    cam_ray, _ = _rays(scene, cam, tbl, "camera")
    a = cam_ray[3] * cam_ray[3] + cam_ray[4] * cam_ray[4] + cam_ray[5] ** 2
    _, k = bn.nearest_sphere(tbl, *cam_ray, a, 1.0 / a)
    lanes = torch.nonzero(k == ground).flatten()
    assert lanes.numel() > N_RAYS // 8
    for kind in ("camera", "shadow"):  # shadow: from the camera rays' hits
        ray, _ = _rays(scene, cam, tbl, kind)
        inv = tuple(1.0 / d for d in ray[3:6])
        box = tb.sphere_groups(tbl)[ground // tb.SPHERE_GROUP].tolist()
        entered = bn.box_entered(box, ray[:3], inv,
                                 torch.full((N_RAYS,), bn.BIG), lanes)
        assert torch.equal(entered, lanes), kind
