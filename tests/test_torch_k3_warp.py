"""K3's warp form on the CPU: the warp's cooperative triangle sweep
against the serial one.

``rtow_tpu_torch/csrc/bounce.cuh``'s ``nearest_triangle_warp`` runs the
32 threads of a warp on one ray: it slab-tests 32 boxes of a level at
once, visits the candidates in table order (testing one again where the
best t fell since), and sweeps a block 32 rows at a time before taking
the least (t, row) over the lanes.  ``csrc/host_lanes.cpp`` builds it for
the host (g++ ``-O2 -std=c++17 -ffp-contract=off``), where one thread
plays the 32 lanes one after another, beside the serial
``nearest_triangle`` that K3's thread form and K1, K4 and K5 run.  The
two must agree bit for bit on every ray: the best t, the winner row and
the counts of box and triangle tests (the serial walk's, counted once per
ray).  The tests skip only where there is no g++.

Tables: ``samples/knot_small.obj`` at its sorted-wavefront block width
(flat: 8 blocks of 256 rows), the 4,096-triangle knot in 128-row blocks
(2 supers), the same knot with every triangle twice (4 supers: exact
ties, which the lower row must win), and the 65,536-triangle knot in the
gradient path's Morton table (512 blocks of 128 rows: 32 supers, 2
hypers); each one-sided and two-sided.  Rays (numpy and torch
generators, seeded): camera rays from the front, random rays from around
the mesh, and shadow rays from points on the mesh toward random
directions from a finite t_init (the NEE sweep's threshold).
"""
import ctypes
import functools
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import mesh_scene
from rtow_tpu_torch.models.camera import camera_rays, make_camera
from rtow_tpu_torch.models.camera import pixel_coords
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import megakernel as mk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402
from test_torch_lanes_host import build_host_lanes  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the host lanes")

N_RAYS, SEED = 2048, 7
BIG = 3.0e38  # bounce.cuh's kBig: a main sweep's starting t


def _knot(segments, rings, twice=False):
    verts, faces = make_knot(segments, rings)
    if twice:
        faces = np.concatenate([faces, faces])
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    return b.build(device="cpu")


@functools.lru_cache(maxsize=None)
def _table(name):
    if name == "flat":
        scene, _ = mesh_scene(Config(model=os.path.join(
            ROOT, "samples", "knot_small.obj"), device="cpu"))
        block = mk.pick_tri_block(scene.n_triangles)
        tris = mk.build_tri_table(scene, block)
        assert (tris.n_blocks, tris.n_super) == (8, 0)
    elif name == "supers":
        scene = _knot(64, 32)
        tris = mk.build_tri_table(scene, 128)
        assert (tris.n_blocks, tris.n_super, tris.n_hyper) == (32, 2, 0)
    elif name == "twins":
        scene = _knot(64, 32, twice=True)
        tris = mk.build_tri_table(scene, 128)
        assert (tris.n_blocks, tris.n_super, tris.n_hyper) == (64, 4, 0)
    else:
        scene = _knot(256, 128)
        tris = grad.grad_tri_table(scene)
        assert (tris.n_blocks, tris.n_super, tris.n_hyper) == (512, 32, 2)
    return scene, tris


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = build_host_lanes(tmp_path_factory.mktemp("host_lanes"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rtow_host_sweep.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p, i, i,
                                    p, p, p]
    return lib


def _rays(scene, kind):
    """(rays (7, n) float32, t_init (n,) float32) of one kind."""
    rng = np.random.default_rng(SEED)
    verts = scene.triangles.verts.numpy()
    lo, hi = verts.reshape(-1, 3).min(0), verts.reshape(-1, 3).max(0)
    if kind == "camera":
        side = int(np.sqrt(N_RAYS))
        cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                          focus_dist=3.0, device="cpu")
        gen = torch.Generator().manual_seed(SEED)
        s, t = pixel_coords(side, side, gen, torch.arange(side * side))
        r = camera_rays(cam, gen, s, t)
        rays = torch.cat([r.origin.T, r.direction.T, r.time[None]]).float()
        return rays.contiguous(), torch.full((side * side,), BIG)
    if kind == "random":  # from a box 1.5x the mesh's, any direction
        mid, half = (lo + hi) / 2, (hi - lo) * 0.75
        org = mid + half * rng.uniform(-1.0, 1.0, (N_RAYS, 3))
        t_init = np.full(N_RAYS, BIG)
    else:  # shadow rays: from points on the mesh, t_init finite
        tri = verts[rng.integers(0, verts.shape[0], N_RAYS)]
        u, v = rng.uniform(0.0, 1.0, (2, N_RAYS, 1))
        u, v = np.where(u + v > 1.0, 1.0 - u, u), np.where(u + v > 1.0,
                                                           1.0 - v, v)
        org = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2]
                                                              - tri[:, 0])
        t_init = rng.uniform(0.05, 2.0, N_RAYS) * (1.0 - 1e-3)
    d = rng.standard_normal((N_RAYS, 3))
    rays = np.concatenate([org, d, np.zeros((N_RAYS, 1))], axis=1).T
    return (torch.from_numpy(np.ascontiguousarray(rays, np.float32)),
            torch.from_numpy(t_init.astype(np.float32)))


def _sweep(host, tris, cull, rays, t_init, warp):
    n = rays.shape[1]
    t_out = torch.empty(n, dtype=torch.float32)
    k_out = torch.empty(n, dtype=torch.int32)
    stats = (ctypes.c_ulonglong * 2)()
    host.rtow_host_sweep(tris.tbl.data_ptr(), tris.boxes.data_ptr(),
                         tris.supers.data_ptr(), tris.hypers.data_ptr(),
                         tris.n_blocks, tris.n_super, tris.n_hyper,
                         tris.block, tris.count, int(cull), rays.data_ptr(),
                         t_init.data_ptr(), n, int(warp), t_out.data_ptr(),
                         k_out.data_ptr(), stats)
    return t_out, k_out, list(stats)


@pytest.mark.parametrize("kind", ["camera", "random", "shadow"])
@pytest.mark.parametrize("cull", [True, False], ids=["one", "two"])
@pytest.mark.parametrize("table", ["flat", "supers", "twins", "hypers"])
def test_warp_sweep_bit_identical_to_serial(host, table, cull, kind):
    scene, tris = _table(table)
    rays, t_init = _rays(scene, kind)
    t_s, k_s, c_s = _sweep(host, tris, cull, rays, t_init, warp=False)
    t_w, k_w, c_w = _sweep(host, tris, cull, rays, t_init, warp=True)
    assert torch.equal(k_w, k_s)
    assert torch.equal(t_w.view(torch.int32), t_s.view(torch.int32))
    assert c_w == c_s
    # The rays do reach the table: hits, misses and swept blocks.
    hit = float((k_s >= 0).float().mean())
    assert 0.02 < hit < 0.98, hit
    assert c_s[1] > 32 * N_RAYS // 4 and c_s[0] >= tris.n_blocks
    assert bool((t_s[k_s >= 0] < t_init[k_s >= 0]).all())
    assert torch.equal(t_s[k_s < 0], t_init[k_s < 0])
