"""K5's warp form on the CPU: the backward bounce under the ``Warp`` sweep
policy against the serial one, lane by lane.

K5's triangle instances run one warp per live lane where a launch has few
live lanes (``csrc/grad_bwd.cu``'s ``grad_bwd_warp``): the 32 threads
replay the lane's main and shadow sweeps together
(``nearest_triangle_warp``) and run the adjoint on the same inputs, lane 0
alone writing.  ``csrc/host_lanes.cpp``'s ``rtow_host_bwd_by`` builds
``bounce_lane_adjoint_t`` under either policy for the host (g++ ``-O2
-std=c++17 -ffp-contract=off``), the warp's 32 lanes played one after
another in one thread, each lane's parts kept apart.  The two forms must
agree bit for bit on every lane's input cotangents, its winner and row
cotangent (added once), its light-row cotangents, and on the counters
(box tests, triangle tests, live lanes, shadow rays): the warp sweep finds
the serial sweep's winner, so every decision is the same.  The tests skip
only where there is no g++.

Tables: the 65,536-triangle knot in the gradient path's Morton table (512
blocks of 128 rows: 32 supers, 2 hypers; 3 with the lamps) and the
4,096-triangle knot with
every triangle twice (64 blocks, 4 supers: exact ties, which the lower
row must win), each unlit under the sky and lit by two square lamps on
black with NEE (shadow sweeps through the hierarchy), one- and two-sided.
Lanes: every bounce's input state of one forward from the camera's rays
(the host's K4, chained), with standard-normal output cotangents (numpy
seed).
"""
import ctypes
import functools
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from rtow_tpu_torch.models.camera import camera_rays, make_camera
from rtow_tpu_torch.models.camera import pixel_coords
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import bounce as bn
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import tables as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402
from test_torch_lanes_host import build_host_lanes  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the host lanes")

SIZE, SPP, DEPTH, SEED = 16, 2, 4, 5


@functools.lru_cache(maxsize=None)
def _scene(table, lit):
    """(scene, camera) of a knot: the 65k knot ("hypers") or the 4k knot
    with twin rows ("twins"), under the sky or lit by two square lamps
    on black."""
    verts, faces = make_knot(*((256, 128) if table == "hypers" else (64, 32)))
    if table == "twins":
        faces = np.concatenate([faces, faces])
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    if lit:
        lamp = b.add_light((4.0, 4.0, 4.0))
        b.add_quad((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0.5, 1.5, 0.5),
                   (-0.5, 1.5, 0.5), lamp)
        b.add_quad((1.5, -0.5, -0.5), (1.5, -0.5, 0.5), (1.5, 0.5, 0.5),
                   (1.5, 0.5, -0.5), lamp)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device="cpu")
    scene = b.build(background=(0.0, 0.0, 0.0) if lit else "sky",
                    device="cpu")
    return scene, cam


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    lib = build_host_lanes(tmp_path_factory.mktemp("host_lanes"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tri = [p, p, p, p, i, i, i, i, i]
    lib.rtow_host_bwd_by.argtypes = [p, i, *tri, p, p, p, i, i, i, i, i, f,
                                     f, f, p, p, p, p, p, p, i, i, i, i, i,
                                     i, i, i, i, i]
    return lib


class _Case:
    """One table's tape: each bounce's input state and output cotangents."""

    def __init__(self, host, table, lit):
        scene, cam = _scene(table, lit)
        self.scene, self.lit = scene, tb.scene_lit(scene, nee=lit)
        self.tbl, _ = tb.build_sphere_table(scene)
        self.tris = tb.grad_tri_table(scene)
        # Both go down the hierarchy (the lamps' 4 triangles add blocks).
        assert self.tris.n_super >= 4
        assert (self.tris.n_hyper >= 2) == (table == "hypers")
        gen = torch.Generator().manual_seed(SEED)
        pix = torch.arange(SIZE * SIZE).repeat_interleave(SPP)
        s, t = pixel_coords(SIZE, SIZE, gen, pix)
        cont, ints = bn.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                                   "cpu")
        rng = np.random.default_rng(SEED)
        self.tape = []
        for it in range(DEPTH + 1):
            cot = torch.from_numpy(rng.standard_normal((13, cont.shape[1]))
                                   .astype(np.float32))
            self.tape.append((cont, ints, cot, it))
            cont, ints = self._fwd(host, cont, ints, it)

    def _args(self, it):
        use_sky, bg = tb.background_args(self.scene.background)
        return (grad._tri_args(self.tris, False),
                (it, SEED, DEPTH, int(use_sky), *bg))

    def _lit_args(self):
        lit = self.lit
        return ((None if lit.rows is None else lit.rows.data_ptr()),
                int(lit.emissive), len(lit.nee_kinds),
                tb.kind_bits(lit.nee_kinds, "st"), int(lit.checker),
                len(lit.vol_kinds), tb.kind_bits(lit.vol_kinds, "sbr"),
                lit.vol_row0)

    def _fwd(self, host, cont, ints, it):
        tris, scalars = self._args(it)
        co, io = torch.empty_like(cont), torch.empty_like(ints)
        stats = (ctypes.c_ulonglong * 4)()
        host.rtow_host_fwd(self.tbl.data_ptr(), self.tbl.shape[0], *tris,
                           cont.data_ptr(), ints.data_ptr(), cont.shape[1],
                           *scalars, co.data_ptr(), io.data_ptr(), stats,
                           *self._lit_args())
        return co, io

    def bwd(self, host, b, warp, cull):
        """(cot_in, winner, gw, g_rows, counters) of tape entry ``b``."""
        cont, ints, cot, it = self.tape[b]
        tris, scalars = self._args(it)
        n = cont.shape[1]
        r = tb.lit_rows(self.lit)
        cot_in = torch.empty_like(cot)
        winner = torch.empty(n, dtype=torch.int32)
        gw = torch.empty((n, 16))
        g_rows = torch.zeros((n, max(r, 1), 14))
        stats = (ctypes.c_ulonglong * 4)()
        lit = self._lit_args()
        host.rtow_host_bwd_by(self.tbl.data_ptr(), self.tbl.shape[0], *tris,
                              cont.data_ptr(), ints.data_ptr(),
                              cot.data_ptr(), n, *scalars, cot_in.data_ptr(),
                              winner.data_ptr(), gw.data_ptr(),
                              g_rows.data_ptr(), stats, lit[0], r, *lit[1:],
                              int(warp), int(cull))
        return cot_in, winner, gw, g_rows, list(stats)


_CASES = {}


def _case(host, table, lit):
    if (table, lit) not in _CASES:
        _CASES[table, lit] = _Case(host, table, lit)
    return _CASES[table, lit]


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("cull", [True, False], ids=["one", "two"])
@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
@pytest.mark.parametrize("table", ["hypers", "twins"])
def test_warp_backward_bit_identical_to_thread(host, table, lit, cull):
    case = _case(host, table, lit)
    live = tri_hits = shadows = row_lanes = 0
    for b in range(len(case.tape)):
        t_in, t_k, t_gw, t_rows, t_c = case.bwd(host, b, False, cull)
        w_in, w_k, w_gw, w_rows, w_c = case.bwd(host, b, True, cull)
        assert torch.equal(_bits(w_in), _bits(t_in)), b
        assert torch.equal(w_k, t_k), b
        assert torch.equal(_bits(w_gw[t_k >= 0]), _bits(t_gw[t_k >= 0])), b
        assert torch.equal(_bits(w_rows), _bits(t_rows)), b
        assert w_c == t_c, (b, w_c, t_c)
        live += t_c[2]
        shadows += t_c[3]
        tri_hits += int((t_k >= case.tbl.shape[0]).sum())
        row_lanes += int((t_rows != 0).flatten(1).any(dim=1).sum())
    # The tape reaches the table: live lanes, triangle winners, and with
    # the lamps shadow rays and light-row cotangents.
    assert live > SIZE * SIZE * SPP and tri_hits > SIZE * SIZE // 4
    assert (shadows > 0) == lit
    assert (row_lanes > 0) == lit
