"""The gradient kernels' lane code built for the host, against the plain
PyTorch versions, on the CPU.

``rtow_tpu_torch/csrc/host_lanes.cpp`` includes ``bounce.cuh`` and
``bounce_adjoint.cuh`` with ``RTOW_HD`` defined as ``inline`` and runs K4's
per-lane bounce and K5's per-lane adjoint in loops over lanes.  g++ builds
it here with ``-O2 -std=c++17 -ffp-contract=off`` (no multiply-add
contraction, as the kernels' ``-fmad=false``); the tests skip only where
there is no g++.  This is the only check of the hand-written adjoint that
runs without a card: on the card K5 sums each lane's row cotangents with
atomics before anything can compare them; here every lane's parts stay
apart.

The lanes are real ones: every bounce's input state of one plain forward
(:func:`grad.bounce_fwd_reference`, chained over ``depth + 1`` bounces
from the camera's rays), with standard-normal output cotangents (numpy
seed).  Scenes: ``light_scene`` and ``cornell_scene`` with NEE toward
their lights, ``textures_scene`` (checker and noise, sky), and the
4,096-triangle knot over a ground sphere (the hierarchy, unlit).

* K4: each bounce's outputs against the plain version's.  The alive
  codes, bounce counts and lane ids are equal on every lane, and so are
  the counters (box tests, triangle tests, live lanes, shadow rays).  The
  floats are bit-identical apart from at most ``FLIP_SHARE`` of the live
  lane-bounces, and there within ``K4_TOL`` of the row's largest |plain|:
  PyTorch's float32 sin, cos and sqrt on the CPU are vectorised and not
  correctly rounded, so they differ from libm's sinf / cosf and the
  scalar sqrtf in the last bit (the scatter's draws, the sphere light's
  cone sample, a root of the sphere quadratic).  Measured: 0-16% of a
  bounce's live lanes, 4.4% of all, at most 7.4e-6 of the scale.
* K5: each lane's input cotangents, and its row cotangents (the winner
  sphere's, the winner triangle's, the light rows'), against
  :func:`grad.bounce_bwd_terms` on the lanes whose K4 outputs agreed:
  every entry within ``GRAD_TOL`` of its row's / column's largest |plain|
  and ``CLOSE_SHARE`` of them within ``CLOSE_TOL``, each with ``FLOOR``
  of the part's largest |plain| added (a column whose true cotangent is
  0 holds rounding of a sum that cancels, 1e-11 beside the row's 1e-5).
  Measured: at most 3.7e-6 of the scale.
* P4 (ROADMAP Queue 3): on the knot, each triangle-table entry's terms
  summed in float64, the host's against the plain version's, within
  ``SUM_TOL`` of the column's largest sum of |terms|.  The edge columns
  (e1, e2) carry the cancellation of t's derivative, ao / det + t d / det
  with |ao| ~ 60 |p - v0| on the knot, so a different rounding of the
  adjoint's terms moves them by far more than a different order of the
  sums does.  Measured at 24x24: 2.8e-7 (e2's y column), v0's columns
  equal; 2.0e-6 before the triangle adjoint summed t's cotangent and took
  the determinant's as autograd does, (g_pz dz + g_py dy) + g_px dx and
  -g_t (t / det).
"""
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import camera_rays, make_camera
from rtow_tpu_torch.models.camera import pixel_coords
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import megakernel as mk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the host lanes")

SIZE, SPP, DEPTH, SEED = 24, 4, 8, 3
#: K4: the share of live lane-bounces whose floats may differ in any bit,
#: and by how much of the row's largest |plain|.
FLIP_SHARE, K4_TOL = 0.08, 1e-4
#: K5: per lane, against the row's / column's largest |plain|, with FLOOR
#: of the part's largest added.
GRAD_TOL, FLOOR = 1e-3, 1e-6
CLOSE_TOL, CLOSE_SHARE = 1e-5, 0.995
#: P4: float64 sums of the triangle terms, against the column's largest
#: sum of |terms|.
SUM_TOL = 5e-7


def _knot():
    verts, faces = make_knot(64, 32)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    b.add_sphere((0.0, -101.0, 0.0), 100.0, b.add_metal((0.5, 0.5, 0.5), 0.1))
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device="cpu")
    return b.build(device="cpu"), cam


SCENES = {
    "light": (lambda: builders.light_scene(1.0, device="cpu"), True),
    "cornell": (lambda: builders.cornell_scene(1.0, device="cpu"), True),
    "textures": (lambda: builders.textures_scene(1.0, device="cpu"), False),
    "knot": (_knot, False),
}


def build_host_lanes(out_dir):
    """csrc/host_lanes.cpp built by g++ into ``out_dir``, loaded, with its
    entry points declared."""
    out = os.path.join(str(out_dir), "librtow_host_lanes.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out,
         os.path.join(ROOT, "rtow_tpu_torch", "csrc", "host_lanes.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tri = [p, p, p, p, i, i, i, i, i]
    lib.rtow_host_fwd.argtypes = [p, i, *tri, p, p, i, i, i, i, i, f, f, f,
                                  p, p, p, p, i, i, i, i]
    lib.rtow_host_bwd.argtypes = [p, i, *tri, p, p, p, i, i, i, i, i, f, f, f,
                                  p, p, p, p, p, p, i, i, i, i, i]
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host_lanes(tmp_path_factory.mktemp("host_lanes"))


def _ptr(t):
    return None if t is None else t.data_ptr()


class _Case:
    """One scene's tape, and each bounce's host and plain outputs."""

    def __init__(self, host, name):
        build, nee = SCENES[name]
        scene, cam = build()
        self.scene, self.lit = scene, grad.grad_lit(scene, nee)
        self.tbl, _ = mk.build_sphere_table(scene)
        self.tris = grad.grad_tri_table(scene) if scene.n_triangles else None
        gen = torch.Generator().manual_seed(SEED)
        pix = torch.arange(SIZE * SIZE).repeat_interleave(SPP)
        s, t = pixel_coords(SIZE, SIZE, gen, pix)
        cont, ints = mk.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                                   "cpu")
        rng = np.random.default_rng(SEED)
        kw = dict(seed=SEED, max_depth=DEPTH, background=scene.background,
                  lit=self.lit)
        npad = self.tbl.shape[0]
        self.bounces = []
        for it in range(DEPTH + 1):
            n = cont.shape[1]
            stats = torch.zeros(4, dtype=torch.int64)
            pc, pi = grad.bounce_fwd_reference(cont, ints, self.tbl,
                                               self.tris, it=it, stats=stats,
                                               **kw)
            hc, hi, hstats = self._host_fwd(host, cont, ints, it)
            cot = torch.from_numpy(rng.standard_normal((13, n))
                                   .astype(np.float32))
            ci, sph, tri, rows = grad.bounce_bwd_terms(
                cont, ints, cot, self.tbl, self.tris, it=it, **kw)
            # The lanes bounce_bwd_terms lists its row terms for: those
            # whose main sweep hit a sphere / a triangle, in lane order.
            _a, best_t, best_k, _l, _s = grad._replay(
                cont, ints, self.tbl, self.tris, it, SEED, False, [0, 0, 0])
            hit = best_t < mk.BIG
            self.bounces.append(dict(
                live=ints[0] > 0, fwd=((hc, hi), (pc, pi)),
                tri_rows=torch.where(hit & (best_k >= npad), best_k - npad,
                                     -1),
                stats=(hstats, stats.tolist()),
                host=self._host_bwd(host, cont, ints, cot, it),
                plain=(ci, _dense(sph, torch.nonzero(hit & (best_k < npad))
                                  .flatten(), n, 16),
                       None if tri is None else _dense(
                           tri, torch.nonzero(hit & (best_k >= npad))
                           .flatten(), n, 14),
                       rows)))
            cont, ints = pc, pi

    def _common(self, it):
        tris = grad._tri_args(self.tris, False)
        use_sky, bg = mk.background_args(self.scene.background)
        return tris, (it, SEED, DEPTH, int(use_sky), *bg)

    def _lit(self):
        lit = self.lit
        return (_ptr(lit.rows), int(lit.emissive), len(lit.nee_kinds),
                mk._kind_bits(lit.nee_kinds, "st"), int(lit.checker))

    def _host_fwd(self, host, cont, ints, it):
        tris, scalars = self._common(it)
        co, io = torch.empty_like(cont), torch.empty_like(ints)
        stats = (ctypes.c_ulonglong * 4)()
        host.rtow_host_fwd(self.tbl.data_ptr(), self.tbl.shape[0], *tris,
                           cont.data_ptr(), ints.data_ptr(), cont.shape[1],
                           *scalars, co.data_ptr(), io.data_ptr(), stats,
                           *self._lit())
        return co, io, list(stats)

    def _host_bwd(self, host, cont, ints, cot, it):
        """(cot_in, sphere rows (n, 16), triangle rows (n, 14) or None,
        light rows (n, R, 14) or None), each lane's own."""
        tris, scalars = self._common(it)
        n, npad = cont.shape[1], self.tbl.shape[0]
        r = mk.lit_rows(self.lit)
        cot_in = torch.empty_like(cot)
        winner = torch.empty(n, dtype=torch.int32)
        gw = torch.empty((n, 16))
        g_rows = torch.zeros((n, max(r, 1), 14))
        stats = (ctypes.c_ulonglong * 4)()
        lit = self._lit()
        host.rtow_host_bwd(self.tbl.data_ptr(), npad, *tris,
                           cont.data_ptr(), ints.data_ptr(), cot.data_ptr(),
                           n, *scalars, cot_in.data_ptr(), winner.data_ptr(),
                           gw.data_ptr(), g_rows.data_ptr(), stats, lit[0], r,
                           *lit[1:])
        is_sph = (winner >= 0) & (winner < npad)
        return (cot_in, torch.where(is_sph[:, None], gw, 0.0),
                None if self.tris is None
                else torch.where((winner >= npad)[:, None], gw, 0.0)[:, :14],
                g_rows[:, :r] if r else None)


def _dense(terms, lanes, n, cols):
    """(n, cols) per-lane row cotangents from (rows, values) terms of
    ``lanes``; 0 elsewhere."""
    out = torch.zeros((n, cols))
    out[lanes, :terms[1].shape[1]] = terms[1]
    return out


_CASES = {}


def _case(host, name):
    if name not in _CASES:
        _CASES[name] = _Case(host, name)
    return _CASES[name]


def _agree(b):
    """The lanes whose K4 outputs are bit-identical."""
    (hc, hi), (pc, pi) = b["fwd"]
    return (hc == pc).all(dim=0) & (hi == pi).all(dim=0)


@pytest.mark.parametrize("name", list(SCENES))
def test_k4_lanes_match_plain(host, name):
    case = _case(host, name)
    off = live = shadows = tris = 0
    for it, b in enumerate(case.bounces):
        (hc, hi), (pc, pi) = b["fwd"]
        assert torch.equal(hi, pi), it
        h, p = b["stats"]
        assert h == p, (it, h, p)
        scale = pc.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        assert float(((hc - pc).abs() / scale).max()) <= K4_TOL, it
        same = _agree(b)
        assert same[~b["live"]].all(), it  # dead lanes are copied
        off += int((~same).sum())
        live += int(b["live"].sum())
        shadows += p[3]
        tris += p[1]
    assert off <= FLIP_SHARE * live, (off, live)
    # The features ran: NEE cast shadow rays; the knot swept triangles.
    assert (shadows > 0) == bool(case.lit.nee_kinds)
    assert (tris > 0) == (case.tris is not None)


def _close(got, want, dim, what):
    """Every entry within GRAD_TOL of its row's / column's max |want|,
    CLOSE_SHARE of them within CLOSE_TOL of it, each with FLOOR of the
    part's largest |want| added."""
    scale = want.abs().amax(dim=dim, keepdim=True)
    floor = float(scale.max()) * FLOOR
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all()), what
    worst = float((d / (GRAD_TOL * scale + floor).clamp_min(1e-30)).max())
    assert worst <= 1.0, (what, worst)
    close = float((d <= CLOSE_TOL * scale + floor).float().mean())
    assert close >= CLOSE_SHARE, (what, close)


@pytest.mark.parametrize("name", list(SCENES))
def test_k5_lanes_match_bounce_bwd_terms(host, name):
    case = _case(host, name)
    touched = [0, 0, 0]
    for it, b in enumerate(case.bounces):
        same = _agree(b)
        for j, (got, want) in enumerate(zip(b["host"], b["plain"])):
            what = (name, it, ("cot_in", "sphere rows", "triangle rows",
                               "light rows")[j])
            assert (got is None) == (want is None), what
            if got is None:
                continue
            if j == 0:
                _close(got[:, same], want[:, same], 1, what)
                continue
            got, want = got[same].flatten(1), want[same].flatten(1)
            _close(got, want, 0, what)
            touched[j - 1] += int((want != 0).any(dim=1).sum())
    assert touched[0] > 0
    assert (touched[1] > 0) == (case.tris is not None)
    assert (touched[2] > 0) == bool(case.lit.nee_kinds)


def test_k5_triangle_terms_sum_as_plain(host):
    """P4: the knot's triangle-table cotangent, each entry's terms summed
    in float64 over the tape's lanes that K4 agreed on, the host's against
    the plain version's, within SUM_TOL of the column's largest sum of
    |terms| (every column that has terms)."""
    case = _case(host, "knot")
    rows = case.tris.tbl.shape[0]
    sums = torch.zeros((3, rows, 14), dtype=torch.float64)
    for b in case.bounces:
        lanes = _agree(b) & (b["tri_rows"] >= 0)
        ids = b["tri_rows"][lanes]
        for j, part in enumerate((b["host"][2][lanes], b["plain"][2][lanes],
                                  b["plain"][2][lanes].abs())):
            sums[j].index_add_(0, ids, part.double())
    scale = sums[2].amax(dim=0)
    cols = scale > 0
    assert cols[:9].all()  # v0, e1, e2
    d = ((sums[0] - sums[1]).abs().amax(dim=0)[cols] / scale[cols])
    assert float(d.max()) <= SUM_TOL, d.tolist()
