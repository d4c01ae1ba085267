"""The gradient kernels' lane code and the sorted lanes' keys built for
the host, against the plain PyTorch versions, on the CPU.

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
their lights, ``textures_scene`` (checker and noise, sky), the
4,096-triangle knot over a ground sphere (the hierarchy, unlit), the
sky-lit fog ball of ``tests/test_pallas_grad_volumes.py`` (a "s" volume:
the free-flight event before the miss) and ``smoke_scene`` with NEE (two
"r" boxes behind the lamp's light rows: the event, NEE from it, and the
shadow rays' transmittance), and three media of the three kinds around
two lamps of the two kinds with NEE (the light's distance in the
transmittance).

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
* K5's one NEE site: a lane set picked from the smoke box's second
  bounce that alternates a volume event, a diffuse surface hit, an
  emitter hit under MIS and an absorbed volume event, so that every warp
  of 32 lanes holds both NEE kinds between lanes that finish before the
  site, held to the plain version as the tapes are; and the plain
  version's ``nee_stats`` on 32x32 spp16 smoke and Cornell tapes against
  the forward's masks (the alive code 2 and the free-flight event).
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
* The sort keys (``csrc/sort_keys.cuh``, the lane code of
  ``csrc/sort_keys.cu``; ``rtow_host_sort_keys`` takes the live range over
  the lanes in order, then each key): equal bit for bit to
  :func:`keys.sort_keys_reference` on a packed state with a float32
  alive row, a window of it (row stride beyond L), the gradient path's
  rows with an int32 alive row, all lanes dead, one live lane and a live
  lane with a NaN direction.  The reference takes a correctly rounded
  float32 sqrt (float64, rounded once), as the card's and libm's are.
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
from rtow_tpu_torch.ops import bounce as bn
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import keys as ky
from rtow_tpu_torch.ops import tables as tb

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are many small PyTorch ops: one intra-op thread
    runs them as fast here and keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _knot():
    verts, faces = make_knot(64, 32)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    b.add_sphere((0.0, -101.0, 0.0), 100.0, b.add_metal((0.5, 0.5, 0.5), 0.1))
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device="cpu")
    return b.build(device="cpu"), cam


def _fog():
    """The sky-lit fog ball of tests/test_pallas_grad_volumes.py
    (``fog_setup``) over its gray ground."""
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.add_lambertian((0.5,) * 3))
    b.add_fog_sphere((0.0, 0.4, -1.0), 0.6, density=2.0,
                     albedo=(0.8, 0.7, 0.6))
    cam = make_camera(lookfrom=(0.0, 0.5, 1.8), lookat=(0.0, 0.3, -1.0),
                      fov_degrees=55.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device="cpu")
    return b.build(device="cpu"), cam


def _fogs():
    """A fog ball ("s"), a fog box ("b") and a rotated one ("r") over a
    ground sphere, black background, lit by a sphere lamp inside the ball
    and a quad lamp (two triangles, facing down) inside the box: shadow
    rays that end inside a medium, so the light's distance carries a
    cotangent into the transmittance, for both kinds of light."""
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.add_lambertian((0.5,) * 3))
    lamp = b.add_light((4.0, 3.5, 3.0))
    b.add_sphere((-0.6, 0.9, -1.2), 0.2, lamp)
    b.add_quad((0.3, 1.2, -1.4), (0.9, 1.2, -1.4), (0.9, 1.2, -0.8),
               (0.3, 1.2, -0.8), lamp)
    b.add_fog_sphere((-0.6, 0.9, -1.2), 0.5, density=0.8,
                     albedo=(0.8, 0.7, 0.6))
    b.add_fog_box((0.2, 0.9, -1.5), (1.0, 1.4, -0.7), 0.7,
                  albedo=(0.6, 0.8, 0.7))
    b.add_fog_box((-0.25, -0.5, -0.25), (0.25, 0.4, 0.25), 1.5,
                  albedo=(0.7, 0.6, 0.9), rotate_y=35.0,
                  translate=(0.0, 0.0, -1.0))
    cam = make_camera(lookfrom=(0.0, 0.5, 1.8), lookat=(0.0, 0.3, -1.0),
                      fov_degrees=55.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device="cpu")
    return b.build(background=(0.0, 0.0, 0.0), device="cpu"), cam


SCENES = {
    "light": (lambda: builders.light_scene(1.0, device="cpu"), True),
    "cornell": (lambda: builders.cornell_scene(1.0, device="cpu"), True),
    "textures": (lambda: builders.textures_scene(1.0, device="cpu"), False),
    "knot": (_knot, False),
    "fog": (_fog, False),
    "smoke": (lambda: builders.smoke_scene(1.0, device="cpu"), True),
    "fogs": (_fogs, True),
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
                                  p, p, p, p, i, i, i, i, i, i, i]
    lib.rtow_host_bwd.argtypes = [p, i, *tri, p, p, p, i, i, i, i, i, f, f, f,
                                  p, p, p, p, p, p, i, i, i, i, i, i, i, i]
    lib.rtow_host_sort_keys.argtypes = [p, ctypes.c_longlong, p, i, i, p, p,
                                        p]
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
        self.scene, self.lit = scene, tb.scene_lit(scene, nee=nee)
        self.tbl, _ = tb.build_sphere_table(scene)
        self.tris = tb.grad_tri_table(scene) if scene.n_triangles else None
        gen = torch.Generator().manual_seed(SEED)
        pix = torch.arange(SIZE * SIZE).repeat_interleave(SPP)
        s, t = pixel_coords(SIZE, SIZE, gen, pix)
        cont, ints = bn.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                                   "cpu")
        rng = np.random.default_rng(SEED)
        self.bounces = []
        for it in range(DEPTH + 1):
            cot = torch.from_numpy(rng.standard_normal((13, cont.shape[1]))
                                   .astype(np.float32))
            self.bounces.append(self.bounce(host, cont, ints, cot, it))
            cont, ints = self.bounces[-1]["fwd"][1]

    def bounce(self, host, cont, ints, cot, it):
        """Bounce ``it`` of the lanes (cont, ints) with the output
        cotangents ``cot``: the host's and the plain outputs of K4 and K5
        and their counters."""
        kw = dict(seed=SEED, max_depth=DEPTH,
                  background=self.scene.background, lit=self.lit)
        n, npad = cont.shape[1], self.tbl.shape[0]
        stats = torch.zeros(4, dtype=torch.int64)
        pc, pi = grad.bounce_fwd_reference(cont, ints, self.tbl, self.tris,
                                           it=it, stats=stats, **kw)
        hc, hi, hstats = self._host_fwd(host, cont, ints, it)
        nee_stats = torch.zeros(2, dtype=torch.int64)
        ci, sph, tri, rows = grad.bounce_bwd_terms(
            cont, ints, cot, self.tbl, self.tris, it=it, nee_stats=nee_stats,
            **kw)
        # The lanes bounce_bwd_terms lists its row terms for: those whose
        # main sweep hit a sphere / a triangle, in lane order.
        _a, best_t, best_k, _l, _s = grad._replay(
            cont, ints, self.tbl, self.tris, it, SEED, False, [0, 0, 0])
        hit = best_t < bn.BIG
        return dict(
            inputs=(cont, ints), live=ints[0] > 0, fwd=((hc, hi), (pc, pi)),
            tri_rows=torch.where(hit & (best_k >= npad), best_k - npad, -1),
            stats=(hstats, stats.tolist()), nee_stats=nee_stats.tolist(),
            host=self._host_bwd(host, cont, ints, cot, it),
            plain=(ci, _dense(sph, torch.nonzero(hit & (best_k < npad))
                              .flatten(), n, 16),
                   None if tri is None else _dense(
                       tri, torch.nonzero(hit & (best_k >= npad)).flatten(),
                       n, 14),
                   rows))

    def _common(self, it):
        tris = grad._tri_args(self.tris, False)
        use_sky, bg = tb.background_args(self.scene.background)
        return tris, (it, SEED, DEPTH, int(use_sky), *bg)

    def _lit(self):
        lit = self.lit
        return (_ptr(lit.rows), int(lit.emissive), len(lit.nee_kinds),
                tb.kind_bits(lit.nee_kinds, "st"), int(lit.checker),
                len(lit.vol_kinds), tb.kind_bits(lit.vol_kinds, "sbr"),
                lit.vol_row0)

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
        r = tb.lit_rows(self.lit)
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


def _k5_close(case, b, what, touched):
    """A bounce's K5 parts, the host's against the plain version's on the
    lanes whose K4 outputs agreed (:func:`_close`); adds to ``touched``
    the lanes with sphere, triangle, light and volume row cotangents."""
    same = _agree(b)
    for j, (got, want) in enumerate(zip(b["host"], b["plain"])):
        part = what + (("cot_in", "sphere rows", "triangle rows",
                        "light rows")[j],)
        assert (got is None) == (want is None), part
        if got is None:
            continue
        if j == 0:
            _close(got[:, same], want[:, same], 1, part)
            continue
        if j == 3:
            vols = want[same, case.lit.vol_row0:]
            touched[3] += int((vols != 0).flatten(1).any(dim=1).sum())
        got, want = got[same].flatten(1), want[same].flatten(1)
        _close(got, want, 0, part)
        touched[j - 1] += int((want != 0).any(dim=1).sum())


@pytest.mark.parametrize("name", list(SCENES))
def test_k5_lanes_match_bounce_bwd_terms(host, name):
    case = _case(host, name)
    touched = [0, 0, 0, 0]  # sphere, triangle, light and volume rows
    for it, b in enumerate(case.bounces):
        _k5_close(case, b, (name, it), touched)
    assert (touched[0] > 0) == bool(case.scene.n_spheres)
    assert (touched[1] > 0) == (case.tris is not None)
    assert (touched[2] > 0) == (case.lit.rows is not None)
    assert (touched[3] > 0) == bool(case.lit.vol_kinds)


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


#: The NEE counts' tapes: 32x32 at 16 samples per pixel, so a warp of 32
#: lanes holds two pixels' samples, as on the media trainer's 400x400 tape.
COUNT_SIZE, COUNT_SPP = 32, 16


def _nee_lanes(tbl, tris, lit, cont, ints, it, alive_out):
    """(volume, surface) masks of the lanes that run NEE's adjoint in
    bounce ``it``, from the forward alone: its alive code 2 (``alive_out``)
    marks a diffuse or volume scatter under NEE, and the free-flight event
    tells the two apart."""
    _a, best_t, _k, lane, salt = grad._replay(cont, ints, tbl, tris, it,
                                              SEED, False, [0, 0, 0])
    nee = alive_out == 2
    event = bn.volume_event(tuple(cont.unbind(0)), bn.draw_scatter(lane, salt),
                            lane, salt, best_t, lit)
    vol = nee & event[0] if event is not None else torch.zeros_like(nee)
    return vol, nee & ~vol


def _merged_warps(vol, surf) -> int:
    """The warps (lanes 32 w .. 32 w + 31) that hold both kinds."""
    return int((vol.view(-1, 32).any(1) & surf.view(-1, 32).any(1)).sum())


@pytest.mark.parametrize("name", ["smoke", "cornell"])
def test_k5_nee_stats_count_merged_warps(name):
    """The plain K5's ``nee_stats`` on a tape with NEE (the trainers'
    depth, chained through the plain K4): the NEE lanes at volume events
    and the warps whose NEE lanes hold a volume event and a surface hit,
    as the forward's outputs give them.  On the smoke box most warps that
    run NEE merge past the camera bounce; the Cornell box has no media,
    so none does."""
    scene, cam = getattr(builders, f"{name}_scene")(1.0, device="cpu")
    lit = tb.scene_lit(scene, nee=True)
    tbl, _ = tb.build_sphere_table(scene)
    tris = tb.grad_tri_table(scene)
    gen = torch.Generator().manual_seed(SEED)
    pix = torch.arange(COUNT_SIZE * COUNT_SIZE).repeat_interleave(COUNT_SPP)
    s, t = pixel_coords(COUNT_SIZE, COUNT_SIZE, gen, pix)
    cont, ints = bn.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                               "cpu")
    kw = dict(seed=SEED, max_depth=DEPTH, background=scene.background,
              lit=lit)
    cot = torch.ones((13, pix.numel()))
    nee_lanes = 0
    for it in range(DEPTH + 1):
        nee_stats = torch.zeros(2, dtype=torch.int64)
        grad.bounce_bwd_reference(cont, ints, cot, tbl, tris, it=it,
                                  nee_stats=nee_stats, **kw)
        out_c, out_i = grad.bounce_fwd_reference(cont, ints, tbl, tris,
                                                 it=it, **kw)
        vol, surf = _nee_lanes(tbl, tris, lit, cont, ints, it, out_i[0])
        merged = _merged_warps(vol, surf)
        assert nee_stats.tolist() == [int(vol.sum()), merged], it
        nee_warps = int((vol | surf).view(-1, 32).any(1).sum())
        nee_lanes += int((vol | surf).sum())
        if name == "cornell":
            assert merged == 0, it
        elif 1 <= it < DEPTH:
            assert merged > 0.8 * nee_warps, (it, merged, nee_warps)
        cont, ints = out_c, out_i
    assert nee_lanes > 0


def test_k5_lanes_alternating_kinds_match_bounce_bwd_terms(host):
    """A lane set picked from the smoke box's second bounce with NEE that
    alternates a volume event, a diffuse surface hit, an emitter hit under
    MIS and a volume event at depth (absorbed), so that each warp's one NEE
    site serves both kinds beside lanes that finished before it: the host's
    K5 holds to the plain version as on the tapes, the forward gives each
    kind its alive code, and the plain ``nee_stats`` count every warp
    merged."""
    case = _case(host, "smoke")
    it = 1
    b = case.bounces[it]
    cont, ints = b["inputs"]
    alive_out = b["fwd"][1][1][0]
    vol, surf = _nee_lanes(case.tbl, case.tris, case.lit, cont, ints, it,
                           alive_out)
    _a, best_t, _k, _l, _s = grad._replay(cont, ints, case.tbl, case.tris,
                                          it, SEED, False, [0, 0, 0])
    emit = (ints[0] == 2) & (best_t < bn.BIG) & (alive_out == 0)
    k = min(int(vol.sum()) // 2, int(surf.sum()), int(emit.sum())) // 8 * 8
    assert k >= 8, k
    v = torch.nonzero(vol).flatten()
    idx = torch.stack([v[:k], torch.nonzero(surf).flatten()[:k],
                       torch.nonzero(emit).flatten()[:k], v[k:2 * k]],
                      dim=1).flatten()
    lanes, lane_ints = cont[:, idx].contiguous(), ints[:, idx].contiguous()
    lane_ints[1, 3::4] = DEPTH  # the fourth lane's event: at depth
    cot = torch.from_numpy(np.random.default_rng(SEED)
                           .standard_normal((13, 4 * k)).astype(np.float32))
    mixed = case.bounce(host, lanes, lane_ints, cot, it)
    kinds = mixed["fwd"][1][1][0].view(-1, 4)
    assert (kinds == torch.tensor([2, 2, 0, 0], dtype=kinds.dtype)).all()
    assert mixed["nee_stats"] == [k, k // 8]
    assert _agree(mixed).view(-1, 4).any(dim=0).all()
    touched = [0, 0, 0, 0]
    _k5_close(case, mixed, ("alternating", it), touched)
    assert all(touched[1:]), touched  # triangle, light, volume rows


def _key_case(name):
    """(ray, alive) of the sort-key case ``name``: 20,000 lanes of random
    origins and directions, 80% live (numpy seed)."""
    rng = np.random.default_rng(11)
    n = 20_000
    st = np.zeros((16, n), np.float32)
    st[0:3] = rng.uniform(-1.2, 1.2, (3, n))
    st[3:6] = rng.normal(size=(3, n))
    st[13] = (rng.random(n) < 0.8) * rng.integers(1, 3, n)
    state = torch.from_numpy(st)
    if name == "packed":
        return state, state[13]
    if name == "window":  # row stride 20,000 over 4,096 lanes
        return state[:, :4096], state[13, :4096]
    if name == "grad_int32":
        return state[:13].clone(), state[13].to(torch.int32)
    if name == "all_dead":
        state[13] = 0.0
    elif name == "one_live":
        state[13] = 0.0
        state[13, 777] = 1.0
    elif name == "nan_direction":
        state[4, 5] = float("nan")
        state[13, 5] = 1.0
    return state, state[13]


@pytest.mark.parametrize("name", ["packed", "window", "grad_int32",
                                  "all_dead", "one_live", "nan_direction"])
def test_sort_keys_lanes_match_plain(host, name, monkeypatch):
    """The key kernel's lane code, run over the lanes on the host, gives
    the plain version's keys bit for bit; dead lanes ``DEAD_KEY``."""
    ray, alive = _key_case(name)
    bmin = torch.tensor([-1.0, -0.9, -0.5])
    inv_ext = 1.0 / torch.tensor([2.0, 1.8, 1.0])
    got = torch.empty(ray.shape[1], dtype=torch.int64)
    host.rtow_host_sort_keys(ray.data_ptr(), ray.stride(0), alive.data_ptr(),
                             int(alive.dtype == torch.float32), ray.shape[1],
                             bmin.data_ptr(), inv_ext.data_ptr(),
                             got.data_ptr())
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())
    want = ky.sort_keys_reference(ray, alive, bmin, inv_ext)
    assert torch.equal(got, want), int((got != want).sum())
    live = alive > 0
    assert bool((got[~live] == ky.DEAD_KEY).all())
    assert bool((got[live] < (1 << 30)).all())
    if name == "nan_direction":  # every live direction code 0
        assert not bool((got[live] & 0o0707070707).any())
