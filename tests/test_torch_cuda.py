"""The CUDA kernels against their plain PyTorch versions, on the card:
the megakernel K1 (ops/megakernel.py, spheres and triangles, and its lit
instances: emission, NEE, media, textures, roulette; each under both
schedulers, the work pool and the classic one), the probes T1 and T2
(rtow_tpu_torch/tools), the sorted
wavefront's bounce K3 (ops/flat_bounce.py) and the gradient bounces
K4 / K5 (ops/grad.py), with their lit instances (emission, NEE with the
light rows' cotangent, textures, media with the volume rows'), and K1's
and K3's two-sided triangles.

Marked ``cuda``: each test skips (with its reason) where
``torch.cuda.is_available()`` is false.  This file imports neither JAX
nor rtow_tpu, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, as in chip_smoke.py: both versions round every float32
operation alike (the kernel is built with -fmad=false, IEEE division and
sqrt) and use the same CUDA math library; at most 1% of pixels may be
off by more than 1e-4 of mean radiance (a last-bit difference can flip
a discrete choice), with mean |difference| at most 1e-3.  K1's lit and
two-sided instances, K3 and its lit instance (bounce by bounce from the
same input state) and K4 are bit-identical to their plain versions, with
the same counts of steps, box tests, triangle tests, shadow rays and live
lanes.
K5 sums its adjoint in another order than autograd and the table
gradient with atomics: per cot_in row and per g_tbl column, max |d| at
most 1e-3 of the largest |plain|; on lit scenes each table part's column
is held to its largest sum of |terms| (grad.bounce_bwd_terms), since a
column of mixed-sign terms can sum to far below its terms; a light-row
column to at least 1e-3 of the largest (a horizontal lamp's x and z
cotangents are 0, their terms rounding of sums that cancel).
"""
import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import (
    cornell_scene, cover_scene, light_scene, mesh_scene, smoke_scene,
    textures_scene, three_sphere_scene,
)
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.camera import camera_rays, pixel_coords
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import flat_bounce as fb
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.ops import wavefront as wf

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _frames(scene, cam, width, height, spp, depth):
    tbl, tris = mk.scene_k1_tables(scene)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(1, width=width, height=height, spp=spp,
                         max_depth=depth),
            mk.n_tiles_for(width, height))
    kw = dict(background=scene.background, tris=tris)
    before = mk.render_blocks.launches
    kern = mk.render_blocks(*args, **kw)
    assert mk.render_blocks.launches == before + 1
    plain = mk.render_blocks_reference(*args, **kw)
    assert mk.render_blocks.launches == before + 1
    torch.cuda.synchronize()
    return (mk.unblock_image(*kern, width=width, height=height) / spp,
            mk.unblock_image(*plain, width=width, height=height) / spp)


@pytest.mark.parametrize("name", ["three_sphere", "cover", "knot_small"])
def test_kernel_matches_plain_on_card(dev, name):
    if name == "cover":
        scene, cam = cover_scene(Config(image_width=200,
                                        aspect_ratio=16 / 9), device=dev)
    elif name == "knot_small":  # 1,920 triangles: K1's triangle sweep
        scene, cam = mesh_scene(Config(
            image_width=200, aspect_ratio=16 / 9,
            model=os.path.join(ROOT, "samples", "knot_small.obj")),
            device=dev)
    else:
        scene, cam = three_sphere_scene(16 / 9, device=dev)
    kern, plain = _frames(scene, cam, 200, 112, 4, 50)
    assert bool(torch.isfinite(kern).all())
    d = (kern - plain).abs().amax(dim=1)
    assert float((d > 1e-4).float().mean()) <= 0.01
    assert float((kern - plain).abs().mean()) <= 1e-3


@pytest.mark.parametrize("name", ["lights", "cornell", "textures", "smoke",
                                  "checker", "roulette"])
def test_lit_kernel_matches_plain_on_card(dev, name):
    """K1's lit instances: bit-identical to the plain version, with equal
    counters (steps, box and triangle tests, shadow rays); each launch
    counted as a lit launch."""
    builders = {"lights": light_scene, "cornell": cornell_scene,
                "textures": textures_scene, "smoke": smoke_scene}
    if name in builders:
        scene, cam = builders[name](1.0, device=dev)
        depth = 8
    else:
        scene, cam = cover_scene(Config(image_width=128, aspect_ratio=1.0,
                                        checker_ground=name == "checker"),
                                 device=dev)
        depth = 50
    tbl, tris = mk.scene_k1_tables(scene)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(3, width=128, height=128, spp=2, max_depth=depth),
            mk.n_tiles_for(128, 128))
    kw = dict(background=scene.background, tris=tris,
              lit=mk.scene_lit(scene, name == "roulette"))
    out, counts = [], []
    before = mk.render_blocks.lit_launches
    for fn in (mk.render_blocks, mk.render_blocks_reference):
        c = [torch.zeros(n, dtype=torch.int64, device=dev) for n in (1, 2, 1)]
        planes = fn(*args, **kw, steps=c[0], tests=c[1], shadows=c[2])
        out.append(mk.unblock_image(*planes, width=128, height=128) / 2)
        counts.append(torch.cat(c).tolist())
    assert mk.render_blocks.lit_launches == before + 1
    kern, plain = out
    assert bool(torch.isfinite(kern).all()) and float(kern.mean()) > 0
    assert torch.equal(kern, plain)
    assert counts[0] == counts[1]
    if name in ("lights", "cornell", "smoke"):
        assert counts[0][3] > 0  # NEE cast shadow rays


@pytest.mark.parametrize("spp", [24, 17])
def test_exact_sample_accounting_on_card(dev, spp):
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device=dev)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    scene = b.build(background=(1.0, 1.0, 1.0), device=dev)
    sums = mk.render_spheres(scene, cam, 0, width=24, height=24, spp=spp,
                             max_depth=4)
    assert bool((sums == spp).all())


def _pool_scene(dev, name):
    """(scene, camera, roulette, depth) of a K1 instance for the pool's
    card tests: the cover (spheres), the knot one- and two-sided
    (triangles), the Cornell box (lit, triangles), the smoke box (lit
    media) and the cover with roulette (lit, spheres)."""
    if name in ("cover", "roulette"):
        scene, cam = cover_scene(Config(image_width=130, aspect_ratio=1.3),
                                 device=dev)
        return scene, cam, name == "roulette", 50
    if name in ("cornell", "smoke"):
        scene, cam = {"cornell": cornell_scene,
                      "smoke": smoke_scene}[name](1.3, device=dev)
        return scene, cam, False, 8
    scene, cam = mesh_scene(Config(
        image_width=130, aspect_ratio=1.3,
        model=os.path.join(ROOT, "samples", "knot_small.obj")), device=dev)
    return scene, cam, False, 20


@pytest.mark.parametrize("name", ["cover", "knot", "knot_two_sided",
                                  "cornell", "smoke", "roulette"])
def test_pool_kernel_bit_identical_to_plain_on_card(dev, name):
    """K1's pool instances against the plain pool at 130x100 (a partial
    tile column: 126 of its lanes take the image columns' items), spp 20
    (two chunks, the second of 4 samples): bit-identical planes and equal
    counters (steps, box and triangle tests, shadow rays, lane slots);
    each launch counted as a pool launch.  The classic instance's slots
    agree too."""
    scene, cam, roulette, depth = _pool_scene(dev, name)
    tbl, tris = mk.scene_k1_tables(scene)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(5, width=130, height=100, spp=20, max_depth=depth),
            mk.n_tiles_for(130, 100))
    kw = dict(background=scene.background, tris=tris,
              lit=mk.scene_lit(scene, roulette),
              cull=name != "knot_two_sided")
    for pool in (True, False):
        out, counts = [], []
        before = mk.render_blocks.pool_launches
        for fn in (mk.render_blocks, mk.render_blocks_reference):
            c = [torch.zeros(n, dtype=torch.int64, device=dev)
                 for n in (1, 2, 1, 1)]
            out.append(torch.stack(fn(*args, **kw, pool=pool, steps=c[0],
                                      tests=c[1], shadows=c[2],
                                      slots=c[3])))
            counts.append(torch.cat(c).tolist())
        assert mk.render_blocks.pool_launches == before + pool
        assert bool(torch.isfinite(out[0]).all()) and float(out[0].mean()) > 0
        assert torch.equal(out[0], out[1]), name
        assert counts[0] == counts[1], (name, pool, counts)
        assert 0 < counts[0][0] <= counts[0][4]


@pytest.mark.parametrize("width,spp", [(24, 24), (24, 17), (130, 17),
                                       (130, 40)])
def test_pool_exact_sample_accounting_on_card(dev, width, spp):
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device=dev)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    scene = b.build(background=(1.0, 1.0, 1.0), device=dev)
    sums = mk.render_spheres(scene, cam, 0, width=width, height=24, spp=spp,
                             max_depth=4, pool=True)
    assert bool((sums == spp).all())


def test_probes_match_plain_on_card(dev):
    """T1's four kinds and T2 against their plain versions: "vpu" bit for
    bit (the same float32 operations); "mxu_f" within 1e-5 of
    max(|plain|, iters) (its fetch is a 3xTF32 product: a parameter keeps
    ~21 of its 24 bits, the sweep's decisions are the plain version's,
    and where a lane's terms cancel its output is small); "mxu" and "mxu_b"
    (h and c in 3xTF32 against float32, then a quadratic that cancels on
    the r = 1000 ground sphere) within 1e-3 relative on all but 1% of the
    lanes; T2 exact on ones, 1e-5 relative on uniform data."""
    from rtow_tpu_torch.tools import mxu_probe, repro_nb_slice

    ins = [torch.from_numpy(x).to(dev) for x in mxu_probe.inputs(2, 4)]
    plain = mxu_probe.probe_reference("vpu", *ins, n_blocks=2, iters=3)
    for kind in mxu_probe.KINDS:
        before = mxu_probe.probe.launches
        got = mxu_probe.probe(kind, *ins, n_blocks=2, iters=3)
        want = mxu_probe.probe_reference(kind, *ins, n_blocks=2, iters=3)
        assert mxu_probe.probe.launches == before + 1
        rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).cpu()
        if kind == "vpu":
            assert torch.equal(got, want) and torch.equal(got, plain)
        elif kind == "mxu_f":
            assert float(((got - want).abs()
                          / want.abs().clamp(min=3.0)).max()) <= 1e-5
        else:
            assert float((rel > 1e-3).float().mean()) <= 0.01
    for width in (128, 256):
        for nb in (1, 300, 1408):
            ones = torch.ones((nb, 16, width), device=dev)
            assert bool((repro_nb_slice.nb_slice(ones) == nb * 2048).all())
            rand = torch.rand((nb, 16, width), device=dev)
            got = repro_nb_slice.nb_slice(rand)
            want = repro_nb_slice.nb_slice_reference(rand)
            assert torch.equal(got, got[0, 0].expand(8, 128))
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


def test_table_larger_than_shared_memory_raises(dev):
    tbl = torch.zeros((4 * 1024, 16), dtype=torch.float32, device=dev)
    cam = torch.zeros(21, dtype=torch.float32, device=dev)
    meta = mk.pack_meta(0, width=8, height=8, spp=1, max_depth=1)
    with pytest.raises(ValueError, match="shared-memory"):
        mk.render_blocks(tbl, cam, meta, 1)


def _knot(dev, segments, rings):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_mesh import make_knot

    verts, faces = make_knot(segments, rings)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    b.add_sphere((0.0, -101.0, 0.0), 100.0, b.add_metal((0.5,) * 3, 0.1))
    return b.build(device=dev)


@pytest.mark.parametrize("segments,rings", [(16, 12), (64, 64)])
def test_flat_bounce_matches_plain_on_card(dev, segments, rings):
    """K3's thread and warp forms against its plain version at every
    bounce of a sorted loop: the 384- and 8,192-triangle knots over a
    ground sphere, 64x64 spp4."""
    scene = _knot(dev, segments, rings)
    tables, bmin, inv_ext = wf.scene_tables(scene)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    pix = torch.arange(64 * 64, device=dev).repeat_interleave(4)
    s, t = pixel_coords(64, 64, gen, pix)
    tape = []
    before = fb.bounce_step.launches
    wf.trace_lanes(wf.lane_state(camera_rays(cam, gen, s, t), pix.numel()),
                   9, max_depth=20, tables=tables, bmin=bmin,
                   inv_ext=inv_ext, tape=tape)
    assert fb.bounce_step.launches == before + len(tape) > 3
    for state, it in tape:
        (kern, kc), (warp, wc), (plain, pc) = _k3_forms(state, it, 9, 20,
                                                        tables)
        assert torch.equal(kern, plain), it
        assert torch.equal(warp, plain), it
        assert kc == pc == wc, it


def test_render_auto_launches_k3_for_large_meshes(dev):
    scene = _knot(dev, 128, 72)  # 18,432 triangles
    cfg = Config(image_width=32, aspect_ratio=1.0, samples_per_pixel=4,
                 max_child_rays=6)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, device=dev)
    from rtow_tpu_torch.pipeline import render_auto

    k1, k3 = mk.render_blocks.launches, fb.bounce_step.launches
    img = render_auto(scene, cam, cfg)
    assert mk.render_blocks.launches == k1
    assert fb.bounce_step.launches > k3
    assert np.isfinite(img).all() and img.shape == (32, 32, 3)


def lit_knot_scene(dev, name, segments=64, rings=64):
    """The 8,192-triangle knot (the super level) lit as the CPU tests
    light it: under two quad lamps on black ("quad_lamps"), with a fog
    ball and a sphere lamp ("fog_lamp"), beside checker and noise spheres
    under the sky ("textures"), or under the sky alone ("roulette")."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_mesh import make_knot

    verts, faces = make_knot(segments, rings)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    bg = "sky"
    if name == "quad_lamps":
        lamp = b.add_light((4.0, 4.0, 4.0))
        b.add_quad((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0.5, 1.5, 0.5),
                   (-0.5, 1.5, 0.5), lamp)
        b.add_quad((1.5, -0.5, -0.5), (1.5, -0.5, 0.5), (1.5, 0.5, 0.5),
                   (1.5, 0.5, -0.5), lamp)
        bg = (0.0, 0.0, 0.0)
    elif name == "fog_lamp":
        b.add_fog_sphere((0.4, 0.0, 0.0), 0.6, 1.5, albedo=(0.8, 0.9, 0.7))
        b.add_sphere((0.0, 1.5, 0.5), 0.3, b.add_light((8.0, 8.0, 8.0)))
        bg = (0.0, 0.0, 0.0)
    elif name == "textures":
        b.add_sphere((-0.9, 0.3, 0.6), 0.35, b.add_checker(
            (0.9, 0.9, 0.9), (0.1, 0.2, 0.3), scale=20.0))
        b.add_sphere((0.9, -0.3, 0.6), 0.35, b.add_noise(
            (0.9, 0.8, 0.7), (0.2, 0.1, 0.1), scale=6.0))
    return b.build(background=bg, device=dev)


def _k3_tape(dev, scene, roulette=False, cull=True):
    """(tables, tape) of one sorted loop over the knot at 64x64 spp4
    depth 8, each launch's input state and step on the tape."""
    tables, bmin, inv_ext = wf.scene_tables(scene, roulette)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    pix = torch.arange(64 * 64, device=dev).repeat_interleave(4)
    s, t = pixel_coords(64, 64, gen, pix)
    tape = []
    wf.trace_lanes(wf.lane_state(camera_rays(cam, gen, s, t), pix.numel()),
                   9, max_depth=8, tables=tables, bmin=bmin, inv_ext=inv_ext,
                   background=scene.background, cull=cull, tape=tape)
    return tables, tape


@contextlib.contextmanager
def _warp_form():
    """``bounce_step`` picks K3's warp form for any live count."""
    cut = fb.WARP_MAX_LIVE
    fb.WARP_MAX_LIVE = 1 << 30
    try:
        yield
    finally:
        fb.WARP_MAX_LIVE = cut


def _k3_forms(state, it, seed, depth, tables, **kw):
    """[(thread form's output, counters), (warp form's, counters)] of one
    launch, and the plain version's, the counters [box tests, triangle
    tests, live lanes, shadow rays]; checks that the warp launch was
    counted as one."""
    out = []
    n_live = int((state[13] > 0).sum())
    for fn, live in ((fb.bounce_step, None), (fb.bounce_step, n_live),
                     (fb.bounce_step_reference, None)):
        c = [torch.zeros(n, dtype=torch.int64, device=state.device)
             for n in (3, 1)]
        before = fb.bounce_step.warp_launches
        with _warp_form():
            o = fn(state, it, seed, depth, tables, **kw, stats=c[0],
                   shadows=c[1], **({} if live is None else dict(live=live)))
        assert fb.bounce_step.warp_launches == before + (live is not None)
        torch.cuda.synchronize()
        out.append((o, torch.cat(c).tolist()))
    return out


def _k3_held(dev, scene, tables, tape, cull=True):
    """K3's two forms against its plain version at every launch of
    ``tape``: bit-identical, with equal box tests, triangle tests, live
    lanes and shadow rays.  Returns the kernel's shadow rays over the
    tape."""
    n_shadows = 0
    for state, it in tape:
        (kern, kc), (warp, wc), (plain, pc) = _k3_forms(
            state, it, 9, 8, tables, background=scene.background, cull=cull)
        assert torch.equal(kern, plain), it
        assert torch.equal(warp, plain), it
        assert kc == pc == wc, it
        n_shadows += kc[3]
    return n_shadows


@pytest.mark.parametrize("name", ["quad_lamps", "fog_lamp", "textures",
                                  "roulette"])
def test_flat_bounce_lit_matches_plain_on_card(dev, name):
    """K3's lit instances, both forms, at every launch of a sorted loop
    over the lit 8,192-triangle knot: bit-identical to the plain version
    with equal counters, each launch counted as a lit launch, the alive
    code 2 carried through the sort where NEE is on."""
    scene = lit_knot_scene(dev, name)
    tables, tape = _k3_tape(dev, scene, roulette=name == "roulette")
    assert tables.lit.any and tables.tris.n_super > 0
    before = fb.bounce_step.lit_launches
    n_shadows = _k3_held(dev, scene, tables, tape)
    assert len(tape) > 3  # both forms launched at each, lit
    assert fb.bounce_step.lit_launches == before + 2 * len(tape)
    nee = bool(tables.lit.nee_kinds)
    assert (n_shadows > 0) == nee
    assert any(bool((state[13] == 2).any()) for state, _ in tape) == nee


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_two_sided_matches_plain_on_card(dev, kernel):
    """K1 and K3 with two-sided triangles (``cull=False``) on the knot
    under two quad lamps, its winding reversed so that the camera sees
    the back faces: bit-identical to the plain versions with equal
    counters, and the render differs from the culled one."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_mesh import make_knot

    verts, faces = make_knot(64, 64 if kernel == "K3" else 32)
    b = SceneBuilder()
    b.add_mesh(verts[faces[:, ::-1]], b.add_lambertian((0.6, 0.5, 0.4)))
    lamp = b.add_light((4.0, 4.0, 4.0))
    b.add_quad((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0.5, 1.5, 0.5),
               (-0.5, 1.5, 0.5), lamp)
    scene = b.build(background=(0.0, 0.0, 0.0), device=dev)
    if kernel == "K3":
        tables, tape = _k3_tape(dev, scene, cull=False)
        assert _k3_held(dev, scene, tables, tape, cull=False) > 0
        return
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    tbl, tris = mk.scene_k1_tables(scene)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(3, width=128, height=128, spp=2, max_depth=8),
            mk.n_tiles_for(128, 128))
    kw = dict(background=scene.background, tris=tris,
              lit=mk.scene_lit(scene))
    out, counts = [], []
    for fn, cull in ((mk.render_blocks, False),
                     (mk.render_blocks_reference, False),
                     (mk.render_blocks, True)):
        c = [torch.zeros(n, dtype=torch.int64, device=dev) for n in (1, 2, 1)]
        out.append(torch.stack(fn(*args, **kw, steps=c[0], tests=c[1],
                                  shadows=c[2], cull=cull)))
        counts.append(torch.cat(c).tolist())
    assert torch.equal(out[0], out[1]) and counts[0] == counts[1]
    assert not torch.equal(out[0], out[2])


@pytest.mark.parametrize("n_live", [1, 31, 33, 1024])
@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
def test_flat_bounce_warp_form_at_live_counts(dev, lit, n_live):
    """K3's warp form, picked by ``bounce_step`` from a live count at or
    below ``WARP_MAX_LIVE``, on the second bounce of a sorted loop over
    the 8,192-triangle knot (over a ground sphere, or under two quad lamps
    with NEE: alive codes 1 and 2) with all but ``n_live`` lanes killed at
    random places: bit-identical to the plain version, counters equal, one
    warp launch."""
    scene = lit_knot_scene(dev, "quad_lamps") if lit else _knot(dev, 64, 64)
    tables, tape = _k3_tape(dev, scene)
    state, it = tape[1][0].clone(), tape[1][1]
    live = torch.nonzero(state[13] > 0).flatten()
    assert live.numel() >= n_live
    assert bool((state[13] == 2).any()) == lit
    gen = torch.Generator().manual_seed(n_live)
    keep = live[torch.randperm(live.numel(), generator=gen)[:n_live]
                .to(dev)]
    state[13] = torch.where(torch.isin(torch.arange(state.shape[1],
                                                    device=dev), keep),
                            state[13], 0.0)
    assert n_live <= fb.WARP_MAX_LIVE
    outs = []
    for fn, kw in ((fb.bounce_step, dict(live=n_live)),
                   (fb.bounce_step_reference, {})):
        c = [torch.zeros(n, dtype=torch.int64, device=dev) for n in (3, 1)]
        before = fb.bounce_step.warp_launches
        out = fn(state, it, 9, 8, tables, background=scene.background,
                 stats=c[0], shadows=c[1], **kw)
        assert fb.bounce_step.warp_launches == before + bool(kw)
        torch.cuda.synchronize()
        outs.append((out, torch.cat(c).tolist()))
    (warp, wc), (plain, pc) = outs
    assert torch.equal(warp, plain)
    assert wc == pc and wc[2] == n_live


def test_nb_slice_one_launch_bit_identical_on_card(dev):
    """T2 at the JAX script's 8 sizes and at NB = 1 and 300: one launch a
    call, its output bit-identical to the kernel's order of the sums in
    plain PyTorch (``nb_slice_ordered``) call after call (the ticket
    counter is back at 0 after each), on a second stream, and replayed
    from a CUDA graph."""
    from rtow_tpu_torch.tools import repro_nb_slice as rs

    for width in rs.WIDTHS:
        for nb in (1, 300) + rs.DEFAULT_NB:
            tbl = torch.rand((nb, 16, width), device=dev)
            want = rs.nb_slice_ordered(tbl)
            before = rs.nb_slice.launches
            for _ in range(3):
                assert torch.equal(rs.nb_slice(tbl), want), (nb, width)
            assert rs.nb_slice.launches == before + 3
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = rs.nb_slice(tbl)  # also makes the side stream's scratch
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [rs.nb_slice(tbl) for _ in range(4)]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def _grad_tape(dev, depth=8):
    """The cover at 64x64, spp 2: the (depth + 1) input states of one
    forward through K4, and the table."""
    scene, cam = cover_scene(Config(image_width=64, aspect_ratio=1.0),
                             device=dev)
    tbl, _ = mk.build_sphere_table(scene)
    gen = torch.Generator(dev).manual_seed(2)
    pix = torch.arange(64 * 64, device=dev).repeat_interleave(2)
    s, t = pixel_coords(64, 64, gen, pix)
    cont, ints = mk.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                               dev)
    tape = []
    for it in range(depth + 1):
        tape.append((cont, ints))
        cont, ints = grad.bounce_fwd(cont, ints, tbl, it=it, seed=3,
                                     max_depth=depth)
    return tbl, tape


def test_grad_fwd_kernel_bit_identical_to_plain(dev):
    tbl, tape = _grad_tape(dev)
    for it, (cont, ints) in enumerate(tape):
        kw = dict(it=it, seed=3, max_depth=8)
        before = grad.bounce_fwd.launches
        kc, ki = grad.bounce_fwd(cont, ints, tbl, **kw)
        assert grad.bounce_fwd.launches == before + 1
        pc, pi = grad.bounce_fwd_reference(cont, ints, tbl, **kw)
        assert torch.equal(kc, pc) and torch.equal(ki, pi), it


def test_grad_bwd_kernel_matches_plain(dev):
    tbl, tape = _grad_tape(dev)
    rng = np.random.default_rng(4)
    for it, (cont, ints) in enumerate(tape):
        kw = dict(it=it, seed=3, max_depth=8)
        cot = torch.from_numpy(rng.standard_normal(cont.shape)
                               .astype(np.float32)).to(dev)
        before = grad.bounce_bwd.launches
        kci, kg, kt, kr = grad.bounce_bwd(cont, ints, cot, tbl, **kw)
        assert grad.bounce_bwd.launches == before + 1
        pci, pg, pt, pr = grad.bounce_bwd_reference(cont, ints, cot, tbl,
                                                    **kw)
        assert kt is None and pt is None and kr is None and pr is None
        assert bool(torch.isfinite(kci).all() and torch.isfinite(kg).all())
        for k, p, dim in ((kci, pci, 1), (kg[:, :13], pg[:, :13], 0)):
            scale = p.abs().amax(dim=dim, keepdim=True)
            assert bool(((k - p).abs() <= 1e-3 * scale).all()), it
        assert not kg[:, 13:].any()


def test_grad_bwd_table_larger_than_shared_memory_raises(dev):
    tbl = torch.zeros((2048, 16), dtype=torch.float32, device=dev)
    cont = torch.zeros((13, mk.TILE), device=dev)
    ints = torch.zeros((3, mk.TILE), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared-memory"):
        grad.bounce_bwd(cont, ints, cont, tbl, it=0, seed=0, max_depth=1)


# ---------------------------------------------------------------------------
# K4 / K5 on meshes


def _mesh_grad_tape(dev, segments, rings, flat, depth=8):
    """The knot over a ground sphere at 64x64 spp4: the gradient path's
    tables and the (depth + 1) sorted input states of one forward through
    K4 (flat sweep or hierarchy), as render_rays_kernel hands them to
    each bounce."""
    scene = _knot(dev, segments, rings)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    gen = torch.Generator(dev).manual_seed(2)
    pix = torch.arange(64 * 64, device=dev).repeat_interleave(4)
    s, t = pixel_coords(64, 64, gen, pix)
    tape, bounce = [], grad.bounce_grad

    def recorded(cont, ints, *a, **k):
        tape.append((cont, ints))
        return bounce(cont, ints, *a, **k)

    grad.bounce_grad = recorded
    try:
        with torch.no_grad():
            grad.render_rays_kernel(scene, camera_rays(cam, gen, s, t),
                                    n_pixels=pix.numel(), spp=1,
                                    max_depth=depth, seed=3, sort_lanes=True,
                                    force_flat=flat)
    finally:
        grad.bounce_grad = bounce
    tbl, _ = mk.build_sphere_table(scene)
    return tbl, grad.grad_tri_table(scene, flat), tape


@pytest.mark.parametrize("segments,rings", [(16, 12), (64, 32)])
@pytest.mark.parametrize("flat", [False, True])
def test_grad_mesh_kernels_match_plain(dev, segments, rings, flat):
    """K4's triangle instance bit-identical to its plain version with equal
    counters (box tests, triangle tests, live lanes); K5's within 1e-3 of
    the largest |plain| per cot_in row and per g_tbl / g_tri column."""
    tbl, tris, tape = _mesh_grad_tape(dev, segments, rings, flat)
    rng = np.random.default_rng(4)
    for it, (cont, ints) in enumerate(tape):
        kw = dict(it=it, seed=3, max_depth=8, flat=flat)
        ks, ps = (torch.zeros(4, dtype=torch.int64, device=dev)
                  for _ in range(2))
        kc, ki = grad.bounce_fwd(cont, ints, tbl, tris, stats=ks, **kw)
        pc, pi = grad.bounce_fwd_reference(cont, ints, tbl, tris, stats=ps,
                                           **kw)
        assert torch.equal(kc, pc) and torch.equal(ki, pi), it
        assert torch.equal(ks, ps), (it, ks.tolist(), ps.tolist())
        cot = torch.from_numpy(rng.standard_normal(cont.shape)
                               .astype(np.float32)).to(dev)
        kci, kg, kt, _ = grad.bounce_bwd(cont, ints, cot, tbl, tris, **kw)
        pci, pg, pt, _ = grad.bounce_bwd_reference(cont, ints, cot, tbl,
                                                   tris, **kw)
        for k, p, dim in ((kci, pci, 1), (kg[:, :13], pg[:, :13], 0),
                          (kt[:, :14], pt[:, :14], 0)):
            assert bool(torch.isfinite(k).all())
            scale = p.abs().amax(dim=dim, keepdim=True)
            assert bool(((k - p).abs() <= 1e-3 * scale).all()), it
        assert not kt[:, 14:].any() and not kg[:, 13:].any()


def test_mesh_gradient_launches_kernels_only(dev, monkeypatch):
    """render_pixels_kernel on a mesh over 16,384 triangles (sorted lanes
    by default) launches K4 and K5 once per bounce, never their plain
    versions; the vertex gradient is finite and non-zero."""
    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(grad, "bounce_fwd_reference", refuse)
    monkeypatch.setattr(grad, "bounce_bwd_reference", refuse)
    scene = _knot(dev, 128, 136)  # 17,408 triangles
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, device=dev)
    before = (grad.bounce_fwd.launches, grad.bounce_bwd.launches)
    loss, grads = grad.loss_and_grad_kernel(
        scene, cam, torch.Generator(dev).manual_seed(0),
        torch.zeros((32 * 32, 3), device=dev), torch.arange(32 * 32),
        width=32, height=32, spp=4, max_depth=4)
    assert (grad.bounce_fwd.launches - before[0],
            grad.bounce_bwd.launches - before[1]) == (5, 5)
    g = grads.triangles.verts
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# K4 / K5 on lit scenes


LIT_SCENES = {"light": (light_scene, True), "cornell": (cornell_scene, True),
              "cornell_no_nee": (cornell_scene, False),
              "textures": (textures_scene, False)}


def _grad_kernels_match_plain(dev, scene, cam, nee):
    """K4's lit instance bit-identical to its plain version with equal
    counters (box and triangle tests, live lanes, shadow rays) at every
    bounce of one forward at 48x48 spp4 depth 8; K5 within 1e-3: cot_in
    per row of its largest |plain|, g_tbl and g_tri per column of its
    largest sum of |terms|, and g_rows per entry of its float64 sum, or of
    a tenth of its sum of |terms| where the sum cancels below that (the
    cotangents have one sign, so the emission columns' terms do not).
    Returns the lit features, the shadow rays and the sum of |K5's
    g_rows|."""
    lit = grad.grad_lit(scene, nee)
    tbl, _ = mk.build_sphere_table(scene)
    tris = grad.grad_tri_table(scene) if scene.n_triangles else None
    gen = torch.Generator(dev).manual_seed(2)
    pix = torch.arange(48 * 48, device=dev).repeat_interleave(4)
    s, t = pixel_coords(48, 48, gen, pix)
    cont, ints = mk.lane_state(camera_rays(cam, gen, s, t), pix.numel(), dev)
    rng = np.random.default_rng(4)
    shadows, g_rows = 0, 0.0
    for it in range(9):
        kw = dict(it=it, seed=3, max_depth=8, lit=lit,
                  background=scene.background)
        ks, ps = (torch.zeros(4, dtype=torch.int64, device=dev)
                  for _ in range(2))
        kc, ki = grad.bounce_fwd(cont, ints, tbl, tris, stats=ks, **kw)
        pc, pi = grad.bounce_fwd_reference(cont, ints, tbl, tris, stats=ps,
                                           **kw)
        assert torch.equal(kc, pc) and torch.equal(ki, pi), it
        assert torch.equal(ks, ps), it
        shadows += int(ks[3])
        cot = torch.from_numpy(np.abs(rng.standard_normal(cont.shape))
                               .astype(np.float32)).to(dev)
        kci, kg, kt, kr = grad.bounce_bwd(cont, ints, cot, tbl, tris, **kw)
        pci, sph, tri, rows = grad.bounce_bwd_terms(cont, ints, cot, tbl,
                                                    tris, **kw)
        scale = pci.abs().amax(dim=1, keepdim=True)
        assert bool(torch.isfinite(kci).all())
        assert bool(((kci - pci).abs() <= 1e-3 * scale).all()), it
        parts = [(kg, sph, tbl.shape[0])]
        if tris is not None:
            parts.append((kt, tri, tris.tbl.shape[0]))
        for k, terms, n_rows in parts:
            p = grad.table_sums(terms, n_rows)
            mags = grad.table_sums((terms[0], terms[1].abs()), n_rows)
            assert bool(torch.isfinite(k).all())
            if not n_rows:  # the smoke box has no spheres
                continue
            assert bool(((k - p).abs()
                         <= 1e-3 * mags.amax(dim=0, keepdim=True)).all()), it
        assert (kr is None) == (rows is None) == (lit.rows is None)
        if rows is not None:  # an entry's scale >= 1e-3 of the largest
            exact = rows.double().sum(dim=0)
            mags = rows.double().abs().sum(dim=0)
            scale = torch.maximum(exact.abs(), 0.1 * mags).clamp_min(
                float(mags.max()) * 1e-3)
            assert bool(torch.isfinite(kr).all())
            assert bool(((kr.double() - exact).abs() <= 1e-3 * scale).all())
            g_rows = g_rows + kr.abs()
        assert not kg[:, 12].any()
        cont, ints = kc, ki
    return lit, shadows, g_rows


@pytest.mark.parametrize("name", list(LIT_SCENES))
def test_grad_lit_kernels_match_plain(dev, name):
    """_grad_kernels_match_plain on the lit scenes."""
    build, nee = LIT_SCENES[name]
    lit, shadows, _ = _grad_kernels_match_plain(dev, *build(1.0, device=dev),
                                                nee)
    assert lit.rows is None or nee
    assert (shadows > 0) == nee


def test_lit_gradient_launches_kernels_only(dev, monkeypatch):
    """render_pixels_kernel(nee=True) on the Cornell box launches K4 and
    K5 once per bounce, never their plain versions; the light-driven
    gradients (the lamp's emission, the walls' albedo, the vertices) are
    finite and non-zero."""
    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(grad, "bounce_fwd_reference", refuse)
    monkeypatch.setattr(grad, "bounce_bwd_reference", refuse)
    scene, cam = cornell_scene(1.0, device=dev)
    before = (grad.bounce_fwd.launches, grad.bounce_bwd.launches)
    loss, grads = grad.loss_and_grad_kernel(
        scene, cam, torch.Generator(dev).manual_seed(0),
        torch.zeros((32 * 32, 3), device=dev), torch.arange(32 * 32),
        width=32, height=32, spp=4, max_depth=4, nee=True)
    assert (grad.bounce_fwd.launches - before[0],
            grad.bounce_bwd.launches - before[1]) == (5, 5)
    for g in (grads.materials.albedo, grads.triangles.verts):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# K4 / K5 through constant-density media


def fog_light_scene(dev):
    """``fog_light_setup`` of tests/test_pallas_grad_volumes.py: a fog ball
    ("s") and a sphere light over a gray ground, black background."""
    b = SceneBuilder()
    g = b.add_lambertian((0.5, 0.5, 0.5))
    lamp = b.add_light((6.0, 5.0, 4.0))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, g)
    b.add_sphere((0.8, 2.2, -0.6), 0.35, lamp)
    b.add_fog_sphere((0.0, 0.4, -1.0), 0.6, density=2.0,
                     albedo=(0.8, 0.7, 0.6))
    return b.build(background=(0.0, 0.0, 0.0), device=dev), _fog_camera(dev)


def fog_box_scene(dev):
    """An unrotated fog box ("b") over the same ground under the sky."""
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.add_lambertian((0.5,) * 3))
    b.add_fog_box((-0.5, -0.2, -1.5), (0.5, 0.9, -0.5), 2.0,
                  albedo=(0.8, 0.7, 0.6))
    return b.build(device=dev), _fog_camera(dev)


def _fog_camera(dev):
    return make_camera(lookfrom=(0.0, 0.5, 1.8), lookat=(0.0, 0.3, -1.0),
                       fov_degrees=55.0, aspect_ratio=1.0, aperture=0.0,
                       focus_dist=1.0, device=dev)


#: name -> (builder, nee): phase 23's scenes.
VOL_SCENES = {
    "smoke": (lambda dev: smoke_scene(1.0, device=dev), False),
    "smoke_nee": (lambda dev: smoke_scene(1.0, device=dev), True),
    "fog_light": (fog_light_scene, True),
    "fog_box": (fog_box_scene, False),
}


@pytest.mark.parametrize("name", list(VOL_SCENES))
def test_grad_vol_kernels_match_plain(dev, name):
    """_grad_kernels_match_plain through media: the free-flight event, NEE
    from it and the shadow rays' transmittance in K4's lit instance, their
    adjoints in K5's; every volume row gets a cotangent."""
    build, nee = VOL_SCENES[name]
    scene, cam = build(dev)
    lit, shadows, g_rows = _grad_kernels_match_plain(dev, scene, cam, nee)
    assert lit.vol_kinds == scene.volume_kinds
    assert (shadows > 0) == nee
    vols = g_rows[lit.vol_row0:]
    assert bool((vols[:, 6] > 0).all())  # every density
    assert bool((vols[:, :6].amax(dim=1) > 0).all())  # every boundary


def test_vol_gradient_launches_kernels_only(dev, monkeypatch):
    """render_pixels_kernel(nee=True) on the smoke box launches K4 and K5
    once per bounce, never their plain versions; the media's gradients
    (density, albedo, the boxes' corners, angles and translations) are
    finite and non-zero."""
    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(grad, "bounce_fwd_reference", refuse)
    monkeypatch.setattr(grad, "bounce_bwd_reference", refuse)
    scene, cam = smoke_scene(1.0, device=dev)
    before = (grad.bounce_fwd.launches, grad.bounce_bwd.launches,
              grad.bounce_fwd.lit_launches, grad.bounce_bwd.lit_launches)
    loss, grads = grad.loss_and_grad_kernel(
        scene, cam, torch.Generator(dev).manual_seed(0),
        torch.zeros((32 * 32, 3), device=dev), torch.arange(32 * 32),
        width=32, height=32, spp=4, max_depth=4, nee=True)
    after = (grad.bounce_fwd.launches, grad.bounce_bwd.launches,
             grad.bounce_fwd.lit_launches, grad.bounce_bwd.lit_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (5, 5, 5, 5)
    vol = grads.volumes
    for g in (vol.density, vol.albedo, vol.p0, vol.p1, vol.rotate_y,
              vol.translate):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# K1's culled sphere sweep and its ticker; K5's warp form


@pytest.mark.parametrize("pool", [False, True], ids=["classic", "pool"])
def test_sphere_cull_bit_identical_to_plain_on_card(dev, pool):
    """K1 sweeps the cover's spheres by row groups: bit for bit the plain
    version's frame, with equal steps, shadow-free counters and sphere box
    / row counts; the rows swept are fewer than the brute-force sweep's."""
    scene, cam = cover_scene(Config(image_width=160, aspect_ratio=16 / 9),
                             device=dev)
    tbl, _ = mk.build_sphere_table(scene)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(2, width=160, height=90, spp=4, max_depth=50),
            mk.n_tiles_for(160, 90))
    out = []
    for fn in (mk.render_blocks, mk.render_blocks_reference):
        steps, sph = (torch.zeros(n, dtype=torch.int64, device=dev)
                      for n in (1, 2))
        planes = torch.stack(fn(*args, steps=steps, spheres=sph, pool=pool))
        torch.cuda.synchronize()
        out.append((planes, steps.tolist() + sph.tolist()))
    (k, kc), (p, pc) = out
    assert torch.equal(k, p)
    assert kc == pc, (kc, pc)
    assert kc[1] == kc[0] * tbl.shape[0] // mk.SPHERE_GROUP  # every sweep
    assert 0 < kc[2] < kc[0] * tbl.shape[0]


def test_ticker_counter_counts_every_tile_row_on_card(dev):
    """One launch with the mapped progress counter: the frame is the one
    rendered without it, and the counter holds every tile row after."""
    scene, cam = cover_scene(Config(image_width=300, aspect_ratio=16 / 9),
                             device=dev)
    tbl, _ = mk.build_sphere_table(scene)
    n_tiles = mk.n_tiles_for(300, 168)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(0, width=300, height=168, spp=2, max_depth=8),
            n_tiles)
    counter = mk.progress_counter(dev.index)
    counter.reset()
    ticked = torch.stack(mk.render_blocks(*args, progress=counter))
    torch.cuda.synchronize()
    assert counter.value == n_tiles * mk.TILE_ROWS
    assert torch.equal(ticked, torch.stack(mk.render_blocks(*args)))


def test_grad_bwd_warp_form_matches_thread_form(dev, monkeypatch):
    """K5's warp form against its thread form and the picked one at every
    bounce of a sorted forward on the 4,096-triangle knot, each forced by
    its cut-over ``grad.WARP_MAX_LIVE``: cot_in bit for bit, equal
    counters, table gradients within 1e-3 of the column's largest
    |thread|."""
    tbl, tris, tape = _mesh_grad_tape(dev, 64, 32, False)
    rng = np.random.default_rng(6)
    before = grad.bounce_bwd.warp_launches
    for it, (cont, ints) in enumerate(tape):
        cot = torch.from_numpy(rng.standard_normal(cont.shape)
                               .astype(np.float32)).to(dev)
        res = {}
        for form, cut in (("thread", -1), ("warp", 1 << 30),
                          ("auto", grad.flat_bounce.WARP_MAX_LIVE)):
            monkeypatch.setattr(grad, "WARP_MAX_LIVE", cut)
            st = torch.zeros(4, dtype=torch.int64, device=dev)
            res[form] = grad.bounce_bwd(cont, ints, cot, tbl, tris, it=it,
                                        seed=3, max_depth=8,
                                        stats=st) + (st,)
        for form in ("warp", "auto"):
            t, w = res["thread"], res[form]
            assert torch.equal(w[0], t[0]), (it, form)
            assert torch.equal(w[4], t[4]), (it, form)
            for a, b in ((w[1], t[1]), (w[2], t[2])):
                scale = b.abs().amax(dim=0, keepdim=True)
                assert bool(((a - b).abs() <= 1e-3 * scale).all()), (it, form)
    assert grad.bounce_bwd.warp_launches == before + 3 * len(tape)


def test_grad_fwd_warp_form_bit_identical(dev, monkeypatch):
    """K4's warp form against its thread form, the picked one and the plain
    version at every bounce of a sorted forward on the 4,096-triangle knot,
    each forced by its cut-over ``grad.WARP_MAX_LIVE``: the outputs bit
    for bit, the counters equal."""
    tbl, tris, tape = _mesh_grad_tape(dev, 64, 32, False)
    before = grad.bounce_fwd.warp_launches
    for it, (cont, ints) in enumerate(tape):
        kw = dict(it=it, seed=3, max_depth=8)
        ps = torch.zeros(4, dtype=torch.int64, device=dev)
        plain = grad.bounce_fwd_reference(cont, ints, tbl, tris, stats=ps,
                                          **kw)
        for cut in (-1, 1 << 30, grad.flat_bounce.WARP_MAX_LIVE):
            monkeypatch.setattr(grad, "WARP_MAX_LIVE", cut)
            st = torch.zeros(4, dtype=torch.int64, device=dev)
            out = grad.bounce_fwd(cont, ints, tbl, tris, stats=st, **kw)
            assert all(torch.equal(a, b) for a, b in zip(out, plain)), \
                (it, cut)
            assert torch.equal(st, ps), (it, cut)
    assert grad.bounce_fwd.warp_launches == before + 3 * len(tape)
