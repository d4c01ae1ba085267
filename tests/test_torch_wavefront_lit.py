"""The port's sorted wavefront on lit scenes, and two-sided triangles,
against rtow_tpu on the CPU: one bounce of K3's plain lit version against
``bounce_step_pallas`` in interpret mode, K1's plain version with
``cull=False`` against ``render_spheres_pallas(cull=False)``, a mesh with
its winding reversed, a triangle lamp seen from behind, the gradient
kernels' refusal of two-sided triangles, the light and
volume rows, the window counters of ``trace_wavefront_sorted(stats=True)``
and a small lit frame.

Every scene is built by the JAX package and carried across with
``Scene.from_numpy``, so both sides hold the same float32 leaves.  The
knots have 4,096 triangles in 128-row blocks (both packages' tables
then have the super level, which the shadow rays descend too).

Tolerances:

* One bounce of 1,024 lanes, from the same input state on both sides (as
  ``test_torch_wavefront.py``): alive codes and bounce counts equal on at
  least 99.5% of lanes (an ulp of XLA's against PyTorch's float32
  sin/cos/exp/log/rsqrt can flip a discrete choice), on the lanes that
  agree every continuous row within 2e-5 * (1 + |value|), lane ids equal,
  and the live count strictly between 0 and the tile.
* K1 with two-sided triangles, lane by lane on one frame (as
  ``test_torch_mesh.py``): at least 95% of pixels within 1e-4 of mean
  radiance and mean |difference| at most 5e-3.
* A mesh with its winding reversed, two-sided, against the original,
  one-sided: equal bit for bit.  Swapping two vertices swaps e1 and e2,
  which negates the cross product and the determinant exactly and swaps
  u and v, so every test, t and (ray-facing) normal is the same float.
* The light and volume rows, the window counters and the step counts
  after each window level: equal.
* One small lit frame against the JAX package's own CPU render (the jnp
  path, threefry camera rays): the mean |difference| of 8x8-pixel block
  means below the Monte Carlo sigma of one block, 1 / sqrt(spp * 64),
  and the largest below 3 sigma (``test_torch_wavefront.py``'s method;
  the lamps are out of view).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models.camera import make_camera as jax_make_camera
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu.ops import wavefront_sorted as jwf
from rtow_tpu.render import render as jax_render
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import Scene
from rtow_tpu_torch.ops import flat_bounce as fb
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.ops import wavefront as wf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402

_PARTS = ("spheres", "triangles", "materials", "volumes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain sweeps are many small PyTorch ops: one intra-op thread
    runs them as fast here and keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAM = dict(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
           fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0, focus_dist=3.0)
BLACK = (0.0, 0.0, 0.0)
#: Both packages' triangle blocks in these tests (JAX's module default).
TRI_BLOCK = 128


def _carried(jscene) -> Scene:
    """The port's copy of a JAX scene (``Scene.from_numpy``)."""
    leaves = {f"{p}.{k}": np.asarray(v)
              for p in _PARTS if getattr(jscene, p) is not None
              for k, v in vars(getattr(jscene, p)).items()}
    return Scene.from_numpy(leaves, "cpu", background=jscene.background,
                            volume_kinds=jscene.volume_kinds)


def _knot(b, segments=64, rings=32, reverse=False):
    verts, faces = make_knot(segments, rings)
    if reverse:
        faces = faces[:, ::-1]
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))


def _quad_lamps(b, emit=4.0):
    """Two square lamps facing the knot: above it and at its right."""
    lamp = b.add_light((emit,) * 3)
    b.add_quad((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0.5, 1.5, 0.5),
               (-0.5, 1.5, 0.5), lamp)
    b.add_quad((1.5, -0.5, -0.5), (1.5, -0.5, 0.5), (1.5, 0.5, 0.5),
               (1.5, 0.5, -0.5), lamp)


def _scene(name):
    """(JAX scene, roulette) of a test scene."""
    b = JaxSceneBuilder()
    _knot(b)
    bg = "sky"
    if name == "sphere_lamp":  # NEE toward a sphere light
        b.add_sphere((0.3, 1.4, 0.8), 0.3, b.add_light((8.0, 8.0, 8.0)))
        bg = BLACK
    elif name == "quad_lamps":  # knot_lit's composition at a small size
        _quad_lamps(b)
        bg = BLACK
    elif name == "fog_lamp":  # a fog ball around part of the knot
        b.add_fog_sphere((0.4, 0.0, 0.0), 0.6, 1.5, albedo=(0.8, 0.9, 0.7))
        b.add_sphere((0.0, 1.5, 0.5), 0.3, b.add_light((8.0, 8.0, 8.0)))
        bg = BLACK
    elif name == "textures":  # checker and noise spheres beside it
        b.add_sphere((-0.9, 0.3, 0.6), 0.35, b.add_checker(
            (0.9, 0.9, 0.9), (0.1, 0.2, 0.3), scale=20.0))
        b.add_sphere((0.9, -0.3, 0.6), 0.35, b.add_noise(
            (0.9, 0.8, 0.7), (0.2, 0.1, 0.1), scale=6.0))
    return b.build(background=bg), name == "roulette"


def _state(n, seed, nee):
    """A (16, n) state of camera rays through random points of the view,
    with random throughput, bounce counts 0-4 and, under NEE, alive codes
    1 and 2 (the previous scatter diffuse or not); 24 lanes dead."""
    rng = np.random.default_rng(seed)
    cam = make_camera(device="cpu", **CAM)
    s, t = rng.random((2, n)).astype(np.float32)
    o = cam.origin.numpy()
    d = (cam.lower_left.numpy() + s[:, None] * cam.horizontal.numpy()
         + t[:, None] * cam.vertical.numpy() - o).astype(np.float32)
    st = np.zeros((16, n), np.float32)
    st[0:3] = o[:, None]
    st[3:6] = d.T
    st[7:10] = rng.uniform(0.3, 1.0, (3, n))
    st[13] = rng.integers(1, 3, n) if nee else 1.0
    st[13, n - 24:] = 0.0
    st[14] = rng.integers(0, 5, n)
    st[15] = np.arange(n)
    return st


def _jax_state(st):
    return tuple(jnp.asarray(st[j]) if j < 13 else
                 jnp.asarray(st[j].astype(np.int32)) for j in range(16))


def _port_tables(scene, roulette):
    tbl, _ = mk.build_sphere_table(scene)
    return fb.Tables(tbl, mk.build_tri_table(scene, TRI_BLOCK),
                     mk.scene_lit(scene, roulette))


def _jax_bounce(jscene, st, it, seed, depth, cull, roulette):
    jtables, (n_blocks, n_tri_blocks, n_super), _, _ = jwf._scene_tables(
        jscene)
    nee_kinds = (tuple(k for k, _ in jscene.light_ids)
                 if jscene.has_emissive else ())
    with pltpu.force_tpu_interpret_mode():
        out = jmk.bounce_step_pallas(
            _jax_state(st), it, seed, depth, jtables, n_blocks=n_blocks,
            n_tri_blocks=n_tri_blocks, n_super=n_super, cull=cull,
            emissive=jscene.has_emissive,
            bg=None if jscene.background == "sky" else jscene.background,
            nee_kinds=nee_kinds, checker=jscene.has_checker,
            vol_kinds=jscene.volume_kinds, vol_row0=len(nee_kinds),
            roulette=roulette)
    return np.stack([np.asarray(x, np.float32) for x in out]), n_super


# ---------------------------------------------------------------------------
# One bounce of K3's plain lit version against the Pallas kernel


@pytest.mark.parametrize("name,cull", [
    ("sphere_lamp", True), ("quad_lamps", True), ("fog_lamp", True),
    ("textures", True), ("roulette", True), ("sphere_lamp", False),
    ("quad_lamps", False)])
def test_lit_bounce_step_matches_pallas(name, cull):
    jscene, roulette = _scene(name)
    scene = _carried(jscene)
    tables = _port_tables(scene, roulette)
    lit = tables.lit
    assert lit.any
    st = _state(mk.TILE, seed=len(name), nee=bool(lit.nee_kinds))
    depth, seed = 6, 13
    shadows = torch.zeros(1, dtype=torch.int64)
    for it in range(2):
        want, n_super = _jax_bounce(jscene, st, it, seed, depth, cull,
                                    roulette)
        assert n_super == tables.tris.n_super >= 2
        got = fb.bounce_step(torch.from_numpy(st), it, seed, depth, tables,
                             background=scene.background, shadows=shadows,
                             cull=cull).numpy()
        same = (got[13] == want[13]) & (got[14] == want[14])
        assert np.mean(same) >= 0.995, (it, np.mean(same))
        np.testing.assert_array_equal(got[15], want[15])
        err = np.abs(got[:13, same] - want[:13, same])
        assert (err <= 2e-5 * (1.0 + np.abs(want[:13, same]))).all(), it
        assert 0 < (want[13] > 0).sum() < mk.TILE - 24
        if lit.nee_kinds:  # the diffuse code survives the bounce
            assert (want[13] == 2).any() and (got[13] == 2).any()
        st = want  # the next bounce starts both sides from one state
    assert (int(shadows) > 0) == bool(lit.nee_kinds)


# ---------------------------------------------------------------------------
# Two-sided triangles


@pytest.mark.parametrize("lamps", [False, True])
def test_k1_two_sided_matches_pallas(lamps):
    """K1's plain version with ``cull=False`` against
    ``render_spheres_pallas(cull=False)``, lane by lane (the classic
    scheduler: ``tests/conftest.py`` sets ``RTOW_POOL=0``): the
    384-triangle knot under the sky, and under the two quad lamps."""
    verts, faces = make_knot(16, 12)
    b = JaxSceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    b.add_sphere((0.0, -101.0, 0.0), 100.0, b.add_metal((0.5,) * 3, 0.2))
    if lamps:
        _quad_lamps(b)
    jscene = b.build(background=BLACK if lamps else "sky")
    scene = _carried(jscene)
    kw = dict(width=32, height=32, spp=2, max_depth=4)
    assert os.environ["RTOW_POOL"] == "0"
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmk.render_spheres_pallas(
            jscene, jax_make_camera(**CAM), 0, cull=False, **kw))
    got = mk.render_spheres(scene, make_camera(device="cpu", **CAM), 0,
                            cull=False, pool=False, **kw).numpy()
    d = np.abs(got - want).max(axis=1) / 2
    assert np.mean(d <= 1e-4) >= 0.95
    assert np.abs(got - want).mean() / 2 <= 5e-3
    assert np.isfinite(got).all() and got.std() > 0.05


def _sheet(n_side, reverse):
    """A square of 2 * n_side**2 triangles in the plane z = 0, wound to
    face the camera at +z (or away with ``reverse``), on a white
    background."""
    x = np.linspace(-1.0, 1.0, n_side + 1)
    p = np.stack(np.meshgrid(x, x, indexing="ij"), -1)
    p = np.concatenate([p, np.zeros(p.shape[:2] + (1,))], -1)
    a, b_, c, d = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
    tris = np.concatenate([np.stack([a, b_, c], 2).reshape(-1, 3, 3),
                           np.stack([a, c, d], 2).reshape(-1, 3, 3)])
    if reverse:
        tris = tris[:, ::-1]
    b = JaxSceneBuilder()
    b.add_mesh(tris, b.add_lambertian((0.5, 0.5, 0.5)))
    return _carried(b.build(background=(1.0, 1.0, 1.0)))


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_reversed_winding(kernel):
    """A sheet wound away from the camera: two-sided, it renders as the
    sheet wound toward it does with culling, bit for bit; culled, every
    camera ray passes it and sees the white background.  K1's sheet has
    8,192 triangles, K3's 16,928 (``render_wavefront``)."""
    n_side = 64 if kernel == "K1" else 92
    cam = make_camera(device="cpu", **CAM)
    cfg = Config(device="cpu", image_width=16, aspect_ratio=1.0,
                 samples_per_pixel=2, max_child_rays=3)

    def render(scene, cull):
        if kernel == "K3":
            return wf.render_wavefront(scene, cam, cfg, cull_backfaces=cull)
        return mk.render_spheres(scene, cam, 0, width=16, height=16, spp=2,
                                 max_depth=3, cull=cull).numpy() / 2

    front, back = _sheet(n_side, False), _sheet(n_side, True)
    assert (back.n_triangles > wf.WAVEFRONT_MIN_TRIS) == (kernel == "K3")
    want = render(front, True)
    np.testing.assert_array_equal(render(back, False), want)
    assert want.min() < 0.9  # the sheet is in view
    np.testing.assert_array_equal(render(back, True), 1.0)


def test_lamp_seen_from_behind_adds_nothing():
    """A square lamp above a floor, two-sided triangles: facing the floor
    its NEE lights the floor's hits; turned away (its back to the floor)
    the shadow rays reach it, but it adds nothing, as JAX's lights stay
    one-sided whatever ``cull`` is (``ops/lights.py:219-226``)."""
    def scene(facing):
        b = JaxSceneBuilder()
        b.add_sphere((0.0, -100.5, 0.0), 100.0, b.add_lambertian((0.7,) * 3))
        lamp = b.add_light((4.0, 4.0, 4.0))
        c = [(-0.5, 1.0, -0.5), (0.5, 1.0, -0.5), (0.5, 1.0, 0.5),
             (-0.5, 1.0, 0.5)]
        b.add_quad(*(c if facing else c[::-1]), lamp)
        return _carried(b.build(background=BLACK))

    st = np.zeros((16, mk.TILE), np.float32)
    rng = np.random.default_rng(4)
    st[0:3] = rng.uniform(-0.4, 0.4, (3, mk.TILE)) + np.array(
        [[0.0], [0.3], [0.0]], np.float32)
    st[3:6] = np.array([[0.0], [-1.0], [0.0]], np.float32)
    st[7:10] = 1.0
    st[13] = 1.0
    st[15] = np.arange(mk.TILE)
    for facing in (True, False):
        sc = scene(facing)
        shadows = torch.zeros(1, dtype=torch.int64)
        out = fb.bounce_step(torch.from_numpy(st), 0, 5, 4,
                             _port_tables(sc, False), background=BLACK,
                             shadows=shadows, cull=False)
        assert int(shadows) == mk.TILE  # every lane hit the floor
        rad = out[10:13]
        if facing:
            assert (rad > 0).float().mean() > 0.9
        else:
            assert torch.equal(rad, torch.zeros_like(rad))


def test_gradient_kernels_refuse_two_sided():
    """K4 and K5 cull, as JAX's gradient does (``pallas_grad.py:910``):
    their wrappers refuse ``cull=False`` before anything runs."""
    from rtow_tpu_torch.ops import grad

    b = JaxSceneBuilder()
    _knot(b, 16, 12)
    scene = _carried(b.build())
    tbl, _ = mk.build_sphere_table(scene)
    tris = mk.build_tri_table(scene, TRI_BLOCK)
    st = torch.from_numpy(_state(mk.TILE, seed=1, nee=False))
    cont, ints = st[:13].contiguous(), st[13:].to(torch.int32).contiguous()
    kw = dict(it=0, seed=1, max_depth=4, cull=False)
    with pytest.raises(ValueError, match="two-sided"):
        grad.bounce_fwd(cont, ints, tbl, tris, **kw)
    with pytest.raises(ValueError, match="two-sided"):
        grad.bounce_bwd(cont, ints, torch.zeros_like(cont), tbl, tris, **kw)
    out, _ = grad.bounce_fwd(cont, ints, tbl, tris, it=0, seed=1,
                             max_depth=4)
    assert out.shape == cont.shape


def test_time_k3_needs_a_card():
    """``python -m rtow_tpu_torch.time_k3`` times K3 on the card only: on
    the CPU it exits before it builds or traces anything."""
    from rtow_tpu_torch import time_k3

    if torch.cuda.is_available():
        pytest.skip("a card is present: the timing would run")
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        time_k3.main(["--runs", "1"])


# ---------------------------------------------------------------------------
# The rows, the counters, a frame


@pytest.mark.parametrize("name", ["quad_lamps", "fog_lamp", "sphere_lamp"])
def test_rows_equal_jax_operand(name):
    """``scene_lit(...).rows``: the light rows, then the volume rows, as
    JAX's ``_scene_tables`` packs its light-table operand."""
    jscene, _ = _scene(name)
    jtables, _, _, _ = jwf._scene_tables(jscene)
    tables, _, _ = wf.scene_tables(_carried(jscene))
    np.testing.assert_array_equal(tables.lit.rows.numpy(),
                                  np.asarray(jtables[6]))
    lights, vols = {"quad_lamps": (4, 0), "fog_lamp": (1, 1),
                    "sphere_lamp": (1, 0)}[name]
    lit = tables.lit
    assert (len(lit.nee_kinds), len(lit.vol_kinds)) == (lights, vols)
    assert lit.rows.shape == (lights + vols, 14)
    assert lit.vol_row0 == lights  # vol_row0 = len(light_ids) under NEE


def test_window_counters_equal_jax():
    """``trace_wavefront_sorted(stats=True)``'s ``acc[3:6]`` (window
    tiles, live lanes, live tiles) and ``level_its`` equal JAX's on the
    same camera rays: 8 tiles of lanes, so the window ladder narrows
    once, the quad-lamp knot at depth 3."""
    jscene, _ = _scene("quad_lamps")
    scene = _carried(jscene)
    P, spp, width, depth, seed = 1024, 8, 32, 3, 21
    pixel_ids = np.arange(P, dtype=np.int32)
    key = jax.random.key(3)
    with jmk.tri_block_for(jscene.n_triangles):
        jtables, counts, jbmin, jinv = jwf._scene_tables(jscene)
        with pltpu.force_tpu_interpret_mode():
            jrad, jacc, jits = jwf.trace_wavefront_sorted(
                jscene, jax_make_camera(**CAM), key, jnp.asarray(pixel_ids),
                seed, spp=spp, max_depth=depth, width=width, height=width,
                tables=jtables, counts=counts, bmin=jbmin, inv_ext=jinv,
                stats=True)
    # JAX's camera rays, handed to the port in place of its own draws.
    from rtow_tpu.models.camera import camera_rays as jax_rays
    from rtow_tpu.models.camera import pixel_coords as jax_coords
    k_pix, k_cam = jax.random.split(key)
    lane_pix = jnp.repeat(jnp.asarray(pixel_ids), spp)
    s, t = jax_coords(width, width, k_pix, lane_pix)
    rays = jax_rays(jax_make_camera(**CAM), k_cam, s, t)
    tables, bmin, inv_ext = wf.scene_tables(scene)
    state = wf.lane_state(
        type("Rays", (), {k: np.asarray(getattr(rays, k), np.float32)
                          for k in ("origin", "direction", "time")}),
        P * spp)
    windows, level_its = [0, 0, 0], []
    stats = torch.zeros(3, dtype=torch.int64)
    wf.trace_lanes(state, seed, max_depth=depth, tables=tables, bmin=bmin,
                   inv_ext=inv_ext, background=scene.background, stats=stats,
                   windows=windows, level_its=level_its)
    np.testing.assert_array_equal(windows, np.asarray(jacc)[3:6])
    assert level_its == [int(x) for x in np.asarray(jits)]
    assert len(level_its) == 2 and windows[0] > 8
    # The triple itself, on the port's own camera rays.
    gen = wf.chunk_generator("cpu", seed, 0)
    rad, acc, its = wf.trace_wavefront_sorted(
        tables, make_camera(device="cpu", **CAM), gen,
        torch.arange(P), seed, spp=spp, max_depth=depth, width=width,
        height=width, bmin=bmin, inv_ext=inv_ext,
        background=scene.background, stats=True)
    assert rad.shape == (P, 3) and acc.shape == (6,) and its.numel() == 2
    assert acc[4] >= P * spp and acc[2] > 0 and acc[0] > 0 and acc[1] > 0


def test_small_lit_frame_matches_jax_render():
    """The quad-lamp knot (384 triangles) at 32x32, spp 8, depth 4
    through ``render_wavefront`` against the JAX package's jnp render."""
    b = JaxSceneBuilder()
    _knot(b, 16, 12)
    _quad_lamps(b, emit=2.0)
    jscene = b.build(background=BLACK)
    kw = dict(image_width=32, aspect_ratio=1.0, samples_per_pixel=8,
              max_child_rays=4)
    want = np.asarray(jax_render(jscene, jax_make_camera(**CAM),
                                 JaxConfig(backend="jnp", **kw),
                                 key=jax.random.key(0)))
    shadows = torch.zeros(1, dtype=torch.int64)
    got = wf.render_wavefront(_carried(jscene),
                              make_camera(device="cpu", **CAM),
                              Config(device="cpu", **kw), shadows=shadows)
    assert got.shape == want.shape == (32, 32, 3) and int(shadows) > 0
    bs = 8

    def blocks(img):
        return img.reshape(32 // bs, bs, 32 // bs, bs, 3).mean(axis=(1, 3))

    diff = np.abs(blocks(got) - blocks(want))
    sigma = 1.0 / np.sqrt(8 * bs * bs)
    assert diff.mean() < sigma and diff.max() < 3 * sigma
    assert got.std() > 0.02  # the knot is lit
