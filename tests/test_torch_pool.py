"""K1's drain-balanced work pool (``RTOW_POOL=1``, the JAX package's
production scheduler) in the port, against rtow_tpu on the CPU.

The port side runs ``render_blocks``' plain PyTorch version with the pool
(the CUDA kernel needs a card; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it bit for bit to this plain version there).  The
JAX side runs ``render_spheres_pallas`` under
``pltpu.force_tpu_interpret_mode()`` with ``RTOW_POOL=1`` set by
``monkeypatch``, as ``tests/test_pool.py`` runs it (the kernel reads the
variable when it is traced, on every call).  Both pools hand out the same
items to the same lanes and draw the same counter-hash random numbers
(the row's iteration count in the salt), so images are compared pixel by
pixel.

Tolerances (per pixel: max |difference| over the channels of mean
radiance):

* sample accounting on a white background: EXACT, as
  ``tests/test_pool.py`` holds the JAX pool;
* ``three_sphere_scene`` at 24x24, spp 24, depth 4: at most 1% of
  pixels off by more than 1e-4, and the ray steps within 0.1% of JAX's
  live-lane-iterations (``stats=True``).  At this size the CLASSIC
  scheduler itself has 3 of 576 pixels off by 0.03-0.04 against JAX's
  classic (one sample each takes another path after a last-bit
  difference in sin/cos; measured), and the pool the same 3: the pool
  gives a column's first chunk to the column's own lane, which then
  draws the classic lane's stream;
* the 487-sphere cover at depth 0: every pixel within 1e-6 (no scatter:
  one sweep and the sky per sample);
* the lit features (NEE toward a sphere and a quad lamp, a fog sphere,
  the checker, roulette) and a small triangle mesh: at least 95% of
  pixels within 1e-4 and mean |difference| at most 5e-3, the classic
  gates of ``tests/test_torch_lit.py`` and ``tests/test_torch_mesh.py``:
  XLA's and PyTorch's float32 sin/cos/exp/log differ in the last bit,
  which can flip a discrete choice (a roulette draw's survival, a
  free-flight event, a hit on a surface a ray grazes) on a few paths; the
  pool's flush sums three or more lanes of one column in lane order,
  XLA's one-hot product in its own order (last bits again).
"""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models import builders as jax_builders
from rtow_tpu.models.camera import make_camera as jax_make_camera
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.ops import tables as tb

W = H = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bounce is many small PyTorch ops: one intra-op thread
    runs them as fast here and keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pool(monkeypatch, scene, cam, *, spp, depth, width=W, height=H,
              roulette=False, stats=False):
    """JAX's pool through ``render_blocks_pallas``, which traces anew on
    every call (the jitted ``render_spheres_pallas`` would serve a trace
    made under another ``RTOW_POOL`` in the same process)."""
    monkeypatch.setenv("RTOW_POOL", "1")
    with pltpu.force_tpu_interpret_mode():
        out = jmk.render_blocks_pallas(
            scene, cam, 0, width=width, height=height, spp=spp,
            max_depth=depth, roulette=roulette, stats=stats)
        img = np.asarray(jmk.unblock_image(*out[:3], width=width,
                                           height=height))
    return (img, np.asarray(out[3])) if stats else img


def _port(scene, cam, *, spp, depth, width=W, height=H, roulette=False,
          pool=True, seed=0, steps=None, slots=None, **kw):
    tbl, tris = tb.k1_tables(scene)
    r, g, b = mk.render_blocks(
        tbl, tb.pack_camera(cam),
        tb.pack_meta(seed, width=width, height=height, spp=spp,
                     max_depth=depth),
        tb.n_tiles_for(width, height), background=scene.background,
        tris=tris, lit=tb.scene_lit(scene, nee=scene.has_emissive,
                                    roulette=roulette), pool=pool,
        steps=steps, slots=slots, **kw)
    return mk.unblock_image(r, g, b, width=width, height=height).numpy()


def _pixel_diff(a, b, spp):
    return np.abs(a - b).max(axis=1) / spp


def _white(device):
    """Empty scene + white background: radiance sums == sample counts."""
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device=device)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    return b.build(background=(1.0, 1.0, 1.0), device=device), cam


# ---------------------------------------------------------------------------
# Exact sample accounting


@pytest.mark.parametrize("spp", [24, 17])  # 17: a chunk remainder
def test_pool_exact_sample_accounting(spp):
    scene, cam = _white("cpu")
    steps = torch.zeros(1, dtype=torch.int64)
    slots = torch.zeros(1, dtype=torch.int64)
    img = _port(scene, cam, spp=spp, depth=4, steps=steps, slots=slots)
    np.testing.assert_array_equal(img, float(spp))
    # One step a sample (every ray leaves for the background at once);
    # the 3 tiles' 24 rows of 128 lanes each hold a slot per iteration.
    assert int(steps) == W * H * spp
    assert int(slots) % tb.LANES == 0 and int(slots) >= int(steps)


@pytest.mark.parametrize("spp", [17, 40])
def test_pool_exact_accounting_partial_width(spp):
    """130 x 8: the second tile column holds 2 image columns, so 126 of
    its lanes start off the image with no samples and take the image
    columns' later chunks; the first column's pixels are untouched by
    them.  Every pixel still gets exactly spp samples, and the lanes off
    the image end with nothing."""
    scene, cam = _white("cpu")
    width = 130
    tbl, _ = tb.build_sphere_table(scene)
    meta = tb.pack_meta(0, width=width, height=8, spp=spp, max_depth=2)
    r, g, b = mk.render_blocks(tbl, tb.pack_camera(cam), meta,
                               tb.n_tiles_for(width, 8),
                               background=scene.background, pool=True)
    assert r.shape == (2 * tb.TILE_ROWS, tb.LANES)
    img = mk.unblock_image(r, g, b, width=width, height=8).numpy()
    np.testing.assert_array_equal(img, float(spp))
    for plane in (r, g, b):
        assert float(plane[8:, 2:].abs().sum()) == 0.0


def test_pool_partial_width_matches_jax(monkeypatch):
    scene, cam = _white("cpu")
    jscene, jcam = _jax_white()
    want = _jax_pool(monkeypatch, jscene, jcam, spp=17, depth=2, width=130,
                     height=8)
    got = _port(scene, cam, spp=17, depth=2, width=130, height=8)
    np.testing.assert_array_equal(got, want)


def _jax_white():
    cam = jax_make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                          fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                          focus_dist=1.0)
    b = JaxSceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    return b.build(background=(1.0, 1.0, 1.0)), cam


# ---------------------------------------------------------------------------
# The plain pool against JAX's pool, lane by lane


def test_pool_three_sphere_matches_jax(monkeypatch):
    want, st = _jax_pool(monkeypatch, *jax_builders.three_sphere_scene(1.0),
                         spp=24, depth=4, stats=True)
    steps = torch.zeros(1, dtype=torch.int64)
    slots = torch.zeros(1, dtype=torch.int64)
    got = _port(*builders.three_sphere_scene(1.0, device="cpu"), spp=24,
                depth=4, steps=steps, slots=slots)
    assert np.mean(_pixel_diff(got, want, 24) > 1e-4) <= 0.01
    # JAX's counters per tile: [3] the tile's iterations, [4] its
    # live-lane-iterations.  A row runs at most as long as its tile.
    assert abs(int(steps) - int(st[:, 4].sum())) <= 1e-3 * st[:, 4].sum()
    assert int(slots) <= tb.TILE * int(st[:, 3].sum())


def test_pool_cover_depth0_matches_jax(monkeypatch):
    kw = dict(seed=0, moving_spheres=True, image_width=40,
              aspect_ratio=16.0 / 9.0)
    jscene, jcam = jax_builders.cover_scene(JaxConfig(**kw))
    scene, cam = builders.cover_scene(Config(device="cpu", **kw))
    want = _jax_pool(monkeypatch, jscene, jcam, spp=17, depth=0, width=40,
                     height=22)
    got = _port(scene, cam, spp=17, depth=0, width=40, height=22)
    assert _pixel_diff(got, want, 17).max() <= 1e-6


def _cover_cfg(**kw):
    return dict(image_width=W, aspect_ratio=1.0, number_of_balls_sqrt=3, **kw)


def _fog_scenes():
    """tests/test_pool.py's fog sphere over a ground sphere (free-flight
    events, NEE from none: no lights)."""
    out = []
    for SB, cam_fn, dev in ((JaxSceneBuilder, jax_make_camera, {}),
                            (SceneBuilder, make_camera, {"device": "cpu"})):
        cam = cam_fn(lookfrom=(0.0, 0.5, 3.0), lookat=(0.0, 0.5, 0.0),
                     fov_degrees=40.0, aspect_ratio=1.0, aperture=0.0,
                     focus_dist=3.0, **dev)
        b = SB()
        b.add_sphere((0.0, -100.0, 0.0), 100.0,
                     b.add_lambertian((0.6, 0.6, 0.6)))
        b.add_fog_sphere((0.0, 0.8, 0.0), 0.8, 2.5, albedo=(0.9, 0.9, 0.9))
        out.append((b.build(background=(0.8, 0.8, 1.0), **dev), cam))
    return out


def _mesh_scenes():
    """A small triangle mesh (a 512-triangle knot, one material) over a
    ground sphere, under the sky: K1's flat triangle sweep."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from make_mesh import make_knot

    verts, faces = make_knot(32, 8)
    out = []
    for SB, cam_fn, dev in ((JaxSceneBuilder, jax_make_camera, {}),
                            (SceneBuilder, make_camera, {"device": "cpu"})):
        cam = cam_fn(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                     fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                     focus_dist=3.0, **dev)
        b = SB()
        b.add_sphere((0.0, -101.0, 0.0), 100.0,
                     b.add_lambertian((0.5, 0.5, 0.5)))
        b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
        out.append((b.build(**dev), cam))
    return out


LIT = {
    # name: (JAX and port (scene, camera) pairs, roulette, spp, depth)
    "lights_nee": (lambda: (jax_builders.light_scene(1.0),
                            builders.light_scene(1.0, device="cpu")),
                   False, 4, 4),
    "cornell_quad_lamp": (lambda: (jax_builders.cornell_scene(1.0),
                                   builders.cornell_scene(1.0, device="cpu")),
                          False, 2, 4),
    "fog_sphere": (_fog_scenes, False, 4, 4),
    "checker": (lambda: (
        jax_builders.cover_scene(JaxConfig(**_cover_cfg(checker_ground=True))),
        builders.cover_scene(Config(device="cpu",
                                    **_cover_cfg(checker_ground=True)))),
                False, 4, 4),
    "roulette": (lambda: (
        jax_builders.cover_scene(JaxConfig(**_cover_cfg())),
        builders.cover_scene(Config(device="cpu", **_cover_cfg()))),
                 True, 4, 8),
    "mesh": (_mesh_scenes, False, 4, 4),
}


@pytest.mark.parametrize("name", sorted(LIT))
def test_pool_features_match_jax(monkeypatch, name):
    build, roulette, spp, depth = LIT[name]
    (jscene, jcam), (scene, cam) = build()
    want = _jax_pool(monkeypatch, jscene, jcam, spp=spp, depth=depth,
                     roulette=roulette)
    shadows = torch.zeros(1, dtype=torch.int64)
    got = _port(scene, cam, spp=spp, depth=depth, roulette=roulette,
                shadows=shadows)
    d = _pixel_diff(got, want, spp)
    assert np.mean(d <= 1e-4) >= 0.95
    assert np.abs(got - want).mean() / spp <= 5e-3
    assert np.isfinite(got).all() and got.std() > 0.01
    lit = tb.scene_lit(scene, nee=scene.has_emissive)
    assert (int(shadows) > 0) == bool(lit.nee_kinds)


# ---------------------------------------------------------------------------
# The pool against the classic scheduler in the port; the knobs


def test_pool_matches_classic_estimator():
    """The same estimator: pool against classic within the classic
    scheduler's own seed-to-seed noise (``tests/test_pool.py:64-74``)."""
    scene, cam = builders.three_sphere_scene(1.0, device="cpu")
    kw = dict(spp=24, depth=4)
    c0 = _port(scene, cam, pool=False, seed=0, **kw)
    c1 = _port(scene, cam, pool=False, seed=123, **kw)
    p0 = _port(scene, cam, pool=True, seed=0, **kw)
    assert np.abs(c0 - p0).max() > 0.0
    noise = np.abs(c0 - c1).mean()
    assert np.abs(c0 - p0).mean() < 1.5 * noise
    assert abs(c0.mean() - p0.mean()) / 24.0 < 0.01


def test_pool_of_one_chunk_is_classic():
    """With spp <= the chunk each lane's first item is its own pixel's
    every sample, taken from iteration 0 on: the pool hands out nothing
    more and draws the classic lane's stream, bit for bit."""
    scene, cam = builders.three_sphere_scene(1.0, device="cpu")
    kw = dict(spp=16, depth=3, width=16, height=16)
    np.testing.assert_array_equal(_port(scene, cam, pool=True, **kw),
                                  _port(scene, cam, pool=False, **kw))


def test_pool_none_follows_env_and_arguments_override(monkeypatch):
    """render_blocks' arguments pick the scheduler and the hand-out, with
    the JAX package's defaults (the pool, 16-sample items every 4
    iterations); ``RTOW_POOL*`` in the environment changes nothing; a
    chunk or period of 0 raises."""
    scene, cam = builders.three_sphere_scene(1.0, device="cpu")
    kw = dict(spp=24, depth=3, width=16, height=16)
    pool = _port(scene, cam, pool=True, **kw)
    classic = _port(scene, cam, pool=False, **kw)
    assert not np.array_equal(pool, classic)
    np.testing.assert_array_equal(
        _port(scene, cam, pool=True, pool_chunk=16, pool_k=4, **kw), pool)
    for name, value in (("RTOW_POOL", "0"), ("RTOW_POOL_CHUNK", "5"),
                        ("RTOW_POOL_K", "2")):
        monkeypatch.setenv(name, value)
    np.testing.assert_array_equal(_port(scene, cam, pool=True, **kw), pool)
    np.testing.assert_array_equal(_port(scene, cam, pool=False, **kw),
                                  classic)
    other = _port(scene, cam, pool=True, pool_chunk=5, pool_k=2, **kw)
    assert not np.array_equal(other, pool)  # another hand-out
    for bad in (dict(pool_chunk=0), dict(pool_k=0)):
        with pytest.raises(ValueError, match="pool chunk"):
            _port(scene, cam, **bad, **kw)


@pytest.mark.parametrize("chunk,k", [(5, 2), (16, 1)])
def test_pool_knobs_match_jax(monkeypatch, chunk, k):
    """Other items and hand-out periods: JAX reads them from
    ``RTOW_POOL_CHUNK`` / ``RTOW_POOL_K``, the port takes them as
    ``render_blocks``' arguments."""
    monkeypatch.setenv("RTOW_POOL_CHUNK", str(chunk))
    monkeypatch.setenv("RTOW_POOL_K", str(k))
    want = _jax_pool(monkeypatch, *jax_builders.three_sphere_scene(1.0),
                     spp=11, depth=3, width=16, height=16)
    got = _port(*builders.three_sphere_scene(1.0, device="cpu"), spp=11,
                depth=3, width=16, height=16, pool_chunk=chunk, pool_k=k)
    assert np.mean(_pixel_diff(got, want, 11) > 1e-4) <= 0.01


def test_pool_occupancy_counters():
    """steps / slots: the classic scheduler holds a warp until its
    slowest lane is done; the pool holds a row until its queue is
    drained.  Both count every live step once."""
    scene, cam = builders.three_sphere_scene(1.0, device="cpu")
    out = {}
    for pool in (False, True):
        steps = torch.zeros(1, dtype=torch.int64)
        slots = torch.zeros(1, dtype=torch.int64)
        _port(scene, cam, spp=16, depth=8, width=128, height=8, pool=pool,
              steps=steps, slots=slots)
        out[pool] = int(steps), int(slots)
    for steps, slots in out.values():
        assert 0 < steps <= slots
    assert out[False][1] % 32 == 0 and out[True][1] % tb.LANES == 0


def test_pipeline_follows_env_and_bands_keep_pixels(monkeypatch):
    """render_megakernel runs the pool (the JAX package's default)
    whatever ``RTOW_POOL`` says; the 10-band ticker path renders the same
    image as the whole-frame launch under the pool too (the pool works
    per tile)."""
    from rtow_tpu_torch.models.builders import scene_for_config
    from rtow_tpu_torch.pipeline import render_megakernel

    cfg = Config(device="cpu", image_width=130, aspect_ratio=130 / 80,
                 samples_per_pixel=17, max_child_rays=3, seed=5,
                 number_of_balls_sqrt=2)
    scene, cam = scene_for_config(cfg)
    monkeypatch.delenv("RTOW_POOL")
    whole = render_megakernel(scene, cam, cfg)
    np.testing.assert_array_equal(
        render_megakernel(scene, cam, cfg, progress=True), whole)
    monkeypatch.setenv("RTOW_POOL", "0")
    np.testing.assert_array_equal(render_megakernel(scene, cam, cfg), whole)
    classic = mk.render_spheres(scene, cam, cfg.seed, width=130, height=80,
                                spp=17, max_depth=3, pool=False).numpy()
    assert not np.array_equal(classic / 17.0, whole.reshape(-1, 3))
    sums = mk.render_spheres(scene, cam, cfg.seed, width=130, height=80,
                             spp=17, max_depth=3).numpy()
    np.testing.assert_allclose(whole.reshape(-1, 3), sums / 17.0,
                               rtol=1e-6)
