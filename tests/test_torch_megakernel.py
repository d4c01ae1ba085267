"""The port's megakernel module against rtow_tpu's Pallas kernel on the
CPU.

The JAX side runs ``render_spheres_pallas`` under
``pltpu.force_tpu_interpret_mode()`` with the CLASSIC scheduler:
``tests/conftest.py`` sets ``RTOW_POOL=0`` before any kernel is traced.
The port side names its scheduler (``pool=False``; the work pool's gates
are ``tests/test_torch_pool.py``) and runs ``render_blocks``' plain
PyTorch version (the CUDA
kernel needs a card; ``tests/test_torch_cuda.py`` holds it against this
plain version there).  Both draw the same counter-hash random numbers
lane by lane, so images are compared pixel by pixel:

* the RNG, the sphere table and the packing agree bit for bit;
* ``three_sphere_scene``: every pixel within 1e-4 of mean radiance;
* the 487-sphere cover at depth 0: every pixel within 1e-6;
* the cover at depth 4: at least 95% of pixels within 1e-4 and mean
  |difference| at most 5e-3.  XLA's and PyTorch's float32 sin/cos differ
  in the last bits, and on the r=1000 ground sphere (|oc|^2 - r^2
  cancels) one ulp can flip whether a ray leaving the ground hits it
  again, so a few pixels take another path.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models import builders as jax_builders
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import bounce as bn
from rtow_tpu_torch.ops.lights import TWO_PI
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.ops import tables as tb
from rtow_tpu_torch.utils.rng import hash_uniform, lane_hash, mix, step_salt


def _jax_sums(scene, cam, *, width, height, spp, depth, seed=0):
    assert os.environ["RTOW_POOL"] == "0"  # classic scheduler (conftest)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jmk.render_spheres_pallas(
            scene, cam, seed, width=width, height=height, spp=spp,
            max_depth=depth))


def _port_sums(scene, cam, *, width, height, spp, depth, seed=0):
    return mk.render_spheres(scene, cam, seed, width=width, height=height,
                             spp=spp, max_depth=depth, pool=False).numpy()


def _pixel_diff(a, b, spp):
    """Per-pixel max |difference| of mean radiance over the channels."""
    return np.abs(a - b).max(axis=1) / spp


# ---------------------------------------------------------------------------
# RNG


@pytest.fixture(scope="module")
def lanes_u32():
    return np.random.default_rng(0).integers(0, 2**32, 100_000,
                                             dtype=np.uint64).astype(np.uint32)


def test_mix_bit_equal(lanes_u32):
    want = np.asarray(jmk._mix(jnp.asarray(lanes_u32)))
    got = mix(torch.from_numpy(lanes_u32.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("draw", [0, 4, 7])
def test_uniform_bit_equal(lanes_u32, draw):
    lanes = torch.from_numpy(lanes_u32.astype(np.int64))
    for salt in (0, 0x7FFFFFFF, 0xDEADBEEF):
        want = np.asarray(jmk._uniform(jnp.asarray(lanes_u32),
                                       jnp.uint32(salt), draw))
        got = hash_uniform(lanes, salt, draw).numpy()
        np.testing.assert_array_equal(got, want)


def test_salt_and_lane_hash_bit_equal():
    for seed, it in ((0, 0), (7, 3), (123, 50_000), (-5, 2**20)):
        want = jmk._mix((jnp.int32(seed) + it * jnp.int32(40503))
                        .astype(jnp.uint32))
        assert step_salt(seed, it) == int(want)
    pix = np.arange(0, 3_000_000, 997, dtype=np.int32)
    want = np.asarray(jmk._mix(jnp.asarray(pix).astype(jnp.uint32)
                               * jnp.uint32(0x9E3779B9)))
    got = lane_hash(torch.from_numpy(pix.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_draw_scatter_matches(lanes_u32):
    """Each side against a float64 oracle: the same float32 uniforms
    (bit-equal on both sides), float32 uz and uph = float32(2 pi) * uu,
    then sqrt(1 - uz^2) * (cos, sin)(uph) in float64.  Each side's float32
    unit vector is within 1e-6 of the oracle (a float32 sin/cos is within
    an ulp); uz and the choice are bit-equal.  A failure names the side
    that moved, with the JAX platform and torch's thread count, the lanes
    and angles that moved, and whether a second computation moves too."""
    import jax

    salt = 0x12345678
    lanes = torch.from_numpy(lanes_u32.astype(np.int64))
    uz = (1.0 - 2.0 * hash_uniform(lanes, salt, 5)).numpy()
    uph = (np.float32(TWO_PI) * hash_uniform(lanes, salt, 6).numpy())
    assert uz.dtype == uph.dtype == np.float32
    uxy = np.sqrt(np.maximum(1.0 - uz.astype(np.float64) ** 2, 0.0))
    oracle = (uxy * np.cos(uph.astype(np.float64)),
              uxy * np.sin(uph.astype(np.float64)))
    sides = {
        "JAX (XLA's float32 cos/sin)": [np.asarray(w) for w in
                                        jmk._draw_scatter(
                                            jnp.asarray(lanes_u32),
                                            jnp.uint32(salt))],
        "port (torch's float32 cos/sin)": [g.numpy() for g in
                                           bn.draw_scatter(lanes, salt)],
    }
    where = (f"jax platform {jax.devices()[0].platform}, "
             f"torch.get_num_threads() {torch.get_num_threads()}")

    def _again(side, name, o):
        """A failing side's error when computed once more: whether the
        fault stays (ROADMAP Queue 3 P2)."""
        k = ("uvx", "uvy").index(name)
        if side.startswith("JAX"):
            v = np.asarray(jmk._draw_scatter(jnp.asarray(lanes_u32),
                                             jnp.uint32(salt))[k])
        else:
            v = bn.draw_scatter(lanes, salt)[k].numpy()
        return np.abs(v.astype(np.float64) - o).max()
    for side, got in sides.items():
        for name, g, o in zip(("uvx", "uvy"), got, oracle):
            err = np.abs(g.astype(np.float64) - o)
            bad = np.nonzero(err > 1e-6)[0]
            assert err.max() <= 1e-6, (
                f"{side} moved: {name} off the float64 oracle by up to "
                f"{err.max():.3g} on {np.mean(err > 1e-6):.2%} of lanes, "
                f"lanes {bad.min()}..{bad.max()} with uph in "
                f"[{uph[bad].min():.4g}, {uph[bad].max():.4g}]; computed "
                f"again now, off by up to {_again(side, name, o):.3g} "
                f"({where})")
        np.testing.assert_array_equal(got[2], uz, err_msg=f"{side} uz")
    np.testing.assert_array_equal(sides["port (torch's float32 cos/sin)"][3],
                                  sides["JAX (XLA's float32 cos/sin)"][3])


# ---------------------------------------------------------------------------
# Tables and packing


def _covers(seed, moving, width=64):
    kw = dict(seed=seed, moving_spheres=moving, image_width=width,
              aspect_ratio=16.0 / 9.0)
    return (jax_builders.cover_scene(JaxConfig(**kw)),
            builders.cover_scene(Config(device="cpu", **kw)))


@pytest.mark.parametrize("seed,moving", [(0, True), (7, True), (0, False),
                                         (123, False)])
def test_sphere_table_bit_equal(seed, moving):
    (jscene, _), (scene, _) = _covers(seed, moving)
    jtbl, jboxes = jmk.build_sphere_table(jscene)
    tbl, boxes = tb.build_sphere_table(scene)
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jtbl))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jboxes))
    if not moving:
        # Static covers have equal Morton codes: the order rests on the
        # stable sort.
        sp = scene.spheres
        r = sp.radius.abs()[:, None]
        smin, smax = sp.center0 - r, sp.center0 + r
        codes = tb._morton_codes(smin.amin(0), smax.amax(0),
                                 0.5 * (smin + smax))
        assert codes.unique().numel() < codes.numel()


def test_pack_camera_and_meta_match_jax():
    (jscene, jcam), (_, cam) = _covers(0, True)
    want = np.asarray(jnp.stack([
        jcam.origin[0], jcam.origin[1], jcam.origin[2],
        jcam.u[0], jcam.u[1], jcam.u[2],
        jcam.v[0], jcam.v[1], jcam.v[2],
        jcam.lower_left[0], jcam.lower_left[1], jcam.lower_left[2],
        jcam.horizontal[0], jcam.horizontal[1], jcam.horizontal[2],
        jcam.vertical[0], jcam.vertical[1], jcam.vertical[2],
        jcam.lens_radius, jcam.t0, jcam.t1 - jcam.t0,
    ]).astype(jnp.float32))
    np.testing.assert_array_equal(tb.pack_camera(cam).numpy(), want)
    assert tb.pack_meta(3, width=1200, height=675, spp=128, max_depth=50,
                        tile0=85) == (3, 1200, 675, 810000, 85, 128, 50)
    with pytest.raises(ValueError):
        tb.pack_meta(2**31, width=8, height=8, spp=1, max_depth=1)


def test_unblock_image_matches_jax():
    width, height = 200, 20
    rows = tb.n_tiles_for(width, height) * tb.TILE_ROWS
    planes = np.random.default_rng(3).random((3, rows, tb.LANES),
                                             dtype=np.float32)
    want = np.asarray(jmk.unblock_image(*map(jnp.asarray, planes),
                                        width=width, height=height))
    got = mk.unblock_image(*map(torch.from_numpy, planes), width=width,
                           height=height).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The plain kernel against the Pallas kernel, lane by lane


def test_three_sphere_matches_pallas():
    kw = dict(width=32, height=32, spp=4, depth=5)
    want = _jax_sums(*jax_builders.three_sphere_scene(1.0), **kw)
    got = _port_sums(*builders.three_sphere_scene(1.0, device="cpu"), **kw)
    assert _pixel_diff(got, want, 4).max() <= 1e-4


def test_cover_depth0_matches_pallas():
    kw = dict(width=64, height=36, spp=1, depth=0)
    (jscene, jcam), (scene, cam) = _covers(0, True, width=64)
    d = _pixel_diff(_port_sums(scene, cam, **kw),
                    _jax_sums(jscene, jcam, **kw), 1)
    assert d.max() <= 1e-6


def test_cover_depth4_matches_pallas():
    kw = dict(width=32, height=18, spp=2, depth=4)
    (jscene, jcam), (scene, cam) = _covers(0, True, width=32)
    got = _port_sums(scene, cam, **kw)
    want = _jax_sums(jscene, jcam, **kw)
    d = _pixel_diff(got, want, 2)
    assert np.mean(d <= 1e-4) >= 0.95
    assert np.abs(got - want).mean() / 2 <= 5e-3


# ---------------------------------------------------------------------------
# Sample accounting and the wrapper's contract


@pytest.fixture(scope="module")
def const_bg():
    """Empty scene + white background: radiance sums == sample counts."""
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device="cpu")
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    return b.build(background=(1.0, 1.0, 1.0), device="cpu"), cam


@pytest.mark.parametrize("spp", [24, 17])
def test_exact_sample_accounting(const_bg, spp):
    scene, cam = const_bg
    sums = _port_sums(scene, cam, width=24, height=24, spp=spp, depth=4)
    np.testing.assert_array_equal(sums, float(spp))


def test_out_of_image_lanes_stay_zero(const_bg):
    scene, cam = const_bg
    tbl, _ = tb.build_sphere_table(scene)
    meta = tb.pack_meta(0, width=24, height=20, spp=3, max_depth=2)
    r, g, b = mk.render_blocks(tbl, tb.pack_camera(cam), meta,
                               tb.n_tiles_for(24, 20),
                               background=scene.background, pool=False)
    # One tile column: block rows are image rows.
    assert r.shape == (3 * tb.TILE_ROWS, tb.LANES)
    for plane in (r, g, b):
        assert bool((plane[:20, :24] == 3).all())
        assert float(plane[20:].abs().sum() + plane[:, 24:].abs().sum()) == 0


def test_wrapper_on_cpu_counts_no_launch(const_bg):
    scene, cam = const_bg
    before = mk.render_blocks.launches
    _port_sums(scene, cam, width=8, height=8, spp=1, depth=1)
    assert mk.render_blocks.launches == before == 0


def test_wrapper_rejects_other_devices_and_bad_inputs(const_bg):
    scene, cam = const_bg
    tbl, _ = tb.build_sphere_table(scene)
    camv = tb.pack_camera(cam)
    meta = tb.pack_meta(0, width=8, height=8, spp=1, max_depth=1)
    with pytest.raises(ValueError, match="no megakernel"):
        mk.render_blocks(tbl.to("meta"), camv.to("meta"), meta, 1)
    with pytest.raises(ValueError, match="sphere table"):
        mk.render_blocks(tbl[:, :8].contiguous(), camv, meta, 1)
    with pytest.raises(ValueError, match="camera"):
        mk.render_blocks(tbl, camv[:20], meta, 1)
