"""The port's light-driven path against rtow_tpu on the CPU: the demo
scene builders (``--lights``, ``--cornell``, ``--textures``, ``--smoke``,
the ``--checker`` cover), ``Scene.from_numpy`` of their JAX scenes, K1's
plain version with emission, NEE+MIS, textures, media and Russian
roulette, the CLI flags, and those features on meshes over 16,384
triangles (the sorted wavefront and K3's plain lit version).

Tolerances:

* builders and ``from_numpy``: arrays EXACTLY equal (both build in
  float64 and cast to float32 once) and the metadata equal;
* K1's plain version against ``render_spheres_pallas`` in interpret mode
  (the classic scheduler: ``tests/conftest.py`` sets ``RTOW_POOL=0``),
  lane by lane on three tiles: at least 95% of pixels within 1e-4 of mean
  radiance and mean |difference| at most 5e-3, as
  ``test_torch_mesh.py`` holds the mesh (XLA's and PyTorch's float32
  sin/cos/exp/log differ in the last bit, which can flip a discrete
  choice on a few paths).
"""
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models import builders as jax_builders
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu_torch import cli, pipeline, time_k1
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import Scene, SceneBuilder
from rtow_tpu_torch.ops import flat_bounce, grad
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.ops import tables as tb
from rtow_tpu_torch.utils.ppm import read_ppm

_PARTS = ("spheres", "triangles", "materials", "volumes")
_META = ("background", "has_emissive", "light_ids", "has_checker",
         "volume_kinds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bounce is many small PyTorch ops: one intra-op thread
    runs them as fast here and keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(scene):
    return {f"{p}.{k}": np.asarray(v.cpu() if hasattr(v, "cpu") else v)
            for p in _PARTS if getattr(scene, p) is not None
            for k, v in vars(getattr(scene, p)).items()}


def _cover_cfg(width=24, **kw):
    return dict(image_width=width, aspect_ratio=1.0, number_of_balls_sqrt=3,
                **kw)


DEMOS = {
    "lights": lambda: (jax_builders.light_scene(1.0),
                       builders.light_scene(1.0, device="cpu")),
    "cornell": lambda: (jax_builders.cornell_scene(1.0),
                        builders.cornell_scene(1.0, device="cpu")),
    "textures": lambda: (jax_builders.textures_scene(1.0),
                         builders.textures_scene(1.0, device="cpu")),
    "smoke": lambda: (jax_builders.smoke_scene(1.0),
                      builders.smoke_scene(1.0, device="cpu")),
    "checker": lambda: (
        jax_builders.cover_scene(JaxConfig(**_cover_cfg(checker_ground=True))),
        builders.cover_scene(Config(device="cpu",
                                    **_cover_cfg(checker_ground=True)))),
    "cover": lambda: (jax_builders.cover_scene(JaxConfig(**_cover_cfg())),
                      builders.cover_scene(Config(device="cpu",
                                                  **_cover_cfg()))),
}


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_builders_equal_jax(name):
    (jscene, jcam), (scene, cam) = DEMOS[name]()
    want, got = _leaves(jscene), _leaves(scene)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in _META:
        assert getattr(scene, k) == getattr(jscene, k), k
    for f in ("origin", "lower_left", "horizontal", "vertical"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), f)


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_from_numpy_carries_jax_scenes(name):
    (jscene, _), _ = DEMOS[name]()
    scene = Scene.from_numpy(_leaves(jscene), "cpu",
                             background=jscene.background,
                             volume_kinds=jscene.volume_kinds)
    want, got = _leaves(jscene), scene.to_numpy()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert scene.meta() == {k: getattr(jscene, k) for k in _META}
    again = Scene.from_numpy(scene.to_numpy(), "cpu", **scene.meta())
    assert again.meta() == scene.meta()


def test_from_numpy_checks_metadata():
    (jscene, _), _ = DEMOS["smoke"]()
    with pytest.raises(ValueError, match="volume_kinds"):
        Scene.from_numpy(_leaves(jscene), "cpu")
    with pytest.raises(ValueError, match="disagrees"):
        Scene.from_numpy(_leaves(jscene), "cpu",
                         volume_kinds=jscene.volume_kinds, has_emissive=False)


def test_build_limits_as_jax():
    b = SceneBuilder()
    lamp = b.add_light((1.0, 1.0, 1.0))
    for i in range(17):
        b.add_sphere((i, 0, 0), 0.1, lamp)
    with pytest.raises(ValueError, match="at most 16 emissive"):
        b.build(device="cpu")
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_lambertian((0.5,) * 3))
    for i in range(9):
        b.add_fog_sphere((i, 0, 0), 0.5, 1.0)
    with pytest.raises(ValueError, match="at most 8 volumes"):
        b.build(device="cpu")
    b = SceneBuilder()
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                   b.add_noise((1, 1, 1), (0, 0, 0)))
    with pytest.raises(ValueError, match="sphere-only"):
        b.build(device="cpu")


# ---------------------------------------------------------------------------
# K1's plain version against the Pallas kernel, lane by lane


@pytest.mark.parametrize("name,roulette,depth", [
    ("lights", False, 4), ("cornell", False, 4), ("textures", False, 4),
    ("smoke", False, 4), ("cover", True, 8)])
def test_k1_lit_matches_pallas(name, roulette, depth):
    (jscene, jcam), (scene, cam) = DEMOS[name]()
    kw = dict(width=24, height=24, spp=2, max_depth=depth, roulette=roulette)
    assert os.environ["RTOW_POOL"] == "0"  # classic scheduler (conftest)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmk.render_spheres_pallas(jscene, jcam, 0, **kw))
    shadows = torch.zeros(1, dtype=torch.int64)
    tbl, tris = tb.k1_tables(scene)
    lit = tb.scene_lit(scene, nee=scene.has_emissive, roulette=roulette)
    r, g, b = mk.render_blocks(
        tbl, tb.pack_camera(cam),
        tb.pack_meta(0, width=24, height=24, spp=2, max_depth=depth),
        tb.n_tiles_for(24, 24), background=scene.background, tris=tris,
        lit=lit, shadows=shadows, pool=False)
    got = mk.unblock_image(r, g, b, width=24, height=24).numpy()
    d = np.abs(got - want).max(axis=1) / 2
    assert np.mean(d <= 1e-4) >= 0.95
    assert np.abs(got - want).mean() / 2 <= 5e-3
    assert np.isfinite(got).all() and got.std() > 0.01
    assert (int(shadows) > 0) == bool(lit.nee_kinds)


def test_lit_features_of_the_scenes():
    (_, _), (cornell, _) = DEMOS["cornell"]()
    lit = tb.scene_lit(cornell, nee=cornell.has_emissive)
    assert lit.emissive and lit.nee_kinds == ("t", "t") and lit.any
    assert lit.rows.shape == (2, 14) and not lit.vol_kinds
    (_, _), (smoke, _) = DEMOS["smoke"]()
    lit = tb.scene_lit(smoke, nee=smoke.has_emissive)
    assert lit.vol_kinds == ("r", "r") and lit.vol_row0 == 2
    assert lit.rows.shape == (4, 14)
    (_, _), (cover, _) = DEMOS["cover"]()
    nee = cover.has_emissive
    assert not tb.scene_lit(cover, nee=nee).any
    assert tb.scene_lit(cover, nee=nee, roulette=True).any


@pytest.mark.parametrize("name", time_k1.SCENES)
def test_time_k1_launches_each_scene(name):
    """``python -m rtow_tpu_torch.time_k1``'s launches: the plain instance
    for the cover, a lit one for every other scene; an unknown scene is
    refused before anything runs."""
    args, kw = time_k1._frame_args(name, torch.device("cpu"))
    assert kw["lit"].any == (name != "cover")
    assert kw["lit"].roulette == (name == "roulette")
    assert args[3] == tb.n_tiles_for(*args[2][1:3])
    with pytest.raises(SystemExit):
        time_k1.main(["--runs", "1", name, "no-such-scene"])


def test_shared_memory_check_counts_lit_rows():
    """The kernel stages the light and volume rows beside the sphere
    table: the wrapper's shared-memory check counts them and raises a
    ValueError before any launch.  Tensors on the meta device reach the
    check without a card: 28 sphere blocks (229,376 bytes) fit the
    classic instance alone, and 64 staged rows of 14 floats (3,584 bytes)
    push them over."""
    tbl = torch.empty((28 * tb.SPHERE_BLOCK, tb.TBL_COLS), device="meta")
    cam = torch.empty(21, device="meta")
    meta = tb.pack_meta(0, width=8, height=8, spp=1, max_depth=1)
    lit = tb.Lit(vol_kinds=("s",), vol_row0=63,
                 rows=torch.empty((64, 14), device="meta"))
    assert tb.lit_rows(lit) == 64
    with pytest.raises(ValueError, match="3584 bytes of light and volume"):
        mk.render_blocks(tbl, cam, meta, 1, lit=lit, pool=False)
    with pytest.raises(ValueError, match="no megakernel for device meta"):
        mk.render_blocks(tbl, cam, meta, 1, pool=False)


# ---------------------------------------------------------------------------
# The CLI


@pytest.mark.parametrize("flag", ["--lights", "--cornell", "--textures",
                                  "--checker", "--smoke",
                                  "--russian-roulette"])
def test_cli_flag_renders_on_cpu(tmp_path, flag):
    out = tmp_path / "lit.ppm"
    before = mk.render_blocks.launches
    assert cli.main(["--device", "cpu", flag, "-w", "64", "-a", "1", "-s",
                     "2", "-c", "4", "-n", "3", "-o", str(out)]) == 0
    assert mk.render_blocks.launches == before  # the plain version
    with open(out) as f:
        img = read_ppm(f)
    assert img.shape == (64, 64, 3) and img.std() > 5


def test_cli_globe_still_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        cli.main(["--device", "cpu", "--globe", "-w", "16"])


# ---------------------------------------------------------------------------
# Meshes over 16,384 triangles: the sorted wavefront's lit features


def _big_mesh(material: str, background=(1.0, 1.0, 1.0)):
    """A 16,640-triangle strip (over K1's 16,384, so the sorted wavefront
    and K3 render it), facing the camera, with a lamp in front of it, a
    dark fog ball, a checkered ground or nothing beside it ("plain")."""
    n = 16640
    x = np.arange(n, dtype=np.float64)
    tris = np.stack([np.stack([x, np.zeros(n), np.zeros(n)], 1),
                     np.stack([x + 1, np.zeros(n), np.zeros(n)], 1),
                     np.stack([x, np.ones(n), np.zeros(n)], 1)], 1)
    b = SceneBuilder()
    b.add_mesh(tris, b.add_lambertian((0.5,) * 3))
    if "light" in material:
        b.add_sphere((0.9, 0.5, 2.0), 0.3, b.add_light((4.0, 4.0, 4.0)))
    if "fog" in material:
        b.add_fog_sphere((0.5, 0.5, 0.0), 1.0, 2.0, albedo=(0.2,) * 3)
    ground = b.add_checker((1, 1, 1), (0, 0, 0)) if "checker" in material \
        else b.add_lambertian((1.0,) * 3)
    b.add_sphere((0, -100, 0), 99.0, ground)
    return b.build(background=background, device="cpu")


def _render_big(scene, roulette=False, depth=8):
    assert pipeline.wavefront_supported(scene)
    cam = make_camera(lookfrom=(0, 0, 5), lookat=(0, 0, 0), fov_degrees=40,
                      aspect_ratio=1.0, aperture=0.0, focus_dist=5.0,
                      device="cpu")
    cfg = Config(device="cpu", image_width=16, aspect_ratio=1.0,
                 samples_per_pixel=4, max_child_rays=depth,
                 russian_roulette=roulette)
    before = flat_bounce.bounce_step.launches
    img = pipeline.render_auto(scene, cam, cfg)
    assert flat_bounce.bounce_step.launches == before  # the CPU's plain K3
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    return img


@pytest.mark.parametrize("material,roulette", [
    ("light", False), ("fog", False), ("checker", False), ("plain", True)])
def test_large_meshes_render_lit_features(material, roulette):
    """Scenes over 16,384 triangles take the sorted wavefront and K3 with
    their lit features: render_auto renders them, and each feature shows.
    The lamp is the only light of a black scene; the dark fog dims the
    white sky; the checker's black squares darken the white ground; and
    roulette changes the image (its draws are a lane's own, so every
    other lane renders as without it) but not its mean."""
    if material == "light":
        scene = _big_mesh(material, background=(0.0, 0.0, 0.0))
        assert tb.scene_lit(scene, nee=scene.has_emissive).nee_kinds == ("s",)
        img = _render_big(scene)
        assert img.mean() > 0.01
        return
    scene = _big_mesh(material)
    img = _render_big(scene, roulette)
    without = _render_big(_big_mesh("plain"))
    if material == "plain":
        assert not np.array_equal(img, without)
        assert abs(img.mean() - without.mean()) < 0.05
    else:
        assert img.mean() < without.mean() - 0.02


def test_large_mesh_renders_every_lit_feature_at_once():
    """The lamp, the fog, the checkered ground and roulette on one scene
    over 16,384 triangles: K3's lit bounce takes them together (rows: the
    light, then the volume from ``vol_row0`` 1)."""
    scene = _big_mesh("light fog checker", background=(0.0, 0.0, 0.0))
    lit = tb.scene_lit(scene, nee=scene.has_emissive, roulette=True)
    assert (lit.emissive, lit.nee_kinds, lit.checker, lit.vol_kinds,
            lit.vol_row0, lit.roulette) == (True, ("s",), True, ("s",), 1,
                                            True)
    img = _render_big(scene, roulette=True, depth=50)
    assert img.mean() > 0.01


@pytest.mark.parametrize("feature", ["light", "checker", "fog"])
def test_gradient_kernels_take_lit_scenes(feature):
    """K4 / K5 take emission, NEE and textures since the lit slice of the
    gradient path, and media since its media slice: none is refused."""
    b = SceneBuilder()
    b.add_sphere((0, -100, 0), 100.0, b.add_lambertian((0.5,) * 3))
    if feature == "light":
        b.add_sphere((0, 1, 0), 0.5, b.add_light((4.0, 4.0, 4.0)))
    if feature == "checker":
        b.add_sphere((0, 1, 0), 0.5, b.add_checker((1, 1, 1), (0, 0, 0)))
    if feature == "fog":
        b.add_fog_sphere((0, 1, 0), 0.5, 1.0)
    scene = b.build(device="cpu")
    cam = make_camera(lookfrom=(0, 1, 4), lookat=(0, 1, 0), fov_degrees=40,
                      aspect_ratio=1.0, aperture=0.0, focus_dist=4.0,
                      device="cpu")
    kw = dict(width=8, height=8, spp=1, max_depth=1,
              nee=feature == "light")
    img = grad.render_pixels_kernel(scene, cam, torch.Generator(),
                                    list(range(64)), **kw)
    assert img.shape == (64, 3) and bool(torch.isfinite(img).all())
    assert float(img.max()) > 0
