"""The port's mesh pieces against rtow_tpu on the CPU: the OBJ loader, the
triangle parts of the scene builder, the triangle table with its
hierarchy, and K1's plain version with triangles.

Tolerances:

* ``load_obj``, ``add_triangle`` / ``add_mesh`` / ``mesh_scene`` and
  ``build_tri_table`` (rows, block boxes, super and hyper boxes) agree
  EXACTLY (tolerance 0): both packages build in float64, cast to float32
  once, and order the triangles by the same float32 median split.
* K1's plain version on the 384-triangle knot plus a ground sphere
  against ``render_spheres_pallas`` in interpret mode, lane by lane (the
  CLASSIC scheduler: ``tests/conftest.py`` sets ``RTOW_POOL=0``): at least
  95% of pixels within 1e-4 of mean radiance and mean |difference| at
  most 5e-3, as ``test_torch_megakernel.py`` holds the cover (XLA's and
  PyTorch's float32 sin/cos and rsqrt differ in the last bits, which can
  flip a discrete choice on a few paths).
"""
import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models import builders as jax_builders
from rtow_tpu.models.camera import make_camera as jax_make_camera
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu.utils import obj as jax_obj
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import Scene, SceneBuilder
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.utils import obj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOT_SMALL = os.path.join(ROOT, "samples", "knot_small.obj")
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain sweeps are many small PyTorch ops: one intra-op thread
    runs them as fast here and keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(scene):
    parts = ("spheres", "triangles", "materials")
    return {f"{p}.{k}": np.asarray(v.cpu() if hasattr(v, "cpu") else v)
            for p in parts for k, v in vars(getattr(scene, p)).items()}


def _assert_same_scene(jscene, scene):
    want, got = _leaves(jscene), _leaves(scene)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# The OBJ loader


_OBJS = {
    "negative_and_slashes": (
        "# a quad as two triangles, every face-entry form\n"
        "o first\nv 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 -0.25\n"
        "vt 0 0\nvn 0 0 1\n"
        "f 1 2 3\nf -4/1 -2/1/1 -1//1\n"
        "g second\nv 2 2 2\nf 5 1 2\n"),
    "comments_and_blanks": "\n  # c\nv 1 2 3\n\nv 4 5 6\nv 7 8 9.5\nf 1 2 3\n",
}


@pytest.mark.parametrize("name", sorted(_OBJS) + ["knot_small"])
def test_load_obj_equals_jax(tmp_path, name):
    if name == "knot_small":
        path = KNOT_SMALL
    else:
        path = str(tmp_path / f"{name}.obj")
        with open(path, "w") as f:
            f.write(_OBJS[name])
    want = jax_obj.load_obj(path, use_native=False)
    got = obj.load_obj(path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", [
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",  # a quad
    "v 0 0 0\nv 1 0 0\nf 1 2 3\n",  # an index out of range
    "v 0 0 0\n",  # no faces
    "v 0 0\nf 1 1 1\n",  # a malformed vertex
])
def test_load_obj_raises_as_jax(tmp_path, text):
    path = str(tmp_path / "bad.obj")
    with open(path, "w") as f:
        f.write(text)
    with pytest.raises(jax_obj.ObjError):
        jax_obj.load_obj(path, use_native=False)
    with pytest.raises(obj.ObjError):
        obj.load_obj(path)


# ---------------------------------------------------------------------------
# Scene builder and mesh_scene


def test_triangles_and_meshes_build_as_jax():
    verts, faces = make_knot(12, 8)
    scenes = []
    for b in (JaxSceneBuilder(), SceneBuilder()):
        m = b.add_lambertian((0.6, 0.5, 0.4))
        glass = b.add_dielectric(1.5)
        b.add_sphere((0.0, -101.0, 0.0), 100.0, m)
        b.add_triangle((0, 0, 0), (1, 0, 0.1), (0.3, 1, 0), glass)
        b.add_mesh(verts[faces], m, scale=0.7, rotate_y=30.0,
                   translate=(0.1, -0.2, 0.3))
        b.add_mesh(verts[faces[:5]], glass)
        scenes.append(b.build() if isinstance(b, JaxSceneBuilder)
                      else b.build(device="cpu"))
    _assert_same_scene(*scenes)
    assert scenes[1].n_triangles == 1 + 5 + len(faces)
    assert scenes[1].n_spheres == 1


def test_triangle_only_scene_and_texture_rule():
    b = SceneBuilder()
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), b.add_lambertian((1,) * 3))
    scene = b.build(device="cpu")
    assert (scene.n_spheres, scene.n_triangles, scene.n_primitives) == (0, 1, 1)
    b._add_mat(4, (1, 0, 0), 0.0, 10.0)  # a checker, which the port lacks
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), 1)
    with pytest.raises(ValueError, match="sphere-only"):
        b.build(device="cpu")


def test_mesh_scene_equals_jax():
    kw = dict(model=KNOT_SMALL, aspect_ratio=1.5, image_width=30)
    jscene, jcam = jax_builders.mesh_scene(JaxConfig(**kw))
    cfg = Config(device="cpu", **kw)
    scene, cam = builders.scene_for_config(cfg)
    _assert_same_scene(jscene, scene)
    assert scene.n_triangles == 1920
    for f in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
              "lens_radius"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), f)


def test_scene_from_numpy_carries_triangles():
    verts, faces = make_knot(8, 6)
    b = JaxSceneBuilder()
    b.add_mesh(verts[faces], b.add_metal((0.9, 0.8, 0.7), 0.2))
    jscene = b.build()
    scene = Scene.from_numpy(_leaves(jscene), "cpu")
    _assert_same_scene(jscene, scene)
    back = scene.to_numpy()
    np.testing.assert_array_equal(back["triangles.verts"],
                                  np.asarray(jscene.triangles.verts))


# ---------------------------------------------------------------------------
# The triangle table


def _knot_scenes(segments, rings):
    verts, faces = make_knot(segments, rings)
    out = []
    for b in (JaxSceneBuilder(), SceneBuilder()):
        b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
        out.append(b.build() if isinstance(b, JaxSceneBuilder)
                   else b.build(device="cpu"))
    return out


@pytest.mark.parametrize("segments,rings,width", [
    (16, 12, "pick"), (64, 64, "pick"), (256, 256, "pick"),
    (16, 12, 128), (64, 64, 128), (64, 160, 128),
])
def test_tri_table_bit_equal(segments, rings, width):
    jscene, scene = _knot_scenes(segments, rings)
    n = scene.n_triangles
    if width == "pick":
        with jmk.tri_block_for(n) as tb:
            want = jmk.build_tri_table(jscene)
        assert mk.pick_tri_block(n) == tb
    else:
        tb = width
        assert jmk.TRI_BLOCK == tb == mk.K1_TRI_BLOCK  # what K1 reads
        want = jmk.build_tri_table(jscene)
    got = mk.build_tri_table(scene, tb)
    for name, g, w in zip(("tbl", "boxes", "supers", "hypers"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got.count == n and got.block == tb
    levels = {(16, 12): (0, 0), (64, 64): (2, 0), (256, 256): (32, 2)}
    if width == "pick":
        assert (got.n_super, got.n_hyper) == levels[(segments, rings)]


# ---------------------------------------------------------------------------
# K1's plain version with triangles against the Pallas kernel


def test_k1_knot_and_sphere_matches_pallas():
    verts, faces = make_knot(16, 12)  # 384 triangles: 3 blocks of 128
    kw = dict(width=32, height=32, spp=2, max_depth=4)
    jb, b = JaxSceneBuilder(), SceneBuilder()
    for bb in (jb, b):
        knot = bb.add_lambertian((0.6, 0.5, 0.4))
        ground = bb.add_metal((0.5, 0.5, 0.5), 0.2)
        bb.add_mesh(verts[faces], knot)
        bb.add_sphere((0.0, -101.0, 0.0), 100.0, ground)
    cam_kw = dict(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                  fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                  focus_dist=3.0)
    assert os.environ["RTOW_POOL"] == "0"  # classic scheduler (conftest)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmk.render_spheres_pallas(
            jb.build(), jax_make_camera(**cam_kw), 0, **kw))
    scene = b.build(device="cpu")
    tests = torch.zeros(2, dtype=torch.int64)
    tbl, tris = mk.scene_k1_tables(scene)
    r, g, bl = mk.render_blocks(
        tbl, mk.pack_camera(make_camera(device="cpu", **cam_kw)),
        mk.pack_meta(0, width=32, height=32, spp=2, max_depth=4),
        mk.n_tiles_for(32, 32), tris=tris, tests=tests, pool=False)
    got = mk.unblock_image(r, g, bl, width=32, height=32).numpy()
    d = np.abs(got - want).max(axis=1) / 2
    assert np.mean(d <= 1e-4) >= 0.95
    assert np.abs(got - want).mean() / 2 <= 5e-3
    # Both the sphere and the knot were hit, and the sweep was counted.
    assert tests[0] > 0 and tests[1] > 0
    assert np.isfinite(got).all() and got.std() > 0.05
