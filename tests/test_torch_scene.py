"""The port's host layer against rtow_tpu on the CPU: config, scene
builders, camera, ``from_numpy`` round trips, PPM output, render stats,
and the rule that rtow_tpu_torch never imports JAX.

Scenes are built from the same numpy PCG64 seeds in both packages and
must agree EXACTLY (tolerance 0): both assemble in float64 and cast to
float32 once.
"""
import ast
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models import builders as jax_builders
from rtow_tpu.utils import ppm as jax_ppm
from rtow_tpu.utils.profiling import RenderStats as JaxRenderStats
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import Camera, make_camera
from rtow_tpu_torch.models.scene import Scene, SceneBuilder
from rtow_tpu_torch.utils import ppm
from rtow_tpu_torch.utils.profiling import RenderStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scene_leaves(scene) -> dict:
    """Either package's scene as {"spheres.center0": ndarray, ...}."""
    out = {}
    for part in ("spheres", "triangles", "materials"):
        obj = getattr(scene, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


def camera_leaves(cam) -> dict:
    return {f.name: np.asarray(getattr(cam, f.name))
            for f in dataclasses.fields(cam)}


def assert_leaves_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _cover(seed, moving):
    kw = dict(seed=seed, moving_spheres=moving, image_width=64)
    return (jax_builders.cover_scene(JaxConfig(**kw)),
            builders.cover_scene(Config(device="cpu", **kw)))


CASES = {
    "cover-s0-moving": lambda: _cover(0, True),
    "cover-s7-moving": lambda: _cover(7, True),
    "cover-s0-static": lambda: _cover(0, False),
    "cover-s7-static": lambda: _cover(7, False),
    "one-sphere": lambda: (jax_builders.one_sphere_scene(),
                           builders.one_sphere_scene(device="cpu")),
    "three-sphere": lambda: (jax_builders.three_sphere_scene(1.5),
                             builders.three_sphere_scene(1.5,
                                                         device="cpu")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_builders_match_jax_exactly(case):
    (jscene, jcam), (scene, cam) = CASES[case]()
    assert scene.background == jscene.background
    assert_leaves_equal(scene_leaves(scene), scene_leaves(jscene))
    assert_leaves_equal(camera_leaves(cam), camera_leaves(jcam))


@pytest.mark.parametrize("case", ["cover-s0-moving", "three-sphere"])
def test_from_numpy_round_trips(case):
    (jscene, jcam), _ = CASES[case]()
    leaves = scene_leaves(jscene)
    scene = Scene.from_numpy(leaves, "cpu")
    assert_leaves_equal(scene_leaves(scene), leaves)
    cam = Camera.from_numpy(camera_leaves(jcam), "cpu")
    assert_leaves_equal(camera_leaves(cam), camera_leaves(jcam))


def test_from_numpy_rejects_unported_leaves():
    (jscene, _), _ = CASES["one-sphere"]()
    leaves = scene_leaves(jscene)
    leaves["triangles.verts"] = np.ones((1, 3, 3), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scene.from_numpy(leaves, "cpu")


def test_cover_scene_follows_the_config_device():
    scene, cam = builders.cover_scene(Config(device="cpu", image_width=32))
    for key, leaf in scene.leaves().items():
        assert leaf.device.type == "cpu", key
    for name in ("origin", "lower_left", "lens_radius"):
        assert getattr(cam, name).device.type == "cpu"
    # An explicit device wins over the config's.
    scene, _ = builders.cover_scene(Config(image_width=32), device="cpu")
    assert scene.device.type == "cpu"


@pytest.mark.parametrize("build", [
    lambda: builders.cover_scene(Config(image_width=32)),
    lambda: builders.one_sphere_scene(),
    lambda: builders.three_sphere_scene(),
    lambda: make_camera((0.0, 0.0, 1.0), (0.0, 0.0, 0.0)),
    lambda: _one_ball().build(),
], ids=["cover_scene", "one_sphere_scene", "three_sphere_scene",
        "make_camera", "SceneBuilder.build"])
def test_builders_default_to_the_card(build):
    """Called with their defaults, the builders put their tensors on the
    card, and raise where there is none: never the CPU."""
    if torch.cuda.is_available():
        out = build()
        first = out[0].spheres.radius if isinstance(out, tuple) else (
            out.origin if hasattr(out, "origin") else out.spheres.radius)
        assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build()


def _one_ball():
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -1.0), 0.5, b.add_lambertian((0.5,) * 3))
    return b


def test_config_matches_jax():
    port, ref = Config(), JaxConfig()
    shared = {f.name for f in dataclasses.fields(ref)}
    assert {f.name for f in dataclasses.fields(port)} == shared | {"device"}
    for name in shared:
        assert getattr(port, name) == getattr(ref, name), name
    cfg = dict(image_width=1200, aspect_ratio=16.0 / 9.0, seed=3)
    assert str(Config(**cfg)) == str(JaxConfig(**cfg))
    assert Config(**cfg).image_height == JaxConfig(**cfg).image_height == 675


def test_write_ppm_byte_equal_to_jax(rng):
    img = rng.uniform(-0.1, 1.3, size=(5, 7, 3))
    ours, ref = io.StringIO(), io.StringIO()
    ppm.write_ppm(ours, img)
    jax_ppm.write_ppm(ref, img, use_native=False)
    assert ours.getvalue() == ref.getvalue()
    back = ppm.read_ppm(io.StringIO(ours.getvalue()))
    np.testing.assert_array_equal(back, jax_ppm.tonemap(img))
    np.testing.assert_array_equal(ppm.tonemap(img), jax_ppm.tonemap(img))


def test_render_stats_summary_matches_jax():
    args = (1.234, 1200 * 675, 128, 50)
    ours = RenderStats(*args).summary()
    ref = JaxRenderStats(*args, backend="cuda").summary()
    assert ours == ref
    assert ours.endswith("depth 50, cuda)")


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_never_import_jax_or_rtow_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "rtow_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rtow_tpu"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rtow_tpu'] = None\n"
        "import rtow_tpu_torch, rtow_tpu_torch.cli, rtow_tpu_torch.pipeline\n"
        "import rtow_tpu_torch.ops.megakernel, rtow_tpu_torch.ops._cuda\n"
        "import rtow_tpu_torch.ops.grad, rtow_tpu_torch.diff\n"
        "assert not any(m.startswith(('jax', 'rtow_tpu.')) for m, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
