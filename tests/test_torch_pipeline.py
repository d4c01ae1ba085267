"""The port's slice end to end on the CPU: Config -> scene_for_config ->
render_auto -> PPM, against rtow_tpu's ``render_pallas`` in interpret
mode, plus the CLI surface.

The JAX side runs the CLASSIC scheduler (``tests/conftest.py`` sets
``RTOW_POOL=0``).  Tolerance for the cover frame: at least 95% of pixels
within 1e-4 of mean radiance and mean |difference| at most 5e-3 (see
tests/test_torch_megakernel.py for why a few pixels flip).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu import cli as jax_cli
from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models.builders import scene_for_config as jax_scene_for_config
from rtow_tpu.pipeline import render_pallas
from rtow_tpu_torch import cli
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import scene_for_config
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.pipeline import render_auto, render_megakernel
from rtow_tpu_torch.utils.ppm import read_ppm, tonemap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slice_matches_render_pallas():
    kw = dict(image_width=32, aspect_ratio=16.0 / 9.0, samples_per_pixel=2,
              max_child_rays=4)
    jcfg = JaxConfig(backend="pallas", **kw)
    assert os.environ["RTOW_POOL"] == "0"  # classic scheduler (conftest)
    with pltpu.force_tpu_interpret_mode():
        want = render_pallas(*jax_scene_for_config(jcfg), jcfg)
    cfg = Config(device="cpu", **kw)
    got = render_auto(*scene_for_config(cfg), cfg)
    assert got.shape == want.shape == (18, 32, 3)
    assert got.dtype == want.dtype == np.float64
    d = np.abs(got - want).max(axis=2)
    assert np.mean(d <= 1e-4) >= 0.95
    assert np.abs(got - want).mean() <= 5e-3


def test_banded_progress_path_bit_identical(capsys):
    """The 10-band ticker path (tile0 > 0 launches) renders the same
    image as the whole-frame launch."""
    cfg = Config(device="cpu", image_width=130, aspect_ratio=130 / 80,
                 samples_per_pixel=1, max_child_rays=3, seed=5)
    assert mk.n_tiles_for(cfg.image_width, cfg.image_height) == 20
    scene, cam = scene_for_config(cfg)
    whole = render_megakernel(scene, cam, cfg)
    banded = render_megakernel(scene, cam, cfg, progress=True)
    np.testing.assert_array_equal(banded, whole)
    err = capsys.readouterr().err
    assert "Scanlines remaining: 0" in err
    assert "10400px x 1spp, depth 3, cpu)" in err


def test_dry_run_text_matches_jax(capsys):
    argv = ["--dry-run", "-w", "300", "-s", "7", "--seed", "4",
            "--static-spheres"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    out = subprocess.run([sys.executable, "-m", "rtow_tpu_torch", *argv],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want


def test_cli_writes_ppm_on_cpu(tmp_path):
    path = tmp_path / "c.ppm"
    argv = ["--device", "cpu", "-w", "24", "-a", "1.5", "-s", "2", "-c", "3",
            "-o", str(path)]
    assert cli.main(argv) == 0
    img = read_ppm(open(path))
    assert img.shape == (16, 24, 3)
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    np.testing.assert_array_equal(
        img, tonemap(render_auto(*scene_for_config(cfg), cfg)))
    assert mk.render_blocks.launches == 0


def test_cli_renders_a_mesh_on_cpu(tmp_path, capsys):
    """``-l`` through K1's plain version (1,920 triangles), with the JAX
    CLI's triangle count on stderr."""
    path = tmp_path / "k.ppm"
    argv = ["--device", "cpu", "-l", os.path.join(ROOT, "samples",
                                                   "knot_small.obj"),
            "-w", "24", "-a", "1", "-s", "2", "-c", "3", "-o", str(path)]
    assert cli.main(argv) == 0
    assert "Scene has 1920 triangles" in capsys.readouterr().err
    img = read_ppm(open(path))
    assert img.shape == (24, 24, 3) and img.std() > 5
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    np.testing.assert_array_equal(
        img, tonemap(render_auto(*scene_for_config(cfg), cfg)))


@pytest.mark.parametrize("flags", [
    ["--globe"], ["-l", os.path.join(ROOT, "samples", "knot_small.obj"),
                  "--backend", "jnp"],
    ["--backend", "jnp"], ["--profile-dir", "trace"],
])
def test_unported_flags_fail_loudly(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--device", "cpu", "-w", "8", "-s", "1", "-o", os.devnull,
                  *flags])


def test_devices_flag_renders_on_one_device(tmp_path):
    """``-t 2`` with fewer than two cards renders on one device, as the
    JAX CLI does (rtow_tpu/pipeline.py:219): here, on the CPU, the same
    PPM as ``-t 1``."""
    out = {}
    for t in ("1", "2"):
        path = tmp_path / f"t{t}.ppm"
        assert cli.main(["--device", "cpu", "-w", "16", "-s", "2", "-c", "3",
                         "-t", t, "-o", str(path)]) == 0
        out[t] = path.read_bytes()
    assert out["1"] == out["2"]


def test_unported_materials_fail_loudly():
    cfg = Config(device="cpu", image_width=8)
    scene, cam = scene_for_config(cfg)
    scene.materials.kind[0] = 6  # IMAGE: the reference integrator's
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_auto(scene, cam, cfg)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-w", "8", "-s", "1", "-o", os.devnull])
    with pytest.raises(RuntimeError, match="cuda"):
        scene_for_config(Config(device="cuda", image_width=8))
