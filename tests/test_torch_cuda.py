"""The CUDA megakernel against its plain PyTorch version, on the card.

Marked ``cuda``: each test skips (with its reason) where
``torch.cuda.is_available()`` is false.  This file imports neither JAX
nor rtow_tpu, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, as in chip_smoke.py: both versions round every float32
operation alike (the kernel is built with -fmad=false, IEEE division and
sqrt) and use the same CUDA math library; at most 1% of pixels may be
off by more than 1e-4 of mean radiance (a last-bit difference can flip
a discrete choice), with mean |difference| at most 1e-3.
"""
import pytest
import torch

from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import cover_scene, three_sphere_scene
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import megakernel as mk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _frames(scene, cam, width, height, spp, depth):
    tbl, _ = mk.build_sphere_table(scene)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(1, width=width, height=height, spp=spp,
                         max_depth=depth),
            mk.n_tiles_for(width, height))
    before = mk.render_blocks.launches
    kern = mk.render_blocks(*args, background=scene.background)
    assert mk.render_blocks.launches == before + 1
    plain = mk.render_blocks_reference(*args, background=scene.background)
    assert mk.render_blocks.launches == before + 1
    torch.cuda.synchronize()
    return (mk.unblock_image(*kern, width=width, height=height) / spp,
            mk.unblock_image(*plain, width=width, height=height) / spp)


@pytest.mark.parametrize("name", ["three_sphere", "cover"])
def test_kernel_matches_plain_on_card(dev, name):
    if name == "cover":
        scene, cam = cover_scene(Config(image_width=200,
                                        aspect_ratio=16 / 9), device=dev)
    else:
        scene, cam = three_sphere_scene(16 / 9, device=dev)
    kern, plain = _frames(scene, cam, 200, 112, 4, 50)
    assert bool(torch.isfinite(kern).all())
    d = (kern - plain).abs().amax(dim=1)
    assert float((d > 1e-4).float().mean()) <= 0.01
    assert float((kern - plain).abs().mean()) <= 1e-3


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


def test_table_larger_than_shared_memory_raises(dev):
    tbl = torch.zeros((4 * 1024, 16), dtype=torch.float32, device=dev)
    cam = torch.zeros(21, dtype=torch.float32, device=dev)
    meta = mk.pack_meta(0, width=8, height=8, spp=1, max_depth=1)
    with pytest.raises(ValueError, match="shared-memory"):
        mk.render_blocks(tbl, cam, meta, 1)
