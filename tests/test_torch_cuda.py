"""The CUDA kernels against their plain PyTorch versions, on the card:
the megakernel K1 (ops/megakernel.py) and the gradient bounces K4 / K5
(ops/grad.py).

Marked ``cuda``: each test skips (with its reason) where
``torch.cuda.is_available()`` is false.  This file imports neither JAX
nor rtow_tpu, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, as in chip_smoke.py: both versions round every float32
operation alike (the kernel is built with -fmad=false, IEEE division and
sqrt) and use the same CUDA math library; at most 1% of pixels may be
off by more than 1e-4 of mean radiance (a last-bit difference can flip
a discrete choice), with mean |difference| at most 1e-3.  K4 is
bit-identical to its plain version.  K5 sums its adjoint in another order
than autograd and the table gradient with atomics: per cot_in row and per
g_tbl column, max |d| at most 1e-3 of the largest |plain|.
"""
import numpy as np
import pytest
import torch

from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import cover_scene, three_sphere_scene
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.camera import camera_rays, pixel_coords
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import grad
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


def _grad_tape(dev, depth=8):
    """The cover at 64x64, spp 2: the (depth + 1) input states of one
    forward through K4, and the table."""
    scene, cam = cover_scene(Config(image_width=64, aspect_ratio=1.0),
                             device=dev)
    tbl, _ = mk.build_sphere_table(scene)
    gen = torch.Generator(dev).manual_seed(2)
    pix = torch.arange(64 * 64, device=dev).repeat_interleave(2)
    s, t = pixel_coords(64, 64, gen, pix)
    cont, ints = grad.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
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
        kci, kg = grad.bounce_bwd(cont, ints, cot, tbl, **kw)
        assert grad.bounce_bwd.launches == before + 1
        pci, pg = grad.bounce_bwd_reference(cont, ints, cot, tbl, **kw)
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
