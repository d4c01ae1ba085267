"""The port's gradient path on its own, on the CPU: finite-difference
gates, the train step, and the wrappers' contract.

FD gates (the port of tests/test_pallas_grad.py:23-60's gate): reverse-
mode gradients of a pixel MSE through the plain K4 / K5 against central
differences with common random numbers (the same generator seed and
kernel seed on every evaluation; the counter RNG replays every draw).
Pixels at the centre of the view, ``jitter=False``, spp 32, depth 2.

* Two Lambertian spheres (a red ball on a ground sphere): the ball's
  centre, radius and albedo.
* One metal ball (fuzz 0.3) under the sky: its fuzz, radius and centre.
  Without a ground the reflected rays meet only the sky, a smooth
  function of their direction, so no visibility boundary crosses the
  difference stencil (visibility deltas are not estimated, rtow_tpu/
  diff.py:8-13).

Tolerance: |AD - FD| at most 2% of the larger (measured: 0.3% at worst).
"""
import numpy as np
import pytest
import torch

from rtow_tpu_torch import diff
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import Scene, SceneBuilder
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import megakernel as mk

W = H = 12
SPP = 32
DEPTH = 2
SEED = 11
KW = dict(width=W, height=H, spp=SPP, max_depth=DEPTH, seed=SEED,
          jitter=False)


@pytest.fixture(scope="module")
def view():
    cam = make_camera(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device="cpu")
    rows, cols = np.meshgrid(range(4, 8), range(4, 8), indexing="ij")
    pix = torch.from_numpy((rows * W + cols).ravel())
    return cam, pix, torch.zeros((pix.shape[0], 3))


def _two_lambertians():
    b = SceneBuilder()
    red = b.add_lambertian((0.7, 0.3, 0.3))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, red)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    return b.build(device="cpu")


def _metal_under_sky():
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -1.0), 0.5, b.add_metal((0.8, 0.6, 0.2), 0.3))
    return b.build(device="cpu")


SCENES = {"two_lambertians": _two_lambertians, "metal": _metal_under_sky}


def _loss(scene, cam, pix, target):
    img = grad.render_pixels_kernel(
        scene, cam, torch.Generator().manual_seed(0), pix, **KW)
    return float(torch.mean((img - target) ** 2))


@pytest.mark.parametrize("scene_name,leaf,index,eps", [
    ("two_lambertians", "spheres.center0", (0, 0), 2e-3),
    ("two_lambertians", "spheres.center0", (0, 2), 2e-3),
    ("two_lambertians", "spheres.radius", (0,), 2e-3),
    ("two_lambertians", "materials.albedo", (0, 0), 1e-2),
    ("metal", "materials.fuzz", (0,), 2e-3),
    ("metal", "spheres.radius", (0,), 2e-3),
    ("metal", "spheres.center0", (0, 1), 2e-3),
])
def test_kernel_grad_matches_fd(view, scene_name, leaf, index, eps):
    cam, pix, target = view
    scene = SCENES[scene_name]()
    loss, grads = grad.loss_and_grad_kernel(
        scene, cam, torch.Generator().manual_seed(0), target, pix, **KW)
    assert np.isfinite(float(loss))
    ad = float(grads.leaves()[leaf][index])

    def loss_at(v):
        t = scene.leaves()[leaf].clone()
        t[index] += v
        return _loss(scene.replace_leaves({leaf: t}), cam, pix, target)

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert fd != 0.0
    assert abs(ad - fd) <= 0.02 * max(abs(fd), abs(ad)), (leaf, ad, fd)


def test_gradients_are_finite_and_integer_leaves_none(view):
    cam, pix, target = view
    _, grads = grad.loss_and_grad_kernel(
        _two_lambertians(), cam, torch.Generator().manual_seed(0), target,
        pix, **KW)
    for key, g in grads.leaves().items():
        if key.endswith(("material", "kind")):
            assert g is None, key
        else:
            assert bool(torch.isfinite(g).all()), key
    assert not grads.materials.albedo2.any()  # no checker: unread


# ---------------------------------------------------------------------------
# The train step


def test_train_step_lowers_the_loss(view):
    """Three steps on perturbed albedos, with common random numbers each
    step: the loss falls and the albedos move toward the truth (chip_smoke
    runs the same on the cover at full size)."""
    cam = view[0]
    scene = _two_lambertians()
    kw = dict(width=W, height=H, spp=4, max_depth=DEPTH)
    target = grad.render_pixels_kernel(scene, cam,
                                       torch.Generator().manual_seed(9),
                                       torch.arange(W * H), **kw)
    noise = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.15, 0.15, scene.materials.albedo.shape).astype(np.float32))
    start = scene.replace_leaves({
        "materials.albedo": (scene.materials.albedo + noise).clamp(0, 1)})
    step = diff.build_train_step(cam, lr=1.0,
                                 keep=lambda p: p.endswith("albedo"), **kw)
    cur, losses = start, []
    for _ in range(3):
        cur, loss = step(cur, torch.Generator().manual_seed(7), target)
        losses.append(float(loss))
    assert losses[0] > losses[1] > losses[2]

    def error(s):
        return float((s.materials.albedo - scene.materials.albedo).abs()
                     .mean())

    assert error(cur) < error(start)
    # The mask kept every other leaf still.
    assert torch.equal(cur.spheres.center0, start.spheres.center0)
    assert torch.equal(cur.materials.fuzz, start.materials.fuzz)


def test_sgd_update_and_mask_grads():
    scene = _two_lambertians()
    grads = scene.replace_leaves({
        k: (torch.ones_like(v) if v.is_floating_point() else None)
        for k, v in scene.leaves().items()})
    masked = diff.mask_grads(grads, lambda p: p.endswith("radius"))
    assert bool((masked.spheres.radius == 1).all())
    assert not masked.materials.albedo.any()
    assert masked.spheres.material is None
    new = diff.sgd_update(scene, masked, 0.5)
    np.testing.assert_array_equal(new.spheres.radius.numpy(),
                                  scene.spheres.radius.numpy() - 0.5)
    assert torch.equal(new.materials.albedo, scene.materials.albedo)
    assert torch.equal(new.spheres.material, scene.spheres.material)


def test_scene_to_numpy_round_trips():
    scene = _two_lambertians()
    back = Scene.from_numpy(scene.to_numpy(), "cpu")
    for key, value in scene.to_numpy().items():
        np.testing.assert_array_equal(back.to_numpy()[key], value)


# ---------------------------------------------------------------------------
# The wrappers' contract


def _relabel(scene, kinds):
    """``scene`` with the kinds of some materials changed ({material:
    kind}), its metadata (emitters, textures) derived anew."""
    arrays = {k: v.copy() for k, v in scene.to_numpy().items()}
    for m, kind in kinds.items():
        arrays["materials.kind"][m] = kind
    if 6 in kinds.values():  # IMAGE: the metadata cannot be derived
        k = scene.materials.kind.clone()
        for m, kind in kinds.items():
            k[m] = kind
        return scene.replace_leaves({"materials.kind": k})
    return Scene.from_numpy(arrays, "cpu", scene.background)


def test_unported_arguments_raise(view):
    """nee=True without an emitter is a ValueError (pallas_grad.py:
    888-892), the sharded step's argument is not ported; emissive,
    checker and noise materials render (the lit slice), image textures
    raise, and so does nothing on an emissive mesh."""
    cam, pix, _ = view
    scene = _two_lambertians()
    kw = dict(width=W, height=H, spp=1, max_depth=1)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="emissive"):
        grad.render_pixels_kernel(scene, cam, gen, pix, nee=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        grad.render_pixels_kernel(scene, cam, gen, pix,
                                  grad_reduce_axes=("spp",), **kw)
    for kind in (3, 4, 5, 6):  # emissive, checker, noise, image
        lit = _relabel(scene, {0: kind})
        if kind == 6:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                grad.render_pixels_kernel(lit, cam, gen, pix, **kw)
            continue
        loss, grads = grad.loss_and_grad_kernel(
            lit, cam, gen, torch.zeros((pix.shape[0], 3)), pix,
            nee=kind == 3, **kw)
        assert np.isfinite(float(loss))
        assert bool(torch.isfinite(grads.materials.albedo).all())
    # A mesh is in the kernels, and so is an emissive one.
    tris = _relabel(scene.replace_leaves({
        "triangles.verts": torch.ones((1, 3, 3)),
        "triangles.material": torch.ones((1,), dtype=torch.int32)}), {1: 3})
    img = grad.render_pixels_kernel(tris, cam, gen, pix, nee=True, **kw)
    assert bool(torch.isfinite(img).all())


def test_sorted_lanes_on_spheres_match_unsorted(view):
    """Sphere scenes take ``sort_lanes=True`` too (as in
    tests/test_pallas_grad.py:377): the same loss within rel 1e-6 and
    gradients within rtol 2e-4, atol 1e-6 (sums in another lane order)."""
    cam, pix, target = view
    out = {s: grad.loss_and_grad_kernel(
        _two_lambertians(), cam, torch.Generator().manual_seed(0), target,
        pix, width=W, height=H, spp=4, max_depth=DEPTH, sort_lanes=s)
        for s in (False, True)}
    assert float(out[True][0]) == pytest.approx(float(out[False][0]),
                                                 rel=1e-6)
    for key, g in out[False][1].leaves().items():
        if g is not None:
            np.testing.assert_allclose(g.numpy(),
                                       out[True][1].leaves()[key].numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=key)


def test_wrappers_on_cpu_count_no_launch(view):
    cam, pix, target = view
    before = (grad.bounce_fwd.launches, grad.bounce_bwd.launches)
    grad.loss_and_grad_kernel(_two_lambertians(), cam,
                              torch.Generator().manual_seed(0), target, pix,
                              width=W, height=H, spp=1, max_depth=1)
    assert (grad.bounce_fwd.launches, grad.bounce_bwd.launches) == before \
        == (0, 0)


def test_wrappers_reject_other_devices_and_bad_inputs():
    tbl, _ = mk.build_sphere_table(_two_lambertians())
    n = mk.TILE
    cont = torch.zeros((13, n))
    ints = torch.zeros((3, n), dtype=torch.int32)
    kw = dict(it=0, seed=0, max_depth=1)
    with pytest.raises(ValueError, match="no grad_fwd kernel"):
        grad.bounce_fwd(cont.to("meta"), ints.to("meta"), tbl.to("meta"),
                        **kw)
    with pytest.raises(ValueError, match="no grad_bwd kernel"):
        grad.bounce_bwd(cont.to("meta"), ints.to("meta"), cont.to("meta"),
                        tbl.to("meta"), **kw)
    with pytest.raises(ValueError, match="cont"):
        grad.bounce_fwd(cont[:12].contiguous(), ints, tbl, **kw)
    with pytest.raises(ValueError, match="ints"):
        grad.bounce_fwd(cont, ints.float(), tbl, **kw)
    with pytest.raises(ValueError, match="cot_out"):
        grad.bounce_bwd(cont, ints, cont[:, :8].contiguous(), tbl, **kw)
    with pytest.raises(ValueError, match="sphere table"):
        grad.bounce_fwd(cont, ints, tbl[:, :8].contiguous(), **kw)
    with pytest.raises(ValueError, match="int32"):
        grad.bounce_fwd(cont, ints, tbl, it=0, seed=2**31, max_depth=1)
