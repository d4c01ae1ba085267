"""The port's gradient path on lit scenes, on its own, on the CPU: the
finite-difference gates of tests/test_pallas_grad_nee.py, run through the
plain K4 / K5 with their lit features, and the same gates for the noise
texture.

Each gate: the reverse-mode gradient of a pixel MSE against central
differences with common random numbers (the same generator seed and
kernel seed on every evaluation; the counter RNG replays every draw, the
light sample and the shadow ray's visibility), within 5% of the larger,
as JAX's gates are held.  Pixels at the centre of the view,
``jitter=False``.

* JAX's NEE scene (a red ball on a ground sphere under a small sphere
  light, black background) at 12x12, 3x3 pixels, spp 8, depth 3, NEE on:
  the ball's albedo, the lamp's emission, the lamp's radius and centre
  height (the cone sample's reparameterisation carries them back through
  the light rows and the sphere table), and every gradient finite.
* The Cornell box with NEE: the triangle lamp's emission, which reaches
  the loss through the triangle table (a camera ray's emission hit) and
  the light rows (the area sample) together.
* ``textures_scene``: the marble sphere's two colours and its noise
  scale, through the noise's derivative in the hit point and the scale.
* Sorted lanes with NEE match unsorted ones (tests/test_pallas_grad.py:
  377) on ``light_scene`` and the Cornell box at 8x8, spp 4, depth 3.
* ``nee=True`` without an emitter raises ValueError; image textures
  still raise NotImplementedError naming their ROADMAP item; a scene with
  media renders.
"""
import numpy as np
import pytest
import torch

from rtow_tpu_torch.models.builders import (
    cornell_scene, light_scene, textures_scene,
)
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import grad

W = H = 12
SPP, DEPTH, SEED = 8, 3, 4
FD_TOL = 0.05


@pytest.fixture(scope="module")
def nee_setup():
    """tests/test_pallas_grad_nee.py:33-53: the diffuse ball and floor lit
    by a small overhead sphere light, black background."""
    cam = make_camera(lookfrom=(0.0, 0.6, 1.6), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=55.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, t0=0.0, t1=0.0, device="cpu")
    b = SceneBuilder()
    red = b.add_lambertian((0.7, 0.3, 0.3))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    lamp = b.add_light((6.0, 5.0, 4.0))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, red)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.8, 2.2, -0.6), 0.35, lamp)
    scene = b.build(background=(0.0, 0.0, 0.0), device="cpu")
    rows, cols = np.meshgrid(range(5, 8), range(5, 8), indexing="ij")
    pix = torch.from_numpy((rows * W + cols).ravel())
    return scene, cam, pix, lamp


def _loss_fn(cam, pix, *, nee, spp=SPP, depth=DEPTH):
    target = torch.zeros((pix.shape[0], 3))

    def loss(scene):
        img = grad.render_pixels_kernel(
            scene, cam, torch.Generator().manual_seed(11), pix, width=W,
            height=H, spp=spp, max_depth=depth, seed=SEED, jitter=False,
            nee=nee)
        return torch.mean((img - target) ** 2)

    return loss


def _fd_gate(loss, scene, leaf, index, eps):
    value, grads = grad.scene_value_and_grad(loss, scene)
    assert np.isfinite(float(value))
    ad = float(grads.leaves()[leaf][index])

    def at(v):
        t = scene.leaves()[leaf].clone()
        t[index] += v
        return float(loss(scene.replace_leaves({leaf: t})))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    assert fd != 0.0, f"{leaf}: the FD gate is degenerate"
    assert abs(ad - fd) <= FD_TOL * max(abs(fd), abs(ad), 1e-6), (leaf, ad,
                                                                   fd)
    return grads


@pytest.mark.parametrize("which", ["albedo", "emit", "radius", "center_y"])
def test_nee_grad_matches_fd(nee_setup, which):
    """tests/test_pallas_grad_nee.py:90-144: material and emission
    (eps 1e-2), light radius and centre height (eps 1e-3)."""
    scene, cam, pix, lamp = nee_setup
    loss = _loss_fn(cam, pix, nee=True)
    leaf, index, eps = {
        "albedo": ("materials.albedo", (0, 0), 1e-2),
        "emit": ("materials.albedo", (lamp, 0), 1e-2),
        "radius": ("spheres.radius", (2,), 1e-3),
        "center_y": ("spheres.center0", (2, 1), 1e-3)}[which]
    _fd_gate(loss, scene, leaf, index, eps)


def test_nee_grads_finite_everywhere(nee_setup):
    scene, cam, pix, _ = nee_setup
    _, grads = grad.scene_value_and_grad(_loss_fn(cam, pix, nee=True), scene)
    for key, g in grads.leaves().items():
        assert g is None or bool(torch.isfinite(g).all()), key
    # The lamp's geometry gets a gradient from the light rows.
    assert float(grads.spheres.radius[2].abs()) > 0


def test_cornell_triangle_lamp_grad_matches_fd():
    """tests/test_pallas_grad_nee.py:157-188: the lamp is two triangles;
    its emission reaches the loss through the triangle table and the light
    rows, and both must agree with FD (eps 0.1)."""
    scene, cam = cornell_scene(1.0, device="cpu")
    pix = torch.tensor([6 * W + 5, 6 * W + 6, 5 * W + 6])
    lamp = int(torch.argmax(scene.materials.albedo.sum(dim=1)))
    _fd_gate(_loss_fn(cam, pix, nee=True), scene, "materials.albedo",
             (lamp, 0), 1e-1)


@pytest.mark.parametrize("leaf,index,eps", [
    ("materials.albedo", (1, 0), 1e-2),
    ("materials.albedo2", (1, 1), 1e-2),
    ("materials.ir", (1,), 1e-3),
])
def test_noise_grad_matches_fd(leaf, index, eps):
    """The marble sphere of ``textures_scene`` (material 1): its colours
    and its noise scale (the ir column).  The scale's derivative runs
    through the marble weight's sine and the value noise's smoothstep in
    the hit point."""
    scene, cam = textures_scene(1.0, device="cpu")
    rows, cols = np.meshgrid(range(5, 8), range(3, 6), indexing="ij")
    pix = torch.from_numpy((rows * W + cols).ravel())
    assert int(scene.materials.kind[1]) == 5  # NOISE
    grads = _fd_gate(_loss_fn(cam, pix, nee=False, depth=2), scene, leaf,
                     index, eps)
    assert float(grads.materials.albedo2[0].abs().max()) > 0  # the checker


def test_lit_scene_contract():
    """nee=True needs an emitter (ValueError, as pallas_grad.py:888-892);
    image textures are not in the kernels yet; media are."""
    cam = make_camera(lookfrom=(0, 1, 4), lookat=(0, 1, 0), fov_degrees=40,
                      aspect_ratio=1.0, aperture=0.0, focus_dist=4.0,
                      device="cpu")
    kw = dict(width=8, height=8, spp=1, max_depth=1)
    b = SceneBuilder()
    b.add_sphere((0, -100, 0), 100.0, b.add_lambertian((0.5,) * 3))
    dark = b.build(device="cpu")
    with pytest.raises(ValueError, match="emissive"):
        grad.render_pixels_kernel(dark, cam, torch.Generator(), [0, 1],
                                  nee=True, **kw)
    b.add_fog_sphere((0, 1, 0), 0.5, 1.0)
    img = grad.render_pixels_kernel(b.build(device="cpu"), cam,
                                    torch.Generator(), [0, 1], **kw)
    assert img.shape == (2, 3) and bool(torch.isfinite(img).all())
    kinds = dark.materials.kind.clone()
    kinds[0] = 6  # IMAGE
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        grad.render_pixels_kernel(
            dark.replace_leaves({"materials.kind": kinds}), cam,
            torch.Generator(), [0, 1], **kw)


@pytest.mark.parametrize("build", [light_scene, cornell_scene])
def test_sorted_lanes_with_nee_match_unsorted(build):
    """tests/test_pallas_grad.py:377 with NEE: the same loss within rel
    1e-6 and gradients within rtol 2e-4, atol 1e-6 (the sums run in
    another lane order)."""
    scene, cam = build(1.0, device="cpu")
    w = h = 8
    pix = torch.arange(w * h)
    out = {s: grad.loss_and_grad_kernel(
        scene, cam, torch.Generator().manual_seed(0), torch.zeros(w * h, 3),
        pix, width=w, height=h, spp=4, max_depth=DEPTH, nee=True,
        sort_lanes=s) for s in (False, True)}
    assert float(out[True][0]) == pytest.approx(float(out[False][0]),
                                                 rel=1e-6)
    for key, g in out[False][1].leaves().items():
        if g is not None:
            np.testing.assert_allclose(g.numpy(),
                                       out[True][1].leaves()[key].numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=key)
