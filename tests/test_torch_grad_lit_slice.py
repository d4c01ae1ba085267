"""The port's lit inverse-rendering slice against rtow_tpu's on the CPU:
``render_pixels_kernel(nee=True)`` and ``loss_and_grad_kernel`` at 8x8
pixels, spp 4, depth 3, on ``light_scene`` (sphere lights) and
``cornell_scene`` (a triangle lamp), from rays made by JAX's own
``pixel_coords`` / ``camera_rays`` (tests/test_torch_grad_lit_fd.py holds
the sorted lanes with NEE against the unsorted ones).

The JAX side runs its Pallas kernels K4 / K5 under
``pltpu.force_tpu_interpret_mode()`` with the classic scheduler
(``tests/conftest.py``); the port side runs the plain versions of its
kernels.  Bounds, as in tests/test_torch_grad_mesh.py: 97% of pixels
within 1e-4 and mean |d| at most 5e-3; the loss within rel 1e-4 (each
side's target is its own pixel where a lane took another path); every
gradient leaf within 2e-2 of its 2-norm and, entry by entry among the
entries non-zero on either side, 98% within 1e-5 + 1e-2 |want|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.models import builders as jax_builders
from rtow_tpu.models.camera import camera_rays as jax_camera_rays
from rtow_tpu.models.camera import pixel_coords as jax_pixel_coords
from rtow_tpu.ops import pallas_grad as jgrad
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import Rays
from rtow_tpu_torch.ops import grad

W = H = 8
SPP, DEPTH, SEED = 4, 3, 4
LEAVES = ("spheres.center0", "spheres.radius", "triangles.verts",
          "materials.albedo")

SCENES = {
    "light": (jax_builders.light_scene,
              lambda: builders.light_scene(1.0, device="cpu")),
    "cornell": (jax_builders.cornell_scene,
                lambda: builders.cornell_scene(1.0, device="cpu")),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_slice_matches_render_and_loss_and_grad_kernel(name):
    jbuild, build = SCENES[name]
    jscene, jcam = jbuild(1.0)
    scene, _ = build()
    pix = np.arange(W * H, dtype=np.int32)
    key = jax.random.key(3)
    lane_pix = jnp.repeat(jnp.asarray(pix), SPP)
    k_pix, k_cam = jax.random.split(key)
    s, t = jax_pixel_coords(W, H, k_pix, lane_pix)
    jrays = jax_camera_rays(jcam, k_cam, s, t)
    rays = Rays(np.asarray(jrays.origin), np.asarray(jrays.direction),
                np.asarray(jrays.time))
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH, seed=SEED,
              nee=True)

    def render(s_):
        return grad.render_rays_kernel(s_, rays, n_pixels=pix.size, spp=SPP,
                                       max_depth=DEPTH, seed=SEED, nee=True)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(functools.partial(
            jgrad.render_pixels_kernel, **kw))(jscene, jcam, key,
                                               jnp.asarray(pix)))
    got = render(scene).numpy()
    flipped = np.abs(got - want).max(axis=1) > 1e-4
    assert np.mean(~flipped) >= 0.97
    assert np.abs(got - want).mean() <= 5e-3
    assert got.max() > 0.05  # lit

    target = np.full((pix.size, 3), 0.3, np.float32)
    jtarget = target.copy()
    target[flipped] = got[flipped]
    jtarget[flipped] = want[flipped]
    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jgrad.loss_and_grad_kernel(
            jscene, jcam, key, jnp.asarray(jtarget), jnp.asarray(pix), **kw)
    loss, grads = grad.scene_value_and_grad(
        lambda s_: torch.mean((render(s_) - torch.from_numpy(target)) ** 2),
        scene)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)

    got_g = grads.to_numpy()
    for leaf in LEAVES:
        part, field = leaf.split(".")
        want_g = np.asarray(getattr(getattr(jgrads, part), field))
        g = got_g[leaf]
        assert g.shape == want_g.shape, leaf
        err = np.linalg.norm(g - want_g)
        assert err <= 2e-2 * np.linalg.norm(want_g) + 1e-12, (leaf, err)
        nz = (g != 0) | (want_g != 0)
        ok = np.abs(g - want_g) <= 1e-5 + 1e-2 * np.abs(want_g)
        if nz.any():
            assert ok[nz].mean() >= 0.98, (leaf, ok[nz].mean())
    # The lamps' emission (albedo rows of the emissive materials) got a
    # gradient from the light rows and the emission hits.
    emissive = scene.materials.kind.numpy() == 3
    assert np.abs(got_g["materials.albedo"][emissive]).max() > 0
