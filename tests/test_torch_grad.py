"""The port's gradient path (ops/grad.py) against rtow_tpu's kernel
gradient path (ops/pallas_grad.py) on the CPU.

The JAX side runs its Pallas bounce kernels K4 / K5 under
``pltpu.force_tpu_interpret_mode()``; the port side runs its kernels'
plain PyTorch versions (the CUDA kernels need a card:
``tests/test_torch_cuda.py`` holds them against these plain versions
there).  Both draw the same counter-hash random numbers lane by lane, so
lanes are compared one by one:

* one bounce, on random lane states (numpy seed) and the cover's table:
  the forward against ``bounce_grad``, the input and table cotangents
  against ``jax.vjp`` of it;
* the slice on the cover at one tile (8x128 pixels, spp 1, depth 2 and
  8), from rays built by JAX's own ``pixel_coords`` / ``camera_rays``:
  pixels against ``render_pixels_kernel``, every gradient leaf against
  ``loss_and_grad_kernel``.

Tolerances.  XLA's CPU code and PyTorch's round a few float32 operations
differently (multiply-add contraction, sin/cos in the last bit).  The
re-derived intersection t magnifies a last-bit difference where the
quadratic cancels (a long ray to a small sphere, or |oc|^2 - r^2 on the
r = 1000 ground sphere), and over several bounces a last-bit difference
can flip a discrete choice, so a few lanes take another path
(tests/test_torch_megakernel.py explains the same for the render).
Each test states its bounds beside the check.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models import builders as jax_builders
from rtow_tpu.models.camera import camera_rays as jax_camera_rays
from rtow_tpu.models.camera import pixel_coords as jax_pixel_coords
from rtow_tpu.ops import pallas_grad as jgrad
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import Rays
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import megakernel as mk

W, H = 128, 72  # the cover's camera; the tile is rows 30-37 (horizon)
LEAVES = ("spheres.center0", "spheres.dcenter", "spheres.radius",
          "materials.albedo", "materials.fuzz", "materials.ir",
          "materials.albedo2")


@pytest.fixture(scope="module")
def covers():
    kw = dict(seed=0, moving_spheres=True, image_width=W,
              aspect_ratio=16.0 / 9.0)
    return (jax_builders.cover_scene(JaxConfig(**kw)),
            builders.cover_scene(Config(device="cpu", **kw)))


# ---------------------------------------------------------------------------
# One bounce, lane by lane


def _random_lanes(n, seed):
    """Lane states around the ball field: 90% alive, bounce counts 0-3,
    unnormalised directions, throughput and radiance in range."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-11, 11, n), rng.uniform(0.05, 3.0, n),
                  rng.uniform(-11, 11, n)])
    d = rng.standard_normal((3, n))
    d[1] -= 0.3
    cont = np.concatenate([
        o, d, rng.uniform(0, 1, (1, n)), rng.uniform(0.1, 1, (3, n)),
        rng.uniform(0, 2, (3, n))]).astype(np.float32)
    ints = np.stack([(rng.uniform(size=n) < 0.9),
                     rng.integers(0, 4, n),
                     np.arange(n)]).astype(np.int32)
    cot = rng.standard_normal((13, n)).astype(np.float32)
    return cont, ints, cot


@pytest.mark.parametrize("background", ["sky", (0.2, 0.3, 0.4)])
def test_one_bounce_matches_bounce_grad_and_its_vjp(covers, background):
    (jscene, _), (scene, _) = covers
    jtbl, jboxes = jmk.build_sphere_table(jscene)
    tbl, _ = mk.build_sphere_table(scene)
    n = mk.TILE
    cont, ints, cot = _random_lanes(n, seed=5)
    it, seed, depth = 2, 11, 3
    bg = None if background == "sky" else background
    statics = (tbl.shape[0] // mk.SPHERE_BLOCK, 0, 0, 0, True, False, bg,
               False, (), (), 0)
    z = lambda *shape: jnp.zeros(shape, jnp.float32)  # noqa: E731

    def jax_bounce(c, t):
        return jgrad.bounce_grad(
            tuple(c), tuple(jnp.asarray(ints)), t, jboxes,
            z(jmk.TRI_BLOCK, 16), z(1, 8), z(1, 8), z(1, 8), z(1, 14),
            statics, (jnp.int32(it), jnp.int32(seed), jnp.int32(depth)))

    with pltpu.force_tpu_interpret_mode():
        (jc, ji), vjp = jax.vjp(jax_bounce, jnp.asarray(cont), jtbl)
        f0 = tuple(np.zeros((n,), jax.dtypes.float0) for _ in range(3))
        jcot, jgtbl = vjp((tuple(jnp.asarray(cot)), f0))
    jc, ji = np.stack(jc), np.stack(ji)
    jcot, jgtbl = np.asarray(jcot), np.asarray(jgtbl)

    kw = dict(it=it, seed=seed, max_depth=depth, background=background)
    c_t, i_t = torch.from_numpy(cont), torch.from_numpy(ints)
    pc, pi = grad.bounce_fwd(c_t, i_t, tbl, **kw)
    pcot, pgtbl, pgtri, prows = grad.bounce_bwd(
        c_t, i_t, torch.from_numpy(cot), tbl, **kw)
    assert pgtri is None and prows is None  # no triangles, no light rows

    # Forward: the discrete state is equal; the floats differ by last bits
    # magnified in the re-derived t (every lane within 5e-3, 80% of lanes
    # within 1e-5; measured: 2e-3 worst, 89% within 1e-5).
    np.testing.assert_array_equal(pi.numpy(), ji)
    d = np.abs(pc.numpy() - jc).max(axis=0)
    assert d.max() <= 5e-3
    assert np.mean(d <= 1e-5) >= 0.8
    # Cotangents: per row (input cotangent) and per column (table
    # cotangent), max |d| within 1e-2 of the largest |value| (measured
    # 2.6e-3 worst); 98% of lanes within 1e-5 of it (measured 98.9%).
    scale = np.abs(jcot).max(axis=1, keepdims=True)
    d = np.abs(pcot.numpy() - jcot)
    assert (d <= 1e-2 * scale).all()
    assert np.mean((d <= 1e-5 * scale).all(axis=0)) >= 0.98
    gscale = np.abs(jgtbl).max(axis=0)
    assert (np.abs(pgtbl.numpy() - jgtbl) <= 1e-2 * gscale + 1e-12).all()
    # The kind column and the texture columns carry no cotangent.
    assert not pgtbl.numpy()[:, 12:].any() and not jgtbl[:, 12:].any()


# ---------------------------------------------------------------------------
# The slice at one tile


@pytest.mark.parametrize("depth,pass_share,rel_norm",
                         [(2, 0.99, 1e-2), (8, 0.97, 5e-2)])
def test_slice_matches_render_and_loss_and_grad_kernel(covers, depth,
                                                       pass_share, rel_norm):
    (jscene, jcam), (scene, _) = covers
    pix = np.arange(30 * W, 38 * W, dtype=np.int32)
    spp, seed = 1, 4
    key = jax.random.key(3)
    # The rays of pallas_grad.py:920-929, handed to the port as numpy.
    lane_pix = jnp.repeat(jnp.asarray(pix), spp)
    k_pix, k_cam = jax.random.split(key)
    s, t = jax_pixel_coords(W, H, k_pix, lane_pix)
    jrays = jax_camera_rays(jcam, k_cam, s, t)
    rays = Rays(np.asarray(jrays.origin), np.asarray(jrays.direction),
                np.asarray(jrays.time))
    kw = dict(width=W, height=H, spp=spp, max_depth=depth, seed=seed)

    def render(s_):
        return grad.render_rays_kernel(s_, rays, n_pixels=pix.size, spp=spp,
                                       max_depth=depth, seed=seed)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgrad.render_pixels_kernel(
            jscene, jcam, key, jnp.asarray(pix), **kw))
    got = render(scene).numpy()

    # Pixels: 97% within 1e-4, mean |d| at most 5e-3 (measured: 0.7% and
    # 1.9% of pixels took another path at depth 2 and 8, mean |d| 4.5e-4).
    flipped = np.abs(got - want).max(axis=1) > 1e-4
    assert np.mean(~flipped) >= 0.97
    assert np.abs(got - want).mean() <= 5e-3

    # The loss targets 0.3 everywhere except on the pixels whose lane took
    # another path: there each side's target is its own pixel, so those
    # lanes send no cotangent back on either side.  A flipped lane near a
    # grazing hit can carry a gradient entry larger than the whole rest of
    # its leaf (measured at depth 8: 0.42 against 0.011), which would hide
    # any other disagreement.
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

    # Gradient leaves, each as a whole: |got - want| <= rel_norm |want| in
    # the 2-norm (measured: 3.3e-3 at depth 2, 1.8e-2 at depth 8, both on
    # the geometry leaves, whose re-derived t magnifies last bits).  Entry
    # by entry, among the entries that are non-zero on either side, a
    # share ``pass_share`` agrees within 1e-5 + 1e-2 |want| (measured:
    # all at depth 2, 98.3% at depth 8).  Sparse leaves such as ir and
    # fuzz (2 to 21 non-zero entries here) are held by both checks.
    got_g = grads.to_numpy()
    for leaf in LEAVES:
        part, name = leaf.split(".")
        want_g = np.asarray(getattr(getattr(jgrads, part), name))
        g = got_g[leaf]
        assert g.shape == want_g.shape, leaf
        err = np.linalg.norm(g - want_g)
        assert err <= rel_norm * np.linalg.norm(want_g), (leaf, err)
        nz = (g != 0) | (want_g != 0)
        ok = np.abs(g - want_g) <= 1e-5 + 1e-2 * np.abs(want_g)
        if nz.any():
            assert ok[nz].mean() >= pass_share, (leaf, ok[nz].mean())
    assert set(got_g) == set(LEAVES) | {"triangles.verts"}
