"""The port's gradient path through constant-density media (ops/grad.py
with the volume rows) against rtow_tpu's kernel gradient path
(ops/pallas_grad.py), and its finite-difference gates, on the CPU.

The JAX side runs its Pallas bounce kernels K4 / K5 under
``pltpu.force_tpu_interpret_mode()`` with the classic scheduler
(``tests/conftest.py``), with the statics ``render_pixels_kernel``
derives (:887-913): the volume rows packed behind the light rows,
``vol_row0`` = the light count under NEE and 0 without.  The port side
runs its kernels' plain PyTorch versions (``tests/test_torch_cuda.py``
and ``tests/test_torch_lanes_host.py`` hold the CUDA code against them).

Scenes, each built by both packages at the sizes of
``tests/test_pallas_grad_volumes.py`` (10x10, spp 8, depth 3): its
fog-ball-plus-sphere-light scene (``fog_light_setup``, black
background); the same light over three media side by side, a fog ball
("s"), an unrotated fog box ("b") and a rotated, translated one ("r");
its sky-lit fog ball (``fog_setup``); and its fog-miss scene.

* One bounce on the three media, with and without NEE (the second
  bounce of one plain forward, so the alive code 2 and volume scatters
  from the first appear), lane by lane, with standard-normal output
  cotangents (numpy seed): ints equal; floats within 5e-3 and 80% of
  lanes within 1e-5; the input cotangents per row, ``g_tbl`` and
  ``g_rows`` (the light row and the volume rows) per column within 1e-2
  of the largest |value| (plus 1e-12), 98% of lanes' cotangents within
  1e-5 of it; every volume row's density, albedo and boundary columns
  non-zero.  XLA's CPU code and PyTorch's round a few float32 operations
  differently (log, sin, cos, multiply-add contraction), so a few lanes
  may take another path.
* The 4x4-pixel slice of ``fog_light_setup`` with NEE, from JAX's own
  rays (``jitter=False``), the loss the mean square of the image: every
  pixel within 1e-4 (none takes another path, so the gradients compare
  whole), the loss within rel 1e-4, every ``volumes.*`` and
  ``materials.albedo`` gradient within 2e-2 of its 2-norm.
* The FD gates of ``tests/test_pallas_grad_volumes.py`` on the port
  alone, each as JAX holds it: AD within 5% of central FD under common
  random numbers for the medium albedo (sky-lit ball, eps 1e-2) and for
  density, medium albedo (eps 1e-2), radius and centre height (eps 1e-3)
  with NEE; the sky-lit density AD within 1e-4 of FD (the event bit is
  piecewise constant); every gradient finite on the fog-miss scene.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.models.camera import camera_rays as jax_camera_rays
from rtow_tpu.models.camera import make_camera as jax_make_camera
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import lights as jlights
from rtow_tpu.ops import pallas_grad as jgrad
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu.ops import volumes as jvolumes
from rtow_tpu_torch.models.camera import Rays, camera_rays, make_camera
from rtow_tpu_torch.models.camera import pixel_coords
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import bounce as bn
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import tables as tb

W = H = 10
SPP, DEPTH, SEED, IT = 8, 3, 6, 1
FD_TOL = 0.05
CAM = dict(lookfrom=(0.0, 0.5, 1.8), lookat=(0.0, 0.3, -1.0),
           fov_degrees=55.0, aspect_ratio=1.0, aperture=0.0, focus_dist=1.0,
           t0=0.0, t1=0.0)
ALBEDO = (0.8, 0.7, 0.6)


def fog_scene(builder_cls, kinds="s", light=True, **build_kw):
    """``fog_light_setup`` of tests/test_pallas_grad_volumes.py (a fog
    ball and a sphere light over a gray ground, black background); with
    ``kinds`` "sbr", a smaller ball on the left, an unrotated fog box
    ("b") in the middle and a rotated, translated one ("r") on the right;
    without ``light``, ``fog_setup`` (sky-lit)."""
    b = builder_cls()
    g = b.add_lambertian((0.5, 0.5, 0.5))
    lamp = b.add_light((6.0, 5.0, 4.0)) if light else None
    b.add_sphere((0.0, -100.5, -1.0), 100.0, g)
    if light:
        b.add_sphere((0.8, 2.2, -0.6), 0.35, lamp)
    if kinds == "s":
        b.add_fog_sphere((0.0, 0.4, -1.0), 0.6, density=2.0, albedo=ALBEDO)
        return b.build(background=(0.0, 0.0, 0.0) if light else "sky",
                       **build_kw)
    b.add_fog_sphere((-0.75, 0.4, -1.1), 0.4, density=2.0, albedo=ALBEDO)
    b.add_fog_box((-0.25, -0.2, -1.3), (0.25, 0.8, -0.8), 2.5,
                  albedo=(0.6, 0.8, 0.7))
    b.add_fog_box((-0.25, -0.3, -0.25), (0.25, 0.6, 0.25), 3.0,
                  albedo=(0.7, 0.6, 0.9), rotate_y=35.0,
                  translate=(0.75, 0.2, -1.0))
    return b.build(background=(0.0, 0.0, 0.0), **build_kw)


def _scenes(kinds, light=True):
    return fog_scene(JaxSceneBuilder, kinds, light), fog_scene(
        SceneBuilder, kinds, light, device="cpu")


def _cam():
    return make_camera(device="cpu", **CAM)


def jax_statics(jscene, nee):
    """JAX's sphere table, rows and statics of ``render_pixels_kernel``
    (:851-913) for a sphere scene with media."""
    tbl, boxes = jmk.build_sphere_table(jscene)
    z = lambda *shape: jnp.zeros(shape, jnp.float32)  # noqa: E731
    kinds = tuple(k for k, _ in jscene.light_ids) if nee else ()
    rows = [jlights.build_light_table(jscene)] if kinds else []
    vol_row0 = rows[0].shape[0] if rows else 0
    rows.append(jvolumes.pack_volume_rows(jscene))
    bg = None if jscene.background == "sky" else jscene.background
    statics = (tbl.shape[0] // jmk.SPHERE_BLOCK, 0, 0, 0, True,
               jscene.has_emissive, bg, jscene.has_checker, kinds,
               jscene.volume_kinds, vol_row0)
    return (tbl, boxes, z(jmk.TRI_BLOCK, 16), z(1, 8), z(1, 8), z(1, 8),
            jnp.concatenate(rows)), statics


def lane_tape(scene, lit, n_bounces):
    """The input states of the first ``n_bounces`` bounces of one plain
    forward from the camera at W x H, spp SPP."""
    tbl, _ = tb.build_sphere_table(scene)
    gen = torch.Generator().manual_seed(SEED)
    pix = torch.arange(W * H).repeat_interleave(SPP)
    s, t = pixel_coords(W, H, gen, pix)
    cont, ints = bn.lane_state(camera_rays(_cam(), gen, s, t), pix.numel(),
                               "cpu")
    tape = []
    for it in range(n_bounces):
        tape.append((cont, ints))
        cont, ints = grad.bounce_fwd_reference(
            cont, ints, tbl, it=it, seed=SEED, max_depth=DEPTH,
            background=scene.background, lit=lit)
    return tbl, tape


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_one_bounce_matches_bounce_grad_and_its_vjp(nee):
    jscene, scene = _scenes("sbr")
    lit = tb.scene_lit(scene, nee=nee)
    assert lit.vol_kinds == ("s", "b", "r")
    assert lit.vol_row0 == (1 if nee else 0)
    tbl, tape = lane_tape(scene, lit, IT + 1)
    cont, ints = (x.numpy() for x in tape[IT])
    n = cont.shape[1]
    cot = np.random.default_rng(SEED).standard_normal(
        (13, n)).astype(np.float32)
    (jtbl, jboxes, jtri, jtb, jsup, jhyp, jrows), statics = jax_statics(
        jscene, nee)
    # The rows are the scene's, on both sides: lights, then volumes.
    np.testing.assert_array_equal(lit.rows.numpy(), np.asarray(jrows))

    def jax_bounce(c, t, lg):
        return jgrad.bounce_grad(
            tuple(c), tuple(jnp.asarray(ints)), t, jboxes, jtri, jtb, jsup,
            jhyp, lg, statics,
            (jnp.int32(IT), jnp.int32(SEED), jnp.int32(DEPTH)))

    with pltpu.force_tpu_interpret_mode():
        (jc, ji), vjp = jax.vjp(jax_bounce, jnp.asarray(cont), jtbl, jrows)
        f0 = tuple(np.zeros((n,), jax.dtypes.float0) for _ in range(3))
        jcot, jgtbl, jgrows = vjp((tuple(jnp.asarray(cot)), f0))
    jc, ji = np.stack(jc), np.stack(ji)
    jcot, jgtbl, jgrows = (np.asarray(x) for x in (jcot, jgtbl, jgrows))

    kw = dict(it=IT, seed=SEED, max_depth=DEPTH, background=scene.background,
              lit=lit)
    c_t, i_t = torch.from_numpy(cont), torch.from_numpy(ints)
    pc, pi = grad.bounce_fwd(c_t, i_t, tbl, **kw)
    pcot, pgtbl, pgtri, prows = grad.bounce_bwd(
        c_t, i_t, torch.from_numpy(cot), tbl, **kw)
    assert pgtri is None

    # Forward: ints equal (the alive codes too); floats within 5e-3, 80% of
    # lanes within 1e-5.  Volume scatters happened (the alive code 2 under
    # NEE comes from diffuse and volume scatters alike).
    np.testing.assert_array_equal(pi.numpy(), ji)
    d = np.abs(pc.numpy() - jc).max(axis=0)
    assert d.max() <= 5e-3
    assert np.mean(d <= 1e-5) >= 0.8
    # Cotangents per row; table and row cotangents per column.
    scale = np.abs(jcot).max(axis=1, keepdims=True)
    d = np.abs(pcot.numpy() - jcot)
    assert (d <= 1e-2 * scale).all()
    assert np.mean((d <= 1e-5 * scale).all(axis=0)) >= 0.98
    for got, want in ((pgtbl.numpy(), jgtbl), (prows.numpy(), jgrows)):
        assert got.shape == want.shape
        gscale = np.abs(want).max(axis=0)
        assert (np.abs(got - want) <= 1e-2 * gscale + 1e-12).all()
    # Each volume row got its density and albedo cotangents and its
    # boundary's (the centre or the corners; the rotated box's angle and
    # translation too).
    vols = prows.numpy()[lit.vol_row0:]
    for k in range(3):
        assert np.abs(vols[k, 6]).max() > 0, k
        assert np.abs(vols[k, 8:11]).max() > 0, k
        assert np.abs(vols[k, :3]).max() > 0, k
    assert np.abs(vols[2, [7, 11, 12, 13]]).min() > 0


def test_slice_matches_render_and_loss_and_grad_kernel():
    """The 4x4-pixel slice of ``fog_light_setup`` with NEE against JAX's
    ``render_pixels_kernel`` and ``loss_and_grad_kernel``."""
    jscene, scene = _scenes("s")
    jcam = jax_make_camera(**CAM)
    rows, cols = np.meshgrid(range(3, 7), range(3, 7), indexing="ij")
    pix = (rows * W + cols).ravel().astype(np.int32)
    key = jax.random.key(13)
    lane_pix = jnp.repeat(jnp.asarray(pix), SPP)
    s = (lane_pix % W + 0.5) / (W - 1)
    t = ((H - 1 - lane_pix // W) + 0.5) / (H - 1)
    _k_pix, k_cam = jax.random.split(key)
    jrays = jax_camera_rays(jcam, k_cam, s.astype(jnp.float32),
                            t.astype(jnp.float32))
    rays = Rays(np.asarray(jrays.origin), np.asarray(jrays.direction),
                np.asarray(jrays.time))
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH, seed=SEED,
              jitter=False, nee=True)

    def render(s_):
        return grad.render_rays_kernel(s_, rays, n_pixels=pix.size, spp=SPP,
                                       max_depth=DEPTH, seed=SEED, nee=True)

    def jax_loss(sc):
        img = jgrad.render_pixels_kernel(sc, jcam, key, jnp.asarray(pix),
                                         **kw)
        return jnp.mean(img ** 2), img

    with pltpu.force_tpu_interpret_mode():
        (jloss, want), jgrads = jax.value_and_grad(
            jax_loss, has_aux=True, allow_int=True)(jscene)
    want = np.asarray(want)
    loss, grads = grad.scene_value_and_grad(
        lambda s_: torch.mean(render(s_) ** 2), scene)
    got = render(scene).numpy()
    # A pixel whose lane took another path would send another cotangent:
    # none may here (this slice has none), so the gradients compare whole.
    assert (np.abs(got - want).max(axis=1) <= 1e-4).all()
    assert got.max() > 0.05  # lit through the fog
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    got_g = grads.to_numpy()
    for leaf in ("volumes.density", "volumes.albedo", "volumes.p0",
                 "volumes.p1", "materials.albedo"):
        part, field = leaf.split(".")
        want_g = np.asarray(getattr(getattr(jgrads, part), field))
        g = got_g[leaf]
        assert g.shape == want_g.shape, leaf
        assert np.abs(want_g).max() > 0, leaf
        err = np.linalg.norm(g - want_g)
        assert err <= 2e-2 * np.linalg.norm(want_g), (leaf, err)


def _loss_fn(pix, *, nee):
    cam = _cam()
    target = torch.zeros((pix.shape[0], 3))

    def loss(scene):
        img = grad.render_pixels_kernel(
            scene, cam, torch.Generator().manual_seed(13), pix, width=W,
            height=H, spp=SPP, max_depth=DEPTH, seed=SEED, jitter=False,
            nee=nee)
        return torch.mean((img - target) ** 2)

    return loss


def _centre():
    rows, cols = np.meshgrid(range(3, 7), range(3, 7), indexing="ij")
    return torch.from_numpy((rows * W + cols).ravel())


#: which -> (leaf, index): test_pallas_grad_volumes.py's _shift_vol.
VOL_LEAVES = {"density": ("volumes.density", (0,)),
              "valbedo": ("volumes.albedo", (0, 0)),
              "vradius": ("volumes.p1", (0, 0)),
              "vcenter_y": ("volumes.p0", (0, 1))}


def _ad_fd(loss, scene, which, eps):
    leaf, index = VOL_LEAVES[which]
    value, grads = grad.scene_value_and_grad(loss, scene)
    assert np.isfinite(float(value))
    ad = float(grads.leaves()[leaf][index])

    def at(v):
        t = scene.leaves()[leaf].clone()
        t[index] += v
        return float(loss(scene.replace_leaves({leaf: t})))

    return ad, (at(eps) - at(-eps)) / (2 * eps)


def test_volume_grad_matches_fd():
    """test_kernel_volume_grad_matches_fd: the sky-lit ball's medium albedo
    (eps 1e-2), AD within 5% of FD."""
    _, scene = _scenes("s", light=False)
    ad, fd = _ad_fd(_loss_fn(_centre(), nee=False), scene, "valbedo", 1e-2)
    assert fd != 0.0
    assert abs(ad - fd) <= FD_TOL * max(abs(fd), abs(ad), 1e-6), (ad, fd)


def test_density_grad_consistent_with_fd():
    """test_kernel_density_grad_consistent_with_fd: sky-lit, the density
    rides the piecewise-constant event bit and the scatter position; AD
    within 1e-4 of FD (eps 1e-2)."""
    _, scene = _scenes("s", light=False)
    ad, fd = _ad_fd(_loss_fn(_centre(), nee=False), scene, "density", 1e-2)
    assert abs(ad - fd) < 1e-4, (ad, fd)


@pytest.mark.parametrize("which,eps", [
    ("density", 1e-2), ("valbedo", 1e-2), ("vradius", 1e-3),
    ("vcenter_y", 1e-3),
])
def test_volume_nee_grad_matches_fd(which, eps):
    """test_kernel_volume_nee_grad_matches_fd: with NEE, volume events
    sample the light and shadow rays carry exp(-sigma overlap); AD within
    5% of FD."""
    _, scene = _scenes("s")
    ad, fd = _ad_fd(_loss_fn(_centre(), nee=True), scene, which, eps)
    assert fd != 0.0, f"{which}: the FD gate is degenerate"
    assert abs(ad - fd) <= FD_TOL * max(abs(fd), abs(ad), 1e-6), (which, ad,
                                                                   fd)


def test_fog_miss_grads_finite():
    """test_kernel_fog_miss_grads_finite: most lanes miss a small
    off-axis fog ball; the sphere interval's double-where guard keeps its
    degenerate discriminant out of every gradient."""
    cam = make_camera(lookfrom=(0.0, 0.0, 1.5), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, t0=0.0, t1=0.0, device="cpu")
    b = SceneBuilder()
    g = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, g)
    b.add_fog_sphere((0.3, 0.1, -1.0), 0.3, density=2.0,
                     albedo=(0.8, 0.8, 0.8))
    scene = b.build(device="cpu")
    pix = torch.arange(W * H)

    def loss(s_):
        img = grad.render_pixels_kernel(
            s_, cam, torch.Generator().manual_seed(13), pix, width=W,
            height=H, spp=SPP, max_depth=DEPTH, seed=SEED, jitter=False)
        return torch.mean(img ** 2)

    value, grads = grad.scene_value_and_grad(loss, scene)
    assert np.isfinite(float(value))
    for key, g_ in grads.leaves().items():
        assert g_ is None or bool(torch.isfinite(g_).all()), key
    assert float(grads.volumes.albedo.abs().max()) > 0
