"""The port's gradient path on lit scenes (ops/grad.py with emission, NEE
and textures) against rtow_tpu's kernel gradient path
(ops/pallas_grad.py), one bounce, lane by lane, on the CPU.

The JAX side runs its Pallas bounce kernels K4 / K5 under
``pltpu.force_tpu_interpret_mode()`` with the classic scheduler
(``tests/conftest.py`` sets it), with the lit statics
``render_pixels_kernel`` derives (:887-913): ``emissive``, the flat
background, ``checker``, and ``nee_kinds`` with the light rows of
``build_light_table`` as a differentiable operand.  The port side runs
its kernels' plain PyTorch versions (``tests/test_torch_cuda.py`` and
``tests/test_torch_lanes_host.py`` hold the CUDA code against them).

Scenes, each built by both packages: ``light_scene`` (two sphere lights,
NEE), ``cornell_scene`` (a triangle lamp, NEE), ``textures_scene``
(checker and noise, sky) and the cover with its checkered ground.  The
lane states are the second bounce's input of one plain forward from the
camera at 32x32, spp 1 (so the alive codes 1 and 2 and the MIS weight of
emission hits after a diffuse scatter appear), with standard-normal
output cotangents (numpy seed).

Bounds, as in tests/test_torch_grad.py: ints equal; floats within 5e-3
and 80% of lanes within 1e-5; the input cotangents per row, ``g_tbl``,
``g_tri`` and ``g_lights`` per column within 1e-2 of the largest
|value|, 98% of lanes within 1e-5 of it; the kind columns zero.  XLA's
CPU code and PyTorch's round a few float32 operations differently
(multiply-add contraction, sin, cos and sqrt in the last bit), so a few
lanes may take another path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models import builders as jax_builders
from rtow_tpu.ops import lights as jlights
from rtow_tpu.ops import pallas_grad as jgrad
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.camera import camera_rays, pixel_coords
from rtow_tpu_torch.ops import bounce as bn
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import tables as tb

SIZE, SEED, DEPTH, IT = 32, 5, 4, 1


def _cover_checker(jax_side):
    kw = dict(seed=0, moving_spheres=True, image_width=64, aspect_ratio=1.0,
              checker_ground=True)
    if jax_side:
        return jax_builders.cover_scene(JaxConfig(**kw))
    return builders.cover_scene(Config(device="cpu", **kw))


#: name -> (JAX builder, port builder, nee)
SCENES = {
    "light": (lambda: jax_builders.light_scene(1.0),
              lambda: builders.light_scene(1.0, device="cpu"), True),
    "cornell": (lambda: jax_builders.cornell_scene(1.0),
                lambda: builders.cornell_scene(1.0, device="cpu"), True),
    "textures": (lambda: jax_builders.textures_scene(1.0),
                 lambda: builders.textures_scene(1.0, device="cpu"), False),
    "checker_cover": (lambda: _cover_checker(True),
                      lambda: _cover_checker(False), False),
}


def jax_statics(jscene, nee):
    """JAX's tables, light rows and statics of ``render_pixels_kernel``
    (:851-913) for a scene, the triangle table built under ``jit``."""
    tbl, boxes = jmk.build_sphere_table(jscene)
    n_blocks = tbl.shape[0] // jmk.SPHERE_BLOCK
    if jscene.n_triangles:
        tri, tri_boxes, tri_sup, tri_hyp = jax.jit(jmk.build_tri_table)(
            jscene)
        nb = tri.shape[0] // jmk.TRI_BLOCK
        tri = tri.reshape(nb, jmk.TRI_BLOCK, 16).transpose(0, 2, 1)
        n_super = nb // jmk.SUPER if tri_sup.shape[0] > 1 else 0
        n_hyper = tri_hyp.shape[0] if tri_hyp.shape[0] > 1 and n_super else 0
        if n_super:
            tri_boxes = tri_boxes[:n_super * jmk.SUPER].reshape(
                n_super, jmk.SUPER * 8)
    else:
        z = lambda *shape: jnp.zeros(shape, jnp.float32)  # noqa: E731
        tri, tri_boxes, tri_sup, tri_hyp = (z(jmk.TRI_BLOCK, 16), z(1, 8),
                                            z(1, 8), z(1, 8))
        nb = n_super = n_hyper = 0
    kinds = tuple(k for k, _ in jscene.light_ids) if nee else ()
    lights = (jlights.build_light_table(jscene) if kinds
              else jnp.zeros((1, 14), jnp.float32))
    bg = None if jscene.background == "sky" else jscene.background
    statics = (n_blocks, nb, n_super, n_hyper, True, jscene.has_emissive, bg,
               jscene.has_checker, kinds, (), 0)
    return (tbl, boxes, tri, tri_boxes, tri_sup, tri_hyp, lights), statics


def lane_tape(scene, cam, lit, n_bounces, size=SIZE, spp=1, seed=SEED):
    """The input states of the first ``n_bounces`` bounces of one plain
    forward from the camera (``depth`` DEPTH), and the tables."""
    tbl, _ = tb.build_sphere_table(scene)
    tris = tb.grad_tri_table(scene) if scene.n_triangles else None
    gen = torch.Generator().manual_seed(seed)
    pix = torch.arange(size * size).repeat_interleave(spp)
    s, t = pixel_coords(size, size, gen, pix)
    cont, ints = bn.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                               "cpu")
    tape = []
    for it in range(n_bounces):
        tape.append((cont, ints))
        cont, ints = grad.bounce_fwd_reference(
            cont, ints, tbl, tris, it=it, seed=seed, max_depth=DEPTH,
            background=scene.background, lit=lit)
    return tbl, tris, tape


@pytest.mark.parametrize("name", list(SCENES))
def test_one_bounce_matches_bounce_grad_and_its_vjp(name):
    jbuild, build, nee = SCENES[name]
    jscene = jbuild()
    scene, cam = build()
    if isinstance(jscene, tuple):
        jscene = jscene[0]
    lit = tb.scene_lit(scene, nee=nee)
    tbl, tris, tape = lane_tape(scene, cam, lit, IT + 1)
    cont, ints = (x.numpy() for x in tape[IT])
    n = cont.shape[1]
    cot = np.random.default_rng(SEED).standard_normal(
        (13, n)).astype(np.float32)
    (jtbl, jboxes, jtri, jtb, jsup, jhyp, jlights), statics = jax_statics(
        jscene, nee)
    if nee:  # the light rows are the scene's, on both sides
        np.testing.assert_array_equal(lit.rows.numpy(), np.asarray(jlights))

    def jax_bounce(c, t, tr, lg):
        return jgrad.bounce_grad(
            tuple(c), tuple(jnp.asarray(ints)), t, jboxes, tr, jtb, jsup,
            jhyp, lg, statics,
            (jnp.int32(IT), jnp.int32(SEED), jnp.int32(DEPTH)))

    with pltpu.force_tpu_interpret_mode():
        (jc, ji), vjp = jax.vjp(jax_bounce, jnp.asarray(cont), jtbl, jtri,
                                jlights)
        f0 = tuple(np.zeros((n,), jax.dtypes.float0) for _ in range(3))
        jcot, jgtbl, jgtri, jglights = vjp((tuple(jnp.asarray(cot)), f0))
    jc, ji = np.stack(jc), np.stack(ji)
    jcot, jgtbl = np.asarray(jcot), np.asarray(jgtbl)

    kw = dict(it=IT, seed=SEED, max_depth=DEPTH, background=scene.background,
              lit=lit)
    c_t, i_t = torch.from_numpy(cont), torch.from_numpy(ints)
    pc, pi = grad.bounce_fwd(c_t, i_t, tbl, tris, **kw)
    pcot, pgtbl, pgtri, prows = grad.bounce_bwd(
        c_t, i_t, torch.from_numpy(cot), tbl, tris, **kw)

    # Forward: ints equal (the alive codes 0/1/2 too); floats within 5e-3,
    # 80% of lanes within 1e-5.
    np.testing.assert_array_equal(pi.numpy(), ji)
    if nee:
        assert (ji[0] == 2).any()  # diffuse scatters under NEE
    d = np.abs(pc.numpy() - jc).max(axis=0)
    assert d.max() <= 5e-3
    assert np.mean(d <= 1e-5) >= 0.8
    # Cotangents per row; table and light-row cotangents per column.
    scale = np.abs(jcot).max(axis=1, keepdims=True)
    d = np.abs(pcot.numpy() - jcot)
    assert (d <= 1e-2 * scale).all()
    assert np.mean((d <= 1e-5 * scale).all(axis=0)) >= 0.98
    parts = [(pgtbl.numpy(), jgtbl)]
    if tris is not None:
        parts.append((pgtri.numpy(), np.asarray(jgtri).transpose(0, 2, 1)
                      .reshape(-1, 16)))
    if nee:
        parts.append((prows.numpy(), np.asarray(jglights)))
    else:
        assert prows is None and not np.asarray(jglights).any()
    for got, want in parts:
        assert got.shape == want.shape
        gscale = np.abs(want).max(axis=0)
        assert (np.abs(got - want) <= 1e-2 * gscale + 1e-12).all()
        assert np.abs(want).max() > 0
    # The kind columns carry no cotangent; the checker's second colour
    # does where a textured sphere was hit.
    assert not pgtbl.numpy()[:, 12].any() and not jgtbl[:, 12].any()
    if scene.has_checker:
        assert np.abs(pgtbl.numpy()[:, 13:]).max() > 0


# ---------------------------------------------------------------------------
# K5's shared-memory layout: tensors on the meta device reach the wrappers'
# checks without a card.


def _meta_tris(blocks):
    def z(*shape):
        return torch.empty(shape, device="meta")
    return tb.TriTable(tbl=z(blocks * tb.GRAD_TRI_BLOCK, 16),
                       boxes=z(blocks, 8), supers=z(1, 8), hypers=z(1, 8),
                       block=tb.GRAD_TRI_BLOCK, count=12)


@pytest.mark.parametrize("sphere_blocks, lights, volumes, layout", [
    # The largest table and rows K5 took before it kept anything more in
    # shared memory: 14 sphere blocks beside 16 light and 8 volume rows.
    (14, 16, 8, (0, 0, 1)),
    # The same table under the smoke box's 2 + 2 rows: no room for the
    # triangle table's gradient or the threads' own row sums.
    (14, 2, 2, (0, 0, 1)),
    # A small table: every piece fits (own: 4 rows x 14 columns, odd).
    (1, 2, 2, (128, 57, 1)),
    (15, 2, 2, None),  # refused alone, as before
])
def test_k5_layout_fits_beside_the_sphere_table(sphere_blocks, lights,
                                                volumes, layout):
    """K5 keeps the triangle table's gradient, each thread's own row sums
    and the volumes' frames in shared memory only where they fit beside
    the sphere table, so it takes every sphere table it took with the
    rows alone; the wrapper's check counts what the layout holds."""
    tbl = torch.empty((sphere_blocks * tb.SPHERE_BLOCK, tb.TBL_COLS),
                      device="meta")
    lit = tb.Lit(nee_kinds=("t",) * lights, vol_kinds=("r",) * volumes,
                 vol_row0=lights,
                 rows=torch.empty((lights + volumes, 14), device="meta"))
    tris = _meta_tris(1)
    n = 64
    cont = torch.empty((13, n), device="meta")
    ints = torch.empty((3, n), dtype=torch.int32, device="meta")
    match = ("no grad_bwd kernel for device meta" if layout
             else "exceed the grad_bwd kernel's shared-memory table")
    with pytest.raises(ValueError, match=match):
        grad.bounce_bwd(cont, ints, torch.empty_like(cont), tbl, tris, it=0,
                        seed=0, max_depth=8, lit=lit)
    staged, got = grad._bwd_layout(tbl, lit, tris)
    if layout:
        assert got == layout
        assert 2 * tbl.numel() * 4 + staged <= tb.MAX_TABLE_BYTES
        assert staged >= 2 * (lights + volumes) * 14 * 4


@pytest.mark.parametrize("blocks, issued", [(None, False), (1, False),
                                            (2, True), (32, True)])
def test_warp_forms_need_more_than_one_triangle_block(blocks, issued):
    """K4 and K5 issue their warp forms, and the wrappers count the live
    lanes, only for a triangle table of more than one block; the Cornell
    and smoke boxes' walls fill one."""
    tris = None if blocks is None else _meta_tris(blocks)
    assert grad.warp_forms(tris) is issued
    ints = torch.ones((3, 8), dtype=torch.int32)
    live = grad._live_count(ints, tris, None)
    assert (live is not None) is issued
