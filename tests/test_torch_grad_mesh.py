"""The port's gradient path on meshes (ops/grad.py with triangles) against
rtow_tpu's kernel gradient path (ops/pallas_grad.py) on the CPU.

The JAX side runs its Pallas bounce kernels K4 / K5 under
``pltpu.force_tpu_interpret_mode()`` with the classic scheduler
(``tests/conftest.py`` sets it); the port side runs its kernels' plain
PyTorch versions (``tests/test_torch_cuda.py`` holds the CUDA kernels
against them on the card).  The scenes are the knot of
``tools/make_mesh.make_knot`` over a ground sphere (0, -101, 0), r 100:
(16, 12) is 384 triangles in 3 blocks, swept flat; (64, 32) is 4,096
triangles in 32 blocks, two supers, swept down the hierarchy.

* the gradient path's triangle table (Morton order, 128-row blocks)
  against ``build_tri_table`` under ``jax.jit``: EXACT (rows, block boxes,
  supers, hypers);
* one bounce, lane by lane, on random lane states (numpy seed): the
  forward against ``bounce_grad``, the input and table cotangents against
  ``jax.vjp`` of it.  Bounds as in tests/test_torch_grad.py: ints equal;
  floats within 5e-3 and 80% of lanes within 1e-5; cotangents, ``g_tbl``
  and ``g_tri`` per row / column within 1e-2 of the largest |value|;
  the kind columns zero;
* the slice at 8x8 pixels, spp 8, depth 2 on the 384-triangle knot, from
  rays made by JAX's own ``pixel_coords`` / ``camera_rays``, with the
  lanes unsorted and sorted: pixels against ``render_pixels_kernel`` under
  ``jit``, every gradient leaf against ``loss_and_grad_kernel``; the
  bounds are stated beside the checks;
* the port alone, mirroring the JAX gates (tests/test_pallas_grad.py):
  the hierarchy equals the flat sweep bit for bit (:301-336); sorted
  lanes match unsorted ones (loss within rel 1e-6, gradients within rtol
  2e-4, atol 1e-6, :339-375); a vertex gradient matches central finite
  differences within 10% (:242-286);
* the caps and the unported lit features raise.

XLA's CPU code and PyTorch's round a few float32 operations differently
(multiply-add contraction, sin/cos in the last bit), so a few lanes may
take another path; tests/test_torch_grad.py explains the bounds.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.models.camera import camera_rays as jax_camera_rays
from rtow_tpu.models.camera import make_camera as jax_make_camera
from rtow_tpu.models.camera import pixel_coords as jax_pixel_coords
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import pallas_grad as jgrad
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu_torch import diff
from rtow_tpu_torch.models.camera import Rays, make_camera
from rtow_tpu_torch.models.scene import Scene, SceneBuilder
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import tables as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402

CAM = dict(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
           fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0, focus_dist=3.0)
LEAVES = ("spheres.center0", "spheres.dcenter", "spheres.radius",
          "triangles.verts", "materials.albedo", "materials.fuzz",
          "materials.ir")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain sweeps are many small PyTorch ops: one intra-op thread
    runs them as fast here and keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _knot_scenes(segments, rings, knot="lambertian"):
    """(JAX scene, port scene) of the knot over the ground sphere.
    ``knot="glass"``: a dielectric knot over a fuzzed metal ground."""
    verts, faces = make_knot(segments, rings)
    out = []
    for b in (JaxSceneBuilder(), SceneBuilder()):
        if knot == "glass":
            m_knot = b.add_dielectric(1.5, 0.05)
            m_ground = b.add_metal((0.7, 0.6, 0.5), 0.2)
        else:
            m_knot = b.add_lambertian((0.6, 0.5, 0.4))
            m_ground = b.add_lambertian((0.5, 0.5, 0.5))
        b.add_mesh(verts[faces], m_knot)
        b.add_sphere((0.0, -101.0, 0.0), 100.0, m_ground)
        out.append(b.build() if isinstance(b, JaxSceneBuilder)
                   else b.build(device="cpu"))
    return out


# ---------------------------------------------------------------------------
# (a) The table


@pytest.mark.parametrize("segments,rings,levels", [(16, 12, (3, 0, 0)),
                                                    (64, 32, (32, 2, 0))])
def test_morton_table_equals_jax_under_jit(segments, rings, levels):
    jscene, scene = _knot_scenes(segments, rings)
    want = jax.jit(jmk.build_tri_table)(jscene)
    got = tb.grad_tri_table(scene)
    for name, g, w in zip(("tbl", "boxes", "supers", "hypers"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got.n_blocks, got.n_super, got.n_hyper) == levels
    assert got.block == jmk.TRI_BLOCK == tb.GRAD_TRI_BLOCK
    # The median split (the render paths' order) is another order.
    median = tb.build_tri_table(scene, 128)
    assert not torch.equal(median.tbl, got.tbl)


def test_table_is_differentiable_in_the_vertices():
    _, scene = _knot_scenes(16, 12)
    verts = scene.triangles.verts.clone().requires_grad_(True)
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    tris = tb.grad_tri_table(scene.replace_leaves(
        {"triangles.verts": verts, "materials.albedo": albedo}))
    assert tris.tbl.requires_grad and not tris.boxes.requires_grad
    w = torch.arange(16, dtype=torch.float32)
    (tris.tbl * w).sum().backward()
    # v0 = verts[:, 0] (weights 0-2), e1 = v1 - v0 (3-5), e2 = v2 - v0
    # (6-8): d/dv0 = w0 - w3 - w6, d/dv1 = w3, d/dv2 = w6, per axis.
    want = torch.tensor([[0 - 3 - 6, 1 - 4 - 7, 2 - 5 - 8],
                         [3, 4, 5], [6, 7, 8]], dtype=torch.float32)
    assert torch.equal(verts.grad, want.expand_as(verts))
    # The knot's material gets 384 rows' albedo weights; the ground none.
    assert torch.equal(albedo.grad, torch.tensor(
        [[9.0 * 384, 10.0 * 384, 11.0 * 384], [0.0, 0.0, 0.0]]))


@pytest.mark.parametrize("order", ["morton", "median"])
def test_table_backward_adds_rows_without_sorting(order):
    """The table's rows are gathered by ``index_select``: its backward
    adds each row's cotangent into its source row (``index_add_``), with
    no sort and no accumulating ``index_put_`` (indexing's backward, which
    on the card sums each material's run of rows in one thread).  All
    4,096 triangles of the knot share one material, whose albedo, fuzz
    and ir get the sums of their rows' cotangents; the ground, a sphere,
    gets none from the triangle table."""
    from torch.profiler import ProfilerActivity, profile

    _, scene = _knot_scenes(64, 32)
    keys = ("triangles.verts", "materials.albedo", "materials.fuzz",
            "materials.ir")
    leaves = {k: scene.leaves()[k].clone().requires_grad_(True)
              for k in keys}
    tris = tb.build_tri_table(scene.replace_leaves(leaves), 128, order=order)
    cot = torch.randn(tris.tbl.shape,
                      generator=torch.Generator().manual_seed(4))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g_verts, g_albedo, g_fuzz, g_ir = torch.autograd.grad(
            (tris.tbl * cot).sum(), [leaves[k] for k in keys])
    names = {e.key for e in prof.key_averages()}
    assert "aten::index_add_" in names
    assert not names & {"aten::sort", "aten::index_put_",
                        "aten::_index_put_impl_"}
    rows = cot[:g_verts.shape[0]].double()
    knot = int(scene.triangles.material[0])
    # Float32 sums in another order than float64's: within 1e-5 of the
    # sum of |terms|.
    for got, cols in ((g_albedo, slice(9, 12)), (g_fuzz, 12), (g_ir, 13)):
        err = (got[knot].double() - rows[:, cols].sum(0)).abs()
        assert bool((err <= 1e-5 * rows[:, cols].abs().sum(0)).all()), cols
        assert not got[1 - knot].any()
    # Each triangle's v0, e1 = v1 - v0 and e2 = v2 - v0: d/dv1 summed over
    # the triangles is the e1 columns' sum, whatever the rows' order.
    err = (g_verts[:, 1].double().sum(0) - rows[:, 3:6].sum(0)).abs()
    assert bool((err <= 1e-5 * rows[:, 3:6].abs().sum(0)).all())


# ---------------------------------------------------------------------------
# (b) One bounce, lane by lane


def _random_lanes(n, seed):
    """Lane states around the knot: origins on a shell of radius 2-3.5,
    directions toward points inside the knot's box with an unnormalised
    length; 90% alive, bounce counts 0-3, throughput and radiance in
    range."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((3, n))
    o *= rng.uniform(2.0, 3.5, n) / np.linalg.norm(o, axis=0)
    d = rng.uniform(-0.9, 0.9, (3, n)) - o
    d *= rng.uniform(0.5, 2.0, n)
    cont = np.concatenate([
        o, d, rng.uniform(0, 1, (1, n)), rng.uniform(0.1, 1, (3, n)),
        rng.uniform(0, 2, (3, n))]).astype(np.float32)
    ints = np.stack([(rng.uniform(size=n) < 0.9),
                     rng.integers(0, 4, n),
                     np.arange(n)]).astype(np.int32)
    cot = rng.standard_normal((13, n)).astype(np.float32)
    return cont, ints, cot


def _jax_tables(jscene):
    """The tables and statics of ``render_pixels_kernel`` (:851-913), the
    triangle table built under ``jit`` (Morton order)."""
    tbl, boxes = jmk.build_sphere_table(jscene)
    tri, tri_boxes, tri_sup, tri_hyp = jax.jit(jmk.build_tri_table)(jscene)
    nb = tri.shape[0] // jmk.TRI_BLOCK
    tri3 = tri.reshape(nb, jmk.TRI_BLOCK, 16).transpose(0, 2, 1)
    n_super = nb // jmk.SUPER if tri_sup.shape[0] > 1 else 0
    n_hyper = tri_hyp.shape[0] if tri_hyp.shape[0] > 1 and n_super else 0
    if n_super:
        tri_boxes = tri_boxes[:n_super * jmk.SUPER].reshape(
            n_super, jmk.SUPER * 8)
    statics = (tbl.shape[0] // jmk.SPHERE_BLOCK, nb, n_super, n_hyper, True,
               False, None, False, (), (), 0)
    return tbl, boxes, tri3, tri_boxes, tri_sup, tri_hyp, statics


@pytest.mark.parametrize("segments,rings,knot", [
    (16, 12, "lambertian"), (64, 32, "lambertian"), (16, 12, "glass")])
def test_one_bounce_matches_bounce_grad_and_its_vjp(segments, rings, knot):
    jscene, scene = _knot_scenes(segments, rings, knot)
    jtbl, jboxes, jtri, jtb, jsup, jhyp, statics = _jax_tables(jscene)
    n = tb.TILE
    cont, ints, cot = _random_lanes(n, seed=7)
    it, seed, depth = 1, 11, 3

    def jax_bounce(c, t, tr):
        return jgrad.bounce_grad(
            tuple(c), tuple(jnp.asarray(ints)), t, jboxes, tr, jtb, jsup,
            jhyp, jnp.zeros((1, 14), jnp.float32), statics,
            (jnp.int32(it), jnp.int32(seed), jnp.int32(depth)))

    with pltpu.force_tpu_interpret_mode():
        (jc, ji), vjp = jax.vjp(jax_bounce, jnp.asarray(cont), jtbl, jtri)
        f0 = tuple(np.zeros((n,), jax.dtypes.float0) for _ in range(3))
        jcot, jgtbl, jgtri = vjp((tuple(jnp.asarray(cot)), f0))
    jc, ji = np.stack(jc), np.stack(ji)
    jcot, jgtbl = np.asarray(jcot), np.asarray(jgtbl)
    jgtri = np.asarray(jgtri).transpose(0, 2, 1).reshape(-1, 16)

    tbl, _ = tb.build_sphere_table(scene)
    tris = tb.grad_tri_table(scene)
    kw = dict(it=it, seed=seed, max_depth=depth)
    c_t, i_t = torch.from_numpy(cont), torch.from_numpy(ints)
    stats = torch.zeros(4, dtype=torch.int64)
    pc, pi = grad.bounce_fwd(c_t, i_t, tbl, tris, stats=stats, **kw)
    pcot, pgtbl, pgtri, _ = grad.bounce_bwd(c_t, i_t, torch.from_numpy(cot),
                                            tbl, tris, **kw)

    # Both kinds were hit, and the sweep was counted.
    assert np.abs(pgtri.numpy()).sum() > 0 and np.abs(pgtbl.numpy()).sum() > 0
    assert stats[2] == int((ints[0] > 0).sum()) and stats[0] > 0 < stats[1]
    # Forward: ints equal; floats within 5e-3, 80% of lanes within 1e-5
    # (measured: 9.9e-6 worst, every lane within 1e-5).
    np.testing.assert_array_equal(pi.numpy(), ji)
    d = np.abs(pc.numpy() - jc).max(axis=0)
    assert d.max() <= 5e-3
    assert np.mean(d <= 1e-5) >= 0.8
    # Cotangents per row, table cotangents per column: within 1e-2 of the
    # largest |value|; 98% of lanes within 1e-5 of it (measured: cot_in
    # 7.1e-7, g_tbl 1.5e-5, g_tri 5.2e-6 of it; every lane within 1e-5).
    scale = np.abs(jcot).max(axis=1, keepdims=True)
    d = np.abs(pcot.numpy() - jcot)
    assert (d <= 1e-2 * scale).all()
    assert np.mean((d <= 1e-5 * scale).all(axis=0)) >= 0.98
    for got, want in ((pgtbl.numpy(), jgtbl), (pgtri.numpy(), jgtri)):
        assert got.shape == want.shape
        gscale = np.abs(want).max(axis=0)
        assert (np.abs(got - want) <= 1e-2 * gscale + 1e-12).all()
    # The kind columns (and the textures' / column 15) carry no cotangent.
    assert not pgtbl.numpy()[:, 12:].any() and not jgtbl[:, 12:].any()
    assert not pgtri.numpy()[:, 14:].any() and not jgtri[:, 14:].any()


# ---------------------------------------------------------------------------
# (c) The slice at 8x8 pixels


@pytest.mark.parametrize("sort_lanes", [False, True])
def test_slice_matches_render_and_loss_and_grad_kernel(sort_lanes):
    jscene, scene = _knot_scenes(16, 12)
    jcam = jax_make_camera(**CAM)
    w = h = 8
    pix = np.arange(w * h, dtype=np.int32)
    spp, depth, seed = 8, 2, 4
    key = jax.random.key(3)
    # The rays of pallas_grad.py:920-929, handed to the port as numpy.
    lane_pix = jnp.repeat(jnp.asarray(pix), spp)
    k_pix, k_cam = jax.random.split(key)
    s, t = jax_pixel_coords(w, h, k_pix, lane_pix)
    jrays = jax_camera_rays(jcam, k_cam, s, t)
    rays = Rays(np.asarray(jrays.origin), np.asarray(jrays.direction),
                np.asarray(jrays.time))
    kw = dict(width=w, height=h, spp=spp, max_depth=depth, seed=seed,
              sort_lanes=sort_lanes)

    def render(s_):
        return grad.render_rays_kernel(s_, rays, n_pixels=pix.size, spp=spp,
                                       max_depth=depth, seed=seed,
                                       sort_lanes=sort_lanes)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(functools.partial(
            jgrad.render_pixels_kernel, **kw))(jscene, jcam, key,
                                               jnp.asarray(pix)))
    got = render(scene).numpy()

    # Pixels: 97% within 1e-4, mean |d| at most 5e-3 (measured, sorted
    # and not: max |d| 1.2e-7).
    flipped = np.abs(got - want).max(axis=1) > 1e-4
    assert np.mean(~flipped) >= 0.97
    assert np.abs(got - want).mean() <= 5e-3
    assert got.std() > 0.05  # the knot and the ground are in view

    # The loss targets 0.3 except on pixels that took another path, as in
    # tests/test_torch_grad.py: there each side's target is its own pixel.
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

    # Gradient leaves, each as a whole: |got - want| <= 1e-2 |want| in the
    # 2-norm; entry by entry, 99% of the entries non-zero on either side
    # within 1e-5 + 1e-2 |want| (measured: at most 3.5e-6 |want| in the
    # 2-norm, every entry within; the loss within rel 1e-7).
    got_g = grads.to_numpy()
    for leaf in LEAVES:
        part, name = leaf.split(".")
        want_g = np.asarray(getattr(getattr(jgrads, part), name))
        g = got_g[leaf]
        assert g.shape == want_g.shape, leaf
        err = np.linalg.norm(g - want_g)
        assert err <= 1e-2 * np.linalg.norm(want_g), (leaf, err)
        nz = (g != 0) | (want_g != 0)
        ok = np.abs(g - want_g) <= 1e-5 + 1e-2 * np.abs(want_g)
        if nz.any():
            assert ok[nz].mean() >= 0.99, (leaf, ok[nz].mean())
    assert np.abs(got_g["triangles.verts"]).max() > 0


# ---------------------------------------------------------------------------
# (d) The port alone: the JAX package's own gates


def _loss_and_grads(scene, **kw):
    cam = make_camera(device="cpu", **CAM)
    w = h = kw.pop("size")
    pix = torch.arange(w * h)
    return grad.loss_and_grad_kernel(
        scene, cam, torch.Generator().manual_seed(7), torch.zeros(w * h, 3),
        pix, width=w, height=h, seed=11, **kw)


def test_hierarchy_equals_flat_bit_for_bit():
    """The 4,096-triangle knot: two supers (tests/test_pallas_grad.py:
    301-336).  Both sweeps compute the same pair intersections in the same
    order, so the loss and every gradient leaf are bit-equal."""
    _, scene = _knot_scenes(64, 32)
    assert tb.grad_tri_table(scene).n_super == 2
    out = {flat: _loss_and_grads(scene, size=4, spp=4, max_depth=2,
                                 _force_flat=flat) for flat in (True, False)}
    assert float(out[True][0]) == float(out[False][0])
    for key, g in out[True][1].leaves().items():
        if g is not None:
            assert torch.equal(g, out[False][1].leaves()[key]), key
    assert out[False][1].triangles.verts.abs().max() > 0


def test_sorted_lanes_match_unsorted():
    """tests/test_pallas_grad.py:339-375 on the 384-triangle knot, 8x8
    spp8 depth 2: the loss within rel 1e-6, the gradients within rtol
    2e-4, atol 1e-6 (their sums run in another lane order)."""
    _, scene = _knot_scenes(16, 12)
    out = {s: _loss_and_grads(scene, size=8, spp=8, max_depth=2,
                              sort_lanes=s) for s in (False, True)}
    assert float(out[False][0]) == pytest.approx(float(out[True][0]),
                                                 rel=1e-6)
    for key, g in out[False][1].leaves().items():
        if g is not None:
            np.testing.assert_allclose(g.numpy(),
                                       out[True][1].leaves()[key].numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=key)


def test_vertex_grad_matches_fd():
    """tests/test_pallas_grad.py:242-286: one large tilted triangle over a
    ground sphere; the z of its first vertex, AD against central
    differences with common random numbers, within 10% relative."""
    w = h = 12
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device="cpu")
    b = SceneBuilder()
    red = b.add_lambertian((0.7, 0.3, 0.3))
    gray = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_triangle((-4.0, -4.0, -0.6), (4.0, -1.0, -1.8), (0.0, 5.0, -1.4),
                   red)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, gray)
    scene = b.build(device="cpu")
    rows, cols = np.meshgrid(range(5, 8), range(5, 8), indexing="ij")
    pix = torch.from_numpy((rows * w + cols).ravel())
    target = torch.zeros((pix.shape[0], 3))
    kw = dict(width=w, height=h, spp=32, max_depth=2, seed=11, jitter=False)

    def loss(s):
        return diff.image_mse(s, cam, torch.Generator().manual_seed(7),
                              target, pix, **kw)

    value, grads = grad.scene_value_and_grad(loss, scene)
    assert np.isfinite(float(value))
    for key, g in grads.leaves().items():
        assert g is None or bool(torch.isfinite(g).all()), key
    ad = float(grads.triangles.verts[0, 0, 2])

    def loss_at(v):
        verts = scene.triangles.verts.clone()
        verts[0, 0, 2] += v
        return float(loss(scene.replace_leaves({"triangles.verts": verts})))

    eps = 2e-3
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert abs(ad - fd) / max(abs(fd), abs(ad), 1e-6) < 0.1, (ad, fd)


def test_train_step_moves_the_vertices():
    """``diff.build_train_step`` on a mesh (tests/test_pallas_grad.py:
    212-240, single device): the vertices move."""
    _, scene = _knot_scenes(16, 12)
    cam = make_camera(device="cpu", **CAM)
    step = diff.build_train_step(cam, width=8, height=4, spp=8, max_depth=2,
                                 lr=1e-2, sort_lanes=True)
    new, loss = step(scene, torch.Generator().manual_seed(0),
                     torch.zeros((32, 3)))
    assert np.isfinite(float(loss))
    assert float((new.triangles.verts - scene.triangles.verts).abs().max()) \
        > 0


# ---------------------------------------------------------------------------
# (e) What raises


def test_caps_raise():
    """JAX's caps (pallas_grad.py:867, :886): 4,096 blocks in all, 1,536
    on the flat sweep.  Degenerate triangles make the tables cheaply."""
    def scene_of(n_tris):
        b = SceneBuilder()
        m = b.add_lambertian((0.5, 0.5, 0.5))
        v = np.zeros((n_tris, 3, 3))
        v[:, 1, 0] = v[:, 2, 1] = 1.0
        v[:, :, 2] = np.arange(n_tris)[:, None] * 1e-3
        b.add_mesh(v, m)
        return b.build(device="cpu")

    big = scene_of(4096 * 128 + 1)  # padded to 4,352 blocks
    with pytest.raises(ValueError, match="caps at 4096"):
        tb.grad_tri_table(big)
    mid = scene_of(1600 * 128)  # 1,600 blocks: 100 supers, 7 hypers
    assert tb.grad_tri_table(mid).n_super
    with pytest.raises(ValueError, match="flat gradient sweep caps"):
        tb.grad_tri_table(mid, flat=True)


def test_lit_meshes_raise():
    """The knot over an emissive ground renders through the lit kernels
    (emission, and NEE toward the ground past the triangles); a knot in
    fog renders through them too (the media slice)."""
    _, scene = _knot_scenes(16, 12)
    arrays = {k: v.copy() for k, v in scene.to_numpy().items()}
    arrays["materials.kind"][1] = 3
    verts, faces = make_knot(16, 12)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    b.add_fog_sphere((0.0, 0.0, 0.0), 0.5, 1.0)
    cam = make_camera(device="cpu", **CAM)
    kw = dict(width=2, height=2, spp=1, max_depth=1)
    img = grad.render_pixels_kernel(
        Scene.from_numpy(arrays, "cpu"), cam, torch.Generator(),
        torch.arange(4), nee=True, **kw)
    assert bool(torch.isfinite(img).all())
    img = grad.render_pixels_kernel(b.build(device="cpu"), cam,
                                    torch.Generator(), torch.arange(4), **kw)
    assert img.shape == (4, 3) and bool(torch.isfinite(img).all())
