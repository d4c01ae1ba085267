"""The train step's kept layout (``diff.build_train_step`` over
``tables.grad_layout`` / ``tables.grad_rows``), on the CPU with the
kernels' plain versions.

Each case runs steps of ``build_train_step`` beside the step composed by
hand with no layout kept (``loss_and_grad`` -> ``mask_grads`` ->
``sgd_update``) from the same scene, generator seeds and target: every
loss and every leaf the same bits.  ``grad_layout.builds`` counts the
layouts built: one over an albedo fit, one a step where the geometry
trains or is edited in place.
"""
import os
import sys

import pytest
import torch

from rtow_tpu_torch import diff
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import cornell_scene, cover_scene
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import IMAGE, SceneBuilder
from rtow_tpu_torch.ops import tables as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402

STEPS = 5


def _albedo(path: str) -> bool:
    return path.endswith("albedo")


def _cover():
    """The cover's moving spheres: 488 rows, four Morton blocks."""
    scene, cam = cover_scene(Config(device="cpu", image_width=8,
                                    aspect_ratio=1.0))
    assert bool(scene.spheres.dcenter.any()) and scene.n_spheres > 384
    return scene, cam, dict(width=8, height=8, spp=2, max_depth=2)


def _knot_camera():
    return make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                       fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                       focus_dist=3.0, device="cpu")


def _knot(segments, rings):
    verts, faces = make_knot(segments, rings)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    b.add_sphere((0.0, -101.0, 0.0), 100.0, b.add_lambertian((0.5,) * 3))
    return b.build(device="cpu")


def _mesh4k():
    """4,096 triangles at 128 rows a block: two supers, no hyper level."""
    scene = _knot(64, 32)
    assert tb.grad_tri_table(scene).n_super == 2
    return scene, _knot_camera(), dict(width=8, height=8, spp=1,
                                       max_depth=1)


def _knot65k():
    """The 65k knot, sorted: 32 supers, so the hyper level and its
    ``tri_pad`` row."""
    scene = _knot(256, 128)
    tris = tb.grad_tri_table(scene)
    assert tris.n_super == 32 and tris.n_hyper == 2
    return scene, _knot_camera(), dict(width=4, height=4, spp=1,
                                       max_depth=1, sort_lanes=True)


def _cornell():
    """The Cornell box under NEE: a two-triangle lamp, a sphere."""
    scene, cam = cornell_scene(device="cpu")
    assert [k for k, _ in scene.light_ids] == ["t", "t"]
    return scene, cam, dict(width=8, height=8, spp=2, max_depth=2, nee=True)


SCENES = {"cover": _cover, "mesh4k": _mesh4k, "knot65k": _knot65k,
          "cornell": _cornell}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(la, lb) -> bool:
    """Every leaf of ``la`` and ``lb`` ({key: leaf}) the same bits."""
    return la.keys() == lb.keys() and all(
        torch.equal(_bits(la[k]), _bits(lb[k])) for k in la)


def _leaves(scene) -> dict:
    """A copy of every leaf of ``scene``, which no later edit reaches."""
    return {k: v.clone() for k, v in scene.leaves().items()}


def _today(camera, kw, keep, lr):
    """The step with no layout kept: loss_and_grad, mask_grads,
    sgd_update."""
    kw = dict(kw)
    width, height = kw["width"], kw["height"]
    pixel_ids = torch.arange(width * height)

    def step(scene, gen, target):
        loss, grads = diff.loss_and_grad(scene, camera, gen, target,
                                         pixel_ids, **kw)
        if keep is not None:
            grads = diff.mask_grads(grads, keep)
        return diff.sgd_update(scene, grads, lr), loss

    return step


def _target(scene, kw):
    return torch.rand((kw["width"] * kw["height"], 3),
                      generator=torch.Generator().manual_seed(3))


def _run(scene, camera, kw, keep, lr=1.0, steps=STEPS, edit=None,
         edit_at=None):
    """(layouts built by build_train_step's step, its [(loss, leaves)],
    today's step's [(loss, leaves)]); before step ``edit_at``,
    ``edit(center0)`` changes both scenes' sphere centres in place."""
    target = _target(scene, kw)
    kept = diff.build_train_step(camera, lr=lr, keep=keep, seed=7, **kw)
    today = _today(camera, dict(kw, seed=7), keep, lr)
    builds = 0
    out = {kept: [], today: []}
    cur = {kept: scene, today: scene}
    for i in range(steps):
        for fn in (kept, today):
            if i == edit_at:
                edit(cur[fn].spheres.center0)
            before = tb.grad_layout.builds
            cur[fn], loss = fn(cur[fn], torch.Generator().manual_seed(i),
                               target)
            out[fn].append((loss, _leaves(cur[fn])))
            if fn is kept:
                builds += tb.grad_layout.builds - before
    return builds, out[kept], out[today]


def _assert_same_steps(kept, today):
    for i, ((lk, sk), (lt, st)) in enumerate(zip(kept, today)):
        assert torch.equal(_bits(lk), _bits(lt)), (i, lk, lt)
        assert _same(sk, st), i


@pytest.mark.parametrize("name", list(SCENES))
def test_albedo_fit_keeps_one_layout_bit_for_bit(name):
    """Five albedo-fit steps: the losses and every leaf equal today's
    step's bit for bit, from one layout; the geometry is carried through
    as the very tensors."""
    scene, camera, kw = SCENES[name]()
    builds, kept, today = _run(scene, camera, kw, _albedo)
    _assert_same_steps(kept, today)
    assert builds == 1
    step = diff.build_train_step(camera, lr=1.0, keep=_albedo, **kw)
    new, _ = step(scene, torch.Generator().manual_seed(0), _target(scene, kw))
    assert new.triangles.verts is scene.triangles.verts
    assert new.spheres.center0 is scene.spheres.center0
    assert not torch.equal(new.materials.albedo, scene.materials.albedo)


@pytest.mark.parametrize("name,leaf", [("cover", "spheres.center0"),
                                       ("mesh4k", "triangles.verts")])
def test_trained_geometry_rebuilds_every_step(name, leaf):
    """A step that trains a geometry leaf builds its layout every step,
    as today, with the same results."""
    scene, camera, kw = SCENES[name]()
    builds, kept, today = _run(
        scene, camera, kw, lambda p: p.endswith("albedo") or p == leaf)
    _assert_same_steps(kept, today)
    assert builds == STEPS
    assert not torch.equal(kept[-1][1][leaf], scene.leaves()[leaf])


def test_every_leaf_trained_rebuilds_every_step():
    """``keep=None`` trains every leaf, so every step builds a layout."""
    scene, camera, kw = _cover()
    builds, kept, today = _run(scene, camera, kw, None, lr=0.1, steps=3)
    _assert_same_steps(kept, today)
    assert builds == 3


def _add(t):
    t[0, 1].add_(0.25)


def _swap(t):
    t.data = t + 0.25


@pytest.mark.parametrize("edit", [_add, _swap], ids=["add_", "data"])
def test_in_place_edit_rebuilds_the_layout(edit):
    """An edit in place of a geometry leaf between two steps (the tensor
    the layout was built from: a sphere moved by ``add_``, which moves
    its version, or every sphere by ``t.data = ...``, which moves its
    address alone): the next step builds a layout anew, and its results
    are today's on the edited scene."""
    scene, camera, kw = _cover()
    builds, kept, today = _run(scene, camera, kw, _albedo, steps=4,
                               edit=edit, edit_at=2)
    _assert_same_steps(kept, today)
    assert builds == 2


def test_negative_lr_keeps_todays_update():
    """With ``lr`` < 0, ``p - lr * 0`` turns -0 into +0: the masked leaves
    take today's update (new tensors, the same bits as today's), so the
    layout is built every step."""
    scene, camera, kw = _cover()
    c0 = scene.spheres.center0.clone()
    c0[1, 0] = -0.0
    scene = scene.replace_leaves({"spheres.center0": c0})
    builds, kept, today = _run(scene, camera, kw, _albedo, lr=-0.5, steps=2)
    _assert_same_steps(kept, today)
    assert builds == 2
    assert _bits(kept[-1][1]["spheres.center0"])[1, 0] == 0  # +0, as today


def test_image_texture_raises_at_the_first_step():
    scene, camera, kw = _cover()
    kind = scene.materials.kind.clone()
    kind[1] = IMAGE
    scene = scene.replace_leaves({"materials.kind": kind})
    step = diff.build_train_step(camera, lr=1.0, keep=_albedo, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step(scene, torch.Generator().manual_seed(0), _target(scene, kw))


def test_grad_tables_is_layout_then_rows():
    """``grad_tables`` builds one layout a call; the rows gathered through
    a layout built earlier equal a fresh build's, and the sort grid, the
    boxes and the hierarchy are the layout's own tensors."""
    scene, _, _ = _knot65k()
    before = tb.grad_layout.builds
    fresh = tb.grad_tables(scene, sort_lanes=True)
    assert tb.grad_layout.builds == before + 1
    layout = tb.grad_layout(scene, sort_lanes=True)
    rows = tb.grad_rows(scene, layout)
    assert torch.equal(rows.tbl, fresh.tbl)
    for a, b in zip(rows.tris, fresh.tris):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    assert all(torch.equal(a, b) for a, b in zip(rows.grid, fresh.grid))
    assert rows.tris.hypers is layout.tris.hypers
    assert rows.grid is layout.grid
