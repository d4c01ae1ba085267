"""The port's spans (``rtow_tpu_torch/utils/profiling.span``) under
``torch.profiler`` on the CPU, with the kernels' plain versions: the
phases of a train step and of a frame, in order and without overlap, the
bounces and sorts inside them, the host-sync spans (``rtow.sync.*``),
and the operators each span encloses on the profiler's one clock.  With
no profiler running a span is one shared no-op object.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtow_tpu_torch import diff
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.builders import scene_for_config
from rtow_tpu_torch.models.camera import camera_rays, make_camera
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import grad
from rtow_tpu_torch.ops import tables as tb
from rtow_tpu_torch.ops import wavefront as wf
from rtow_tpu_torch.pipeline import render_auto
from rtow_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402

W, H, SPP, DEPTH = 8, 6, 2, 2
PHASES = ["rtow.train.tables", "rtow.train.forward", "rtow.train.backward",
          "rtow.train.update"]


def recorded(fn):
    """(fn(), the profiler's events as (name, start, end) in start order,
    the enclosing event first where two start together)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    return out, sorted(events, key=lambda e: (e[1], -e[2]))


def named(events, name):
    return [e for e in events if e[0] == name]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def in_order(spans) -> bool:
    """Each span ends before the next starts."""
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def _scene():
    b = SceneBuilder()
    red = b.add_lambertian((0.7, 0.3, 0.3))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, red)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def train():
    """(step kwargs, camera, scene, target) of a tiny albedo fit."""
    cam = make_camera(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=60.0, aspect_ratio=W / H, aperture=0.0,
                      focus_dist=1.0, device="cpu")
    scene = _scene()
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH, seed=5)
    with torch.no_grad():
        target = grad.render_pixels_kernel(
            scene, cam, torch.Generator().manual_seed(1),
            torch.arange(W * H), **kw)
    start = scene.replace_leaves(
        {"materials.albedo": scene.materials.albedo * 0.8})
    return kw, cam, start, target


def test_span_without_a_profiler_is_the_shared_noop():
    assert profiling.span("rtow.a") is profiling.NO_SPAN
    assert profiling.span("rtow.b") is profiling.NO_SPAN
    with profiling.span("rtow.a"), profiling.span("rtow.b"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("rtow.a") is not profiling.NO_SPAN


@pytest.mark.parametrize("sort_lanes", [False, True])
def test_train_step_phases(train, sort_lanes):
    """One ``rtow.train.step`` tiled by tables, forward, backward and
    update in that order; ``max_depth + 1`` bounces in the forward, each
    with K4's span and, where the lanes are sorted, the sort's (and one
    more sort after the last bounce; the keys make no host copy); the
    scene check's sync in the tables, the step's one sync; K5's spans in
    the backward (this thread on the CPU), and where sorted the
    un-permutes' (the camera rays' permute has no cotangent to put
    back)."""
    kw, cam, scene, target = train
    step = diff.build_train_step(cam, lr=1.0, sort_lanes=sort_lanes,
                                 keep=lambda p: p.endswith("albedo"), **kw)
    _, ev = recorded(lambda: step(scene, torch.Generator().manual_seed(2),
                                  target))
    [unit] = named(ev, "rtow.train.step")
    phases = [named(ev, p) for p in PHASES]
    assert all(len(p) == 1 for p in phases)
    phases = [p[0] for p in phases]
    assert in_order(phases) and all(inside(p, unit) for p in phases)
    tables, forward, backward, update = phases
    bounces = named(ev, "rtow.train.bounce")
    assert len(bounces) == DEPTH + 1 and in_order(bounces)
    assert all(inside(b, forward) for b in bounces)
    k4 = named(ev, "rtow.grad.k4")
    assert len(k4) == DEPTH + 1
    assert all(inside(k, b) for k, b in zip(k4, bounces))
    sorts = named(ev, "rtow.grad.sort")
    if sort_lanes:
        assert len(sorts) == DEPTH + 2
        assert all(inside(s, b) for s, b in zip(sorts, bounces))
        assert inside(sorts[-1], forward) and sorts[-1][1] >= bounces[-1][2]
    else:
        assert sorts == []
    k5 = named(ev, "rtow.grad.k5")
    assert len(k5) == DEPTH + 1 and all(inside(k, backward) for k in k5)
    unpermutes = named(ev, "rtow.grad.unpermute")
    assert len(unpermutes) == (DEPTH + 1 if sort_lanes else 0)
    assert all(inside(u, backward) for u in unpermutes)
    syncs = [e for e in ev if e[0].startswith("rtow.sync.")]
    assert [e[0] for e in syncs] == ["rtow.sync.check_scene"]
    assert inside(syncs[0], tables)


@pytest.mark.parametrize("sort_lanes", [False, True])
def test_second_train_step_has_no_sync(train, sort_lanes):
    """The second step of one albedo-fit step function keeps the first's
    layout: its tables phase holds no ``rtow.sync.*`` span and reads no
    value back (no ``aten::item``), and the step holds no sync at all."""
    kw, cam, scene, target = train
    step = diff.build_train_step(cam, lr=1.0, sort_lanes=sort_lanes,
                                 keep=lambda p: p.endswith("albedo"), **kw)
    after, _ = step(scene, torch.Generator().manual_seed(2), target)
    _, ev = recorded(lambda: step(after, torch.Generator().manual_seed(3),
                                  target))
    [tables] = named(ev, "rtow.train.tables")
    assert not [e for e in ev if e[0].startswith("rtow.sync.")]
    assert not [a for a in named(ev, "aten::item") if inside(a, tables)]
    assert len(named(ev, "rtow.train.bounce")) == DEPTH + 1


def test_trace_profile_holds_a_train_step(train, tmp_path, capsys):
    """``trace_profile`` around a train step, as an operator traces one:
    the written Chrome trace holds ``rtow.train.step``, its four phases
    and K5's span a bounce (on the autograd engine's thread on a card,
    on this one on the CPU)."""
    kw, cam, scene, target = train
    step = diff.build_train_step(cam, **kw)
    with profiling.trace_profile(str(tmp_path)):
        step(scene, torch.Generator().manual_seed(3), target)
    assert f"profile trace written to {tmp_path}" in capsys.readouterr().err
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    for name in ["rtow.train.step", *PHASES]:
        assert names.count(name) == 1, name
    assert names.count("rtow.grad.k5") == DEPTH + 1


def test_frame_spans():
    """``render_auto`` on K1's path: one ``rtow.render.frame`` holding
    the image-texture check's tables, K1's tables, K1 and the read-back,
    in order; the syncs in their phases (K1's camera read-back is a card
    path's only)."""
    cfg = Config(device="cpu", image_width=16, samples_per_pixel=1,
                 max_child_rays=2, number_of_balls_sqrt=2)
    scene, cam = scene_for_config(cfg)
    img, ev = recorded(lambda: render_auto(scene, cam, cfg))
    assert img.shape == (cfg.image_height, 16, 3)
    [frame] = named(ev, "rtow.render.frame")
    phases = [e for e in ev if e[0] in ("rtow.render.tables",
                                        "rtow.render.k1",
                                        "rtow.render.readback")]
    assert [p[0] for p in phases] == [
        "rtow.render.tables", "rtow.render.tables", "rtow.render.k1",
        "rtow.render.readback"]
    assert in_order(phases) and all(inside(p, frame) for p in phases)
    syncs = {e[0]: e for e in ev if e[0].startswith("rtow.sync.")}
    assert set(syncs) == {"rtow.sync.image_check", "rtow.sync.readback"}
    assert inside(syncs["rtow.sync.image_check"], phases[0])
    assert inside(syncs["rtow.sync.readback"], phases[3])


def test_trace_lanes_counts_a_live_count_sync_a_bounce():
    """``trace_lanes`` reads the live count once in each bounce, after
    its K3 step, and once opening each window of the ladder; each bounce
    sorts its window once, inside its span."""
    verts, faces = make_knot(16, 12)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    scene = b.build(device="cpu")
    tables, bmin, inv_ext = tb.k3_tables(scene)
    n = 16 * tb.TILE
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device="cpu")
    gen = torch.Generator().manual_seed(4)
    s, t = torch.rand(n, generator=gen), torch.rand(n, generator=gen)
    state = wf.packed_state(camera_rays(cam, gen, s, t), n)
    levels = []
    _, ev = recorded(lambda: wf.trace_lanes(
        state, 3, max_depth=4, tables=tables, bmin=bmin, inv_ext=inv_ext,
        level_its=levels))
    assert len(levels) == len(wf._window_ladder(n)) == 2
    bounces = named(ev, "rtow.wavefront.bounce")
    counts = named(ev, "rtow.sync.live_count")
    assert len(bounces) == levels[-1] > 0
    assert len(counts) == len(bounces) + len(levels)
    sorts = named(ev, "rtow.wavefront.sort")
    for bounce in bounces:
        assert sum(inside(c, bounce) for c in counts) == 1
        assert sum(inside(x, bounce) for x in sorts) == 1


def test_spans_enclose_their_operators(train):
    """Every ``aten::argsort`` of a sorted step's forward lies in a
    ``rtow.grad.sort`` span (the tables' Morton order has one too), and
    the tables' one read of a value to the host (``aten::item``) in the
    scene check's sync span: the spans and the operators share one
    clock."""
    kw, cam, scene, target = train
    step = diff.build_train_step(cam, sort_lanes=True, **kw)
    _, ev = recorded(lambda: step(scene, torch.Generator().manual_seed(2),
                                  target))
    [forward] = named(ev, "rtow.train.forward")
    sorts = named(ev, "rtow.grad.sort")
    argsorts = [a for a in named(ev, "aten::argsort") if inside(a, forward)]
    assert len(argsorts) == len(sorts) == DEPTH + 2
    assert all(any(inside(a, s) for s in sorts) for a in argsorts)
    [tables] = named(ev, "rtow.train.tables")
    [check] = named(ev, "rtow.sync.check_scene")
    reads = [a for a in named(ev, "aten::item") if inside(a, tables)]
    assert len(reads) == 1 and inside(reads[0], check)
    spans = [e for e in ev if e[0].startswith("rtow.")]
    assert spans and all(np.isfinite(e[1]) and e[2] >= e[1] for e in spans)
