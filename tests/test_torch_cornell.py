"""The Cornell box as the benchmark runs it (``benchmark/configs/cornell
.json``), on the CPU: the frozen scene is the port's ``--cornell`` scene,
and the port's lit paths (K1's plain lit pool, the lit train step) agree
with the plain lit reference (``benchmark/reference/lit.py``) within the
cells' limits, while the reference in bfloat16 does not."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.drivers import Context, Seeds, render, train
from benchmark.drivers import render_lit, train_lit
from benchmark.reference import lit
from benchmark.scenes import cornell

CPU = torch.device("cpu")
SEED = 2_147_483_659  # more than 31 bits
CONFIG = core.load_json(core.HERE / "configs" / "cornell.json")
RENDER = dict(width=24, height=24, spp=2, max_depth=6)
TRAIN = dict(width=16, height=16, spp=2, max_depth=4)


def limits(cell):
    return {k: v["limit"] for k, v in core.load_json(
        core.HERE / "limits" / f"{cell}.json").items()}


def context(traffic, sizes, seed=SEED):
    return Context(CONFIG, core.load_json(core.HERE / "traffic"
                                          / f"{traffic}.json"),
                   Seeds(seed), CPU, cornell.scene(CONFIG, 0), sizes)


def test_frozen_scene_is_the_builders():
    from rtow_tpu_torch.models.builders import cornell_scene

    mine = render_lit.build_scene(cornell.scene(CONFIG, 0), CPU)
    theirs, cam = cornell_scene(1.0, device=CPU)
    a, b = mine.leaves(), theirs.leaves()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert mine.meta() == theirs.meta()
    assert mine.light_ids == (("t", 10), ("t", 11))
    assert mine.background == (0.0, 0.0, 0.0)
    spec = {**CONFIG["camera"], "aspect_ratio": 1.0}
    from benchmark.program import build_camera

    frozen = build_camera(spec, CPU)
    for f in dataclasses.fields(cam):
        assert torch.equal(getattr(frozen, f.name), getattr(cam, f.name)), f


@pytest.fixture
def frame(monkeypatch):
    """One 24 x 24 frame of the render cell through ``render_auto`` on
    K1's plain work pool, its shadow rays counted, and the reference's
    events counted while it replays the sampled tile rows."""
    from rtow_tpu_torch import pipeline

    shadows = torch.zeros(1, dtype=torch.int64)
    blocks = pipeline.render_blocks

    def counted(*a, **k):
        return blocks(*a, **{**k, "shadows": shadows})

    monkeypatch.setattr(pipeline, "render_blocks", counted)
    events = {"emissive": 0, "weighted": 0, "lit": 0}
    bounce = lit.lit_bounce

    def tallied(*a, **k):
        out = bounce(*a, **k)
        w = out[3].emit_w
        events["emissive"] += int((w > 0).sum())
        events["weighted"] += int(((w > 0) & (w < 1)).sum())
        events["lit"] += int((out[3].nee_w > 0).sum())
        return out

    monkeypatch.setattr(lit, "lit_bounce", tallied)
    driver = render_lit.Driver(context("render_lit_600x600_spp200_d50",
                                       RENDER))
    driver.setup()
    return driver, shadows, events


def test_render_matches_the_reference(frame):
    driver, shadows, events = frame
    numbers, _ = render.compare(driver.frames, driver.reference())
    lim = limits("cornell.render")
    assert all(v <= lim[k] for k, v in numbers.items()), numbers
    assert int(shadows) > 0
    assert events["emissive"] > 0 and events["weighted"] > 0
    assert events["lit"] > 0


def test_render_control_fails(frame):
    driver, _, _ = frame
    ref = driver.reference()
    numbers, _ = render.compare([driver.reference(torch.bfloat16)], ref)
    lim = limits("cornell.render")
    assert any(v > lim[k] for k, v in numbers.items()), numbers


@pytest.fixture(scope="module")
def steps():
    driver = train_lit.Driver(context("train_lit_400x400_spp16_d8", TRAIN))
    driver.setup()
    return driver, driver.reference()


def test_train_steps_match_the_reference(steps):
    driver, ref = steps
    numbers = train.compare(driver.first, ref, driver.lr)
    lim = limits("cornell.train")
    assert all(v <= lim[k] for k, v in numbers.items()), numbers
    first = driver.first["albedo"]
    assert np.array_equal(first[0][3], [5.0, 5.0, 5.0])
    assert first[-1][3][0] > first[0][3][0]  # the lamp's row rises


def test_train_control_fails(steps):
    driver, ref = steps
    numbers = train.compare(driver.reference(torch.bfloat16), ref, driver.lr)
    lim = limits("cornell.train")
    assert any(v > lim[k] for k, v in numbers.items()), numbers
