"""The Cornell smoke as the benchmark runs it (``benchmark/configs/smoke
.json``), on the CPU: the frozen scene is the port's ``--smoke`` scene,
the port's media train step (the plain versions of K4's and K5's media
instances under NEE) agrees with the plain media reference
(``benchmark/reference/media.py``) within the cell's limits on random
media, a sound run of the cell is correct and each fault planted under
it is caught, the reference in bfloat16 fails the limits, and the
reference's albedo gradient is its own central difference."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from benchmark import core, faults
from benchmark.drivers import Context, Seeds, train_media
from benchmark.reference import media
from benchmark.scenes import smoke

CPU = torch.device("cpu")
SEED = 2_147_483_659  # more than 31 bits
CONFIG = core.load_json(core.HERE / "configs" / "smoke.json")
TRAFFIC = "train_media_400x400_spp16_d8"
SIZES = dict(width=16, height=16, spp=2, max_depth=4)


def limits():
    return {k: v["limit"] for k, v in core.load_json(
        core.HERE / "limits" / "smoke.train.json").items()}


def random_media(seed):
    """The frozen scene with its media's true leaves, and a start, drawn
    from ``seed``: densities in [0.005, 0.03], albedos in [0, 1]."""
    rng = np.random.default_rng(seed)
    inputs = smoke.scene(CONFIG, 0)
    inputs["volumes"] = {**inputs["volumes"],
                         "density": rng.uniform(0.005, 0.03, 2),
                         "albedo": rng.uniform(0.0, 1.0, (2, 3))}
    start = {media.DENSITY: rng.uniform(0.005, 0.03, 2).tolist(),
             media.ALBEDO: rng.uniform(0.0, 1.0, (2, 3)).tolist()}
    return inputs, start


def driver(seed=SEED, inputs=None, start=None):
    config = dict(CONFIG)
    if start is not None:
        config["train"] = {**config["train"], "start": start}
    ctx = Context(config, core.load_json(core.HERE / "traffic"
                                         / f"{TRAFFIC}.json"),
                  Seeds(seed), CPU, inputs or smoke.scene(CONFIG, 0), SIZES)
    return train_media.Driver(ctx)


def test_frozen_scene_is_the_builders():
    from benchmark.program import build_camera
    from rtow_tpu_torch.models.builders import smoke_scene

    mine = train_media.build_scene(smoke.scene(CONFIG, 0), CPU)
    theirs, cam = smoke_scene(1.0, device=CPU)
    a, b = mine.leaves(), theirs.leaves()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert mine.meta() == theirs.meta()
    assert mine.volume_kinds == ("r", "r")
    assert mine.light_ids == (("t", 10), ("t", 11))
    frozen = build_camera({**CONFIG["camera"], "aspect_ratio": 1.0}, CPU)
    for f in dataclasses.fields(cam):
        assert torch.equal(getattr(frozen, f.name), getattr(cam, f.name)), f


@pytest.fixture(scope="module")
def steps():
    """The driver after set-up, the reference, and the layouts set-up
    built."""
    from rtow_tpu_torch.ops.tables import grad_layout

    d = driver()
    before = grad_layout.builds
    d.setup()
    return d, d.reference(), grad_layout.builds - before


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_train_steps_match_the_reference(seed):
    """Three steps on random media: every number within its limit, and
    the fit moves both densities and the albedos."""
    inputs, start = random_media(seed)
    d = driver(SEED + seed, inputs, start)
    d.setup()
    numbers = train_media.compare(d.first, d.reference(), d.lr)
    lim = limits()
    assert all(v <= lim[k] for k, v in numbers.items()), numbers
    first, last = d.first["state"][0], d.first["state"][-1]
    assert np.all(first[media.DENSITY] != last[media.DENSITY])
    assert np.any(first[media.ALBEDO] != last[media.ALBEDO])


def test_the_carried_leaves_stand(steps):
    """The step carries every leaf it does not fit unchanged, and builds
    one layout for the three steps."""
    d, _, builds = steps
    first, last = d.first["state"][0], d.first["state"][-1]
    for key in first:
        if key not in train_media.FIT:
            assert np.array_equal(first[key], last[key]), key
    assert builds == 2  # the target's render, then the step's one


def test_train_control_fails(steps):
    d, ref, _ = steps
    numbers = train_media.compare(d.reference(torch.bfloat16), ref, d.lr)
    lim = limits()
    assert any(v > lim[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
def test_cell_run(fault):
    """A whole run of the cell at the small size: sound, it is correct
    with both end-to-end metrics; with a fault planted, not."""
    with (faults.planted(fault, train_media.BASE) if fault
          else contextlib.nullcontext()):
        result = core.run("smoke.train", SEED, 0.2, False, device=CPU,
                          sizes=SIZES, log=io.StringIO())
    assert result["correct"] == (fault is None), (fault, result["compared"])
    if fault is None:
        assert set(result["metrics"]) == {"train_step_ms",
                                          "train_step_p95_ms", "setup_s"}
        assert result["attempted"] >= 1 and result["failed"] == 0


def test_reference_albedo_grad_is_its_central_difference():
    """The albedos move no path, so the reference's gradient in them is
    the loss's central difference in float64 on common random numbers,
    up to rounding."""
    dtype = torch.float64
    inputs, start = random_media(4)
    M = media.build_media_scene(inputs, CPU, dtype)
    cam = media.make_camera(CONFIG["camera"] | {"aspect_ratio": 1.0}, CPU,
                            dtype)
    kw = dict(spp=2, seed=11, max_depth=4)
    w = 12
    target = media.render_image(M, media.leaves_of(inputs, CPU, dtype),
                                media.camera_rays(cam, 5, w, w, 2, CPU),
                                **kw)
    rays = media.camera_rays(cam, 6, w, w, 2, CPU)
    leaves = media.start_leaves(start, CPU, dtype)
    _, grad = media.loss_and_grad(M, leaves, rays, target, **kw)
    h = 1e-4

    def loss(leaves):
        img = media.render_image(M, leaves, rays, **kw)
        return float(torch.mean((img - target) ** 2))

    for v in range(2):
        for c in range(3):
            up = {k: x.clone() for k, x in leaves.items()}
            down = {k: x.clone() for k, x in leaves.items()}
            up[media.ALBEDO][v, c] += h
            down[media.ALBEDO][v, c] -= h
            fd = (loss(up) - loss(down)) / (2 * h)
            g = float(grad[media.ALBEDO][v, c])
            assert abs(fd - g) <= 1e-7 * max(1.0, abs(g)), (v, c, fd, g)
    assert float(grad[media.ALBEDO].abs().max()) > 0
