"""The port's next-event estimation (``rtow_tpu_torch/ops/lights.py``)
against ``rtow_tpu.ops.lights`` on the CPU.

Tolerances:

* ``build_light_table``: EXACTLY equal (both build the rows in float32
  from bit-equal scene leaves, in ``light_ids`` order);
* ``sample_light_dirs`` and ``light_pdf_toward`` on points and uniforms
  made from a numpy seed: within 1e-5 relative (plus 1e-6 absolute near
  zero) on at least 99.9% of lanes and within 1e-4 on all: XLA's and
  PyTorch's float32 sin/cos and multiply-add contraction differ in the
  last bit, and a small sphere light's 1 - cos(theta_max) cancels (one
  ulp of cos(theta_max) is 1.5e-5 of the pdf for a light of radius 0.4
  at distance 4.3);
* the sampler's pdf and the evaluator's pdf of the sampled direction at
  the sampled distance agree within 2e-3 relative, as
  ``tests/test_emissive.py::test_mis_pdf_pairing`` holds the JAX pair.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtow_tpu.models import builders as jax_builders
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import lights as jl
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import lights


def _mixed(builder_cls):
    """Sphere lights (one moving), triangle lights and a quad light, in
    an order that interleaves kinds, under a ground."""
    b = builder_cls()
    lamp = b.add_light((5.0, 4.0, 3.0))
    tlamp = b.add_light((2.0, 2.5, 1.0))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((2.0, 3.0, -1.0), 1.2, lamp)
    b.add_triangle((-3.0, 4.0, -2.0), (1.0, 4.0, -2.0), (-1.0, 4.0, 2.0),
                   tlamp)
    b.add_moving_sphere((-2.0, 2.5, 1.0), (-2.0, 3.0, 1.5), 0.4, lamp)
    b.add_quad((-1.0, 5.0, -1.0), (1.0, 5.0, -1.0), (1.0, 5.0, 1.0),
               (-1.0, 5.0, 1.0), tlamp)
    return (b.build(background=(0.0, 0.0, 0.0)) if builder_cls is
            JaxSceneBuilder else b.build(background=(0.0, 0.0, 0.0),
                                         device="cpu"))


SCENES = {
    "mixed": lambda: (_mixed(JaxSceneBuilder), _mixed(SceneBuilder)),
    "lights": lambda: (jax_builders.light_scene(1.0)[0],
                       builders.light_scene(1.0, device="cpu")[0]),
    "cornell": lambda: (jax_builders.cornell_scene(1.0)[0],
                        builders.cornell_scene(1.0, device="cpu")[0]),
    "smoke": lambda: (jax_builders.smoke_scene(1.0)[0],
                      builders.smoke_scene(1.0, device="cpu")[0]),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_light_table_equals_jax(name):
    jscene, scene = SCENES[name]()
    assert scene.light_ids == jscene.light_ids
    want = np.asarray(jl.build_light_table(jscene))
    got = lights.build_light_table(scene).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_light_table_without_lights_is_one_zero_row():
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_lambertian((0.5,) * 3))
    got = lights.build_light_table(b.build(device="cpu"))
    assert got.shape == (1, 14) and not got.any()


def _lanes(n=4096, seed=3):
    """Uniforms and shading points: above the ground, and a few inside
    the first sphere light."""
    rng = np.random.default_rng(seed)
    pick, u1, u2 = rng.random((3, n), dtype=np.float32)
    p = rng.uniform(-3.0, 3.0, (3, n)).astype(np.float32)
    p[1] = np.abs(p[1]) + np.float32(0.01)
    # Inside sphere light 0, and picking it: degenerate samples.
    p[:, :16] = np.float32([[2.0], [3.0], [-1.0]])
    pick[:16] = np.float32(0.05)
    tm = rng.random(n, dtype=np.float32)
    return pick, u1, u2, p, tm


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    off = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-6
    assert off.mean() <= 1e-3, f"{off.sum()} lanes off by > 1e-5 relative"


def test_sample_light_dirs_matches_jax():
    jscene, scene = SCENES["mixed"]()
    kinds = tuple(k for k, _ in scene.light_ids)
    jt, tt = jl.build_light_table(jscene), lights.build_light_table(scene)
    pick, u1, u2, p, tm = _lanes()
    want = jl.sample_light_dirs(jt, kinds, *map(jnp.asarray,
                                                (pick, u1, u2, *p, tm)))
    got = lights.sample_light_dirs(tt, kinds, *map(torch.from_numpy,
                                                   (pick, u1, u2, *p, tm)))
    (jdx, jdy, jdz, jtl, jw, jpdf), (dx, dy, dz, tl, w, pdf) = want, got
    for g, wt in zip((dx, dy, dz, tl, *w, pdf),
                     (jdx, jdy, jdz, jtl, *jw, jpdf)):
        _close(g.numpy(), wt)
    pdf = pdf.numpy()
    assert (pdf[:16] == 0).all()  # inside the light: degenerate
    assert (pdf[16:] > 0).mean() > 0.5


def test_light_pdf_toward_matches_jax():
    """Rays toward sampled light points (raw directions of random length,
    the distance in their units), half of them with a distance that
    misses the light's."""
    jscene, scene = SCENES["mixed"]()
    kinds = tuple(k for k, _ in scene.light_ids)
    jt, tt = jl.build_light_table(jscene), lights.build_light_table(scene)
    pick, u1, u2, p, tm = _lanes(seed=9)
    dx, dy, dz, t_l = (v.numpy() for v in lights.sample_light_dirs(
        tt, kinds, *map(torch.from_numpy, (pick, u1, u2, *p, tm)))[:4])
    rng = np.random.default_rng(10)
    scale = rng.uniform(0.3, 2.0, dx.size).astype(np.float32)
    t_hit = t_l / scale
    t_hit[::2] *= np.float32(1.5)
    args = (*p, dx * scale, dy * scale, dz * scale, t_hit, tm)
    want = np.asarray(jl.light_pdf_toward(jt, kinds, *map(jnp.asarray,
                                                          args)))
    got = lights.light_pdf_toward(tt, kinds, *map(torch.from_numpy,
                                                  args)).numpy()
    _close(got, want)
    assert (got[1::2] > 0).mean() > 0.5 and (got[::2] > 0).mean() < 0.05


def test_mis_pdf_pairing():
    """The sampler's pdf of a light direction equals the evaluator's pdf
    of that ray at the sampled distance, so the two balance weights sum
    to 1."""
    _, scene = SCENES["mixed"]()
    kinds = tuple(k for k, _ in scene.light_ids)
    table = lights.build_light_table(scene)
    n = 512
    rng = np.random.default_rng(11)
    pick, u1, u2 = map(torch.from_numpy, rng.random((3, n),
                                                    dtype=np.float32))
    px = torch.linspace(-2.0, 2.0, n)
    py = torch.zeros(n) + 0.01
    pz = torch.linspace(-1.5, 1.5, n)
    tm = torch.zeros(n)
    dx, dy, dz, t_l, _w, pdf = lights.sample_light_dirs(
        table, kinds, pick, u1, u2, px, py, pz, tm)
    back = lights.light_pdf_toward(table, kinds, px, py, pz, dx, dy, dz,
                                   t_l, tm)
    ok = pdf > 0
    assert float(ok.float().mean()) > 0.9
    np.testing.assert_allclose(back[ok].numpy(), pdf[ok].numpy(), rtol=2e-3)
