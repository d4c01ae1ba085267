"""The port's constant-density media (``rtow_tpu_torch/ops/volumes.py``)
against ``rtow_tpu.ops.volumes`` on the CPU.

Tolerances:

* ``build_volume_table``: EXACTLY equal (float32 rows from bit-equal
  leaves);
* ``_interval`` for spheres and boxes within 1e-6 relative (plus 1e-6
  absolute): the same float32 operations in the same order, but XLA may
  contract a multiply-add (the sphere's h * h - a * c); for the rotated
  box within 1e-5 relative (plus 1e-5 absolute): it inverse-rotates the
  ray by a float32 cos / sin, whose last bit XLA and PyTorch may round
  apart;
* ``volume_transmittance`` and ``sample_volume_event`` on rays made from
  a numpy seed: the event flags equal, t and the transmittance within
  1e-5 relative (plus 1e-6 absolute);
* the analytic gate of ``tests/test_volumes.py``: an absorbing slab of
  density sigma and thickness L passes exp(-sigma L) (1e-5 relative),
  and a rotated box's chord is 2 / cos(theta).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtow_tpu.models import builders as jax_builders
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import volumes as jv
from rtow_tpu_torch.models import builders
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import volumes


def _fogs(builder_cls):
    """One volume of each kind, overlapping, around the origin."""
    b = builder_cls()
    b.add_sphere((0.0, -100.0, 0.0), 100.0, b.add_lambertian((0.5,) * 3))
    b.add_fog_sphere((0.3, 0.8, 0.0), 0.9, 1.7, albedo=(0.9, 0.8, 0.7))
    b.add_fog_box((-1.0, 0.0, -1.0), (0.5, 1.5, 1.0), 0.6,
                  translate=(0.2, 0.0, 0.1))
    b.add_fog_box((0.0, 0.0, 0.0), (1.2, 0.9, 1.2), 2.3,
                  albedo=(0.1, 0.2, 0.3), rotate_y=-27.0,
                  translate=(-0.4, 0.1, -0.6))
    return (b.build() if builder_cls is JaxSceneBuilder
            else b.build(device="cpu"))


SCENES = {
    "fogs": lambda: (_fogs(JaxSceneBuilder), _fogs(SceneBuilder)),
    "smoke": lambda: (jax_builders.smoke_scene(1.0)[0],
                      builders.smoke_scene(1.0, device="cpu")[0]),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_volume_table_equals_jax(name):
    jscene, scene = SCENES[name]()
    assert scene.volume_kinds == jscene.volume_kinds
    want, _albedo = jv.build_volume_table(jscene)
    got = volumes.build_volume_table(scene).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(np.asarray(jv.pack_volume_rows(jscene)),
                                  got)


def _rays(n=4096, seed=4):
    """Rays from around the volumes, raw directions of random length."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (3, n)).astype(np.float32)
    target = rng.uniform(-1.0, 1.5, (3, n)).astype(np.float32)
    d = (target - o) * rng.uniform(0.2, 3.0, n).astype(np.float32)
    d[:, :8] = np.float32([[0.0], [1.0], [0.0]])  # axis-parallel rays
    return o, d


@pytest.mark.parametrize("k", [0, 1, 2])
def test_interval_matches_jax(k):
    jscene, scene = SCENES["fogs"]()
    jt, _ = jv.build_volume_table(jscene)
    row = volumes.build_volume_table(scene)[k].tolist()
    kind = scene.volume_kinds[k]
    assert kind == "sbr"[k]
    o, d = _rays()
    want = jv._interval(jt, k, kind, *map(jnp.asarray, (*o, *d)))
    got = volumes._interval(row, kind, *map(torch.from_numpy, (*o, *d)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    valid = got[2].numpy()
    assert 0.05 < valid.mean() < 0.95
    for g, w in zip(got[:2], want[:2]):
        g, w = g.numpy()[valid], np.asarray(w)[valid]
        if kind == "r":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_transmittance_and_event_match_jax():
    jscene, scene = SCENES["fogs"]()
    kinds = scene.volume_kinds
    jt, jalb = jv.build_volume_table(jscene)
    tt = volumes.build_volume_table(scene)
    o, d = _rays(seed=6)
    rng = np.random.default_rng(7)
    t_max = rng.uniform(0.1, 3.0, o.shape[1]).astype(np.float32)
    t_max[::5] = np.float32(3.0e38)  # a miss: the sweep's BIG
    us = rng.random((len(kinds), o.shape[1]), dtype=np.float32)
    us[:, :4] = np.float32(0.0)  # floored at 1e-12
    jargs = tuple(map(jnp.asarray, (*o, *d)))
    targs = tuple(map(torch.from_numpy, (*o, *d)))

    want = np.asarray(jv.volume_transmittance(jt, kinds, *jargs,
                                              jnp.asarray(t_max)))
    got = volumes.volume_transmittance(tt, kinds, *targs,
                                       torch.from_numpy(t_max)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert 0.05 < (got < 1.0).mean() < 0.95

    jhit, jtv, jal = jv.sample_volume_event(
        jt, jalb, kinds, tuple(map(jnp.asarray, us)), *jargs,
        jnp.asarray(t_max))
    hit, tv, al = volumes.sample_volume_event(
        tt, kinds, tuple(map(torch.from_numpy, us)), *targs,
        torch.from_numpy(t_max))
    hit = hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(jhit))
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_allclose(tv.numpy()[hit], np.asarray(jtv)[hit],
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(al, jal):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _one_volume(**kw):
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 50.0), 0.5, b.add_lambertian((0.5,) * 3))
    b.add_fog_box(**kw)
    scene = b.build(device="cpu")
    return volumes.build_volume_table(scene), scene.volume_kinds


def _transmittance(table, kinds, o, d, t_max=100.0):
    o = torch.tensor(o, dtype=torch.float32)[:, None]
    d = torch.tensor(d, dtype=torch.float32)[:, None]
    return float(volumes.volume_transmittance(
        table, kinds, *o, *d, torch.full((1,), t_max))[0])


def test_absorbing_slab_transmittance_is_exact():
    sigma, slab = 0.7, 2.0
    table, kinds = _one_volume(p_min=(-20, -20, 0.0), p_max=(20, 20, slab),
                               density=sigma, albedo=(0.0, 0.0, 0.0))
    for o, d in (((0, 0, 3.0), (0, 0, -1.0)), ((1.0, -2.0, 5.0),
                                                (0, 0, -2.5))):
        assert _transmittance(table, kinds, o, d) == pytest.approx(
            np.exp(-sigma * slab), rel=1e-5)
    # A ray that stops inside the slab sees only its part of it.
    assert _transmittance(table, kinds, (0, 0, 3.0), (0, 0, -1.0),
                          t_max=2.0) == pytest.approx(np.exp(-sigma * 1.0),
                                                      rel=1e-5)


def test_rotated_box_chord():
    sigma = 0.9
    table, kinds = _one_volume(p_min=(-1.0, -1.0, -1.0),
                               p_max=(1.0, 1.0, 1.0), density=sigma,
                               rotate_y=30.0, translate=(0.0, 5.0, 0.0))
    assert kinds == ("r",)
    chord = 2.0 / np.cos(np.radians(30.0))
    assert _transmittance(table, kinds, (-10, 5.0, 0), (1, 0, 0)) == \
        pytest.approx(np.exp(-chord * sigma), rel=1e-4)
    assert _transmittance(table, kinds, (0, 0, 0), (0, 1, 0)) == \
        pytest.approx(np.exp(-2.0 * sigma), rel=1e-4)
