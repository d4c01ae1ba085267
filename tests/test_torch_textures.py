"""The port's procedural textures (``rtow_tpu_torch/models/materials.py``)
against ``rtow_tpu.models.materials`` on the CPU, on points made from a
numpy seed.

Tolerances: the lattice hash is integer arithmetic and agrees EXACTLY;
``value_noise`` and ``marble_t`` agree within 1e-6 (``marble_t`` ends in a
float32 sin, whose last bit XLA and PyTorch may round apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtow_tpu.models import materials as jmat
from rtow_tpu_torch.models import materials as mat


@pytest.fixture(scope="module")
def points():
    """Points of both signs and a few magnitudes, float32."""
    rng = np.random.default_rng(5)
    scale = np.repeat([0.5, 3.0, 40.0, 1000.0], 5000)
    return (rng.standard_normal((3, scale.size)) * scale).astype(np.float32)


def test_hash01_bit_equal():
    rng = np.random.default_rng(1)
    ijk = rng.integers(-2**31, 2**31, (3, 50_000), dtype=np.int64)
    ijk[:, :6] = [[0, -1, 2**31 - 1, -2**31, 7, 123456789]] * 3
    want = np.asarray(jmat._hash01(*(jnp.asarray(v.astype(np.int32))
                                     for v in ijk)))
    got = mat._hash01(*map(torch.from_numpy, ijk)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() < 1.0


def test_value_noise_matches(points):
    want = np.asarray(jmat.value_noise(*map(jnp.asarray, points)))
    got = mat.value_noise(*map(torch.from_numpy, points)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0.0 <= got.min() and got.max() < 1.0


@pytest.mark.parametrize("scale", [3.0, 6.0, 0.25])
def test_marble_t_matches(points, scale):
    p = points / np.float32(40.0)
    s = np.full(p.shape[1], scale, np.float32)
    want = np.asarray(jmat.marble_t(*map(jnp.asarray, p), jnp.asarray(s)))
    got = mat.marble_t(*map(torch.from_numpy, p), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
