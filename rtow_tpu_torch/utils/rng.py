"""Random sampling for the host-side ray setup (the port of
``rtow_tpu.utils.rng``).

Draws come from an explicit ``torch.Generator`` in place of a JAX key;
each call advances it.  The distributions are the JAX package's (analytic
polar disk sampling, no rejection loop), but not its threefry bits: tests
that compare the two packages pass the same rays to both.

The kernels' own draws are the stateless counter hash below
(:func:`mix`, :func:`hash_uniform`, :func:`step_salt`,
:func:`lane_hash`; ``pallas_megakernel.py:112-122`` in the JAX package,
``csrc/bounce.cuh`` for the kernels), bit for bit.  torch has no logical
right shift on uint32 on the CPU, so the hash runs on int64 tensors (or
Python ints) holding uint32 values.
"""
from __future__ import annotations

import math

import torch

from .dtypes import REAL

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SALT_STRIDE = 40503
INV24 = 1.0 / (1 << 24)


def uniform(gen: torch.Generator, shape=(), lo: float = 0.0, hi: float = 1.0,
            dtype=REAL) -> torch.Tensor:
    """U[lo, hi) of ``shape`` on the generator's device, drawn at float32
    resolution (as ``rtow_tpu.utils.rng.uniform``)."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return (lo + (hi - lo) * u).to(dtype)


def in_unit_disk(gen: torch.Generator, batch_shape=(),
                 dtype=REAL) -> torch.Tensor:
    """Uniform points in the unit disk (z = 0), shape ``batch_shape + (3,)``
    (polar sampling, as ``rtow_tpu.utils.rng.in_unit_disk``)."""
    r = torch.sqrt(uniform(gen, batch_shape, dtype=dtype))
    theta = uniform(gen, batch_shape, 0.0, 2.0 * math.pi, dtype=dtype)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros_like(r)], dim=-1)


def mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix(x):
    """murmur3 finalizer (``pallas_megakernel._mix``, :112)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_uniform(lane, salt, draw: int) -> torch.Tensor:
    """U[0,1) per lane from (lane, salt, draw) (``_uniform``, :122)."""
    h = mix(lane ^ ((salt + ((draw * _GOLDEN) & M32)) & M32))
    return (h >> 8).to(torch.float32) * INV24


def step_salt(seed: int, it: int) -> int:
    """The salt of step ``it``: K1's per-lane step count, the gradient
    bounce's scan step."""
    return mix((seed + it * _SALT_STRIDE) & M32)


def lane_hash(lane_id):
    """A lane's hashed id from its integer id (``_lane_u32``)."""
    return mix(mul32(lane_id & M32, _GOLDEN))
