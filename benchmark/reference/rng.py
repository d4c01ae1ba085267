"""The path tracer's random numbers, as its semantics fix them.

Every bounce draws from a stateless counter hash: a lane's hashed id,
the step's salt and a draw number go through a murmur3 finalizer, and
the top 24 bits make a uniform in [0, 1).  The hash is uint32
arithmetic; it runs on int64 tensors holding uint32 values (the CPU has
no logical right shift on uint32).  Camera rays of the gradient path and
of the sorted wavefront come from a ``torch.Generator`` instead
(:mod:`.camera`).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SALT_STRIDE = 40503
INV24 = 1.0 / (1 << 24)
TWO_PI = float(np.float32(2.0 * np.pi))


def mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32), in int64 without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix(x):
    """The murmur3 finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def step_salt(seed: int, it: int) -> int:
    """The salt of step ``it`` under ``seed``."""
    return mix((seed + it * SALT_STRIDE) & M32)


def lane_hash(lane_id):
    """A lane's hashed id from its integer id (an int64 tensor)."""
    return mix(mul32(lane_id & M32, GOLDEN))


def uniform(lane, salt: int, draw: int, dtype) -> torch.Tensor:
    """U[0, 1) of each lane for (salt, draw), in ``dtype``."""
    h = mix(lane ^ ((salt + ((draw * GOLDEN) & M32)) & M32))
    return (h >> 8).to(dtype) * INV24


def scatter_draws(lane, salt: int, dtype):
    """A bounce's draws: a uniform unit vector (draws 5, 6) and the
    dielectric's choice (draw 7)."""
    uz = 1.0 - 2.0 * uniform(lane, salt, 5, dtype)
    uu = uniform(lane, salt, 6, dtype)
    uxy = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
    uph = TWO_PI * uu
    return (uxy * torch.cos(uph), uxy * torch.sin(uph), uz,
            uniform(lane, salt, 7, dtype))
