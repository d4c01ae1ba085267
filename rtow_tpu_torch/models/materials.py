"""Procedural textures (the texture part of ``rtow_tpu.models.materials``,
:137-190): a lattice hash, trilinear value noise and the marble weight of
the NOISE material.

The hash is uint32 arithmetic.  CPU torch has no logical right shift on
uint32, so it runs on int64 tensors holding uint32 values, as
``utils/rng.mix`` does; ``csrc/bounce.cuh`` has the same functions on
uint32 for the kernel.
"""
from __future__ import annotations

import torch

from ..utils.rng import INV24, M32, mul32

_F32 = torch.float32


def _hash01(xi, yi, zi) -> torch.Tensor:
    """Lattice hash of integer coordinates (int64 tensors) -> U[0, 1):
    a murmur3-style finalizer over the three coordinates taken mod
    2**32."""
    h = (mul32(xi & M32, 0x9E3779B1) ^ mul32(yi & M32, 0x85EBCA77)
         ^ mul32(zi & M32, 0xC2B2AE3D))
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h >> 8).to(_F32) * INV24


def value_noise(px, py, pz) -> torch.Tensor:
    """Trilinear hash value noise of float32 points -> [0, 1), with the
    book's smoothstep fade."""
    ix, iy, iz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - ix, py - iy, pz - iz
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    uz = fz * fz * (3.0 - 2.0 * fz)
    # float -> int32 as the JAX package converts, then int64 for the hash.
    xi, yi, zi = (v.to(torch.int32).to(torch.int64) for v in (ix, iy, iz))

    def corner(dx, dy, dz):
        return _hash01(xi + dx, yi + dy, zi + dz)

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(corner(0, 0, 0), corner(1, 0, 0), ux)
    c10 = lerp(corner(0, 1, 0), corner(1, 1, 0), ux)
    c01 = lerp(corner(0, 0, 1), corner(1, 0, 1), ux)
    c11 = lerp(corner(0, 1, 1), corner(1, 1, 1), ux)
    return lerp(lerp(c00, c10, uy), lerp(c01, c11, uy), uz)


def marble_t(px, py, pz, scale) -> torch.Tensor:
    """Marble mix weight in [0, 1]: a z-stripe displaced by 3-octave
    value-noise turbulence, 0.5 (1 + sin(scale z + 10 turb))."""
    turb = (value_noise(px * scale, py * scale, pz * scale)
            + 0.5 * value_noise(px * scale * 2.0 + 17.0,
                                py * scale * 2.0, pz * scale * 2.0)
            + 0.25 * value_noise(px * scale * 4.0,
                                 py * scale * 4.0 + 31.0,
                                 pz * scale * 4.0))
    # A division by a tensor: torch divides a CUDA tensor by a Python
    # scalar as a product with its reciprocal, which rounds otherwise.
    turb = turb / torch.full_like(turb, 1.75)
    return 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * turb))
