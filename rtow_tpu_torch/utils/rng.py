"""Random sampling for the host-side ray setup (the port of
``rtow_tpu.utils.rng``).

Draws come from an explicit ``torch.Generator`` in place of a JAX key;
each call advances it.  The distributions are the JAX package's (analytic
polar disk sampling, no rejection loop), but not its threefry bits: tests
that compare the two packages pass the same rays to both.  The kernels'
own draws are the counter hash of ``ops/megakernel.py`` and do not use
this module.
"""
from __future__ import annotations

import math

import torch

from .dtypes import REAL


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
