"""Thin-lens camera with defocus blur and a motion-blur shutter (the
port of ``rtow_tpu.models.camera``).

Same optical model as the reference Camera (reference
src/common-model.cpp:136-167): look-from/look-at/up basis, vertical
field of view in degrees, focus plane spanned by ``horizontal`` /
``vertical``, aperture jitter in the lens disk, and a ray time in the
shutter interval [t0, t1].  Camera rays themselves are generated inside
the megakernel (ops/megakernel.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch

from ..utils.dtypes import REAL

_FIELDS = ("origin", "u", "v", "w", "horizontal", "vertical", "lower_left",
           "lens_radius", "t0", "t1")


@dataclasses.dataclass
class Camera:
    origin: torch.Tensor  # (3,)
    u: torch.Tensor  # (3,) camera-right
    v: torch.Tensor  # (3,) camera-up
    w: torch.Tensor  # (3,) camera-back (view dir = -w)
    horizontal: torch.Tensor  # (3,) focus-plane x extent
    vertical: torch.Tensor  # (3,) focus-plane y extent
    lower_left: torch.Tensor  # (3,) focus-plane corner
    lens_radius: torch.Tensor  # ()
    t0: torch.Tensor  # () shutter open
    t1: torch.Tensor  # () shutter close

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], device,
                   dtype=REAL) -> "Camera":
        """Build from the JAX camera's leaves given as numpy arrays
        keyed by field name (``"origin"``, ..., ``"t1"``)."""
        return cls(**{
            f: torch.tensor(np.asarray(arrays[f]), dtype=dtype,
                            device=device)
            for f in _FIELDS
        })


def make_camera(
    lookfrom,
    lookat,
    vup=(0.0, 1.0, 0.0),
    fov_degrees: float = 90.0,
    aspect_ratio: float = 16.0 / 9.0,
    aperture: float = 0.0,
    focus_dist: Optional[float] = None,
    t0: float = 0.0,
    t1: float = 0.0,
    dtype=REAL,
    device="cpu",
) -> Camera:
    """Construct the camera basis (reference src/common-model.cpp:136-154)
    in numpy float64, cast once to ``dtype``.

    ``focus_dist=None`` defaults to the look distance, as in the
    reference."""
    lookfrom = np.asarray(lookfrom, dtype=np.float64)
    lookat = np.asarray(lookat, dtype=np.float64)
    vup = np.asarray(vup, dtype=np.float64)

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    v = v / np.linalg.norm(v)

    viewport_height = 2.0 * math.tan(math.radians(fov_degrees) / 2.0)
    viewport_width = aspect_ratio * viewport_height
    fd = (float(focus_dist) if focus_dist is not None
          else float(np.linalg.norm(lookfrom - lookat)))

    horizontal = fd * viewport_width * u
    vertical = fd * viewport_height * v
    lower_left = lookfrom - horizontal / 2.0 - vertical / 2.0 - fd * w

    def real(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(device=device,
                                                             dtype=dtype)

    return Camera(
        origin=real(lookfrom),
        u=real(u),
        v=real(v),
        w=real(w),
        horizontal=real(horizontal),
        vertical=real(vertical),
        lower_left=real(lower_left),
        lens_radius=real(aperture / 2.0),
        t0=real(t0),
        t1=real(t1),
    )
