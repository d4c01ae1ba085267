"""Thin-lens camera with defocus blur and a motion-blur shutter (the
port of ``rtow_tpu.models.camera``).

Same optical model as the reference Camera (reference
src/common-model.cpp:136-167): look-from/look-at/up basis, vertical
field of view in degrees, focus plane spanned by ``horizontal`` /
``vertical``, aperture jitter in the lens disk, and a ray time in the
shutter interval [t0, t1].  The megakernel generates its camera rays
itself (ops/megakernel.py); :func:`camera_rays` and :func:`pixel_coords`
build them on the host side for the gradient path (ops/grad.py), from a
``torch.Generator`` in place of a JAX key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..utils import rng
from ..utils.dtypes import REAL


class Rays(NamedTuple):
    origin: torch.Tensor  # (L, 3)
    direction: torch.Tensor  # (L, 3), not normalised (the reference's)
    time: torch.Tensor  # (L,)


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
    device="cuda",
) -> Camera:
    """Construct the camera basis (reference src/common-model.cpp:136-154)
    in numpy float64, cast once to ``dtype``, on ``device`` (raises where
    CUDA is asked for and there is no card).

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
    device = resolve_device(device)

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


def camera_rays(cam: Camera, gen: torch.Generator, s: torch.Tensor,
                t: torch.Tensor) -> Rays:
    """Vectorised ``Camera::get_ray`` (reference src/common-model.cpp:
    156-167; ``rtow_tpu.models.camera.camera_rays``, :102).

    ``s`` / ``t`` are (L,) viewport coordinates in [0, 1]; each ray gets
    its own lens-disk offset and shutter time from ``gen``, which lives
    on the camera's device."""
    dtype = cam.origin.dtype
    rd = cam.lens_radius * rng.in_unit_disk(gen, s.shape, dtype=dtype)
    offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v
    origin = cam.origin + offset
    direction = (cam.lower_left + s[..., None] * cam.horizontal
                 + t[..., None] * cam.vertical - origin)
    time = (rng.uniform(gen, s.shape, dtype=dtype) * (cam.t1 - cam.t0)
            + cam.t0)
    return Rays(origin=origin, direction=direction, time=time)


def pixel_coords(image_width: int, image_height: int, gen: torch.Generator,
                 pixel_ids: torch.Tensor, dtype=REAL):
    """Jittered viewport (s, t) of flat pixel ids (row-major, row 0 at the
    top), the reference's ``u=(j+rand)/(W-1)``, ``v=(from_top+rand)/(H-1)``
    (src/render.cpp:157-159; ``rtow_tpu.models.camera.pixel_coords``,
    :127)."""
    row = pixel_ids // image_width
    col = pixel_ids % image_width
    ju = rng.uniform(gen, pixel_ids.shape, dtype=dtype)
    jv = rng.uniform(gen, pixel_ids.shape, dtype=dtype)
    s = (col.to(dtype) + ju) / (image_width - 1)
    t = ((image_height - 1 - row).to(dtype) + jv) / (image_height - 1)
    return s, t
