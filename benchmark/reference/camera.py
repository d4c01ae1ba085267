"""The thin-lens camera with a shutter (the book's ``camera::get_ray``).

The basis is built in numpy float64 and cast once to the tracing dtype.
Two ways of making camera rays are part of what an image is:

* :func:`generator_rays`, for the gradient path and the sorted wavefront:
  jittered pixel coordinates, the lens offset and the shutter time drawn
  from a ``torch.Generator``, in that order, five draws over all lanes;
* :func:`counter_ray`, for the whole-frame render: the same quantities
  from the counter hash (draws 0 to 4) of the lane's slot.

The arithmetic is written as the port's semantics round it, so the same
draws give the same rays bit for bit in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .rng import TWO_PI, uniform

_FIELDS = ("origin", "u", "v", "w", "horizontal", "vertical", "lower_left",
           "lens_radius", "t0", "t1")


class Camera(NamedTuple):
    origin: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    lower_left: torch.Tensor
    lens_radius: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor


def make_camera(spec: dict, device, dtype) -> Camera:
    """The camera from its look-from, look-at, up, vertical field of view
    (degrees), aspect ratio, aperture, focus distance (None: the look
    distance) and shutter, built in float64 and cast once to ``dtype``."""
    lookfrom = np.asarray(spec["lookfrom"], np.float64)
    lookat = np.asarray(spec["lookat"], np.float64)
    vup = np.asarray(spec.get("vup", (0.0, 1.0, 0.0)), np.float64)
    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    v = v / np.linalg.norm(v)
    height = 2.0 * math.tan(math.radians(spec["fov_degrees"]) / 2.0)
    width = spec["aspect_ratio"] * height
    fd = spec.get("focus_dist")
    fd = float(np.linalg.norm(lookfrom - lookat)) if fd is None else float(fd)
    horizontal = fd * width * u
    vertical = fd * height * v
    basis = dict(origin=lookfrom, u=u, v=v, w=w, horizontal=horizontal,
                 vertical=vertical,
                 lower_left=lookfrom - horizontal / 2.0 - vertical / 2.0
                 - fd * w,
                 lens_radius=spec["aperture"] / 2.0, t0=spec.get("t0", 0.0),
                 t1=spec.get("t1", 0.0))
    return Camera(**{f: torch.as_tensor(np.asarray(basis[f], np.float64))
                     .to(device=device, dtype=dtype) for f in _FIELDS})


def _draw(gen: torch.Generator, n: int, lo: float, hi: float, dtype):
    u = torch.rand((n,), generator=gen, device=gen.device,
                   dtype=torch.float32)
    return (lo + (hi - lo) * u).to(dtype)


def generator_rays(cam: Camera, gen: torch.Generator, pixel_ids, width: int,
                   height: int):
    """Camera rays of ``pixel_ids`` (one lane each, row 0 at the top),
    drawn from ``gen`` -> (origin (L, 3), direction (L, 3), time (L,))."""
    dtype = cam.origin.dtype
    n = pixel_ids.numel()
    row = pixel_ids // width
    col = pixel_ids % width
    ju = _draw(gen, n, 0.0, 1.0, dtype)
    jv = _draw(gen, n, 0.0, 1.0, dtype)
    s = (col.to(dtype) + ju) / (width - 1)
    t = ((height - 1 - row).to(dtype) + jv) / (height - 1)
    r = torch.sqrt(_draw(gen, n, 0.0, 1.0, dtype))
    theta = _draw(gen, n, 0.0, 2.0 * math.pi, dtype)
    disk = torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros_like(r)], dim=-1)
    rd = cam.lens_radius * disk
    offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v
    origin = cam.origin + offset
    direction = (cam.lower_left + s[..., None] * cam.horizontal
                 + t[..., None] * cam.vertical - origin)
    time = _draw(gen, n, 0.0, 1.0, dtype) * (cam.t1 - cam.t0) + cam.t0
    return origin, direction, time


def packed(cam: Camera) -> list:
    """The camera as the whole-frame render reads it: 21 numbers, the
    shutter's length taken in the tracing dtype."""
    c = cam
    vec = torch.stack([
        c.origin[0], c.origin[1], c.origin[2], c.u[0], c.u[1], c.u[2],
        c.v[0], c.v[1], c.v[2], c.lower_left[0], c.lower_left[1],
        c.lower_left[2], c.horizontal[0], c.horizontal[1], c.horizontal[2],
        c.vertical[0], c.vertical[1], c.vertical[2], c.lens_radius, c.t0,
        c.t1 - c.t0])
    return [float(x) for x in vec.cpu()]


def counter_ray(cam: list, lane, salt: int, fcol, frow, inv_w: float,
                inv_h: float, dtype):
    """A camera ray through pixel column ``fcol`` and flipped row
    ``frow`` from the counter hash -> (ox, oy, oz, dx, dy, dz, time)."""
    (cox, coy, coz, cux, cuy, cuz, cvx, cvy, cvz, llx, lly, llz,
     chx, chy, chz, cwx, cwy, cwz, lens_r, t0, dt) = cam
    s = (fcol + uniform(lane, salt, 0, dtype)) * inv_w
    t = (frow + uniform(lane, salt, 1, dtype)) * inv_h
    rad_l = lens_r * torch.sqrt(uniform(lane, salt, 2, dtype))
    th = TWO_PI * uniform(lane, salt, 3, dtype)
    lx = rad_l * torch.cos(th)
    ly = rad_l * torch.sin(th)
    nox = cox + lx * cux + ly * cvx
    noy = coy + lx * cuy + ly * cvy
    noz = coz + lx * cuz + ly * cvz
    return (nox, noy, noz, llx + s * chx + t * cwx - nox,
            lly + s * chy + t * cwy - noy, llz + s * chz + t * cwz - noz,
            t0 + uniform(lane, salt, 4, dtype) * dt)
