"""Constant-density participating media (the port of
``rtow_tpu.ops.volumes``, :52-206): the volume table, the boundary
interval of a ray, the shadow ray's transmittance and the free-flight
volume event.

Media are a small static table of analytic boundaries, sampled once per
bounce after the surface sweep: each volume's boundary interval is
clipped against [1e-3, t_surf], a free-flight distance Exp(sigma) / |d|
is drawn (one uniform per volume), and the nearest event that lands
inside its interval wins and overrides the surface hit (an isotropic
scatter, throughput times the medium's albedo).  These are the plain
PyTorch versions; ``csrc/bounce.cuh`` has the same arithmetic for the
kernel.

The table is (V, 14) float32 (as wide as the light rows, which the
kernel's rows put in front of it):

* sphere "s": cols 0-2 center, 3 radius;
* box "b": cols 0-2 min corner, 3-5 max corner;
* rotated box "r": cols 0-5 the local corners, 7 rotate_y in radians,
  11-13 the translation (world = R(angle) local + T);
* col 6 density, cols 8-10 the scatter albedo.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_BIG = float(np.float32(1e30))


def build_volume_table(scene) -> torch.Tensor:
    """(V, 14) float32 volume rows of ``scene`` on its device."""
    v = scene.volumes
    rows = []
    for k, kind in enumerate(scene.volume_kinds):
        geo = (torch.cat([v.p0[k], v.p1[k][:1], v.p1.new_zeros(2)])
               if kind == "s" else torch.cat([v.p0[k], v.p1[k]]))
        rows.append(torch.cat([geo, v.density[k][None], v.rotate_y[k][None],
                               v.albedo[k], v.translate[k]]).to(_F32))
    return torch.stack(rows)


def _cols(table, k):
    """Volume ``k``'s 14 columns of ``table`` ((V, 14), or (L, V, 14) with
    one copy of the rows per lane): scalars, or (L,) per lane."""
    return table[..., k, :].unbind(-1)


def _interval(row, kind, ox, oy, oz, dx, dy, dz):
    """(t0, t1, valid) of the ray against one volume's boundary (ray
    units of d).  ``row``: the volume's 14 columns (tensors, or floats).
    A rotated box takes the ray into its local frame."""
    if kind == "s":
        cx, cy, cz, r = row[:4]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a = dx * dx + dy * dy + dz * dz
        h = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = h * h - a * c
        # The double-where guard: a lane that misses the sphere must not
        # take sqrt'(0) into the gradient (JAX volumes.py:128-134).
        deg = disc <= 0.0
        sq = torch.where(deg, 0.0, torch.sqrt(torch.where(deg, 1.0, disc)))
        inv_a = 1.0 / torch.clamp(a, min=1e-24)
        return (-h - sq) * inv_a, (-h + sq) * inv_a, disc > 0.0
    x0, y0, z0, x1, y1, z1 = row[:6]
    if kind == "r":
        th = torch.as_tensor(row[7], dtype=_F32, device=ox.device)
        c, sn = torch.cos(th), torch.sin(th)
        wx, wy, wz = ox - row[11], oy - row[12], oz - row[13]
        ox, oz = c * wx - sn * wz, sn * wx + c * wz
        oy = wy
        dx, dz = c * dx - sn * dz, sn * dx + c * dz

    def axis(o, d, lo, hi):
        small = torch.where(d < 0, -1e-24, 1e-24)
        inv = 1.0 / torch.where(d.abs() < 1e-24, small, d)
        ta, tb = (lo - o) * inv, (hi - o) * inv
        return torch.minimum(ta, tb), torch.maximum(ta, tb)

    ax0, ax1 = axis(ox, dx, x0, x1)
    ay0, ay1 = axis(oy, dy, y0, y1)
    az0, az1 = axis(oz, dz, z0, z1)
    t0 = torch.maximum(torch.maximum(ax0, ay0), az0)
    t1 = torch.minimum(torch.minimum(ax1, ay1), az1)
    return t0, t1, t0 < t1


def volume_transmittance(table, volume_kinds, ox, oy, oz, dx, dy, dz,
                         t_max):
    """exp(-sum_k sigma_k * overlap_k) along [0, t_max] of the ray: the
    medium attenuation a shadow ray carries."""
    dlen = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    tau = torch.zeros_like(ox)
    for k, kind in enumerate(volume_kinds):
        row = _cols(table, k)
        t0, t1, valid = _interval(row, kind, ox, oy, oz, dx, dy, dz)
        t_in = torch.clamp(t0, min=0.0)
        t_out = torch.minimum(t1, t_max)
        overlap = torch.clamp(t_out - t_in, min=0.0)
        tau = tau + torch.where(valid, row[6] * overlap * dlen, 0.0)
    return torch.exp(-tau)


def sample_volume_event(table, volume_kinds, us, ox, oy, oz, dx, dy, dz,
                        t_surf):
    """Per-lane free flight -> (v_hit, t_v, (ar, ag, ab)).

    ``us``: one per-lane uniform per volume; ``t_surf``: the surface
    sweep's t (a huge value on a miss).  The nearest event that lands
    inside its volume's clipped interval wins.  t_v is differentiable in
    the winner's density and boundary and in the ray; which event wins
    is a comparison, a constant for autograd."""
    dlen = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    t_v = torch.full_like(ox, _BIG)
    zero = torch.zeros_like(ox)
    ar = ag = ab = zero
    for k, kind in enumerate(volume_kinds):
        row = _cols(table, k)
        t0, t1, valid = _interval(row, kind, ox, oy, oz, dx, dy, dz)
        t_in = torch.clamp(t0, min=1e-3)
        t_out = torch.minimum(t1, t_surf)
        # A divisor as wide as the lanes: torch divides a CUDA tensor by a
        # scalar as a product with its reciprocal, which rounds otherwise.
        sigma = torch.clamp(row[6], min=1e-12).expand_as(ox)
        step = -torch.log(torch.clamp(us[k], min=1e-12)) / sigma / dlen
        t_k = t_in + step
        ok = valid & (t_in < t_out) & (t_k < t_out)
        win = ok & (t_k < t_v)
        t_v = torch.where(win, t_k, t_v)
        ar = torch.where(win, row[8], ar)
        ag = torch.where(win, row[9], ag)
        ab = torch.where(win, row[10], ab)
    return t_v < _BIG, t_v, (ar, ag, ab)
