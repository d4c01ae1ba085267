"""Next-event estimation: the light table, the light sampler and the
light-strategy pdf of a direction (the port of ``rtow_tpu.ops.lights``,
:71-322).

At every diffuse hit the bounce samples a point on a light, casts one
shadow ray and adds the direct contribution, balanced (MIS, balance
heuristic) against the scatter strategy; the scattered ray's emissive
hit carries the paired weight.  These are the plain PyTorch versions;
``csrc/bounce.cuh`` has the same arithmetic for the kernel, in the same
order.

The table is (K, 14) float32, one row per emissive primitive in
``scene.light_ids`` order (triangles indexed as built, before the
triangle table's median-split reorder):

* sphere: cols 1-3 center0, 4-6 dcenter, 7 radius;
* triangle: cols 1-3 v0, 4-6 e1, 7-9 e2, 10 area;
* cols 11-13 the emitted radiance; col 0 the kind (0 sphere, 1 triangle),
  which nothing reads: the kinds are the static ``light_kinds`` tuple.

The sampler and the pdf read the table as tensors, so autograd carries
cotangents into its rows (the gradient path's light-row cotangent).  A
table may also hold one copy of the rows per lane, (L, K, 14): every
read is ``table[..., k, c]``, so each lane's rows get their own
cotangent.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
LIGHT_COLS = 14

# The JAX expressions' constants, rounded to float32 as XLA rounds them.
TWO_PI = float(np.float32(2.0 * np.pi))
_PI = float(np.float32(np.pi))


def build_light_table(scene, mats=None) -> torch.Tensor:
    """(K, 14) float32 light rows of ``scene`` on its device; one zero row
    when it has no lights.  ``mats``, the material of each light as an
    int (``tables.grad_layout`` reads them once), spares the host a read
    of each light's material from the card."""
    f32 = _F32
    dev = scene.device
    rows = []
    for j, (kind, i) in enumerate(scene.light_ids):
        if kind == "s":
            sp = scene.spheres
            emit = scene.materials.albedo[
                sp.material[i].long() if mats is None else mats[j]]
            rows.append(torch.cat([
                torch.zeros(1, dtype=f32, device=dev), sp.center0[i],
                sp.dcenter[i], sp.radius[i][None],
                torch.zeros(3, dtype=f32, device=dev), emit]).to(f32))
        else:
            v = scene.triangles.verts[i].to(f32)
            v0, e1, e2 = v[0], v[1] - v[0], v[2] - v[0]
            cx = e1[1] * e2[2] - e1[2] * e2[1]
            cy = e1[2] * e2[0] - e1[0] * e2[2]
            cz = e1[0] * e2[1] - e1[1] * e2[0]
            area = 0.5 * torch.sqrt(cx * cx + cy * cy + cz * cz)
            emit = scene.materials.albedo[
                scene.triangles.material[i].long() if mats is None
                else mats[j]]
            rows.append(torch.cat([
                torch.ones(1, dtype=f32, device=dev), v0, e1, e2,
                area[None], emit]).to(f32))
    if not rows:
        return torch.zeros((1, LIGHT_COLS), dtype=f32, device=dev)
    return torch.stack(rows)


def _onb(wx, wy, wz):
    """Branchless orthonormal basis around unit w (Frisvad / Duff)."""
    sign = torch.where(wz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + wz)
    b = wx * wy * a
    ux = 1.0 + sign * wx * wx * a
    uy = sign * b
    uz = -sign * wx
    vx = b
    vy = sign + wy * wy * a
    vz = -wy
    return (ux, uy, uz), (vx, vy, vz)


def _sqrt_pos(x, floor=0.0):
    """sqrt(x) where x > floor, else 0 (the JAX code's double-where
    guard, forward values only)."""
    deg = x <= floor
    return torch.where(deg, 0.0, torch.sqrt(torch.where(deg, 1.0, x)))


def sample_light_dirs(table, light_kinds, pick, u1, u2, px, py, pz, tm):
    """Per-lane light sample -> (dx, dy, dz, t_light, (w0, w1, w2), pdf).

    ``table``: the (K, 14) light rows; ``light_kinds``: the static tuple
    of "s" / "t"; ``pick`` / ``u1`` / ``u2``: per-lane uniforms; ``p*``:
    the shading points; ``tm``: the ray times.  The weight is emit times
    the geometry terms times K (multiply by the Lambertian albedo and
    cos theta); ``pdf`` is the strategy's solid-angle density (the
    picked light's over K, 0 where the sample is degenerate)."""
    n = len(light_kinds)
    k_idx = torch.clamp((pick * n).to(torch.int32), max=n - 1)
    zero = torch.zeros_like(px)
    dx = dy = dz = w0 = w1 = w2 = pdf = zero
    tl = torch.full_like(px, 1e30)
    for k, lkind in enumerate(light_kinds):
        t = table[..., k, :].unbind(-1)
        sel = k_idx == k
        er, eg, eb = t[11], t[12], t[13]
        if lkind == "s":
            cx = t[1] + tm * t[4]
            cy = t[2] + tm * t[5]
            cz = t[3] + tm * t[6]
            r2 = t[7] * t[7]
            tox, toy, toz = cx - px, cy - py, cz - pz
            d2 = tox * tox + toy * toy + toz * toz
            d = torch.sqrt(torch.clamp(d2, min=1e-12))
            inv_d = 1.0 / d
            wx_, wy_, wz_ = tox * inv_d, toy * inv_d, toz * inv_d
            cos_max = _sqrt_pos(1.0 - r2 / torch.clamp(d2, min=1e-12))
            cos_t = 1.0 - u1 * (1.0 - cos_max)
            sin_t = _sqrt_pos(1.0 - cos_t * cos_t, 1e-12)
            phi = TWO_PI * u2
            (ux, uy, uz), (vx, vy, vz) = _onb(wx_, wy_, wz_)
            cp, sp = torch.cos(phi), torch.sin(phi)
            sx = cp * sin_t * ux + sp * sin_t * vx + cos_t * wx_
            sy = cp * sin_t * uy + sp * sin_t * vy + cos_t * wy_
            sz = cp * sin_t * uz + sp * sin_t * vz + cos_t * wz_
            oc_d = -(tox * sx + toy * sy + toz * sz)
            disc = oc_d * oc_d - (d2 - r2)
            t_k = -oc_d - _sqrt_pos(disc)
            ok = (d2 > r2) & (disc > 0.0)
            geo = torch.where(ok, 2.0 * (1.0 - cos_max) * n, 0.0)
            pdf_k = torch.where(ok, 1.0 / torch.clamp(
                TWO_PI * (1.0 - cos_max) * n, min=1e-12), 0.0)
            t_k = torch.clamp(t_k, min=1e-4)
        else:
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, area = t[1:11]
            su = torch.sqrt(torch.clamp(u1, min=1e-12))
            bu = 1.0 - su
            bv = u2 * su
            qx = v0x + bu * e1x + bv * e2x
            qy = v0y + bu * e1y + bv * e2y
            qz = v0z + bu * e1z + bv * e2z
            tox, toy, toz = qx - px, qy - py, qz - pz
            d2 = tox * tox + toy * toy + toz * toz
            d = torch.sqrt(torch.clamp(d2, min=1e-12))
            inv_d = 1.0 / d
            sx, sy, sz = tox * inv_d, toy * inv_d, toz * inv_d
            nx, ny, nz, nlen = _light_normal(e1x, e1y, e1z, e2x, e2y, e2z)
            cos_a = -(sx * nx + sy * ny + sz * nz) / nlen
            ok = cos_a > 1e-6
            geo = torch.where(ok, cos_a * area * n / (_PI * torch.clamp(
                d2, min=1e-12)), 0.0)
            pdf_k = torch.where(ok, d2 / torch.clamp(cos_a * area * n,
                                                     min=1e-12), 0.0)
            t_k = torch.clamp(d, min=1e-4)
        dx = torch.where(sel, sx, dx)
        dy = torch.where(sel, sy, dy)
        dz = torch.where(sel, sz, dz)
        tl = torch.where(sel, t_k, tl)
        w0 = torch.where(sel, er * geo, w0)
        w1 = torch.where(sel, eg * geo, w1)
        w2 = torch.where(sel, eb * geo, w2)
        pdf = torch.where(sel, pdf_k, pdf)
    return dx, dy, dz, tl, (w0, w1, w2), pdf


def _light_normal(e1x, e1y, e1z, e2x, e2y, e2z):
    """A triangle light's unnormalised normal cross(e1, e2) and its
    length (floored at 1e-24 under the root)."""
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    nlen = torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-24))
    return nx, ny, nz, nlen


def light_pdf_toward(table, light_kinds, ox, oy, oz, dx, dy, dz, t_hit, tm):
    """Light-strategy pdf of direction d from o, given the path's nearest
    hit at ``t_hit`` (in units of the possibly unnormalised d): the sum,
    in light order, of each light's solid-angle pdf over K for the lights
    whose first intersection along d lies within 1e-3 max(t_hit, 1) of
    the hit."""
    n = len(light_kinds)
    dlen = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-24))
    inv_l = 1.0 / dlen
    dx, dy, dz = dx * inv_l, dy * inv_l, dz * inv_l
    t_hit = t_hit * dlen
    pdf = torch.zeros_like(ox)
    for k, lkind in enumerate(light_kinds):
        t = table[..., k, :].unbind(-1)
        if lkind == "s":
            cx = t[1] + tm * t[4]
            cy = t[2] + tm * t[5]
            cz = t[3] + tm * t[6]
            r2 = t[7] * t[7]
            tox, toy, toz = cx - ox, cy - oy, cz - oz
            d2 = tox * tox + toy * toy + toz * toz
            oc_d = -(tox * dx + toy * dy + toz * dz)
            disc = oc_d * oc_d - (d2 - r2)
            t_k = -oc_d - _sqrt_pos(disc)
            cos_max = _sqrt_pos(1.0 - r2 / torch.clamp(d2, min=1e-12))
            ok = (d2 > r2) & (disc > 0.0) & (t_k > 0.0)
            pdf_k = 1.0 / torch.clamp(TWO_PI * (1.0 - cos_max) * n,
                                      min=1e-12)
        else:
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, area = t[1:11]
            # Moller-Trumbore against the light, front side only.
            px_ = dy * e2z - dz * e2y
            py_ = dz * e2x - dx * e2z
            pz_ = dx * e2y - dy * e2x
            det = e1x * px_ + e1y * py_ + e1z * pz_
            inv = 1.0 / torch.where(det.abs() < 1e-12, 1.0, det)
            sx_, sy_, sz_ = ox - v0x, oy - v0y, oz - v0z
            u = (sx_ * px_ + sy_ * py_ + sz_ * pz_) * inv
            qx_ = sy_ * e1z - sz_ * e1y
            qy_ = sz_ * e1x - sx_ * e1z
            qz_ = sx_ * e1y - sy_ * e1x
            v = (dx * qx_ + dy * qy_ + dz * qz_) * inv
            t_k = (e2x * qx_ + e2y * qy_ + e2z * qz_) * inv
            ok = ((det >= 1e-6) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t_k > 0.0))
            nx, ny, nz, nlen = _light_normal(e1x, e1y, e1z, e2x, e2y, e2z)
            cos_a = -(dx * nx + dy * ny + dz * nz) / nlen
            pdf_k = (t_k * t_k) / torch.clamp(cos_a * area * n, min=1e-12)
        match = ok & ((t_k - t_hit).abs()
                      <= 1e-3 * torch.clamp(t_hit, min=1.0))
        pdf = pdf + torch.where(match, pdf_k, 0.0)
    return pdf
