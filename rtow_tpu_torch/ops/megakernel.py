"""The persistent whole-frame megakernel (K1), its plain PyTorch version,
and the parts of the bounce it shares with the other kernels (the port
of ``rtow_tpu/ops/pallas_megakernel.py``'s ``_kernel`` with both its
schedulers, and ``_bounce_core``).

``render_blocks`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/megakernel.cu``, on a CPU tensor it runs
``render_blocks_reference``, and on anything else it raises.  Both
compute what the Pallas kernel ``_kernel`` computes, under the scheduler
that ``RTOW_POOL`` names (or the ``pool`` argument).  Under the classic
scheduler (``RTOW_POOL=0``) every lane of an 8x128-pixel tile owns one
pixel and loops until that pixel has ``spp`` samples.  Under the
drain-balanced work pool (``RTOW_POOL=1``, the JAX package's production
default, :1492-1615) each image row's 128 pixels x ``spp`` samples form
a queue of (column, ``RTOW_POOL_CHUNK``-sample) items that the row's
idle lanes take every ``RTOW_POOL_K`` iterations, flushing their
radiance into per-pixel sums (:func:`pool_knobs`).  Either way a lane
loops: regenerate a
thin-lens, time-jittered camera ray when idle, then advance one bounce
(sphere sweep, then the flat triangle sweep for meshes of up to 16,384
triangles; Lambertian / metal / dielectric scatter, sky or flat
background on a miss).  Scenes with lights, textures or media, and
renders with Russian roulette, add the lit features (:class:`Lit`,
:func:`bounce_lanes`): emission with its MIS weight, next-event
estimation with a shadow sweep, the volume event, the textured albedo,
roulette.  Outputs are per-pixel radiance SUMS in the kernel's block
layout: three (n_tiles * 8, 128) float32 planes.

Random numbers are the JAX kernel's stateless counter hash, bit for bit:
lane id ``pix = tile * 1024 + row * 128 + col``, salt
``mix(seed + it * 40503)``, draw ``mix(lane ^ (salt + draw *
0x9E3779B9))``.  Under the classic scheduler a lane takes exactly one
step per iteration of its tile's loop until it is done, so ``it`` is the
lane's own step count and a per-lane loop replays the JAX kernel's
stream exactly.  Under the pool ``it`` is the row's iteration count,
which idle lanes advance too: rows are independent (each has its own
queue), so a per-row loop replays the stream exactly.

The sphere table keeps the JAX package's Morton order and the triangle
table its median-split order, so the nearest hit resolves ties the same
way: the winner is the first minimal ``t`` in table order, spheres
before triangles (winner ids: spheres ``0 .. Npad - 1``, triangles from
``Npad``).  Each lane slab-tests a triangle block's box before it sweeps
the block; the TPU culls per tile.  A culled block holds no triangle the
ray can hit, so the winner does not change.

The plain bounce is shared with the other kernels' plain versions
(``ops/grad.py``, ``ops/flat_bounce.py``), as ``csrc/bounce.cuh`` is
shared by the kernels: :func:`lane_hash`, :func:`step_salt`,
:func:`draw_scatter`, :func:`nearest_sphere`, :func:`nearest_triangle`,
:func:`winner_rows`, :func:`hit_basics`, :func:`shade`, :func:`bounce_lanes`
(K1's and K3's plain bounce) and :func:`background_args`.  Triangles are
one-sided unless a caller passes ``cull=False`` (K1 and K3, as the JAX
kernels take ``cull``).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import _cuda
from .lights import LIGHT_COLS

TILE_ROWS = 8
LANES = 128
TILE = TILE_ROWS * LANES
#: Spheres per Morton block (table rows are padded to a multiple).
SPHERE_BLOCK = 128

# Sphere-table columns.
(_C0X, _C0Y, _C0Z, _DCX, _DCY, _DCZ, _R, _ALR, _ALG, _ALB, _FUZZ, _IR,
 _KIND) = range(13)
TBL_COLS = 16

# float32-exact constants (the JAX kernel's np.float32 values).
_INV24 = 1.0 / (1 << 24)
_TWO_PI = float(np.float32(2.0 * np.pi))
T_MIN = float(np.float32(1e-3))
BIG = float(np.float32(3.0e38))
_EPS12 = float(np.float32(1e-12))

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SALT_STRIDE = 40503

#: Triangle blocks per super-block, and super-blocks per hyper-block, of
#: the triangle table's cull hierarchy.
SUPER = 16
#: Triangle-block width of K1's flat sweep (``render_blocks_pallas``
#: reads the module default, 128).
K1_TRI_BLOCK = 128
#: The per-scene width pick of the sorted-wavefront path: 256 up to this
#: many triangles, 128 above (``pick_tri_block``, :77).
TRI_BLOCK_256_MAX_TRIS = 160000
#: Triangle-table columns: v0 (3), e1 (3), e2 (3), albedo (3), fuzz, ir,
#: kind, then one zero.
TRI_PARAMS = 15
_DET_MIN = float(np.float32(1e-6))

#: Material kind codes as they sit in the table's float column.
_METAL = 1.0
_DIELECTRIC = 2.0
_EMISSIVE = 3.0
_CHECKER = 4.0
_NOISE = 5.0

# The lit bounce's constants (float32, as the JAX kernel rounds them).
_INV_PI = float(np.float32(1.0 / np.pi))
_HALF_INV_PI = float(np.float32(0.5 / np.pi))
_QUARTER_INV_PI = float(np.float32(0.25 / np.pi))
#: The shadow ray must reach this fraction of the light's distance.
_SHADOW_FRAC = float(np.float32(1.0 - 1e-3))
#: Russian roulette (rtow_tpu/ops/integrator.py:55-57): from this many
#: scatters on, with this survival floor.
RR_START = 3
RR_PMIN = float(np.float32(0.05))

#: Largest table the kernel's shared memory holds (227 KB per block on
#: Hopper): 3,632 spheres.
MAX_TABLE_BYTES = 232448

#: Shared memory the pool's instances stage beside the tables: each lane's
#: column and radiance (16 B), then a take mask and a count per warp, for
#: the block's 256 threads (``PoolStage`` in ``csrc/megakernel.cu``).
POOL_STAGE_BYTES = 256 * 16 + 8 * 4 * 2

_F32 = torch.float32


class Pool(NamedTuple):
    """A launch's scheduler: the work pool (``on``) with items of
    ``chunk`` samples handed out every ``k`` iterations, or the classic
    one."""
    on: bool
    chunk: int
    k: int


def pool_knobs(pool: Optional[bool] = None, pool_chunk: Optional[int] = None,
               pool_k: Optional[int] = None) -> Pool:
    """The scheduler a launch runs.  Each argument left None is read from
    the environment at call time, with the JAX package's defaults
    (``pallas_megakernel.py:1511-1516``, ``pipeline.py:74-84``):
    ``RTOW_POOL`` "1" (the pool on unless it is set to something else),
    ``RTOW_POOL_CHUNK`` 16, ``RTOW_POOL_K`` 4."""
    env = os.environ.get
    on = env("RTOW_POOL", "1") == "1" if pool is None else bool(pool)
    chunk = int(env("RTOW_POOL_CHUNK", "16") if pool_chunk is None
                else pool_chunk)
    k = int(env("RTOW_POOL_K", "4") if pool_k is None else pool_k)
    if chunk < 1 or k < 1:
        raise ValueError(f"pool chunk {chunk} and period {k} must be >= 1")
    return Pool(on, chunk, k)


# ---------------------------------------------------------------------------
# Counter RNG.  torch has no logical right shift on uint32 on the CPU, so
# the hash runs on int64 tensors (or Python ints) holding uint32 values.


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix(x):
    """murmur3 finalizer (``pallas_megakernel._mix``, :112)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform(lane, salt, draw: int) -> torch.Tensor:
    """U[0,1) per lane from (lane, salt, draw) (``_uniform``, :122)."""
    h = mix(lane ^ ((salt + ((draw * _GOLDEN) & _M32)) & _M32))
    return (h >> 8).to(_F32) * _INV24


def draw_scatter(lane, salt):
    """The bounce's draws: a unit vector and the dielectric choice
    (``_draw_scatter``, :1225)."""
    uz = 1.0 - 2.0 * uniform(lane, salt, 5)
    uu = uniform(lane, salt, 6)
    uxy = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
    uph = _TWO_PI * uu
    return (uxy * torch.cos(uph), uxy * torch.sin(uph), uz,
            uniform(lane, salt, 7))


def step_salt(seed: int, it: int) -> int:
    """The salt of step ``it``: K1's per-lane step count, the gradient
    bounce's scan step."""
    return mix((seed + it * _SALT_STRIDE) & _M32)


def lane_hash(lane_id):
    """A lane's hashed id from its integer id (``_lane_u32``)."""
    return mix(_mul32(lane_id & _M32, _GOLDEN))


def lane_state(rays, n_lanes: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first bounce's (cont, ints) for ``n_lanes`` camera rays
    (``render_pixels_kernel``'s lane set-up, pallas_grad.py:931-950), as
    the gradient bounce and the sorted wavefront start their lanes: lanes
    padded to a multiple of 1,024, padding lanes dead with direction
    (0, 0, 1), throughput 1, radiance 0, lane id = index.  ``rays`` (a
    camera's ``Rays``) may hold tensors or numpy arrays."""
    n = -(-n_lanes // TILE) * TILE

    def lanes(x, width):
        x = torch.as_tensor(x, dtype=_F32, device=device)
        if tuple(x.shape) != ((n_lanes, width) if width else (n_lanes,)):
            raise ValueError(f"rays must hold {n_lanes} lanes, got "
                             f"{tuple(x.shape)}")
        return x

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((n - n_lanes,), fill, dtype=_F32,
                                        device=device)])

    origin = lanes(rays.origin, 3)
    direction = lanes(rays.direction, 3)
    one = torch.ones(n, dtype=_F32, device=device)
    zero = torch.zeros(n, dtype=_F32, device=device)
    cont = torch.stack([
        pad(origin[:, 0]), pad(origin[:, 1]), pad(origin[:, 2]),
        pad(direction[:, 0]), pad(direction[:, 1]),
        pad(direction[:, 2], fill=1.0), pad(lanes(rays.time, 0)),
        one, one, one, zero, zero, zero,
    ])
    lane_id = torch.arange(n, dtype=torch.int32, device=device)
    ints = torch.stack([(lane_id < n_lanes).to(torch.int32),
                        torch.zeros_like(lane_id), lane_id])
    return cont, ints


# ---------------------------------------------------------------------------
# Host tables and packing.


def build_sphere_table(scene) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere tables ((Npad, 16) params, (NB, 8) block AABBs) on the
    scene's device (``build_sphere_table``, :134).

    Rows are in Morton order of the spheres' motion-swept bounds;
    padding rows have r = 0 and a far-away center, so they are never
    hit.  The block boxes are the JAX kernel's culling boxes; the CUDA
    kernel sweeps every row and does not read them.  A scene without
    spheres gets empty tables (the JAX kernels' ``n_blocks = 0``)."""
    sp = scene.spheres
    mats = scene.materials
    n = sp.radius.shape[0]
    npad = -(-n // SPHERE_BLOCK) * SPHERE_BLOCK
    dev = sp.radius.device
    if n == 0:
        return (torch.zeros((0, TBL_COLS), dtype=_F32, device=dev),
                torch.zeros((0, 8), dtype=_F32, device=dev))

    r_abs = sp.radius.abs()[:, None]
    c1 = sp.center0 + sp.dcenter
    smin = torch.minimum(sp.center0, c1) - r_abs
    smax = torch.maximum(sp.center0, c1) + r_abs
    cent = 0.5 * (smin + smax)
    order = morton_order(smin.amin(dim=0), smax.amax(dim=0), cent)
    c0 = sp.center0[order]
    dc = sp.dcenter[order]
    mid = sp.material[order].long()
    smin, smax = smin[order], smax[order]

    tbl = torch.stack([
        c0[:, 0], c0[:, 1], c0[:, 2],
        dc[:, 0], dc[:, 1], dc[:, 2],
        sp.radius[order],
        mats.albedo[mid, 0], mats.albedo[mid, 1], mats.albedo[mid, 2],
        mats.fuzz[mid], mats.ir[mid], mats.kind[mid].to(_F32),
        mats.albedo2[mid, 0], mats.albedo2[mid, 1], mats.albedo2[mid, 2],
    ], dim=1).to(_F32)
    pad = torch.zeros((npad - n, TBL_COLS), dtype=_F32, device=dev)
    pad[:, _C0X] = 1.0e9
    tbl = torch.cat([tbl, pad])

    big = 1.0e30
    bmin = torch.cat([smin, torch.full((npad - n, 3), big, device=dev)])
    bmax = torch.cat([smax, torch.full((npad - n, 3), -big, device=dev)])
    nb = npad // SPHERE_BLOCK
    blk_min = bmin.reshape(nb, SPHERE_BLOCK, 3).amin(dim=1)
    blk_max = bmax.reshape(nb, SPHERE_BLOCK, 3).amax(dim=1)
    pad_eps = 1e-4 + 1e-4 * (blk_max - blk_min).abs()
    boxes = torch.cat([blk_min - pad_eps, blk_max + pad_eps,
                       torch.zeros((nb, 2), dtype=_F32, device=dev)], dim=1)
    return tbl, boxes.to(_F32)


class TriTable(NamedTuple):
    """The triangle table and its cull hierarchy (``build_tri_table``).

    ``tbl``: (Mpad, 16) float32 rows ``v0 e1 e2 albedo fuzz ir kind 0``;
    ``boxes``: (NB, 8) block AABBs (min xyz, max xyz, 0, 0), one per
    ``block`` rows; ``supers`` / ``hypers``: the (NSB, 8) / (NHB, 8)
    AABBs of ``SUPER`` blocks / ``SUPER`` supers, each a (1, 8) zero
    sentinel where the level is absent; ``count``: the real triangles
    (rows past it are padding, never hit)."""
    tbl: torch.Tensor
    boxes: torch.Tensor
    supers: torch.Tensor
    hypers: torch.Tensor
    block: int
    count: int

    @property
    def n_blocks(self) -> int:
        return self.tbl.shape[0] // self.block

    @property
    def n_super(self) -> int:
        return self.supers.shape[0] if self.supers.shape[0] > 1 else 0

    @property
    def n_hyper(self) -> int:
        return self.hypers.shape[0] if self.hypers.shape[0] > 1 else 0


def pick_tri_block(n_triangles: int) -> int:
    """The sorted-wavefront path's triangle-block width for a mesh
    (``pick_tri_block``, :77, without its environment override)."""
    return 256 if 0 < n_triangles <= TRI_BLOCK_256_MAX_TRIS else 128


def _median_split_order(cent: np.ndarray, tri_block: int) -> np.ndarray:
    """Recursive median-split permutation of triangle centroids
    (``_median_split_order``, :253): every run of ``tri_block`` rows is a
    compact cluster, with cuts aligned to SUPER multiples higher up so
    super and hyper groups are subtrees.  ``cent`` is float32, as the
    JAX package computes it, so the order is the same."""
    def rec(ids):
        n = ids.shape[0]
        if n <= tri_block:
            return [ids]
        unit = tri_block
        while unit * SUPER * 2 <= n:
            unit *= SUPER
        c = cent[ids]
        ext = c.max(axis=0) - c.min(axis=0)
        ids = ids[np.argsort(c[:, int(ext.argmax())], kind="stable")]
        hi = ((n - 1) // unit) * unit
        cut = min(max(unit, int(round(n / 2 / unit)) * unit), hi)
        return rec(ids[:cut]) + rec(ids[cut:])

    return np.concatenate(rec(np.arange(cent.shape[0])))


def build_tri_table(scene, tri_block: int, order: str = "median") -> TriTable:
    """The triangle table of ``scene`` in ``tri_block``-row blocks, on the
    scene's device (``build_tri_table``, :281-387): rows in median-split
    order, padded to whole super-blocks when there are at least 2*SUPER
    blocks and to whole hyper-blocks when there are at least 2*SUPER
    supers; padding rows are zero (degenerate, never hit) and their
    boxes inverted.  Block boxes are padded by 1e-4 + 1e-4 * extent, so a
    flat block still has volume.

    ``order="morton"`` orders the rows by the Morton code of their
    centroids instead, as the JAX table does when the vertices are traced
    (:314-318, the gradient path under ``jit`` and ``grad``).  The order
    and the boxes are taken from detached vertices, so the boxes carry no
    gradient (pallas_grad.py:716-718); the rows are gathers of the
    vertices and materials, through which autograd carries the table's
    cotangent back to ``triangles.verts`` and the material leaves."""
    tr = scene.triangles
    mats = scene.materials
    m = tr.material.shape[0]
    if m == 0:
        raise ValueError("scene has no triangles")
    dev = tr.verts.device
    mpad = -(-m // tri_block) * tri_block
    if mpad // tri_block >= 2 * SUPER:
        mpad = -(-mpad // (tri_block * SUPER)) * tri_block * SUPER
    if mpad // (tri_block * SUPER) >= 2 * SUPER:
        mpad = (-(-mpad // (tri_block * SUPER * SUPER))
                * tri_block * SUPER * SUPER)

    verts = tr.verts.to(_F32)
    tmin = verts.detach().amin(dim=1)
    tmax = verts.detach().amax(dim=1)
    cent = 0.5 * (tmin + tmax)
    if order == "morton":
        perm = morton_order(tmin.amin(dim=0), tmax.amax(dim=0), cent)
    elif order == "median":
        perm = torch.from_numpy(_median_split_order(
            cent.cpu().numpy(), tri_block)).to(dev)
    else:
        raise ValueError(f"order must be 'median' or 'morton', not {order!r}")
    verts = verts[perm]
    mid = tr.material[perm].long()
    tmin, tmax = tmin[perm], tmax[perm]
    v0 = verts[:, 0]
    e1 = verts[:, 1] - v0
    e2 = verts[:, 2] - v0
    tbl = torch.cat([
        v0, e1, e2, mats.albedo[mid],
        torch.stack([mats.fuzz[mid], mats.ir[mid],
                     mats.kind[mid].to(_F32)], dim=1),
        torch.zeros((m, 1), dtype=_F32, device=dev),
    ], dim=1).to(_F32)
    tbl = torch.cat([tbl, torch.zeros((mpad - m, TBL_COLS), dtype=_F32,
                                      device=dev)])

    big = 1.0e30

    def padded(x, fill, rows):
        return torch.cat([x, torch.full((rows - x.shape[0], 3), fill,
                                        dtype=_F32, device=dev)])

    def group(lo, hi, k):
        n = lo.shape[0] // k
        return lo.reshape(n, k, 3).amin(dim=1), hi.reshape(n, k, 3).amax(dim=1)

    def rows8(lo, hi):
        return torch.cat([lo, hi, torch.zeros((lo.shape[0], 2), dtype=_F32,
                                              device=dev)], dim=1)

    blk_min, blk_max = group(padded(tmin, big, mpad), padded(tmax, -big, mpad),
                             tri_block)
    pad_eps = 1e-4 + 1e-4 * (blk_max - blk_min).abs()
    blk_min = blk_min - pad_eps
    blk_max = blk_max + pad_eps
    boxes = rows8(blk_min, blk_max)
    none = torch.zeros((1, 8), dtype=_F32, device=dev)
    nb = boxes.shape[0]
    if nb % SUPER or nb < 2 * SUPER:
        return TriTable(tbl, boxes, none, none, tri_block, m)
    sup_min, sup_max = group(blk_min, blk_max, SUPER)
    supers = rows8(sup_min, sup_max)
    nsb = supers.shape[0]
    if nsb < 2 * SUPER:
        return TriTable(tbl, boxes, supers, none, tri_block, m)
    # Supers pad to a whole hyper-block with inverted boxes.
    nsb_pad = -(-nsb // SUPER) * SUPER
    pad_row = torch.tensor([[big, big, big, -big, -big, -big, 0.0, 0.0]],
                           dtype=_F32, device=dev)
    supers = torch.cat([supers, pad_row.repeat(nsb_pad - nsb, 1)])
    hyp_min, hyp_max = group(padded(sup_min, big, nsb_pad),
                             padded(sup_max, -big, nsb_pad), SUPER)
    return TriTable(tbl, boxes, supers, rows8(hyp_min, hyp_max), tri_block, m)


def morton_order(cmin: torch.Tensor, cmax: torch.Tensor,
                 cent: torch.Tensor) -> torch.Tensor:
    """Stable Morton (z-order) permutation of centroids (``_morton_order``,
    :191).  The sort is stable, as ``jnp.argsort`` is: static covers have
    equal codes."""
    return torch.argsort(_morton_codes(cmin, cmax, cent), stable=True)


def _morton_codes(cmin, cmax, cent) -> torch.Tensor:
    """30-bit Morton codes of centroids quantised over robust (5th-95th
    percentile) bounds."""
    plo = torch.quantile(cent, 0.05, dim=0)
    phi = torch.quantile(cent, 0.95, dim=0)
    ok = (phi - plo) > 1e-9
    lo = torch.where(ok, plo, cmin)
    hi = torch.where(ok, phi, cmax)
    ext = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((cent - lo) / ext * 1023.0, 0.0, 1023.0).to(torch.int64)

    def spread(x):  # interleave 10 bits with two zero bits each
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def pack_camera(camera) -> torch.Tensor:
    """The kernel's (21,) float32 camera vector (:2062-2070)."""
    c = camera
    return torch.stack([
        c.origin[0], c.origin[1], c.origin[2],
        c.u[0], c.u[1], c.u[2],
        c.v[0], c.v[1], c.v[2],
        c.lower_left[0], c.lower_left[1], c.lower_left[2],
        c.horizontal[0], c.horizontal[1], c.horizontal[2],
        c.vertical[0], c.vertical[1], c.vertical[2],
        c.lens_radius, c.t0, c.t1 - c.t0,
    ]).to(_F32)


def pack_meta(seed: int, *, width: int, height: int, spp: int,
              max_depth: int, tile0: int = 0) -> Tuple[int, ...]:
    """The kernel's scalars (:2071-2075):
    (seed, W, H, n_pixels, tile0, spp, max_depth), each an int32."""
    meta = (int(seed), int(width), int(height), int(width) * int(height),
            int(tile0), int(spp), int(max_depth))
    for v in meta:
        if not -(1 << 31) <= v < (1 << 31):
            raise ValueError(f"kernel scalar {v} does not fit in int32")
    if width < 1 or height < 1 or spp < 0 or max_depth < 0 or tile0 < 0:
        raise ValueError(f"bad render scalars {meta}")
    return meta


def n_tiles_for(width: int, height: int) -> int:
    return -(-width // LANES) * -(-height // TILE_ROWS)


def background_args(background) -> Tuple[bool, Tuple[float, float, float]]:
    if background == "sky":
        return True, (0.0, 0.0, 0.0)
    r, g, b = (float(np.float32(x)) for x in background)
    return False, (r, g, b)


# ---------------------------------------------------------------------------
# The plain version.


class Lit(NamedTuple):
    """The lit features of a render, static per scene
    (``render_blocks_pallas``'s kernel parameters, :2077-2102): emission
    (``emissive``), next-event estimation toward the lights of kinds
    ``nee_kinds`` ("s" / "t", the first ``len(nee_kinds)`` rows of
    ``rows``), checker and noise textures (``checker``), media of kinds
    ``vol_kinds`` (rows ``vol_row0`` on) and Russian roulette
    (``roulette``).  ``rows``: the (K + V, 14) float32 light rows then
    volume rows (``ops/lights.py``, ``ops/volumes.py``), or None."""
    emissive: bool = False
    nee_kinds: tuple = ()
    checker: bool = False
    vol_kinds: tuple = ()
    vol_row0: int = 0
    roulette: bool = False
    rows: Optional[torch.Tensor] = None

    @property
    def any(self) -> bool:
        return bool(self.emissive or self.nee_kinds or self.checker
                    or self.vol_kinds or self.roulette)

    def lights(self):
        """The light rows: (K, 14), or (L, K, 14) where ``rows`` holds one
        copy per lane (the gradient path's per-lane row cotangents)."""
        return self.rows[..., :len(self.nee_kinds), :]

    def volumes(self):
        """The volume rows: (V, 14), or (L, V, 14) per lane."""
        return self.rows[..., self.vol_row0:, :]


def render_blocks_reference(
    tbl: torch.Tensor,
    cam: torch.Tensor,
    meta: Tuple[int, ...],
    n_tiles: int,
    *,
    background: Union[str, tuple] = "sky",
    steps: Optional[torch.Tensor] = None,
    tris: Optional[TriTable] = None,
    tests: Optional[torch.Tensor] = None,
    lit: Lit = Lit(),
    shadows: Optional[torch.Tensor] = None,
    cull: bool = True,
    pool: Optional[bool] = None,
    pool_chunk: Optional[int] = None,
    pool_k: Optional[int] = None,
    slots: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the megakernel, on ``tbl``'s device.

    The classic scheduler runs the per-lane loop vectorised over a chunk
    of lanes at a time, dropping lanes as they finish; the pool runs the
    per-row loop vectorised over every row (:func:`_trace_pool`).  Same
    inputs and outputs as :func:`render_blocks`."""
    knobs = pool_knobs(pool, pool_chunk, pool_k)
    seed, width, height, _n_pixels, tile0, spp, max_depth = meta
    dev = tbl.device
    cam_f = [float(x) for x in cam.detach().cpu()]
    tally = [0, 0, 0]  # box tests, triangle tests, shadow rays
    kw = dict(seed=seed, width=width, height=height, spp=spp,
              max_depth=max_depth, background=background, tris=tris,
              tally=tally, lit=lit, cull=cull)
    if knobs.on:
        out, n_steps, n_slots = _trace_pool(tbl, cam_f, n_tiles, tile0,
                                            knobs, **kw)
    else:
        out, n_steps, n_slots = _trace_classic(tbl, cam_f, n_tiles, tile0,
                                               **kw)
    if steps is not None:
        steps += n_steps
    if slots is not None:
        slots += n_slots
    if tests is not None:
        tests += torch.tensor(tally[:2], device=dev)
    if shadows is not None:
        shadows += tally[2]
    planes = out.view(3, n_tiles * TILE_ROWS, LANES)
    return planes[0], planes[1], planes[2]


def _trace_classic(tbl, cam, n_tiles, tile0, *, seed, width, height, spp,
                   max_depth, background, tris, tally, lit, cull):
    """The classic scheduler: (radiance sums (3, n_tiles * 1024), ray
    steps, lane slots = 32 x each warp's longest loop)."""
    dev = tbl.device
    n_lanes = n_tiles * TILE
    out = torch.zeros((3, n_lanes), dtype=_F32, device=dev)
    its = torch.zeros(n_lanes, dtype=torch.int64, device=dev)

    g = torch.arange(n_lanes, device=dev, dtype=torch.int64)
    tiles_x = -(-width // LANES)
    pid = tile0 + g // TILE
    row = (g % TILE) // LANES
    col = g % LANES
    prow = (pid // tiles_x) * TILE_ROWS + row
    pcol = (pid % tiles_x) * LANES + col
    in_img = (prow < height) & (pcol < width)
    pix = (pid * TILE + row * LANES + col) & _M32
    lanes = torch.nonzero(in_img).flatten() if spp > 0 else g[:0]
    # Lanes per chunk: the pair temporaries are (chunk, 128) float32, so
    # 2**20 lanes take about 0.5 GB each on the card.
    chunk = 1 << 20 if dev.type == "cuda" else 1 << 16
    n_steps = 0
    for start in range(0, lanes.numel(), chunk):
        idx = lanes[start:start + chunk]
        out[:, idx], its[idx], n = _trace_lanes(
            tbl, cam, pix[idx], prow[idx], pcol[idx], seed=seed,
            width=width, height=height, spp=spp, max_depth=max_depth,
            background=background, tris=tris, tally=tally, lit=lit,
            cull=cull)
        n_steps += n
    n_slots = 32 * int(its.view(-1, 32).amax(dim=1).sum())
    return out, n_steps, n_slots


def _trace_lanes(tbl, cam, pix, prow, pcol, *, seed, width, height, spp,
                 max_depth, background, tris, tally, lit, cull):
    """(radiance sums (3, L) of lanes ``pix`` after ``spp`` samples, each
    lane's step count, ray steps taken)."""
    dev = tbl.device
    n = pix.numel()
    out = torch.zeros((3, n), dtype=_F32, device=dev)
    its = torch.zeros(n, dtype=torch.int64, device=dev)
    inv_w = float(np.float32(1.0) / np.float32(width - 1))
    inv_h = float(np.float32(1.0) / np.float32(height - 1))

    # Lane state, compacted to the unfinished lanes after every step;
    # ``idx`` maps it back to the lane's slot in ``out``.  ``code`` is
    # the alive code: 0 dead, 1 alive, 2 alive after a diffuse scatter
    # (which only next-event estimation tells apart).
    idx = torch.arange(n, device=dev)
    lane = lane_hash(pix)
    fcol = pcol.to(_F32)
    frow = (height - 1 - prow).to(_F32)
    zeros = torch.zeros(n, dtype=_F32, device=dev)
    ox = oy = oz = dy = dz = tm = tpr = tpg = tpb = rr = rg = rb = zeros
    dx = zeros + 1.0
    code = torch.zeros(n, dtype=torch.int32, device=dev)
    bounce = torch.zeros(n, dtype=torch.int32, device=dev)
    started = torch.zeros(n, dtype=torch.int32, device=dev)

    it = steps = 0
    while idx.numel():
        salt = step_salt(seed, it)
        # ---- regeneration: idle lanes (all have samples left) -------
        need = code == 0
        nox, noy, noz, ndx, ndy, ndz, ntm = camera_ray(
            cam, lane, salt, fcol, frow, inv_w, inv_h)
        ox = torch.where(need, nox, ox)
        oy = torch.where(need, noy, oy)
        oz = torch.where(need, noz, oz)
        dx = torch.where(need, ndx, dx)
        dy = torch.where(need, ndy, dy)
        dz = torch.where(need, ndz, dz)
        tm = torch.where(need, ntm, tm)
        tpr = torch.where(need, 1.0, tpr)
        tpg = torch.where(need, 1.0, tpg)
        tpb = torch.where(need, 1.0, tpb)
        bounce = torch.where(need, 0, bounce)
        started = started + need.to(torch.int32)
        # A regenerated lane starts a camera path: no diffuse flag.
        from_diffuse = (code > 1) & ~need if lit.nee_kinds else None

        # ---- one bounce for every lane (all are alive now) ----------
        state, code, bounce = bounce_lanes(
            tbl, tris, (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg,
                        rb), lane, salt, bounce, max_depth, background,
            lit=lit, from_diffuse=from_diffuse, tally=tally, cull=cull)
        (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
        code = code.to(torch.int32)
        it += 1
        steps += idx.numel()

        done = (code == 0) & (started == spp)
        if bool(done.any()):
            out[:, idx[done]] = torch.stack([rr[done], rg[done], rb[done]])
            its[idx[done]] = it
            keep = ~done
            idx, lane, fcol, frow = idx[keep], lane[keep], fcol[keep], frow[keep]
            ox, oy, oz, dx, dy, dz, tm = (
                v[keep] for v in (ox, oy, oz, dx, dy, dz, tm))
            tpr, tpg, tpb, rr, rg, rb = (
                v[keep] for v in (tpr, tpg, tpb, rr, rg, rb))
            code, bounce, started = code[keep], bounce[keep], started[keep]
    return out, its, steps


def camera_ray(cam, lane, salt, fcol, frow, inv_w, inv_h):
    """A thin-lens, time-jittered camera ray through pixel column ``fcol``
    and flipped row ``frow`` (the kernel's regeneration, :1618-1639):
    origin xyz, direction xyz, time."""
    (cox, coy, coz, cux, cuy, cuz, cvx, cvy, cvz, llx, lly, llz,
     chx, chy, chz, cwx, cwy, cwz, lens_r, t0, dt) = cam
    s = (fcol + uniform(lane, salt, 0)) * inv_w
    t = (frow + uniform(lane, salt, 1)) * inv_h
    rad_l = lens_r * torch.sqrt(uniform(lane, salt, 2))
    th = _TWO_PI * uniform(lane, salt, 3)
    lx = rad_l * torch.cos(th)
    ly = rad_l * torch.sin(th)
    nox = cox + lx * cux + ly * cvx
    noy = coy + lx * cuy + ly * cvy
    noz = coz + lx * cuz + ly * cvz
    return (nox, noy, noz, llx + s * chx + t * cwx - nox,
            lly + s * chy + t * cwy - noy, llz + s * chz + t * cwz - noz,
            t0 + uniform(lane, salt, 4) * dt)


def _pool_flush(acc, rad, cur, take):
    """Adds each taking lane's radiance to its pixel's sum, in place:
    ``acc`` and ``rad`` (3, R, 128), ``cur`` (R, 128) the lanes' columns,
    ``take`` (R, 128) which lanes flush.  Column c of row r gets the
    radiance of the row's taking lanes at c summed in lane order from 0,
    then added to ``acc`` -- the order ``csrc/megakernel.cu`` sums in (the
    JAX kernel's ``acc + ch @ onehot``, :1584-1596)."""
    rows = torch.nonzero(take.any(dim=1)).flatten()
    if not rows.numel():
        return
    cur_r, take_r = cur[rows], take[rows]
    lane = torch.arange(LANES, device=cur.device)
    # rank[r, i]: the taking lanes before lane i at lane i's column.
    before = ((cur_r[:, :, None] == cur_r[:, None, :]) & take_r[:, None, :]
              & (lane[None, None, :] < lane[None, :, None]))
    rank = torch.where(take_r, before.sum(dim=2), -1)
    s = torch.zeros((3,) + cur_r.shape, dtype=_F32, device=cur.device)
    for k in range(int(rank.max()) + 1):
        r, i = torch.nonzero(rank == k, as_tuple=True)
        c = cur_r[r, i]
        s[:, r, c] = s[:, r, c] + rad[:, rows[r], i]
    acc[:, rows] = acc[:, rows] + s


def _trace_pool(tbl, cam, n_tiles, tile0, knobs: Pool, *, seed, width,
                height, spp, max_depth, background, tris, tally, lit, cull):
    """The work pool (``_kernel`` with ``RTOW_POOL=1``, :1492-1615,
    :1689-1726), one loop over all rows at once: (radiance sums (3,
    n_tiles * 1024), ray steps, lane slots = 128 x each row's
    iterations).

    Row r's queue holds ``ceil(spp / chunk) * 128`` items; item i is
    column i % 128, chunk i // 128, with ``clip(spp - chunk * chunk_size,
    0, chunk_size)`` samples (none off the image).  Lane c starts on item
    c; the row's counter starts at 128.  At every iteration ``it`` with
    ``it % k == 0`` the lanes that are dead with no samples left take the
    next items in lane order (an exclusive prefix sum), flushing their
    radiance into their current column's sum first.  Then idle lanes
    with samples left regenerate a camera ray through their current
    column, and every live lane advances one bounce.  A row runs while a
    lane is alive or has samples left or its queue is not drained; a
    final flush adds every lane's radiance."""
    dev = tbl.device
    n_rows = n_tiles * TILE_ROWS
    rows = torch.arange(n_rows, device=dev, dtype=torch.int64)
    tiles_x = -(-width // LANES)
    pid = tile0 + rows // TILE_ROWS
    prow = (pid // tiles_x) * TILE_ROWS + rows % TILE_ROWS
    pcol0 = (pid % tiles_x) * LANES
    col = torch.arange(LANES, device=dev, dtype=torch.int64).expand(
        n_rows, LANES)
    lane = lane_hash(((pid * TILE)[:, None] + (rows % TILE_ROWS)[:, None]
                      * LANES + col) & _M32).flatten()
    row_ok = (prow < height)[:, None]
    n_items = -(-spp // knobs.chunk) * LANES

    def budget(c, chunk):
        ok = row_ok & (pcol0[:, None] + c < width)
        left = torch.as_tensor(spp - chunk * knobs.chunk, device=dev)
        return torch.where(ok, left.clamp(0, knobs.chunk), 0)

    inv_w = float(np.float32(1.0) / np.float32(width - 1))
    inv_h = float(np.float32(1.0) / np.float32(height - 1))
    frow = (height - 1 - prow).to(_F32).repeat_interleave(LANES)
    pcol_lane = pcol0.repeat_interleave(LANES)
    n = n_rows * LANES
    zeros = torch.zeros(n, dtype=_F32, device=dev)
    # state: ox oy oz dx dy dz tm tpr tpg tpb rr rg rb, per lane.
    state = [zeros.clone() for _ in range(13)]
    state[3] += 1.0
    code = torch.zeros(n, dtype=torch.int32, device=dev)
    bounce = torch.zeros(n, dtype=torch.int32, device=dev)
    rem = budget(col, 0).flatten()
    cur = col.flatten().clone()
    nxt = torch.full((n_rows,), LANES, dtype=torch.int64, device=dev)
    acc = torch.zeros((3, n_rows, LANES), dtype=_F32, device=dev)
    row_its = torch.zeros(n_rows, dtype=torch.int64, device=dev)

    def radiance():
        return torch.stack(state[10:13]).view(3, n_rows, LANES)

    it = steps = 0
    while True:
        busy = ((code != 0) | (rem > 0)).view(n_rows, LANES).any(dim=1)
        going = busy | (nxt < n_items)
        if not bool(going.any()):
            break
        row_its += going
        salt = step_salt(seed, it)
        if it % knobs.k == 0:
            # ---- hand-out: idle lanes take items, flushing first --------
            done = ((code == 0) & (rem == 0)).view(n_rows, LANES)
            off = torch.cumsum(done, dim=1) - done.long()
            item = nxt[:, None] + off
            take = done & (item < n_items)
            _pool_flush(acc, radiance(), cur.view(n_rows, LANES), take)
            flat = take.flatten()
            for ch in (10, 11, 12):
                state[ch] = torch.where(flat, 0.0, state[ch])
            new_col = item % LANES
            cur = torch.where(flat, new_col.flatten(), cur)
            rem = torch.where(flat, budget(new_col, item // LANES).flatten(),
                              rem)
            nxt = nxt + take.sum(dim=1)
        # ---- regeneration through the lane's current column -------------
        need = (code == 0) & (rem > 0)
        sub = torch.nonzero(need).flatten()
        if sub.numel():
            fcol = (pcol_lane[sub] + cur[sub]).to(_F32)
            ray = camera_ray(cam, lane[sub], salt, fcol, frow[sub], inv_w,
                             inv_h)
            for j, v in enumerate(ray):
                state[j] = state[j].index_put((sub,), v)
            for j in (7, 8, 9):
                state[j] = state[j].index_put(
                    (sub,), torch.ones_like(sub, dtype=_F32))
            bounce = bounce.index_put((sub,), torch.zeros_like(
                sub, dtype=torch.int32))
            rem = rem - need.to(rem.dtype)
        # ---- one bounce of the live lanes -------------------------------
        live = torch.nonzero((code != 0) | need).flatten()
        if live.numel():
            from_diffuse = ((code[live] > 1) & ~need[live]
                            if lit.nee_kinds else None)
            new, new_code, new_bounce = bounce_lanes(
                tbl, tris, tuple(v[live] for v in state), lane[live], salt,
                bounce[live], max_depth, background, lit=lit,
                from_diffuse=from_diffuse, tally=tally, cull=cull)
            for j, v in enumerate(new):
                state[j] = state[j].index_put((live,), v)
            code = code.index_put((live,), new_code.to(torch.int32))
            bounce = bounce.index_put((live,), new_bounce.to(torch.int32))
        steps += live.numel()
        it += 1
    _pool_flush(acc, radiance(), cur.view(n_rows, LANES),
               torch.ones((n_rows, LANES), dtype=torch.bool, device=dev))
    return acc.view(3, -1), steps, LANES * int(row_its.sum())


def bounce_lanes(tbl, tris, state, lane, salt, bounce, max_depth, background,
                 *, lit: Lit = Lit(), from_diffuse=None, tally=None,
                 flat: bool = True, cull: bool = True):
    """One bounce of live lanes in ``_bounce_core``'s order (:1358-1430):
    the sweep; the volume event; next-event estimation with its shadow
    sweep (from ``t_init`` = the light's distance less 0.1%, counted in
    ``tally`` as the main sweep is); then :func:`shade`.  ``state``: the
    13-tuple; ``lane``: the lanes' hashed ids; ``from_diffuse``: the
    previous bounce's diffuse flags (with NEE).  Both triangle sweeps go
    down the table's hierarchy unless ``flat`` (K1 sweeps flat, K3
    descends: :func:`nearest_triangle`); ``cull`` False makes triangles
    two-sided.  Returns (new 13-tuple, alive code, bounce)."""
    ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb = state
    a = dx * dx + dy * dy + dz * dz
    npad = tbl.shape[0]
    best_t, best_k = nearest_sphere(tbl, ox, oy, oz, dx, dy, dz, tm, a,
                                    1.0 / a)
    if tris is not None:
        best_t, best_k = nearest_triangle(
            tris, ox, oy, oz, dx, dy, dz, best_t, best_k, npad, flat=flat,
            cull=cull, tally=tally)
    w, tri = winners(tbl, tris, best_t, best_k,
                     cols=TBL_COLS if lit.checker else 13)
    draws = draw_scatter(lane, salt)
    alive = torch.ones_like(best_t, dtype=torch.bool)
    v_event = volume_event(state, draws, lane, salt, best_t, lit)
    basics = hit_basics(state, w, best_t, tri=tri, checker=lit.checker,
                        cull=cull)
    if lit.nee_kinds:
        nee_us = (uniform(lane, salt, 8), uniform(lane, salt, 9),
                  uniform(lane, salt, 10))
        (px, py, pz), (ldx, ldy, ldz), thresh, contrib, nee_act = nee_contrib(
            state, basics, alive, bounce, max_depth, nee_us, lit, v_event)
        sub = torch.nonzero(nee_act).flatten()
        if tally is not None:
            tally[2] += sub.numel()
        if sub.numel():
            sx, sy, sz, lx, ly, lz = (v[sub] for v in (px, py, pz, ldx, ldy,
                                                       ldz))
            la = lx * lx + ly * ly + lz * lz
            s_t, s_k = nearest_sphere(tbl, sx, sy, sz, lx, ly, lz, tm[sub], la,
                                      1.0 / la, t_init=thresh[sub])
            if tris is not None:
                s_t, _ = nearest_triangle(tris, sx, sy, sz, lx, ly, lz, s_t,
                                          s_k, npad, flat=flat, cull=cull,
                                          tally=tally)
            add = s_t >= thresh[sub]
            rr, rg, rb = (
                ch.index_put((sub,), ch[sub] + torch.where(add, c[sub], 0.0))
                for ch, c in zip((rr, rg, rb), contrib))
            state = (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb)
    return shade(state, w, draws, best_t, alive, bounce, max_depth,
                 background, tri=tri, basics=basics, lit=lit,
                 from_diffuse=from_diffuse, v_event=v_event,
                 rr_u=uniform(lane, salt, 11) if lit.roulette else None)


def volume_event(state, draws, lane, salt, best_t, lit: Lit):
    """The free-flight event of ``lit``'s media before the surface at
    ``best_t`` (one uniform per volume at salts 16 on), or None without
    media: (v_hit, t_v, albedo rgb, the isotropic direction xyz), as
    :func:`nee_contrib` and :func:`shade` take it."""
    if not lit.vol_kinds:
        return None
    from .volumes import sample_volume_event

    us = [uniform(lane, salt, 16 + j) for j in range(len(lit.vol_kinds))]
    v_hit, v_t, (v_ar, v_ag, v_ab) = sample_volume_event(
        lit.volumes(), lit.vol_kinds, us, *state[:6], best_t)
    uvx, uvy, uvz, _choice = draws
    return (v_hit, v_t, v_ar, v_ag, v_ab, uvx * 0.5, uvy * 0.5, uvz * 0.5)


def nearest_sphere(tbl, ox, oy, oz, dx, dy, dz, tm, a, inv_a, t_init=None):
    """(best_t, best_k) over the whole table, block by block, with the
    JAX kernel's tie rule (``_sphere_block_sweep``, :558-588): inside a
    block the first minimal t wins, across blocks only a strictly
    smaller t replaces the winner.  ``t_init`` (the shadow sweep's
    threshold) seeds best_t in place of BIG."""
    best_t = torch.full_like(ox, BIG) if t_init is None else t_init.clone()
    best_k = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    o3x, o3y, o3z = ox[:, None], oy[:, None], oz[:, None]
    d3x, d3y, d3z = dx[:, None], dy[:, None], dz[:, None]
    tm3, a3, inva3 = tm[:, None], a[:, None], inv_a[:, None]
    for b0 in range(0, tbl.shape[0], SPHERE_BLOCK):
        blk = tbl[b0:b0 + SPHERE_BLOCK]
        ocx = o3x - (blk[:, _C0X] + tm3 * blk[:, _DCX])
        ocy = o3y - (blk[:, _C0Y] + tm3 * blk[:, _DCY])
        ocz = o3z - (blk[:, _C0Z] + tm3 * blk[:, _DCZ])
        r_ = blk[:, _R]
        h = ocx * d3x + ocy * d3y + ocz * d3z
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
        disc = h * h - a3 * cc
        pos = disc > 0.0
        sq = torch.sqrt(torch.where(pos, disc, 1.0))
        near = (-h - sq) * inva3
        far = (-h + sq) * inva3
        bt3 = best_t[:, None]
        near_ok = (near >= T_MIN) & (near <= bt3)
        far_ok = (far >= T_MIN) & (far <= bt3)
        t_pair = torch.where(near_ok, near, far)
        t_pair = torch.where(pos & (near_ok | far_ok), t_pair, BIG)
        bk = torch.argmin(t_pair, dim=1)
        bt = torch.gather(t_pair, 1, bk[:, None])[:, 0]
        upd = bt < best_t
        best_t = torch.where(upd, bt, best_t)
        best_k = torch.where(upd, bk + b0, best_k)
    return best_t, best_k


def nearest_triangle(tris: TriTable, ox, oy, oz, dx, dy, dz, best_t, best_k,
                     base: int, *, flat: bool = False, cull: bool = True,
                     tally: Optional[list] = None):
    """Go on with a sweep's (best_t, best_k) over the triangle table
    (``_sweep_all``'s triangle half, :612-835): Moller-Trumbore in the
    determinant form of ``_mt_rows`` with the backface cull (without
    ``cull``, either side where ``|det|`` clears the floor, :676-679),
    winner ids ``base + row``.  Returns new (best_t, best_k).

    Each lane slab-tests a box with its current best_t and goes down only
    where its ray enters it: hyper-blocks, then their super-blocks, then
    their blocks, as fixed-order nested loops over the levels the table
    has (``flat`` tests every block box and skips the upper levels, as
    K1 does).  Inside a block the first minimal t wins, across blocks
    only a strictly smaller one: the JAX sweep's tie rule.  ``tally``,
    a list [box tests, triangle tests], gets the work added to it, as
    the kernels count it (padding rows past ``tris.count`` are not
    tested)."""
    best_t, best_k = best_t.clone(), best_k.clone()
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    org = (ox, oy, oz)
    t_min = torch.tensor(T_MIN, dtype=_F32, device=ox.device)
    tb = tris.block
    if flat or not tris.n_super:
        levels = [tris.boxes.tolist()]
    elif tris.n_hyper:
        levels = [tris.hypers.tolist(), tris.supers.tolist(),
                  tris.boxes.tolist()]
    else:
        levels = [tris.supers.tolist(), tris.boxes.tolist()]

    def entered(box, idx):
        """Lanes of ``idx`` whose ray enters ``box`` (``_box_enter_exit``,
        :444; fmin / fmax ignore a NaN from 0 * inf, as the kernels'
        fminf / fmaxf do)."""
        t0 = [(box[a] - org[a][idx]) * inv[a][idx] for a in range(3)]
        t1 = [(box[3 + a] - org[a][idx]) * inv[a][idx] for a in range(3)]
        lo = [torch.fmin(p, q) for p, q in zip(t0, t1)]
        hi = [torch.fmax(p, q) for p, q in zip(t0, t1)]
        enter = torch.fmax(torch.fmax(lo[0], lo[1]), torch.fmax(lo[2], t_min))
        exit_ = torch.fmin(torch.fmin(hi[0], hi[1]),
                           torch.fmin(hi[2], best_t[idx]))
        if tally is not None:
            tally[0] += idx.numel()
        return idx[exit_ > enter]

    def sweep(b, idx):
        rows = min(tb, tris.count - b * tb)
        if rows <= 0:
            return
        if tally is not None:
            tally[1] += idx.numel() * rows
        blk = tris.tbl[b * tb:b * tb + rows]
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) = (
            blk[:, c][None, :] for c in range(9))
        nxb = e1y * e2z - e1z * e2y
        nyb = e1z * e2x - e1x * e2z
        nzb = e1x * e2y - e1y * e2x
        # Bounded pair temporaries: (chunk, rows) float32 each.
        chunk = 1 << 16
        for start in range(0, idx.numel(), chunk):
            sub = idx[start:start + chunk]
            ux, uy, uz = ox[sub, None], oy[sub, None], oz[sub, None]
            vx, vy, vz = dx[sub, None], dy[sub, None], dz[sub, None]
            det = -(vx * nxb + vy * nyb + vz * nzb)
            det_ok = (det if cull else det.abs()) >= _DET_MIN
            invdet = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0),
                                 0.0)
            aox, aoy, aoz = ux - v0x, uy - v0y, uz - v0z
            daox = aoy * vz - aoz * vy
            daoy = aoz * vx - aox * vz
            daoz = aox * vy - aoy * vx
            u = (e2x * daox + e2y * daoy + e2z * daoz) * invdet
            v = -(e1x * daox + e1y * daoy + e1z * daoz) * invdet
            tt = (aox * nxb + aoy * nyb + aoz * nzb) * invdet
            bt_sub = best_t[sub]
            ok = (det_ok & (tt >= T_MIN) & (tt <= bt_sub[:, None])
                  & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
            t_pair = torch.where(ok, tt, BIG)
            bk = torch.argmin(t_pair, dim=1)
            bt = torch.gather(t_pair, 1, bk[:, None])[:, 0]
            upd = bt < bt_sub
            best_t[sub] = torch.where(upd, bt, bt_sub)
            best_k[sub] = torch.where(upd, bk + base + b * tb, best_k[sub])

    def descend(level, first, count, idx):
        for i in range(first, first + count):
            sub = entered(levels[level][i], idx)
            if not sub.numel():
                continue
            if level + 1 < len(levels):
                descend(level + 1, i * SUPER, SUPER, sub)
            else:
                sweep(i, sub)

    lanes = torch.arange(ox.numel(), device=ox.device)
    descend(0, 0, len(levels[0]), lanes)
    return best_t, best_k


def winner_rows(tbl, best_t, best_k, cols: int = 13) -> torch.Tensor:
    """(L, cols) table rows of the sweep's winners, 0 where nothing was
    hit (the JAX sweep's winner fetch; 16 columns with textures)."""
    return torch.where((best_t < BIG)[:, None], tbl[best_k, :cols], 0.0)


def winners(tbl, tris: Optional[TriTable], best_t, best_k, cols: int = 13):
    """The winner rows :func:`shade` takes: (sphere rows (L, cols), and
    for a scene with triangles (triangle rows (L, 15), is_tri) else
    None).  Each is 0 where the winner is of the other kind or nothing
    was hit, as the JAX sweep's deferred winner fetch leaves them."""
    if tris is None:
        return winner_rows(tbl, best_t, best_k, cols), None
    npad = tbl.shape[0]
    hit = best_t < BIG
    is_tri = best_k >= npad
    rows = torch.zeros((best_k.numel(), cols), dtype=_F32,
                       device=best_k.device)
    if npad:
        rows = torch.where((hit & ~is_tri)[:, None],
                           tbl[best_k.clamp(max=npad - 1), :cols], 0.0)
    trows = torch.where((hit & is_tri)[:, None],
                        tris.tbl[(best_k - npad).clamp(min=0), :TRI_PARAMS],
                        0.0)
    return rows, (trows, is_tri)


class Basics(NamedTuple):
    """The hit record (``_hit_basics``'s tuple)."""
    hit: torch.Tensor
    t_hit: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    front: torch.Tensor
    alr: torch.Tensor
    alg: torch.Tensor
    alb: torch.Tensor
    fuzz: torch.Tensor
    ir: torch.Tensor
    kind: torch.Tensor
    a: torch.Tensor


def hit_basics(state, w, best_t, tri=None, checker=False,
               cull=True) -> Basics:
    """The hit record re-derived from the winner's parameters
    (``_hit_basics``, :891-995): t (the sphere's root nearer the sweep's
    best_t; a triangle's (ao . n) / det), the point, the unit normal
    against the ray (a triangle's is the unit cross(e1, e2), always
    front-facing, as in the reference, src/common-model.cpp:122; without
    ``cull`` it is turned toward the ray, :965-968), and the winner's
    material.  ``checker`` (``w`` then has 16 columns)
    turns the CHECKER and NOISE albedos into the texture's value at the
    point.  Without ``tri`` no triangle operation runs, so sphere scenes
    shade exactly as before."""
    (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
    (c0x, c0y, c0z, dcx, dcy, dcz, r_, alr, alg, alb, fuzz, ir,
     kind) = w[:, :13].unbind(1)
    hit = best_t < BIG
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a

    # ---- t re-derived from the winner's parameters -------------------
    ocx = ox - (c0x + tm * dcx)
    ocy = oy - (c0y + tm * dcy)
    ocz = oz - (c0z + tm * dcz)
    h = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r_ * r_
    disc = h * h - a * cc
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    near = (-h - sq) * inv_a
    far = (-h + sq) * inv_a
    root_is_near = (near - best_t).abs() <= (far - best_t).abs()
    t_hit = torch.where(hit, torch.where(root_is_near, near, far), 1.0)
    if tri is not None:
        trows, is_tri = tri
        (tv0x, tv0y, tv0z, te1x, te1y, te1z, te2x, te2y, te2z, talr, talg,
         talb, tfuzz, tir, tkind) = trows.unbind(1)
        tnxb = te1y * te2z - te1z * te2y
        tnyb = te1z * te2x - te1x * te2z
        tnzb = te1x * te2y - te1y * te2x
        tdet = -(dx * tnxb + dy * tnyb + dz * tnzb)
        tdet_safe = torch.where(tdet.abs() > _EPS12, tdet, 1.0)
        t_tri = ((ox - tv0x) * tnxb + (oy - tv0y) * tnyb
                 + (oz - tv0z) * tnzb) / tdet_safe
        t_hit = torch.where(hit & is_tri, t_tri, t_hit)
        alr = torch.where(is_tri, talr, alr)
        alg = torch.where(is_tri, talg, alg)
        alb = torch.where(is_tri, talb, alb)
        fuzz = torch.where(is_tri, tfuzz, fuzz)
        ir = torch.where(is_tri, tir, ir)
        kind = torch.where(is_tri, tkind, kind)
    px = ox + t_hit * dx
    py = oy + t_hit * dy
    pz = oz + t_hit * dz
    r_abs = torch.where(r_ == 0.0, 1.0, r_.abs())
    nx = (px - (c0x + tm * dcx)) / r_abs
    ny = (py - (c0y + tm * dcy)) / r_abs
    nz = (pz - (c0z + tm * dcz)) / r_abs
    front = (dx * nx + dy * ny + dz * nz < 0.0) ^ (r_ < 0.0)
    flip = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    if tri is not None:
        # 1/sqrt where JAX has rsqrt: CUDA's rsqrtf is not IEEE, and the
        # kernels and this version must round alike.
        tl2 = tnxb * tnxb + tnyb * tnyb + tnzb * tnzb
        tl_ok = tl2 > 0.0
        tinv = torch.where(tl_ok, 1.0 / torch.sqrt(torch.where(tl_ok, tl2, 1.0)),
                           0.0)
        tnx, tny, tnz = tnxb * tinv, tnyb * tinv, tnzb * tinv
        if not cull:
            tflip = torch.where(dx * tnx + dy * tny + dz * tnz < 0.0, 1.0,
                                -1.0)
            tnx, tny, tnz = tnx * tflip, tny * tflip, tnz * tflip
        nx = torch.where(is_tri, tnx, nx)
        ny = torch.where(is_tri, tny, ny)
        nz = torch.where(is_tri, tnz, nz)
        front = is_tri | front
    if checker:
        # Textured albedos (spheres only): the second colour in columns
        # 13-15, the scale in the ir column.
        from ..models.materials import marble_t

        al2r, al2g, al2b = w[:, 13], w[:, 14], w[:, 15]
        sp = torch.sin(ir * px) * torch.sin(ir * py) * torch.sin(ir * pz)
        odd = (kind == _CHECKER) & (sp < 0.0)
        alr = torch.where(odd, al2r, alr)
        alg = torch.where(odd, al2g, alg)
        alb = torch.where(odd, al2b, alb)
        noise = kind == _NOISE
        mt = marble_t(px, py, pz, ir)
        alr = torch.where(noise, alr + (al2r - alr) * mt, alr)
        alg = torch.where(noise, alg + (al2g - alg) * mt, alg)
        alb = torch.where(noise, alb + (al2b - alb) * mt, alb)
    return Basics(hit, t_hit, px, py, pz, nx, ny, nz, front, alr, alg, alb,
                  fuzz, ir, kind, a)


def _is_diffuse(kind):
    """Lambertian, checker or noise: the kinds NEE samples from."""
    return (kind == 0.0) | (kind == _CHECKER) | (kind == _NOISE)


def nee_contrib(state, basics: Basics, alive, bounce, max_depth, nee_us,
                lit: Lit, v_event=None):
    """Next-event estimation short of the shadow ray's visibility
    (``_nee_contrib``, :1244-1326): the light sample from the hit point
    (or from the volume event's point, with the isotropic phase), the
    MIS balance weight against the scatter strategy, the shadow ray's
    medium transmittance.  Returns ((px, py, pz), (ldx, ldy, ldz),
    thresh, (cr, cg, cb), nee_act): the shadow ray, the distance it must
    reach, and the contribution to add where it does."""
    from .lights import sample_light_dirs

    (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, _rr, _rg, _rb) = state
    b = basics
    px, py, pz = b.px, b.py, b.pz
    pick, u1, u2 = nee_us
    v_act = None
    if v_event is not None:
        v_act = alive & v_event[0] & (bounce < max_depth)
        px = torch.where(v_act, ox + v_event[1] * dx, px)
        py = torch.where(v_act, oy + v_event[1] * dy, py)
        pz = torch.where(v_act, oz + v_event[1] * dz, pz)
    ldx, ldy, ldz, t_l, (w0, w1, w2), l_pdf = sample_light_dirs(
        lit.lights(), lit.nee_kinds, pick, u1, u2, px, py, pz, tm)
    nee_act = alive & b.hit & (bounce < max_depth) & _is_diffuse(b.kind)
    if v_event is not None:
        nee_act = (nee_act & ~v_event[0]) | v_act
    thresh = t_l * _SHADOW_FRAC
    cos_t = torch.clamp(b.nx * ldx + b.ny * ldy + b.nz * ldz, min=0.0)
    phase = cos_t * _INV_PI
    factor = cos_t
    nar, nag, nab = b.alr, b.alg, b.alb
    if v_event is not None:
        phase = torch.where(v_act, _QUARTER_INV_PI, phase)
        factor = torch.where(v_act, 0.25, factor)
        nar = torch.where(v_act, v_event[2], nar)
        nag = torch.where(v_act, v_event[3], nag)
        nab = torch.where(v_act, v_event[4], nab)
    w_l = l_pdf / torch.clamp(l_pdf + phase, min=_EPS12)
    if lit.vol_kinds:
        from .volumes import volume_transmittance

        factor = factor * volume_transmittance(
            lit.volumes(), lit.vol_kinds, px, py, pz, ldx, ldy, ldz, t_l)
    cw = factor * w_l
    contrib = (tpr * nar * w0 * cw, tpg * nag * w1 * cw, tpb * nab * w2 * cw)
    return (px, py, pz), (ldx, ldy, ldz), thresh, contrib, nee_act


def shade(state, w, draws, best_t, alive, bounce, max_depth, background,
          tri=None, *, basics: Optional[Basics] = None, lit: Lit = Lit(),
          from_diffuse=None, v_event=None, rr_u=None):
    """The differentiable half of a bounce (``_shade_pure``,
    :998-1222): winner rows -> new state.

    ``state`` is the 13-tuple (ox oy oz dx dy dz tm tpr tpg tpb rr rg rb),
    ``w`` the sphere winner rows from :func:`winner_rows` (or
    :func:`winners`), ``draws`` from :func:`draw_scatter`, ``best_t`` the
    sweep's t, ``alive`` a bool mask and ``bounce`` the int32 bounce
    counts; ``tri``, for a scene with triangles, is (triangle winner rows
    (L, 15), is_tri) from :func:`winners`; ``basics`` the hit record if
    it was already taken (:func:`hit_basics`).  Returns (new 13-tuple
    with ``tm`` passed through, ``can``, new ``bounce``).  Dead lanes pass
    through; a live miss adds throughput * background and retires; a live
    hit at ``max_depth`` retires; every other live hit scatters.

    The lit features (``lit``; all off by default, and then no lit
    operation runs): an EMISSIVE hit adds throughput * emit (weighted
    against the light sample with ``from_diffuse``, the previous
    bounce's diffuse flags, under NEE) and retires, at any depth;
    ``v_event`` (v_hit, v_t, albedo rgb, direction xyz) overrides the
    surface and the sky with a volume scatter; ``rr_u`` plays Russian
    roulette past ``RR_START`` scatters.  Under NEE ``can`` is the alive
    code (0 dead, 1 alive, 2 alive after a diffuse or volume scatter).

    The intersection t is re-derived from the winner's parameters, so
    autograd through this function gives the exact geometry gradient.
    Every branch that is computed and then not selected is guarded
    ("safe where"), so it puts no NaN into the gradient."""
    (ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb) = state
    uvx, uvy, uvz, choice = draws
    use_sky, bg = background_args(background)
    if basics is None:
        basics = hit_basics(state, w, best_t, tri=tri, checker=lit.checker)
    (hit, t_hit, px, py, pz, nx, ny, nz, front, alr, alg, alb, fuzz, ir,
     kind, a) = basics

    # Lambertian: n + unit (degenerate -> n).
    lamx, lamy, lamz = nx + uvx, ny + uvy, nz + uvz
    degen = lamx * lamx + lamy * lamy + lamz * lamz < _EPS12
    lamx = torch.where(degen, nx, lamx)
    lamy = torch.where(degen, ny, lamy)
    lamz = torch.where(degen, nz, lamz)

    # Metal: reflect(raw d) + fuzz * unit (no horizon check — reference).
    ddn2 = 2.0 * (dx * nx + dy * ny + dz * nz)
    mrx = dx - ddn2 * nx + fuzz * uvx
    mry = dy - ddn2 * ny + fuzz * uvy
    mrz = dz - ddn2 * nz + fuzz * uvz

    # Dielectric: Schlick + total internal reflection, + fuzz.  sin_t
    # only feeds the TIR test; its epsilon floor keeps sqrt'(0) out of
    # the gradient at normal incidence (pallas_megakernel.py:1056-1059).
    inv_dlen = 1.0 / torch.sqrt(a)
    udx, udy, udz = dx * inv_dlen, dy * inv_dlen, dz * inv_dlen
    cos_t = torch.minimum(-(udx * nx + udy * ny + udz * nz),
                          torch.ones_like(a))
    sin_t = torch.sqrt(torch.maximum(1.0 - cos_t * cos_t,
                                     torch.full_like(a, _EPS12)))
    ir_safe = torch.where(ir > 0.0, ir, 1.0)
    ratio = torch.where(front, 1.0 / ir_safe, ir_safe)
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    refl_p = r0 + (1.0 - r0) * omc2 * omc2 * omc
    must_reflect = cannot | (refl_p > choice)
    k_raw = 1.0 - ratio * ratio * (1.0 - cos_t * cos_t)
    k_ok = k_raw > 0.0
    sqk = torch.where(k_ok, torch.sqrt(torch.where(k_ok, k_raw, 1.0)), 0.0)
    rfx = ratio * udx + (ratio * cos_t - sqk) * nx
    rfy = ratio * udy + (ratio * cos_t - sqk) * ny
    rfz = ratio * udz + (ratio * cos_t - sqk) * nz
    udn2 = 2.0 * (udx * nx + udy * ny + udz * nz)
    dix = torch.where(must_reflect, udx - udn2 * nx, rfx) + fuzz * uvx
    diy = torch.where(must_reflect, udy - udn2 * ny, rfy) + fuzz * uvy
    diz = torch.where(must_reflect, udz - udn2 * nz, rfz) + fuzz * uvz

    is_metal = kind == _METAL
    is_diel = kind == _DIELECTRIC
    sdx = torch.where(is_metal, mrx, torch.where(is_diel, dix, lamx))
    sdy = torch.where(is_metal, mry, torch.where(is_diel, diy, lamy))
    sdz = torch.where(is_metal, mrz, torch.where(is_diel, diz, lamz))
    atr = torch.where(is_diel, 1.0, alr)
    atg = torch.where(is_diel, 1.0, alg)
    atb = torch.where(is_diel, 1.0, alb)

    if v_event is not None:
        v_hit = v_event[0] & alive
        v_can = v_hit & (bounce < max_depth)
        # The free-flight point on the incoming ray.
        vpx = ox + v_event[1] * dx
        vpy = oy + v_event[1] * dy
        vpz = oz + v_event[1] * dz
    else:
        v_hit = v_can = torch.zeros_like(alive)

    # ---- background for live lanes that missed ----------------------
    missed = alive & ~hit & ~v_hit
    if use_sky:  # the reference's sky gradient
        sky_t = 0.5 * (dy * (1.0 / torch.sqrt(a)) + 1.0)
        skyr = 1.0 - sky_t + sky_t * 0.5
        skyg = 1.0 - sky_t + sky_t * 0.7
        skyb = 1.0
    else:
        skyr, skyg, skyb = bg
    rr = rr + torch.where(missed, tpr * skyr, 0.0)
    rg = rg + torch.where(missed, tpg * skyg, 0.0)
    rb = rb + torch.where(missed, tpb * skyb, 0.0)

    # ---- advance (depth is checked after the hit) -------------------
    can = alive & hit & (bounce < max_depth) & ~v_hit
    if lit.emissive:
        # An emissive hit adds throughput * emit and retires the lane,
        # whatever its depth; under NEE a diffuse-scattered ray's hit is
        # weighted against the light sample (balance heuristic, the
        # scatter pdf recovered as |d| / (2 pi) from the raw n + unit
        # direction).
        is_emis = kind == _EMISSIVE
        lit_hit = alive & hit & is_emis & ~v_hit
        w_emit = 1.0
        if from_diffuse is not None:
            from .lights import light_pdf_toward

            p_l = light_pdf_toward(lit.lights(), lit.nee_kinds, ox, oy, oz,
                                   dx, dy, dz, t_hit, tm)
            p_b = torch.sqrt(a) * _HALF_INV_PI
            w_emit = torch.where(from_diffuse,
                                 p_b / torch.clamp(p_b + p_l, min=_EPS12), 1.0)
        rr = rr + torch.where(lit_hit, tpr * alr * w_emit, 0.0)
        rg = rg + torch.where(lit_hit, tpg * alg * w_emit, 0.0)
        rb = rb + torch.where(lit_hit, tpb * alb * w_emit, 0.0)
        can = can & ~is_emis
    ox = torch.where(can, px, ox)
    oy = torch.where(can, py, oy)
    oz = torch.where(can, pz, oz)
    dx = torch.where(can, sdx, dx)
    dy = torch.where(can, sdy, dy)
    dz = torch.where(can, sdz, dz)
    tpr = torch.where(can, tpr * atr, tpr)
    tpg = torch.where(can, tpg * atg, tpg)
    tpb = torch.where(can, tpb * atb, tpb)
    bounce = bounce + can.to(torch.int32)
    if v_event is not None:
        # A volume scatter: to the free-flight point, the isotropic
        # direction, the medium's albedo; one bounce of the budget.
        ox = torch.where(v_can, vpx, ox)
        oy = torch.where(v_can, vpy, oy)
        oz = torch.where(v_can, vpz, oz)
        dx = torch.where(v_can, v_event[5], dx)
        dy = torch.where(v_can, v_event[6], dy)
        dz = torch.where(v_can, v_event[7], dz)
        tpr = torch.where(v_can, tpr * v_event[2], tpr)
        tpg = torch.where(v_can, tpg * v_event[3], tpg)
        tpb = torch.where(v_can, tpb * v_event[4], tpb)
        bounce = bounce + v_can.to(torch.int32)
    if rr_u is not None:
        # Russian roulette on the post-increment bounce count: a lane past
        # RR_START scatters survives with p = clamp(max throughput
        # channel, RR_PMIN, 1), boosted by 1 / p.
        p = torch.clamp(torch.maximum(torch.maximum(tpr, tpg), tpb),
                        RR_PMIN, 1.0)
        consider = (can | v_can) & (bounce > RR_START)
        kill = consider & (rr_u >= p)
        boost = torch.where(consider & ~kill, 1.0 / p, 1.0)
        tpr, tpg, tpb = tpr * boost, tpg * boost, tpb * boost
        can = can & ~kill
        v_can = v_can & ~kill
    if from_diffuse is not None:
        can = can.to(torch.int32) * torch.where(_is_diffuse(kind), 2, 1)
        can = torch.where(v_can, 2, can)
    elif v_event is not None:
        can = can | v_can
    return ((ox, oy, oz, dx, dy, dz, tm, tpr, tpg, tpb, rr, rg, rb), can,
            bounce)


# ---------------------------------------------------------------------------
# The wrapper.


def check_table(tbl: torch.Tensor, kernel: str, copies: int = 1,
                staged: int = 0) -> None:
    """Raise unless ``tbl`` is a sphere table the kernel ``kernel`` takes:
    a contiguous (k*128, 16) float32 tensor (k may be 0) on the CPU (the
    plain version) or on a CUDA device, where ``copies`` times its bytes
    plus the ``staged`` bytes the kernel keeps beside it must fit in a
    block's shared memory and it must be 16-byte aligned."""
    if tbl.dtype != _F32 or tbl.dim() != 2 or tbl.shape[1] != TBL_COLS \
            or tbl.shape[0] % SPHERE_BLOCK or not tbl.is_contiguous():
        raise ValueError(
            f"sphere table must be a contiguous (k*{SPHERE_BLOCK}, "
            f"{TBL_COLS}) float32 tensor, got {tuple(tbl.shape)} {tbl.dtype}")
    if tbl.device.type == "cpu":
        return
    nbytes = copies * tbl.numel() * 4 + staged
    if nbytes > MAX_TABLE_BYTES:
        raise ValueError(
            f"{tbl.shape[0]} table rows and {staged} bytes of light and "
            f"volume rows ({nbytes} bytes) exceed the {kernel}'s "
            f"shared-memory table ({MAX_TABLE_BYTES} bytes)")
    if tbl.device.type != "cuda":
        raise ValueError(f"no {kernel} for device {tbl.device}")
    if tbl.data_ptr() % 16:
        raise ValueError("sphere table must be 16-byte aligned")


def check_tris(tris: TriTable, tbl: torch.Tensor, kernel: str) -> None:
    """Raise unless ``tris`` is a triangle table on ``tbl``'s device that
    the kernel ``kernel`` takes: contiguous float32 (Mpad, 16) rows and
    (n, 8) boxes of every level, 16-byte aligned on a card."""
    nb = tris.n_blocks
    shapes = ((tris.tbl, (nb * tris.block, TBL_COLS)), (tris.boxes, (nb, 8)),
              (tris.supers, (tris.supers.shape[0], 8)),
              (tris.hypers, (tris.hypers.shape[0], 8)))
    for t, shape in shapes:
        if (t.dtype != _F32 or tuple(t.shape) != shape or nb < 1
                or not t.is_contiguous() or t.device != tbl.device
                or (t.device.type == "cuda" and t.data_ptr() % 16)):
            raise ValueError(
                f"{kernel}: triangle tables must be contiguous, 16-byte "
                f"aligned float32 (Mpad, 16) rows and (n, 8) boxes on the "
                f"sphere table's device")
    if not 0 < tris.count <= tris.tbl.shape[0]:
        raise ValueError(f"{kernel}: bad triangle count {tris.count}")
    if tris.n_super and (nb != tris.n_super * SUPER or (
            tris.n_hyper and tris.n_super != tris.n_hyper * SUPER)):
        raise ValueError(f"{kernel}: the triangle hierarchy's levels do not "
                         f"divide by {SUPER}")


def check_counter(t: Optional[torch.Tensor], n: int, tbl: torch.Tensor,
                  name: str) -> None:
    """Raise unless ``t`` is None or an (n,) int64 tensor on ``tbl``'s
    device (a stats counter)."""
    if t is not None and (t.dtype != torch.int64 or tuple(t.shape) != (n,)
                          or t.device != tbl.device):
        raise ValueError(f"{name} must be a ({n},) int64 tensor on the "
                         f"table's device")


def render_blocks(
    tbl: torch.Tensor,
    cam: torch.Tensor,
    meta: Tuple[int, ...],
    n_tiles: int,
    *,
    background: Union[str, tuple] = "sky",
    steps: Optional[torch.Tensor] = None,
    tris: Optional[TriTable] = None,
    tests: Optional[torch.Tensor] = None,
    lit: Lit = Lit(),
    shadows: Optional[torch.Tensor] = None,
    cull: bool = True,
    pool: Optional[bool] = None,
    pool_chunk: Optional[int] = None,
    pool_k: Optional[int] = None,
    slots: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radiance sums of tiles ``tile0 .. tile0 + n_tiles - 1`` as three
    (n_tiles * 8, 128) float32 planes (``render_blocks_pallas``, :2004).

    ``tbl``: (Npad, 16) sphere table from :func:`build_sphere_table`;
    ``tris``: the triangle table from ``build_tri_table(scene,
    K1_TRI_BLOCK)`` or None (swept flat, block by block); ``cam``: (21,)
    vector from :func:`pack_camera`; ``meta``: the scalars from
    :func:`pack_meta`.  A CUDA ``tbl`` launches the CUDA kernel (and
    counts the launch in ``render_blocks.launches``); a CPU ``tbl`` runs
    :func:`render_blocks_reference`; any other device raises.  Stats
    counters, int64 on ``tbl``'s device: ``steps`` (1,) gets the ray
    steps (bounces) of the render added to it, ``tests`` (2,) the block
    box tests and the triangle tests (the shadow sweeps' included),
    ``shadows`` (1,) the NEE shadow rays.  ``lit``: the lit features and
    their light and volume rows (:func:`scene_lit`); a launch with any
    of them runs a lit instance and is also counted in
    ``render_blocks.lit_launches``.  ``cull`` False makes the triangles
    two-sided (``render_blocks_pallas(cull=False)``, :2013).

    The scheduler: the work pool where ``pool`` is True, the classic one
    where it is False; ``pool``, ``pool_chunk`` and ``pool_k`` left None
    are read from ``RTOW_POOL``, ``RTOW_POOL_CHUNK`` and ``RTOW_POOL_K``
    at each call (:func:`pool_knobs`).  A pool launch is also counted in
    ``render_blocks.pool_launches``.  ``slots`` (1,) gets the lane slots
    added to it, the lane-iterations a launch holds lanes for: 128 x
    each row's iterations under the pool, 32 x each warp's longest loop
    under the classic scheduler; ``steps / slots`` is the occupancy."""
    knobs = pool_knobs(pool, pool_chunk, pool_k)
    check_lit(lit, tbl)
    check_table(tbl, "megakernel",
                staged=(lit_rows(lit) * LIGHT_COLS * 4
                        + (POOL_STAGE_BYTES if knobs.on else 0)))
    if tris is not None:
        check_tris(tris, tbl, "megakernel")
    check_counter(tests, 2, tbl, "tests")
    if cam.dtype != _F32 or tuple(cam.shape) != (21,) \
            or not cam.is_contiguous() or cam.device != tbl.device:
        raise ValueError("camera must be a contiguous (21,) float32 tensor "
                         "on the table's device")
    if len(meta) != 7 or n_tiles < 1:
        raise ValueError(f"bad meta {meta} / n_tiles {n_tiles}")
    check_counter(steps, 1, tbl, "steps")
    check_counter(shadows, 1, tbl, "shadows")
    check_counter(slots, 1, tbl, "slots")
    seed, width, height, _n_pixels, tile0, spp, max_depth = meta
    if knobs.on and -(-spp // knobs.chunk) * LANES >= 1 << 31:
        raise ValueError(f"spp {spp} makes more pool items than int32 holds")
    if tbl.device.type == "cpu":
        return render_blocks_reference(
            tbl, cam, meta, n_tiles, background=background, steps=steps,
            tris=tris, tests=tests, lit=lit, shadows=shadows, cull=cull,
            pool=knobs.on, pool_chunk=knobs.chunk, pool_k=knobs.k,
            slots=slots)
    lib = _lib()
    use_sky, (bgr, bgg, bgb) = background_args(background)
    out = torch.empty((3, n_tiles * TILE_ROWS, LANES), dtype=_F32,
                      device=tbl.device)
    err = lib.rtow_megakernel(
        tbl.data_ptr(), tbl.shape[0],
        None if tris is None else tris.tbl.data_ptr(),
        None if tris is None else tris.boxes.data_ptr(),
        0 if tris is None else tris.n_blocks,
        0 if tris is None else tris.block,
        0 if tris is None else tris.count,
        cam.data_ptr(), seed, width, height,
        tile0, spp, max_depth, n_tiles, int(use_sky), bgr, bgg, bgb,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        None if steps is None else steps.data_ptr(),
        None if tests is None else tests.data_ptr(),
        None if shadows is None else shadows.data_ptr(),
        *lit_args(lit, tbl), int(cull), int(knobs.on), knobs.chunk,
        knobs.k, None if slots is None else slots.data_ptr(),
        *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "megakernel")
    render_blocks.launches += 1
    render_blocks.lit_launches += lit.any
    render_blocks.pool_launches += knobs.on
    return out[0], out[1], out[2]


#: Kernel launches made by :func:`render_blocks` in this process, those of
#: them that ran a lit instance, and those that ran the pool scheduler.
render_blocks.launches = 0
render_blocks.lit_launches = 0
render_blocks.pool_launches = 0


def unblock_image(r, g, b, *, width: int, height: int) -> torch.Tensor:
    """Block rows (tiles * 8, 128) x3 -> (H * W, 3) image order
    (``unblock_image``, :2143)."""
    tiles_x = -(-width // LANES)
    tiles_y = -(-height // TILE_ROWS)

    def unblock(x):
        img = x.reshape(tiles_y, tiles_x, TILE_ROWS, LANES)
        img = img.permute(0, 2, 1, 3).reshape(tiles_y * TILE_ROWS,
                                              tiles_x * LANES)
        return img[:height, :width].reshape(-1)

    return torch.stack([unblock(r), unblock(g), unblock(b)], dim=-1)


def _kind_bits(kinds, names: str) -> int:
    """The kernel's code of a kind tuple: 2 bits per entry, entry j's
    index in ``names`` at bits 2j, 2j + 1."""
    return sum(names.index(k) << (2 * j) for j, k in enumerate(kinds))


def lit_args(lit: Lit, tbl: torch.Tensor) -> tuple:
    """The lit features as the kernels' C entry points take them: the
    rows' address (``tbl``'s where there are none), emissive, the
    lights' count and kind bits, checker, the volumes' count and kind
    bits, their first row, roulette."""
    rows = lit.rows if lit.rows is not None else tbl
    return (rows.data_ptr(), int(lit.emissive), len(lit.nee_kinds),
            _kind_bits(lit.nee_kinds, "st"), int(lit.checker),
            len(lit.vol_kinds), _kind_bits(lit.vol_kinds, "sbr"),
            lit.vol_row0, int(lit.roulette))


def lit_rows(lit: Lit) -> int:
    """The light and volume rows a launch reads (and stages in shared
    memory): the lights, then the volumes from ``vol_row0``."""
    return (lit.vol_row0 + len(lit.vol_kinds) if lit.vol_kinds
            else len(lit.nee_kinds))


def check_lit(lit: Lit, tbl: torch.Tensor) -> None:
    """Raise unless ``lit``'s rows and features agree and its rows are a
    contiguous (K + V, 14) float32 tensor on ``tbl``'s device."""
    from ..models.scene import MAX_LIGHTS, MAX_VOLUMES

    if (len(lit.nee_kinds) > MAX_LIGHTS or len(lit.vol_kinds) > MAX_VOLUMES
            or not set(lit.nee_kinds) <= {"s", "t"}
            or not set(lit.vol_kinds) <= {"s", "b", "r"}):
        raise ValueError(f"lit features: at most {MAX_LIGHTS} lights of "
                         f"kinds 's', 't' and {MAX_VOLUMES} volumes of kinds "
                         f"'s', 'b', 'r', got {lit.nee_kinds!r} and "
                         f"{lit.vol_kinds!r}")
    need = lit_rows(lit)
    if lit.vol_kinds and lit.vol_row0 < len(lit.nee_kinds):
        raise ValueError(f"volume rows start at {lit.vol_row0}, inside the "
                         f"{len(lit.nee_kinds)} light rows")
    if need and (lit.rows is None or lit.rows.dtype != _F32
                 or lit.rows.dim() != 2 or lit.rows.shape[1] != LIGHT_COLS
                 or lit.rows.shape[0] < need
                 or not lit.rows.is_contiguous()
                 or lit.rows.device != tbl.device):
        raise ValueError(f"lit rows must be a contiguous (>= {need}, "
                         f"{LIGHT_COLS}) float32 tensor on the table's "
                         f"device")


def scene_lit(scene, roulette: bool = False) -> Lit:
    """The lit features of ``scene`` and their rows, as
    ``render_blocks_pallas`` derives them (:2077-2102): NEE toward the
    scene's lights when it has an emissive material, its media, its
    textures, and ``roulette``."""
    from .lights import build_light_table
    from .volumes import build_volume_table

    nee_kinds = (tuple(k for k, _ in scene.light_ids)
                 if scene.has_emissive else ())
    rows = [build_light_table(scene)] if nee_kinds else []
    vol_row0 = rows[0].shape[0] if rows else 0
    if scene.volume_kinds:
        rows.append(build_volume_table(scene))
    return Lit(emissive=scene.has_emissive, nee_kinds=nee_kinds,
               checker=scene.has_checker,
               vol_kinds=tuple(scene.volume_kinds), vol_row0=vol_row0,
               roulette=bool(roulette),
               rows=torch.cat(rows).contiguous() if rows else None)


def scene_k1_tables(scene) -> Tuple[torch.Tensor, Optional[TriTable]]:
    """K1's tables of a scene: (sphere table, triangle table at
    ``K1_TRI_BLOCK`` rows per block or None)."""
    tbl, _boxes = build_sphere_table(scene)
    tris = (build_tri_table(scene, K1_TRI_BLOCK) if scene.n_triangles
            else None)
    return tbl, tris


def render_spheres(scene, camera, seed: int, *, width: int, height: int,
                   spp: int, max_depth: int, roulette: bool = False,
                   cull: bool = True, pool: Optional[bool] = None,
                   pool_chunk: Optional[int] = None,
                   pool_k: Optional[int] = None) -> torch.Tensor:
    """Whole-frame render of a sphere or small-mesh scene -> (n_pixels,
    3) radiance sums (``render_spheres_pallas``, :2163); ``cull`` False
    makes the triangles two-sided; the scheduler as :func:`render_blocks`
    picks it."""
    tbl, tris = scene_k1_tables(scene)
    meta = pack_meta(seed, width=width, height=height, spp=spp,
                     max_depth=max_depth)
    r, g, b = render_blocks(tbl, pack_camera(camera), meta,
                            n_tiles_for(width, height),
                            background=scene.background, tris=tris,
                            lit=scene_lit(scene, roulette), cull=cull,
                            pool=pool, pool_chunk=pool_chunk, pool_k=pool_k)
    return unblock_image(r, g, b, width=width, height=height)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/megakernel.cu``, built at first use, with its C entry
    points declared."""
    lib = _cuda.load("megakernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtow_megakernel.argtypes = [p, i, p, p, i, i, i, p, i, i, i, i, i,
                                    i, i, i, f, f, f, p, p, p, p, p, p,
                                    p, i, i, i, i, i, i, i, i, i, i, i, i,
                                    p, i, p]
    lib.rtow_megakernel.restype = i
    return lib
