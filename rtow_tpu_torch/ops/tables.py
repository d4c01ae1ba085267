"""What the kernels read of a scene, built on the host: the sphere and
triangle tables, the camera and the scalars packed as the launches take
them, the lit features with their light and volume rows, the checks the
kernels' wrappers make of all of these, and one builder per kernel
family (:func:`k1_tables`, :func:`k3_tables`, :func:`grad_tables`; the
port of ``pallas_megakernel.py``'s table builders, :134-387,
``wavefront_sorted._scene_tables`` and ``render_pixels_kernel``'s
set-up, ``pallas_grad.py:861-967``).

The sphere table keeps the JAX package's Morton order and the triangle
table its median-split order (Morton order on the gradient path, as JAX
builds it under ``jit``), so the nearest hit resolves ties the same way:
the winner is the first minimal ``t`` in table order, spheres before
triangles (winner ids: spheres ``0 .. Npad - 1``, triangles from
``Npad``).  Sphere table rows (16 float32): center0, dcenter, radius,
albedo, fuzz, ir, the material kind, the second colour of a texture;
triangle rows: v0, e1, e2, albedo, fuzz, ir, kind, 0.

Each table is built in two parts: its layout (``sphere_layout``,
``tri_layout``, :func:`grad_layout`: the orders, the boxes and
hierarchy, the sort grid, the checks), a detached function of the
geometry and the integer leaves, then its rows (``sphere_rows``,
``tri_rows``, :func:`grad_rows`), gathered through the layout from the
leaves, differentiable.  The renders build both every frame; a train
step keeps the layout while its geometry stands (``diff``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.scene import IMAGE, MAX_LIGHTS, MAX_VOLUMES
from ..utils.profiling import span
from .lights import LIGHT_COLS, build_light_table
from .volumes import build_volume_table

TILE_ROWS = 8
LANES = 128
TILE = TILE_ROWS * LANES
#: Spheres per Morton block (table rows are padded to a multiple).
SPHERE_BLOCK = 128
#: K1's sphere cull: rows per group of the table (:func:`sphere_groups`;
#: ``kSphereGroup`` in ``csrc/bounce.cuh``, fixed at compile time).
SPHERE_GROUP = 16

# Sphere-table columns.
(_C0X, _C0Y, _C0Z, _DCX, _DCY, _DCZ, _R, _ALR, _ALG, _ALB, _FUZZ, _IR,
 _KIND) = range(13)
TBL_COLS = 16

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

#: Largest table the kernel's shared memory holds (227 KB per block on
#: Hopper): 3,632 spheres.
MAX_TABLE_BYTES = 232448

#: Meshes larger than this take the sorted-wavefront path (K3) and sort
#: the gradient path's lanes; smaller ones stay on the megakernel (K1).
WAVEFRONT_MIN_TRIS = 16384

#: The gradient path's triangle-block width: the JAX module global
#: ``TRI_BLOCK``, which ``render_pixels_kernel`` does not re-pick per
#: scene (pallas_megakernel.py:71, :85).
GRAD_TRI_BLOCK = 128
#: Caps on the gradient path's triangle blocks (pallas_grad.py:867,
#: :886): in all, and on the flat sweep.
MAX_TRI_BLOCKS = 4096
MAX_FLAT_TRI_BLOCKS = 1536

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Host tables and packing.


class SphereLayout(NamedTuple):
    """The detached part of the sphere table (:func:`sphere_layout`): the
    Morton order of the rows and each row's material (None without
    spheres), the padding rows that close the table, and the (NB, 8)
    block AABBs."""
    order: Optional[torch.Tensor]
    mid: Optional[torch.Tensor]
    pad: torch.Tensor
    boxes: torch.Tensor


def sphere_layout(scene) -> SphereLayout:
    """The :class:`SphereLayout` of ``scene``: a function of its sphere
    geometry and material ids alone, which no gradient reaches."""
    sp = scene.spheres
    n = sp.radius.shape[0]
    npad = -(-n // SPHERE_BLOCK) * SPHERE_BLOCK
    dev = sp.radius.device
    if n == 0:
        return SphereLayout(None, None,
                            torch.zeros((0, TBL_COLS), dtype=_F32, device=dev),
                            torch.zeros((0, 8), dtype=_F32, device=dev))

    with torch.no_grad():
        r_abs = sp.radius.abs()[:, None]
        c1 = sp.center0 + sp.dcenter
        smin = torch.minimum(sp.center0, c1) - r_abs
        smax = torch.maximum(sp.center0, c1) + r_abs
        cent = 0.5 * (smin + smax)
        order = morton_order(smin.amin(dim=0), smax.amax(dim=0), cent)
        mid = sp.material[order].long()
        smin, smax = smin[order], smax[order]
        pad = torch.zeros((npad - n, TBL_COLS), dtype=_F32, device=dev)
        pad[:, _C0X] = _PAD_CENTER

        big = 1.0e30
        bmin = torch.cat([smin, torch.full((npad - n, 3), big, device=dev)])
        bmax = torch.cat([smax, torch.full((npad - n, 3), -big, device=dev)])
        nb = npad // SPHERE_BLOCK
        blk_min = bmin.reshape(nb, SPHERE_BLOCK, 3).amin(dim=1)
        blk_max = bmax.reshape(nb, SPHERE_BLOCK, 3).amax(dim=1)
        pad_eps = 1e-4 + 1e-4 * (blk_max - blk_min).abs()
        boxes = torch.cat([blk_min - pad_eps, blk_max + pad_eps,
                           torch.zeros((nb, 2), dtype=_F32, device=dev)],
                          dim=1)
    return SphereLayout(order, mid, pad, boxes.to(_F32))


def sphere_rows(scene, lay: SphereLayout) -> torch.Tensor:
    """The (Npad, 16) sphere table of ``scene`` laid out by ``lay``: its
    rows gathered from the scene's leaves, through which autograd
    carries the table's cotangent back."""
    if lay.order is None:
        return torch.zeros((0, TBL_COLS), dtype=_F32, device=lay.pad.device)
    sp = scene.spheres
    mats = scene.materials
    order, mid = lay.order, lay.mid
    c0 = sp.center0[order]
    dc = sp.dcenter[order]
    tbl = torch.stack([
        c0[:, 0], c0[:, 1], c0[:, 2],
        dc[:, 0], dc[:, 1], dc[:, 2],
        sp.radius[order],
        mats.albedo[mid, 0], mats.albedo[mid, 1], mats.albedo[mid, 2],
        mats.fuzz[mid], mats.ir[mid], mats.kind[mid].to(_F32),
        mats.albedo2[mid, 0], mats.albedo2[mid, 1], mats.albedo2[mid, 2],
    ], dim=1).to(_F32)
    return torch.cat([tbl, lay.pad])


def build_sphere_table(scene) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere tables ((Npad, 16) params, (NB, 8) block AABBs) on the
    scene's device (``build_sphere_table``, :134).

    Rows are in Morton order of the spheres' motion-swept bounds;
    padding rows have r = 0 and a far-away center, so they are never
    hit.  The block boxes are the JAX kernel's culling boxes; K1 culls
    by the finer groups of :func:`sphere_groups` instead, and K3, K4 and
    K5 sweep every row.  A scene without
    spheres gets empty tables (the JAX kernels' ``n_blocks = 0``)."""
    lay = sphere_layout(scene)
    return sphere_rows(scene, lay), lay.boxes


#: A padding row's centre x (its radius is 0).
_PAD_CENTER = 1.0e9


def sphere_groups(tbl: torch.Tensor,
                  shutter: Tuple[float, float] = (0.0, 1.0)) -> torch.Tensor:
    """The boxes of sphere table ``tbl``'s groups of ``SPHERE_GROUP``
    rows in table (Morton) order, (npad / SPHERE_GROUP, 8) float32 (min
    xyz, max xyz, 0, 0) on ``tbl``'s device: K1's sphere cull, the port's
    counterpart of the JAX kernel's 128-row block boxes.

    A group's box holds each of its rows' bounds swept over the times
    [min(t0, 0), max(t1, 1)] of ``shutter`` = (t0, t1) (the centre moves
    linearly, so its two ends bound it), padded as
    :func:`build_sphere_table` pads its blocks (1e-4 + 1e-4 x extent), so
    a ray that hits a row below its best t enters the row's box first.
    Padding rows (radius 0, centre at 1e9) are never hit and are left
    out: a group of padding only gets a box at +infinity, never entered."""
    t_lo, t_hi = min(float(shutter[0]), 0.0), max(float(shutter[1]), 1.0)
    c0, dc = tbl[:, _C0X:_DCX], tbl[:, _DCX:_R]
    ca, cb = c0 + t_lo * dc, c0 + t_hi * dc
    r_abs = tbl[:, _R:_R + 1].abs()
    pad = ((tbl[:, _R] == 0.0) & (tbl[:, _C0X] == _PAD_CENTER))[:, None]
    big = 1.0e30
    smin = torch.where(pad, big, torch.minimum(ca, cb) - r_abs)
    smax = torch.where(pad, -big, torch.maximum(ca, cb) + r_abs)
    ng = tbl.shape[0] // SPHERE_GROUP
    gmin = smin.reshape(ng, SPHERE_GROUP, 3).amin(dim=1)
    gmax = smax.reshape(ng, SPHERE_GROUP, 3).amax(dim=1)
    pad_eps = 1e-4 + 1e-4 * (gmax - gmin).abs()
    lo, hi = gmin - pad_eps, gmax + pad_eps
    # A group of padding only: a box at infinity, which no ray enters (an
    # inverted box would pass the slab test, whose min / max swap it).
    empty = (gmin > gmax).any(dim=1, keepdim=True)
    lo, hi = torch.where(empty, math.inf, lo), torch.where(empty, math.inf, hi)
    boxes = torch.cat([lo, hi, torch.zeros((ng, 2), dtype=_F32,
                                           device=tbl.device)], dim=1)
    return boxes.to(_F32).contiguous()


def camera_shutter(cam: torch.Tensor) -> Tuple[float, float]:
    """(t0, t1) of a camera vector from :func:`pack_camera` (a host sync
    where ``cam`` is on a card)."""
    with span("rtow.sync.camera_shutter"):
        t0, dt = cam[19:21].tolist()
    return t0, t0 + dt


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


class TriLayout(NamedTuple):
    """The detached part of a triangle table (:func:`tri_layout`): the
    row order ``perm`` and each row's material ``mid`` (M,), the zero
    column and the padding rows that close the table, and the cull
    hierarchy, as :class:`TriTable` holds it."""
    perm: torch.Tensor
    mid: torch.Tensor
    zeros: torch.Tensor
    pad: torch.Tensor
    boxes: torch.Tensor
    supers: torch.Tensor
    hypers: torch.Tensor
    block: int
    count: int


def tri_layout(scene, tri_block: int, order: str = "median") -> TriLayout:
    """The :class:`TriLayout` of ``scene`` in ``tri_block``-row blocks: a
    function of its vertices and material ids alone, taken detached, so
    the boxes carry no gradient (pallas_grad.py:716-718)."""
    tr = scene.triangles
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

    with torch.no_grad():
        verts = tr.verts.to(_F32)
        tmin = verts.amin(dim=1)
        tmax = verts.amax(dim=1)
        cent = 0.5 * (tmin + tmax)
        if order == "morton":
            perm = morton_order(tmin.amin(dim=0), tmax.amax(dim=0), cent)
        elif order == "median":
            # The split is made on the host: the centroids read back, the
            # order copied up (both wait for the card).
            with span("rtow.sync.tri_order"):
                perm = torch.from_numpy(_median_split_order(
                    cent.cpu().numpy(), tri_block)).to(dev)
        else:
            raise ValueError(
                f"order must be 'median' or 'morton', not {order!r}")
        mid = tr.material[perm].long()
        tmin, tmax = tmin[perm], tmax[perm]
        zeros = torch.zeros((m, 1), dtype=_F32, device=dev)
        pad = torch.zeros((mpad - m, TBL_COLS), dtype=_F32, device=dev)

        big = 1.0e30

        def padded(x, fill, rows):
            return torch.cat([x, torch.full((rows - x.shape[0], 3), fill,
                                            dtype=_F32, device=dev)])

        def group(lo, hi, k):
            n = lo.shape[0] // k
            return (lo.reshape(n, k, 3).amin(dim=1),
                    hi.reshape(n, k, 3).amax(dim=1))

        def rows8(lo, hi):
            return torch.cat([lo, hi, torch.zeros(
                (lo.shape[0], 2), dtype=_F32, device=dev)], dim=1)

        blk_min, blk_max = group(padded(tmin, big, mpad),
                                 padded(tmax, -big, mpad), tri_block)
        pad_eps = 1e-4 + 1e-4 * (blk_max - blk_min).abs()
        blk_min = blk_min - pad_eps
        blk_max = blk_max + pad_eps
        boxes = rows8(blk_min, blk_max)
        supers = hypers = torch.zeros((1, 8), dtype=_F32, device=dev)
        nb = boxes.shape[0]
        if nb % SUPER == 0 and nb >= 2 * SUPER:
            sup_min, sup_max = group(blk_min, blk_max, SUPER)
            supers = rows8(sup_min, sup_max)
            nsb = supers.shape[0]
            if nsb >= 2 * SUPER:
                # Supers pad to a whole hyper-block with inverted boxes.
                nsb_pad = -(-nsb // SUPER) * SUPER
                # A host tensor's copy to the card waits for the card.
                with span("rtow.sync.tri_pad"):
                    pad_row = torch.tensor(
                        [[big, big, big, -big, -big, -big, 0.0, 0.0]],
                        dtype=_F32, device=dev)
                supers = torch.cat([supers, pad_row.repeat(nsb_pad - nsb, 1)])
                hypers = rows8(*group(padded(sup_min, big, nsb_pad),
                                      padded(sup_max, -big, nsb_pad), SUPER))
    return TriLayout(perm, mid, zeros, pad, boxes, supers, hypers, tri_block,
                     m)


def tri_rows(scene, lay: TriLayout) -> TriTable:
    """The :class:`TriTable` of ``scene`` laid out by ``lay``: its rows
    gathered from the scene's vertices and materials, through which
    autograd carries the table's cotangent back to ``triangles.verts``
    and the material leaves."""
    tr = scene.triangles
    mats = scene.materials
    # The rows gather by index_select, whose backward adds each row's
    # cotangent into its source row (index_add_).  Indexing's backward
    # sorts the rows' indices first and, on the card, sums each source
    # row's run in one thread: a mesh's triangles mostly share one
    # material, which made that run every triangle of the mesh.
    verts = tr.verts.to(_F32).index_select(0, lay.perm)
    v0 = verts[:, 0]
    e1 = verts[:, 1] - v0
    e2 = verts[:, 2] - v0
    mat_cols = torch.cat([
        mats.albedo,
        torch.stack([mats.fuzz, mats.ir, mats.kind.to(_F32)], dim=1),
    ], dim=1)
    tbl = torch.cat([
        v0, e1, e2, mat_cols.index_select(0, lay.mid), lay.zeros,
    ], dim=1).to(_F32)
    return TriTable(torch.cat([tbl, lay.pad]), lay.boxes, lay.supers,
                    lay.hypers, lay.block, lay.count)


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
    and the boxes are :func:`tri_layout`'s, the rows :func:`tri_rows`'."""
    return tri_rows(scene, tri_layout(scene, tri_block, order))


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
# The lit features.


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


# ---------------------------------------------------------------------------
# The wrappers' checks and the lit arguments.


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


def kind_bits(kinds, names: str) -> int:
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
            kind_bits(lit.nee_kinds, "st"), int(lit.checker),
            len(lit.vol_kinds), kind_bits(lit.vol_kinds, "sbr"),
            lit.vol_row0, int(lit.roulette))


def grad_lit_args(lit: Lit) -> tuple:
    """The lit features as K4's and K5's C entry points take them: the
    light and volume rows (or a null pointer), their count, the emissive,
    NEE and texture features, and the media (their count, kinds and first
    row).  No roulette: the gradient path never runs it."""
    return (None if lit.rows is None else lit.rows.data_ptr(), lit_rows(lit),
            int(lit.emissive), len(lit.nee_kinds),
            kind_bits(lit.nee_kinds, "st"), int(lit.checker),
            len(lit.vol_kinds), kind_bits(lit.vol_kinds, "sbr"),
            lit.vol_row0)


def lit_rows(lit: Lit) -> int:
    """The light and volume rows a launch reads (and stages in shared
    memory): the lights, then the volumes from ``vol_row0``."""
    return (lit.vol_row0 + len(lit.vol_kinds) if lit.vol_kinds
            else len(lit.nee_kinds))


def check_lit(lit: Lit, tbl: torch.Tensor) -> None:
    """Raise unless ``lit``'s rows and features agree and its rows are a
    contiguous (K + V, 14) float32 tensor on ``tbl``'s device."""
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


def scene_lit(scene, *, nee: bool, roulette: bool = False,
              light_mats: Optional[tuple] = None) -> Lit:
    """The lit features of ``scene`` and their rows, as
    ``render_blocks_pallas`` (:2077-2102) and ``render_pixels_kernel``
    (pallas_grad.py:887-913) derive them: emission wherever the scene has
    an emissive material, next-event estimation toward its lights with
    ``nee`` (a ValueError on a scene that emits nothing), its checker and
    noise textures, its media, and ``roulette``.  The rows are
    ``build_light_table``'s under NEE (from the lights' materials
    ``light_mats`` where given), then ``build_volume_table``'s from
    ``vol_row0``, differentiable in the scene's leaves.  The renders pass
    ``nee=scene.has_emissive``; the gradient path passes its own."""
    if nee and not scene.has_emissive:
        raise ValueError("nee=True needs an emissive scene "
                         "(SceneBuilder.add_light)")
    nee_kinds = tuple(k for k, _ in scene.light_ids) if nee else ()
    rows = [build_light_table(scene, light_mats)] if nee_kinds else []
    vol_row0 = rows[0].shape[0] if rows else 0
    if scene.volume_kinds:
        rows.append(build_volume_table(scene))
    return Lit(emissive=scene.has_emissive, nee_kinds=nee_kinds,
               checker=scene.has_checker,
               vol_kinds=tuple(scene.volume_kinds), vol_row0=vol_row0,
               roulette=bool(roulette),
               rows=torch.cat(rows).contiguous() if rows else None)


# ---------------------------------------------------------------------------
# One builder per kernel family.


def check_kernel_scene(scene) -> None:
    """Raise NotImplementedError where ``scene`` has an image texture,
    which no kernel reads.  The test reads a flag back from the scene's
    device: a host sync, which each caller puts inside a span of its
    own."""
    if bool((scene.materials.kind == IMAGE).any()):
        raise NotImplementedError(
            "image textures need the reference integrator's texel gathers "
            "(ROADMAP Queue 1 item 5)")


def sort_grid(sph_boxes: torch.Tensor, tris
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, 1 / extent) of the sort keys' origin grid: the union of the
    sphere blocks' and the triangle blocks' boxes (``tris.boxes``, of a
    :class:`TriTable` or a :class:`TriLayout`, or None), detached
    (cull-only, ``_scene_tables``, :152; pallas_grad.py:955-967)."""
    boxes = sph_boxes.detach()
    if tris is not None:
        boxes = torch.cat([boxes, tris.boxes.detach()])
    bmin = boxes[:, 0:3].amin(dim=0)
    bmax = boxes[:, 3:6].amax(dim=0)
    return bmin, 1.0 / torch.clamp(bmax - bmin, min=1e-6)


def k1_tables(scene) -> Tuple[torch.Tensor, Optional[TriTable]]:
    """K1's tables of a scene: (sphere table, triangle table at
    ``K1_TRI_BLOCK`` rows per block or None)."""
    tbl, _boxes = build_sphere_table(scene)
    tris = (build_tri_table(scene, K1_TRI_BLOCK) if scene.n_triangles
            else None)
    return tbl, tris


class Tables(NamedTuple):
    """K3's tables of a bounce: the (Npad, 16) sphere table (Npad may be
    0), the triangle table with its hierarchy, and the lit features with
    their light and volume rows (none by default)."""
    sph: torch.Tensor
    tris: TriTable
    lit: Lit = Lit()


def k3_tables(scene, roulette: bool = False
              ) -> Tuple[Tables, torch.Tensor, torch.Tensor]:
    """(K3's tables, scene-box min, 1 / extent) of a mesh scene
    (``_scene_tables``, :152): the triangle table at the scene's
    ``pick_tri_block`` width, the lit features of the scene (and
    ``roulette``) with their light then volume rows (JAX's light-table
    operand, :179-188), and the grid of the sort keys' origin code
    (:func:`sort_grid`)."""
    sph, sph_boxes = build_sphere_table(scene)
    tris = build_tri_table(scene, pick_tri_block(scene.n_triangles))
    lit = scene_lit(scene, nee=scene.has_emissive, roulette=roulette)
    bmin, inv_ext = sort_grid(sph_boxes, tris)
    return Tables(sph, tris, lit), bmin, inv_ext


def grad_tri_layout(scene, flat: bool = False) -> TriLayout:
    """The gradient path's triangle layout: Morton order, 128-row blocks
    (``build_tri_table`` under ``jit``), held to JAX's caps (a ValueError
    past 4,096 blocks, or past 1,536 on the flat sweep)."""
    lay = tri_layout(scene, GRAD_TRI_BLOCK, order="morton")
    nb = lay.boxes.shape[0]
    if nb > MAX_TRI_BLOCKS:
        raise ValueError(f"{nb} triangle blocks: the gradient path caps at "
                         f"{MAX_TRI_BLOCKS} ({MAX_TRI_BLOCKS * GRAD_TRI_BLOCK}"
                         f" triangles)")
    if (flat or lay.supers.shape[0] == 1) and nb > MAX_FLAT_TRI_BLOCKS:
        raise ValueError(f"{nb} triangle blocks: the flat gradient sweep "
                         f"caps at {MAX_FLAT_TRI_BLOCKS}")
    return lay


def grad_tri_table(scene, flat: bool = False) -> TriTable:
    """The gradient path's triangle table (:func:`grad_tri_layout`)."""
    return tri_rows(scene, grad_tri_layout(scene, flat))


class GradTables(NamedTuple):
    """What the differentiable render reads of a scene, built once a
    render by :func:`grad_tables`: the sphere table, the triangle table
    (None without triangles), the lit features with their rows, the sort
    keys' origin grid (min, 1 / extent) where the lanes are sorted (None
    where not) and whether the triangle blocks are swept flat."""
    tbl: torch.Tensor
    tris: Optional[TriTable]
    lit: Lit
    grid: Optional[Tuple[torch.Tensor, torch.Tensor]]
    flat: bool


#: The leaves a scene's :class:`GradLayout` is a function of, with the
#: scene's metadata: the geometry and the integer leaves.
LAYOUT_LEAVES = ("spheres.center0", "spheres.dcenter", "spheres.radius",
                 "spheres.material", "triangles.verts", "triangles.material",
                 "materials.kind")


class GradLayout(NamedTuple):
    """The detached part of :class:`GradTables` (:func:`grad_layout`):
    the sphere and triangle layouts, the material of each light under
    NEE, the sort grid, and the statics.  No gradient reaches it, and it
    changes only with ``LAYOUT_LEAVES`` and the metadata, so a train step
    that leaves those alone keeps it (``diff.build_train_step``)."""
    spheres: SphereLayout
    tris: Optional[TriLayout]
    light_mats: tuple
    grid: Optional[Tuple[torch.Tensor, torch.Tensor]]
    flat: bool
    nee: bool


def grad_layout(scene, *, sort_lanes=None, force_flat: bool = False,
                nee: bool = False) -> GradLayout:
    """The :class:`GradLayout` of ``scene``; arguments as
    :func:`grad_tables`.  Image textures raise, after the span
    ``rtow.sync.check_scene``; under NEE the lights' materials are read
    to the host once, in the span ``rtow.sync.light_mats``.  Counted in
    ``grad_layout.builds``."""
    grad_layout.builds += 1
    with span("rtow.sync.check_scene"):
        check_kernel_scene(scene)
    if sort_lanes is None:
        sort_lanes = scene.n_triangles > WAVEFRONT_MIN_TRIS
    sph = sphere_layout(scene)
    tris = grad_tri_layout(scene, force_flat) if scene.n_triangles else None
    grid = sort_grid(sph.boxes, tris) if sort_lanes else None
    light_mats = ()
    if nee and scene.light_ids:
        with span("rtow.sync.light_mats"):
            mats = torch.cat([scene.spheres.material,
                              scene.triangles.material]).tolist()
        light_mats = tuple(mats[i if k == "s" else scene.n_spheres + i]
                           for k, i in scene.light_ids)
    return GradLayout(sph, tris, light_mats, grid, force_flat, nee)


#: Layouts built by :func:`grad_layout` in this process.
grad_layout.builds = 0


def grad_rows(scene, layout: GradLayout) -> GradTables:
    """The :class:`GradTables` of ``scene`` laid out by ``layout``: the
    sphere, triangle, light and volume rows, differentiable in the
    scene's leaves, gathered anew on every call."""
    lit = scene_lit(scene, nee=layout.nee, light_mats=layout.light_mats)
    tbl = sphere_rows(scene, layout.spheres)
    tris = tri_rows(scene, layout.tris) if layout.tris is not None else None
    return GradTables(tbl, tris, lit, layout.grid, layout.flat)


def grad_tables(scene, *, sort_lanes=None, force_flat: bool = False,
                nee: bool = False) -> GradTables:
    """The :class:`GradTables` of ``scene``, differentiable in its leaves:
    ``sort_lanes`` None sorts for meshes of more than 16,384 triangles;
    ``force_flat`` sweeps the triangle blocks flat, ``nee`` samples the
    lights at every diffuse hit (``render_pixels_kernel``'s statics, no
    roulette).  :func:`grad_layout`, then :func:`grad_rows`."""
    return grad_rows(scene, grad_layout(scene, sort_lanes=sort_lanes,
                                        force_flat=force_flat, nee=nee))
