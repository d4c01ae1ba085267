"""Kernel-speed gradients for sphere and mesh scenes (the port of
``rtow_tpu/ops/pallas_grad.py`` short of its lit features).

One differentiable bounce is :class:`BounceGrad`, the counterpart of the
``bounce_grad`` custom_vjp (:573): its forward is the bounce kernel K4,
its backward the kernel K5, which replays the bounce from the saved input
state (the counter RNG makes the sweep, the draws and every discrete
decision reproduce exactly) and runs the adjoint of the shade and of the
winner's hit record.

* :func:`bounce_fwd` is K4's wrapper: on a CUDA table it launches
  ``csrc/grad_fwd.cu``, on a CPU table it runs
  :func:`bounce_fwd_reference`, on anything else it raises.
* :func:`bounce_bwd` is K5's: ``csrc/grad_bwd.cu`` or
  :func:`bounce_bwd_reference` (autograd through the plain shade).

Both take the sphere table and, for a scene with triangles, the triangle
table with its block, super and hyper boxes (a :class:`TriTable` built in
Morton order with 128-row blocks, as the JAX gradient path builds it under
``jit``).  A lane sweeps the spheres, then the triangles: flat over the
block boxes, or down the hierarchy where the table has one (32 blocks or
more) unless ``flat`` asks for the flat sweep (JAX's ``_force_flat``, the
parity switch).  Winner ids are spheres ``0 .. npad - 1``, triangles
``npad + row``.

:func:`render_rays_kernel` chains ``max_depth + 1`` bounces over
(pixel x sample) lanes; autograd's tape of the bounces' saved inputs
plays the role of the ``lax.scan`` carries.  With ``sort_lanes`` (by
default for meshes of more than 16,384 triangles) the lanes are sorted by
the sorted wavefront's spatial key before every bounce and put back in
lane order after the last, by differentiable gathers (``_permute_by``,
:724-758; on the card an index gather, whose backward is an index
scatter).  The tables' cotangents flow back into the Scene's leaves
through ``build_sphere_table``'s and ``build_tri_table``'s gathers.

Lane state: ``cont`` (13, L) float32 = ox oy oz dx dy dz tm tpr tpg tpb
rr rg rb, ``ints`` (3, L) int32 = alive, bounce, lane id.  L is a
multiple of 1,024; padding lanes are dead.  The RNG salt is the bounce's
scan step ``it`` (0..max_depth), the same for every lane.

Covered: spheres and triangles, the sky or a flat background, Lambertian
/ metal / dielectric.  NEE, media, emission, checker and image textures
and the sharded step raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple, Union

import torch

from ..models.camera import Camera, Rays, camera_rays, pixel_coords
from ..models.scene import DIELECTRIC, Scene
from . import _cuda
from .megakernel import (
    BIG, TBL_COLS, TRI_PARAMS, TriTable, background_args,
    build_sphere_table, build_tri_table, check_counter, check_table,
    check_tris, draw_scatter, lane_hash, lane_state, nearest_sphere,
    nearest_triangle, shade, step_salt, winners,
)
from .wavefront import WAVEFRONT_MIN_TRIS, sort_keys

#: Continuous (cotangent-bearing) state rows.
N_CONT = 13
#: Sphere winner-row columns that carry a cotangent (c0, dc, r, albedo,
#: fuzz, ir, kind; kind's is 0).
_N_PARAMS = 13
#: Triangle winner-row columns that carry a cotangent (v0, e1, e2,
#: albedo, fuzz, ir); kind's and column 15's are 0.
_N_TRI_PARAMS = 14
#: The gradient path's triangle-block width: the JAX module global
#: ``TRI_BLOCK``, which ``render_pixels_kernel`` does not re-pick per
#: scene (pallas_megakernel.py:71, :85).
GRAD_TRI_BLOCK = 128
#: Caps on the triangle blocks (pallas_grad.py:867, :886): in all, and on
#: the flat sweep.
MAX_TRI_BLOCKS = 4096
MAX_FLAT_TRI_BLOCKS = 1536

_F32 = torch.float32
_I32 = torch.int32


# ---------------------------------------------------------------------------
# The plain versions.


def _sweep_live(tbl, tris, cont, alive, flat,
                tally) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_t, best_k) of the live lanes over the sphere table, then the
    triangle table where there is one; dead lanes get (BIG, 0).  The
    (chunk, 128) pair temporaries bound the chunk.  ``tally`` ([box
    tests, triangle tests]) gets the triangle sweep's work."""
    n = cont.shape[1]
    best_t = torch.full((n,), BIG, dtype=_F32, device=cont.device)
    best_k = torch.zeros((n,), dtype=torch.int64, device=cont.device)
    live = torch.nonzero(alive).flatten()
    chunk = 1 << 18 if cont.device.type == "cuda" else 1 << 14
    for start in range(0, live.numel(), chunk):
        idx = live[start:start + chunk]
        ox, oy, oz, dx, dy, dz, tm = cont[:7, idx]
        a = dx * dx + dy * dy + dz * dz
        bt, bk = nearest_sphere(tbl, ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a)
        if tris is not None:
            bt, bk = nearest_triangle(tris, ox, oy, oz, dx, dy, dz, bt, bk,
                                      tbl.shape[0], flat=flat, tally=tally)
        best_t[idx], best_k[idx] = bt, bk
    return best_t, best_k


def _replay(cont, ints, tbl, tris, it, seed, flat, stats):
    """The bounce's discrete half: (alive, best_t, best_k, draws).
    ``stats`` (or None) gets the box tests, triangle tests and live
    lanes added to it, as the kernels count them."""
    alive = ints[0] > 0
    tally = [0, 0]
    with torch.no_grad():
        best_t, best_k = _sweep_live(tbl, tris, cont, alive, flat, tally)
        if stats is not None:
            stats += torch.tensor(tally + [int(alive.sum())],
                                  device=stats.device)
    lane = lane_hash(ints[2].long())
    return alive, best_t, best_k, draw_scatter(lane, step_salt(seed, it))


def bounce_fwd_reference(cont, ints, tbl, tris: Optional[TriTable] = None,
                         *, it: int, seed: int, max_depth: int,
                         background="sky", flat: bool = False,
                         stats: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K4: one bounce of every lane ->
    (cont, ints).  Same inputs and outputs as :func:`bounce_fwd`."""
    alive, best_t, best_k, draws = _replay(cont, ints, tbl, tris, it, seed,
                                           flat, stats)
    w, tri = winners(tbl, tris, best_t, best_k)
    state, can, bounce = shade(
        tuple(cont.unbind(0)), w, draws, best_t, alive, ints[1], max_depth,
        background, tri=tri)
    return torch.stack(state), torch.stack([can.to(_I32), bounce, ints[2]])


def bounce_bwd_reference(cont, ints, cot_out, tbl,
                         tris: Optional[TriTable] = None, *, it: int,
                         seed: int, max_depth: int, background="sky",
                         flat: bool = False,
                         stats: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K5 -> (cot_in (13, L), g_tbl (Npad, 16),
    g_tri (Mpad, 16), or None without ``tris``): each hit lane's row
    cotangent from :func:`bounce_bwd_terms` added to its winner's row of
    ``g_tbl`` or, for a triangle, of ``g_tri`` (``pallas_grad.py:444-539``;
    the kind column and column 15 get 0)."""
    cot_in, sph, tri = bounce_bwd_terms(
        cont, ints, cot_out, tbl, tris, it=it, seed=seed,
        max_depth=max_depth, background=background, flat=flat, stats=stats)
    return (cot_in, table_sums(sph, tbl.shape[0]),
            None if tri is None else table_sums(tri, tris.tbl.shape[0]))


def table_sums(terms, rows: int, dtype=_F32) -> torch.Tensor:
    """(rows, 16) table cotangent of ``terms`` ((row ids (H,), row
    cotangents (H, C)) from :func:`bounce_bwd_terms`), summed in
    ``dtype``; columns past C get 0."""
    ids, src = terms
    out = torch.zeros((rows, TBL_COLS), dtype=dtype, device=src.device)
    out[:, :src.shape[1]].index_add_(0, ids, src.to(dtype))
    return out


def bounce_bwd_terms(cont, ints, cot_out, tbl,
                     tris: Optional[TriTable] = None, *, it: int, seed: int,
                     max_depth: int, background="sky", flat: bool = False,
                     stats: Optional[torch.Tensor] = None):
    """K5's plain version before its table sums -> (cot_in (13, L), the
    sphere-hit lanes' (winner rows, row cotangents (H, 13)), the
    triangle-hit lanes' (winner rows, row cotangents (T, 14)) or None
    without ``tris``).

    Replays the sweeps and the draws, then takes ``torch.autograd.grad``
    of the plain shade w.r.t. the input state and the winner rows of each
    kind (the rows :func:`winners` gives the forward).  ``tm`` passes
    through the bounce, so its cotangent gets the downstream one added
    (:433-436): the stacked output below holds that identity."""
    alive, best_t, best_k, draws = _replay(cont, ints, tbl, tris, it, seed,
                                           flat, stats)
    npad, n = tbl.shape[0], best_k.numel()
    hit = best_t < BIG
    is_tri = (best_k >= npad if tris is not None
              else torch.zeros_like(hit))
    sph_hit, tri_hit = hit & ~is_tri, hit & is_tri
    with torch.enable_grad():
        state = cont.detach().requires_grad_(True)
        rows = (tbl.detach()[best_k.clamp(max=npad - 1), :_N_PARAMS] if npad
                else torch.zeros((n, _N_PARAMS), dtype=_F32,
                                 device=tbl.device)).requires_grad_(True)
        inputs, tri = [state, rows], None
        if tris is not None:
            trows = tris.tbl.detach()[(best_k - npad).clamp(min=0),
                                      :TRI_PARAMS].requires_grad_(True)
            inputs.append(trows)
            tri = (torch.where(tri_hit[:, None], trows, 0.0), is_tri)
        out, _can, _bounce = shade(
            tuple(state.unbind(0)), torch.where(sph_hit[:, None], rows, 0.0),
            draws, best_t, alive, ints[1], max_depth, background, tri=tri)
        grads = torch.autograd.grad(torch.stack(out), inputs, cot_out)
    sph = (best_k[sph_hit], grads[1][sph_hit])
    if tris is None:
        return grads[0], sph, None
    return grads[0], sph, (best_k[tri_hit] - npad,
                           grads[2][tri_hit, :_N_TRI_PARAMS])


# ---------------------------------------------------------------------------
# The wrappers.


def _check_state(tbl, cont, ints, cot=None) -> None:
    n = cont.shape[-1]
    for name, t, dtype, rows in (("cont", cont, _F32, N_CONT),
                                 ("ints", ints, _I32, 3),
                                 ("cot_out", cot, _F32, N_CONT)):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != (rows, n) \
                or not t.is_contiguous() or t.device != tbl.device:
            raise ValueError(
                f"{name} must be a contiguous ({rows}, L) {dtype} tensor on "
                f"the table's device, got {tuple(t.shape)} {t.dtype} "
                f"{t.device}")
    if not 0 < n < (1 << 31):
        raise ValueError(f"bad lane count {n}")


def _scalars(it, seed, max_depth):
    for v in (it, seed, max_depth):
        if not -(1 << 31) <= int(v) < (1 << 31):
            raise ValueError(f"kernel scalar {v} does not fit in int32")
    return int(it), int(seed), int(max_depth)


def _check(kernel, tbl, tris, cont, ints, cot, stats, **scalars):
    """The wrappers' checks -> (it, seed, max_depth)."""
    check_table(tbl, kernel, copies=2 if cot is not None else 1)
    if tris is not None:
        check_tris(tris, tbl, kernel)
    elif stats is not None:
        raise ValueError("stats count the triangle sweep: they need a "
                         "triangle table")
    _check_state(tbl, cont, ints, cot)
    check_counter(stats, 3, tbl, "stats")
    return _scalars(**scalars)


def _tri_args(tris: Optional[TriTable], flat: bool) -> tuple:
    """The launchers' triangle arguments (null pointers without
    triangles; no super / hyper levels for the flat sweep)."""
    if tris is None:
        return (None,) * 4 + (0,) * 5
    deep = not flat
    return (tris.tbl.data_ptr(), tris.boxes.data_ptr(),
            tris.supers.data_ptr(), tris.hypers.data_ptr(), tris.n_blocks,
            tris.n_super if deep else 0, tris.n_hyper if deep else 0,
            tris.block, tris.count)


def bounce_fwd(cont: torch.Tensor, ints: torch.Tensor, tbl: torch.Tensor,
               tris: Optional[TriTable] = None, *, it: int, seed: int,
               max_depth: int, background: Union[str, tuple] = "sky",
               flat: bool = False, stats: Optional[torch.Tensor] = None):
    """One forward bounce (``_bounce_fwd_impl``, :592) -> (cont, ints).

    ``tris``: the scene's triangle table, or None; ``flat`` sweeps its
    block boxes without the hierarchy; ``stats``, a (3,) int64 tensor on
    the table's device (with ``tris`` only), gets the box tests, triangle
    tests and live lanes added to it.  A CUDA ``tbl`` launches
    ``csrc/grad_fwd.cu`` (counted in ``bounce_fwd.launches``); a CPU
    ``tbl`` runs :func:`bounce_fwd_reference`; any other device raises."""
    it, seed, max_depth = _check("grad_fwd kernel", tbl, tris, cont, ints,
                                 None, stats, it=it, seed=seed,
                                 max_depth=max_depth)
    if tbl.device.type == "cpu":
        return bounce_fwd_reference(cont, ints, tbl, tris, it=it, seed=seed,
                                    max_depth=max_depth,
                                    background=background, flat=flat,
                                    stats=stats)
    lib = _lib("grad_fwd")
    use_sky, (bgr, bgg, bgb) = background_args(background)
    cont_out = torch.empty_like(cont)
    ints_out = torch.empty_like(ints)
    err = lib.rtow_grad_fwd(
        tbl.data_ptr(), tbl.shape[0], *_tri_args(tris, flat),
        cont.data_ptr(), ints.data_ptr(), cont.shape[1], it, seed, max_depth,
        int(use_sky), bgr, bgg, bgb, cont_out.data_ptr(), ints_out.data_ptr(),
        None if stats is None else stats.data_ptr(), *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "grad_fwd")
    bounce_fwd.launches += 1
    return cont_out, ints_out


#: Kernel launches made by :func:`bounce_fwd` in this process.
bounce_fwd.launches = 0


def bounce_bwd(cont: torch.Tensor, ints: torch.Tensor, cot_out: torch.Tensor,
               tbl: torch.Tensor, tris: Optional[TriTable] = None, *,
               it: int, seed: int, max_depth: int,
               background: Union[str, tuple] = "sky", flat: bool = False,
               stats: Optional[torch.Tensor] = None):
    """One backward bounce (``_bounce_grad_bwd``, :639) from the bounce's
    saved input state -> (cot_in (13, L), g_tbl (Npad, 16), g_tri (Mpad,
    16), or None without ``tris``).  ``tris``, ``flat`` and ``stats`` as
    for :func:`bounce_fwd`.

    A CUDA ``tbl`` launches ``csrc/grad_bwd.cu`` (counted in
    ``bounce_bwd.launches``); a CPU ``tbl`` runs
    :func:`bounce_bwd_reference`; any other device raises."""
    it, seed, max_depth = _check("grad_bwd kernel", tbl, tris, cont, ints,
                                 cot_out, stats, it=it, seed=seed,
                                 max_depth=max_depth)
    if tbl.device.type == "cpu":
        return bounce_bwd_reference(cont, ints, cot_out, tbl, tris, it=it,
                                    seed=seed, max_depth=max_depth,
                                    background=background, flat=flat,
                                    stats=stats)
    lib = _lib("grad_bwd")
    use_sky, (bgr, bgg, bgb) = background_args(background)
    cot_in = torch.empty_like(cot_out)
    g_tbl = torch.zeros_like(tbl)
    g_tri = None if tris is None else torch.zeros_like(tris.tbl)
    err = lib.rtow_grad_bwd(
        tbl.data_ptr(), tbl.shape[0], *_tri_args(tris, flat),
        cont.data_ptr(), ints.data_ptr(), cot_out.data_ptr(), cont.shape[1],
        it, seed, max_depth, int(use_sky), bgr, bgg, bgb, cot_in.data_ptr(),
        g_tbl.data_ptr(), None if g_tri is None else g_tri.data_ptr(),
        None if stats is None else stats.data_ptr(), *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "grad_bwd")
    bounce_bwd.launches += 1
    return cot_in, g_tbl, g_tri


#: Kernel launches made by :func:`bounce_bwd` in this process.
bounce_bwd.launches = 0


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` (grad_fwd or grad_bwd), built at first use, with
    its launcher declared."""
    lib = _cuda.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tri = [p, p, p, p, i, i, i, i, i]
    if name == "grad_fwd":
        lib.rtow_grad_fwd.argtypes = [p, i, *tri, p, p, i, i, i, i, i, f, f,
                                      f, p, p, p, i, p]
        lib.rtow_grad_fwd.restype = i
    else:
        lib.rtow_grad_bwd.argtypes = [p, i, *tri, p, p, p, i, i, i, i, i, f,
                                      f, f, p, p, p, p, i, p]
        lib.rtow_grad_bwd.restype = i
    return lib


class BounceGrad(torch.autograd.Function):
    """One differentiable bounce (``pallas_grad.bounce_grad``, :573):
    (cont, ints) -> (cont, ints), differentiable in ``cont``, ``tbl`` and
    the triangle rows ``tri_tbl``.

    The forward is :func:`bounce_fwd` and saves its input state (the
    tape); the backward is :func:`bounce_bwd` on that state.  ``ints``
    carries no cotangent, nor do the triangle boxes: ``tris`` is the
    table without its rows (``tbl=None``), decisions only."""

    @staticmethod
    def forward(ctx, cont, ints, tbl, tri_tbl, tris, it, seed, max_depth,
                background, flat):
        full = None if tris is None else tris._replace(tbl=tri_tbl)
        cont_out, ints_out = bounce_fwd(cont, ints, tbl, full, it=it,
                                        seed=seed, max_depth=max_depth,
                                        background=background, flat=flat)
        ctx.save_for_backward(cont, ints, tbl, tri_tbl)
        ctx.tris = tris
        ctx.scalars = dict(it=it, seed=seed, max_depth=max_depth,
                           background=background, flat=flat)
        ctx.mark_non_differentiable(ints_out)
        return cont_out, ints_out

    @staticmethod
    def backward(ctx, g_cont, _g_ints):
        cont, ints, tbl, tri_tbl = ctx.saved_tensors
        full = None if ctx.tris is None else ctx.tris._replace(tbl=tri_tbl)
        cot_in, g_tbl, g_tri = bounce_bwd(cont, ints, g_cont.contiguous(),
                                          tbl, full, **ctx.scalars)
        return (cot_in, None, g_tbl, g_tri, None, None, None, None, None,
                None)


def bounce_grad(cont, ints, tbl, tris: Optional[TriTable] = None, *,
                it: int, seed: int, max_depth: int,
                background: Union[str, tuple] = "sky", flat: bool = False):
    """:class:`BounceGrad` applied to one bounce."""
    return BounceGrad.apply(
        cont, ints, tbl, None if tris is None else tris.tbl,
        None if tris is None else tris._replace(tbl=None), it, seed,
        max_depth, background, flat)


# ---------------------------------------------------------------------------
# The differentiable render.


def _check_scene(scene: Scene) -> None:
    if (bool((scene.materials.kind > DIELECTRIC).any())
            or scene.has_emissive or scene.has_checker):
        raise NotImplementedError(
            "emissive, checker, noise and image-texture materials in the "
            "gradient kernels are not ported yet (ROADMAP Queue 1 item 10)")
    if scene.volume_kinds:
        raise NotImplementedError(
            "constant-density media in the gradient kernels are not ported "
            "yet (ROADMAP Queue 1 item 10)")


def grad_tri_table(scene: Scene, flat: bool = False) -> TriTable:
    """The gradient path's triangle table: Morton order, 128-row blocks
    (``build_tri_table`` under ``jit``), held to JAX's caps (a ValueError
    past 4,096 blocks, or past 1,536 on the flat sweep)."""
    tris = build_tri_table(scene, GRAD_TRI_BLOCK, order="morton")
    nb = tris.n_blocks
    if nb > MAX_TRI_BLOCKS:
        raise ValueError(f"{nb} triangle blocks: the gradient path caps at "
                         f"{MAX_TRI_BLOCKS} ({MAX_TRI_BLOCKS * GRAD_TRI_BLOCK}"
                         f" triangles)")
    if (flat or not tris.n_super) and nb > MAX_FLAT_TRI_BLOCKS:
        raise ValueError(f"{nb} triangle blocks: the flat gradient sweep "
                         f"caps at {MAX_FLAT_TRI_BLOCKS}")
    return tris


def _sort_grid(sph_boxes, tris) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, 1 / extent) of the sort keys' origin grid: the union of the
    sphere blocks' and the triangle blocks' boxes, detached (cull-only,
    pallas_grad.py:955-967)."""
    boxes = sph_boxes.detach()
    if tris is not None:
        boxes = torch.cat([boxes, tris.boxes.detach()])
    bmin = boxes[:, 0:3].amin(dim=0)
    bmax = boxes[:, 3:6].amax(dim=0)
    return bmin, 1.0 / torch.clamp(bmax - bmin, min=1e-6)


def _permute(cont, ints, perm):
    """The lanes in the order ``perm``: a gather, differentiable in
    ``cont`` (its backward scatters the cotangent back)."""
    return cont.index_select(1, perm), ints.index_select(1, perm)


def render_rays_kernel(scene: Scene, rays: Rays, *, n_pixels: int, spp: int,
                       max_depth: int, seed: int = 0, sort_lanes=None,
                       force_flat: bool = False) -> torch.Tensor:
    """Differentiable mean radiance of ``n_pixels`` pixels -> (P, 3), from
    their ``n_pixels * spp`` camera rays in (pixel, sample) order (the
    lane half of ``render_pixels_kernel``, pallas_grad.py:915-1001):
    :func:`lane_state`, then ``max_depth + 1`` bounces of
    :class:`BounceGrad`, each after a sort of the lanes where
    ``sort_lanes`` (None: for meshes of more than 16,384 triangles).
    ``force_flat`` sweeps the triangle blocks flat.  The render runs on
    the scene's device: the kernels on a card, their plain versions on
    the CPU."""
    _check_scene(scene)
    if sort_lanes is None:
        sort_lanes = scene.n_triangles > WAVEFRONT_MIN_TRIS
    tbl, sph_boxes = build_sphere_table(scene)
    tris = grad_tri_table(scene, force_flat) if scene.n_triangles else None
    l_raw = n_pixels * spp
    cont, ints = lane_state(rays, l_raw, scene.device)
    if sort_lanes:
        bmin, inv_ext = _sort_grid(sph_boxes, tris)
    for it in range(max_depth + 1):
        if sort_lanes:
            with torch.no_grad():
                perm = torch.argsort(
                    sort_keys(cont, ints[0], bmin, inv_ext), stable=True)
            cont, ints = _permute(cont, ints, perm)
        cont, ints = bounce_grad(cont, ints, tbl, tris, it=it, seed=seed,
                                 max_depth=max_depth,
                                 background=scene.background,
                                 flat=force_flat)
    if sort_lanes:  # back to lane order, so a pixel's samples are adjacent
        cont, ints = _permute(cont, ints, torch.argsort(ints[2]))
    return cont[10:13, :l_raw].T.reshape(n_pixels, spp, 3).mean(dim=1)


def render_pixels_kernel(
    scene: Scene,
    camera: Camera,
    gen: torch.Generator,
    pixel_ids,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed: int = 0,
    jitter: bool = True,
    sort_lanes=None,
    nee: bool = False,
    grad_reduce_axes: Tuple = (),
    _force_flat: bool = False,
) -> torch.Tensor:
    """Differentiable mean radiance of the given pixels -> (P, 3)
    (``render_pixels_kernel``, pallas_grad.py:761): camera rays from
    ``gen`` (a ``torch.Generator`` on the scene's device, in place of the
    JAX key) and :func:`render_rays_kernel`.  ``jitter=False`` pins rays
    to pixel centres (FD gates).  ``sort_lanes`` (None: by the triangle
    count) and ``_force_flat`` as there.  Gradients reach every scene leaf
    that ``build_sphere_table`` and ``build_tri_table`` read (sphere
    centers and radii, triangle vertices, albedo, fuzz, ir)."""
    if nee:
        raise NotImplementedError(
            "nee=True needs NEE in the gradient kernels "
            "(ROADMAP Queue 1 item 10)")
    if grad_reduce_axes:
        raise NotImplementedError(
            "grad_reduce_axes needs the sharded train step "
            "(ROADMAP Queue 1 item 11)")
    pixel_ids = torch.as_tensor(pixel_ids, device=scene.device).long()
    lane_pix = pixel_ids.repeat_interleave(spp)
    if jitter:
        s, t = pixel_coords(width, height, gen, lane_pix)
    else:
        row, col = lane_pix // width, lane_pix % width
        s = (col.to(_F32) + 0.5) / (width - 1)
        t = ((height - 1 - row).to(_F32) + 0.5) / (height - 1)
    return render_rays_kernel(scene, camera_rays(camera, gen, s, t),
                              n_pixels=pixel_ids.shape[0], spp=spp,
                              max_depth=max_depth, seed=seed,
                              sort_lanes=sort_lanes, force_flat=_force_flat)


def scene_value_and_grad(fn: Callable[[Scene], torch.Tensor],
                         scene: Scene) -> Tuple[torch.Tensor, Scene]:
    """(fn(scene), d fn / d scene) for a scalar ``fn``: the counterpart of
    ``jax.value_and_grad(fn, allow_int=True)``.  The gradient is a Scene
    whose float leaves hold the gradients (zeros where ``fn`` does not
    read the leaf) and whose integer leaves are None."""
    leaves = scene.leaves()
    params = {k: v.detach().requires_grad_(True)
              for k, v in leaves.items() if v.is_floating_point()}
    with torch.enable_grad():
        value = fn(scene.replace_leaves(params))
        grads = torch.autograd.grad(value, list(params.values()),
                                    allow_unused=True)
    out = {k: None for k in leaves}
    for (k, p), g in zip(params.items(), grads):
        out[k] = torch.zeros_like(p) if g is None else g
    return value.detach(), scene.replace_leaves(out)


def loss_and_grad_kernel(scene: Scene, camera: Camera, gen: torch.Generator,
                         target, pixel_ids,
                         **render_kw) -> Tuple[torch.Tensor, Scene]:
    """(loss, dloss/dscene) of the pixel MSE with kernel-speed forward and
    backward (``loss_and_grad_kernel``, pallas_grad.py:1004)."""
    target = torch.as_tensor(target, dtype=_F32, device=scene.device)

    def mse(s):
        img = render_pixels_kernel(s, camera, gen, pixel_ids, **render_kw)
        return torch.mean((img - target) ** 2)

    return scene_value_and_grad(mse, scene)
