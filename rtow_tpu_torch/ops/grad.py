"""Kernel-speed gradients for sphere and mesh scenes, lit or not, with or
without media (the port of ``rtow_tpu/ops/pallas_grad.py``).

One differentiable bounce is :class:`BounceGrad`, the counterpart of the
``bounce_grad`` custom_vjp (:573): its forward is the bounce kernel K4,
its backward the kernel K5, which replays the bounce from the saved input
state (the counter RNG makes the sweep, the draws, the light sample, the
shadow ray's visibility and every discrete decision reproduce exactly)
and runs the adjoint of the shade, of next-event estimation and of the
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

The lit features come in a ``tables.Lit`` (``tables.scene_lit``
derives it from the scene, as ``render_pixels_kernel`` derives its
statics, :887-913): emission with its MIS weight, next-event estimation
toward the (K, 14) light rows with ``nee=True`` (the shadow ray swept from
``t_init`` = the light's distance less 0.1%; the alive code {0, 1, 2}
marks a diffuse or volume scatter), checker and noise albedo, and
constant-density media: the free-flight event (one uniform per volume at
salts 16 on) before the surface, whose distance and albedo read the
(V, 14) volume rows packed behind the light rows from ``vol_row0``, and
the shadow ray's transmittance.  The rows are a differentiable input of
:class:`BounceGrad`; their cotangent flows back into the Scene through
``build_light_table`` and ``build_volume_table``.

:func:`render_rays_kernel` chains ``max_depth + 1`` bounces over
(pixel x sample) lanes; autograd's tape of the bounces' saved inputs
plays the role of the ``lax.scan`` carries.  With ``sort_lanes`` (by
default for meshes of more than 16,384 triangles) the lanes are sorted by
the sorted wavefront's spatial key before every bounce and put back in
lane order after the last, by :class:`LanePermute` (``_permute_by``,
:724-758): an index gather, whose backward writes each cotangent column
back once, with no sum and no sort.  The tables' cotangents flow back
into the Scene's leaves through ``build_sphere_table``'s and
``build_tri_table``'s gathers.

Lane state: ``cont`` (13, L) float32 = ox oy oz dx dy dz tm tpr tpg tpb
rr rg rb, ``ints`` (3, L) int32 = alive, bounce, lane id.  L is a
multiple of 1,024; padding lanes are dead.  The RNG salt is the bounce's
scan step ``it`` (0..max_depth), the same for every lane.

Image textures and the sharded step raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..models.camera import Camera, Rays, camera_rays, pixel_coords
from ..models.scene import Scene
from ..utils.profiling import span
from ..utils.rng import hash_uniform, lane_hash, step_salt
from . import _cuda, flat_bounce
from .bounce import (
    BIG, draw_scatter, hit_basics, lane_state, nearest_sphere,
    nearest_triangle, nee_contrib, shade, volume_event, winners,
)
from .keys import sort_keys
from .lights import LIGHT_COLS
from .tables import (
    MAX_TABLE_BYTES, TBL_COLS, TRI_PARAMS, GradTables, Lit, TriTable,
    background_args, check_counter, check_lit, check_table, check_tris,
    grad_lit_args, grad_tables, lit_rows,
)

#: Continuous (cotangent-bearing) state rows.
N_CONT = 13
#: Sphere winner-row columns that carry a cotangent (c0, dc, r, albedo,
#: fuzz, ir, kind; kind's is 0).
_N_PARAMS = 13
#: Triangle winner-row columns that carry a cotangent (v0, e1, e2,
#: albedo, fuzz, ir); kind's and column 15's are 0.
_N_TRI_PARAMS = 14
#: K5's thread form (``csrc/grad_bwd.cu``) sums the triangle table's
#: gradient per block in shared memory where the table has at most this
#: many rows, and gives each of a block's ``BWD_THREADS`` threads its own
#: sums of the light and volume rows where they take at most this many
#: bytes, each only where it fits beside the sphere table
#: (:func:`_bwd_layout`).
TRI_SHARED_ROWS = 512
OWN_ROWS_BYTES = 64 * 1024
BWD_THREADS = 256

_F32 = torch.float32
_I32 = torch.int32


# ---------------------------------------------------------------------------
# The plain versions.


def _sweep(tbl, tris, o, d, tm, idx, flat, tally, t_init=None):
    """(best_t, best_k) of lanes ``idx`` of the rays (o, d, tm) over the
    sphere table, then the triangle table where there is one, from
    ``t_init`` (BIG, or the shadow rays' thresholds, per lane of ``idx``);
    the other lanes get (BIG or their t_init, 0).  The (chunk, 128) pair
    temporaries bound the chunk.  ``tally`` ([box tests, triangle tests,
    ...]) gets the triangle sweep's work."""
    n = tm.shape[0]
    best_t = torch.full((n,), BIG, dtype=_F32, device=tm.device)
    best_k = torch.zeros((n,), dtype=torch.int64, device=tm.device)
    chunk = 1 << 18 if tm.device.type == "cuda" else 1 << 14
    for start in range(0, idx.numel(), chunk):
        i = idx[start:start + chunk]
        ox, oy, oz = (v[i] for v in o)
        dx, dy, dz = (v[i] for v in d)
        a = dx * dx + dy * dy + dz * dz
        bt, bk = nearest_sphere(
            tbl, ox, oy, oz, dx, dy, dz, tm[i], a, 1.0 / a,
            t_init=None if t_init is None else t_init[start:start + chunk])
        if tris is not None:
            bt, bk = nearest_triangle(tris, ox, oy, oz, dx, dy, dz, bt, bk,
                                      tbl.shape[0], flat=flat, tally=tally)
        best_t[i], best_k[i] = bt, bk
    return best_t, best_k


def _replay(cont, ints, tbl, tris, it, seed, flat, tally):
    """The bounce's main sweep: (alive, best_t, best_k, lane hashes,
    salt); ``tally`` ([box tests, triangle tests, shadow rays]) gets its
    work."""
    alive = ints[0] > 0
    with torch.no_grad():
        best_t, best_k = _sweep(tbl, tris, cont[0:3], cont[3:6], cont[6],
                                torch.nonzero(alive).flatten(), flat, tally)
    return alive, best_t, best_k, lane_hash(ints[2].long()), step_salt(seed,
                                                                         it)


def _shadow_open(tbl, tris, p, l, tm, thresh, nee_act, flat, tally):
    """Whether each NEE lane's shadow ray (from ``p`` along ``l``) reaches
    ``thresh`` unblocked: the shadow sweep from ``t_init = thresh``
    (``_nee_contrib``'s caller, pallas_grad.py:193-204), a constant for
    autograd.  ``tally[2]`` counts the shadow rays, its first two entries
    their sweep's box and triangle tests."""
    with torch.no_grad():
        sub = torch.nonzero(nee_act).flatten()
        tally[2] += sub.numel()
        s_t, _ = _sweep(tbl, tris, [v.detach() for v in p],
                        [v.detach() for v in l], tm.detach(), sub, flat,
                        tally, t_init=thresh.detach()[sub])
        return nee_act & (s_t >= thresh.detach())


def _lit_shade(state, ints, w, tri, best_t, alive, lane, salt, *, tbl, tris,
               lit, max_depth, background, flat, tally, nee_stats=None):
    """The differentiable half of a bounce with the lit features
    (``_grad_fwd_kernel``'s live tile, :165-215): the free-flight event
    where ``lit`` has media (its distance and albedo differentiable in the
    volume rows, which event wins a constant), next-event estimation
    where it has lights (from the hit point or the event's), its
    contribution added where the shadow ray gets through, then
    ``bounce.shade`` with the volume scatter, emission, the MIS
    weight (the previous bounce's diffuse flag is the alive code 2) and
    the textures.  Returns shade's (13-tuple, can, bounce).
    ``nee_stats`` (or None): :func:`_count_nee`'s counts of the NEE
    lanes."""
    bounce = ints[1]
    basics = hit_basics(state, w, best_t, tri=tri, checker=lit.checker)
    draws = draw_scatter(lane, salt)
    v_event = volume_event(state, draws, lane, salt, best_t, lit)
    from_diffuse = None
    if lit.nee_kinds:
        from_diffuse = ints[0] > 1
        nee_us = (hash_uniform(lane, salt, 8), hash_uniform(lane, salt, 9),
                  hash_uniform(lane, salt, 10))
        p, l, thresh, contrib, nee_act = nee_contrib(
            state, basics, alive, bounce, max_depth, nee_us, lit, v_event)
        add = _shadow_open(tbl, tris, p, l, state[6], thresh, nee_act, flat,
                           tally)
        if nee_stats is not None:
            _count_nee(nee_act,
                       None if v_event is None else nee_act & v_event[0],
                       nee_stats)
        state = state[:10] + tuple(ch + torch.where(add, c, 0.0)
                                   for ch, c in zip(state[10:], contrib))
    return shade(state, w, draws, best_t, alive, bounce, max_depth,
                 background, tri=tri, basics=basics, lit=lit,
                 from_diffuse=from_diffuse, v_event=v_event)


def _count_nee(nee_act, vol, nee_stats) -> None:
    """Adds K5's NEE counts to ``nee_stats``: the NEE lanes that are volume
    events (``vol``; None: none), and the warps (lanes 32 w .. 32 w + 31)
    whose NEE lanes hold both a volume event and a surface hit, which the
    kernel's one NEE pass a warp serves together."""
    if vol is None:
        vol = torch.zeros_like(nee_act)
    pad = -nee_act.numel() % 32
    warps_vol = torch.nn.functional.pad(vol, (0, pad)).view(-1, 32).any(1)
    warps_surf = torch.nn.functional.pad(nee_act & ~vol,
                                         (0, pad)).view(-1, 32).any(1)
    nee_stats += torch.stack([vol.sum(), (warps_vol & warps_surf).sum()]).to(
        nee_stats.device)


def _count(tally, alive, stats) -> None:
    """Adds the box tests, triangle tests, live lanes and shadow rays to
    ``stats`` (or None), as the kernels count them."""
    if stats is not None:
        stats += torch.tensor(tally[:2] + [int(alive.sum()), tally[2]],
                              device=stats.device)


def bounce_fwd_reference(cont, ints, tbl, tris: Optional[TriTable] = None,
                         *, it: int, seed: int, max_depth: int,
                         background="sky", flat: bool = False,
                         stats: Optional[torch.Tensor] = None,
                         lit: Lit = Lit()):
    """Plain PyTorch version of K4: one bounce of every lane ->
    (cont, ints).  Same inputs and outputs as :func:`bounce_fwd`."""
    tally = [0, 0, 0]
    alive, best_t, best_k, lane, salt = _replay(cont, ints, tbl, tris, it,
                                                seed, flat, tally)
    w, tri = winners(tbl, tris, best_t, best_k,
                     cols=TBL_COLS if lit.checker else _N_PARAMS)
    state, can, bounce = _lit_shade(
        tuple(cont.unbind(0)), ints, w, tri, best_t, alive, lane, salt,
        tbl=tbl, tris=tris, lit=lit, max_depth=max_depth,
        background=background, flat=flat, tally=tally)
    _count(tally, alive, stats)
    return torch.stack(state), torch.stack([can.to(_I32), bounce, ints[2]])


def bounce_bwd_reference(cont, ints, cot_out, tbl,
                         tris: Optional[TriTable] = None, *, it: int,
                         seed: int, max_depth: int, background="sky",
                         flat: bool = False,
                         stats: Optional[torch.Tensor] = None,
                         lit: Lit = Lit(),
                         nee_stats: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K5 -> (cot_in (13, L), g_tbl (Npad, 16),
    g_tri (Mpad, 16) or None without ``tris``, g_rows (R, 14) or None
    without light or volume rows): each hit lane's row cotangent from
    :func:`bounce_bwd_terms` added to its winner's row of ``g_tbl`` or,
    for a triangle, of ``g_tri`` (``pallas_grad.py:444-539``; the kind
    column and column 15 get 0), and the lanes' cotangents of the light
    and volume rows summed (``glgt``, :448-462)."""
    cot_in, sph, tri, rows = bounce_bwd_terms(
        cont, ints, cot_out, tbl, tris, it=it, seed=seed,
        max_depth=max_depth, background=background, flat=flat, stats=stats,
        lit=lit, nee_stats=nee_stats)
    return (cot_in, table_sums(sph, tbl.shape[0]),
            None if tri is None else table_sums(tri, tris.tbl.shape[0]),
            None if rows is None else rows.sum(dim=0))


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
                     stats: Optional[torch.Tensor] = None, lit: Lit = Lit(),
                     nee_stats: Optional[torch.Tensor] = None):
    """K5's plain version before its table sums -> (cot_in (13, L), the
    sphere-hit lanes' (winner rows, row cotangents (H, 13), or (H, 16)
    with textures), the triangle-hit lanes' (winner rows, row cotangents
    (T, 14)) or None without ``tris``, each lane's cotangent of the light
    and volume rows (L, R, 14) or None without them).

    Replays the sweeps, the draws and the shadow rays, then takes
    ``torch.autograd.grad`` of the plain lit shade (:func:`_lit_shade`)
    w.r.t. the input state, the winner rows of each kind (the rows
    :func:`winners` gives the forward) and a per-lane copy of the light
    and volume rows.  ``tm`` passes through the bounce, so its cotangent
    gets the downstream one added (:433-436): the stacked output below
    holds that identity."""
    tally = [0, 0, 0]
    alive, best_t, best_k, lane, salt = _replay(cont, ints, tbl, tris, it,
                                                seed, flat, tally)
    npad, n = tbl.shape[0], best_k.numel()
    hit = best_t < BIG
    is_tri = (best_k >= npad if tris is not None
              else torch.zeros_like(hit))
    sph_hit, tri_hit = hit & ~is_tri, hit & is_tri
    cols = TBL_COLS if lit.checker else _N_PARAMS
    with torch.enable_grad():
        state = cont.detach().requires_grad_(True)
        rows = (tbl.detach()[best_k.clamp(max=npad - 1), :cols] if npad
                else torch.zeros((n, cols), dtype=_F32,
                                 device=tbl.device)).requires_grad_(True)
        inputs, tri = [state, rows], None
        if tris is not None:
            trows = tris.tbl.detach()[(best_k - npad).clamp(min=0),
                                      :TRI_PARAMS].requires_grad_(True)
            inputs.append(trows)
            tri = (torch.where(tri_hit[:, None], trows, 0.0), is_tri)
        lane_lit = lit
        if lit.rows is not None:
            lrows = lit.rows.detach()[None].expand(
                n, *lit.rows.shape).contiguous().requires_grad_(True)
            inputs.append(lrows)
            lane_lit = lit._replace(rows=lrows)
        out, _can, _bounce = _lit_shade(
            tuple(state.unbind(0)), ints, torch.where(sph_hit[:, None], rows,
                                                      0.0),
            tri, best_t, alive, lane, salt, tbl=tbl, tris=tris, lit=lane_lit,
            max_depth=max_depth, background=background, flat=flat,
            tally=tally, nee_stats=nee_stats)
        grads = torch.autograd.grad(torch.stack(out), inputs, cot_out,
                                    allow_unused=True)
    _count(tally, alive, stats)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    sph = (best_k[sph_hit], grads[1][sph_hit])
    tri_terms = None
    if tris is not None:
        tri_terms = (best_k[tri_hit] - npad,
                     grads[2][tri_hit, :_N_TRI_PARAMS])
    return (grads[0], sph, tri_terms,
            grads[-1] if lit.rows is not None else None)


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


def _bwd_layout(tbl: torch.Tensor, lit: Lit,
                tris: Optional[TriTable]) -> Tuple[int, Tuple[int, int, int]]:
    """K5's shared memory beside its two copies of the sphere table ->
    (bytes, (tri_rows, own, frames)), the layout ``rtow_grad_bwd`` takes
    (``csrc/grad_bwd.cu``'s ``Layout``).  Always the light and volume rows
    and one copy of their sums; then, each only where the block's shared
    memory still holds it, in the order of what each saved for its bytes
    (PERF.md): the volumes' frames (8 bytes a volume), the triangle
    table's gradient where it has at most ``TRI_SHARED_ROWS`` rows, and
    each thread's own row sums where they take at most
    ``OWN_ROWS_BYTES`` (``own``: the odd stride between two threads'
    copies).  So K5 takes every table that fits with the rows alone."""
    rows = lit_rows(lit)
    used = 2 * tbl.numel() * 4 + 2 * rows * LIGHT_COLS * 4
    tri_rows = own = frames = 0
    if lit.vol_kinds and used + 8 * len(lit.vol_kinds) <= MAX_TABLE_BYTES:
        frames = 1
        used += 8 * len(lit.vol_kinds)
    if tris is not None and tris.tbl.shape[0] <= TRI_SHARED_ROWS \
            and used + tris.tbl.numel() * 4 <= MAX_TABLE_BYTES:
        tri_rows = tris.tbl.shape[0]
        used += tris.tbl.numel() * 4
    stride = (rows * LIGHT_COLS) | 1
    more = BWD_THREADS * stride * 4 - rows * LIGHT_COLS * 4
    if rows and BWD_THREADS * stride * 4 <= OWN_ROWS_BYTES \
            and used + more <= MAX_TABLE_BYTES:
        own = stride
        used += more
    return used - 2 * tbl.numel() * 4, (tri_rows, own, frames)


def _check(kernel, tbl, tris, cont, ints, cot, stats, lit, **scalars):
    """The wrappers' checks -> (it, seed, max_depth).  ``lit`` holds only
    what the gradient kernels take: JAX's gradient statics have no
    roulette."""
    if lit.roulette:
        raise ValueError("the gradient kernels have no Russian roulette "
                         "(pallas_grad.py:910-913)")
    check_lit(lit, tbl)
    copies = 2 if cot is not None else 1
    staged = (lit_rows(lit) * LIGHT_COLS * 4 if cot is None
              else _bwd_layout(tbl, lit, tris)[0])
    check_table(tbl, kernel, copies=copies, staged=staged)
    if tris is not None:
        check_tris(tris, tbl, kernel)
    _check_state(tbl, cont, ints, cot)
    check_counter(stats, 4, tbl, "stats")
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


#: K4's and K5's warp forms (``grad_fwd_warp``, ``grad_bwd_warp``) run a
#: triangle launch of at most this many live lanes; the thread forms run
#: the rest.  It is K3's cut, measured on K3's launches
#: (:data:`.flat_bounce.WARP_MAX_LIVE`).  K4's and K5's own launches,
#: timed alone in both forms on the 65k knot and the lit 65k knot
#: (``chip_smoke.py`` phase 20), put each cut between 235,170 live lanes
#: (the warp form wins) and 1,048,576 (it loses); those tapes have no
#: launch in between, so any cut there picks the same forms
#: (``python -m rtow_tpu_torch.time_k4 --cross`` times K4's forms in
#: between).  Read at each call: a launch's lane count or more runs the
#: warp form alone, below 0 the thread form runs every launch.
WARP_MAX_LIVE = flat_bounce.WARP_MAX_LIVE


def warp_forms(tris: Optional[TriTable]) -> bool:
    """Whether K4 and K5 issue their warp forms beside the thread forms:
    for a triangle table of more than one block.  The warp form's gain is
    a lane's blocks swept by 32 threads; a table of one block (the Cornell
    and smoke boxes' 12-24 walls) gives it none, and there issuing both
    forms with a live count cost K4 4-21% (PERF.md)."""
    return tris is not None and tris.n_blocks > 1


def _live_count(ints, tris, live):
    """The launchers' device count of the live lanes (``live``, or
    counted here from ``ints``), or None where the kernels issue the
    thread form alone (:func:`warp_forms`)."""
    if not warp_forms(tris):
        return None
    if live is None:
        return torch.count_nonzero(ints[0])
    if live.dtype != torch.int64 or live.numel() != 1 \
            or live.device != ints.device:
        raise ValueError(f"live must be a one-element int64 count on the "
                         f"lanes' device, got {live.dtype} "
                         f"{tuple(live.shape)} {live.device}")
    return live


def bounce_fwd(cont: torch.Tensor, ints: torch.Tensor, tbl: torch.Tensor,
               tris: Optional[TriTable] = None, *, it: int, seed: int,
               max_depth: int, background: Union[str, tuple] = "sky",
               flat: bool = False, stats: Optional[torch.Tensor] = None,
               lit: Lit = Lit(), live: Optional[torch.Tensor] = None):
    """One forward bounce (``_bounce_fwd_impl``, :592) -> (cont, ints).

    ``tris``: the scene's triangle table, or None; ``flat`` sweeps its
    block boxes without the hierarchy; ``lit``: the lit features and the
    light and volume rows (``tables.scene_lit``); ``stats``, a (4,) int64
    tensor on the table's device, gets the box tests, triangle tests (the
    shadow sweep's included), live lanes and NEE shadow rays added to it.
    A CUDA ``tbl`` launches ``csrc/grad_fwd.cu`` (counted in
    ``bounce_fwd.launches``, in ``lit_launches`` where ``lit`` has a
    feature, and in ``vol_launches`` where it has media); a CPU ``tbl`` runs
    :func:`bounce_fwd_reference`; any other device raises.  With a
    triangle table of more than one block (:func:`warp_forms`), it issues
    both of K4's forms, and the card runs the warp form (one warp per live
    lane) where the launch has at most ``WARP_MAX_LIVE`` live lanes, the
    thread form elsewhere, from ``live`` (a one-element int64 tensor on
    the card, ``torch.count_nonzero(ints[0])``) or from a count taken
    here; launches that issue the warp form are also counted in
    ``bounce_fwd.warp_launches``.  Otherwise the thread form runs alone,
    with no count.  Both forms give the same outputs and counters, bit
    for bit.  Triangles are one-sided, as in JAX's gradient
    (pallas_grad.py:910)."""
    it, seed, max_depth = _check("grad_fwd kernel", tbl, tris, cont, ints,
                                 None, stats, lit, it=it, seed=seed,
                                 max_depth=max_depth)
    if tbl.device.type == "cpu":
        return bounce_fwd_reference(cont, ints, tbl, tris, it=it, seed=seed,
                                    max_depth=max_depth,
                                    background=background, flat=flat,
                                    stats=stats, lit=lit)
    lib = _lib("grad_fwd")
    use_sky, (bgr, bgg, bgb) = background_args(background)
    cont_out = torch.empty_like(cont)
    ints_out = torch.empty_like(ints)
    live = _live_count(ints, tris, live)
    err = lib.rtow_grad_fwd(
        tbl.data_ptr(), tbl.shape[0], *_tri_args(tris, flat),
        cont.data_ptr(), ints.data_ptr(), cont.shape[1], it, seed, max_depth,
        int(use_sky), bgr, bgg, bgb, cont_out.data_ptr(), ints_out.data_ptr(),
        None if stats is None else stats.data_ptr(), *grad_lit_args(lit),
        None if live is None else live.data_ptr(), WARP_MAX_LIVE,
        *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "grad_fwd")
    bounce_fwd.launches += 1
    bounce_fwd.lit_launches += lit.any
    bounce_fwd.vol_launches += bool(lit.vol_kinds)
    bounce_fwd.warp_launches += live is not None
    return cont_out, ints_out


#: Kernel launches made by :func:`bounce_fwd` in this process, those of
#: them that ran a lit instance, those of these that ran media, and those
#: that issued the warp form.
bounce_fwd.launches = 0
bounce_fwd.lit_launches = 0
bounce_fwd.vol_launches = 0
bounce_fwd.warp_launches = 0


def bounce_bwd(cont: torch.Tensor, ints: torch.Tensor, cot_out: torch.Tensor,
               tbl: torch.Tensor, tris: Optional[TriTable] = None, *,
               it: int, seed: int, max_depth: int,
               background: Union[str, tuple] = "sky", flat: bool = False,
               stats: Optional[torch.Tensor] = None, lit: Lit = Lit(),
               live: Optional[torch.Tensor] = None,
               nee_stats: Optional[torch.Tensor] = None):
    """One backward bounce (``_bounce_grad_bwd``, :639) from the bounce's
    saved input state -> (cot_in (13, L), g_tbl (Npad, 16), g_tri (Mpad,
    16) or None without ``tris``, g_rows (R, 14) or None without light or
    volume rows).  ``tris``, ``flat``, ``lit``, ``stats`` and ``live`` as
    for :func:`bounce_fwd`.  ``nee_stats``, a (2,) int64 tensor on the
    table's device, gets added the NEE adjoints run from volume events and
    the warps of 32 lanes (lanes 32 w .. 32 w + 31) whose one NEE pass
    served both a volume event and a diffuse surface hit: on a launch with
    media the lit instance's thread form has a warp's threads meet before
    NEE's adjoint, runs it once for both kinds and counts there; the warp
    form (one lane a warp) counts no merged warp.

    A CUDA ``tbl`` launches ``csrc/grad_bwd.cu`` (counted in
    ``bounce_bwd.launches``, ``lit_launches`` and ``vol_launches``, as for
    :func:`bounce_fwd`); a CPU ``tbl`` runs
    :func:`bounce_bwd_reference`; any other device raises.  Where
    :func:`warp_forms`, it issues both of K5's forms, and the card runs
    the warp form (one warp per live lane) where the launch has at most
    ``WARP_MAX_LIVE`` live lanes, from a count on the card (``live``, or
    taken here), the thread form elsewhere.  Launches that issue the warp form are also
    counted in ``bounce_bwd.warp_launches``.  Both forms give the same
    cot_in and counters, and table gradients that differ only by the
    atomics' order."""
    it, seed, max_depth = _check("grad_bwd kernel", tbl, tris, cont, ints,
                                 cot_out, stats, lit, it=it,
                                 seed=seed, max_depth=max_depth)
    check_counter(nee_stats, 2, tbl, "nee_stats")
    if tbl.device.type == "cpu":
        return bounce_bwd_reference(cont, ints, cot_out, tbl, tris, it=it,
                                    seed=seed, max_depth=max_depth,
                                    background=background, flat=flat,
                                    stats=stats, lit=lit,
                                    nee_stats=nee_stats)
    lib = _lib("grad_bwd")
    use_sky, (bgr, bgg, bgb) = background_args(background)
    cot_in = torch.empty_like(cot_out)
    g_tbl = torch.zeros_like(tbl)
    g_tri = None if tris is None else torch.zeros_like(tris.tbl)
    g_rows = None if lit.rows is None else torch.zeros_like(lit.rows)
    live = _live_count(ints, tris, live)
    err = lib.rtow_grad_bwd(
        tbl.data_ptr(), tbl.shape[0], *_tri_args(tris, flat),
        cont.data_ptr(), ints.data_ptr(), cot_out.data_ptr(), cont.shape[1],
        it, seed, max_depth, int(use_sky), bgr, bgg, bgb, cot_in.data_ptr(),
        g_tbl.data_ptr(), None if g_tri is None else g_tri.data_ptr(),
        None if g_rows is None else g_rows.data_ptr(),
        None if stats is None else stats.data_ptr(),
        None if nee_stats is None else nee_stats.data_ptr(),
        *grad_lit_args(lit), *_bwd_layout(tbl, lit, tris)[1],
        None if live is None else live.data_ptr(),
        WARP_MAX_LIVE, *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "grad_bwd")
    bounce_bwd.launches += 1
    bounce_bwd.lit_launches += lit.any
    bounce_bwd.vol_launches += bool(lit.vol_kinds)
    bounce_bwd.warp_launches += live is not None
    return cot_in, g_tbl, g_tri, g_rows


#: Kernel launches made by :func:`bounce_bwd` in this process, those of
#: them that ran a lit instance, those of these that ran media, and those
#: that issued the warp form.
bounce_bwd.launches = 0
bounce_bwd.lit_launches = 0
bounce_bwd.vol_launches = 0
bounce_bwd.warp_launches = 0


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` (grad_fwd or grad_bwd), built at first use, with
    its launcher declared."""
    lib = _cuda.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tri = [p, p, p, p, i, i, i, i, i]
    lit = [p, i, i, i, i, i, i, i, i]
    if name == "grad_fwd":
        lib.rtow_grad_fwd.argtypes = [p, i, *tri, p, p, i, i, i, i, i, f, f,
                                      f, p, p, p, *lit, p, i, i, p]
        lib.rtow_grad_fwd.restype = i
    else:
        lib.rtow_grad_bwd.argtypes = [p, i, *tri, p, p, p, i, i, i, i, i, f,
                                      f, f, p, p, p, p, p, p, *lit, i, i, i,
                                      p, i, i, p]
        lib.rtow_grad_bwd.restype = i
    return lib


class BounceGrad(torch.autograd.Function):
    """One differentiable bounce (``pallas_grad.bounce_grad``, :573):
    (cont, ints) -> (cont, ints), differentiable in ``cont``, ``tbl``, the
    triangle rows ``tri_tbl`` and the light and volume rows ``rows``.

    The forward is :func:`bounce_fwd` and saves its input state (the
    tape); the backward is :func:`bounce_bwd` on that state.  ``ints``
    carries no cotangent, nor do the triangle boxes: ``tris`` is the
    table without its rows (``tbl=None``), decisions only; ``lit`` is the
    lit features without their rows.  On the card, where the kernels
    issue their warp forms (:func:`warp_forms`), the live lanes are
    counted once: the forward's count picks K4's form and is kept for
    K5's."""

    @staticmethod
    def forward(ctx, cont, ints, tbl, tri_tbl, rows, tris, lit, it, seed,
                max_depth, background, flat):
        full = None if tris is None else tris._replace(tbl=tri_tbl)
        with span("rtow.grad.k4"):
            live = (torch.count_nonzero(ints[0])
                    if warp_forms(full) and ints.is_cuda else None)
            cont_out, ints_out = bounce_fwd(cont, ints, tbl, full, it=it,
                                            seed=seed, max_depth=max_depth,
                                            background=background, flat=flat,
                                            lit=lit._replace(rows=rows),
                                            live=live)
        ctx.save_for_backward(cont, ints, tbl, tri_tbl, rows)
        ctx.tris, ctx.lit, ctx.live = tris, lit, live
        ctx.scalars = dict(it=it, seed=seed, max_depth=max_depth,
                           background=background, flat=flat)
        ctx.mark_non_differentiable(ints_out)
        return cont_out, ints_out

    @staticmethod
    def backward(ctx, g_cont, _g_ints):
        cont, ints, tbl, tri_tbl, rows = ctx.saved_tensors
        full = None if ctx.tris is None else ctx.tris._replace(tbl=tri_tbl)
        # On a card this runs on the autograd engine's device thread.
        with span("rtow.grad.k5"):
            cot_in, g_tbl, g_tri, g_rows = bounce_bwd(
                cont, ints, g_cont.contiguous(), tbl, full,
                lit=ctx.lit._replace(rows=rows), live=ctx.live,
                **ctx.scalars)
        return (cot_in, None, g_tbl, g_tri, g_rows) + (None,) * 7


def bounce_grad(cont, ints, tbl, tris: Optional[TriTable] = None, *,
                it: int, seed: int, max_depth: int,
                background: Union[str, tuple] = "sky", flat: bool = False,
                lit: Lit = Lit()):
    """:class:`BounceGrad` applied to one bounce."""
    return BounceGrad.apply(
        cont, ints, tbl, None if tris is None else tris.tbl, lit.rows,
        None if tris is None else tris._replace(tbl=None),
        lit._replace(rows=None), it, seed, max_depth, background, flat)


# ---------------------------------------------------------------------------
# The differentiable render.


class LanePermute(torch.autograd.Function):
    """(cont, ints, perm) -> the lanes in the order ``perm``, a
    permutation (``torch.argsort``'s): two gathers, differentiable in
    ``cont`` (``pallas_grad._permute_by``, :724-758).

    The backward puts the cotangent back in lane order, ``g_in[:, perm[j]]
    = g_out[:, j]``, writing each column once into an empty tensor.  A
    permutation has nothing to sum, so ``index_select``'s own backward, an
    accumulating scatter into zeros that first sorts the indices, is not
    needed; ``perm`` is saved as it is, so the forward launches nothing
    beside its two gathers.  Nor does the backward zero-fill a cotangent
    for ``ints`` (``set_materialize_grads(False)``)."""

    @staticmethod
    def forward(ctx, cont, ints, perm):
        ctx.save_for_backward(perm)
        ctx.set_materialize_grads(False)
        ints_out = ints.index_select(1, perm)
        ctx.mark_non_differentiable(ints_out)
        return cont.index_select(1, perm), ints_out

    @staticmethod
    def backward(ctx, g_cont, _g_ints):
        perm, = ctx.saved_tensors
        # On a card this runs on the autograd engine's device thread.
        with span("rtow.grad.unpermute"):
            g_in = torch.empty_like(g_cont).index_copy_(1, perm, g_cont)
        permute_lanes.bwd_launches += 1
        return g_in, None, None


def permute_lanes(cont, ints, perm):
    """:class:`LanePermute` applied to the lanes (cont, ints)."""
    permute_lanes.launches += 1
    return LanePermute.apply(cont, ints, perm)


#: Permutations of the lanes made by :func:`permute_lanes` in this
#: process, and un-permutes of their cotangents by its backward.
permute_lanes.launches = 0
permute_lanes.bwd_launches = 0


def _sort_lanes(cont, ints, grid):
    """The lanes in the order of their spatial keys on ``grid``."""
    with span("rtow.grad.sort"):
        with torch.no_grad():
            perm = torch.argsort(sort_keys(cont, ints[0], *grid), stable=True)
        return permute_lanes(cont, ints, perm)


def render_rays_kernel(scene: Scene, rays: Rays, *, n_pixels: int, spp: int,
                       max_depth: int, seed: int = 0, sort_lanes=None,
                       force_flat: bool = False, nee: bool = False,
                       tables: Optional[GradTables] = None) -> torch.Tensor:
    """Differentiable mean radiance of ``n_pixels`` pixels -> (P, 3), from
    their ``n_pixels * spp`` camera rays in (pixel, sample) order (the
    lane half of ``render_pixels_kernel``, pallas_grad.py:915-1001):
    :func:`lane_state`, then ``max_depth + 1`` bounces of
    :class:`BounceGrad`, each after a sort of the lanes where
    ``sort_lanes`` (None: for meshes of more than 16,384 triangles).
    ``force_flat`` sweeps the triangle blocks flat; ``nee`` samples the
    lights at every diffuse hit (``tables.scene_lit``).  ``tables``, built
    by ``tables.grad_tables`` from ``scene``, replaces those three: the
    render
    then builds none.  The render runs on the scene's device: the kernels
    on a card, their plain versions on the CPU."""
    if tables is None:
        tables = grad_tables(scene, sort_lanes=sort_lanes,
                             force_flat=force_flat, nee=nee)
    l_raw = n_pixels * spp
    cont, ints = lane_state(rays, l_raw, scene.device)
    for it in range(max_depth + 1):
        with span("rtow.train.bounce"):
            if tables.grid is not None:
                cont, ints = _sort_lanes(cont, ints, tables.grid)
            cont, ints = bounce_grad(cont, ints, tables.tbl, tables.tris,
                                     it=it, seed=seed, max_depth=max_depth,
                                     background=scene.background,
                                     flat=tables.flat, lit=tables.lit)
    if tables.grid is not None:
        # Back to lane order, so a pixel's samples are adjacent.
        with span("rtow.grad.sort"):
            cont, ints = permute_lanes(cont, ints, torch.argsort(ints[2]))
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
    tables: Optional[GradTables] = None,
) -> torch.Tensor:
    """Differentiable mean radiance of the given pixels -> (P, 3)
    (``render_pixels_kernel``, pallas_grad.py:761): camera rays from
    ``gen`` (a ``torch.Generator`` on the scene's device, in place of the
    JAX key) and :func:`render_rays_kernel`.  ``jitter=False`` pins rays
    to pixel centres (FD gates).  ``sort_lanes`` (None: by the triangle
    count), ``_force_flat`` and ``tables`` as there; ``nee=True``
    (emissive scenes only) runs next-event estimation with MIS in both
    kernels.  Gradients reach every scene leaf that
    ``build_sphere_table``, ``build_tri_table``, under NEE
    ``build_light_table``, and ``build_volume_table`` read (sphere
    centers and radii, triangle vertices, albedo and the second colour,
    fuzz, ir; the media's density, albedo, corners or centre and radius,
    rotate_y and translate)."""
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
                              sort_lanes=sort_lanes, force_flat=_force_flat,
                              nee=nee, tables=tables)


def scene_params(scene: Scene) -> Dict[str, torch.Tensor]:
    """The scene's floating-point leaves, detached, as fresh tensors that
    require gradients, under their dotted keys."""
    return {k: v.detach().requires_grad_(True)
            for k, v in scene.leaves().items() if v.is_floating_point()}


def scene_grads(value: torch.Tensor, params: Dict[str, torch.Tensor],
                scene: Scene) -> Scene:
    """d value / d ``params`` (from :func:`scene_params` of ``scene``) as
    a Scene: the float leaves hold the gradients (zeros where ``value``
    does not read the leaf), the integer leaves None."""
    grads = torch.autograd.grad(value, list(params.values()),
                                allow_unused=True)
    out = {k: None for k in scene.leaves()}
    for (k, p), g in zip(params.items(), grads):
        out[k] = torch.zeros_like(p) if g is None else g
    return scene.replace_leaves(out)


def scene_value_and_grad(fn: Callable[[Scene], torch.Tensor],
                         scene: Scene) -> Tuple[torch.Tensor, Scene]:
    """(fn(scene), d fn / d scene) for a scalar ``fn``: the counterpart of
    ``jax.value_and_grad(fn, allow_int=True)``, the gradient as
    :func:`scene_grads` gives it."""
    params = scene_params(scene)
    with torch.enable_grad():
        value = fn(scene.replace_leaves(params))
    return value.detach(), scene_grads(value, params, scene)


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
