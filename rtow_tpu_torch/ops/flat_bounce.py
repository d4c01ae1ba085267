"""One bounce of L sorted lanes (K3), and its plain PyTorch version (the
port of ``bounce_step_pallas`` / ``_flat_bounce_kernel``,
``rtow_tpu/ops/pallas_megakernel.py:1739-2001``).

The sorted-wavefront mesh path (``ops/wavefront.py``) keeps every ray's
state in one packed (16, L) float32 tensor and calls :func:`bounce_step`
once per bounce.  Rows: ox oy oz dx dy dz tm tpr tpg tpb rr rg rb, the
alive code, the bounce count and the lane id, the last three as exact
float32 integers.  A live lane (alive > 0) is advanced one bounce: the
sphere sweep, the triangle sweep down the table's hyper / super / block
hierarchy, the shade, as in ``ops/megakernel.py``; a dead lane is copied
through.  The lane's random numbers are the counter hash on its lane id
(``lane_hash``) and the step salt ``mix(seed + it * 40503)``
(pallas_megakernel.py:1791-1792), so a lane's path does not depend on
where the sort put it.

Scenes with lights, textures or media, and renders with Russian
roulette, carry their lit features in ``Tables.lit``
(``megakernel.scene_lit``; JAX's static flags and light-table operand,
:1742-1744): emission with its MIS weight, next-event estimation with a
shadow ray down the same hierarchy, the volume event, the textured
albedo, roulette.  Under NEE the alive code is 2 after a diffuse or
volume scatter, and the next bounce reads it back as ``from_diffuse =
alive > 1`` (:1809).  ``cull=False`` makes the triangles two-sided.

``bounce_step`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/flat_bounce.cu`` (counting the launch in
``bounce_step.launches``, a lit one also in ``bounce_step.lit_launches``
and one of the warp form also in ``bounce_step.warp_launches``), on a
CPU tensor it runs :func:`bounce_step_reference`, and on anything else it
raises.  The kernel has two forms with the same outputs, bit for bit:
one thread per lane, for the wide launches, and one warp per live lane
(``WARP_MAX_LIVE``), for the narrow ones of the window ladder's drain.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from . import _cuda
from .megakernel import (
    LIGHT_COLS, Lit, TriTable, background_args, bounce_lanes, check_counter,
    check_lit, check_table, check_tris, lit_args, lit_rows, lane_hash,
    step_salt,
)

#: Rows of the packed lane state.
STATE_ROWS = 16
_ALIVE, _BOUNCE, _LANE = 13, 14, 15

_F32 = torch.float32

#: The cut-over between K3's forms: a launch whose state has at most this
#: many live lanes runs the warp form (one warp per live lane), a wider
#: one the thread form.  Set from the two forms timed launch by launch in
#: turns (chip_smoke.py phases 13 and 25; NVIDIA H100 80GB HBM3, 700 W) on
#: the 262,144-lane centre chunks of bench.py's 65k and 360k knots and of
#: the lit 65k knot: from 201,601 live lanes down, the warp form wins every
#: launch (65k: 1.35 against 3.81 ms there, 0.12-0.22 against 0.33-6.6 ms
#: at 6,572 and fewer); at the chunk's first launch, all 262,144 lanes
#: live, the thread form wins on the unlit knots (1.30 against 2.15 ms,
#: 360k 1.03 against 1.41) and loses on the lit one (5.38 against 3.72).
#: A count cannot tell those apart; the cut keeps the full first launch on
#: the thread form, as bench.py's mesh legs (unlit) want.
WARP_MAX_LIVE = 240_000


class Tables(NamedTuple):
    """The scene tables of a bounce: the (Npad, 16) sphere table (Npad
    may be 0), the triangle table with its hierarchy, and the lit
    features with their light and volume rows (none by default)."""
    sph: torch.Tensor
    tris: TriTable
    lit: Lit = Lit()


def _check(state: torch.Tensor, tables: Tables, stats, shadows,
           live=None) -> None:
    check_lit(tables.lit, tables.sph)
    check_table(tables.sph, "flat bounce",
                staged=lit_rows(tables.lit) * LIGHT_COLS * 4)
    check_tris(tables.tris, tables.sph, "flat bounce")
    if (state.dtype != _F32 or state.dim() != 2
            or state.shape[0] != STATE_ROWS or not state.is_contiguous()
            or state.device != tables.sph.device):
        raise ValueError("state must be a contiguous (16, L) float32 tensor "
                         "on the tables' device")
    if state.shape[1] >= 1 << 24:
        raise ValueError("lane ids must stay exact in float32 (L < 2**24)")
    check_counter(stats, 3, tables.sph, "stats")
    check_counter(shadows, 1, tables.sph, "shadows")
    if live is not None and not 0 <= live <= state.shape[1]:
        raise ValueError(f"live must be a lane count in [0, "
                         f"{state.shape[1]}], got {live}")


def bounce_step_reference(state: torch.Tensor, it: int, seed: int,
                          max_depth: int, tables: Tables, *,
                          background: Union[str, tuple] = "sky",
                          stats: Optional[torch.Tensor] = None,
                          shadows: Optional[torch.Tensor] = None,
                          cull: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K3: a new (16, L) state.  Same inputs and
    outputs as :func:`bounce_step`; the bounce is K1's plain one
    (``megakernel.bounce_lanes``) with both triangle sweeps down the
    hierarchy, as the kernel traverses it."""
    out = state.clone()
    live = torch.nonzero(state[_ALIVE] > 0).flatten()
    lit = tables.lit
    tally = [0, 0, 0]  # box tests, triangle tests, shadow rays
    if live.numel():
        code = state[_ALIVE, live]
        new, can, bounce = bounce_lanes(
            tables.sph, tables.tris, tuple(state[:13, live].unbind(0)),
            lane_hash(state[_LANE, live].long()), step_salt(seed, it),
            state[_BOUNCE, live].to(torch.int32), max_depth, background,
            lit=lit, from_diffuse=code > 1 if lit.nee_kinds else None,
            tally=tally, flat=False, cull=cull)
        out[:13, live] = torch.stack(new)
        out[_ALIVE, live] = can.to(_F32)
        out[_BOUNCE, live] = bounce.to(_F32)
    if stats is not None:
        stats += torch.tensor(tally[:2] + [live.numel()], device=state.device)
    if shadows is not None:
        shadows += tally[2]
    return out


def bounce_step(state: torch.Tensor, it: int, seed: int, max_depth: int,
                tables: Tables, *, background: Union[str, tuple] = "sky",
                stats: Optional[torch.Tensor] = None,
                shadows: Optional[torch.Tensor] = None,
                cull: bool = True, live: Optional[int] = None
                ) -> torch.Tensor:
    """Advance every lane of ``state`` (16, L) one bounce -> a new state
    (``bounce_step_pallas``, :1838).

    ``it`` is the bounce's step (the salt's counter), ``seed`` the
    chunk's seed, ``tables`` the scene's :class:`Tables` (its ``lit``
    picks the lit instance); ``cull`` False makes the triangles
    two-sided (``bounce_step_pallas(cull=False)``, :1848).  Counters,
    int64 on the state's device: ``stats`` (3,) gets the bounce's box
    tests, triangle tests (the shadow rays' included) and live lanes
    added to it, ``shadows`` (1,) its NEE shadow rays.  A CUDA state
    launches ``csrc/flat_bounce.cu``; a CPU state runs
    :func:`bounce_step_reference`; any other device raises.

    ``live``: the number of live lanes in ``state``, where the caller
    has counted them (``wavefront.trace_lanes`` does, once a bounce).  At
    most ``WARP_MAX_LIVE`` picks the kernel's warp form; without a count
    the thread form runs.  Both give the same state and counters."""
    _check(state, tables, stats, shadows, live)
    if state.device.type == "cpu":
        return bounce_step_reference(state, it, seed, max_depth, tables,
                                     background=background, stats=stats,
                                     shadows=shadows, cull=cull)
    tris = tables.tris
    warp = live is not None and live <= WARP_MAX_LIVE
    use_sky, (bgr, bgg, bgb) = background_args(background)
    out = torch.empty_like(state)
    lib = _lib()
    err = lib.rtow_flat_bounce(
        tables.sph.data_ptr(), tables.sph.shape[0], tris.tbl.data_ptr(),
        tris.boxes.data_ptr(), tris.supers.data_ptr(), tris.hypers.data_ptr(),
        tris.n_blocks, tris.n_super, tris.n_hyper, tris.block, tris.count,
        int(cull), state.data_ptr(), out.data_ptr(), state.shape[1],
        step_salt(seed, it), int(max_depth), int(use_sky), bgr, bgg, bgb,
        None if stats is None else stats.data_ptr(),
        None if shadows is None else shadows.data_ptr(),
        *lit_args(tables.lit, tables.sph), int(warp),
        *_cuda.device_args(state))
    _cuda.check_launch(lib, err, "flat bounce")
    bounce_step.launches += 1
    bounce_step.lit_launches += tables.lit.any
    bounce_step.warp_launches += warp
    return out


#: Kernel launches made by :func:`bounce_step` in this process, those of
#: them that ran a lit instance, and those that ran the warp form.
bounce_step.launches = 0
bounce_step.lit_launches = 0
bounce_step.warp_launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/flat_bounce.cu``, built at first use, with its C entry point
    declared."""
    lib = _cuda.load("flat_bounce")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.rtow_flat_bounce.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p,
                                     p, i, u, i, i, f, f, f, p, p, p, i, i,
                                     i, i, i, i, i, i, i, i, p]
    lib.rtow_flat_bounce.restype = i
    return lib
