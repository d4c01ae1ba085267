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

``bounce_step`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel ``csrc/flat_bounce.cu`` (counting the launch in
``bounce_step.launches``), on a CPU tensor it runs
:func:`bounce_step_reference`, and on anything else it raises.

K3 has the sphere, triangle, sky and three-material bounce only: lights,
textures, media and roulette on a large mesh raise (:func:`check_scene`)
until its lit features are ported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from ..models.scene import EMISSIVE
from . import _cuda
from .megakernel import (
    TriTable, background_args, check_counter, check_table, check_tris,
    draw_scatter, lane_hash, nearest_sphere, nearest_triangle, shade,
    step_salt, winners,
)

#: Rows of the packed lane state.
STATE_ROWS = 16
_ALIVE, _BOUNCE, _LANE = 13, 14, 15

_F32 = torch.float32


class Tables(NamedTuple):
    """The scene tables of a bounce: the (Npad, 16) sphere table (Npad
    may be 0) and the triangle table with its hierarchy."""
    sph: torch.Tensor
    tris: TriTable


def check_scene(scene, roulette: bool = False) -> None:
    """Raise ``NotImplementedError`` if ``scene`` (or ``roulette``) needs
    a feature K3 does not have: emission and NEE, textures, media,
    Russian roulette."""
    kinds = scene.materials.kind
    needs = [name for name, on in (
        ("lights", scene.has_emissive or bool((kinds == EMISSIVE).any())),
        ("textures", scene.has_checker or bool((kinds > EMISSIVE).any())),
        ("media", bool(scene.volume_kinds)),
        ("Russian roulette", roulette)) if on]
    if needs:
        raise NotImplementedError(
            f"{', '.join(needs)} on meshes of over 16,384 triangles need "
            f"K3's lit features (ROADMAP Queue 1 item 9)")


def _check(state: torch.Tensor, tables: Tables, stats) -> None:
    check_table(tables.sph, "flat bounce")
    check_tris(tables.tris, tables.sph, "flat bounce")
    if (state.dtype != _F32 or state.dim() != 2
            or state.shape[0] != STATE_ROWS or not state.is_contiguous()
            or state.device != tables.sph.device):
        raise ValueError("state must be a contiguous (16, L) float32 tensor "
                         "on the tables' device")
    if state.shape[1] >= 1 << 24:
        raise ValueError("lane ids must stay exact in float32 (L < 2**24)")
    check_counter(stats, 3, tables.sph, "stats")


def bounce_step_reference(state: torch.Tensor, it: int, seed: int,
                          max_depth: int, tables: Tables, *,
                          background: Union[str, tuple] = "sky",
                          stats: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of K3: a new (16, L) state.  Same inputs and
    outputs as :func:`bounce_step`."""
    out = state.clone()
    live = torch.nonzero(state[_ALIVE] > 0).flatten()
    tally = [0, 0]
    if live.numel():
        cont = state[:13, live]
        ox, oy, oz, dx, dy, dz, tm = cont[:7]
        a = dx * dx + dy * dy + dz * dz
        best_t, best_k = nearest_sphere(tables.sph, ox, oy, oz, dx, dy, dz,
                                        tm, a, 1.0 / a)
        best_t, best_k = nearest_triangle(
            tables.tris, ox, oy, oz, dx, dy, dz, best_t, best_k,
            tables.sph.shape[0], tally=tally)
        w, tri = winners(tables.sph, tables.tris, best_t, best_k)
        lane = lane_hash(state[_LANE, live].long())
        new, can, bounce = shade(
            tuple(cont.unbind(0)), w, draw_scatter(lane, step_salt(seed, it)),
            best_t, torch.ones_like(best_t, dtype=torch.bool),
            state[_BOUNCE, live].to(torch.int32), max_depth, background,
            tri=tri)
        out[:13, live] = torch.stack(new)
        out[_ALIVE, live] = can.to(_F32)
        out[_BOUNCE, live] = bounce.to(_F32)
    if stats is not None:
        stats += torch.tensor(tally + [live.numel()], device=state.device)
    return out


def bounce_step(state: torch.Tensor, it: int, seed: int, max_depth: int,
                tables: Tables, *, background: Union[str, tuple] = "sky",
                stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Advance every lane of ``state`` (16, L) one bounce -> a new state
    (``bounce_step_pallas``, :1838).

    ``it`` is the bounce's step (the salt's counter), ``seed`` the
    chunk's seed, ``tables`` the scene's :class:`Tables`.  ``stats``, a
    (3,) int64 tensor on the state's device, gets the bounce's box tests,
    triangle tests and live lanes added to it.  A CUDA state launches
    ``csrc/flat_bounce.cu``; a CPU state runs
    :func:`bounce_step_reference`; any other device raises."""
    _check(state, tables, stats)
    if state.device.type == "cpu":
        return bounce_step_reference(state, it, seed, max_depth, tables,
                                     background=background, stats=stats)
    tris = tables.tris
    use_sky, (bgr, bgg, bgb) = background_args(background)
    out = torch.empty_like(state)
    lib = _lib()
    err = lib.rtow_flat_bounce(
        tables.sph.data_ptr(), tables.sph.shape[0], tris.tbl.data_ptr(),
        tris.boxes.data_ptr(), tris.supers.data_ptr(), tris.hypers.data_ptr(),
        tris.n_blocks, tris.n_super, tris.n_hyper, tris.block, tris.count,
        state.data_ptr(), out.data_ptr(), state.shape[1],
        step_salt(seed, it), int(max_depth), int(use_sky), bgr, bgg, bgb,
        None if stats is None else stats.data_ptr(),
        *_cuda.device_args(state))
    _cuda.check_launch(lib, err, "flat bounce")
    bounce_step.launches += 1
    return out


#: Kernel launches made by :func:`bounce_step` in this process.
bounce_step.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/flat_bounce.cu``, built at first use, with its C entry point
    declared."""
    lib = _cuda.load("flat_bounce")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.rtow_flat_bounce.argtypes = [p, i, p, p, p, p, i, i, i, i, i, p, p, i,
                                     u, i, i, f, f, f, p, i, p]
    lib.rtow_flat_bounce.restype = i
    return lib
