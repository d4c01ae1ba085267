"""The sorted-wavefront mesh renderer (the port of
``rtow_tpu/ops/wavefront_sorted.py``): the path for meshes of more than
16,384 triangles.

One lane is one (pixel, sample) path, and all lanes of a chunk of pixels
advance one bounce at a time.  The rays' state lives in one packed
(16, L) float32 tensor (``ops/flat_bounce.py``).  Before every bounce
the lanes are sorted by a spatial key (the origin's Morton code on a
fixed scene grid, interleaved with the direction's, dead lanes last) and
the state is gathered into that order; then K3 (``bounce_step``)
advances every lane.  A shrinking window follows the live lanes: once
they fit in a window 8x narrower, the loop runs on the head of the
sorted state alone.  After the last bounce a scatter by lane id puts
the radiance back in (pixel, sample) order.

Lit scenes (lights, textures, media) and renders with Russian roulette
take K3's lit instance: the scene's lit features ride in the tables
(``tables.k3_tables``), and the alive row keeps
its code {0, 1, 2} through the sort and the window (both test
``alive > 0``), so the next bounce knows a diffuse scatter came before
it.  ``cull_backfaces=False`` makes the triangles two-sided.

The image does not depend on the sort: every lane's random numbers are
the counter hash on its lane id and the bounce (``ops/flat_bounce.py``).
Camera rays come from a ``torch.Generator`` seeded per chunk
(``models/camera.py``), where the JAX package uses threefry, so a frame
agrees with the JAX package's statistically, not lane by lane.

Host costs: the window test reads the live-lane count each bounce (one
device-to-host sync per bounce), and each bounce is a few launches
around K3: the key kernel (``keys.sort_keys``, ``csrc/sort_keys.cu``), the
sort and the gather of the state.  The same count picks K3's form for
the bounce (``bounce_step``'s ``live``): the wide launches one thread
per lane, the drain's narrow ones one warp per live lane.
"""
from __future__ import annotations

import sys
import time as _time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..models.camera import Camera, camera_rays, pixel_coords
from ..models.scene import Scene
from ..utils.profiling import RenderStats, span
from .bounce import lane_state
from .flat_bounce import bounce_step
from .keys import sort_keys
from .tables import TILE, Tables, k3_tables

#: The chunk's seed stride (``seed + chunk * 7919``, as in JAX).
_CHUNK_SEED_STRIDE = 7919

_F32 = torch.float32


def _window_ladder(n: int) -> list:
    """Shrinking window widths [n, ~n/8, ~n/64, ...] down to one TILE
    (``_window_ladder``, :203)."""
    widths = [n]
    w = n
    while w // 8 >= TILE:
        w = -(-w // 8 // TILE) * TILE
        widths.append(w)
    return sorted(set(widths), reverse=True)


def _morton_pixel_perm(width: int, height: int) -> np.ndarray:
    """Pixel ids in Morton (z-) order over (row, col), so a chunk covers a
    compact image tile (``_morton_pixel_perm``, :617)."""
    rows = np.arange(height, dtype=np.uint32)[:, None]
    cols = np.arange(width, dtype=np.uint32)[None, :]

    def spread(x):  # interleave 16 bits with one zero bit each
        x = (x | (x << 8)) & np.uint32(0x00FF00FF)
        x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
        x = (x | (x << 2)) & np.uint32(0x33333333)
        x = (x | (x << 1)) & np.uint32(0x55555555)
        return x

    code = (spread(cols) | (spread(rows) << 1)).ravel()
    return np.argsort(code).astype(np.int32)


def _sorted(state, bmin, inv_ext):
    with span("rtow.wavefront.sort"):
        perm = torch.sort(sort_keys(state, state[13], bmin, inv_ext),
                          stable=True).indices
        return state.index_select(1, perm)


def _live_count(win) -> int:
    """The window's live lanes, read on the host."""
    with span("rtow.sync.live_count"):
        return int((win[13] > 0).sum())


def packed_state(rays, n_lanes: int) -> torch.Tensor:
    """The packed (16, L) state of ``n_lanes`` camera rays
    (``_trace_lane_per_sample``, :256-269): ``bounce.lane_state`` (L a
    whole number of TILEs, camera lanes at alive code 1, padding lanes
    dead) with its alive, bounce and lane-id rows as float32."""
    cont, ints = lane_state(rays, n_lanes, rays.origin.device)
    return torch.cat([cont, ints.to(_F32)])


def trace_lanes(state: torch.Tensor, seed: int, *, max_depth: int,
                tables: Tables, bmin: torch.Tensor, inv_ext: torch.Tensor,
                background="sky", cull: bool = True,
                stats: Optional[torch.Tensor] = None,
                shadows: Optional[torch.Tensor] = None,
                tape: Optional[list] = None,
                windows: Optional[list] = None,
                level_its: Optional[list] = None) -> torch.Tensor:
    """Run the sorted bounce loop on a packed state until every lane is
    dead -> the final state, in sorted order (``_trace_lane_per_sample``'s
    loop, :282-391).  ``stats``, ``shadows``, ``cull``: see
    ``bounce_step``.  ``tape``, a list, gets each bounce's (input state,
    step) appended (the inputs K3 was given).  ``windows``, a list of
    three ints, gets each bounce's window tiles, live lanes and live
    tiles added to it, and ``level_its`` the step count after each
    window level appended (JAX's ``acc[3:6]`` and ``level_its``,
    :304-321, :384)."""
    widths = _window_ladder(state.shape[1])
    it = 0
    for i, w in enumerate(widths):
        nxt = widths[i + 1] if i + 1 < len(widths) else 0
        if w != state.shape[1]:
            state = _sorted(state, bmin, inv_ext)
        win, rest = state[:, :w], state[:, w:]
        # The one host sync per bounce (and one opening each window): the
        # live count picks the window, and K3's form.
        n_live = _live_count(win)
        while n_live > 0 and n_live > nxt:
            with span("rtow.wavefront.bounce"):
                win = _sorted(win, bmin, inv_ext)
                if tape is not None:
                    tape.append((win, it))
                if windows is not None:
                    live_tiles = (win[13] > 0).view(-1, TILE).any(
                        dim=1).sum()
                    for j, n in enumerate((w // TILE, n_live,
                                           int(live_tiles))):
                        windows[j] += n
                win = bounce_step(win, it, seed, max_depth, tables,
                                  background=background, stats=stats,
                                  shadows=shadows, cull=cull, live=n_live)
                it += 1
                n_live = _live_count(win)
        state = torch.cat([win, rest], dim=1) if rest.shape[1] else win
        if level_its is not None:
            level_its.append(it)
    return state


def trace_wavefront_sorted(tables: Tables, camera: Camera,
                           gen: torch.Generator, pixel_ids: torch.Tensor,
                           seed: int, *, spp: int, max_depth: int,
                           width: int, height: int, bmin: torch.Tensor,
                           inv_ext: torch.Tensor, background="sky",
                           cull_backfaces: bool = True,
                           stats: Union[bool, torch.Tensor, None] = None,
                           shadows: Optional[torch.Tensor] = None):
    """Radiance sums of a chunk of pixels -> (P, 3)
    (``trace_wavefront_sorted``, :404), one lane per sample.

    ``gen`` draws the camera rays; ``seed`` salts the bounces' counter
    hash; ``tables`` carries the lit features (``tables.k3_tables``);
    ``cull_backfaces`` False makes the triangles two-sided.  ``stats``:
    a (3,) counter (see ``bounce_step``, as ``shadows``), or True for
    JAX's triple (rad, acc, level_its) (:304-321): ``acc`` a (6,) int64
    tensor whose ``acc[3:6]`` are JAX's (window tiles, live lanes and
    live 1,024-lane tiles, summed over the bounces) and ``acc[0:3]`` the
    port's own box tests, triangle tests and shadow rays (JAX counts
    block sweeps per TPU tile there, which per-thread traversal has no
    counterpart of); ``level_its`` the step count after each window
    level.  The regenerating layout (fewer lanes than samples per pixel)
    is not ported."""
    n_pix = pixel_ids.numel()
    lane_pix = pixel_ids.repeat_interleave(spp)
    s, t = pixel_coords(width, height, gen, lane_pix)
    state = packed_state(camera_rays(camera, gen, s, t), lane_pix.numel())
    triple = stats is True
    windows, level_its = ([0, 0, 0], []) if triple else (None, None)
    if triple:
        dev = state.device
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        shadows = torch.zeros(1, dtype=torch.int64, device=dev)
    final = trace_lanes(state, seed, max_depth=max_depth, tables=tables,
                        bmin=bmin, inv_ext=inv_ext, background=background,
                        cull=cull_backfaces, stats=stats, shadows=shadows,
                        windows=windows, level_its=level_its)
    # Back to (pixel, sample) order: a scatter by lane id.
    rad = torch.empty((3, final.shape[1]), dtype=_F32, device=final.device)
    rad[:, final[15].long()] = final[10:13]
    rad = rad[:, :lane_pix.numel()].reshape(3, n_pix, spp).sum(dim=2).T
    if not triple:
        return rad
    acc = torch.cat([stats[:2], shadows,
                     torch.tensor(windows, device=stats.device)])
    return rad, acc, torch.tensor(level_its)


def chunk_plan(cfg: Config) -> Tuple[int, int]:
    """(pixels per chunk, chunks) of a frame: ``rays_per_batch // spp``
    pixels a chunk, at least one TILE of lanes (:742-745)."""
    n_pixels = cfg.image_width * cfg.image_height
    spp = cfg.samples_per_pixel
    ppc = min(max(cfg.rays_per_batch // spp, 1), n_pixels)
    ppc = max(ppc, -(-TILE // spp))
    return ppc, -(-n_pixels // ppc)


def chunk_generator(device, seed: int, chunk: int) -> torch.Generator:
    """The camera rays' generator of chunk ``chunk`` of a frame."""
    return torch.Generator(device).manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | chunk)


def render_wavefront(scene: Scene, camera: Camera, cfg: Config,
                     progress: bool = False, cull_backfaces: bool = True,
                     stats: Optional[torch.Tensor] = None,
                     shadows: Optional[torch.Tensor] = None) -> np.ndarray:
    """Whole-frame mean radiance (H, W, 3) float64 through the sorted
    path, on the scene's device (``render_wavefront``, :699), with the
    scene's lit features and ``cfg.russian_roulette``.

    Chunks of ``ppc`` pixels in Morton order, chunk ``g`` salted with
    ``cfg.seed + g * 7919``.  With ``progress`` a scanline ticker is
    printed after each chunk.  ``cull_backfaces`` False makes the
    triangles two-sided.  ``stats``, ``shadows``: see ``bounce_step``."""
    width, height = cfg.image_width, cfg.image_height
    spp = cfg.samples_per_pixel
    n_pixels = width * height
    device = scene.device
    ppc, n_chunks = chunk_plan(cfg)

    with span("rtow.wavefront.tables"):
        if device.type == "cuda":
            with span("rtow.sync.frame_start"):
                torch.cuda.synchronize(device)
        t0 = _time.perf_counter()
        tables, bmin, inv_ext = k3_tables(scene, cfg.russian_roulette)
        perm = np.full((n_chunks * ppc,), n_pixels, np.int64)
        perm[:n_pixels] = _morton_pixel_perm(width, height)
        with span("rtow.sync.pixel_perm"):
            perm_t = torch.from_numpy(perm).to(device)
        fb = torch.zeros((n_chunks * ppc, 3), dtype=_F32, device=device)
    for g in range(n_chunks):
        with span("rtow.wavefront.chunk"):
            pixel_ids = perm_t[g * ppc:(g + 1) * ppc]
            sums = trace_wavefront_sorted(
                tables, camera, chunk_generator(device, cfg.seed, g),
                pixel_ids.clamp(max=n_pixels - 1),
                cfg.seed + g * _CHUNK_SEED_STRIDE, spp=spp,
                max_depth=cfg.max_child_rays, width=width, height=height,
                bmin=bmin, inv_ext=inv_ext, background=scene.background,
                cull_backfaces=cull_backfaces, stats=stats, shadows=shadows)
            fb[g * ppc:(g + 1) * ppc] = torch.where(
                (pixel_ids < n_pixels)[:, None], sums, 0.0)
        if progress:
            done = min((g + 1) * ppc // width, height)
            print(f"\rScanlines remaining: {height - done}   ",
                  end="" if done < height else "\n", file=sys.stderr,
                  flush=True)
    img = torch.zeros((n_pixels, 3), dtype=_F32, device=device)
    valid = perm_t < n_pixels
    with span("rtow.sync.frame_scatter"):  # a mask's size, read back
        img[perm_t[valid]] = fb[valid]
    with span("rtow.sync.readback"):
        img = img.cpu().numpy()
    elapsed = _time.perf_counter() - t0
    if progress:
        print(RenderStats(elapsed, n_pixels, spp, cfg.max_child_rays,
                          backend=f"{device.type}-sorted").summary(),
              file=sys.stderr)
    return img.astype(np.float64).reshape(height, width, 3) / spp
