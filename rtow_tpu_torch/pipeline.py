"""Render dispatch (the port of ``rtow_tpu.pipeline``).

Two backends, each on the scene's device (the CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors), picked as the JAX
package picks them (``pipeline.py:39-71``): sphere scenes and meshes of
up to 16,384 triangles go through the persistent megakernel K1
(ops/megakernel.py), larger meshes through the sorted-wavefront loop and
its bounce kernel K3 (ops/wavefront.py, ops/flat_bounce.py); both with
emission, next-event estimation, textures, media and Russian roulette.
Everything else the JAX package can render raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import sys
import time as _time
from typing import Optional

import numpy as np
import torch

from .config import Config
from .models.camera import Camera
from .models.scene import IMAGE, Scene
from .ops.megakernel import (
    LANES, TILE_ROWS, n_tiles_for, pack_camera, pack_meta, render_blocks,
    scene_k1_tables, scene_lit, unblock_image,
)
from .ops.wavefront import WAVEFRONT_MIN_TRIS, render_wavefront
from .utils.profiling import RenderStats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_megakernel(
    scene: Scene,
    camera: Camera,
    cfg: Config,
    seed: Optional[int] = None,
    progress: bool = False,
) -> np.ndarray:
    """Whole-frame render through the megakernel -> (H, W, 3) float64
    mean radiance (``rtow_tpu.pipeline.render_pallas``, :124).

    With ``progress`` the frame is issued as 10 sequential tile bands
    with a carriage-return ticker between them (the reference's
    scanlines-remaining ticker, src/render.cpp:154); each band is one
    launch over a contiguous tile range."""
    width, height = cfg.image_width, cfg.image_height
    spp = cfg.samples_per_pixel
    if seed is None:
        seed = cfg.seed
    device = scene.device
    tiles_x = -(-width // LANES)
    tiles_total = n_tiles_for(width, height)

    _sync(device)
    t0 = _time.perf_counter()
    tbl, tris = scene_k1_tables(scene)
    lit = scene_lit(scene, cfg.russian_roulette)
    cam = pack_camera(camera)
    if progress and tiles_total >= 20:
        n_bands = 10
        band_tiles = -(-tiles_total // n_bands)
        parts = []
        for band in range(n_bands):
            meta = pack_meta(seed, width=width, height=height, spp=spp,
                             max_depth=cfg.max_child_rays,
                             tile0=band * band_tiles)
            parts.append(render_blocks(tbl, cam, meta, band_tiles,
                                       background=scene.background,
                                       tris=tris, lit=lit))
            _sync(device)
            rows_done = min((band + 1) * band_tiles * TILE_ROWS // tiles_x,
                            height)
            print(f"\rScanlines remaining: {height - rows_done}   ",
                  end="" if rows_done < height else "\n",
                  file=sys.stderr, flush=True)
        rows = tiles_total * TILE_ROWS
        r, g, b = (torch.cat([p[c] for p in parts])[:rows] for c in range(3))
    else:
        meta = pack_meta(seed, width=width, height=height, spp=spp,
                         max_depth=cfg.max_child_rays)
        r, g, b = render_blocks(tbl, cam, meta, tiles_total,
                                background=scene.background, tris=tris,
                                lit=lit)
    rad = unblock_image(r, g, b, width=width, height=height)
    _sync(device)
    elapsed = _time.perf_counter() - t0
    if progress:
        stats = RenderStats(elapsed, width * height, spp, cfg.max_child_rays,
                            backend=device.type)
        print(stats.summary(), file=sys.stderr)
    return rad.cpu().numpy().astype(np.float64).reshape(height, width, 3) / spp


def megakernel_supported(scene: Scene) -> bool:
    """K1 renders sphere scenes and meshes of up to 16,384 triangles
    (``pallas_supported``, :39)."""
    return 0 < scene.n_primitives and scene.n_triangles <= WAVEFRONT_MIN_TRIS


def wavefront_supported(scene: Scene) -> bool:
    """Larger meshes take the sorted-wavefront loop and K3
    (``wavefront_supported``, :56)."""
    return scene.n_triangles > WAVEFRONT_MIN_TRIS


def render_auto(
    scene: Scene,
    camera: Camera,
    cfg: Config,
    progress: bool = False,
) -> np.ndarray:
    """Render with the backend the config and scene call for, on the
    scene's device (``rtow_tpu.pipeline.render_auto``, :194).

    Only single-device renders through the kernels are ported: ``-t N``
    renders on one device where fewer than two are there to shard over (a
    CPU scene, or a host with one card), as the JAX package does
    (``pipeline.py:219``), and raises where two or more cards are.
    Meshes over 16,384 triangles take the sorted wavefront, lit or not;
    the reference integrator's cases (``--backend jnp``, image textures)
    and ``--profile-dir`` raise."""
    if (cfg.n_devices > 1 and scene.device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "--devices > 1 on a host with several cards needs multi-device "
            "rendering (ROADMAP Queue 1 item 11)")
    if cfg.backend == "jnp":
        raise NotImplementedError(
            "--backend jnp needs the reference integrator "
            "(ROADMAP Queue 1 item 5)")
    if cfg.profile_dir:
        raise NotImplementedError(
            "--profile-dir needs the port's profiler traces "
            "(ROADMAP Queue 1 item 12)")
    if bool((scene.materials.kind == IMAGE).any()):
        raise NotImplementedError(
            "image textures need the reference integrator "
            "(ROADMAP Queue 1 item 5)")
    if wavefront_supported(scene):
        return render_wavefront(scene, camera, cfg, progress=progress)
    if megakernel_supported(scene):
        return render_megakernel(scene, camera, cfg, progress=progress)
    raise ValueError("scene has no primitives")
