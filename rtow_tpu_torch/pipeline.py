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
import threading
import time as _time
from typing import Optional

import numpy as np
import torch

from .config import Config
from .models.camera import Camera
from .models.scene import Scene
from .ops.megakernel import progress_counter, render_blocks, unblock_image
from .ops.tables import (
    LANES, WAVEFRONT_MIN_TRIS, check_kernel_scene, k1_tables, n_tiles_for,
    pack_camera, pack_meta, scene_lit,
)
from .ops.wavefront import render_wavefront
from .utils.profiling import RenderStats, span, trace_profile


def _sync(device: torch.device, site: str) -> None:
    """Wait for the card, inside the span ``rtow.sync.<site>``."""
    if device.type == "cuda":
        with span(f"rtow.sync.{site}"):
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

    The frame is one launch.  With ``progress`` the host prints the
    reference's scanlines-remaining ticker (src/render.cpp:154) while it
    runs: on a card, K1's blocks add their finished tile rows to a counter
    in mapped host memory (:class:`~.ops.megakernel.ProgressCounter`),
    which a host thread reads about every ``TICK_S`` seconds, printing
    each new count, until the launch's event completes; on the CPU the plain
    version renders the frame and the ticker prints 0.  The scheduler is
    the work pool, the JAX package's production default."""
    width, height = cfg.image_width, cfg.image_height
    spp = cfg.samples_per_pixel
    if seed is None:
        seed = cfg.seed
    device = scene.device

    with span("rtow.render.tables"):
        _sync(device, "frame_start")
        t0 = _time.perf_counter()
        tbl, tris = k1_tables(scene)
        lit = scene_lit(scene, nee=scene.has_emissive,
                        roulette=cfg.russian_roulette)
        cam = pack_camera(camera)
        meta = pack_meta(seed, width=width, height=height, spp=spp,
                         max_depth=cfg.max_child_rays)
        counter = None
        if progress and device.type == "cuda":
            counter = progress_counter(torch.cuda.current_device()
                                       if device.index is None
                                       else device.index)
            counter.reset()
    with span("rtow.render.k1"):
        r, g, b = render_blocks(tbl, cam, meta, n_tiles_for(width, height),
                                background=scene.background, tris=tris,
                                lit=lit, progress=counter)
        if progress:
            _ticker(counter, device, width, height)
    with span("rtow.render.readback"):
        rad = unblock_image(r, g, b, width=width, height=height)
        _sync(device, "frame_end")
        elapsed = _time.perf_counter() - t0
        if progress:
            stats = RenderStats(elapsed, width * height, spp,
                                cfg.max_child_rays, backend=device.type)
            print(stats.summary(), file=sys.stderr)
        with span("rtow.sync.readback"):
            rad = rad.cpu()
        # The float64 cast and the divide in one pass into one array: two
        # passes, each into a fresh array, cost the host twice the time
        # and most of a frame's jitter (the same values either way).
        img = np.empty((height, width, 3), np.float64)
        np.divide(rad.numpy().reshape(height, width, 3), spp, out=img,
                  dtype=np.float64)
        return img


#: Seconds between the ticker's reads of the progress counter.
TICK_S = 0.05


def _ticker(counter, device, width: int, height: int) -> None:
    """Prints ``Scanlines remaining: N`` on stderr whenever N changes while
    the launch before it runs (N from ``counter``'s finished tile rows;
    none on the CPU, where the frame is already done), then 0 and a
    newline once the card has finished.  A thread reads the counter every
    ``TICK_S`` seconds while this one waits for the launch's event, so the
    wait ends when the launch does, not at the next tick."""
    if counter is not None:
        tiles_x = -(-width // LANES)
        stop = threading.Event()

        def tick():
            shown = None
            while True:
                left = max(height - counter.value // tiles_x, 1)
                if left != shown:
                    print(f"\rScanlines remaining: {left}   ", end="",
                          file=sys.stderr, flush=True)
                    shown = left
                if stop.wait(TICK_S):
                    return

        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        reader = threading.Thread(target=tick, daemon=True)
        reader.start()
        try:
            with span("rtow.sync.ticker"):
                done.synchronize()
        finally:
            stop.set()
            reader.join()
    print("\rScanlines remaining: 0   ", file=sys.stderr, flush=True)


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
    raise.  ``cfg.profile_dir`` (``--profile-dir``) traces the render
    into a Chrome trace there (``utils/profiling.trace_profile``), its
    spans included: ``rtow.render.frame`` around the frame, and within it
    ``rtow.render.tables`` (here the image-texture check), then K1's
    ``rtow.render.tables``, ``rtow.render.k1`` and
    ``rtow.render.readback`` or the wavefront's spans."""
    if (cfg.n_devices > 1 and scene.device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "--devices > 1 on a host with several cards needs multi-device "
            "rendering (ROADMAP Queue 1 item 11)")
    if cfg.backend == "jnp":
        raise NotImplementedError(
            "--backend jnp needs the reference integrator "
            "(ROADMAP Queue 1 item 5)")
    with trace_profile(cfg.profile_dir), span("rtow.render.frame"):
        with span("rtow.render.tables"):
            with span("rtow.sync.image_check"):
                check_kernel_scene(scene)
        if wavefront_supported(scene):
            return render_wavefront(scene, camera, cfg, progress=progress)
        if megakernel_supported(scene):
            return render_megakernel(scene, camera, cfg, progress=progress)
    raise ValueError("scene has no primitives")
