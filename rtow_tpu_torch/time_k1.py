"""Times whole-frame launches of the megakernel K1 on the card.

    python -m rtow_tpu_torch.time_k1 [--runs 5] [--pool {0,1}] [--spp 16]
        [scene ...]

Scenes: ``cover`` (the plain instance), and the lit instances' ``cornell``,
``smoke``, ``lights`` and ``textures`` at 400x400, spp 16, depth 8, and
``checker`` and ``roulette`` (the cover) at 1200x675, spp 16, depth 50;
by default all of them (``--spp`` sets the samples per pixel).
``--pool 0`` times the classic scheduler, ``--pool 1`` the work pool
(16-sample items handed out every 4 iterations, ``render_blocks``'
defaults); by default both, in turns, so one call compares the two (at
spp 16 each lane's one item holds its pixel's every sample: the pool
renders the classic image and the A/B shows its cost alone).  Each scene and
scheduler is launched once to warm up and once with the stats counters
(ray steps and lane slots: their ratio is the occupancy; the sphere
groups' box tests and rows swept), then ``--runs`` times, each timed
alone by CUDA events.
Prints one JSON line: the card, nvcc's register and spill report for
``csrc/megakernel.cu`` (when this process built it), and per scene the
times in ms and their median, keyed by scheduler.  Run it from two
checkouts on one card, one after the other and back, to compare two
versions of the kernel.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

SCENES = ("cover", "cornell", "smoke", "lights", "textures", "checker",
          "roulette")


def _frame_args(name: str, dev, spp: int = 16):
    from .config import Config
    from .models import builders as B
    from .ops import megakernel as mk
    from .ops import tables as tb

    if name in ("cornell", "smoke", "lights", "textures"):
        build = {"cornell": B.cornell_scene, "smoke": B.smoke_scene,
                 "lights": B.light_scene, "textures": B.textures_scene}[name]
        (scene, cam), width, height, depth = build(1.0, device=dev), 400, 400, 8
    else:
        width, height, depth = 1200, 675, 50
        scene, cam = B.cover_scene(Config(image_width=width,
                                          aspect_ratio=16.0 / 9.0,
                                          checker_ground=name == "checker"),
                                   device=dev)
    tbl, tris = tb.k1_tables(scene)
    args = (tbl, tb.pack_camera(cam),
            tb.pack_meta(0, width=width, height=height, spp=spp,
                         max_depth=depth),
            tb.n_tiles_for(width, height))
    kw = dict(background=scene.background, tris=tris,
              lit=tb.scene_lit(scene, nee=scene.has_emissive,
                               roulette=name == "roulette"))
    return args, kw


def main(argv=None) -> None:
    import torch

    from .ops import _cuda
    from .ops import megakernel as mk

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--pool", type=int, choices=(0, 1), default=None,
                   help="0 the classic scheduler, 1 the work pool "
                        "(default: both, in turns)")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("scenes", nargs="*", metavar="scene",
                   help=f"one of {', '.join(SCENES)} (default: all)")
    opts = p.parse_args(argv)
    bad = set(opts.scenes) - set(SCENES)
    if bad:
        p.error(f"unknown scenes {sorted(bad)}; choose from {SCENES}")
    if not torch.cuda.is_available():
        raise SystemExit("time_k1: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    build = _cuda.build("megakernel")
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    pools = {0: ("classic",), 1: ("pool",), None: ("classic", "pool")}[
        opts.pool]
    times = {}
    for name in opts.scenes or SCENES:
        args, kw = _frame_args(name, dev, opts.spp)
        runs, counts = {s: [] for s in pools}, {}
        for s in pools:
            mk.render_blocks(*args, **kw, pool=s == "pool")  # warm-up
            c = {n: torch.zeros(k, dtype=torch.int64, device=dev)
                 for n, k in (("steps", 1), ("slots", 1), ("spheres", 2))}
            if not hasattr(mk, "sphere_groups"):  # a checkout without the cull
                del c["spheres"]
            mk.render_blocks(*args, **kw, pool=s == "pool", **c)
            counts[s] = {n: t.tolist() for n, t in c.items()}
        for _ in range(opts.runs):
            for s in pools:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                mk.render_blocks(*args, **kw, pool=s == "pool")
                end.record()
                torch.cuda.synchronize()
                runs[s].append(start.elapsed_time(end))
        times[name] = {s: {"ms": runs[s],
                           "median_ms": statistics.median(runs[s]),
                           **counts[s],
                           "occupancy": (counts[s]["steps"][0]
                                         / counts[s]["slots"][0])}
                       for s in pools}
    print(json.dumps({"card": card, "ptxas": ptxas, "times": times}),
          flush=True)


if __name__ == "__main__":
    main()
