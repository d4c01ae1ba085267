"""Times the sorted wavefront's bounce kernel K3 on the card.

    python -m rtow_tpu_torch.time_k3 [--runs 5]

Traces the centre chunk of bench.py's 65k knot (``tools/make_mesh.py``'s
``make_knot(256, 128)``, 262,144 lanes at 400x400, 64 samples per pixel,
depth 20: the mesh leg) through ``trace_lanes``, keeping each launch's
input state, then issues the chunk's launches back to back between two
CUDA events: once to warm up, then ``--runs`` times.  Prints one JSON
line: the card, nvcc's register and spill report for
``csrc/flat_bounce.cu`` (when this process built it), the times in ms and
their median.  It calls only what every version of the sorted wavefront
has had, so a copy of this file in another checkout's package times that
checkout's K3: run it from two checkouts on one card, one after the other
and back, to compare two versions of the kernel.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WIDTH, SPP, DEPTH = 400, 64, 20


def main(argv=None) -> None:
    import torch

    from .config import Config
    from .models.camera import camera_rays, make_camera, pixel_coords
    from .models.scene import SceneBuilder
    from .ops import _cuda
    from .ops import flat_bounce as fb
    from .ops import wavefront as wf

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=5)
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k3: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    build = _cuda.build("flat_bounce")
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from make_mesh import make_knot

    verts, faces = make_knot(256, 128)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    scene = b.build(device=dev)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    cfg = Config(image_width=WIDTH, aspect_ratio=1.0, samples_per_pixel=SPP,
                 max_child_rays=DEPTH)
    ppc, _ = wf.chunk_plan(cfg)
    perm = torch.from_numpy(wf._morton_pixel_perm(WIDTH, WIDTH)
                            .astype("int64")).to(dev)
    g = int((perm == WIDTH // 2 * WIDTH + WIDTH // 2).nonzero()) // ppc
    seed = cfg.seed + g * 7919  # render_wavefront's chunk salt
    tables, bmin, inv_ext = wf.scene_tables(scene)
    gen = wf.chunk_generator(dev, cfg.seed, g)
    pix = perm[g * ppc:(g + 1) * ppc].repeat_interleave(SPP)
    s, t = pixel_coords(WIDTH, WIDTH, gen, pix)
    tape = []
    wf.trace_lanes(wf.lane_state(camera_rays(cam, gen, s, t), pix.numel()),
                   seed, max_depth=DEPTH, tables=tables, bmin=bmin,
                   inv_ext=inv_ext, tape=tape)

    def chunk():
        for state, it in tape:
            fb.bounce_step(state, it, seed, DEPTH, tables)

    chunk()  # warm-up
    runs = []
    for _ in range(opts.runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chunk()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    print(json.dumps({"card": card, "ptxas": ptxas, "launches": len(tape),
                      "times": {"ms": runs,
                                "median_ms": statistics.median(runs)}}),
          flush=True)


if __name__ == "__main__":
    main()
