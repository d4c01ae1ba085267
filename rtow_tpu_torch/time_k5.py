"""Times the backward bounce kernel K5 on the mesh trainer's launches.

    python -m rtow_tpu_torch.time_k5 [--runs 3] [--knot 65k|360k] [--lit]

The tape: the sorted input states of one forward at the mesh trainer's
size (256x256, 16 samples per pixel, depth 8: 1,048,576 lanes) through
K4 on bench.py's knot (``tools/make_mesh.make_knot``), with ``--lit``
under two square lamps on black with NEE.  Each of its 9 K5 launches is
timed alone by CUDA events (``--runs`` calls after a warm-up, their
mean), beside its live lanes, then the 9 together (median of
``--runs``); where the checkout's K5 has forms (``grad.WARP_MAX_LIVE``),
in each form ("thread", "warp", "auto": the one the card picks), in
turns, each forced through that cut-over.  Prints one
JSON line: the card and, per form, the per-launch and total
milliseconds.  It calls only what every checkout since K5's triangle
instances has, so a copy of this file in another checkout's package
times that K5: run both in one chip call, in turns, to compare two
versions.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

KNOTS = {"65k": (256, 128), "360k": (600, 300)}
SIZE, SPP, DEPTH = 256, 16, 8


def _scene(knot: str, lit: bool, dev):
    from .models.scene import SceneBuilder

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tools"))
    from make_mesh import make_knot

    verts, faces = make_knot(*KNOTS[knot])
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    if lit:
        lamp = b.add_light((4.0, 4.0, 4.0))
        b.add_quad((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0.5, 1.5, 0.5),
                   (-0.5, 1.5, 0.5), lamp)
        b.add_quad((1.5, -0.5, -0.5), (1.5, -0.5, 0.5), (1.5, 0.5, 0.5),
                   (1.5, 0.5, -0.5), lamp)
    return b.build(background=(0.0, 0.0, 0.0) if lit else "sky", device=dev)


def _tape(scene, lit: bool, dev):
    """(sphere table, triangle table, [(cont, ints)] of each bounce)."""
    import torch

    from .models.camera import camera_rays, make_camera, pixel_coords
    from .ops import grad as G
    from .ops import megakernel as mk

    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    gen = torch.Generator(dev).manual_seed(7)
    pix = torch.arange(SIZE * SIZE, device=dev).repeat_interleave(SPP)
    s, t = pixel_coords(SIZE, SIZE, gen, pix)
    tape, bounce = [], G.bounce_grad

    def recorded(cont, ints, *a, **k):
        tape.append((cont, ints))
        return bounce(cont, ints, *a, **k)

    G.bounce_grad = recorded
    try:
        with torch.no_grad():
            G.render_rays_kernel(scene, camera_rays(cam, gen, s, t),
                                 n_pixels=pix.numel(), spp=1,
                                 max_depth=DEPTH, seed=0, sort_lanes=True,
                                 nee=lit)
    finally:
        G.bounce_grad = bounce
    tbl, _ = mk.build_sphere_table(scene)
    return tbl, G.grad_tri_table(scene), tape


def main(argv=None) -> None:
    import numpy as np
    import torch

    from .ops import grad as G

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--knot", choices=sorted(KNOTS), default="65k")
    p.add_argument("--lit", action="store_true")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k5: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    scene = _scene(opts.knot, opts.lit, dev)
    tbl, tris, tape = _tape(scene, opts.lit, dev)
    lit = G.grad_lit(scene, opts.lit)
    rng = np.random.default_rng(1)
    cots = [torch.from_numpy(rng.standard_normal(tuple(c.shape))
                             .astype(np.float32)).to(dev) for c, _ in tape]
    cut = getattr(G, "WARP_MAX_LIVE", None)
    forms = ((None,) if cut is None else ("thread", "warp", "auto"))

    def call(it, form):
        c, i = tape[it]
        if form is not None:
            G.WARP_MAX_LIVE = {"thread": -1, "warp": 1 << 30, "auto": cut}[
                form]
        return G.bounce_bwd(c, i, cots[it], tbl, tris, it=it, seed=0,
                            max_depth=DEPTH, lit=lit)

    def ms(fn, n):
        fn()  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    live = [int((i[0] > 0).sum()) for _, i in tape]
    per = {str(f): [] for f in forms}
    for it in range(len(tape)):
        for f in forms:
            per[str(f)].append(ms(lambda: call(it, f), opts.runs))
    total = {str(f): [] for f in forms}
    for _ in range(opts.runs):
        for f in forms:
            total[str(f)].append(ms(lambda: [call(it, f)
                                             for it in range(len(tape))], 1))
    if cut is not None:
        G.WARP_MAX_LIVE = cut
    print(json.dumps({"card": card, "knot": opts.knot, "lit": opts.lit,
                      "lanes": tape[0][0].shape[1], "live": live,
                      "per_launch_ms": per,
                      "total_ms": {f: {"runs": v,
                                       "median": statistics.median(v)}
                                   for f, v in total.items()}}), flush=True)


if __name__ == "__main__":
    main()
