"""Times the sorted wavefront's bounce kernel K3 on the card, its two forms
in turns.

    python -m rtow_tpu_torch.time_k3 [--runs 5] [--knot 65k|360k]

Traces the centre chunk of one of bench.py's knots (``tools/make_mesh.py``'s
``make_knot(256, 128)``, 65,536 triangles, or ``make_knot(600, 300)``,
360,000; 262,144 lanes at 400x400, 64 samples per pixel, depth 20: the
mesh leg) through ``trace_lanes``, keeping each launch's input state and
live-lane count, then issues the chunk's launches back to back between
two CUDA events in each of K3's forms: ``thread`` (one thread per lane),
``warp`` (one warp per live lane) and ``picked`` (the form
``bounce_step`` picks from the live count, as the render path runs it),
once each to warm up, then ``--runs`` rounds, the forms in turns.  Then
times each launch alone in both forms, in turns (thread, warp, warp,
thread).  Prints one JSON line: the card, nvcc's register and spill report
for ``csrc/flat_bounce.cu`` (when this process built it), the cut-over,
the chunk's times in ms per form with their medians, and per launch its
live lanes and its two times in each form.

It calls only what every version of the sorted wavefront has had, and
times a version without the warp form as its one form, ``kernel``: so a
copy of this file in another checkout's package times that checkout's K3.
Run it from two checkouts on one card, one after the other and back, to
compare two versions of the kernel.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WIDTH, SPP, DEPTH = 400, 64, 20
KNOTS = {"65k": (256, 128), "360k": (600, 300)}


def main(argv=None) -> None:
    import torch

    from .config import Config
    from .models.camera import camera_rays, make_camera, pixel_coords
    from .models.scene import SceneBuilder
    from .ops import _cuda
    from .ops import flat_bounce as fb
    from .ops import tables as tb
    from .ops import wavefront as wf

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--knot", choices=sorted(KNOTS), default="65k")
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

    verts, faces = make_knot(*KNOTS[opts.knot])
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
    tables, bmin, inv_ext = tb.k3_tables(scene)
    gen = wf.chunk_generator(dev, cfg.seed, g)
    pix = perm[g * ppc:(g + 1) * ppc].repeat_interleave(SPP)
    s, t = pixel_coords(WIDTH, WIDTH, gen, pix)
    tape = []
    wf.trace_lanes(wf.packed_state(camera_rays(cam, gen, s, t), pix.numel()),
                   seed, max_depth=DEPTH, tables=tables, bmin=bmin,
                   inv_ext=inv_ext, tape=tape)
    lives = [int((state[13] > 0).sum()) for state, _ in tape]

    cut = getattr(fb, "WARP_MAX_LIVE", None)
    forms = ("kernel",) if cut is None else ("thread", "warp", "picked")

    def launch(form, i):
        state, it = tape[i]
        if form in ("kernel", "thread"):
            return fb.bounce_step(state, it, seed, DEPTH, tables)
        fb.WARP_MAX_LIVE = 1 << 30 if form == "warp" else cut
        try:
            return fb.bounce_step(state, it, seed, DEPTH, tables,
                                  live=lives[i])
        finally:
            fb.WARP_MAX_LIVE = cut

    def timed(form, launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in launches:
            launch(form, i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    every = range(len(tape))
    for form in forms:
        timed(form, every)  # warm-up
    runs = {form: [] for form in forms}
    for _ in range(opts.runs):
        for form in forms:
            runs[form].append(timed(form, every))
    per_launch = []
    for i in every:
        order = forms[:2] + forms[1::-1] if cut is not None else forms * 2
        ms = {form: [] for form in order}
        for form in order:
            ms[form].append(timed(form, [i]))
        per_launch.append({"live": lives[i], **{f"{form}_ms": v
                                                 for form, v in ms.items()}})
    print(json.dumps({
        "card": card, "ptxas": ptxas, "knot": opts.knot,
        "launches": len(tape), "warp_max_live": cut,
        "times": {form: {"ms": v, "median_ms": statistics.median(v)}
                  for form, v in runs.items()},
        "per_launch": per_launch}), flush=True)


if __name__ == "__main__":
    main()
