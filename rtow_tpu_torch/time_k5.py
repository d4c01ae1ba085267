"""Times the backward bounce kernel K5 on the gradient trainers' launches.

    python -m rtow_tpu_torch.time_k5 [--runs 3] [--knot 4k|65k|360k] [--lit]
    python -m rtow_tpu_torch.time_k5 [--runs 3] --scene cornell|smoke|smoke-nee|cover ...

The knot tape: the input states of one forward at the mesh trainer's
size (256x256, 16 samples per pixel, depth 8: 1,048,576 lanes) through
K4 on bench.py's knot (``tools/make_mesh.make_knot``), with ``--lit``
under two square lamps on black with NEE, sorted where the trainer sorts
them (meshes of more than 16,384 triangles: the 65k and 360k knots, not
the 4,096-triangle one).  The scene tapes
(``--scene``, one or more): the unsorted input states of one forward
through K4 at the lit and media trainers' size (400x400, 16 samples per
pixel, depth 8: 2,560,000 lanes) on the Cornell box with NEE
(``cornell``), the smoke box without NEE (``smoke``) and with it
(``smoke-nee``), and the sphere trainer's cover at 400x267 (``cover``,
the sphere instance), given to the kernels as the trainers give them.
Each of a tape's 9 K5
launches is timed alone by CUDA events (``--runs`` calls after a warm-up, their mean), beside its
live lanes, then the 9 together (median of ``--runs``); on a knot, where the
checkout's K5 has forms (``grad.WARP_MAX_LIVE``), in each form
("thread", "warp", "auto": the one the card picks), in turns, each forced
through that cut-over; on a scene as the card picks it.  Prints one JSON
line per tape: the card and, per form, the per-launch and total
milliseconds; where the checkout's K5 counts its NEE adjoints
(``nee_stats``), beside them each launch's NEE adjoints from volume
events, the warps whose one NEE pass served a volume event and a surface
hit, the warps that ran NEE's adjoint at all (from K4's alive codes 2 of
the launch's lanes) and the merged share of those.  It calls only what
every checkout since K5's triangle instances has, so a copy of this file
in another checkout's package times that K5: run both in one chip call,
in turns, to compare two versions.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

KNOTS = {"4k": (64, 32), "65k": (256, 128), "360k": (600, 300)}
SIZE, SPP, DEPTH = 256, 16, 8
#: --scene: (builder in models/builders.py, aspect ratio, NEE).
SCENES = {"cornell": ("cornell_scene", 1.0, True),
          "smoke": ("smoke_scene", 1.0, False),
          "smoke-nee": ("smoke_scene", 1.0, True),
          "cover": ("cover_scene", 1.5, False)}
W_SCENE = 400


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
    """(sphere table, triangle table, [(cont, ints)] of each bounce) of a
    knot, as render_rays_kernel hands them to each bounce (sorted where
    it sorts them)."""
    import torch

    from .models.camera import camera_rays, make_camera, pixel_coords
    from .ops import grad as G
    from .ops import tables as tb

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
                                 max_depth=DEPTH, seed=0, nee=lit)
    finally:
        G.bounce_grad = bounce
    tbl, _ = tb.build_sphere_table(scene)
    return tbl, tb.grad_tri_table(scene), tape


def tapes(opts, dev):
    """{name: (tbl, tris, tape, lit, background)} of the tapes asked for:
    the knot's, or each --scene's (unsorted, chained through K4)."""
    import importlib

    import torch

    from .config import Config
    from .models.camera import camera_rays, pixel_coords
    from .ops import bounce as bn
    from .ops import grad as G
    from .ops import tables as tb

    if not opts.scene:
        scene = _scene(opts.knot, opts.lit, dev)
        name = f"{'lit ' if opts.lit else ''}{opts.knot} knot"
        return {name: (*_tape(scene, opts.lit, dev),
                       tb.scene_lit(scene, nee=opts.lit), scene.background)}
    builders = importlib.import_module(f"{__package__}.models.builders")
    out = {}
    for name in opts.scene:
        fn, aspect, nee = SCENES[name]
        if fn == "cover_scene":
            scene, cam = builders.cover_scene(
                Config(image_width=W_SCENE, aspect_ratio=aspect), device=dev)
        else:
            scene, cam = getattr(builders, fn)(aspect, device=dev)
        height = int(round(W_SCENE / aspect))
        lit = tb.scene_lit(scene, nee=nee)
        tbl, _ = tb.build_sphere_table(scene)
        tris = tb.grad_tri_table(scene) if scene.n_triangles else None
        gen = torch.Generator(dev).manual_seed(7)
        pix = torch.arange(W_SCENE * height,
                           device=dev).repeat_interleave(SPP)
        s, t = pixel_coords(W_SCENE, height, gen, pix)
        cont, ints = bn.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                                   dev)
        tape = []
        for it in range(DEPTH + 1):
            tape.append((cont, ints))
            cont, ints = G.bounce_fwd(cont, ints, tbl, tris, it=it, seed=0,
                                      max_depth=DEPTH, lit=lit,
                                      background=scene.background)
        out[name] = (tbl, tris, tape, lit, scene.background)
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def event_ms(torch, fn, n):
    """Mean ms of ``n`` calls of ``fn`` after one to warm up, between two
    CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_forms(torch, G, kernel, tape, forms, runs):
    """({form: [ms of each launch alone]}, {form: {runs, median}} of the 9
    together): ``kernel(it)`` issues launch ``it``, in each of ``forms``
    in turns (forced through ``G.WARP_MAX_LIVE``; None: the checkout's
    one form)."""
    cut = getattr(G, "WARP_MAX_LIVE", None)

    def call(it, form):
        if form is not None:
            G.WARP_MAX_LIVE = {"thread": -1, "warp": 1 << 30, "auto": cut}[
                form]
        return kernel(it)

    per = {str(f): [] for f in forms}
    total = {str(f): [] for f in forms}
    try:
        for it in range(len(tape)):
            for f in forms:
                per[str(f)].append(event_ms(torch, lambda: call(it, f), runs))
        for _ in range(runs):
            for f in forms:
                total[str(f)].append(event_ms(
                    torch, lambda: [call(it, f) for it in range(len(tape))],
                    1))
    finally:
        if cut is not None:
            G.WARP_MAX_LIVE = cut
    return per, {f: {"runs": v, "median": statistics.median(v)}
                 for f, v in total.items()}


def nee_counts(torch, G, kernel, tape, fwd):
    """Per launch of ``tape``: [NEE adjoints from volume events, warps
    whose one NEE pass served both kinds] (``kernel(it, nee_stats)``) and
    the warps of 32 lanes whose lanes ran NEE (``fwd(it)``'s alive codes
    2: a diffuse or volume scatter under NEE)."""
    stats, warps = [], []
    for it in range(len(tape)):
        ns = torch.zeros(2, dtype=torch.int64, device=tape[0][0].device)
        kernel(it, ns)
        nee = fwd(it)[1][0] == 2
        nee = torch.nn.functional.pad(nee, (0, -nee.numel() % 32))
        stats.append(ns.tolist())
        warps.append(int(nee.view(-1, 32).any(dim=1).sum()))
    return stats, warps


def main(argv=None) -> None:
    import numpy as np
    import torch

    from .ops import grad as G

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--knot", choices=sorted(KNOTS), default="65k")
    p.add_argument("--lit", action="store_true")
    p.add_argument("--scene", nargs="+", choices=sorted(SCENES))
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k5: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name_card = card()
    has_forms = getattr(G, "WARP_MAX_LIVE", None) is not None
    counted = "nee_stats" in inspect.signature(G.bounce_bwd).parameters
    for name, (tbl, tris, tape, lit, bg) in tapes(opts, dev).items():
        rng = np.random.default_rng(1)
        cots = [torch.from_numpy(rng.standard_normal(tuple(c.shape))
                                 .astype(np.float32)).to(dev)
                for c, _ in tape]
        forms = (("thread", "warp", "auto") if has_forms and not opts.scene
                 else (None,))

        def kernel(it, **kw):
            c, i = tape[it]
            return G.bounce_bwd(c, i, cots[it], tbl, tris, it=it, seed=0,
                                max_depth=DEPTH, lit=lit, background=bg,
                                **kw)

        per, total = time_forms(torch, G, kernel, tape, forms, opts.runs)
        line = {"card": name_card, "kernel": "K5", "tape": name,
                "lanes": tape[0][0].shape[1],
                "live": [int((i[0] > 0).sum()) for _, i in tape],
                "per_launch_ms": per, "total_ms": total}
        if counted:
            stats, warps = nee_counts(
                torch, G, lambda it, ns: kernel(it, nee_stats=ns), tape,
                lambda it: G.bounce_fwd(*tape[it], tbl, tris, it=it, seed=0,
                                        max_depth=DEPTH, lit=lit,
                                        background=bg))
            line.update(nee_stats=stats, nee_warps=warps, merged_share=[
                s[1] / w if w else 0.0 for s, w in zip(stats, warps)])
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
