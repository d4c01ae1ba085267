#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtow_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rtow_tpu_torch/csrc`` with
nvcc (one process per source, started together), holds each against its
plain PyTorch version on the card, and drives the port's three paths:
the render (the cover through ``rtow_tpu_torch.cli.main`` at 1200x675,
128 samples per pixel, depth 50; kernel K1, one launch a frame with the
scanline ticker, every K1 frame held bit for bit with equal counters
against its plain version), the trainer (three SGD
steps of the cover's albedos at 400x267, 16 samples per pixel, depth 8,
the JAX package's bench grad leg; kernels K4 and K5) and the mesh path
(``cli.main -l`` on the 65,536-triangle knot at 400x400, 64 samples per
pixel, depth 20, through the sorted wavefront and K3, and on
``samples/knot_small.obj`` through K1; then bench.py's two knots timed
through ``render_wavefront``) and the light-driven path (K1's lit
instances against their plain version on the five lit scenes, then
``cli.main --cornell``, ``--smoke``, ``--lights`` and ``--textures`` at
400x400, 512 samples per pixel, depth 8, and ``--checker`` and
``--russian-roulette`` on the cover at the render's size, the latter
held against the unbiased render; a middle tenth of each of these
renders' tiles is launched again with ``cli.main``'s inputs and held bit
for bit against the plain version) and mesh inverse rendering (K4's and
K5's triangle instances against their plain versions on the 4,096- and
65,536-triangle knots, flat and down the hierarchy, K5 as picked and in
its warp form; three
``diff.build_train_step`` steps on the 65k knot at 256x256, 16 samples
per pixel, depth 8, with the lanes sorted; the forward and
forward+backward times of both bench knots; each K4 and K5 launch timed
alone, K5's thread and warp forms in turns and held to each other) and
lit inverse rendering
(K4's and K5's lit instances against their plain versions on the Cornell
box and ``light_scene`` with NEE, ``textures_scene`` and the checker
cover; three ``diff.build_train_step(nee=True)`` steps on the Cornell box
at 400x400, 16 samples per pixel, depth 8, the lamp's emission and the
walls' albedo; the forward and forward+backward times) and inverse
rendering through media (K4's and K5's media against their plain
versions on the smoke box with and without NEE, a fog ball under a
sphere light and a fog box under the sky; three
``diff.build_train_step(nee=True)`` steps of the smoke box's densities
and albedos at 400x400, 16 samples per pixel, depth 8; the forward and
forward+backward times) and lit meshes over 16,384 triangles (K3's lit
instance against its plain version at every launch of the centre chunk
of the 65k knot under two square lamps and of the 65k knot with roulette
under the sky; the lit knot at 400x400, 64 samples per pixel, depth 8,
through ``render_wavefront``, and ``cli.main -l <65k knot> --russian-
roulette``; K1 and K3 with two-sided triangles on a knot wound away from
the camera) and the JAX package's production scheduler, K1's work pool
(the render through ``cli.main`` runs it by default and under
``RTOW_POOL=0`` the classic scheduler; the pool instances against the
plain pool on every K1 instance, bit for bit with equal counters; exact
sample accounting at 1200x675; pool against classic as one estimator;
the two schedulers' A/B with their occupancy on the cover, the Cornell
box and ``knot_small``) and the probes T1 (``python -m
rtow_tpu_torch.tools.mxu_probe``: the sphere sweep's CUDA-core and
tensor-core forms) and T2 (``python -m
rtow_tpu_torch.tools.repro_nb_slice``: a block-by-block table sum, against
its plain version and ``torch.sum``).  Every phase
prints one line; any failed check raises and the script exits non-zero.  The
line before the card line is the kernels' JSON summary; the last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, when no CUDA device is usable or
when the ``rtow_tpu_torch`` package is not beside this script.  The
rendered PPM is written to a temporary directory, read back, and
removed.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

W_MAIN, H_MAIN = 1200, 675
ASPECT = 16.0 / 9.0
# K1 against its plain version on the card: both round every float32
# operation alike (-fmad=false, IEEE division and sqrt) and use the same
# CUDA math library, so every K1 frame is held bit for bit, with equal
# counters (k1_held).

#: The trainer: bench.py's grad leg (bench.py:249-261).
W_GRAD, H_GRAD, SPP_GRAD, DEPTH_GRAD = 400, 267, 16, 8
#: SGD step on the albedos (the loss is a mean over 106,800 pixels, so
#: one material's gradient is small), and the albedo perturbation.
LR = 10.0
PERTURB = 0.15
#: K5 against its plain version (autograd): both replay the same sweep and
#: decisions, but the adjoint is summed in another order than autograd's,
#: and the table gradient with atomics in an order that changes from run
#: to run.  Allowed, per cot_in row and per g_tbl column: max |d| at most
#: GRAD_TOL of the row's / column's max |plain|, and at most GRAD_SHARE of
#: the entries off by more than 1e-4 |plain| + 1e-6 max |plain|.
GRAD_TOL = 1e-3
GRAD_SHARE = 1e-3
#: The light rows' cotangent (R x 14 entries, each summed over every lane;
#: see check_rows): an entry's scale is its float64 sum |E| where that is
#: at least ROWS_CANCEL of its sum of |terms| S, else ROWS_CANCEL S, and at
#: least ROWS_FLOOR of the largest S.
ROWS_CANCEL = 0.1
ROWS_FLOOR = 1e-3

#: Roofline of one H100 SXM (NVIDIA's data sheet): float32 outside the
#: tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
#: float32 operations of the triangle sweep (a lower bound, from
#: csrc/bounce.cuh): a box test (6 subtractions, 6 products, 10 min/max,
#: the compare: 23) and a triangle test's unconditional part (the normal:
#: 9, the determinant: 5, the cull: 1); a lane's step adds the ray's three
#: inverse directions.
OPS_PER_BOX = 23
OPS_PER_TRI = 15
OPS_INV_DIR = 3

#: Mesh inverse rendering: the JAX package's mesh-gradient leg
#: (README.md:311-324: 256x256, spp 16, depth 8; the knots of KNOTS), its
#: learning rate for the knot's one material.
W_MESH_GRAD = 256
LR_MESH = 3.0
#: Lit inverse rendering: the JAX package's Cornell demo's step for the
#: walls' albedo (tools/inverse_demo.py:165-169), for every albedo row.
LR_LIT = 30.0
#: Media inverse rendering: one SGD rate for the smoke box's densities and
#: albedos (the densities' gradients are ~40x the albedos': measured with
#: the plain versions at 40x40 spp4 on the CPU, the loss fell at 0.01-0.05).
LR_VOL = 0.02

#: The light-driven path: the Cornell box as BASELINE.md:336-343 measured
#: it (400 px, depth 8, NEE at 512 spp), the smoke box alike.
W_LIT, SPP_LIT, DEPTH_LIT = 400, 512, 8
#: Lower bounds of the float32 operations of the lit bounce, counted from
#: csrc/bounce.cuh: a light sample with its MIS weight (the sphere light's
#: cone sample, the cheaper of the two kinds: 60) and the contribution
#: (10) per shadow ray; per volume and step, a boundary interval and the
#: free flight (the sphere's, the cheaper kind: 25), and again per
#: shadow ray for the transmittance.  Textures are not counted.
OPS_NEE = 70
OPS_PER_VOL = 25
#: Roulette against the unbiased render: frame means within this many
#: standard errors of their difference.
RR_SIGMAS = 4.0

#: The mesh path: bench.py's knot legs (bench.py:162-188).
W_MESH, SPP_MESH, DEPTH_MESH = 400, 64, 20
KNOTS = {"65k": (256, 128), "360k": (600, 300)}
#: float32 operations the kernels do per lane-bounce (a lower bound, from
#: csrc/bounce.cuh): per table row of the sweep, the unconditional part
#: (the centre at tm: 6, oc: 3, h: 5, cc: 7, disc: 3, the test: 1); per
#: step, |d|^2 and 1/|d|^2 (6) plus the cheaper shade branch, the sky
#: (17); K5 adds the cheaper adjoint branch, the sky's (32).
OPS_PER_ROW = 25
OPS_PER_STEP = 6 + 17
OPS_BWD_EXTRA = 32


#: The pool against its plain version (phase 28): reduced frames with a
#: partial tile column (400 = 3 x 128 + 16, 300 = 2 x 128 + 44), and two
#: items per column (16 + 4 samples).
POOL_COVER, POOL_SQUARE, POOL_SPP = (400, 225), 300, 20

#: The lit knot (phases 25-27): bench.py's 65k knot lit only by two square
#: lamps of emission 4 on a black background, one 1.5 above the knot
#: facing down and one 1.5 to its right facing it (each 1 x 1, centred on
#: the knot's axis; the lamps of samples/knot_lit.png are not in the
#: repo), at the JAX package's showcase settings (README.md:312-316:
#: 400x400, 64 samples per pixel, depth 8), through render_wavefront.
DEPTH_KNOT_LIT = 8
#: Seconds the band checks of phase 17 may take together (100.5 s on an
#: H100 80GB HBM3 at 700 W).
BAND_S = 400
KNOT_LAMP_EMIT = 4.0


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def event_ms(torch, fn):
    """(milliseconds between CUDA events around ``fn()``, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def wall_ms(torch, fn):
    """Host milliseconds around ``fn()``, the card synchronised before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def kept_radiance():
    """Keeps the float radiance image that ``cli.main`` hands to the PPM
    writer: yields a list that the image is appended to."""
    from rtow_tpu_torch.utils import ppm

    kept, write = [], ppm.write_ppm

    def keep(f, image, *a, **k):
        kept.append(image)
        return write(f, image, *a, **k)

    ppm.write_ppm = keep
    try:
        yield kept
    finally:
        ppm.write_ppm = write


@contextlib.contextmanager
def pool_env(value):
    """``RTOW_POOL`` set to ``value`` (None: unset) inside the block, as a
    user sets it around ``python -m rtow_tpu_torch``."""
    old = os.environ.pop("RTOW_POOL", None)
    if value is not None:
        os.environ["RTOW_POOL"] = value
    try:
        yield
    finally:
        os.environ.pop("RTOW_POOL", None)
        if old is not None:
            os.environ["RTOW_POOL"] = old


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def running_children() -> list:
    """[pid and command line] of every child of this process that has not
    exited (zombies aside), as Linux's /proc lists them."""
    pids = set()
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids.update(f.read().split())
    left = []
    for pid in sorted(pids, key=int):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except FileNotFoundError:  # it ended meanwhile
            continue
        if state != "Z":
            left.append(f"{pid} {cmd.strip()}")
    return left


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import rtow_tpu_torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: rtow_tpu_torch not found beside "
                         f"this script ({e})") from e
    pkg_dir = os.path.dirname(os.path.abspath(rtow_tpu_torch.__file__))
    if pkg_dir != os.path.join(ROOT, "rtow_tpu_torch"):
        raise SystemExit(f"chip_smoke: imported rtow_tpu_torch from "
                         f"{pkg_dir}, not from beside this script")

    from rtow_tpu_torch import cli, pipeline
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models.builders import cover_scene, three_sphere_scene
    from rtow_tpu_torch.models.camera import make_camera
    from rtow_tpu_torch.models.scene import SceneBuilder
    from rtow_tpu_torch.ops import _cuda
    from rtow_tpu_torch.ops import megakernel as mk
    from rtow_tpu_torch.ptxas_report import entries as ptxas_entries
    from rtow_tpu_torch.utils.ppm import read_ppm

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- (0) card and toolchain ---------------------------------------
    card = card_line()
    print(card, flush=True)
    nvcc_ver = subprocess.run([_cuda.nvcc(), "--version"], capture_output=True,
                              text=True, check=True, timeout=60)
    say("0", f"card {card!r}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}, nvcc "
             f"{nvcc_ver.stdout.strip().splitlines()[-1]}")

    # ---- (1) build, all six sources at once ------------------------------
    t0 = time.perf_counter()
    builds = _cuda.build_all(["megakernel", "flat_bounce", "grad_fwd",
                              "grad_bwd", "mxu_probe", "nb_slice"])
    wall = time.perf_counter() - t0
    for name, build in builds.items():
        regs = [int(w) for line in build.log.splitlines() if "Used" in line
                for w in [line.split("Used ")[1].split()[0]]]
        spills = [int(line.split("bytes spill stores")[0].split(",")[-1])
                  for line in build.log.splitlines()
                  if "bytes spill stores" in line]
        report = (f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
                  f"registers, spill stores {min(spills)}-{max(spills)} B"
                  if regs and spills else "an existing build")
        say("1", f"nvcc build of csrc/{name}.cu: {build.seconds:.1f} s "
                 f"({report})")
    k3 = {}
    for entry, v in ptxas_entries(builds["flat_bounce"].log).items():
        warp, lit, two = re.search(r"flat_bounce(_warp)?ILb(\d)ELb(\d)E",
                                   entry).groups()
        k3[("warp " if warp else "") + ("lit" if lit == "1" else "unlit")
           + (" two-sided" if two == "1" else "")] = v
    say("1", "K3's instances (ptxas): " + "; ".join(
        f"{k} {regs} registers, {spill} B spilled"
        for k, (regs, spill, _) in sorted(k3.items())))
    k1 = {}
    for entry, v in ptxas_entries(builds["megakernel"].log).items():
        bits = re.search(r"megakernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                         entry).groups()
        k1[" ".join(w for w, b in zip(("triangles", "lit", "two-sided",
                                        "pool"), bits) if b == "1")
           or "spheres"] = v
    say("1", "K1's instances (ptxas): " + "; ".join(
        f"{k} {regs} registers, {spill} B spilled"
        for k, (regs, spill, _) in sorted(k1.items())))
    for name, label in (("grad_fwd", "K4"), ("grad_bwd", "K5")):
        inst = {}
        for entry, v in ptxas_entries(builds[name].log).items():
            # The warp forms: grad_fwd_warp / grad_bwd_warp<kLit>, their
            # triangles implied.
            warp, a, b = re.search(name + r"(_warp)?ILb(\d)E(?:Lb(\d)E)?",
                                   entry).groups()
            bits = ("1", a) if warp else (a, b)
            inst[("warp " if warp else "") + (" ".join(
                w for w, x in zip(("triangles", "lit"), bits) if x == "1")
                or "spheres")] = v
        say("1", f"{label}'s instances (ptxas): " + "; ".join(
            f"{k} {regs} registers, {spill} B spilled"
            for k, (regs, spill, _) in sorted(inst.items())))
    say("1", "the probes' kernels (ptxas): " + "; ".join(
        f"{k} {regs} registers, {spill} B spilled"
        for name in ("mxu_probe", "nb_slice")
        for k, (regs, spill, _) in ptxas_entries(builds[name].log).items()))
    say("1", f"six builds in parallel: {wall:.1f} s wall")

    def sphere_args(scene, cam, width, height, spp, depth):
        tbl, _ = mk.build_sphere_table(scene)
        return (tbl, mk.pack_camera(cam),
                mk.pack_meta(0, width=width, height=height, spp=spp,
                             max_depth=depth),
                mk.n_tiles_for(width, height))

    # ---- (2) kernel vs plain version on the card -----------------------
    three = three_sphere_scene(ASPECT, device=dev)
    cover = cover_scene(Config(image_width=400, aspect_ratio=ASPECT),
                        device=dev)
    lines2 = []
    for name, (scene, cam) in (("three_sphere", three), ("cover", cover)):
        k2, c2 = k1_held(torch, mk, dev, f"{name} 400x225",
                         sphere_args(scene, cam, 400, 225, 4, 50),
                         dict(background=scene.background, pool=False))
        lines2.append(f"{name} {c2}")
    kc = k2
    say("2", f"kernel vs plain (classic scheduler), 400x225 spp4 depth50: "
             f"bit-identical with equal counters ({K1_COUNTERS}): "
             + "; ".join(lines2))

    # ---- (3) exact sample accounting -------------------------------------
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device=dev)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    empty = b.build(background=(1.0, 1.0, 1.0), device=dev)
    for spp in (17, 24):
        sums = mk.render_spheres(empty, cam, 0, width=24, height=24,
                                 spp=spp, max_depth=4, pool=False)
        check(bool((sums == spp).all()), f"sample accounting spp {spp}")
    say("3", "exact sample accounting: every pixel's sums == spp at spp 17 "
             "and 24 (white background, empty scene)")

    # ---- (4) determinism -------------------------------------------------
    again = torch.stack(mk.render_blocks(
        *sphere_args(*cover, 400, 225, 4, 50), background=cover[0].background,
        pool=False))
    check(torch.equal(kc, again), "two kernel runs differ")
    say("4", "two kernel runs of the cover 400x225 are bit-identical")

    # ---- (5) the main path: cli.main at full size ----------------------
    # Under the JAX package's production scheduler (RTOW_POOL unset: the
    # work pool), then under RTOW_POOL=0 (the classic one); each run's
    # launches counted from 0.
    spp_main = 128
    runs5 = {}
    for label, env in (("pool", None), ("classic", "0")):
        log = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp, pool_env(env):
            ppm_path = os.path.join(tmp, "cover.ppm")
            mk.render_blocks.launches = mk.render_blocks.pool_launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(log), kept_radiance() as kept:
                rc = cli.main(["-w", str(W_MAIN), "-a", repr(ASPECT), "-s",
                               str(spp_main), "-c", "50", "-o", ppm_path])
            wall = time.perf_counter() - t0
            n = (mk.render_blocks.launches, mk.render_blocks.pool_launches)
            check(rc == 0, f"cli.main ({label}) returned {rc}")
            check(n[0] == 1 and n[1] == (n[0] if label == "pool" else 0),
                  f"cli.main ({label}): {n[0]} K1 launches ({n[1]} of them "
                  f"the pool), not one a frame")
            with open(ppm_path) as f:
                img = read_ppm(f)
        check(img.shape == (H_MAIN, W_MAIN, 3), f"PPM shape {img.shape}")
        check(img.min() >= 0 and img.max() <= 255 and img.std() > 10,
              "PPM values out of range or flat")
        top = img[:40].reshape(-1, 3).mean(axis=0)
        check(top[2] > top[0], f"top rows are not sky-blue (mean rgb {top})")
        stats = [ln for ln in log.getvalue().splitlines()
                 if ln.startswith("Done")]
        # The ticker from the one launch: each count the host read, then 0.
        ticks = [int(x) for x in re.findall(r"Scanlines remaining: (\d+)",
                                            log.getvalue())]
        check(len(ticks) >= 2 and ticks[-1] == 0 and 0 < ticks[0] <= H_MAIN
              and ticks == sorted(ticks, reverse=True),
              f"cli.main ({label}): the ticker printed {ticks}")
        runs5[label] = (n[0], wall, kept[0])
        say("5", f"cli.main -w {W_MAIN} -a {ASPECT!r} -s {spp_main} -c 50 "
                 f"({label} scheduler{'' if env is None else ', RTOW_POOL=0'}"
                 f"): {n[0]} launch, {n[1]} of them the pool; ticker "
                 f"{ticks[:-1]} then 0; {wall:.2f} s "
                 f"end to end ({W_MAIN * H_MAIN * spp_main / wall / 1e6:.2f} "
                 f"Mprimary-rays/s incl. scene build and PPM write); render: "
                 f"{stats[-1]}")
    launches, pool_launches = runs5["classic"][0], runs5["pool"][0]
    cover_radiance = runs5["pool"][2]
    # What the ticker costs the render: render_megakernel with and without
    # it, in turns (ticker, none, none, ticker), the same image bit for bit.
    cfg5 = Config(image_width=W_MAIN, aspect_ratio=ASPECT,
                  samples_per_pixel=spp_main, max_child_rays=50)
    scene5, cam5 = cover_scene(cfg5, device=dev)
    walls, imgs = {True: [], False: []}, {}
    for prog in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            imgs[prog] = pipeline.render_megakernel(scene5, cam5, cfg5,
                                                    progress=prog)
        walls[prog].append((time.perf_counter() - t0) * 1e3)
    check(bool((imgs[True] == imgs[False]).all()),
          "render_megakernel: the ticker's image differs from the render "
          "without it")
    tick_ms = statistics.mean(walls[True]) - statistics.mean(walls[False])
    say("5", f"render_megakernel on the cover {W_MAIN}x{H_MAIN} spp"
             f"{spp_main} d50 (pool) on {card}, ms in turns: with the ticker "
             f"{', '.join(f'{x:.2f}' for x in walls[True])}, without "
             f"{', '.join(f'{x:.2f}' for x in walls[False])}; the ticker "
             f"costs {tick_ms:.2f} ms; the same image bit for bit")

    # ---- (6) kernel and plain times at the main path's shape -----------
    # The classic scheduler, as every earlier PR timed it, then the pool.
    big = cover_scene(Config(image_width=W_MAIN, aspect_ratio=ASPECT),
                      device=dev)
    tbl, _ = mk.build_sphere_table(big[0])
    args = (tbl, mk.pack_camera(big[1]),
            mk.pack_meta(0, width=W_MAIN, height=H_MAIN, spp=16,
                         max_depth=50),
            mk.n_tiles_for(W_MAIN, H_MAIN))
    n_sph = big[0].n_spheres
    width_g = mk.SPHERE_GROUP

    def k1_counts(spp, pool):
        """K1_COUNTERS of a kernel launch at ``spp`` (not timed)."""
        c = [torch.zeros(n, dtype=torch.int64, device=dev)
             for n in (1, 2, 1, 1, 2)]
        mk.render_blocks(*args[:2], mk.pack_meta(0, width=W_MAIN,
                                                 height=H_MAIN, spp=spp,
                                                 max_depth=50),
                         args[3], steps=c[0], tests=c[1], shadows=c[2],
                         slots=c[3], spheres=c[4], pool=pool)
        return [int(x) for t in c for x in t.tolist()]

    def bound_line(c, ms):
        """The culled bound, the brute-force one, and the ground group's
        share of the rows swept, from counters ``c`` and a kernel time."""
        b, brute = (x / PEAK_F32 * 1e3 for x in (k1_ops(c),
                                                 k1_brute_ops(c, n_sph)))
        per_sweep = c[6] / (c[0] + c[3])
        ground = width_g * (c[0] + c[3]) / c[6]
        return b, (f"bound {b:.2f} ms = {b / ms:.1%} of {ms:.2f} ms "
                   f"(float32 ops {OPS_PER_STEP + OPS_INV_DIR} per step + "
                   f"{OPS_PER_BOX} x {c[5]} group boxes + {OPS_PER_ROW} x "
                   f"{c[6]} rows swept, {per_sweep:.1f} rows a sweep of "
                   f"{tbl.shape[0]}; the ground sphere's group of "
                   f"{width_g} rows at most {ground:.1%} of them), "
                   f"brute-force bound {brute:.2f} ms = {brute / ms:.1%}")

    meta128 = mk.pack_meta(0, width=W_MAIN, height=H_MAIN, spp=spp_main,
                           max_depth=50)
    k1_rows = {}
    for label, pool in (("classic", False), ("pool", True)):
        def timed(fn):
            return event_ms(torch, lambda: fn(*args, pool=pool))

        timed(mk.render_blocks)  # warm-up
        runs = [timed(mk.render_blocks) for _ in range(3)]
        kernel_ms = statistics.median(ms for ms, _ in runs)
        times = []
        _, c16 = k1_held(torch, mk, dev, f"cover {W_MAIN}x{H_MAIN} "
                         f"({label})", args, dict(pool=pool), times)
        plain_ms = times[1]
        k1_bound, line16 = bound_line(c16, kernel_ms)
        say("6", f"cover {W_MAIN}x{H_MAIN} spp16 depth50, {label} "
                 f"scheduler, sphere groups of {width_g} rows, on {card}: "
                 f"kernel {kernel_ms:.2f} ms (median of 3: "
                 f"{', '.join(f'{ms:.2f}' for ms, _ in runs)}), plain "
                 f"{plain_ms:.2f} ms; kernel vs plain bit-identical with "
                 f"equal counters ({K1_COUNTERS}) {c16}; {line16}")
        ms128 = statistics.median(
            event_ms(torch, lambda: mk.render_blocks(
                *args[:2], meta128, args[3], pool=pool))[0]
            for _ in range(3))
        c128 = k1_counts(spp_main, pool)
        say("6", f"K1 ({label}) spp{spp_main}, one whole-frame launch "
                 f"(median of 3): {ms128:.2f} ms; ray steps {c128[0]}, lane "
                 f"slots {c128[4]} (occupancy {c128[0] / c128[4]:.1%}); "
                 + bound_line(c128, ms128)[1])
        k1_rows[label] = dict(ms=kernel_ms, plain_ms=plain_ms, err=0.0,
                              bound=k1_bound)

    grad = grad_phases(torch, dev, card, say)
    mesh = mesh_phases(torch, dev, card, say, event_ms)
    lit = lit_phases(torch, dev, card, say, event_ms, cover_radiance)
    mesh_grad = mesh_grad_phases(torch, dev, card, say, event_ms)
    lit_grad = lit_grad_phases(torch, dev, card, say, event_ms)
    vol_grad = vol_grad_phases(torch, dev, card, say, event_ms)
    lit_mesh = lit_mesh_phases(torch, dev, card, say, event_ms)

    pool = pool_phases(torch, dev, card, say, event_ms)
    tools = tool_phases(torch, dev, card, say, event_ms)

    k1_entries = [{
        "name": name,
        "route": "cuda",
        "source": "rtow_tpu_torch/csrc/megakernel.cu",
        "replaces": replaces,
        "launches": n,
        "max_abs_err": max(k1_rows[label]["err"], extra_err),
        "ms": k1_rows[label]["ms"],
        "plain_ms": k1_rows[label]["plain_ms"],
        "bound_ms": k1_rows[label]["bound"],
        "bound_by": "operations",
        "library_ms": None,
    } for name, label, replaces, n, extra_err in (
        ("megakernel", "classic", "rtow_tpu/ops/pallas_megakernel.py:1433",
         launches, 0.0),
        ("megakernel_pool", "pool", "rtow_tpu/ops/pallas_megakernel.py:1492",
         pool_launches, pool["max_abs_err"]))]
    # ---- (32) every process this script started has ended --------------
    left = running_children()
    check(not left, f"processes started by this script still run: {left}")
    say("32", "no process started by this script is still running (nvcc, "
              "nvidia-smi and phase 17's workers all waited for)")

    print(json.dumps({"kernels": k1_entries + mesh + [lit] + lit_mesh
                      + grad + mesh_grad + lit_grad + vol_grad + tools}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def grad_phases(torch, dev, card, say):
    """Phases 7-9: K4 and K5 against their plain versions, the trainer
    at full size, and a profile of its step.  Returns the kernels' JSON
    entries."""
    import numpy as np

    from rtow_tpu_torch import diff
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models.builders import cover_scene
    from rtow_tpu_torch.models.camera import camera_rays, pixel_coords
    from rtow_tpu_torch.ops import grad as G
    from rtow_tpu_torch.ops import megakernel as mk

    rng = np.random.default_rng(0)

    def lanes_of(cam, width, height, spp, seed):
        """The first bounce's state, as render_pixels_kernel builds it."""
        gen = torch.Generator(dev).manual_seed(seed)
        pix = torch.arange(width * height, device=dev).repeat_interleave(spp)
        s, t = pixel_coords(width, height, gen, pix)
        return G.lane_state(camera_rays(cam, gen, s, t), pix.numel(), dev)

    def forward_tape(tbl, cont, ints, depth, seed, fn):
        """The (depth + 1) input states of one forward through ``fn``."""
        tape = []
        for it in range(depth + 1):
            tape.append((cont, ints))
            cont, ints = fn(cont, ints, tbl, it=it, seed=seed,
                            max_depth=depth)
        return tape, (cont, ints)

    # ---- (7) K4 and K5 against their plain versions, a reduced forward ---
    small = cover_scene(Config(image_width=64, aspect_ratio=1.0), device=dev)
    tbl_s, _ = mk.build_sphere_table(small[0])
    c0, i0 = lanes_of(small[1], 64, 64, 4, seed=1)
    tape_k, (ck, ik) = forward_tape(tbl_s, c0, i0, DEPTH_GRAD, 5,
                                    G.bounce_fwd)
    tape_p, (cp, ip) = forward_tape(tbl_s, c0, i0, DEPTH_GRAD, 5,
                                    G.bounce_fwd_reference)
    for it, ((a, ai), (b, bi)) in enumerate(zip(tape_k[1:] + [(ck, ik)],
                                                tape_p[1:] + [(cp, ip)])):
        check(torch.equal(a, b) and torch.equal(ai, bi),
              f"K4 vs plain, bounce {it}: not bit-identical (max |d| "
              f"{float((a - b).abs().max())})")
    worst7 = []
    for it, (cont, ints) in enumerate(tape_k):
        cot = torch.from_numpy(rng.standard_normal(
            (13, cont.shape[1])).astype(np.float32)).to(dev)
        kw = dict(it=it, seed=5, max_depth=DEPTH_GRAD)
        res = check_k5(torch, G.bounce_bwd(cont, ints, cot, tbl_s, **kw),
                       G.bounce_bwd_reference(cont, ints, cot, tbl_s, **kw),
                       f"cover 64x64 spp4, bounce {it}")
        worst7.append(res)
    say("7", f"cover 64x64 spp4 depth {DEPTH_GRAD} ({c0.shape[1]} lanes): "
             f"K4 and its plain version bit-identical at all "
             f"{DEPTH_GRAD + 1} bounces; K5 vs plain, worst over the "
             f"bounces: cot_in max |d| "
             f"{max(w['cot_in'][0] for w in worst7):.3g} "
             f"({max(w['cot_in'][1] for w in worst7):.3g} of its row's max), "
             f"g_tbl max |d| {max(w['g_tbl'][0] for w in worst7):.3g} "
             f"({max(w['g_tbl'][1] for w in worst7):.3g} of its column's "
             f"max); shares off "
             f"{max(v[2] for w in worst7 for v in w.values()):.3g} "
             f"(allowed {GRAD_TOL} of max, share {GRAD_SHARE})")

    # ---- (8) the trainer at full size: the cover at 400x267 spp16 d8 -----
    cfg = Config(image_width=W_GRAD, aspect_ratio=1.5)
    scene, cam = cover_scene(cfg)  # Config's device: the card
    check(scene.device.type == "cuda", "cover_scene(Config()) is not on "
                                       "the card")
    kw = dict(width=W_GRAD, height=H_GRAD, spp=SPP_GRAD,
              max_depth=DEPTH_GRAD)
    pix = torch.arange(W_GRAD * H_GRAD, device=dev)
    with torch.no_grad():
        target = G.render_pixels_kernel(
            scene, cam, torch.Generator(dev).manual_seed(123), pix, **kw)
    albedo = scene.materials.albedo
    noise = torch.from_numpy(rng.uniform(-PERTURB, PERTURB, albedo.shape)
                             .astype(np.float32)).to(dev)
    start = scene.replace_leaves(
        {"materials.albedo": (albedo + noise).clamp(0.0, 1.0)})
    step = diff.build_train_step(cam, lr=LR,
                                 keep=lambda p: p.endswith("albedo"), **kw)
    losses, cur, per_step = [], start, []
    G.bounce_fwd.launches = G.bounce_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(3):
        cur, loss = step(cur, torch.Generator(dev).manual_seed(7), target)
        losses.append(float(loss))
        per_step.append((G.bounce_fwd.launches, G.bounce_bwd.launches))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = per_step[-1]
    moved = float((cur.materials.albedo - start.materials.albedo).abs().max())
    want = [(k * (DEPTH_GRAD + 1),) * 2 for k in (1, 2, 3)]
    check(per_step == want,
          f"K4 / K5 launch counts after each train step {per_step}, not "
          f"{want}")
    check(all(np.isfinite(losses)), f"losses not finite: {losses}")
    check(bool(torch.isfinite(cur.materials.albedo).all()) and moved > 0,
          f"albedos not finite or did not move ({moved})")
    check(losses[0] > losses[1] > losses[2],
          f"loss did not fall over the steps: {losses}")
    err0 = float((start.materials.albedo - albedo).abs().mean())
    err3 = float((cur.materials.albedo - albedo).abs().mean())
    say("8", f"3 train steps of the cover {W_GRAD}x{H_GRAD} spp{SPP_GRAD} "
             f"depth {DEPTH_GRAD} (lr {LR}, albedo mask, fixed generator "
             f"seed): loss {', '.join(f'{x:.6g}' for x in losses)}; albedo "
             f"mean |error| {err0:.6g} -> {err3:.6g}, max move {moved:.3g}; "
             f"K4 {fwd_launches} and K5 {bwd_launches} launches; "
             f"{train_s:.2f} s")

    # bench.py's grad_mrays and grad_ratio, median of 3 calls each.
    def fwd_call():
        with torch.no_grad():
            return G.render_pixels_kernel(
                scene, cam, torch.Generator(dev).manual_seed(7), pix, **kw)

    def fwdbwd_call():
        return G.loss_and_grad_kernel(
            scene, cam, torch.Generator(dev).manual_seed(7), target, pix,
            **kw)

    fwd_call()  # warm-up
    loss, grads = fwdbwd_call()
    check(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.leaves().values()
        if g is not None), "loss_and_grad_kernel: not finite")
    fwd_runs = [wall_ms(torch, fwd_call) for _ in range(3)]
    fb_runs = [wall_ms(torch, fwdbwd_call) for _ in range(3)]
    fwd_ms, fb_ms = statistics.median(fwd_runs), statistics.median(fb_runs)
    say("8", f"on {card}: forward {fwd_ms:.2f} ms (median of "
             f"{', '.join(f'{x:.2f}' for x in fwd_runs)}), "
             f"{W_GRAD * H_GRAD * SPP_GRAD / fwd_ms / 1e3:.2f} Mrays/s; "
             f"forward+backward {fb_ms:.2f} ms (median of "
             f"{', '.join(f'{x:.2f}' for x in fb_runs)}); ratio "
             f"{fb_ms / fwd_ms:.3f}")

    # Each kernel at the trainer's shapes: the (depth + 1) launches of one
    # forward / backward on that forward's tape, against the plain version.
    tbl, _ = mk.build_sphere_table(scene)
    c0, i0 = lanes_of(cam, W_GRAD, H_GRAD, SPP_GRAD, seed=7)
    tape, _ = forward_tape(tbl, c0, i0, DEPTH_GRAD, 0, G.bounce_fwd)
    n = c0.shape[1]
    live = [int((ints[0] > 0).sum()) for _, ints in tape]
    cots = [torch.from_numpy(rng.standard_normal((13, n)).astype(np.float32))
            .to(dev) for _ in tape]
    args = [dict(it=it, seed=0, max_depth=DEPTH_GRAD)
            for it in range(len(tape))]

    def run_all(fn, bwd):
        """(ms, outputs) of the (depth + 1) calls, issued back to back
        between one pair of events."""
        return event_ms(torch, lambda: [
            fn(cont, ints, cot, tbl, **a) if bwd else fn(cont, ints, tbl, **a)
            for (cont, ints), cot, a in zip(tape, cots, args)])

    rows = []
    for name, kern, plain, bwd in (
            ("grad_fwd", G.bounce_fwd, G.bounce_fwd_reference, False),
            ("grad_bwd", G.bounce_bwd, G.bounce_bwd_reference, True)):
        # Timed runs keep no outputs, so each reuses the memory the
        # caching allocator holds from the one before (no cudaMalloc).
        _, k_outs = run_all(kern, bwd)  # warm-up, and the outputs compared
        k_runs = [run_all(kern, bwd)[0] for _ in range(3)]
        k_ms = statistics.median(k_runs)
        p_ms, p_outs = run_all(plain, bwd)
        if bwd:
            res = [check_k5(torch, k, p,
                            f"cover {W_GRAD}x{H_GRAD}, bounce {it}")
                   for it, (k, p) in enumerate(zip(k_outs, p_outs))]
            err = max(v[0] for r in res for v in r.values())
        else:
            for it, (k, p) in enumerate(zip(k_outs, p_outs)):
                check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
                      f"K4 vs plain at {W_GRAD}x{H_GRAD}, bounce {it}: not "
                      f"bit-identical")
            err = 0.0
        # The sweep over the scene's spheres (not the table's padding).
        n_sph = scene.n_spheres
        ops = OPS_PER_STEP + OPS_PER_ROW * n_sph + (OPS_BWD_EXTRA if bwd
                                                    else 0)
        # Bytes: each input read once, each output written once.
        nbytes = (29 + 13 if bwd else 16 + 16) * 4 * n + n_sph * 64 * (
            2 if bwd else 1)
        bound = sum(max(nbytes / PEAK_BYTES, lv * ops / PEAK_F32) * 1e3
                    for lv in live)
        by = ("operations" if max(live) * ops / PEAK_F32 > nbytes / PEAK_BYTES
              else "bytes")
        say("8", f"{name}: {len(tape)} launches of {n} lanes (live "
                 f"{', '.join(map(str, live))}) on {card}: kernel "
                 f"{k_ms:.3f} ms (median of "
                 f"{', '.join(f'{ms:.3f}' for ms in k_runs)}), plain "
                 f"{p_ms:.2f} ms, bound {bound:.3f} ms ({by}; "
                 f"{bound / k_ms:.1%} of the kernel time); max |d| vs plain "
                 f"{err:.3g}")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"rtow_tpu_torch/csrc/{name}.cu",
            "replaces": ("rtow_tpu/ops/pallas_grad.py:224" if bwd
                         else "rtow_tpu/ops/pallas_grad.py:101"),
            "launches": bwd_launches if bwd else fwd_launches,
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    # Where a train step's time goes: torch.profiler over one step.
    step_ms, dev_ms = profile_ms(torch, lambda: step(
        start, torch.Generator(dev).manual_seed(7), target))
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    say("9", f"one train step under torch.profiler on {card}: {step_ms:.2f} "
             f"ms wall, device kernels {busy_ms:.2f} ms "
             f"(idle share {1 - busy_ms / step_ms:.1%}); by kernel: "
             + "; ".join(f"{k[:40]} {ms:.3f} ms" for k, ms in top))

    return rows


def grad_agreement(kern, plain, dim, scale=None):
    """(max |d|, worst max |d| / scale per row or column, share of entries
    off by more than 1e-4 |plain| + 1e-6 scale); the scale is the row's /
    column's max |plain| unless given."""
    d = (kern - plain).abs()
    if scale is None:
        scale = plain.abs().amax(dim=dim, keepdim=True)
    worst = float((d.amax(dim=dim, keepdim=True)
                   / scale.clamp_min(1e-30)).max())
    share = float((d > 1e-4 * plain.abs() + 1e-6 * scale).float().mean())
    return float(d.max()), worst, share


def rows_agreement(torch, k, p, exact, mags):
    """K5's light-row cotangent ``k`` (R, 14) against the plain version's
    ``p``, given the float64 sum ``exact`` and sum of |terms| ``mags`` of
    its per-lane terms -> (max |d|, worst max |d| / scale, share of the
    coherent entries off, coherent entries, kernel's and plain's worst
    distance from the float64 sum as shares of the scale).

    Each entry sums a term from every lane, so it is held to its own sum
    (check_rows): max |d| at most GRAD_TOL of the scale max(|exact|,
    ROWS_CANCEL mags, ROWS_FLOOR max mags).  Where the terms do not cancel
    below ROWS_CANCEL of their sum of |terms| (a coherent entry: the
    emission columns under same-sign cotangents), that is 1e-3 of the
    value itself, and the share rule holds too (no more than GRAD_SHARE of
    the coherent entries off by more than 1e-4 |plain| + 1e-6 scale).  An
    entry whose terms cancel (a horizontal lamp's x and z) is held to 1e-3
    of ROWS_CANCEL of its terms, the size of the float32 rounding of the
    sum."""
    big = float(mags.max())
    scale = torch.maximum(exact.abs(), ROWS_CANCEL * mags).clamp_min(
        ROWS_FLOOR * big).clamp_min(1e-300)
    coherent = (exact.abs() >= ROWS_CANCEL * mags) & (mags >= ROWS_FLOOR * big)
    d = (k.double() - p.double()).abs()
    off = d > 1e-4 * p.double().abs() + 1e-6 * scale
    share = float(off[coherent].double().mean()) if coherent.any() else 0.0
    return (float(d.max()), float((d / scale).max()), share,
            int(coherent.sum())) + tuple(
        float(((x.double() - exact).abs() / scale).max()) for x in (k, p))


def check_rows(torch, k, p, exact, mags, what):
    """rows_agreement, raising CheckFailed past its rule."""
    r = rows_agreement(torch, k, p, exact, mags)
    check(r[1] <= GRAD_TOL and r[2] <= GRAD_SHARE,
          f"{what}: K5 g_rows vs plain: max |d| / scale {r[1]:.3g} "
          f"(allowed {GRAD_TOL}), share of coherent entries off {r[2]:.3g} "
          f"(allowed {GRAD_SHARE})")
    return r


def plant_faults(torch, k, p, sums, what, vol_row0=None) -> str:
    """check_rows's rule on K5's row cotangent ``k`` made wrong on purpose,
    every entry scaled by 1.01 and the whole of it 0, and where the rows
    hold volumes (from ``vol_row0`` on) their density column scaled by
    1.01 and 0 -> what the rule read on each; raises CheckFailed if it
    would pass any."""
    faults = [("x1.01", k * 1.01), ("0", torch.zeros_like(k))]
    if vol_row0 is not None:
        for fault, factor in (("density x1.01", 1.01), ("density 0", 0.0)):
            bad = k.clone()
            bad[vol_row0:, 6] *= factor
            faults.append((fault, bad))
    seen = []
    for fault, bad in faults:
        r = rows_agreement(torch, bad, p, *sums)
        check(r[1] > GRAD_TOL or r[2] > GRAD_SHARE,
              f"{what}: check_rows passed K5's g_rows {fault}")
        seen.append(f"{fault} max |d| / scale {r[1]:.3g}, coherent entries "
                    f"off {r[2]:.3g}")
    return f"{what} (" + "; ".join(seen) + ")"


@contextlib.contextmanager
def warp_form(G, form):
    """K4 and K5 forced to their "thread" or "warp" forms, or left to pick
    ("auto"), through their cut-over ``G.WARP_MAX_LIVE``."""
    keep = G.WARP_MAX_LIVE
    G.WARP_MAX_LIVE = {"thread": -1, "warp": 1 << 30, "auto": keep}[form]
    try:
        yield
    finally:
        G.WARP_MAX_LIVE = keep


def check_k5(torch, kern, plain, what, sums=None):
    """K5's (cot_in, g_tbl, g_tri, g_rows) against the plain version's, by
    the 1e-3 rule (GRAD_TOL, GRAD_SHARE) per cot_in row and per table
    column -> {name: (max |d|, worst share of the scale, share off[,
    kernel's and plain's worst distance from the float64 sum, as shares of
    the scale])} for cot_in, g_tbl (where the scene has spheres), g_tri
    (where it has triangles) and g_rows (where it has light rows; the
    tuple of check_rows).  The kind columns must be 0.

    The scale is the row's / column's max |plain|, or, for a table part
    in ``sums`` ({part: (float64 sum, float64 sum of |terms|)} of the
    plain version's per-lane row cotangents), the column's largest sum
    of |terms|: two float32 sums of the same terms in other orders differ
    by rounding that scales with it, not with the sum, which mixed-sign
    cotangents can cancel far below its terms.  The light rows' R x 14
    entries, which ``sums`` must hold, follow check_rows."""
    (ci, gt, gr, gl), (pci, pgt, pgr, pgl) = kern, plain
    parts = [("cot_in", ci, pci, 1), ("g_tbl", gt[:, :16], pgt[:, :16], 0)]
    check(not gt[:, 12].any(), f"{what}: K5 g_tbl kind column not 0")
    if gr is not None:
        parts.append(("g_tri", gr[:, :14], pgr[:, :14], 0))
        check(not gr[:, 14:].any(), f"{what}: K5 g_tri kind column not 0")
    out = {}
    for name, k, p, dim in parts:
        check(bool(torch.isfinite(k).all()), f"{what}: K5 {name} not finite")
        if not p.numel():
            continue
        scale = exact = None
        if sums and name in sums:
            exact, mags = (s_[:, :k.shape[1]] for s_ in sums[name])
            scale = mags.amax(dim=0, keepdim=True).float()
        mx, worst, share = grad_agreement(k, p, dim, scale)
        check(worst <= GRAD_TOL and share <= GRAD_SHARE,
              f"{what}: K5 {name} vs plain: max |d| / scale "
              f"{worst:.3g} (allowed {GRAD_TOL}), share off "
              f"{share:.3g} (allowed {GRAD_SHARE})")
        out[name] = (mx, worst, share)
        if exact is not None:
            out[name] += tuple(
                float(((x.double() - exact).abs().amax(dim=0)
                       / scale[0].double().clamp_min(1e-300)).max())
                for x in (k, p))
    if gl is not None:
        check(bool(torch.isfinite(gl).all()), f"{what}: K5 g_rows not finite")
        out["g_rows"] = check_rows(torch, gl, pgl, *sums["g_rows"], what)
    return out


def profile_ms(torch, fn):
    """(wall ms, {kernel name: device ms}) of ``fn()`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        if ev.device_type.name == "CUDA" and us:
            dev_ms[ev.key] = us / 1e3
    return wall, dev_ms


def split_device_time(dev_ms, kernels=(("K3", "flat_bounce"),)):
    """Device ms by part of a sorted path: each of ``kernels`` ((label, a
    word of its kernel's name) pairs; K3 for the sorted wavefront), the
    sort, the gathers and scatters (index kernels), everything else."""
    parts = {label: 0.0 for label, _ in kernels}
    parts.update(sort=0.0, gather=0.0, other=0.0)
    for key, ms in dev_ms.items():
        low = key.lower()
        label = next((lb for lb, word in kernels if word in low), None)
        if label is not None:
            parts[label] += ms
        elif "sort" in low or "radix" in low:
            parts["sort"] += ms
        elif "index" in low or "gather" in low or "scatter" in low:
            parts["gather"] += ms
        else:
            parts["other"] += ms
    return parts


def mesh_phases(torch, dev, card, say, event_ms):
    """Phases 10-13: K1 with triangles against its plain version on the
    frame ``cli.main -l samples/knot_small.obj`` renders, the mesh path
    through ``cli.main -l`` (K3 and K1), bench.py's knots through
    ``render_wavefront``, and K3 against its plain version, bit for bit
    with equal counters, at every launch of each knot's centre chunk
    (262,144 lanes, then the window ladder's narrower launches), timed
    there.  Returns K3's JSON entries, the thread and warp forms (the 65k
    knot's times)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_mesh import make_knot

    from rtow_tpu_torch import cli
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models.builders import mesh_scene
    from rtow_tpu_torch.models.camera import make_camera
    from rtow_tpu_torch.models.scene import SceneBuilder
    from rtow_tpu_torch.ops import flat_bounce as fb
    from rtow_tpu_torch.ops import megakernel as mk
    from rtow_tpu_torch.ops import wavefront as wf
    from rtow_tpu_torch.utils.ppm import read_ppm

    small_obj = os.path.join(ROOT, "samples", "knot_small.obj")

    # ---- (10) K1 with triangles against its plain version ---------------
    scene, cam = mesh_scene(Config(model=small_obj, image_width=W_MESH,
                                   aspect_ratio=1.0), device=dev)
    tbl, tris = mk.scene_k1_tables(scene)

    def k1_args(spp):
        return (tbl, mk.pack_camera(cam),
                mk.pack_meta(0, width=W_MESH, height=W_MESH, spp=spp,
                             max_depth=DEPTH_MESH),
                mk.n_tiles_for(W_MESH, W_MESH))

    # The frame cli.main -l renders (spp 64): the kernel timed, then held
    # bit for bit with equal counters against the plain version.
    def k1_launch():
        return mk.render_blocks(*k1_args(SPP_MESH), tris=tris, pool=False)

    k1_runs = [event_ms(torch, k1_launch)[0] for _ in range(4)][1:]
    k1_ms = statistics.median(k1_runs)
    times = []
    _, c10 = k1_held(torch, mk, dev, "knot_small", k1_args(SPP_MESH),
                     dict(tris=tris, pool=False), times)
    k1_plain = times[1]
    k1_bound = k1_ops(c10) / PEAK_F32 * 1e3
    say("10", f"K1 on samples/knot_small.obj ({scene.n_triangles} "
              f"triangles, {tris.n_blocks} blocks) {W_MESH}x{W_MESH} "
              f"spp{SPP_MESH} depth {DEPTH_MESH} on {card}: kernel vs plain "
              f"bit-identical with equal counters ({K1_COUNTERS}) {c10}; "
              f"kernel {k1_ms:.2f} ms (median of "
              f"{', '.join(f'{x:.2f}' for x in k1_runs)}), plain "
              f"{k1_plain:.1f} ms; bound {k1_bound:.3f} ms (operations) = "
              f"{k1_bound / k1_ms:.1%}")

    bench_cam = make_camera(lookfrom=(0.0, 0.0, 3.0),
                            lookat=(0.0, 0.0, 0.0), fov_degrees=45.0,
                            aspect_ratio=1.0, aperture=0.0, focus_dist=3.0,
                            device=dev)
    bench_cfg = Config(image_width=W_MESH, aspect_ratio=1.0,
                       samples_per_pixel=SPP_MESH, max_child_rays=DEPTH_MESH)
    knots = {}
    for name, (seg, rings) in KNOTS.items():
        verts, faces = make_knot(seg, rings)
        b = SceneBuilder()
        b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
        knots[name] = (b.build(device=dev), verts, faces)

    ppc, n_chunks = wf.chunk_plan(bench_cfg)
    perm = torch.from_numpy(wf._morton_pixel_perm(W_MESH, W_MESH)
                            .astype("int64")).to(dev)
    # The chunk that holds the frame's centre pixel: the knot fills it.
    centre = W_MESH // 2 * W_MESH + W_MESH // 2
    g_mid = int((perm == centre).nonzero()) // ppc
    mid_pixels = perm[g_mid * ppc:(g_mid + 1) * ppc]
    mid_seed = bench_cfg.seed + g_mid * 7919  # render_wavefront's salt

    # ---- (11) the mesh path through cli.main -l --------------------------
    def refuse(*_a, **_k):
        raise CheckFailed("the mesh path ran K3's plain version on the card")

    log = io.StringIO()
    plain_k3 = fb.bounce_step_reference
    fb.bounce_step_reference = refuse
    try:
        with tempfile.TemporaryDirectory() as tmp:
            obj = os.path.join(tmp, "knot65k.obj")
            _, verts, faces = knots["65k"]
            with open(obj, "w") as f:
                f.writelines(f"v {a:.6f} {b:.6f} {c:.6f}\n"
                             for a, b, c in verts)
                f.writelines(f"f {a} {b} {c}\n" for a, b, c in faces + 1)
            runs = {}
            for label, path in (("65k knot", obj), ("knot_small", small_obj)):
                ppm_path = os.path.join(tmp, "mesh.ppm")
                mk.render_blocks.launches = fb.bounce_step.launches = 0
                fb.bounce_step.warp_launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(log):
                    rc = cli.main(["-l", path, "-w", str(W_MESH), "-a", "1",
                                   "-s", str(SPP_MESH), "-c",
                                   str(DEPTH_MESH), "-o", ppm_path])
                wall = time.perf_counter() - t0
                check(rc == 0, f"cli.main -l {label} returned {rc}")
                with open(ppm_path) as f:
                    img = read_ppm(f)
                check(img.shape == (W_MESH, W_MESH, 3) and img.std() > 10
                      and img.max() <= 255,
                      f"{label}: PPM shape {img.shape} or values flat")
                runs[label] = (wall, mk.render_blocks.launches,
                               fb.bounce_step.launches,
                               fb.bounce_step.warp_launches)
    finally:
        fb.bounce_step_reference = plain_k3
    k3_launches, k3_warp = runs["65k knot"][2:]
    check(k3_launches > k3_warp > 0 and runs["65k knot"][1] == 0,
          f"65k knot: K3 launched {k3_launches} times ({k3_warp} the warp "
          f"form), K1 {runs['65k knot'][1]} times")
    check(runs["knot_small"][1] > 0 and runs["knot_small"][2] == 0,
          f"knot_small: K1 launched {runs['knot_small'][1]}, K3 "
          f"{runs['knot_small'][2]} times")
    lines = log.getvalue().splitlines()
    tri_lines = [ln for ln in lines if ln.startswith("Scene has")]
    done = [ln for ln in lines if ln.startswith("Done")]
    check(tri_lines == [f"Scene has {len(knots['65k'][2])} triangles",
                        "Scene has 1920 triangles"],
          f"cli.main printed {tri_lines}")
    say("11", f"cli.main -l <65k knot OBJ> -w {W_MESH} -a 1 -s {SPP_MESH} "
              f"-c {DEPTH_MESH}: {k3_launches} K3 launches ({k3_warp} of "
              f"them the warp form, at most {fb.WARP_MAX_LIVE} live lanes), "
              f"0 of K1, "
              f"{runs['65k knot'][0]:.2f} s end to end (render: {done[0]}); "
              f"-l samples/knot_small.obj: {runs['knot_small'][1]} K1 "
              f"launches, 0 of K3, {runs['knot_small'][0]:.2f} s (render: "
              f"{done[1]})")

    # ---- (12) bench.py's knots through render_wavefront ------------------
    for name, (scene, _, _) in knots.items():
        frame = lambda: wf.render_wavefront(scene, bench_cam, bench_cfg)
        frame()  # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = frame()
            walls.append(time.perf_counter() - t0)
        check(img.shape == (W_MESH, W_MESH, 3) and bool(
            (img >= 0).all()) and img.std() > 0.05, f"{name}: bad image")
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        fb.bounce_step.launches = fb.bounce_step.warp_launches = 0
        wf.render_wavefront(scene, bench_cam, bench_cfg, stats=stats)
        per_frame = fb.bounce_step.launches
        warp_frame = fb.bounce_step.warp_launches
        check(per_frame > warp_frame > 0, f"{name} frame: {warp_frame} of "
                                          f"{per_frame} launches the warp form")
        wall = statistics.median(walls)
        f_wall, f_dev = profile_ms(torch, frame)
        parts = split_device_time(f_dev)
        busy = sum(f_dev.values())
        tables, bmin, inv_ext = wf.scene_tables(scene)
        c_wall, c_dev = profile_ms(torch, lambda: wf.trace_wavefront_sorted(
            tables, bench_cam, wf.chunk_generator(dev, bench_cfg.seed, g_mid),
            mid_pixels, mid_seed, spp=SPP_MESH, max_depth=DEPTH_MESH,
            width=W_MESH, height=W_MESH, bmin=bmin, inv_ext=inv_ext))
        c_parts = split_device_time(c_dev)
        c_busy = sum(c_dev.values())
        box, tri, live = stats.tolist()
        say("12", f"the {name} knot {W_MESH}x{W_MESH} spp{SPP_MESH} depth "
                  f"{DEPTH_MESH} ({n_chunks} chunks of {ppc} pixels) on "
                  f"{card}: {wall:.3f} s a frame (median of "
                  f"{', '.join(f'{x:.3f}' for x in walls)}), "
                  f"{W_MESH * W_MESH * SPP_MESH / wall / 1e6:.2f} Mrays/s; "
                  f"{per_frame} K3 launches ({warp_frame} the warp form), "
                  f"{live} live lane-bounces, {box} box and {tri} triangle "
                  f"tests a frame.  One frame under torch.profiler: "
                  f"{f_wall:.1f} ms wall, device {busy:.1f} ms (idle share "
                  f"{1 - busy / f_wall:.1%}): K3 {parts['K3']:.1f}, sort "
                  f"{parts['sort']:.1f}, gather/scatter "
                  f"{parts['gather']:.1f}, other {parts['other']:.1f}.  "
                  f"Chunk {g_mid} (the centre) under torch.profiler: "
                  f"{c_wall:.1f} ms wall, "
                  f"device {c_busy:.1f} ms (idle share "
                  f"{1 - c_busy / c_wall:.1%}): K3 {c_parts['K3']:.2f}, "
                  f"sort {c_parts['sort']:.2f}, gather/scatter "
                  f"{c_parts['gather']:.2f}, other {c_parts['other']:.2f}")

    # ---- (13) K3 against its plain version at the main path's shapes ----
    # Every launch of each knot's centre chunk, as render_wavefront traced
    # it in phase 12, both versions on the same input states.
    rows = {}
    for name, (scene, _, _) in knots.items():
        tables, tape = k3_tape(torch, dev, wf, scene, bench_cam, bench_cfg,
                               g_mid, mid_pixels, mid_seed, SPP_MESH,
                               DEPTH_MESH)
        r = k3_held(torch, dev, fb, f"K3 {name}, chunk {g_mid}", scene,
                    tables, tape, mid_seed, DEPTH_MESH)
        rows[name] = r
        tt = tables.tris
        say("13", f"K3 on chunk {g_mid} of the {name} knot ({tt.count} "
                  f"triangles, {tt.n_blocks} blocks of {tt.block}, "
                  f"{tt.n_super} supers, {tt.n_hyper} hypers; "
                  f"{tape[0][0].shape[1]} lanes, {len(tape)} launches) on "
                  f"{card}: both forms and the plain version bit-identical "
                  f"at every launch, counters equal; " + k3_line(r))
    return k3_entries("flat_bounce", rows["65k"], rows.values(),
                      k3_launches, k3_warp)


def k3_entries(name, row, rows, launches, warp_launches):
    """The kernels' JSON entries of K3's thread and warp forms: the main
    path's launches of each, and the chunk ``row``'s times in each form
    (its 20 or so launches, all in that form)."""
    return [{
        "name": name + suffix,
        "route": "cuda",
        "source": "rtow_tpu_torch/csrc/flat_bounce.cu",
        "replaces": "rtow_tpu/ops/pallas_megakernel.py:1739",
        "launches": n,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": row[key],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound"],
        "bound_by": row["by"],
        "library_ms": None,
    } for suffix, key, n in (("", "ms", launches - warp_launches),
                             ("_warp", "warp_ms", warp_launches))]


def k3_tape(torch, dev, wf, scene, cam, cfg, g, pixels, seed, spp, depth,
            roulette=False, cull=True):
    """(K3's tables, tape) of chunk ``g`` of a ``render_wavefront`` frame:
    its ``pixels``' camera rays drawn as the frame draws them, and every
    launch's (input state, step) as ``trace_lanes`` ran the chunk."""
    from rtow_tpu_torch.models.camera import camera_rays, pixel_coords

    tables, bmin, inv_ext = wf.scene_tables(scene, roulette)
    gen = wf.chunk_generator(dev, cfg.seed, g)
    pix = pixels.repeat_interleave(spp)
    s, t = pixel_coords(cfg.image_width, cfg.image_height, gen, pix)
    tape = []
    wf.trace_lanes(wf.lane_state(camera_rays(cam, gen, s, t), pix.numel()),
                   seed, max_depth=depth, tables=tables, bmin=bmin,
                   inv_ext=inv_ext, background=scene.background, cull=cull,
                   tape=tape)
    return tables, tape


def k3_held(torch, dev, fb, what, scene, tables, tape, seed, depth,
            cull=True):
    """K3's two forms against its plain version at every launch of
    ``tape``: the outputs bit-identical and the counters (box tests,
    triangle tests, live lanes, shadow rays) equal, launch by launch.
    Times the tape's launches back to back between one pair of CUDA
    events in each form (``thread``, ``warp``, and ``picked``, the form
    ``bounce_step`` picks from the live count), median of 3 rounds in
    turns after a warm-up; the plain version once; and each launch alone
    with its counters in both forms, in turns (thread, warp, warp,
    thread).  Returns the times, the summed counters and the bound: per
    launch the larger of its float32 operations (counted from
    csrc/bounce.cuh, ``OPS_*``) over the card's peak and its bytes (16
    state rows in and out per live lane, at most the table rows, boxes and
    light rows it tested, each read once) over the memory rate."""
    kw = dict(background=scene.background, cull=cull)
    lives = [int((state[13] > 0).sum()) for state, _ in tape]
    cut = fb.WARP_MAX_LIVE

    def launch(form, i, **counters):
        state, it = tape[i]
        if form == "thread":
            return fb.bounce_step(state, it, seed, depth, tables, **kw,
                                  **counters)
        fb.WARP_MAX_LIVE = 1 << 30 if form == "warp" else cut
        try:
            return fb.bounce_step(state, it, seed, depth, tables, **kw,
                                  **counters, live=lives[i])
        finally:
            fb.WARP_MAX_LIVE = cut

    def run_all(form):
        return event_ms(torch, lambda: [launch(form, i)
                                        for i in range(len(tape))])

    # Timed runs keep no outputs (the caching allocator reuses the memory
    # of the run before).  The plain version counts on the host from sizes
    # it already has, so its counters cost it no time.
    forms = ("thread", "warp", "picked")
    outs = {form: run_all(form)[1] for form in forms[:2]}  # warm-ups too
    run_all("picked")
    runs = {form: [] for form in forms}
    for _ in range(3):
        for form in forms:
            runs[form].append(run_all(form)[0])
    p_cs = [(torch.zeros(3, dtype=torch.int64, device=dev),
             torch.zeros(1, dtype=torch.int64, device=dev)) for _ in tape]
    p_ms, p_outs = event_ms(torch, lambda: [
        fb.bounce_step_reference(state, it, seed, depth, tables, **kw,
                                 stats=c[0], shadows=c[1])
        for (state, it), c in zip(tape, p_cs)])
    err = 0.0
    for form, k_outs in outs.items():
        err = max([err] + [float((k - p).abs().max())
                           for k, p in zip(k_outs, p_outs)])
        for i, (k, p) in enumerate(zip(k_outs, p_outs)):
            check(bool(torch.isfinite(k).all()),
                  f"{what}, launch {i}: the {form} form's output not finite")
            check(torch.equal(k, p),
                  f"{what}, launch {i}: the {form} form not bit-identical to "
                  f"the plain version (max |d| over the tape {err:.3g})")
    del outs, p_outs
    lit, tt = tables.lit, tables.tris
    n_sph, n_vol = scene.n_spheres, len(lit.vol_kinds)
    rows_bytes = 0 if lit.rows is None else lit.rows.numel() * 4
    bound, by_ops, by_bytes = 0.0, 0, 0
    per_launch, launch_ms, total = [], [], [0, 0, 0, 0]
    for i, (ps, psh) in enumerate(p_cs):
        ms = {"thread": [], "warp": []}
        for form in ("thread", "warp", "warp", "thread"):
            st, sh = (torch.zeros(n, dtype=torch.int64, device=dev)
                      for n in (3, 1))
            t, _ = event_ms(torch, lambda: launch(form, i, stats=st,
                                                  shadows=sh))
            ms[form].append(t)
            check(torch.equal(st, ps) and torch.equal(sh, psh),
                  f"{what}, launch {i}: the {form} form counted "
                  f"{st.tolist() + sh.tolist()}, the plain version "
                  f"{ps.tolist() + psh.tolist()} (box tests, triangle "
                  f"tests, live lanes, shadow rays)")
        box, tri, live = ps.tolist()
        shadows = int(psh)
        total = [a + b for a, b in zip(total, (box, tri, live, shadows))]
        t_ms, w_ms = (statistics.mean(ms[f]) for f in ("thread", "warp"))
        launch_ms.append((live, t_ms, w_ms))
        per_launch.append(f"{live}/{tri / max(live, 1):.0f}/{t_ms:.3f}/"
                          f"{w_ms:.3f}")
        ops = (box * OPS_PER_BOX + tri * OPS_PER_TRI
               + live * (OPS_PER_STEP + OPS_INV_DIR)
               + shadows * (OPS_NEE + OPS_INV_DIR)
               + (n_sph * OPS_PER_ROW + n_vol * OPS_PER_VOL)
               * (live + shadows))
        nbytes = (32 * 4 * live + min(tri, tt.tbl.shape[0]) * 64
                  + min(box, tt.n_blocks + tt.supers.shape[0]
                        + tt.hypers.shape[0]) * 32 + rows_bytes)
        ops_s, bytes_s = ops / PEAK_F32, nbytes / PEAK_BYTES
        bound += max(ops_s, bytes_s) * 1e3
        by_ops += ops_s >= bytes_s
        by_bytes += ops_s < bytes_s
    # The cut-over this chunk's launches favour: the live count at or
    # below which the warp form, above which the thread form, makes the
    # least sum of the launches' times.
    best = min((sum(w if n <= c else t for n, t, w in launch_ms), c)
               for c in [0] + [n for n, _, _ in launch_ms])
    return dict(err=err, ms=statistics.median(runs["thread"]),
                warp_ms=statistics.median(runs["warp"]),
                picked_ms=statistics.median(runs["picked"]), runs=runs,
                plain_ms=p_ms, bound=bound, by_ops=by_ops, by_bytes=by_bytes,
                by="operations" if by_ops >= by_bytes else "bytes",
                per_launch=per_launch, launch_ms=launch_ms, total=total,
                best_cut=best[1], best_ms=best[0],
                cut=cut, warp_launches=sum(n <= cut for n in lives))


def k3_line(r):
    """The times of k3_held's result ``r``, for a phase's line."""
    def med(form):
        runs = ", ".join(f"{x:.3f}" for x in r["runs"][form])
        ms = r["ms" if form == "thread" else form + "_ms"]
        return f"{ms:.3f} ms (median of {runs})"

    return (f"thread form {med('thread')}, warp form {med('warp')}, as "
            f"picked (warp form at <= {r['cut']} live lanes: "
            f"{r['warp_launches']} of the launches) {med('picked')}; plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound']:.3f} ms (operations "
            f"in {r['by_ops']} launches, bytes in {r['by_bytes']}) = "
            f"{r['bound'] / r['ms']:.1%} of the thread form, "
            f"{r['bound'] / r['picked_ms']:.1%} as picked; the launches' "
            f"least sum {r['best_ms']:.3f} ms at a cut-over of "
            f"{r['best_cut']} live lanes; per launch (live lanes / triangle "
            f"tests per live lane / thread-form ms / warp-form ms, each "
            f"launch timed alone with its counters, in turns): "
            f"{', '.join(r['per_launch'])}")


def lit_knot(SceneBuilder, verts, faces, device, reverse=False):
    """The lit knot's scene (``DEPTH_KNOT_LIT``); ``reverse`` winds every
    triangle the other way, so the camera sees back faces."""
    b = SceneBuilder()
    b.add_mesh(verts[faces[:, ::-1] if reverse else faces],
               b.add_lambertian((0.6, 0.5, 0.4)))
    lamp = b.add_light((KNOT_LAMP_EMIT,) * 3)
    b.add_quad((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0.5, 1.5, 0.5),
               (-0.5, 1.5, 0.5), lamp)
    b.add_quad((1.5, -0.5, -0.5), (1.5, -0.5, 0.5), (1.5, 0.5, 0.5),
               (1.5, 0.5, -0.5), lamp)
    return b.build(background=(0.0, 0.0, 0.0), device=device)


#: The counters k1_pair reads, in its order.
K1_COUNTERS = ("steps, box tests, triangle tests, shadow rays, lane slots, "
               "sphere-group box tests, sphere rows swept")


def k1_pair(torch, mk, dev, args, kw, times=None):
    """One launch of K1 and one of its plain version on the same inputs:
    ((kernel planes, kernel counters), (plain planes, plain counters)),
    the three radiance planes stacked and the counters as K1_COUNTERS
    lists them.  ``times``, a list, gets each call's milliseconds (CUDA
    events) appended."""
    out = []
    for fn in (mk.render_blocks, mk.render_blocks_reference):
        steps, tests, shadows, slots, spheres = (
            torch.zeros(n, dtype=torch.int64, device=dev)
            for n in (1, 2, 1, 1, 2))
        ms, planes = event_ms(torch, lambda: torch.stack(fn(
            *args, **kw, steps=steps, tests=tests, shadows=shadows,
            slots=slots, spheres=spheres)))
        if times is not None:
            times.append(ms)
        out.append((planes, steps.tolist() + tests.tolist()
                    + shadows.tolist() + slots.tolist() + spheres.tolist()))
    return out


def k1_held(torch, mk, dev, what, args, kw, times=None):
    """k1_pair, checked: the kernel's planes finite and bit-identical to
    the plain version's, the counters equal.  Returns (kernel planes,
    counters)."""
    (k, kc), (p, pc) = k1_pair(torch, mk, dev, args, kw, times)
    check(bool(torch.isfinite(k).all()), f"K1 {what}: output not finite")
    check(torch.equal(k, p), f"K1 {what}: not bit-identical to the plain "
                             f"version (max |d| {float((k - p).abs().max())})")
    check(kc == pc, f"K1 {what}: kernel counted {kc}, plain {pc} "
                    f"({K1_COUNTERS})")
    return k, kc


def k1_ops(counts, n_vol=0):
    """float32 operations of the work a K1 launch's counters (K1_COUNTERS)
    say it did: per step the shade's (OPS_PER_STEP) and the rays' inverse
    directions; per sphere-group box test OPS_PER_BOX and per sphere row
    swept OPS_PER_ROW; the triangle sweep's box and triangle tests; NEE and
    its own inverse directions per shadow ray; each volume per step and
    per shadow ray.  The brute-force sweep this replaced: OPS_PER_ROW for
    each of the scene's spheres per step and per shadow ray
    (k1_brute_ops)."""
    steps, n_box, n_tri, n_shadow, _slots, sph_box, sph_rows = counts
    return (steps * (OPS_PER_STEP + OPS_INV_DIR) + sph_box * OPS_PER_BOX
            + sph_rows * OPS_PER_ROW + n_box * OPS_PER_BOX
            + n_tri * OPS_PER_TRI + n_shadow * (OPS_NEE + OPS_INV_DIR)
            + n_vol * OPS_PER_VOL * (steps + n_shadow))


def k1_brute_ops(counts, n_sph, n_vol=0):
    """k1_ops with the sphere sweep of every scene sphere in place of the
    culled one (the bound PRs 1-10 stated)."""
    steps, _box, _tri, n_shadow = counts[:4]
    return (k1_ops(counts, n_vol) - counts[5] * OPS_PER_BOX
            - counts[6] * OPS_PER_ROW
            + (steps + n_shadow) * n_sph * OPS_PER_ROW)


def moved(obj, device):
    """``obj`` with every tensor in it (in tuples, NamedTuples and dicts)
    moved to ``device``."""
    if hasattr(obj, "to") and hasattr(obj, "dtype"):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        items = [moved(v, device) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def band_check(payload):
    """A worker process's check of one recorded K1 launch (``payload``:
    its (args, kwargs) with the tensors on the CPU): the kernel and its
    plain version on the card.  Returns (finite, bit-identical, max |d|,
    kernel counters, plain counters, seconds)."""
    import torch

    sys.path.insert(0, ROOT)
    from rtow_tpu_torch.ops import megakernel as mk

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    args, kw = moved(payload, dev)
    t0 = time.perf_counter()
    (k, kc), (p, pc) = k1_pair(torch, mk, dev, args, kw)
    return (bool(torch.isfinite(k).all()), torch.equal(k, p),
            float((k - p).abs().max()), kc, pc, time.perf_counter() - t0)


def band_worker(src, dst):
    """A worker process of ``band_checks``: ``band_check`` on the payload
    pickled at ``src``, its result pickled to ``dst``."""
    with open(src, "rb") as f:
        payload = pickle.load(f)
    result = band_check(payload)
    with open(dst, "wb") as f:
        pickle.dump(result, f)


def band_checks(payloads):
    """``band_check`` on each of ``payloads`` ({key: payload}), each in a
    Python process of its own, all started together.  Every process is
    waited for; one still running when this returns or raises (a check
    that failed, ``BAND_S`` passed) is killed first.  Returns {key:
    result}."""
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i, (key, payload) in enumerate(payloads.items()):
                src, dst = (os.path.join(tmp, f"{i}.{x}") for x in ("in",
                                                                     "out"))
                with open(src, "wb") as f:
                    pickle.dump(payload, f)
                code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
                        f"import chip_smoke; "
                        f"chip_smoke.band_worker({src!r}, {dst!r})")
                procs[key] = (subprocess.Popen([sys.executable, "-c", code]),
                              dst)
            deadline = time.monotonic() + BAND_S
            results = {}
            for key, (proc, dst) in procs.items():
                try:
                    rc = proc.wait(timeout=max(deadline - time.monotonic(),
                                               1.0))
                except subprocess.TimeoutExpired:
                    raise CheckFailed(f"the band check of {key} ran past "
                                      f"{BAND_S} s") from None
                check(rc == 0, f"the band check of {key} exited {rc}")
                with open(dst, "rb") as f:
                    results[key] = pickle.load(f)
            return results
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def lit_phases(torch, dev, card, say, event_ms, cover_radiance):
    """Phases 14-18: K1's lit instances against their plain version on the
    five lit scenes (and the checkered cover), the light-driven path
    through ``cli.main`` for each lit flag at full size, roulette on the
    cover against phase 5's unbiased render, the middle band of each of
    those renders held against the plain version, and the lit instance's
    times and bound on the Cornell and smoke boxes.  Returns the lit
    instance's JSON entry (the Cornell box's times)."""
    import numpy as np

    from rtow_tpu_torch import cli, pipeline
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models import builders as B
    from rtow_tpu_torch.ops import megakernel as mk
    from rtow_tpu_torch.utils.ppm import read_ppm

    def prepared(scene, cam, spp, depth, roulette, width=W_LIT):
        tbl, tris = mk.scene_k1_tables(scene)
        args = (tbl, mk.pack_camera(cam),
                mk.pack_meta(0, width=width, height=width, spp=spp,
                             max_depth=depth),
                mk.n_tiles_for(width, width))
        kw = dict(background=scene.background, tris=tris,
                  lit=mk.scene_lit(scene, roulette), pool=False)
        return args, kw

    def held(name, finite, same, err, kc, pc):
        """The kernel against its plain version on one launch: finite,
        bit-identical, with equal counters.  max |d| goes to ``errs``."""
        errs.append(err)
        check(finite, f"lit K1 {name}: kernel output not finite")
        check(same, f"lit K1 {name}: not bit-identical to the plain version "
                    f"(max |d| {err:.3g})")
        check(kc == pc,
              f"lit K1 {name}: kernel counted {kc}, plain {pc} "
              f"({K1_COUNTERS}) for the same launch")

    def compared(name, args, kw):
        """held() on one launch of each here.  Returns the counters."""
        (k, kc), (p, pc) = k1_pair(torch, mk, dev, args, kw)
        held(name, bool(torch.isfinite(k).all()), torch.equal(k, p),
             float((k - p).abs().max()), kc, pc)
        return kc

    # ---- (14) the lit instances against their plain version, spp 2 ------
    errs = []
    scenes = {
        "lights": (B.light_scene(1.0, device=dev), False, DEPTH_LIT),
        "cornell": (B.cornell_scene(1.0, device=dev), False, DEPTH_LIT),
        "textures": (B.textures_scene(1.0, device=dev), False, DEPTH_LIT),
        "smoke": (B.smoke_scene(1.0, device=dev), False, DEPTH_LIT),
        "checker cover": (B.cover_scene(Config(
            image_width=W_LIT, aspect_ratio=1.0, checker_ground=True),
            device=dev), False, 50),
        "roulette cover": (B.cover_scene(Config(
            image_width=W_LIT, aspect_ratio=1.0), device=dev), True, 50),
    }
    lines = []
    for name, ((scene, cam), roulette, depth) in scenes.items():
        counts = compared(name, *prepared(scene, cam, 2, depth, roulette))
        lines.append(f"{name} {counts}")
    say("14", f"lit K1 vs plain at {W_LIT}x{W_LIT} spp2 (depth {DEPTH_LIT}, "
              f"the covers 50) on {card}: bit-identical with equal counters "
              f"({K1_COUNTERS}): " + "; ".join(lines))

    # ---- (15) the light-driven path through cli.main at full size --------
    def refuse(*_a, **_k):
        raise CheckFailed("the light-driven path ran K1's plain version on "
                          "the card")

    def run_cli(flags, label):
        """cli.main with ``flags``: (PPM image, radiance, wall s, lit
        launches, its "Done" line, the (args, kwargs) of every launch)."""
        plain_k1, kernel = mk.render_blocks_reference, pipeline.render_blocks
        launched = []

        def record(*a, **k):
            launched.append((a, {n: v for n, v in k.items()
                                 if n != "progress"}))
            return kernel(*a, **k)

        mk.render_blocks_reference, pipeline.render_blocks = refuse, record
        log = io.StringIO()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                ppm_path = os.path.join(tmp, "lit.ppm")
                mk.render_blocks.launches = mk.render_blocks.lit_launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(log), kept_radiance() as kept:
                    rc = cli.main(flags + ["-o", ppm_path])
                wall = time.perf_counter() - t0
                launches = (mk.render_blocks.launches,
                            mk.render_blocks.lit_launches)
                check(rc == 0, f"cli.main {label} returned {rc}")
                with open(ppm_path) as f:
                    img = read_ppm(f)
        finally:
            mk.render_blocks_reference, pipeline.render_blocks = (plain_k1,
                                                                  kernel)
        check(launches[1] > 0 and launches[0] == launches[1],
              f"cli.main {label}: {launches[1]} of {launches[0]} K1 launches "
              f"ran a lit instance")
        done = [ln for ln in log.getvalue().splitlines()
                if ln.startswith("Done")]
        return img, kept[0], wall, launches[1], done[-1], launched

    # A middle tile range of each render, relaunched with cli.main's
    # inputs (one launch a frame): the sixth tenth of its tiles.  (the
    # range's first tile, its tiles, the launch's (args, kwargs)).
    bands = {}

    def middle(launched):
        check(len(launched) == 1, f"{len(launched)} K1 launches a frame")
        (tbl, cam, meta, n_tiles), kw = launched[0]
        band = -(-n_tiles // 10)
        tile0 = 5 * band
        meta = meta[:4] + (tile0,) + meta[5:]
        return tile0, band, ((tbl, cam, meta, band), kw)

    box_flags = ["-w", str(W_LIT), "-a", "1", "-s", str(SPP_LIT), "-c",
                 str(DEPTH_LIT)]
    cover_flags = ["-w", str(W_MAIN), "-a", repr(ASPECT), "-s", "128", "-c",
                   "50"]
    lit_launches = {}
    for flag, flags in (("--cornell", box_flags), ("--smoke", box_flags),
                        ("--lights", box_flags), ("--textures", box_flags),
                        ("--checker", cover_flags)):
        img, rad, wall, n, done, launched = run_cli([flag] + flags, flag)
        check(img.shape[2] == 3 and img.std() > 10
              and bool(np.isfinite(rad).all()),
              f"{flag}: PPM shape {img.shape}, flat, or radiance not finite")
        what = ""
        if flag in ("--cornell", "--smoke"):
            inner = img[100:300, 100:300].mean()
            # The camera sees past the box's open front on every side: a
            # 5-pixel ring of rays that miss everything (black background).
            ring = np.concatenate([img[:5].ravel(), img[-5:].ravel(),
                                   img[:, :5].ravel(), img[:, -5:].ravel()])
            check(img.shape == (W_LIT, W_LIT, 3) and inner > 40
                  and ring.max() == 0,
                  f"{flag}: interior mean {inner:.1f} (want > 40), border "
                  f"ring max {ring.max()} (want 0)")
            what = f"; interior mean {inner:.1f} / 255, border ring black"
        lit_launches[flag] = n
        bands[flag] = middle(launched)
        say("15", f"cli.main {flag} {' '.join(flags)}: {n} lit K1 launches, "
                  f"{wall:.2f} s end to end (render: {done}); radiance mean "
                  f"{rad.mean():.4f}{what}")

    # ---- (16) roulette on the cover against the unbiased render ----------
    img, rad, wall, n, done, launched = run_cli(
        ["--russian-roulette"] + cover_flags, "--russian-roulette")
    check(rad.shape == cover_radiance.shape and bool(np.isfinite(rad).all()),
          "--russian-roulette: radiance shape or values")
    diff = (rad - cover_radiance).mean(axis=2).ravel()
    se = diff.std() / np.sqrt(diff.size)
    check(abs(diff.mean()) <= RR_SIGMAS * se,
          f"--russian-roulette: frame mean {rad.mean():.6f} vs unbiased "
          f"{cover_radiance.mean():.6f}: difference {diff.mean():.3g} > "
          f"{RR_SIGMAS} x its standard error {se:.3g}")
    say("16", f"cli.main --russian-roulette {' '.join(cover_flags)}: {n} lit "
              f"K1 launches, {wall:.2f} s end to end (render: {done}); frame "
              f"mean {rad.mean():.6f} vs phase 5's unbiased "
              f"{cover_radiance.mean():.6f}: difference {diff.mean():.3g} = "
              f"{diff.mean() / se:.2f} standard errors ({se:.3g}; allowed "
              f"{RR_SIGMAS})")
    bands["--russian-roulette"] = middle(launched)

    # ---- (17) a middle tile range of each render against plain ----------
    # The plain version at the renders' spp takes one to two minutes a
    # tenth of a frame, bound by the host's dispatch of its small ops: one
    # worker process per range, all at once (nothing is timed meanwhile).
    t0 = time.perf_counter()
    results = band_checks({flag: moved(launch, "cpu")
                           for flag, (_, _, launch) in bands.items()})
    lines = []
    for flag, (tile0, n_tiles, ((_, _, meta, _), _)) in bands.items():
        finite, same, err, kc, pc, seconds = results[flag]
        held(f"{flag}, tiles {tile0}..", finite, same, err, kc, pc)
        lines.append(f"{flag} (tile0 {tile0}, {n_tiles} tiles, spp "
                     f"{meta[5]}, depth {meta[6]}): counters {kc}, "
                     f"{seconds:.1f} s")
    say("17", f"a middle tenth of each render above's tiles, launched again "
              f"with cli.main's inputs, kernel vs plain on {card} "
              f"({len(bands)} worker processes, "
              f"{time.perf_counter() - t0:.1f} s wall): bit-identical with "
              f"equal counters ({K1_COUNTERS}): " + "; ".join(lines))

    # ---- (18) the lit instance's times and bound, spp 16 -----------------
    rows = {}
    for name in ("cornell", "smoke"):
        (scene, cam), _, _ = scenes[name]
        args, kw = prepared(scene, cam, 16, DEPTH_LIT, False)
        timed = lambda: mk.render_blocks(*args, **kw)  # noqa: E731
        event_ms(torch, timed)  # warm-up
        k_runs = [event_ms(torch, timed)[0] for _ in range(3)]
        k_ms = statistics.median(k_runs)
        p_ms, _ = event_ms(torch, lambda: mk.render_blocks_reference(
            *args, **kw))
        c18 = compared(f"{name} spp16", args, kw)
        steps, n_box, n_tri, n_shadow = c18[:4]
        # The work this frame's counters say it needs (k1_ops).  Bytes:
        # the scene's rows and boxes read once, the three planes written
        # once.
        tris, lit = kw["tris"], kw["lit"]
        n_sph, n_vol = scene.n_spheres, len(lit.vol_kinds)
        ops = k1_ops(c18, n_vol)
        nbytes = (n_sph * 64 + tris.count * 64 + tris.n_blocks * 32
                  + lit.rows.numel() * 4 + 3 * 4 * args[3] * 1024)
        ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound=bound, by=by)
        say("18", f"lit K1, {name} {W_LIT}x{W_LIT} spp16 depth {DEPTH_LIT} "
                  f"on {card}: kernel {k_ms:.3f} ms (median of "
                  f"{', '.join(f'{x:.3f}' for x in k_runs)}), plain "
                  f"{p_ms:.1f} ms; kernel vs plain bit-identical, counters "
                  f"equal; {steps} ray steps, {n_shadow} shadow rays, "
                  f"{n_box} box and {n_tri} triangle tests, {n_sph} spheres "
                  f"({c18[5]} group box tests, {c18[6]} rows swept); "
                  f"bound {bound:.4f} ms ({by}: {ops:.4g} float32 "
                  f"operations, {nbytes} bytes) = {bound / k_ms:.1%} of the "
                  f"kernel time")
    main_row = rows["cornell"]
    return {
        "name": "megakernel_lit",
        "route": "cuda",
        "source": "rtow_tpu_torch/csrc/megakernel.cu",
        "replaces": "rtow_tpu/ops/pallas_megakernel.py:1433",
        "launches": lit_launches["--cornell"],
        "max_abs_err": max(errs),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound"],
        "bound_by": main_row["by"],
        "library_ms": None,
    }


def mesh_grad_phases(torch, dev, card, say, event_ms):
    """Phases 19-20: K4's and K5's triangle instances against their plain
    versions at every launch of one sorted forward at the trainer's
    1,048,576 lanes (the 4,096-triangle knot over a ground sphere and the
    65,536-triangle knot, both through the hierarchy and the flat sweep),
    then mesh inverse rendering at full
    size: three ``diff.build_train_step`` steps on the 65k knot at
    256x256 spp16 depth 8 with the lanes sorted (the plain versions made
    to raise), the forward and forward+backward times on both bench
    knots, K4 and K5 timed by CUDA events with their bounds, and a
    profiled step.  Returns the triangle instances' JSON entries."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_mesh import make_knot
    import numpy as np

    from rtow_tpu_torch import diff
    from rtow_tpu_torch.models.camera import (
        camera_rays, make_camera, pixel_coords,
    )
    from rtow_tpu_torch.models.scene import SceneBuilder
    from rtow_tpu_torch.ops import grad as G
    from rtow_tpu_torch.ops import megakernel as mk

    rng = np.random.default_rng(1)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    size = W_MESH_GRAD
    n_pix = size * size
    kw = dict(width=size, height=size, spp=SPP_GRAD, max_depth=DEPTH_GRAD)

    def knot(seg, rings, ground=False):
        verts, faces = make_knot(seg, rings)
        b = SceneBuilder()
        b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
        if ground:
            b.add_sphere((0.0, -101.0, 0.0), 100.0,
                         b.add_metal((0.5, 0.5, 0.5), 0.1))
        return b.build(device=dev)

    def tape_of(scene, flat, seed=7, nee=False):
        """The sorted input states of one forward at the trainer's size
        through K4, as render_rays_kernel hands them to each bounce, and
        the tables."""
        gen = torch.Generator(dev).manual_seed(seed)
        pix = torch.arange(n_pix, device=dev).repeat_interleave(SPP_GRAD)
        s, t = pixel_coords(size, size, gen, pix)
        tape, bounce = [], G.bounce_grad

        def recorded(cont, ints, *a, **k):
            tape.append((cont, ints))
            return bounce(cont, ints, *a, **k)

        G.bounce_grad = recorded
        try:
            with torch.no_grad():
                G.render_rays_kernel(scene, camera_rays(cam, gen, s, t),
                                     n_pixels=pix.numel(), spp=1,
                                     max_depth=DEPTH_GRAD, seed=0,
                                     sort_lanes=True, force_flat=flat,
                                     nee=nee)
        finally:
            G.bounce_grad = bounce
        tbl, _ = mk.build_sphere_table(scene)
        return tbl, G.grad_tri_table(scene, flat), tape

    def counters():
        return torch.zeros(4, dtype=torch.int64, device=dev)

    # ---- (19) the triangle instances against their plain versions -------
    # Every launch of one sorted forward at the trainer's 1,048,576 lanes,
    # on the 65k knot (its hierarchy is what the trainer launches) and on
    # the 4,096-triangle knot over a ground sphere, flat and hierarchy.
    knots = {"4k": knot(64, 32, ground=True),
             "65k": knot(*KNOTS["65k"]), "360k": knot(*KNOTS["360k"])}
    lines, errs, errs_warp = [], [], []
    for name in ("4k", "65k"):
        for flat in (False, True):
            tbl, tris, tape = tape_of(knots[name], flat)
            npad, mpad = tbl.shape[0], tris.tbl.shape[0]
            worst, f64, tests, p_ms = {}, {}, [], [0.0, 0.0]
            for it, (cont, ints) in enumerate(tape):
                a = dict(it=it, seed=0, max_depth=DEPTH_GRAD, flat=flat)
                ks, ps = counters(), counters()
                kc, ki = G.bounce_fwd(cont, ints, tbl, tris, stats=ks, **a)
                ms, (pc, pi) = event_ms(torch, lambda: G.bounce_fwd_reference(
                    cont, ints, tbl, tris, stats=ps, **a))
                p_ms[0] += ms
                check(torch.equal(kc, pc) and torch.equal(ki, pi),
                      f"K4 {name} knot, flat={flat}, bounce {it}: not "
                      f"bit-identical (max |d| {float((kc - pc).abs().max())})")
                check(torch.equal(ks, ps),
                      f"K4 {name} knot, flat={flat}, bounce {it}: counted "
                      f"{ks.tolist()}, plain {ps.tolist()}")
                # K4's warp form forced, held to the plain version bit for
                # bit with equal counters.
                kw4 = counters()
                with warp_form(G, "warp"):
                    wc, wi = G.bounce_fwd(cont, ints, tbl, tris, stats=kw4,
                                          **a)
                check(torch.equal(wc, pc) and torch.equal(wi, pi)
                      and torch.equal(kw4, ps),
                      f"K4's warp form {name} knot, flat={flat}, bounce "
                      f"{it}: not bit-identical to plain (max |d| "
                      f"{float((wc - pc).abs().max())}) or counted "
                      f"{kw4.tolist()}, plain {ps.tolist()}")
                # Zero-mean cotangents, of mixed sign as the loss's
                # 2 (img - target) / N are; K5 is held to the sums of
                # |terms| (check_k5).
                cot = torch.from_numpy(rng.standard_normal(
                    tuple(cont.shape)).astype(np.float32)).to(dev)
                kb, pb = counters(), counters()
                kern = G.bounce_bwd(cont, ints, cot, tbl, tris, stats=kb, **a)

                def plain_bwd():  # bounce_bwd_reference, keeping its terms
                    ci, s_t, t_t, _ = G.bounce_bwd_terms(
                        cont, ints, cot, tbl, tris, stats=pb, **a)
                    return ((ci, G.table_sums(s_t, npad),
                             G.table_sums(t_t, mpad), None), (s_t, t_t))

                ms, (plain, terms) = event_ms(torch, plain_bwd)
                p_ms[1] += ms
                sums = {part: (G.table_sums(t, rows, torch.float64),
                               G.table_sums((t[0], t[1].abs()), rows,
                                            torch.float64))
                        for part, t, rows in zip(("g_tbl", "g_tri"), terms,
                                                 (npad, mpad))}
                res = check_k5(torch, kern, plain,
                               f"{name} knot, flat={flat}, bounce {it}",
                               sums=sums)
                check(torch.equal(kb, ks) and torch.equal(pb, ps),
                      f"K5 {name} knot, bounce {it}: its replay counted "
                      f"{kb.tolist()} / {pb.tolist()}, K4 {ks.tolist()}")
                # The warp form forced at every bounce, held to the same
                # plain version by the same rule.
                kw_ = counters()
                with warp_form(G, "warp"):
                    warp = G.bounce_bwd(cont, ints, cot, tbl, tris,
                                        stats=kw_, **a)
                res_w = check_k5(torch, warp, plain,
                                 f"{name} knot, flat={flat}, bounce {it}, "
                                 f"warp form", sums=sums)
                check(torch.equal(kw_, ks),
                      f"K5's warp form {name} knot, bounce {it}: counted "
                      f"{kw_.tolist()}, K4 {ks.tolist()}")
                errs_warp.extend(r[0] for r in res_w.values())
                for part, r in res.items():
                    worst[part] = max(worst.get(part, 0.0), r[1])
                    errs.append(r[0])
                    if len(r) > 3:
                        f64[part] = [max(x, y) for x, y in
                                     zip(f64.get(part, (0.0, 0.0)), r[3:])]
                tests.append(ks.tolist()[:3])
            if name == "65k" and not flat:  # phase 20 times the kernels here
                timed = (tbl, tris, tape, tests, p_ms)
            box = sum(t[0] for t in tests)
            tri = sum(t[1] for t in tests)
            live = sum(t[2] for t in tests)
            lines.append(
                f"{name} {'flat' if flat else 'hierarchy'} "
                f"({tris.n_blocks} blocks, {tris.n_super if not flat else 0} "
                f"supers, {tris.n_hyper if not flat else 0} hypers; "
                f"{tape[0][0].shape[1]} lanes): {live} live lane-bounces, "
                f"{box / max(live, 1):.1f} box and {tri / max(live, 1):.1f} "
                f"triangle tests per live lane-bounce; plain K4 "
                f"{p_ms[0]:.1f} ms, K5 {p_ms[1]:.1f} ms; K5 worst share of "
                f"scale " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items())
                + "; from the float64 sum, kernel / plain: " + ", ".join(
                    f"{k} {v[0]:.2g} / {v[1]:.2g}" for k, v in f64.items()))
    say("19", f"K4 / K5 triangle instances vs plain on {card}, all 9 "
              f"bounces of one forward at {size}x{size} spp{SPP_GRAD} depth "
              f"{DEPTH_GRAD} (sorted lanes): K4 bit-identical with equal "
              f"counters (box tests, triangle tests, live lanes), as picked "
              f"and in the warp form forced, K5's "
              f"replay counting the same, K5 within {GRAD_TOL} of the scale "
              f"(cot_in: its row's max |plain|; g_tbl, g_tri: the column's "
              f"largest sum of |terms|), as picked and in the warp form "
              f"forced (max |d| {max(errs_warp):.3g}); " + "; ".join(lines))

    # ---- (20) mesh inverse rendering at full size ------------------------
    scene = knots["65k"]
    pix = torch.arange(n_pix, device=dev)
    with torch.no_grad():
        target = G.render_pixels_kernel(
            scene, cam, torch.Generator(dev).manual_seed(123), pix, **kw)
    albedo = scene.materials.albedo
    noise = torch.from_numpy(rng.uniform(-PERTURB, PERTURB, albedo.shape)
                             .astype(np.float32)).to(dev)
    start = scene.replace_leaves(
        {"materials.albedo": (albedo + noise).clamp(0.0, 1.0)})
    step = diff.build_train_step(cam, lr=LR_MESH,
                                 keep=lambda p: p.endswith("albedo"), **kw)

    def refuse(*_a, **_k):
        raise CheckFailed("the mesh trainer ran a plain version on the card")

    plain = (G.bounce_fwd_reference, G.bounce_bwd_reference, G.sort_keys)
    sorts = [0]

    def counted_keys(*a, **k):
        sorts[0] += 1
        return plain[2](*a, **k)

    G.bounce_fwd_reference = G.bounce_bwd_reference = refuse
    G.sort_keys = counted_keys
    try:
        losses, cur, per_step = [], start, []
        G.bounce_fwd.launches = G.bounce_bwd.launches = 0
        G.bounce_fwd.warp_launches = G.bounce_bwd.warp_launches = 0
        t0 = time.perf_counter()
        for _ in range(3):
            cur, loss = step(cur, torch.Generator(dev).manual_seed(7), target)
            losses.append(float(loss))
            per_step.append((G.bounce_fwd.launches, G.bounce_bwd.launches,
                             sorts[0]))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        main_launches = per_step[-1][:2] + (G.bounce_bwd.warp_launches,
                                            G.bounce_fwd.warp_launches)
        _, grads = G.loss_and_grad_kernel(
            start, cam, torch.Generator(dev).manual_seed(7), target, pix,
            **kw)
    finally:
        G.bounce_fwd_reference, G.bounce_bwd_reference, G.sort_keys = plain
    want = [(k * (DEPTH_GRAD + 1),) * 3 for k in (1, 2, 3)]
    check(per_step == want,
          f"K4 / K5 launches and sorts after each mesh train step "
          f"{per_step}, not {want}")
    check(main_launches[2] == main_launches[1],
          f"K5 issued its warp form {main_launches[2]} times in "
          f"{main_launches[1]} launches")
    check(main_launches[3] == main_launches[0],
          f"K4 issued its warp form {main_launches[3]} times in "
          f"{main_launches[0]} launches")
    check(all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2],
          f"mesh trainer: loss did not fall over the steps: {losses}")
    gv = grads.triangles.verts
    check(bool(torch.isfinite(gv).all()) and float(gv.abs().max()) > 0,
          "mesh trainer: the vertex gradient is not finite and non-zero")
    err0 = float((start.materials.albedo - albedo).abs().mean())
    err3 = float((cur.materials.albedo - albedo).abs().mean())
    say("20", f"3 train steps of the 65k knot ({scene.n_triangles} "
              f"triangles) {size}x{size} spp{SPP_GRAD} depth {DEPTH_GRAD}, "
              f"lanes sorted (lr {LR_MESH}, albedo mask): loss "
              f"{', '.join(f'{x:.6g}' for x in losses)}; albedo mean |error| "
              f"{err0:.6g} -> {err3:.6g}; K4 {main_launches[0]} and K5 "
              f"{main_launches[1]} launches (the warp forms issued in "
              f"{main_launches[3]} and {main_launches[2]}), "
              f"{per_step[-1][2]} sorts, no "
              f"plain version; {train_s:.2f} s; vertex gradient max |g| "
              f"{float(gv.abs().max()):.3g}")

    for name in ("65k", "360k"):
        sc = knots[name]
        tgt = target if name == "65k" else torch.zeros_like(target)

        def fwd_call():
            with torch.no_grad():
                return G.render_pixels_kernel(
                    sc, cam, torch.Generator(dev).manual_seed(7), pix, **kw)

        def fwdbwd_call():
            return G.loss_and_grad_kernel(
                sc, cam, torch.Generator(dev).manual_seed(7), tgt, pix, **kw)

        fwd_call()  # warm-up
        loss, grads = fwdbwd_call()
        check(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.leaves().values()
            if g is not None), f"{name} knot: loss_and_grad not finite")
        fwd_runs = [wall_ms(torch, fwd_call) for _ in range(3)]
        fb_runs = [wall_ms(torch, fwdbwd_call) for _ in range(3)]
        fwd_ms, fb_ms = statistics.median(fwd_runs), statistics.median(fb_runs)
        say("20", f"the {name} knot ({sc.n_triangles} triangles) {size}x"
                  f"{size} spp{SPP_GRAD} depth {DEPTH_GRAD} on {card}: "
                  f"forward {fwd_ms:.2f} ms (median of "
                  f"{', '.join(f'{x:.2f}' for x in fwd_runs)}), "
                  f"{n_pix * SPP_GRAD / fwd_ms / 1e3:.3f} Mrays/s "
                  f"(mesh_grad_fwd_mrays); forward+backward {fb_ms:.2f} ms "
                  f"(median of {', '.join(f'{x:.2f}' for x in fb_runs)}); "
                  f"ratio {fb_ms / fwd_ms:.3f} (mesh_grad_ratio)")

    # K4 and K5 alone: one forward's and one backward's 9 launches on
    # phase 19's tape of the 65k knot, by CUDA events, beside the plain
    # versions' times on the same launches there, and the bound from the
    # counts of those launches.
    tbl, tris, tape, tests, plain_ms = timed
    n = tape[0][0].shape[1]
    cots = [torch.from_numpy(rng.standard_normal((13, n)).astype(np.float32))
            .to(dev) for _ in tape]

    def run_all(fn, bwd):
        return event_ms(torch, lambda: [
            fn(c, i, ct, tbl, tris, **a) if bwd else fn(c, i, tbl, tris, **a)
            for (c, i), ct, a in zip(
                tape, cots, [dict(it=it, seed=0, max_depth=DEPTH_GRAD)
                             for it in range(len(tape))])])

    rows = []
    for kname, kern, p_ms, bwd in (
            ("grad_fwd", G.bounce_fwd, plain_ms[0], False),
            ("grad_bwd", G.bounce_bwd, plain_ms[1], True)):
        run_all(kern, bwd)  # warm-up
        k_runs = [run_all(kern, bwd)[0] for _ in range(3)]
        k_ms = statistics.median(k_runs)
        bound = 0.0
        by_ops = by_bytes = 0
        for box, tri, live in tests:
            ops = (live * (OPS_PER_STEP + OPS_INV_DIR
                           + (OPS_BWD_EXTRA if bwd else 0))
                   + box * OPS_PER_BOX + tri * OPS_PER_TRI)
            # Bytes: the lane arrays in and out once (K5: the state and
            # the output cotangents in, the input cotangents out), at most
            # the triangle rows and boxes the launch tested, and K5's g_tri
            # written once.
            nbytes = ((16 + 13 + 13 if bwd else 16 + 16) * 4 * n
                      + min(tri, tris.count) * 64
                      + min(box, tris.n_blocks + tris.supers.shape[0]
                            + tris.hypers.shape[0]) * 32
                      + (tris.tbl.numel() * 4 if bwd else 0))
            ops_s, bytes_s = ops / PEAK_F32, nbytes / PEAK_BYTES
            bound += max(ops_s, bytes_s) * 1e3
            by_ops += ops_s >= bytes_s
            by_bytes += ops_s < bytes_s
        by = "operations" if by_ops >= by_bytes else "bytes"
        say("20", f"{kname} triangle instance on the 65k knot: "
                  f"{len(tape)} launches of {n} lanes on {card}: kernel "
                  f"{k_ms:.3f} ms (median of "
                  f"{', '.join(f'{x:.3f}' for x in k_runs)}); plain "
                  f"{p_ms:.1f} ms (phase 19); bound {bound:.3f} ms (operations in "
                  f"{by_ops} launches, bytes in {by_bytes}) = "
                  f"{bound / k_ms:.1%} of the kernel time; per launch (box "
                  f"tests, triangle tests, live lanes): {tests}")
        rows.append({
            "name": f"{kname}_tris",
            "route": "cuda",
            "source": f"rtow_tpu_torch/csrc/{kname}.cu",
            "replaces": ("rtow_tpu/ops/pallas_grad.py:224" if bwd
                         else "rtow_tpu/ops/pallas_grad.py:101"),
            "launches": main_launches[1] if bwd else main_launches[0],
            "max_abs_err": max(errs) if bwd else 0.0,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })

    # K4 and K5 launch by launch: each of the 9 launches of phase 19's
    # tape of the 65k knot, and of the 65k knot under two square lamps
    # with NEE, timed alone by CUDA events (each kernel's two forms in
    # turns: thread, warp, warp, thread; then as picked on the card),
    # beside its live lanes; the forms held to each other at every launch:
    # K4 bit for bit with equal counters (and on the lit knot, which
    # phase 19 does not run, to the plain version too), K5's cot_in bit
    # for bit, equal counters, g_tbl / g_tri / g_rows within GRAD_TOL of
    # the column's largest |thread form|.
    lit_scene = lit_knot(SceneBuilder, *make_knot(*KNOTS["65k"]), dev)
    lit_tbl, lit_tris, lit_tape = tape_of(lit_scene, False, nee=True)
    tapes = {"65k knot": (tbl, tris, tape, mk.Lit(), scene.background),
             "lit 65k knot": (lit_tbl, lit_tris, lit_tape,
                              G.grad_lit(lit_scene, nee=True),
                              lit_scene.background)}
    form_sums = {}
    for tname, (t_tbl, t_tris, t_tape, t_lit, t_bg) in tapes.items():
        launches = []
        sums = {f"{k} {f}": 0.0 for k in ("K4", "K5")
                for f in ("thread", "warp", "auto")}
        for it, (c, i) in enumerate(t_tape):
            a = dict(it=it, seed=0, max_depth=DEPTH_GRAD, lit=t_lit,
                     background=t_bg)
            fwd, st4 = {}, {}
            for form in ("auto", "thread", "warp"):
                st4[form] = counters()
                with warp_form(G, form):
                    fwd[form] = G.bounce_fwd(c, i, t_tbl, t_tris,
                                             stats=st4[form], **a)
            if tname.startswith("lit"):
                st4["plain"] = counters()
                fwd["plain"] = G.bounce_fwd_reference(
                    c, i, t_tbl, t_tris, stats=st4["plain"], **a)
            for form in fwd:
                check(all(torch.equal(x, y) for x, y in
                          zip(fwd[form], fwd["thread"]))
                      and torch.equal(st4[form], st4["thread"]),
                      f"K4 {form} form, {tname}, launch {it}: not "
                      f"bit-identical to the thread form, or counted "
                      f"{st4[form].tolist()}, the thread form "
                      f"{st4['thread'].tolist()}")
            ct = torch.from_numpy(rng.standard_normal((13, c.shape[1]))
                                  .astype(np.float32)).to(dev)
            res, st = {}, {}
            for form in ("auto", "thread", "warp"):
                st[form] = counters()
                with warp_form(G, form):
                    res[form] = G.bounce_bwd(c, i, ct, t_tbl, t_tris,
                                             stats=st[form], **a)
            ref = res["thread"]
            for form in ("warp", "auto"):
                what = f"K5 {form} form, {tname}, launch {it}"
                check(torch.equal(res[form][0], ref[0]),
                      f"{what}: cot_in not bit-identical to the thread form")
                check(torch.equal(st[form], st["thread"]),
                      f"{what}: counted {st[form].tolist()}, the thread "
                      f"form {st['thread'].tolist()}")
                for part, k_, t_ in zip(("g_tbl", "g_tri", "g_rows"),
                                        res[form][1:], ref[1:]):
                    if t_ is None or not t_.numel():
                        continue
                    scale = t_.abs().amax(dim=0, keepdim=True)
                    check(bool(((k_ - t_).abs() <= GRAD_TOL * scale).all()),
                          f"{what}: {part} off the thread form's by more "
                          f"than {GRAD_TOL} of the column's scale")
            calls = {"K4": lambda: G.bounce_fwd(c, i, t_tbl, t_tris, **a),
                     "K5": lambda: G.bounce_bwd(c, i, ct, t_tbl, t_tris,
                                                **a)}
            ms, text = {}, []
            for kname, call in calls.items():
                turns = {"thread": [], "warp": []}
                for form in ("thread", "warp", "warp", "thread"):
                    with warp_form(G, form):
                        turns[form].append(per_launch_ms(torch, call, 3))
                ms.update({f"{kname} {f}": statistics.mean(v)
                           for f, v in turns.items()})
                ms[f"{kname} auto"] = per_launch_ms(torch, call, 3)
                text.append(
                    f"{kname} thread "
                    f"{'/'.join(f'{x:.3f}' for x in turns['thread'])}, warp "
                    f"{'/'.join(f'{x:.3f}' for x in turns['warp'])}, picked "
                    f"{ms[f'{kname} auto']:.3f}")
            for k_, v in ms.items():
                sums[k_] += v
            launches.append(f"{int(st['thread'][2])} live: "
                            + "; ".join(text))
        form_sums[tname] = sums
        say("20", f"K4 / K5 per launch on the {tname} ({W_MESH_GRAD}x"
                  f"{W_MESH_GRAD} spp{SPP_GRAD}, {t_tape[0][0].shape[1]} "
                  f"lanes, sorted) on {card}, ms each launch alone (each "
                  f"kernel's forms in turns thread, warp, warp, thread, the "
                  f"picked form with WARP_MAX_LIVE {G.WARP_MAX_LIVE}); K4's "
                  f"forms bit-identical with equal counters"
                  + (" and to the plain version" if tname.startswith("lit")
                     else "")
                  + f", K5's cot_in bit-identical, counters equal, table "
                  f"gradients within {GRAD_TOL}: " + " | ".join(launches)
                  + "; sums: " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in sums.items()))
    for kname, key, row, n_warp in (
            ("grad_fwd", "K4 warp", rows[0], main_launches[3]),
            ("grad_bwd", "K5 warp", rows[1], main_launches[2])):
        rows.append({
            "name": f"{kname}_tris_warp",
            "route": "cuda",
            "source": f"rtow_tpu_torch/csrc/{kname}.cu",
            "replaces": row["replaces"],
            "launches": n_warp,
            "max_abs_err": max(errs_warp) if kname == "grad_bwd" else 0.0,
            "ms": form_sums["65k knot"][key],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })

    # Where a mesh train step's time goes: torch.profiler over one step.
    step_ms, dev_ms = profile_ms(torch, lambda: step(
        start, torch.Generator(dev).manual_seed(7), target))
    busy_ms = sum(dev_ms.values())
    parts = split_device_time(dev_ms, (("K4", "grad_fwd"),
                                       ("K5", "grad_bwd")))
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    say("20", f"one mesh train step under torch.profiler on {card}: "
              f"{step_ms:.2f} ms wall, device kernels {busy_ms:.2f} ms (busy "
              f"share {busy_ms / step_ms:.1%}): K4 {parts['K4']:.2f}, K5 "
              f"{parts['K5']:.2f}, sort {parts['sort']:.2f}, gather/scatter "
              f"{parts['gather']:.2f}, other {parts['other']:.2f} ms; by "
              f"kernel: " + "; ".join(f"{k[:40]} {ms:.3f} ms" for k, ms in top))
    return rows


def lit_grad_phases(torch, dev, card, say, event_ms):
    """Phases 21-22: K4's and K5's lit instances against their plain
    versions at every bounce of one forward (the Cornell box and
    ``light_scene`` with NEE at 400x400, ``textures_scene`` and the
    checker cover at 400x267, all spp16 depth 8), then lit inverse
    rendering at full size: three ``diff.build_train_step(nee=True)``
    steps on the Cornell box at 400x400 spp16 depth 8 from the lamp at 5
    and the red wall at 0.4 (tools/inverse_demo.py:154-160), with the
    plain versions made to raise; the forward and forward+backward
    medians, K4 and K5 by CUDA events with their bounds, and a profiled
    step.  Returns the lit instances' JSON entries."""
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models.builders import (
        cornell_scene, cover_scene, light_scene, textures_scene,
    )

    def checker_cover(aspect, device):
        return cover_scene(Config(image_width=W_LIT, aspect_ratio=aspect,
                                  checker_ground=True), device=device)

    def start(scene):
        # cornell_scene's materials: 0 white, 1 red, 2 green, 3 the lamp,
        # 4 the mirror.
        albedo = scene.materials.albedo.clone()
        albedo[3] = 5.0
        albedo[1] = 0.4
        return scene.replace_leaves({"materials.albedo": albedo})

    def moved(first, cur):
        return (f"lamp {float(first.materials.albedo[3].mean()):.4g} -> "
                f"{float(cur.materials.albedo[3].mean()):.4g}, red wall -> "
                + ", ".join(f"{x:.4g}" for x in
                            cur.materials.albedo[1].tolist()))

    return grad_feature_phases(torch, dev, card, say, event_ms, dict(
        phases=("21", "22"), what="lit", suffix="_lit",
        scenes={"cornell": (cornell_scene, 1.0, True),
                "light": (light_scene, 1.0, True),
                "textures": (textures_scene, 1.5, False),
                "checker_cover": (checker_cover, 1.5, False)},
        timed="cornell", counter="lit_launches",
        train=dict(scene="cornell", start=start, lr=LR_LIT,
                   keep=lambda p: p.endswith("albedo"),
                   about="albedo mask, the lamp from 5 toward 15, the red "
                         "wall from 0.4", moved=moved,
                   grad_ok=lambda g: float(
                       g.materials.albedo[3].abs().max()) > 0)))


def fog_light_scene(aspect, device):
    """``fog_light_setup`` of tests/test_pallas_grad_volumes.py: a fog ball
    ("s") and a sphere light over a gray ground, black background."""
    from rtow_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    g = b.add_lambertian((0.5, 0.5, 0.5))
    lamp = b.add_light((6.0, 5.0, 4.0))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, g)
    b.add_sphere((0.8, 2.2, -0.6), 0.35, lamp)
    b.add_fog_sphere((0.0, 0.4, -1.0), 0.6, density=2.0,
                     albedo=(0.8, 0.7, 0.6))
    return (b.build(background=(0.0, 0.0, 0.0), device=device),
            fog_camera(aspect, device))


def fog_box_scene(aspect, device):
    """An unrotated fog box ("b") over the same ground under the sky."""
    from rtow_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.add_lambertian((0.5,) * 3))
    b.add_fog_box((-0.5, -0.2, -1.5), (0.5, 0.9, -0.5), 2.0,
                  albedo=(0.8, 0.7, 0.6))
    return b.build(device=device), fog_camera(aspect, device)


def fog_camera(aspect, device):
    from rtow_tpu_torch.models.camera import make_camera

    return make_camera(lookfrom=(0.0, 0.5, 1.8), lookat=(0.0, 0.3, -1.0),
                       fov_degrees=55.0, aspect_ratio=aspect, aperture=0.0,
                       focus_dist=1.0, device=device)


def vol_grad_phases(torch, dev, card, say, event_ms):
    """Phases 23-24: K4's and K5's media (their lit instances with the
    free-flight event, NEE from it and the shadow rays' transmittance)
    against their plain versions at every bounce of one forward (the smoke
    box with and without NEE, the fog ball under a sphere light with NEE,
    a fog box under the sky; all 400x400 spp16 depth 8), then media
    inverse rendering at full size: three
    ``diff.build_train_step(nee=True)`` steps on the smoke box from its
    densities doubled and the white fog's albedo at 0.6, training the
    densities and albedos, with the plain versions made to raise; the
    forward and forward+backward medians, K4 and K5 by CUDA events with
    their bounds, and a profiled step.  Returns the media's JSON
    entries."""
    from rtow_tpu_torch.models.builders import smoke_scene

    def start(scene):
        v = scene.volumes
        albedo = v.albedo.clone()
        albedo[1] = 0.6  # the white fog
        return scene.replace_leaves({"volumes.density": v.density * 2.0,
                                     "volumes.albedo": albedo})

    def moved(first, cur):
        return (f"densities {first.volumes.density.tolist()} -> "
                + ", ".join(f"{x:.5g}" for x in cur.volumes.density.tolist())
                + ", white fog albedo 0.6 -> " + ", ".join(
                    f"{x:.5g}" for x in cur.volumes.albedo[1].tolist()))

    return grad_feature_phases(torch, dev, card, say, event_ms, dict(
        phases=("23", "24"), what="media", suffix="_vol",
        scenes={"smoke_nee": (smoke_scene, 1.0, True),
                "smoke": (smoke_scene, 1.0, False),
                "fog_light": (fog_light_scene, 1.0, True),
                "fog_box": (fog_box_scene, 1.0, False)},
        timed="smoke_nee", counter="vol_launches",
        train=dict(scene="smoke_nee", start=start, lr=LR_VOL,
                   keep=lambda p: p in ("volumes.density", "volumes.albedo"),
                   about="densities and albedos, the densities from twice "
                         "theirs, the white fog's albedo from 0.6",
                   moved=moved,
                   grad_ok=lambda g: bool(
                       (g.volumes.density.abs() > 0).all())
                   and float(g.volumes.albedo.abs().max()) > 0)))


def grad_feature_phases(torch, dev, card, say, event_ms, spec):
    """Two phases of one feature of the gradient kernels (``spec``: its
    phase numbers, scenes (name -> (builder, aspect, nee)) and trainer):
    K4's and K5's instances against their plain versions at every bounce
    of one forward on each scene at W_LIT wide, spp16 depth 8 (K4 bit for
    bit with equal counters, K5 by check_k5 under same-sign cotangents,
    wrong g_rows planted and refused each time; both kernels timed on
    the forward's launches), then three ``diff.build_train_step(nee=...)``
    steps of the trainer's scene at full size with the plain versions
    made to raise (9 launches of each kernel a step, all counted in
    ``spec["counter"]``, and a falling loss), the forward and
    forward+backward medians, K4 and K5 by CUDA events on the timed
    scene's tape with their bounds, and a profiled step.  Returns the two
    JSON entries."""
    import numpy as np

    from rtow_tpu_torch import diff
    from rtow_tpu_torch.models.camera import camera_rays, pixel_coords
    from rtow_tpu_torch.ops import grad as G
    from rtow_tpu_torch.ops import megakernel as mk

    p_cmp, p_train = spec["phases"]
    what = spec["what"]
    rng = np.random.default_rng(2)
    scenes = spec["scenes"]

    def setup(name):
        build, aspect, nee = scenes[name]
        scene, cam = build(aspect, device=dev)
        width, height = W_LIT, int(round(W_LIT / aspect))
        lit = G.grad_lit(scene, nee)
        tbl, _ = mk.build_sphere_table(scene)
        tris = G.grad_tri_table(scene) if scene.n_triangles else None
        return scene, cam, width, height, lit, tbl, tris, nee

    def tape_of(scene, cam, width, height, lit, tbl, tris, seed=7):
        """The (depth + 1) input states of one forward through K4 from
        the camera, as render_rays_kernel hands them to each bounce."""
        gen = torch.Generator(dev).manual_seed(seed)
        pix = torch.arange(width * height,
                           device=dev).repeat_interleave(SPP_GRAD)
        s, t = pixel_coords(width, height, gen, pix)
        cont, ints = G.lane_state(camera_rays(cam, gen, s, t), pix.numel(),
                                  dev)
        tape = []
        for it in range(DEPTH_GRAD + 1):
            tape.append((cont, ints))
            cont, ints = G.bounce_fwd(cont, ints, tbl, tris, it=it, seed=0,
                                      max_depth=DEPTH_GRAD, lit=lit,
                                      background=scene.background)
        return tape

    def counters():
        return torch.zeros(4, dtype=torch.int64, device=dev)

    def kernel_ms(scene, tbl, tris, lit, tape):
        """Medians of 3 (after a warm-up) of K4's and K5's (depth + 1)
        launches on ``tape`` (K5 under standard-normal cotangents), each
        set issued back to back between one pair of CUDA events, as the
        trainer issues them -> ((K4 ms, runs), (K5 ms, runs))."""
        n = tape[0][0].shape[1]
        cots = [torch.from_numpy(rng.standard_normal((13, n))
                                 .astype(np.float32)).to(dev) for _ in tape]
        args = [dict(it=it, seed=0, max_depth=DEPTH_GRAD, lit=lit,
                     background=scene.background)
                for it in range(len(tape))]
        out = []
        for kern, bwd in ((G.bounce_fwd, False), (G.bounce_bwd, True)):
            def run():
                return event_ms(torch, lambda: [
                    kern(c, i, ct, tbl, tris, **a) if bwd
                    else kern(c, i, tbl, tris, **a)
                    for (c, i), ct, a in zip(tape, cots, args)])[0]
            run()  # warm-up
            runs = [run() for _ in range(3)]
            out.append((statistics.median(runs), runs))
        return out

    # ---- the instances against their plain versions ---------------------
    lines, errs, timed, planted = [], [], {}, []
    for name in scenes:
        scene, cam, width, height, lit, tbl, tris, _nee = setup(name)
        tape = tape_of(scene, cam, width, height, lit, tbl, tris)
        npad = tbl.shape[0]
        worst, f64, counts, p_ms, coherent = {}, {}, [], [0.0, 0.0], 0
        for it, (cont, ints) in enumerate(tape):
            a = dict(it=it, seed=0, max_depth=DEPTH_GRAD, lit=lit,
                     background=scene.background)
            ks, ps = counters(), counters()
            kc, ki = G.bounce_fwd(cont, ints, tbl, tris, stats=ks, **a)
            ms, (pc, pi) = event_ms(torch, lambda: G.bounce_fwd_reference(
                cont, ints, tbl, tris, stats=ps, **a))
            p_ms[0] += ms
            check(torch.equal(kc, pc) and torch.equal(ki, pi),
                  f"K4 {what} {name}, bounce {it}: not bit-identical (max "
                  f"|d| {float((kc - pc).abs().max())})")
            check(torch.equal(ks, ps),
                  f"K4 {what} {name}, bounce {it}: counted {ks.tolist()}, "
                  f"plain {ps.tolist()}")
            # Same-sign cotangents: a row's entry then sums its lanes'
            # terms without random cancellation (the emission columns' terms
            # all share one sign), so check_rows holds it to its own value.
            cot = torch.from_numpy(np.abs(rng.standard_normal(
                tuple(cont.shape))).astype(np.float32)).to(dev)
            kb, pb = counters(), counters()
            kern = G.bounce_bwd(cont, ints, cot, tbl, tris, stats=kb, **a)

            def plain_bwd():  # bounce_bwd_reference, keeping its terms
                ci, s_t, t_t, l_t = G.bounce_bwd_terms(
                    cont, ints, cot, tbl, tris, stats=pb, **a)
                return ((ci, G.table_sums(s_t, npad),
                         None if t_t is None
                         else G.table_sums(t_t, tris.tbl.shape[0]),
                         None if l_t is None else l_t.sum(dim=0)),
                        (s_t, t_t, l_t))

            ms, (plain, (s_t, t_t, l_t)) = event_ms(torch, plain_bwd)
            p_ms[1] += ms
            sums = {"g_tbl": (G.table_sums(s_t, npad, torch.float64),
                              G.table_sums((s_t[0], s_t[1].abs()), npad,
                                           torch.float64))}
            if t_t is not None:
                rows = tris.tbl.shape[0]
                sums["g_tri"] = (G.table_sums(t_t, rows, torch.float64),
                                 G.table_sums((t_t[0], t_t[1].abs()), rows,
                                              torch.float64))
            if l_t is not None:
                sums["g_rows"] = (l_t.double().sum(dim=0),
                                  l_t.double().abs().sum(dim=0))
            del l_t
            res = check_k5(torch, kern, plain, f"{what} {name}, bounce {it}",
                           sums=sums)
            check(torch.equal(kb, ks) and torch.equal(pb, ps),
                  f"K5 {what} {name}, bounce {it}: its replay counted "
                  f"{kb.tolist()} / {pb.tolist()}, K4 {ks.tolist()}")
            if "g_rows" in res:
                coherent += res["g_rows"][3]
                res["g_rows"] = res["g_rows"][:3] + res["g_rows"][4:]
                if it == 0:  # the rule must refuse a wrong sum
                    planted.append(plant_faults(
                        torch, kern[3], plain[3], sums["g_rows"], name,
                        vol_row0=lit.vol_row0 if lit.vol_kinds else None))
            for part, r in res.items():
                worst[part] = max(worst.get(part, 0.0), r[1])
                errs.append(r[0])
                if len(r) > 3:
                    f64[part] = [max(x, y) for x, y in
                                 zip(f64.get(part, (0.0, 0.0)), r[3:])]
            counts.append(ks.tolist())
        (k4_ms, _), (k5_ms, _) = kernel_ms(scene, tbl, tris, lit, tape)
        if name == spec["timed"]:  # the next phase times the kernels here
            timed = (scene, tbl, tris, lit, tape, counts, p_ms)
        live = sum(c[2] for c in counts)
        shadows = sum(c[3] for c in counts)
        lines.append(
            f"{name} ({tape[0][0].shape[1]} lanes, {len(lit.nee_kinds)} "
            f"lights, {len(lit.vol_kinds)} volumes "
            f"{''.join(lit.vol_kinds)}, checker {lit.checker}): {live} live "
            f"lane-bounces, {shadows} shadow rays, "
            f"{sum(c[1] for c in counts)} triangle tests; {coherent} "
            f"coherent row entries; K4 {k4_ms:.3f} ms, K5 {k5_ms:.3f} ms "
            f"(its {len(tape)} launches, median of 3); plain K4 "
            f"{p_ms[0]:.1f} ms, K5 {p_ms[1]:.1f} ms; K5 worst share of "
            f"scale " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items())
            + "; from the float64 sum, kernel / plain: " + ", ".join(
                f"{k} {v[0]:.2g} / {v[1]:.2g}" for k, v in f64.items()))
    say(p_cmp, f"K4 / K5 {what} instances vs plain on {card}, all "
               f"{DEPTH_GRAD + 1} bounces of one forward at spp{SPP_GRAD} "
               f"depth {DEPTH_GRAD}: K4 bit-identical with equal counters "
               f"(box tests, triangle tests, live lanes, shadow rays), K5's "
               f"replay counting the same, K5 within {GRAD_TOL} of the "
               f"scale (cot_in: its row's max |plain|; g_tbl, g_tri: the "
               f"column's largest sum of |terms|; g_rows: each entry's own "
               f"float64 sum, or {ROWS_CANCEL} of its sum of |terms| where "
               f"that cancels), same-sign cotangents; " + "; ".join(lines)
               + "; wrong sums planted at bounce 0, each refused: "
               + ", ".join(planted))

    # ---- the trainer at full size -------------------------------------------
    tr = spec["train"]
    scene, cam, width, height, lit, tbl, tris, nee = setup(tr["scene"])
    n_pix = width * height
    pix = torch.arange(n_pix, device=dev)
    kw = dict(width=width, height=height, spp=SPP_GRAD,
              max_depth=DEPTH_GRAD, nee=nee)
    with torch.no_grad():
        target = G.render_pixels_kernel(
            scene, cam, torch.Generator(dev).manual_seed(123), pix, **kw)
    start = tr["start"](scene)
    step = diff.build_train_step(cam, lr=tr["lr"], keep=tr["keep"], **kw)

    def refuse(*_a, **_k):
        raise CheckFailed(f"the {what} trainer ran a plain version on the "
                          f"card")

    counter = spec["counter"]
    plain = (G.bounce_fwd_reference, G.bounce_bwd_reference)
    G.bounce_fwd_reference = G.bounce_bwd_reference = refuse
    try:
        losses, cur, per_step = [], start, []
        for f in (G.bounce_fwd, G.bounce_bwd):
            f.launches = 0
            setattr(f, counter, 0)
        t0 = time.perf_counter()
        for _ in range(3):
            cur, loss = step(cur, torch.Generator(dev).manual_seed(7), target)
            losses.append(float(loss))
            per_step.append((G.bounce_fwd.launches, G.bounce_bwd.launches,
                             getattr(G.bounce_fwd, counter),
                             getattr(G.bounce_bwd, counter)))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        main_launches = per_step[-1][2:]

        def fwd_call():
            with torch.no_grad():
                return G.render_pixels_kernel(
                    scene, cam, torch.Generator(dev).manual_seed(7), pix,
                    **kw)

        def fwdbwd_call():
            return G.loss_and_grad_kernel(
                start, cam, torch.Generator(dev).manual_seed(7), target, pix,
                **kw)

        fwd_call()  # warm-up
        loss, grads = fwdbwd_call()
        fwd_runs = [wall_ms(torch, fwd_call) for _ in range(3)]
        fb_runs = [wall_ms(torch, fwdbwd_call) for _ in range(3)]
        step_ms, dev_ms = profile_ms(torch, lambda: step(
            start, torch.Generator(dev).manual_seed(7), target))
    finally:
        G.bounce_fwd_reference, G.bounce_bwd_reference = plain
    want = [(k * (DEPTH_GRAD + 1),) * 4 for k in (1, 2, 3)]
    check(per_step == want,
          f"K4 / K5 launches and {counter} after each {what} train step "
          f"{per_step}, not {want}")
    check(all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2],
          f"{what} trainer: loss did not fall over the steps: {losses}")
    check(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.leaves().values()
        if g is not None) and tr["grad_ok"](grads),
        f"{what} trainer: loss_and_grad not finite, or a trained leaf "
        f"without a gradient")
    fwd_ms, fb_ms = statistics.median(fwd_runs), statistics.median(fb_runs)
    say(p_train, f"3 train steps of {tr['scene']} {width}x{height} "
                 f"spp{SPP_GRAD} depth {DEPTH_GRAD}, nee={nee} (lr "
                 f"{tr['lr']}, {tr['about']}): loss "
                 f"{', '.join(f'{x:.6g}' for x in losses)}; "
                 f"{tr['moved'](start, cur)}; K4 {main_launches[0]} and K5 "
                 f"{main_launches[1]} launches, all counted in {counter}, no "
                 f"plain version; {train_s:.2f} s")
    say(p_train, f"on {card}: forward {fwd_ms:.2f} ms (median of "
                 f"{', '.join(f'{x:.2f}' for x in fwd_runs)}), "
                 f"{n_pix * SPP_GRAD / fwd_ms / 1e3:.3f} Mrays/s; "
                 f"forward+backward {fb_ms:.2f} ms (median of "
                 f"{', '.join(f'{x:.2f}' for x in fb_runs)}); grad_ratio "
                 f"{fb_ms / fwd_ms:.3f}")
    busy_ms = sum(dev_ms.values())
    parts = split_device_time(dev_ms, (("K4", "grad_fwd"),
                                       ("K5", "grad_bwd")))
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    say(p_train, f"one {what} train step under torch.profiler on {card}: "
                 f"{step_ms:.2f} ms wall, device kernels {busy_ms:.2f} ms "
                 f"(idle share {1 - busy_ms / step_ms:.1%}): K4 "
                 f"{parts['K4']:.2f}, K5 {parts['K5']:.2f}, other "
                 f"{parts['other'] + parts['sort'] + parts['gather']:.2f} "
                 f"ms; by kernel: " + "; ".join(f"{k[:40]} {ms:.3f} ms"
                                                for k, ms in top))

    # K4 and K5 alone: one forward's and one backward's 9 launches on the
    # timed scene's tape, by CUDA events, beside the plain versions' times
    # on the same launches there, and the bound from the counts of those
    # launches.
    scene, tbl, tris, lit, tape, counts, plain_ms = timed
    n = tape[0][0].shape[1]
    n_sph = scene.n_spheres
    n_vol = len(lit.vol_kinds)
    rows = []
    for kname, (k_ms, k_runs), p_ms, bwd in zip(
            ("grad_fwd", "grad_bwd"), kernel_ms(scene, tbl, tris, lit, tape),
            plain_ms, (False, True)):
        bound = 0.0
        by_ops = by_bytes = 0
        for box, tri, live, shadows in counts:
            # Per live lane-bounce the step and the sphere sweep, the ray's
            # inverse directions for the triangle sweep, and per volume its
            # interval and free flight; per box and triangle test (both
            # sweeps) their unconditional part; per shadow ray its light
            # sample, MIS weight and contribution, its sphere sweep and per
            # volume the transmittance's interval; K5 adds the shade's
            # cheapest adjoint per lane, and per shadow ray and per volume
            # the replay and an adjoint at least as long.
            twice = 2 if bwd else 1
            ops = (live * (OPS_PER_STEP + OPS_INV_DIR + OPS_PER_ROW * n_sph
                           + OPS_PER_VOL * n_vol * twice
                           + (OPS_BWD_EXTRA if bwd else 0))
                   + box * OPS_PER_BOX + tri * OPS_PER_TRI
                   + shadows * ((OPS_NEE + OPS_PER_VOL * n_vol) * twice
                                + OPS_PER_ROW * n_sph))
            # Bytes: the lane arrays in and out once (K5: the state and the
            # output cotangents in, the input cotangents out), the tables
            # and rows in once, K5's table gradients out once.
            tables = (tbl.numel() + lit.rows.numel() + (
                0 if tris is None
                else tris.tbl.numel() + tris.boxes.numel())) * 4
            nbytes = ((16 + 13 + 13 if bwd else 16 + 16) * 4 * n
                      + tables * (2 if bwd else 1))
            ops_s, bytes_s = ops / PEAK_F32, nbytes / PEAK_BYTES
            bound += max(ops_s, bytes_s) * 1e3
            by_ops += ops_s >= bytes_s
            by_bytes += ops_s < bytes_s
        by = "operations" if by_ops >= by_bytes else "bytes"
        say(p_train, f"{kname} {what} instance on {spec['timed']}: "
                     f"{len(tape)} launches of {n} lanes on {card}: kernel "
                     f"{k_ms:.3f} ms (median of "
                     f"{', '.join(f'{x:.3f}' for x in k_runs)}); plain "
                     f"{p_ms:.1f} ms (phase {p_cmp}); bound {bound:.3f} ms "
                     f"(operations in {by_ops} launches, bytes in "
                     f"{by_bytes}) = {bound / k_ms:.1%} of the kernel time; "
                     f"per launch (box tests, triangle tests, live lanes, "
                     f"shadow rays): {counts}")
        rows.append({
            "name": f"{kname}{spec['suffix']}",
            "route": "cuda",
            "source": f"rtow_tpu_torch/csrc/{kname}.cu",
            "replaces": ("rtow_tpu/ops/pallas_grad.py:224" if bwd
                         else "rtow_tpu/ops/pallas_grad.py:101"),
            "launches": main_launches[1] if bwd else main_launches[0],
            "max_abs_err": max(errs) if bwd else 0.0,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    return rows


def lit_mesh_phases(torch, dev, card, say, event_ms):
    """Phases 25-27: K3's lit instance against its plain version at every
    launch of the centre chunk of the lit 65k knot and of the 65k knot
    with roulette under the sky, timed there; the lit knot at 400x400
    spp64 depth 8 through ``render_wavefront`` and ``cli.main -l ...
    --russian-roulette``; K1 and K3 with two-sided triangles against
    their plain versions on a knot wound away from the camera.  Returns
    the lit instances' JSON entries, the thread and warp forms (the lit
    knot's chunk)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_mesh import make_knot

    import numpy as np

    from rtow_tpu_torch import cli
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models.camera import make_camera
    from rtow_tpu_torch.models.scene import SceneBuilder
    from rtow_tpu_torch.ops import flat_bounce as fb
    from rtow_tpu_torch.ops import megakernel as mk
    from rtow_tpu_torch.ops import wavefront as wf
    from rtow_tpu_torch.utils.ppm import read_ppm

    verts, faces = make_knot(*KNOTS["65k"])
    lit_scene = lit_knot(SceneBuilder, verts, faces, dev)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    sky_scene = b.build(device=dev)
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0, device=dev)
    lit_cfg = Config(image_width=W_MESH, aspect_ratio=1.0,
                     samples_per_pixel=SPP_MESH,
                     max_child_rays=DEPTH_KNOT_LIT)
    rr_cfg = Config(image_width=W_MESH, aspect_ratio=1.0,
                    samples_per_pixel=SPP_MESH, max_child_rays=DEPTH_MESH,
                    russian_roulette=True)
    ppc, n_chunks = wf.chunk_plan(lit_cfg)
    perm = torch.from_numpy(wf._morton_pixel_perm(W_MESH, W_MESH)
                            .astype("int64")).to(dev)
    centre = W_MESH // 2 * W_MESH + W_MESH // 2
    g_mid = int((perm == centre).nonzero()) // ppc
    mid_pixels = perm[g_mid * ppc:(g_mid + 1) * ppc]

    def refuse(*_a, **_k):
        raise CheckFailed("the lit mesh path ran K3's plain version on the "
                          "card")

    # ---- (25) K3's lit instance against its plain version ----------------
    rows = {}
    for name, scene, cfg, roulette in (
            ("lit 65k knot", lit_scene, lit_cfg, False),
            ("65k knot with roulette under the sky", sky_scene, rr_cfg,
             True)):
        depth = cfg.max_child_rays
        seed = cfg.seed + g_mid * 7919  # render_wavefront's chunk salt
        tables, tape = k3_tape(torch, dev, wf, scene, cam, cfg, g_mid,
                               mid_pixels, seed, SPP_MESH, depth,
                               roulette=roulette)
        check(tables.lit.any, f"{name}: no lit feature")
        before = fb.bounce_step.lit_launches, fb.bounce_step.launches
        r = k3_held(torch, dev, fb, f"lit K3, {name}, chunk {g_mid}", scene,
                    tables, tape, seed, depth)
        lit_n = fb.bounce_step.lit_launches - before[0]
        check(lit_n == fb.bounce_step.launches - before[1] > 0,
              f"{name}: {lit_n} of the launches ran the lit instance")
        box, tri, live, shadows = r["total"]
        codes = sum(int((state[13] == 2).sum()) for state, _ in tape)
        check((shadows > 0) == (codes > 0) == bool(tables.lit.nee_kinds),
              f"{name}: {shadows} shadow rays, {codes} lanes at alive code 2")
        rows[name] = r
        tt = tables.tris
        say("25", f"lit K3 on chunk {g_mid} of the {name} ({tt.count} "
                  f"triangles, {tt.n_blocks} blocks of {tt.block}, "
                  f"{tt.n_super} supers, {tt.n_hyper} hypers; spp "
                  f"{SPP_MESH}, depth {depth}; {tape[0][0].shape[1]} lanes, "
                  f"{len(tape)} launches) on {card}: both forms and the "
                  f"plain version bit-identical at every launch, counters "
                  f"equal ({box} box tests, {tri} triangle tests, {live} live "
                  f"lane-bounces, {shadows} shadow rays; {codes} lanes "
                  f"entered a bounce at alive code 2); " + k3_line(r))

    # ---- (26) the lit knot through render_wavefront, and cli.main -l -----
    frame = lambda: wf.render_wavefront(lit_scene, cam, lit_cfg)  # noqa: E731
    plain_k3 = fb.bounce_step_reference
    fb.bounce_step_reference = refuse
    log = io.StringIO()
    try:
        frame()  # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = frame()
            walls.append(time.perf_counter() - t0)
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        shadows = torch.zeros(1, dtype=torch.int64, device=dev)
        fb.bounce_step.launches = fb.bounce_step.lit_launches = 0
        mk.render_blocks.launches = fb.bounce_step.warp_launches = 0
        counted = wf.render_wavefront(lit_scene, cam, lit_cfg, stats=stats,
                                      shadows=shadows)
        frame_launches = fb.bounce_step.launches
        frame_warp = fb.bounce_step.warp_launches
        check(frame_launches > frame_warp > 0
              and fb.bounce_step.lit_launches == frame_launches
              and mk.render_blocks.launches == 0,
              f"lit knot frame: {fb.bounce_step.lit_launches} lit of "
              f"{frame_launches} K3 launches ({frame_warp} the warp form), "
              f"{mk.render_blocks.launches} of K1")
        check(np.array_equal(counted, img), "two lit knot frames differ")
        f_wall, f_dev = profile_ms(torch, frame)
        tables, bmin, inv_ext = wf.scene_tables(lit_scene)
        c_wall, c_dev = profile_ms(torch, lambda: wf.trace_wavefront_sorted(
            tables, cam, wf.chunk_generator(dev, lit_cfg.seed, g_mid),
            mid_pixels, lit_cfg.seed + g_mid * 7919, spp=SPP_MESH,
            max_depth=DEPTH_KNOT_LIT, width=W_MESH, height=W_MESH,
            bmin=bmin, inv_ext=inv_ext, background=lit_scene.background))
        with tempfile.TemporaryDirectory() as tmp:
            obj = os.path.join(tmp, "knot65k.obj")
            with open(obj, "w") as f:
                f.writelines(f"v {a:.6f} {b:.6f} {c:.6f}\n"
                             for a, b, c in verts)
                f.writelines(f"f {a} {b} {c}\n" for a, b, c in faces + 1)
            ppm_path = os.path.join(tmp, "rr.ppm")
            fb.bounce_step.launches = fb.bounce_step.lit_launches = 0
            mk.render_blocks.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(log):
                rc = cli.main(["-l", obj, "--russian-roulette", "-w",
                               str(W_MESH), "-a", "1", "-s", str(SPP_MESH),
                               "-c", str(DEPTH_MESH), "-o", ppm_path])
            cli_wall = time.perf_counter() - t0
            cli_launches = (fb.bounce_step.launches,
                            fb.bounce_step.lit_launches,
                            mk.render_blocks.launches)
            check(rc == 0, f"cli.main -l --russian-roulette returned {rc}")
            with open(ppm_path) as f:
                ppm = read_ppm(f)
    finally:
        fb.bounce_step_reference = plain_k3
    check(img.shape == (W_MESH, W_MESH, 3) and bool(np.isfinite(img).all())
          and img.min() == 0.0 and img.mean() > 0.01,
          f"lit knot: shape {img.shape}, min {img.min()}, mean {img.mean()} "
          f"(want black where the rays miss, light elsewhere)")
    check(cli_launches[0] > 0 and cli_launches[1] == cli_launches[0]
          and cli_launches[2] == 0,
          f"cli.main --russian-roulette: {cli_launches[1]} lit of "
          f"{cli_launches[0]} K3 launches, {cli_launches[2]} of K1")
    check(ppm.shape == (W_MESH, W_MESH, 3) and ppm.std() > 10,
          f"cli.main --russian-roulette: PPM shape {ppm.shape} or flat")
    wall = statistics.median(walls)
    parts, busy = split_device_time(f_dev), sum(f_dev.values())
    c_parts, c_busy = split_device_time(c_dev), sum(c_dev.values())
    box, tri, live = stats.tolist()
    done = [ln for ln in log.getvalue().splitlines() if ln.startswith("Done")]
    say("26", f"the lit 65k knot {W_MESH}x{W_MESH} spp{SPP_MESH} depth "
              f"{DEPTH_KNOT_LIT} through render_wavefront ({n_chunks} chunks "
              f"of {ppc} pixels) on {card}: {wall:.3f} s a frame (median of "
              f"{', '.join(f'{x:.3f}' for x in walls)}), "
              f"{W_MESH * W_MESH * SPP_MESH / wall / 1e6:.2f} Mrays/s; "
              f"{frame_launches} K3 launches, all lit, {frame_warp} of them "
              f"the warp form; {int(shadows)} shadow "
              f"rays, {live} live lane-bounces, {box} box and {tri} triangle "
              f"tests a frame; radiance mean {img.mean():.4f}.  One frame "
              f"under torch.profiler: {f_wall:.1f} ms wall, device "
              f"{busy:.1f} ms (idle share {1 - busy / f_wall:.1%}): K3 "
              f"{parts['K3']:.1f}, sort {parts['sort']:.1f}, gather/scatter "
              f"{parts['gather']:.1f}, other {parts['other']:.1f}.  Chunk "
              f"{g_mid} (the centre): {c_wall:.1f} ms wall, device "
              f"{c_busy:.1f} ms (idle share {1 - c_busy / c_wall:.1%}): K3 "
              f"{c_parts['K3']:.2f}, sort {c_parts['sort']:.2f}, "
              f"gather/scatter {c_parts['gather']:.2f}, other "
              f"{c_parts['other']:.2f}.  cli.main -l <65k knot OBJ> "
              f"--russian-roulette -w {W_MESH} -a 1 -s {SPP_MESH} -c "
              f"{DEPTH_MESH}: {cli_launches[0]} K3 launches, all lit, 0 of "
              f"K1, {cli_wall:.2f} s end to end (render: {done[-1]}); PPM "
              f"mean {ppm.mean():.1f} / 255")

    # ---- (27) two-sided triangles: K1 and K3 with cull=False -------------
    small_v, small_f = make_knot(64, 32)  # 4,096 triangles: K1
    k1_scene = lit_knot(SceneBuilder, small_v, small_f, dev, reverse=True)
    tbl, tris = mk.scene_k1_tables(k1_scene)
    args = (tbl, mk.pack_camera(cam),
            mk.pack_meta(0, width=W_MESH, height=W_MESH, spp=2,
                         max_depth=DEPTH_KNOT_LIT),
            mk.n_tiles_for(W_MESH, W_MESH))
    kw = dict(background=k1_scene.background, tris=tris,
              lit=mk.scene_lit(k1_scene), pool=False)
    two_sided = lambda: mk.render_blocks(*args, **kw, cull=False)  # noqa
    event_ms(torch, two_sided)  # warm-up
    k1_ms = statistics.median(event_ms(torch, two_sided)[0]
                              for _ in range(3))
    times = []
    k, kc = k1_held(torch, mk, dev, "two-sided", args, dict(kw, cull=False),
                    times)
    k1_plain_ms = times[1]
    culled = torch.stack(mk.render_blocks(*args, **kw))
    check(not torch.equal(k, culled) and float(k.mean()) > 0,
          "two-sided K1: the render equals the culled one, or is black")
    rev_scene = lit_knot(SceneBuilder, verts, faces, dev, reverse=True)
    seed = lit_cfg.seed + g_mid * 7919
    tables, tape = k3_tape(torch, dev, wf, rev_scene, cam, lit_cfg, g_mid,
                           mid_pixels, seed, SPP_MESH, DEPTH_KNOT_LIT,
                           cull=False)
    r = k3_held(torch, dev, fb, f"two-sided K3, chunk {g_mid}", rev_scene,
                tables, tape, seed, DEPTH_KNOT_LIT, cull=False)
    check(r["total"][3] > 0, "two-sided K3: no shadow rays")
    say("27", f"two-sided triangles (cull=False), the lit knot wound away "
              f"from the camera, on {card}: K1 on the 4,096-triangle knot "
              f"{W_MESH}x{W_MESH} spp2 depth {DEPTH_KNOT_LIT}: kernel and "
              f"plain bit-identical, counters equal {kc} ({K1_COUNTERS}), "
              f"the culled render differs; "
              f"kernel {k1_ms:.3f} ms (median of 3), plain {k1_plain_ms:.1f} "
              f"ms.  K3 on chunk {g_mid} of the 65k knot ({len(tape)} "
              f"launches): both forms bit-identical at every launch, "
              f"counters equal {r['total']} (box tests, triangle tests, live "
              f"lanes, shadow rays); " + k3_line(r))
    rows["two-sided"] = r
    return k3_entries("flat_bounce_lit", rows["lit 65k knot"],
                      rows.values(), frame_launches, frame_warp)


def pool_phases(torch, dev, card, say, event_ms):
    """Phases 28-29: the pool instances of K1 against the plain pool on
    every K1 instance, bit for bit with equal counters; the pool's sample
    accounting at the main path's size; pool against classic as one
    estimator; the two schedulers' A/B on three scenes with their
    occupancy.  Returns {"max_abs_err": ...} of phase 28."""
    import numpy as np

    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models import builders as B
    from rtow_tpu_torch.models.camera import make_camera
    from rtow_tpu_torch.models.scene import SceneBuilder
    from rtow_tpu_torch.ops import megakernel as mk

    small_obj = os.path.join(ROOT, "samples", "knot_small.obj")

    def cover(width, height, **kw):
        return B.cover_scene(Config(image_width=width,
                                    aspect_ratio=width / height, **kw),
                             device=dev)

    def knot(width):
        return B.mesh_scene(Config(model=small_obj, image_width=width,
                                   aspect_ratio=1.0), device=dev)

    def launch_args(scene, cam, width, height, spp, depth, roulette=False,
                    **kw):
        tbl, tris = mk.scene_k1_tables(scene)
        args = (tbl, mk.pack_camera(cam),
                mk.pack_meta(0, width=width, height=height, spp=spp,
                             max_depth=depth),
                mk.n_tiles_for(width, height))
        return args, dict(background=scene.background, tris=tris,
                          lit=mk.scene_lit(scene, roulette), **kw)

    # ---- (28) the pool against its plain version, every K1 instance ------
    # Reduced frames (POOL_COVER, POOL_SQUARE, POOL_SPP).  Bit-identical
    # sums and equal counters (the lane slots are 128 x each row's
    # iterations: the rows' hand-outs ended alike).
    (cw, ch), sq = POOL_COVER, POOL_SQUARE
    cases = {
        "cover (spheres)": (cover(cw, ch), cw, ch, 50, False, True),
        "knot_small (triangles)": (knot(sq), sq, sq, 20, False, True),
        "knot_small two-sided": (knot(sq), sq, sq, 20, False, False),
        "Cornell box (lit, triangles)": (B.cornell_scene(1.0, device=dev),
                                         sq, sq, 8, False, True),
        "smoke box (lit, media)": (B.smoke_scene(1.0, device=dev), sq, sq,
                                   8, False, True),
        "roulette cover (lit, spheres)": (cover(cw, ch), cw, ch, 50, True,
                                          True),
    }
    lines, errs, t0 = [], [], time.perf_counter()
    for name, ((scene, cam), w, h, depth, roulette, cull) in cases.items():
        args, kw = launch_args(scene, cam, w, h, POOL_SPP, depth, roulette,
                               cull=cull, pool=True)
        before = mk.render_blocks.pool_launches
        (k, kc), (p, pc) = k1_pair(torch, mk, dev, args, kw)
        check(mk.render_blocks.pool_launches == before + 1,
              f"pool {name}: the launch did not run the pool")
        err = float((k - p).abs().max())
        errs.append(err)
        check(bool(torch.isfinite(k).all()) and float(k.mean()) > 0,
              f"pool {name}: kernel output not finite, or black")
        check(torch.equal(k, p), f"pool {name}: not bit-identical to the "
                                 f"plain pool (max |d| {err:.3g})")
        check(kc == pc, f"pool {name}: kernel counted {kc}, plain {pc}")
        lines.append(f"{name} {w}x{h} depth {depth}: {kc}")
    say("28", f"the pool instances of K1 vs the plain pool at spp{POOL_SPP} "
              f"(chunk 16, hand-out every 4 iterations; partial tile "
              f"columns) on {card}: bit-identical with equal counters "
              f"({K1_COUNTERS}): " + "; ".join(lines)
              + f" ({time.perf_counter() - t0:.1f} s)")

    # ---- (29) accounting, the estimator, and the A/B of the schedulers ---
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=ASPECT, aperture=0.0,
                      focus_dist=1.0, device=dev)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    white = b.build(background=(1.0, 1.0, 1.0), device=dev)
    held29 = []
    for spp in (128, 17):
        args, kw = launch_args(white, cam, W_MAIN, H_MAIN, spp, 50,
                               pool=True)
        planes, c29 = k1_held(torch, mk, dev, f"pool accounting spp {spp}",
                              args, kw)
        sums = mk.unblock_image(*planes, width=W_MAIN, height=H_MAIN)
        check(bool((sums == spp).all()),
              f"pool sample accounting {W_MAIN}x{H_MAIN} spp {spp}: sums "
              f"{float(sums.min())}..{float(sums.max())}")
        held29.append(f"spp{spp} {c29}")
    big = cover(W_MAIN, H_MAIN)
    frames = {}
    for label, pool, seed in (("c0", False, 0), ("c1", False, 123),
                              ("p0", True, 0)):
        frames[label] = mk.render_spheres(
            *big, seed, width=W_MAIN, height=H_MAIN, spp=128, max_depth=50,
            pool=pool).cpu().numpy() / 128
    c0, c1, p0 = frames["c0"], frames["c1"], frames["p0"]
    noise = float(np.abs(c0 - c1).mean())
    d_pool = float(np.abs(c0 - p0).mean())
    d_mean = abs(float(c0.mean()) - float(p0.mean()))
    check(d_pool > 0 and d_pool < 1.5 * noise and d_mean < 0.01,
          f"pool vs classic on the cover: mean |d| {d_pool:.4g} (noise "
          f"{noise:.4g}), frame means differ by {d_mean:.4g}")
    say("29", f"the pool's sample accounting at {W_MAIN}x{H_MAIN} spp128 and "
              f"spp17 (white background) on {card}: every pixel's sums == "
              f"spp, kernel vs plain pool bit-identical with equal counters "
              f"({K1_COUNTERS}) " + ", ".join(held29) + f"; the cover "
              f"{W_MAIN}x{H_MAIN} spp128 depth 50, pool vs "
              f"classic (seed 0): mean |d| {d_pool:.5f} against the classic "
              f"scheduler's seed-to-seed {noise:.5f} (allowed 1.5x), frame "
              f"means {float(p0.mean()):.6f} / {float(c0.mean()):.6f}")

    ab = {
        "cover spp128 d50": (big, W_MAIN, H_MAIN, 128, 50),
        f"Cornell box spp{SPP_LIT} d{DEPTH_LIT}": (
            B.cornell_scene(1.0, device=dev), W_LIT, W_LIT, SPP_LIT,
            DEPTH_LIT),
        f"knot_small spp{SPP_MESH} d{DEPTH_MESH}": (
            knot(W_MESH), W_MESH, W_MESH, SPP_MESH, DEPTH_MESH),
    }
    rows = {}
    for name, ((scene, cam), w, h, spp, depth) in ab.items():
        args, kw = launch_args(scene, cam, w, h, spp, depth)
        counts, runs = {}, {"classic": [], "pool": []}
        for label in ("classic", "pool"):
            mk.render_blocks(*args, **kw, pool=label == "pool")  # warm-up
            steps, slots = (torch.zeros(1, dtype=torch.int64, device=dev)
                            for _ in range(2))
            mk.render_blocks(*args, **kw, pool=label == "pool", steps=steps,
                             slots=slots)
            counts[label] = (int(steps), int(slots))
        for order in (("classic", "pool"), ("pool", "classic")) * 2:
            for label in order:
                runs[label].append(event_ms(torch, lambda: mk.render_blocks(
                    *args, **kw, pool=label == "pool"))[0])
        med = {k: statistics.median(v) for k, v in runs.items()}
        rows[name] = (med, counts)
        say("29", f"A/B {name} {w}x{h}, one whole-frame launch each, in "
                  f"turns, on {card}: classic {med['classic']:.2f} ms "
                  f"(median of {', '.join(f'{x:.2f}' for x in runs['classic'])}"
                  f"), pool {med['pool']:.2f} ms (median of "
                  f"{', '.join(f'{x:.2f}' for x in runs['pool'])}), pool / "
                  f"classic {med['pool'] / med['classic']:.3f}; steps / lane "
                  f"slots = occupancy: classic {counts['classic'][0]} / "
                  f"{counts['classic'][1]} = "
                  f"{counts['classic'][0] / counts['classic'][1]:.1%}, pool "
                  f"{counts['pool'][0]} / {counts['pool'][1]} = "
                  f"{counts['pool'][0] / counts['pool'][1]:.1%}")
    return {"max_abs_err": max(errs), "ab": rows}


def per_launch_ms(torch, fn, n):
    """Milliseconds per call of ``fn``, from CUDA events around ``n`` calls
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


#: Calls captured in the CUDA graph that times a call's device work.
GRAPH_CALLS = 100


def graph_ms(torch, stream, fn):
    """Milliseconds per call of ``fn`` on the card alone: CUDA events
    around the replay of a CUDA graph of ``GRAPH_CALLS`` captured calls
    (captured on ``stream``, after one call there), median of 3 replays
    after a warm-up replay."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    return statistics.median(times)


#: float32 operations of the probe T1 (a lower bound, counted from
#: csrc/mxu_probe.cu): per (lane, sphere) pair, the CUDA-core form's oc (9),
#: h (5), c (7), disc (3), the sign test, the square root, near and far
#: (4), the four interval tests and the min (1): 35; the matrix form's
#: h and c additions (2), disc (3), the sign test, the square root, near
#: and far (4), the interval tests (4) and the min (1): 16.  Tensor-core
#: work per (lane, block): the (256 x 16) product, 2 x 256 x 16, and the
#: fetch, 2 x 16 x 128, each three times (3xTF32).
OPS_PAIR_VPU = 35
OPS_PAIR_MXU = 16
TF32_HC = 3 * 2 * 256 * 16
TF32_FETCH = 3 * 2 * 16 * 128
#: H100 SXM's dense TF32 tensor-core rate (NVIDIA's data sheet).
PEAK_TF32 = 495e12


def tool_phases(torch, dev, card, say, event_ms):
    """Phases 30-31: the probes T1 (four kinds) and T2 (the JAX script's 8
    sizes), each driven through its entry point with the launch counts
    set to 0 just before, then each kernel against its plain version (and
    T2 against torch.sum), timed.  Returns their JSON entries."""
    import numpy as np

    from rtow_tpu_torch.tools import mxu_probe as mp
    from rtow_tpu_torch.tools import repro_nb_slice as rs

    # ---- (30) T1: the sphere-sweep probe at its defaults -----------------
    iters, n_blocks, n_tiles = 40, 4, 64
    out = io.StringIO()
    mp.probe.launches = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = mp.main([])
    main_launches = mp.probe.launches
    printed = out.getvalue().strip().splitlines()
    check(rc == 0 and main_launches == 4 * len(mp.KINDS)
          and sum("Gpairs/s" in ln for ln in printed) == len(mp.KINDS),
          f"mxu_probe main: rc {rc}, {main_launches} launches, printed "
          f"{printed}")
    ins = [torch.from_numpy(x).to(dev) for x in mp.inputs(n_blocks, n_tiles)]
    lanes = n_tiles * 1024
    pairs = lanes * 128 * n_blocks * iters
    nbytes = sum(x.numel() for x in ins) * 4 + lanes * 4
    kern, entries, lines = {}, [], []
    for kind in mp.KINDS:
        run = lambda: mp.probe(kind, *ins, n_blocks=n_blocks,  # noqa: E731
                               iters=iters)
        k_runs = [event_ms(torch, run)[0] for _ in range(4)][1:]
        k_ms = statistics.median(k_runs)
        kern[kind] = run()
        p_runs = [event_ms(torch, lambda: mp.probe_reference(
            kind, *ins, n_blocks=n_blocks, iters=iters)) for _ in range(4)]
        p_ms = statistics.median(ms for ms, _ in p_runs[1:])
        plain = p_runs[-1][1]
        got, want = kern[kind].cpu().numpy(), plain.cpu().numpy()
        mx, rel, share = mp.compare(got, want)
        if kind == "vpu":
            check(np.array_equal(got, want), f"T1 vpu: not bit-identical to "
                                             f"the plain version ({mx:.3g})")
        elif kind == "mxu_f":
            # The same sweep; the fetched parameters keep ~21 of their 24
            # bits (3xTF32), so a lane's sum of iters x (t + c0x / 4 +
            # dcx / 2 + r) moves by ~1e-6 of iters x its terms; where the
            # terms cancel the output is small, hence the floor of iters.
            rel_f = float((np.abs(got - want)
                           / np.maximum(np.abs(want), iters)).max())
            check(rel_f <= 1e-5, f"T1 mxu_f: max |d| / max(|plain|, "
                                 f"{iters}) {rel_f:.3g}")
        else:
            check(share <= 0.01, f"T1 {kind}: {share:.3%} of lanes off by "
                                 f"more than 1e-3 relative")
        matrix = kind in ("mxu", "mxu_b")
        f32_ops = pairs * (OPS_PAIR_MXU if matrix else OPS_PAIR_VPU)
        tf32 = lanes * n_blocks * iters * (
            (TF32_HC if matrix else 0) + (TF32_FETCH if kind != "vpu" else 0))
        times = {"operations": max(f32_ops / PEAK_F32, tf32 / PEAK_TF32),
                 "bytes": nbytes / PEAK_BYTES}
        by = max(times, key=times.get)
        bound = times[by] * 1e3
        vs = mp.compare(got, kern["vpu"].cpu().numpy())
        lines.append(
            f"{kind}: kernel {k_ms:.3f} ms (median of "
            f"{', '.join(f'{x:.3f}' for x in k_runs)}; "
            f"{pairs / k_ms / 1e6:.1f} Gpairs/s), plain {p_ms:.1f} ms "
            f"(one sweep serves its iterations; median of 3 after a warm-up), "
            f"vs plain max |d| {mx:.3g}, max rel {rel:.3g}, {share:.4%} of "
            f"lanes > 1e-3; vs vpu max |d| {vs[0]:.3g}, max rel {vs[1]:.3g}, "
            f"{vs[2]:.4%} > 1e-3; bound {bound:.4f} ms ({by}: "
            f"{f32_ops:.4g} float32 operations, {tf32:.4g} TF32 "
            f"tensor-core operations, {nbytes} bytes) = {bound / k_ms:.1%}")
        entries.append({
            "name": f"mxu_probe_{kind}",
            "route": "cuda",
            "source": "rtow_tpu_torch/csrc/mxu_probe.cu",
            "replaces": ("tools/mxu_probe.py:205" if matrix
                         else "tools/mxu_probe.py:133"),
            "launches": main_launches // len(mp.KINDS),
            "max_abs_err": mx,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": None,
        })
    say("30", f"T1, python -m rtow_tpu_torch.tools.mxu_probe (defaults: "
              f"{iters} iters, {n_blocks} blocks, {n_tiles} tiles) on {card}: "
              f"{main_launches} launches; it printed: " + " | ".join(printed))
    say("30", "T1 per kind at the defaults: " + "; ".join(lines))

    # ---- (31) T2: the block-by-block table sum, the JAX script's sizes ---
    out = io.StringIO()
    rs.nb_slice.launches = 0
    with contextlib.redirect_stdout(out):
        rc = rs.main([])
    t2_launches = rs.nb_slice.launches
    printed = out.getvalue().strip().splitlines()
    check(rc == 0 and t2_launches == 8 and len(printed) == 8
          and all(ln.split(": ")[-1].strip() == "OK" for ln in printed),
          f"repro_nb_slice main: rc {rc}, {t2_launches} launches, printed "
          f"{printed}")
    lines, worst, entry = [], 0.0, None
    side = torch.cuda.Stream(dev)  # the CUDA graphs' capture stream
    for width in rs.WIDTHS:
        for nb in rs.DEFAULT_NB:
            tbl = torch.rand((nb, 16, width), device=dev)
            before = rs.nb_slice.launches
            got = rs.nb_slice(tbl)
            check(rs.nb_slice.launches == before + 1,
                  f"T2 NB={nb}: {rs.nb_slice.launches - before} launches "
                  f"for one call")
            ordered = rs.nb_slice_ordered(tbl)
            check(torch.equal(got, ordered),
                  f"T2 NB={nb} width {width}: not bit-identical to the "
                  f"kernel's order of the sums ({float(got[0, 0])!r} vs "
                  f"{float(ordered[0, 0])!r})")
            p_ms, want = event_ms(torch, lambda: rs.nb_slice_reference(tbl))
            lib = torch.sum(tbl[:, :, :128])
            rel = float(((got - want).abs() / want.abs()).max())
            rel_lib = float(((got - lib).abs() / lib.abs()).max())
            check(rel <= 1e-5 and rel_lib <= 1e-5
                  and bool((got == got[0, 0]).all()),
                  f"T2 NB={nb} width {width}: relative |d| {rel:.3g} vs "
                  f"plain, {rel_lib:.3g} vs torch.sum")
            worst = max(worst, float((got - want).abs().max()))
            k_ms = per_launch_ms(torch, lambda: rs.nb_slice(tbl), 20)
            l_ms = per_launch_ms(torch, lambda: torch.sum(tbl[:, :, :128]),
                                 20)
            k_dev = graph_ms(torch, side, lambda: rs.nb_slice(tbl))
            l_dev = graph_ms(torch, side, lambda: torch.sum(tbl[:, :, :128]))
            nbytes = nb * 16 * 128 * 4 + 8 * 128 * 4
            bound = nbytes / PEAK_BYTES * 1e3
            lines.append(f"NB={nb} width {width}: a call {k_ms * 1e3:.1f} "
                         f"us (torch.sum {l_ms * 1e3:.1f}), the device alone "
                         f"{k_dev * 1e3:.2f} us (torch.sum "
                         f"{l_dev * 1e3:.2f}), plain {p_ms:.1f} ms, bound "
                         f"{bound * 1e3:.2f} us (bytes) = {bound / k_dev:.1%} "
                         f"of the device time; rel |d| {rel:.2g} vs plain, "
                         f"{rel_lib:.2g} vs torch.sum")
            entry = {
                "name": "nb_slice",
                "route": "cuda",
                "source": "rtow_tpu_torch/csrc/nb_slice.cu",
                "replaces": "tools/repro_nb_slice.py:30",
                "launches": t2_launches,
                "max_abs_err": worst,
                "ms": k_ms,
                "plain_ms": p_ms,
                "bound_ms": bound,
                "bound_by": "bytes",
                "library_ms": l_ms,
            }
    say("31", f"T2, python -m rtow_tpu_torch.tools.repro_nb_slice on {card}: "
              f"{t2_launches} launches; it printed: " + " | ".join(printed))
    say("31", "T2 on uniform [0, 1) tables, one launch a call, "
              "bit-identical to the kernel's order of the sums "
              "(nb_slice_ordered) at every size; a call timed by CUDA events "
              "around 20 calls, the device alone around a CUDA graph of "
              f"{GRAPH_CALLS} captured calls (the kernels' line: NB=1408, "
              "width 256, a call): " + "; ".join(lines))
    return entries + [entry]


if __name__ == "__main__":
    main()
