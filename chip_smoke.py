#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtow_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rtow_tpu_torch/csrc`` with
nvcc (one process per source, started together), holds each against its
plain PyTorch version on the card, and drives the port's two paths: the
render (the cover through ``rtow_tpu_torch.cli.main`` at 1200x675, 128
samples per pixel, depth 50; kernel K1) and the trainer (three SGD steps
of the cover's albedos at 400x267, 16 samples per pixel, depth 8, the
JAX package's bench grad leg; kernels K4 and K5).  Every phase prints
one line; any failed check raises and the script exits non-zero.  The
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
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

W_MAIN, H_MAIN = 1200, 675
ASPECT = 16.0 / 9.0
#: Kernel vs plain version on the card: both round every float32
#: operation alike (-fmad=false, IEEE division and sqrt) and use the same
#: CUDA math library, so a pixel may differ only where a last-bit
#: difference flips a discrete choice (a reflection or a hit on the
#: r=1000 ground sphere, whose |oc|^2 - r^2 cancels).  Allowed: at most
#: FLIP_SHARE of pixels off by more than PIXEL_TOL in mean radiance, and
#: a mean |difference| of at most MEAN_TOL.
PIXEL_TOL = 1e-4
FLIP_SHARE = 0.01
MEAN_TOL = 1e-3

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

#: Roofline of one H100 SXM (NVIDIA's data sheet): float32 outside the
#: tensor cores, and HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
#: float32 operations the kernels do per lane-bounce (a lower bound, from
#: csrc/bounce.cuh): per table row of the sweep, the unconditional part
#: (the centre at tm: 6, oc: 3, h: 5, cc: 7, disc: 3, the test: 1); per
#: step, |d|^2 and 1/|d|^2 (6) plus the cheaper shade branch, the sky
#: (17); K5 adds the cheaper adjoint branch, the sky's (32).
OPS_PER_ROW = 25
OPS_PER_STEP = 6 + 17
OPS_BWD_EXTRA = 32


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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

    from rtow_tpu_torch import cli
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models.builders import cover_scene, three_sphere_scene
    from rtow_tpu_torch.models.camera import make_camera
    from rtow_tpu_torch.models.scene import SceneBuilder
    from rtow_tpu_torch.ops import _cuda
    from rtow_tpu_torch.ops import megakernel as mk
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

    # ---- (1) build, all three sources at once ----------------------------
    t0 = time.perf_counter()
    builds = _cuda.build_all(["megakernel", "grad_fwd", "grad_bwd"])
    wall = time.perf_counter() - t0
    for name, build in builds.items():
        ptxas = "; ".join(line.split("ptxas info    : ")[-1]
                          for line in build.log.splitlines()
                          if "Used" in line or "spill" in line)
        say("1", f"nvcc build of csrc/{name}.cu: {build.seconds:.1f} s "
                 f"({ptxas})")
    say("1", f"three builds in parallel: {wall:.1f} s wall")

    def frame(scene, cam, width, height, spp, depth, *, plain=False,
              seed=0):
        """(H*W, 3) mean radiance of one frame, kernel or plain."""
        tbl, _ = mk.build_sphere_table(scene)
        args = (tbl, mk.pack_camera(cam),
                mk.pack_meta(seed, width=width, height=height, spp=spp,
                             max_depth=depth),
                mk.n_tiles_for(width, height))
        fn = mk.render_blocks_reference if plain else mk.render_blocks
        r, g, b = fn(*args, background=scene.background)
        torch.cuda.synchronize()
        return mk.unblock_image(r, g, b, width=width, height=height) / spp

    def agreement(kern, plain):
        diff = (kern - plain).abs().amax(dim=1)
        check(bool(torch.isfinite(kern).all()), "kernel output not finite")
        return (float(diff.max()), float(diff.mean()),
                float((diff > PIXEL_TOL).float().mean()))

    # ---- (2) kernel vs plain version on the card -----------------------
    three = three_sphere_scene(ASPECT, device=dev)
    k3 = frame(*three, 400, 225, 4, 50)
    p3 = frame(*three, 400, 225, 4, 50, plain=True)
    mx3, _, _ = agreement(k3, p3)
    check(mx3 <= PIXEL_TOL, f"three_sphere: max |d| {mx3} > {PIXEL_TOL}")
    cover = cover_scene(Config(image_width=400, aspect_ratio=ASPECT),
                        device=dev)
    kc = frame(*cover, 400, 225, 4, 50)
    pc = frame(*cover, 400, 225, 4, 50, plain=True)
    mxc, meanc, flipc = agreement(kc, pc)
    check(flipc <= FLIP_SHARE and meanc <= MEAN_TOL,
          f"cover 400x225: {flipc:.4%} of pixels off by > {PIXEL_TOL}, "
          f"mean |d| {meanc}")
    say("2", f"kernel vs plain: three_sphere 400x225 spp4 depth50 max |d| "
             f"{mx3:.3g} (allowed {PIXEL_TOL}); cover 400x225 spp4 depth50 "
             f"{flipc:.4%} of pixels off by > {PIXEL_TOL} (allowed "
             f"{FLIP_SHARE:.0%}), mean |d| {meanc:.3g} (allowed {MEAN_TOL}),"
             f" max |d| {mxc:.3g}")

    # ---- (3) exact sample accounting -------------------------------------
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0, device=dev)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    empty = b.build(background=(1.0, 1.0, 1.0), device=dev)
    for spp in (17, 24):
        sums = mk.render_spheres(empty, cam, 0, width=24, height=24,
                                 spp=spp, max_depth=4)
        check(bool((sums == spp).all()), f"sample accounting spp {spp}")
    say("3", "exact sample accounting: every pixel's sums == spp at spp 17 "
             "and 24 (white background, empty scene)")

    # ---- (4) determinism -------------------------------------------------
    again = frame(*cover, 400, 225, 4, 50)
    check(torch.equal(kc, again), "two kernel runs differ")
    say("4", "two kernel runs of the cover 400x225 are bit-identical")

    # ---- (5) the main path: cli.main at full size ----------------------
    spp_main = 128
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        ppm_path = os.path.join(tmp, "cover.ppm")
        mk.render_blocks.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            rc = cli.main(["-w", str(W_MAIN), "-a", repr(ASPECT), "-s",
                           str(spp_main), "-c", "50", "-o", ppm_path])
        wall = time.perf_counter() - t0
        launches = mk.render_blocks.launches
        check(rc == 0, f"cli.main returned {rc}")
        check(launches > 0, "the main path launched no megakernel")
        with open(ppm_path) as f:
            img = read_ppm(f)
    check(img.shape == (H_MAIN, W_MAIN, 3), f"PPM shape {img.shape}")
    check(img.min() >= 0 and img.max() <= 255 and img.std() > 10,
          "PPM values out of range or flat")
    top = img[:40].reshape(-1, 3).mean(axis=0)
    check(top[2] > top[0], f"top rows are not sky-blue (mean rgb {top})")
    stats = [ln for ln in log.getvalue().splitlines() if ln.startswith("Done")]
    say("5", f"cli.main -w {W_MAIN} -a {ASPECT!r} -s {spp_main} -c 50: "
             f"{launches} launches, {wall:.2f} s end to end "
             f"({W_MAIN * H_MAIN * spp_main / wall / 1e6:.2f} Mprimary-rays/s "
             f"incl. scene build and PPM write); render: {stats[-1]}")

    # ---- (6) kernel and plain times at the main path's shape -----------
    big = cover_scene(Config(image_width=W_MAIN, aspect_ratio=ASPECT),
                      device=dev)
    tbl, _ = mk.build_sphere_table(big[0])
    args = (tbl, mk.pack_camera(big[1]),
            mk.pack_meta(0, width=W_MAIN, height=H_MAIN, spp=16,
                         max_depth=50),
            mk.n_tiles_for(W_MAIN, H_MAIN))

    def timed(fn):
        return event_ms(torch, lambda: fn(*args))

    timed(mk.render_blocks)  # warm-up
    runs = [timed(mk.render_blocks) for _ in range(3)]
    kernel_ms = statistics.median(ms for ms, _ in runs)
    plain_ms, plain_out = timed(mk.render_blocks_reference)
    kern = mk.unblock_image(*runs[0][1], width=W_MAIN, height=H_MAIN) / 16
    plain = mk.unblock_image(*plain_out, width=W_MAIN, height=H_MAIN) / 16
    mx6, mean6, flip6 = agreement(kern, plain)
    check(flip6 <= FLIP_SHARE and mean6 <= MEAN_TOL,
          f"cover {W_MAIN}x{H_MAIN}: {flip6:.4%} of pixels off by > "
          f"{PIXEL_TOL}, mean |d| {mean6}")
    say("6", f"cover {W_MAIN}x{H_MAIN} spp16 depth50 on {card}: kernel "
             f"{kernel_ms:.2f} ms (median of 3: "
             f"{', '.join(f'{ms:.2f}' for ms, _ in runs)}), plain "
             f"{plain_ms:.2f} ms; kernel vs plain {flip6:.4%} of pixels off "
             f"by > {PIXEL_TOL}, mean |d| {mean6:.3g}, max |d| {mx6:.3g}")

    # Ray steps (a stats launch each, not timed) -> K1's bound: the
    # sweep's and the step's float32 operations over the card's peak.
    npad = tbl.shape[0]

    def k1_steps(spp):
        steps = torch.zeros(1, dtype=torch.int64, device=dev)
        mk.render_blocks(*args[:2], mk.pack_meta(0, width=W_MAIN,
                                                 height=H_MAIN, spp=spp,
                                                 max_depth=50),
                         args[3], steps=steps)
        return int(steps)

    def k1_bound_ms(steps):
        return steps * (OPS_PER_STEP + OPS_PER_ROW * npad) / PEAK_F32 * 1e3

    steps16 = k1_steps(16)
    k1_bound = k1_bound_ms(steps16)
    meta128 = mk.pack_meta(0, width=W_MAIN, height=H_MAIN, spp=spp_main,
                           max_depth=50)
    ms128 = statistics.median(
        event_ms(torch, lambda: mk.render_blocks(*args[:2], meta128,
                                                  args[3]))[0]
        for _ in range(3))
    steps128 = k1_steps(spp_main)
    say("6", f"K1 ray steps: spp16 {steps16}, spp{spp_main} {steps128}; "
             f"bound (float32 ops {OPS_PER_STEP} + {OPS_PER_ROW} x {npad} "
             f"per step / 67 TFLOP/s): spp16 {k1_bound:.2f} ms = "
             f"{k1_bound / kernel_ms:.1%} of {kernel_ms:.2f} ms; "
             f"spp{spp_main} {k1_bound_ms(steps128):.2f} ms = "
             f"{k1_bound_ms(steps128) / ms128:.1%} of {ms128:.2f} ms "
             f"(one whole-frame launch, median of 3)")

    grad = grad_phases(torch, dev, card, say)

    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "rtow_tpu_torch/csrc/megakernel.cu",
        "replaces": "rtow_tpu/ops/pallas_megakernel.py:1433",
        "launches": launches,
        "max_abs_err": mx6,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": "operations",
        "library_ms": None,
    }] + grad}), flush=True)
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

    def grad_agreement(kern, plain, dim):
        """(max |d|, worst max |d| / max |plain| per row or column, share
        of entries off by more than 1e-4 |plain| + 1e-6 max |plain|)."""
        d = (kern - plain).abs()
        scale = plain.abs().amax(dim=dim, keepdim=True)
        worst = float((d.amax(dim=dim, keepdim=True)
                       / scale.clamp_min(1e-30)).max())
        share = float((d > 1e-4 * plain.abs() + 1e-6 * scale).float().mean())
        return float(d.max()), worst, share

    def check_bwd(kern, plain, what):
        (ci, gt), (pci, pgt) = kern, plain
        check(bool(torch.isfinite(ci).all() and torch.isfinite(gt).all()),
              f"{what}: K5 output not finite")
        out = []
        for name, k, p, dim in (("cot_in", ci, pci, 1),
                                ("g_tbl", gt[:, :13], pgt[:, :13], 0)):
            mx, worst, share = grad_agreement(k, p, dim)
            check(worst <= GRAD_TOL and share <= GRAD_SHARE,
                  f"{what}: K5 {name} vs plain: max |d| / max |plain| "
                  f"{worst:.3g} (allowed {GRAD_TOL}), share off "
                  f"{share:.3g} (allowed {GRAD_SHARE})")
            out.append((mx, worst, share))
        return out

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
        res = check_bwd(G.bounce_bwd(cont, ints, cot, tbl_s, **kw),
                        G.bounce_bwd_reference(cont, ints, cot, tbl_s, **kw),
                        f"cover 64x64 spp4, bounce {it}")
        worst7.append(res)
    say("7", f"cover 64x64 spp4 depth {DEPTH_GRAD} ({c0.shape[1]} lanes): "
             f"K4 and its plain version bit-identical at all "
             f"{DEPTH_GRAD + 1} bounces; K5 vs plain, worst over the "
             f"bounces: cot_in max |d| {max(w[0][0] for w in worst7):.3g} "
             f"({max(w[0][1] for w in worst7):.3g} of its row's max), "
             f"g_tbl max |d| {max(w[1][0] for w in worst7):.3g} "
             f"({max(w[1][1] for w in worst7):.3g} of its column's max); "
             f"shares off {max(max(w[0][2], w[1][2]) for w in worst7):.3g} "
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

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    fwd_call()  # warm-up
    loss, grads = fwdbwd_call()
    check(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.leaves().values()
        if g is not None), "loss_and_grad_kernel: not finite")
    fwd_runs = [wall_ms(fwd_call) for _ in range(3)]
    fb_runs = [wall_ms(fwdbwd_call) for _ in range(3)]
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
            res = [check_bwd(k, p, f"cover {W_GRAD}x{H_GRAD}, bounce {it}")
                   for it, (k, p) in enumerate(zip(k_outs, p_outs))]
            err = max(max(r[0][0], r[1][0]) for r in res)
        else:
            for it, (k, p) in enumerate(zip(k_outs, p_outs)):
                check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
                      f"K4 vs plain at {W_GRAD}x{H_GRAD}, bounce {it}: not "
                      f"bit-identical")
            err = 0.0
        npad = tbl.shape[0]
        ops = OPS_PER_STEP + OPS_PER_ROW * npad + (OPS_BWD_EXTRA if bwd
                                                   else 0)
        # Bytes: each input read once, each output written once.
        nbytes = (29 + 13 if bwd else 16 + 16) * 4 * n + npad * 64 * (
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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(start, torch.Generator(dev).manual_seed(7), target)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    dev_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        if ev.device_type.name == "CUDA" and us:
            dev_us[ev.key] = us
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    say("9", f"one train step under torch.profiler on {card}: {step_ms:.2f} "
             f"ms wall, device kernels {busy_ms:.2f} ms "
             f"(idle share {1 - busy_ms / step_ms:.1%}); by kernel: "
             + "; ".join(f"{k[:40]} {us / 1e3:.3f} ms" for k, us in top))

    return rows


if __name__ == "__main__":
    main()
