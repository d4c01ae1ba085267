#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rtow_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA megakernel from ``rtow_tpu_torch/csrc`` with nvcc,
holds it against its plain PyTorch version on the card, and drives the
main path (the cover-scene render through ``rtow_tpu_torch.cli.main``)
at 1200x675, 128 samples per pixel, depth 50.  Every phase prints one
line; any failed check raises and the script exits non-zero.  The last
line of standard output is one JSON object:
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


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


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

    # ---- (1) build -----------------------------------------------------
    build = _cuda.build("megakernel")
    ptxas = "; ".join(line.split("ptxas info    : ")[-1]
                      for line in build.log.splitlines()
                      if "Used" in line or "spill" in line)
    say("1", f"nvcc build of csrc/megakernel.cu: {build.seconds:.1f} s "
             f"({ptxas})")

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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

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

    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "rtow_tpu_torch/csrc/megakernel.cu",
        "replaces": "rtow_tpu/ops/pallas_megakernel.py:1433",
        "launches": launches,
        "max_abs_err": mx6,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
