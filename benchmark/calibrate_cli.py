"""The readings of the command-line cell's check limit (``ppm_gap``, in
8-bit levels), as ``calibrate.py`` takes them for the others (the same
modes, seeds and lines), on the card:

    python3 benchmark/calibrate_cli.py --workload cover.cli \\
        --modes program,control,fault:half --seeds 1,2,3 --out readings.jsonl

* ``program``: set-up (one run of the command line), one run of the
  window's call, then the check;
* ``control``: the reference in bfloat16, tone-mapped as the PPM is,
  against the float32 reference's, on the run's sample of tile rows;
* ``fault:<name>``: the command line with a render fault of
  ``benchmark/faults.py`` planted under it (its frame is
  ``pipeline.render_auto``'s, which the command line calls).
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402


def reading(cell, mode: str, seed: int, device) -> dict:
    import numpy as np
    import torch

    from benchmark import faults
    from benchmark.drivers import Context, Seeds, cli
    from benchmark.reference.render import draw_sample, render_sample

    seeds = Seeds(seed)
    ctx = Context(cell.config, cell.traffic, seeds, device,
                  cell.scene_inputs(seeds))
    driver = cli.Driver(ctx)
    if mode == "control":
        sample = draw_sample(ctx.inputs, driver.width, driver.height,
                             np.random.default_rng(seeds.sample),
                             driver.check_rows, 0)

        def ref(dtype):
            return cli.tonemap(render_sample(
                ctx.inputs, ctx.camera(), sample, seed=driver.seed(),
                width=driver.width, height=driver.height, spp=driver.spp,
                max_depth=driver.max_depth, device=device, dtype=dtype))

        t0 = time.perf_counter()
        high = ref(torch.float32)
        t1 = time.perf_counter()
        low = ref(torch.bfloat16)
        return {"numbers": {"ppm_gap": float(np.max(np.abs(low - high)))},
                "reference_s": t1 - t0}
    fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
    with (faults.planted(fault, "render") if fault
          else contextlib.nullcontext()):
        driver.setup()
        driver.unit(0)
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check = driver.check({})
    return {"numbers": check.numbers, "reference_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--modes", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    device = core.require_cards(1)
    print(f"card: {core.card_line()}", flush=True)
    cell = core.Cell(core.load_json(core.ROOT / "BENCHMARK.json"),
                     args.workload)
    with open(args.out, "a") as out:
        for mode in args.modes.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                r = {"workload": args.workload, "mode": mode, "seed": seed,
                     **reading(cell, mode, seed, device),
                     "seconds": time.perf_counter() - t0}
                out.write(json.dumps(r) + "\n")
                out.flush()
                print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
