"""The readings that a cell's check limits are set from, at the cell's own
size on the card, many seeds in one process:

    python3 benchmark/calibrate.py --workload cover.render \\
        --modes program,control --seeds 1,2,3 --out readings.jsonl

* ``program``: the program's numbers, as a run compares them (set-up,
  one frame or step of the window's call, the reference after it);
* ``control``: the reference put in the program's place, computed in
  bfloat16 (the configurations state float32), against the float32
  reference;
* ``fault:<name>``: the program with a fault of ``benchmark/faults.py``
  planted under it.

Each reading is one JSON line: the mode, the seed, the numbers and the
reference's seconds.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def reading(cell, mode: str, seed: int, device) -> dict:
    import torch

    from benchmark import faults
    from benchmark.drivers import Context, Seeds

    seeds = Seeds(seed)
    ctx = Context(cell.config, cell.traffic, seeds, device,
                  cell.scene_inputs(seeds))
    driver = cell.driver(ctx)
    kind = cell.traffic["kind"]
    module = sys.modules[type(driver).__module__]
    if mode == "control":
        if kind == "render":
            driver.draw()
        t0 = time.perf_counter()
        ref = driver.reference()
        t1 = time.perf_counter()
        low = driver.reference(torch.bfloat16)
        if kind == "render":
            numbers = module.compare([low], ref)[0]
        else:
            numbers = module.compare(low, ref, driver.lr)
        return {"numbers": numbers, "reference_s": t1 - t0}
    fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
    with faults.planted(fault, kind) if fault else contextlib.nullcontext():
        driver.setup()
        driver.unit(0)
    driver.release()
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
    from benchmark import core

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
