"""The readings of the lit cells' check limits, as ``calibrate.py``
takes them for the others (the same modes, seeds and lines), on the card:

    python3 benchmark/calibrate_lit.py --workload cornell.render \\
        --modes program,control,fault:half --seeds 1,2,3 --out readings.jsonl

A lit traffic kind (``drivers/render_lit.py``, ``drivers/train_lit.py``)
names the kind whose faults and readings it takes (its ``BASE``):
:class:`LitCell` shows ``calibrate.reading`` that kind while building the
lit driver.
"""
import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402
from benchmark.calibrate import reading  # noqa: E402


class LitCell(core.Cell):
    """A lit cell whose traffic kind reads as its driver's ``BASE``."""

    def __init__(self, bench: dict, workload: str):
        super().__init__(bench, workload)
        self.module = importlib.import_module(
            f"benchmark.drivers.{self.traffic['kind']}")
        self.traffic = {**self.traffic, "kind": self.module.BASE}

    def driver(self, ctx):
        return self.module.Driver(ctx)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--modes", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    device = core.require_cards(1)
    print(f"card: {core.card_line()}", flush=True)
    cell = LitCell(core.load_json(core.ROOT / "BENCHMARK.json"),
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
