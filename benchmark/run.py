"""Runs one cell of ``BENCHMARK.json`` on the card and prints its result
as the last line of standard output:

    python3 benchmark/run.py --workload cover.render --seed 7 \\
        --seconds 20 --trace 0

``--trace 1`` runs the window under ``torch.profiler`` and reports the
cell's per-layer metrics instead of its end-to-end ones.  Without a card,
or with fewer than the cell asks for, it prints no result and exits 3.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.core import main

    raise SystemExit(main(t_start=T_START))
