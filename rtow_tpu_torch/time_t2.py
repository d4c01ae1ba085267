"""Times the probe T2 (the block-by-block table sum) on the card.

    python -m rtow_tpu_torch.time_t2 [--runs 5]

At the JAX script's largest and smallest sizes (NB = 1,408 at width 256,
NB = 256 at width 128), on a uniform [0, 1) table: a call, by CUDA events
around 20 calls (the host's launch and the wrapper included), and the
device alone, by CUDA events around the replay of a CUDA graph of 100
captured calls, each ``--runs`` times.  Prints one JSON line: the card and
per size the times in microseconds with their medians.  It calls only
``repro_nb_slice.nb_slice``, so a copy of this file in another checkout's
package times that checkout's T2: run both in one chip call, one after
the other and back, to compare two versions of the kernel.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

SIZES = ((1408, 256), (256, 128))
CALLS, GRAPH_CALLS = 20, 100


def main(argv=None) -> None:
    import torch

    from .tools import repro_nb_slice as rs

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=5)
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_t2: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]

    def timed_us(fn, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n * 1e3

    times = {}
    for nb, width in SIZES:
        tbl = torch.rand((nb, 16, width), device=dev)
        side = torch.cuda.Stream(dev)  # the graph's capture stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            rs.nb_slice(tbl)  # warm-up, before the capture
        rs.nb_slice(tbl)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(GRAPH_CALLS):
                rs.nb_slice(tbl)
        graph.replay()
        calls = [timed_us(lambda: [rs.nb_slice(tbl) for _ in range(CALLS)],
                          CALLS) for _ in range(opts.runs)]
        device = [timed_us(graph.replay, GRAPH_CALLS)
                  for _ in range(opts.runs)]
        times[f"NB={nb} width {width}"] = {
            "call_us": calls, "call_median_us": statistics.median(calls),
            "device_us": device,
            "device_median_us": statistics.median(device)}
    print(json.dumps({"card": card, "times": times}), flush=True)


if __name__ == "__main__":
    main()
