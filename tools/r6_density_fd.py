"""ROADMAP R6 measured on the card: the port's density gradient of the
smoke fit's loss against the loss's central difference, on common random
numbers.

    python3 tools/r6_density_fd.py [--spp 256] [--sets 4] [--step 0.01]

The benchmark's ``smoke.train`` cell at its start state
(``benchmark/configs/smoke.json``: the frozen Cornell smoke, both
densities at 0.02, the white fog's albedo at 0.6), its 400 x 400 pixels
at ``--spp`` samples each, depth 8, NEE on, lanes unsorted.  The target
is rendered at the true leaves at the same spp.  The loss (the mean
squared error over every pixel) and its gradient (``diff.loss_and_grad``,
K4 and K5) are taken in chunks of pixels of at most 2,560,000 lanes,
each chunk with its own camera generator and kernel seed, the same at
every evaluation of a set.  Each medium's density is then moved by
``--step`` of itself up and down and the loss taken again: the central
difference holds what the gradient omits (the derivative of the
probability that an event happens, which the replayed event bit leaves
out), and the Monte Carlo noise of the events that the step flips.  The
white fog's red albedo, which moves no path, is the control: its
difference and its gradient agree.  ``--sets`` independent seed sets
give the spread.  Prints one JSON line; exits 3 without a card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: Lanes of one chunk: the cell's own 400 x 400 x 16.
CHUNK_LANES = 2_560_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--sets", type=int, default=4)
    ap.add_argument("--step", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=260_001)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no card to run on", file=sys.stderr)
        return 3
    from benchmark import core, program
    from benchmark.drivers.train_media import FIT, build_scene
    from benchmark.scenes import smoke
    from rtow_tpu_torch import diff
    from rtow_tpu_torch.ops.grad import render_pixels_kernel
    from rtow_tpu_torch.ops.tables import grad_tables

    dev = torch.device("cuda")
    config = core.load_json(core.HERE / "configs" / "smoke.json")
    w = h = 400
    depth = 8
    truth = build_scene(smoke.scene(config, 0), dev)
    camera = program.build_camera({**config["camera"], "aspect_ratio": 1.0},
                                  dev)
    start = config["train"]["start"]
    state = truth.replace_leaves({
        k: torch.tensor(start[k], dtype=torch.float32, device=dev)
        for k in FIT})
    per = max(CHUNK_LANES // args.spp, 1)
    chunks = [torch.arange(s, min(s + per, w * h), device=dev)
              for s in range(0, w * h, per)]
    kw = dict(width=w, height=h, spp=args.spp, max_depth=depth, nee=True,
              sort_lanes=False)

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def render(scene, base, c, ids):
        with torch.no_grad():
            return render_pixels_kernel(
                scene, camera, gen(base + c), ids, seed=base + 7919 * c,
                tables=grad_tables(scene, sort_lanes=False, nee=True), **kw)

    def loss(scene, base, target):
        total = 0.0
        for c, ids in enumerate(chunks):
            img = render(scene, base, c, ids)
            total += float(((img - target[ids]) ** 2).sum())
        return total / (w * h * 3)

    def loss_grad(scene, base, target):
        total, grads = 0.0, {k: 0.0 for k in FIT}
        for c, ids in enumerate(chunks):
            val, g = diff.loss_and_grad(
                scene, camera, gen(base + c), target[ids], ids,
                seed=base + 7919 * c, **kw)
            share = ids.numel() / (w * h)
            total += float(val) * share
            leaves = g.leaves()
            for k in FIT:
                grads[k] = grads[k] + leaves[k].double() * share
        return total, {k: v.cpu().numpy() for k, v in grads.items()}

    def moved(key, index, delta):
        leaf = state.leaves()[key].clone()
        leaf[index] += delta
        return state.replace_leaves({key: leaf})

    sets = []
    t0 = time.perf_counter()
    for s in range(args.sets):
        base = args.seed + 1_000_003 * s
        target = torch.cat([render(truth, base + 500_009, c, ids)
                            for c, ids in enumerate(chunks)])
        value, grad = loss_grad(state, base, target)
        row = {"loss": value}
        probes = [("density", "volumes.density", (v,), v) for v in range(2)]
        probes.append(("fog_albedo_r", "volumes.albedo", (1, 0), None))
        for name, key, index, v in probes:
            x = float(state.leaves()[key][index])
            d = args.step * x
            up = loss(moved(key, index, d), base, target)
            down = loss(moved(key, index, -d), base, target)
            label = name if v is None else f"{name}{v}"
            row[label] = {"grad": float(grad[key][index]),
                          "fd": (up - down) / (2 * d)}
        sets.append(row)
        print(json.dumps({"set": s, **row}), flush=True)
    summary = {}
    for label in [k for k in sets[0] if k != "loss"]:
        g = np.array([r[label]["grad"] for r in sets])
        f = np.array([r[label]["fd"] for r in sets])
        diff_ = f - g
        summary[label] = {
            "grad_mean": float(g.mean()), "fd_mean": float(f.mean()),
            "fd_minus_grad_mean": float(diff_.mean()),
            "fd_minus_grad_stderr": float(diff_.std(ddof=1)
                                          / np.sqrt(len(sets)))
            if len(sets) > 1 else None,
            "relative_bias": float(diff_.mean() / f.mean()) if f.mean()
            else None}
    print(json.dumps({"card": core.card_line(), "spp": args.spp,
                      "step": args.step, "sets": args.sets,
                      "seconds": time.perf_counter() - t0,
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
