"""Times the forward bounce kernel K4 on the gradient trainers' launches.

    python -m rtow_tpu_torch.time_k4 [--runs 3] [--knot 4k|65k|360k] [--lit] [--cross]
    python -m rtow_tpu_torch.time_k4 [--runs 3] --scene cornell|smoke|smoke-nee ...

The tapes are ``time_k5``'s: the knot's input states of one forward at
the mesh trainer's size (256x256, 16 samples per pixel, depth 8:
1,048,576 lanes; sorted where the trainer sorts them), with ``--lit``
under two square lamps with NEE, or
each ``--scene``'s unsorted ones at 400x400, given to K4 as the trainers
give them.  Each of a tape's 9 K4
launches is timed alone by CUDA events (``--runs`` calls after a warm-up,
their mean), beside its live lanes, then the 9 together (median of
``--runs``); on a knot, where the checkout's K4 has forms
(``bounce_fwd.warp_launches``), in each form ("thread", "warp", "auto":
the one the card picks from ``grad.WARP_MAX_LIVE``), in turns, each
forced through that cut-over; otherwise in its one form.  ``--cross``
then times both forms where the two cross: the knot's first launch with
only its first 262,144 / 393,216 / 524,288 / 786,432 lanes left live (the
sorted prefix, as a drain leaves it), thread, warp, warp, thread.  Prints
one JSON line per tape: the card, per form the per-launch and total
milliseconds, and the crossing's times.  It calls only what every
checkout since K4's triangle instances has, so copies of this file and
``time_k5.py`` in another checkout's package time that K4: run both in
one chip call, in turns, to compare two versions.
"""
from __future__ import annotations

import argparse
import json

from .time_k5 import (
    DEPTH, KNOTS, SCENES, card, event_ms, tapes, time_forms,
)

#: --cross: the live lanes left in the knot's first launch.
CROSS = (262_144, 393_216, 524_288, 786_432)


def main(argv=None) -> None:
    import torch

    from .ops import grad as G

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--knot", choices=sorted(KNOTS), default="65k")
    p.add_argument("--lit", action="store_true")
    p.add_argument("--scene", nargs="+", choices=sorted(SCENES))
    p.add_argument("--cross", action="store_true")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k4: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name_card = card()
    has_forms = hasattr(G.bounce_fwd, "warp_launches")
    for name, (tbl, tris, tape, lit, bg) in tapes(opts, dev).items():
        forms = (("thread", "warp", "auto") if has_forms and not opts.scene
                 else (None,))

        def kernel(it, ints=None):
            c, i = tape[it]
            return G.bounce_fwd(c, i if ints is None else ints, tbl, tris,
                                it=it, seed=0, max_depth=DEPTH, lit=lit,
                                background=bg)

        per, total = time_forms(torch, G, kernel, tape, forms, opts.runs)
        out = {"card": name_card, "kernel": "K4", "tape": name,
               "lanes": tape[0][0].shape[1],
               "live": [int((i[0] > 0).sum()) for _, i in tape],
               "per_launch_ms": per, "total_ms": total}
        if opts.cross and has_forms and not opts.scene:
            cut, cross = G.WARP_MAX_LIVE, {}
            try:
                for m in CROSS:
                    ints = tape[0][1].clone()
                    ints[0, m:] = 0
                    turns = {"thread": [], "warp": []}
                    for form in ("thread", "warp", "warp", "thread"):
                        G.WARP_MAX_LIVE = -1 if form == "thread" else 1 << 30
                        turns[form].append(event_ms(
                            torch, lambda: kernel(0, ints), opts.runs))
                    cross[str(int((ints[0] > 0).sum()))] = turns
            finally:
                G.WARP_MAX_LIVE = cut
            out["cross_ms"] = cross
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
