"""Builds the port's CUDA kernels and reports each kernel's registers and
spills, as ptxas gives them.

    python -m rtow_tpu_torch.ptxas_report [source ...]

Sources: the names of ``csrc/<name>.cu`` (default: all six).  nvcc builds
them, one process each, all started together (``ops/_cuda.build_all``,
whose flags carry ``-Xptxas -v``); a build of the same sources and flags
made before is built again into a temporary directory, so there is
always a report.  Prints one JSON line: per source its nvcc seconds and,
per kernel entry (the mangled name with the anonymous namespace's hash,
which differs from checkout to checkout, taken out), [registers, spill
store bytes, spill load bytes].  It calls only ``_cuda.build_all``, so a
copy of this file in another checkout's package reports that checkout's
kernels: run both in one chip call to compare two versions.
"""
from __future__ import annotations

import argparse
import json
import re
import tempfile
from pathlib import Path

SOURCES = ("megakernel", "flat_bounce", "grad_fwd", "grad_bwd", "sort_keys",
           "mxu_probe", "nb_slice")


def entries(log: str) -> dict:
    """{kernel entry: [registers, spill stores, spill loads]} from an
    nvcc build log with ptxas's verbose report."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = re.sub(r"GLOBAL__N__[0-9a-f]+_", "", line.split("'")[1])
            out[entry] = [None, None, None]
        elif "Function properties for" in line:
            props = re.sub(r"GLOBAL__N__[0-9a-f]+_", "",
                           line.split("for ")[-1].strip())
        elif "bytes spill stores" in line and entry and props == entry:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            out[entry][1:] = [int(m.group(1)), int(m.group(2))]
        elif "Used " in line and entry:
            out[entry][0] = int(line.split("Used ")[1].split()[0])
    return out


def main(argv=None) -> None:
    from .ops import _cuda

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sources", nargs="*", metavar="source",
                   help=f"one of {', '.join(SOURCES)} (default: all)")
    names = p.parse_args(argv).sources or list(SOURCES)
    bad = set(names) - set(SOURCES)
    if bad:
        p.error(f"unknown sources {sorted(bad)}; choose from {SOURCES}")
    with tempfile.TemporaryDirectory() as tmp:
        _cuda.BUILD_DIR = Path(tmp)  # a fresh build, with its log
        _cuda._BUILT.clear()
        builds = _cuda.build_all(names)
        print(json.dumps({name: {"seconds": b.seconds,
                                 "entries": entries(b.log)}
                          for name, b in builds.items()}), flush=True)


if __name__ == "__main__":
    main()
