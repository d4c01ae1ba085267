"""Shows that chip_smoke.py's phase 21 fails a K5 whose light-row sums are
wrong: runs phases 21-22 (``chip_smoke.lit_grad_phases``) on the checkout,
then phase 21 on two copies in a temporary directory whose
``rtow_tpu_torch/csrc/grad_bwd.cu`` adds each block's light-row cotangent
to ``g_rows`` times 1.01, or not at all.  Each copy must stop with
CheckFailed.  Needs one CUDA card and nvcc:

    python3 tools/k5_rows_mutants.py

Exits 0 when the checkout passes and both copies are refused.
"""
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = "if (v != 0.0f) atomicAdd(&g_rows[i], v);"
MUTANTS = {
    "x1.01": "if (v != 0.0f) atomicAdd(&g_rows[i], 1.01f * v);",
    "none": "if (v != 0.0f && false) atomicAdd(&g_rows[i], v);",
}
RUN = """
import sys, time, torch
sys.path.insert(0, {root!r})
import chip_smoke as C
dev = torch.device("cuda", 0)
card = C.card_line()
print(card, flush=True)
t0 = time.time()
try:
    rows = C.lit_grad_phases(torch, dev, card, C.say, C.event_ms)
except C.CheckFailed as e:
    print("CheckFailed:", e, flush=True)
    print("after", round(time.time() - t0, 1), "s", flush=True)
    sys.exit(3)
print(rows)
print("phases 21-22 took", round(time.time() - t0, 1), "s", flush=True)
"""


def run(root: str) -> int:
    return subprocess.run([sys.executable, "-c", RUN.format(root=root)],
                          cwd=root).returncode


def main() -> int:
    rc = run(ROOT)
    print(f"checkout: exit {rc}", flush=True)
    refused = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, line in MUTANTS.items():
            dst = os.path.join(tmp, name)
            shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
                "_build", "_checkout", "chiprun_out", ".git", "__pycache__"))
            path = os.path.join(dst, "rtow_tpu_torch", "csrc", "grad_bwd.cu")
            with open(path) as f:
                src = f.read()
            if src.count(LINE) != 1:
                raise SystemExit(f"grad_bwd.cu has no single line {LINE!r}")
            with open(path, "w") as f:
                f.write(src.replace(LINE, line))
            rc_m = run(dst)
            refused += rc_m == 3
            print(f"g_rows {name}: exit {rc_m} "
                  f"({'refused' if rc_m == 3 else 'NOT refused'})", flush=True)
    return 0 if rc == 0 and refused == len(MUTANTS) else 1


if __name__ == "__main__":
    sys.exit(main())
