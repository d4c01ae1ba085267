"""The sphere-sweep probe T1: the sweep's pair quadratic in its CUDA-core
form and in its matrix form on the tensor cores (the port of
``tools/mxu_probe.py:_build``, four kinds in one ``pallas_call``).

    python -m rtow_tpu_torch.tools.mxu_probe [iters] [n_blocks] [tiles]
        [--device cuda|cpu]

Defaults 40, 4 and 64, as the JAX probe's.  Every lane of ``tiles`` 8x128
lane tiles runs, ``iters`` times, a nearest-hit sweep over ``n_blocks``
blocks of 128 moving spheres: per block the first minimal t, taken where
it is strictly below the best so far, then the winner's 13 parameters;
each iteration adds ``t_ok + c0x / 4 + dcx / 2 + r`` of the winner to the
lane's output (the JAX carry's ``res[2] * 0.25 + res[5] * 0.5 + res[8]``,
:193-202).
The kinds compute that same function in four forms:

* ``vpu``: the pair quadratic on the CUDA cores, the winner fetched by
  index (``_vpu_kernel``);
* ``mxu_f``: the same sweep, the winner fetched as a one-hot x block
  product on the tensor cores (``_vpu_kernel(mxu_fetch=True)``);
* ``mxu``: the h and c terms as a (256, 16) x (16, lanes) product on the
  tensor cores from weights built on the host in float64
  (:func:`mxu_weights`), then the quadratic, min and argmin on the CUDA
  cores and the fetch as a product, one row of 128 lanes per CTA
  (``_mxu_kernel``);
* ``mxu_b``: the same, one 8-row tile per CTA (the batched
  ``dot_general``).

``Precision.HIGHEST`` becomes 3xTF32 in the kernels (hi x hi + hi x lo +
lo x hi, float32 accumulation, ``mma.sync`` m16n8k8).  The plain version
(:func:`probe_reference`) is the probe's arithmetic in float32 PyTorch,
with TF32 off for its products.  :func:`probe` is the wrapper: the kernel
(``csrc/mxu_probe.cu``) on a CUDA tensor, the plain version on a CPU
tensor.  ``main`` prints what the JAX probe prints: each kind's time and
pair rate, and each kind against ``vpu`` (the matrix form's float32
cancellation on the r = 1000 ground sphere is what the probe measures).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time

import numpy as np
import torch

from ..ops import _cuda

ROWS, LANES = 8, 128
NSPH = 128  # spheres per block
NPAR = 13  # fetched parameters per winner
BIG = float(np.float32(3.0e38))
T_MIN = float(np.float32(1e-3))
KINDS = ("vpu", "mxu", "mxu_b", "mxu_f")
#: Shared memory a block can hold on Hopper: "vpu" and "mxu_f" keep the
#: whole table there, and "mxu_f" a 2 KB fetch buffer per warp.
MAX_SHARED_BYTES = 232448
_F32 = torch.float32


# ---------------------------------------------------------------------------
# Inputs, in the JAX probe's distributions (:56-89), from numpy.


def sphere_table(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    """(n_blocks * 128, 16) float32 cover-like table: c0 dc r albedo
    fuzz ir kind and 3 zeros; about 30% of the spheres move; row 0 is the
    r = 1000 ground sphere (the float32 cancellation's stress case)."""
    n = n_blocks * NSPH
    c0 = rng.uniform(-11.0, 11.0, (n, 3))
    c0[:, 1] = np.abs(c0[:, 1]) * 0.05 + 0.2
    dc = rng.uniform(0.0, 0.5, (n, 3)) * (rng.uniform(size=(n, 1)) < 0.3)
    r = rng.uniform(0.15, 0.25, n)
    c0[0], dc[0], r[0] = (0.0, -1000.0, 0.0), 0.0, 1000.0
    alb = rng.uniform(size=(n, 3))
    misc = rng.uniform(size=(n, 3))
    return np.concatenate([c0, dc, r[:, None], alb, misc, np.zeros((n, 3))],
                          axis=1).astype(np.float32)


def lane_state(rng: np.random.Generator, n_tiles: int) -> np.ndarray:
    """(7, n_tiles * 8, 128) float32 lanes: ox oy oz dx dy dz tm."""
    shape = (n_tiles * ROWS, LANES)
    return np.stack([
        rng.uniform(-10.0, 10.0, shape), rng.uniform(0.0, 3.0, shape),
        rng.uniform(-10.0, 10.0, shape), rng.standard_normal(shape),
        rng.standard_normal(shape), rng.standard_normal(shape),
        rng.uniform(size=shape)]).astype(np.float32)


def mxu_weights(tbl: np.ndarray) -> np.ndarray:
    """(2N, 16) float32 h / c weights of an (N, 16) table, built in
    float64 (the JAX probe's ``_mxu_weights``, :92-127).

    Lane features: dx dy dz, tm d, ox oy oz, tm o, 1, tm, tm^2, 0, so that
    h = o.d + W_h f and c = o.o + W_c f.  Block b's rows are W_h of its
    128 spheres, then their W_c."""
    t = np.asarray(tbl, np.float64)
    c0, dc, r = t[:, 0:3], t[:, 3:6], t[:, 6]
    n = t.shape[0]
    z = np.zeros((n,))
    wh = np.stack(
        [-c0[:, 0], -c0[:, 1], -c0[:, 2], -dc[:, 0], -dc[:, 1], -dc[:, 2],
         z, z, z, z, z, z, z, z, z, z], axis=1)
    cc0 = (c0 * c0).sum(1) - r * r
    c0dc = (c0 * dc).sum(1)
    dc2 = (dc * dc).sum(1)
    wc = np.stack(
        [z, z, z, z, z, z,
         -2.0 * c0[:, 0], -2.0 * c0[:, 1], -2.0 * c0[:, 2],
         -2.0 * dc[:, 0], -2.0 * dc[:, 1], -2.0 * dc[:, 2],
         cc0, 2.0 * c0dc, dc2, z], axis=1)
    nb = n // NSPH
    w = np.concatenate(
        [wh.reshape(nb, NSPH, 16), wc.reshape(nb, NSPH, 16)], axis=1
    ).reshape(2 * n, 16)
    return w.astype(np.float32)


def inputs(n_blocks: int, n_tiles: int, seed: int = 7):
    """(table, weights, lane state) as numpy float32 arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    tbl = sphere_table(rng, n_blocks)
    return tbl, mxu_weights(tbl), lane_state(rng, n_tiles)


# ---------------------------------------------------------------------------
# The plain version.


def _quadratic(h, cc, a, inv_a, best_t):
    """The pair test from h and c: (L, 128) t of each pair, BIG on a
    miss (``_vpu_kernel``'s sweep, :158-170)."""
    disc = h * h - a[:, None] * cc
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    near = (-h - sq) * inv_a[:, None]
    far = (-h + sq) * inv_a[:, None]
    bt = best_t[:, None]
    near_ok = (near >= T_MIN) & (near <= bt)
    far_ok = (far >= T_MIN) & (far <= bt)
    t_pair = torch.where(near_ok, near, far)
    return torch.where(pos & (near_ok | far_ok), t_pair, BIG)


def probe_reference(kind: str, tbl: torch.Tensor, w: torch.Tensor,
                    state: torch.Tensor, *, n_blocks: int,
                    iters: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe`, on ``tbl``'s device: the
    probe's arithmetic in float32, the matrix forms' products by
    ``torch.matmul`` with TF32 off.  Every iteration sweeps the same
    lanes, so one sweep serves all ``iters`` sums."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    ox, oy, oz, dx, dy, dz, tm = (x.flatten() for x in state)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    matrix = kind in ("mxu", "mxu_b")
    if matrix:
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        feat = torch.stack([dx, dy, dz, tm * dx, tm * dy, tm * dz, ox, oy,
                            oz, tm * ox, tm * oy, tm * oz, torch.ones_like(tm),
                            tm, tm * tm, torch.zeros_like(tm)], dim=1)
    best_t = torch.full_like(ox, BIG)
    params = torch.zeros((NPAR, ox.numel()), dtype=_F32, device=ox.device)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for b in range(n_blocks):
            blk = tbl[b * NSPH:(b + 1) * NSPH]
            if matrix:
                hc = feat @ w[b * 2 * NSPH:(b + 1) * 2 * NSPH].T
                h = hc[:, :NSPH] + od[:, None]
                cc = hc[:, NSPH:] + oo[:, None]
            else:
                ocx = ox[:, None] - (blk[:, 0] + tm[:, None] * blk[:, 3])
                ocy = oy[:, None] - (blk[:, 1] + tm[:, None] * blk[:, 4])
                ocz = oz[:, None] - (blk[:, 2] + tm[:, None] * blk[:, 5])
                h = ocx * dx[:, None] + ocy * dy[:, None] + ocz * dz[:, None]
                cc = (ocx * ocx + ocy * ocy + ocz * ocz
                      - blk[:, 6] * blk[:, 6])
            bt, bk = _quadratic(h, cc, a, inv_a, best_t).min(dim=1)
            if kind == "vpu":
                fetched = blk[bk, :NPAR].T
            else:  # the one-hot x block product
                onehot = (bk[:, None] == torch.arange(
                    NSPH, device=bk.device)).to(_F32)
                fetched = (onehot @ blk)[:, :NPAR].T
            upd = bt < best_t
            best_t = torch.where(upd, bt, best_t)
            params = torch.where(upd, fetched, params)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    t_ok = torch.where(best_t < BIG, best_t, 0.0)
    acc = torch.zeros_like(ox)
    for _ in range(iters):
        acc = acc + t_ok + params[0] * 0.25 + params[3] * 0.5 + params[6]
    return acc.view(state.shape[1:])


# ---------------------------------------------------------------------------
# The wrapper.


def check_inputs(tbl, w, state, n_blocks: int, iters: int) -> None:
    """Raise unless the three are contiguous float32 tensors on one device
    of the probe's shapes, and the counts are positive."""
    shapes = ((tbl, (n_blocks * NSPH, 16)), (w, (2 * n_blocks * NSPH, 16)))
    ok = (n_blocks >= 1 and iters >= 1 and state.dim() == 3
          and state.shape[0] == 7 and state.shape[1] % ROWS == 0
          and state.shape[1] > 0 and state.shape[2] == LANES)
    for t, shape in shapes + ((state, tuple(state.shape)),):
        ok = ok and (t.dtype == _F32 and tuple(t.shape) == shape
                     and t.is_contiguous() and t.device == tbl.device)
    if not ok:
        raise ValueError(
            f"probe inputs must be contiguous float32 ({n_blocks * NSPH}, "
            f"16), ({2 * n_blocks * NSPH}, 16) and (7, tiles * 8, 128) "
            f"tensors on one device, n_blocks and iters >= 1")


def probe(kind: str, tbl: torch.Tensor, w: torch.Tensor,
          state: torch.Tensor, *, n_blocks: int, iters: int) -> torch.Tensor:
    """(tiles * 8, 128) float32 probe output of ``kind`` (``_build``,
    :338).  ``tbl``: (n_blocks * 128, 16) table; ``w``: (2 * n_blocks *
    128, 16) weights from :func:`mxu_weights`; ``state``: (7, tiles * 8,
    128) lanes.  A CUDA ``tbl`` launches the kernel (counted in
    ``probe.launches``), a CPU ``tbl`` runs :func:`probe_reference`, any
    other device raises."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    check_inputs(tbl, w, state, n_blocks, iters)
    if tbl.device.type == "cpu":
        return probe_reference(kind, tbl, w, state, n_blocks=n_blocks,
                               iters=iters)
    if tbl.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {tbl.device}")
    if tbl.numel() * 4 + 256 * 16 * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"{n_blocks} sphere blocks exceed the probe's "
                         f"shared-memory table ({MAX_SHARED_BYTES} bytes)")
    out = torch.empty(state.shape[1:], dtype=_F32, device=tbl.device)
    lib = _lib()
    err = lib.rtow_mxu_probe(KINDS.index(kind), tbl.data_ptr(), w.data_ptr(),
                             state.data_ptr(), state.shape[1] * LANES,
                             n_blocks, iters, out.data_ptr(),
                             *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, f"mxu_probe {kind}")
    probe.launches += 1
    return out


#: Kernel launches made by :func:`probe` in this process.
probe.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/mxu_probe.cu``, built at first use, with its C entry point
    declared."""
    lib = _cuda.load("mxu_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rtow_mxu_probe.argtypes = [i, p, p, p, i, i, i, p, i, p]
    lib.rtow_mxu_probe.restype = i
    return lib


def compare(got: np.ndarray, ref: np.ndarray):
    """(max |d|, max relative d, share of lanes with relative d > 1e-3),
    relative to max(|ref|, 1e-3): the JAX probe's agreement numbers."""
    d = np.abs(ref - got)
    rel = d / np.maximum(np.abs(ref), 1e-3)
    return float(d.max()), float(rel.max()), float((rel > 1e-3).mean())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="*", type=int,
                   help="iters n_blocks tiles (default 40 4 64)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain version)")
    opts = p.parse_args(argv)
    iters, n_blocks, n_tiles = (list(opts.sizes) + [40, 4, 64][
        len(opts.sizes):])[:3]
    dev = torch.device(opts.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mxu_probe: needs an NVIDIA GPU (or --device cpu)")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain version)")
    tbl, w, state = (torch.from_numpy(x).to(dev)
                     for x in inputs(n_blocks, n_tiles))
    print(f"probe on {name}: {n_tiles} tiles x {iters} iters x {n_blocks} "
          f"blocks", file=sys.stderr)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    outs, times = {}, {}
    for kind in KINDS:
        o = probe(kind, tbl, w, state, n_blocks=n_blocks, iters=iters)
        sync()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            o = probe(kind, tbl, w, state, n_blocks=n_blocks, iters=iters)
            sync()
            reps.append(time.perf_counter() - t0)
        times[kind], outs[kind] = min(reps), o.cpu().numpy()
    for kind, t in times.items():
        pairs = n_tiles * ROWS * LANES * NSPH * n_blocks * iters
        print(f"{kind:6s} {t * 1e3:8.2f} ms   {pairs / t / 1e9:8.1f} Gpairs/s")
    for kind in KINDS[1:]:
        mx, rel, share = compare(outs[kind], outs["vpu"])
        print(f"{kind} vs vpu: max abs diff {mx:.3e}  max rel {rel:.3e}  "
              f"mismatched>1e-3: {share * 100:.4f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
