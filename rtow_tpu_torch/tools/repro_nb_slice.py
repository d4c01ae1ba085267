"""The block-by-block table sum T2 (the port of
``tools/repro_nb_slice.py:make_kernel``, a repro of a TPU runtime abort on
dynamic major-dimension slices of a (NB, 16, 256) VMEM table).

    python -m rtow_tpu_torch.tools.repro_nb_slice [NB ...] [--device cuda|cpu]

Default NB list 256 512 782 1408, each at widths 128 and 256, as the JAX
script.  The function: the first 128 columns of every (16, width) block
of an (NB, 16, width) float32 table, summed block by block, broadcast to
an (8, 128) float32 output.  ``main`` fills the table with ones and
prints ``OK`` where every output element is NB x 16 x 128, else
``WRONG``, per size.

:func:`nb_slice` is the wrapper: the kernel (``csrc/nb_slice.cu``, one
launch: CTAs sum contiguous block ranges, and the last CTA to finish adds
their partials in CTA order, so the result does not change from run to
run) on a CUDA tensor, :func:`nb_slice_reference` (the JAX kernel's loop:
each block's sum added to a float32 accumulator in block order) on a CPU
tensor.  :func:`nb_slice_ordered` is the kernel's own order of the sums
in plain PyTorch, which the kernel equals bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import torch

from ..ops import _cuda

WIDTHS = (128, 256)
DEFAULT_NB = (256, 512, 782, 1408)
#: The kernel's most CTAs: two per SM of an H100.
MAX_CTAS = 264
_F32 = torch.float32


def check_table(tbl: torch.Tensor) -> None:
    """Raise unless ``tbl`` is a contiguous (NB, 16, 128 or 256) float32
    tensor with NB >= 1, 16-byte aligned on a card."""
    if (tbl.dtype != _F32 or tbl.dim() != 3 or tbl.shape[0] < 1
            or tbl.shape[1] != 16 or tbl.shape[2] not in WIDTHS
            or not tbl.is_contiguous()
            or (tbl.device.type == "cuda" and tbl.data_ptr() % 16)):
        raise ValueError(
            f"the table must be a contiguous, 16-byte aligned (NB, 16, 128 "
            f"or 256) float32 tensor, got {tuple(tbl.shape)} {tbl.dtype}")


def nb_slice_reference(tbl: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`nb_slice`, on ``tbl``'s device."""
    acc = torch.zeros((), dtype=_F32, device=tbl.device)
    for b in range(tbl.shape[0]):
        acc = acc + tbl[b, :, :128].sum()
    return acc.expand(8, 128).contiguous()


def nb_slice_ordered(tbl: torch.Tensor) -> torch.Tensor:
    """:func:`nb_slice`'s function summed in the kernel's order, in plain
    PyTorch: each of ``partial_ctas`` CTAs' 256 threads adds its float4s'
    pair sums block by block, a warp's 32 threads are added by a shuffle
    tree, a CTA's 8 warps and then the CTAs' partials one after another.
    float32 additions round alike everywhere, so the kernel's output
    equals this one bit for bit."""
    check_table(tbl)
    nb = tbl.shape[0]
    per = -(-nb // partial_ctas(nb))
    ctas = -(-nb // per)
    v = tbl[:, :, :128].reshape(nb, 16, 32, 4)
    # Thread r * 32 + c reads column group c of rows r, then r + 8.
    q = ((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])).reshape(
        nb, 2, 8, 32)
    s = torch.zeros((ctas, 8, 32), dtype=_F32, device=tbl.device)
    first = torch.arange(ctas, device=tbl.device) * per
    for j in range(per):
        b = first + j
        ok = (b < nb)[:, None, None]
        for half in (0, 1):
            s = torch.where(ok, s + q[b.clamp(max=nb - 1), half], s)
    for off in (16, 8, 4, 2, 1):  # __shfl_down_sync: lane 0's sum
        s = s[..., :off] + s[..., off:2 * off]
    partial = torch.zeros(ctas, dtype=_F32, device=tbl.device)
    for w in range(8):
        partial = partial + s[:, w, 0]
    acc = torch.zeros((), dtype=_F32, device=tbl.device)
    for c in range(ctas):
        acc = acc + partial[c]
    return acc.expand(8, 128).contiguous()


def nb_slice(tbl: torch.Tensor) -> torch.Tensor:
    """(8, 128) float32: the sum of the first 128 columns of every block of
    the (NB, 16, width) table ``tbl`` (``make_kernel``, :30).  A CUDA
    ``tbl`` launches the kernel (counted in ``nb_slice.launches``), a CPU
    ``tbl`` runs :func:`nb_slice_reference`, any other device raises.

    A call allocates only its output: the kernel's partials and ticket
    counter live in a scratch buffer kept per device and stream (made,
    zeroed, at the first call on a stream: make that call before
    capturing a CUDA graph on the stream)."""
    check_table(tbl)
    if tbl.device.type == "cpu":
        return nb_slice_reference(tbl)
    if tbl.device.type != "cuda":
        raise ValueError(f"no nb_slice kernel for device {tbl.device}")
    index, stream = _cuda.device_args(tbl)
    scratch = _SCRATCH.get((index, stream))
    if scratch is None:  # the ticket counter (0), then the partials
        scratch = torch.zeros(1 + MAX_CTAS, dtype=torch.int32,
                              device=tbl.device)
        _SCRATCH[(index, stream)] = scratch
    out = torch.empty((8, 128), dtype=_F32, device=tbl.device)
    lib = _lib()
    err = lib.rtow_nb_slice(tbl.data_ptr(), tbl.shape[0], tbl.shape[2],
                            scratch.data_ptr(), partial_ctas(tbl.shape[0]),
                            out.data_ptr(), index, stream)
    _cuda.check_launch(lib, err, "nb_slice")
    nb_slice.launches += 1
    return out


#: Kernel launches made by :func:`nb_slice` in this process.
nb_slice.launches = 0

#: The kernel's scratch, by (device index, stream handle).
_SCRATCH: dict = {}


def partial_ctas(nb: int) -> int:
    """The kernel's CTAs: at most ``MAX_CTAS``, each summing a contiguous
    range of blocks."""
    return min(nb, MAX_CTAS)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/nb_slice.cu``, built at first use, with its C entry point
    declared."""
    lib = _cuda.load("nb_slice")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rtow_nb_slice.argtypes = [p, i, i, p, i, p, i, p]
    lib.rtow_nb_slice.restype = i
    return lib


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("nbs", nargs="*", type=int, metavar="NB",
                   help=f"block counts (default {' '.join(map(str, DEFAULT_NB))})")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel) or cpu (the plain version)")
    opts = p.parse_args(argv)
    dev = torch.device(opts.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_nb_slice: needs an NVIDIA GPU (or --device "
                         "cpu)")
    for width in WIDTHS:
        for nb in opts.nbs or DEFAULT_NB:
            tbl = torch.ones((nb, 16, width), dtype=_F32, device=dev)
            out = nb_slice(tbl)
            got, want = float(out[0, 0]), nb * 16 * 128
            same = bool((out == want).all())
            ok = "OK " if same else f"WRONG ({got} != {want})"
            print(f"(NB={nb:5d}, 16, {width}): {ok}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
