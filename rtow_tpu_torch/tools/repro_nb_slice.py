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

:func:`nb_slice` is the wrapper: the kernel (``csrc/nb_slice.cu``: CTAs
sum contiguous block ranges, then one CTA adds their partials in block
order, so the result does not change from run to run) on a CUDA tensor,
:func:`nb_slice_reference` (the JAX kernel's loop: each block's sum added
to a float32 accumulator in block order) on a CPU tensor.
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


def nb_slice(tbl: torch.Tensor) -> torch.Tensor:
    """(8, 128) float32: the sum of the first 128 columns of every block of
    the (NB, 16, width) table ``tbl`` (``make_kernel``, :30).  A CUDA
    ``tbl`` launches the kernel (counted in ``nb_slice.launches``), a CPU
    ``tbl`` runs :func:`nb_slice_reference`, any other device raises."""
    check_table(tbl)
    if tbl.device.type == "cpu":
        return nb_slice_reference(tbl)
    if tbl.device.type != "cuda":
        raise ValueError(f"no nb_slice kernel for device {tbl.device}")
    n_cta = partial_ctas(tbl.shape[0])
    partial = torch.empty(n_cta, dtype=_F32, device=tbl.device)
    out = torch.empty((8, 128), dtype=_F32, device=tbl.device)
    lib = _lib()
    err = lib.rtow_nb_slice(tbl.data_ptr(), tbl.shape[0], tbl.shape[2],
                            partial.data_ptr(), n_cta, out.data_ptr(),
                            *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "nb_slice")
    nb_slice.launches += 1
    return out


#: Kernel launches made by :func:`nb_slice` in this process (a launch is
#: both stages).
nb_slice.launches = 0


def partial_ctas(nb: int) -> int:
    """CTAs of the first stage: at most 264 (two per SM of an H100), each
    summing a contiguous range of blocks."""
    return min(nb, 264)


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
