"""The sorted lanes' spatial keys (the port of
``rtow_tpu/ops/wavefront_sorted.py``'s ``sort_keys``, :77): the key
kernel ``csrc/sort_keys.cu`` and its plain PyTorch version.  The sorted
wavefront (``ops/wavefront.py``) sorts K3's lanes by them before every
bounce, and the gradient path (``ops/grad.py``) sorts its lanes by them
where it sorts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

DEAD_KEY = 0x7FFFFFFF

_F32 = torch.float32


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Interleave the low 10 bits of ``x`` (int64) with two zero bits
    each."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def sort_keys(ray: torch.Tensor, alive: torch.Tensor, bmin: torch.Tensor,
              inv_ext: torch.Tensor) -> torch.Tensor:
    """Spatial key of every lane -> (L,) int64, dead lanes ``DEAD_KEY``
    (``sort_keys``, :77).  ``ray``: a float32 tensor whose first six rows
    are ox oy oz dx dy dz, lanes adjacent (a row stride beyond L will do:
    the sorted wavefront passes its packed state or a window of it, the
    gradient path its ``cont``); ``alive``: the (L,) alive row, int32 (the
    gradient path's ``ints[0]``) or float32 (the state's row 13), live
    where > 0; ``bmin``, ``inv_ext``: the (3,) float32 grid.

    A CUDA ``ray`` launches ``csrc/sort_keys.cu`` (counted in
    ``sort_keys.launches``): the live direction range and the keys on the
    card, a fixed two launches whatever L, no host round trip.  A CPU
    ``ray`` runs :func:`sort_keys_reference`; any other device raises.
    Both give the same keys, bit for bit."""
    _check_keys(ray, alive, bmin, inv_ext)
    if ray.device.type == "cpu":
        return sort_keys_reference(ray, alive, bmin, inv_ext)
    n = ray.shape[1]
    out = torch.empty(n, dtype=torch.int64, device=ray.device)
    index, stream = _cuda.device_args(ray)
    scratch = _KEY_SCRATCH.get((index, stream))
    if scratch is None:  # the ticket counter (0), lo and scale, partials
        scratch = torch.zeros(1 + 6 + 6 * KEY_MAX_CTAS, dtype=torch.int32,
                              device=ray.device)
        _KEY_SCRATCH[(index, stream)] = scratch
    n_cta = min(-(-n // (256 * 4)), KEY_MAX_CTAS)
    lib = _keys_lib()
    err = lib.rtow_sort_keys(
        ray.data_ptr(), ray.stride(0), alive.data_ptr(),
        int(alive.dtype == _F32), n, bmin.data_ptr(), inv_ext.data_ptr(),
        scratch.data_ptr(), n_cta, out.data_ptr(), index, stream)
    _cuda.check_launch(lib, err, "sort_keys")
    sort_keys.launches += 1
    return out


#: Calls of the key kernel made by :func:`sort_keys` in this process (each
#: issues its two launches, the range and the keys).
sort_keys.launches = 0

#: The most CTAs of the key kernel's range pass (each strides over at
#: least 1,024 lanes).
KEY_MAX_CTAS = 1024

#: The key kernel's scratch, by (device index, stream handle).
_KEY_SCRATCH: dict = {}


def _check_keys(ray, alive, bmin, inv_ext) -> None:
    """Raise unless the key kernel (or its plain version, on the CPU)
    takes these operands."""
    dev = ray.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no sort_keys kernel for device {dev}")
    if ray.dtype != _F32 or ray.dim() != 2 or ray.shape[0] < 6 \
            or (ray.shape[1] > 1 and ray.stride(1) != 1):
        raise ValueError(f"ray must be float32 rows (>= 6, L) with adjacent "
                         f"lanes, got {tuple(ray.shape)} {ray.dtype} "
                         f"strides {ray.stride()}")
    n = ray.shape[1]
    if alive.dtype not in (torch.int32, _F32) \
            or tuple(alive.shape) != (n,) or not alive.is_contiguous():
        raise ValueError(f"alive must be a contiguous ({n},) int32 or "
                         f"float32 row, got {tuple(alive.shape)} "
                         f"{alive.dtype}")
    for name, t in (("bmin", bmin), ("inv_ext", inv_ext)):
        if t.dtype != _F32 or tuple(t.shape) != (3,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (3,) float32 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if any(t.device != dev for t in (alive, bmin, inv_ext)):
        raise ValueError("ray, alive, bmin and inv_ext must share a device")


@functools.lru_cache(maxsize=None)
def _keys_lib() -> ctypes.CDLL:
    """``csrc/sort_keys.cu``, built at first use, with its C entry point
    declared."""
    lib = _cuda.load("sort_keys")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rtow_sort_keys.argtypes = [p, q, p, i, i, p, p, p, i, p, i, p]
    lib.rtow_sort_keys.restype = i
    return lib


def sort_keys_reference(ray, alive: torch.Tensor, bmin: torch.Tensor,
                        inv_ext: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`sort_keys`, in PyTorch operators.

    A 30-bit Morton code whose 3-bit groups alternate origin and
    direction, origin first: the origin quantised to 5 bits per axis on
    the fixed scene grid (``bmin``, ``inv_ext``), the unit direction to 5
    bits per axis over the live lanes' range.  1/sqrt where JAX has
    rsqrt (CUDA's rsqrtf is not IEEE)."""
    ox, oy, oz, dx, dy, dz = ray[:6]
    live = alive > 0
    lim = 31.0

    def qorig(o, a):
        return torch.clamp((o - bmin[a]) * inv_ext[a] * lim, 0.0, lim)

    ocode = (_spread3(qorig(ox, 0).long()) | (_spread3(qorig(oy, 1).long()) << 1)
             | (_spread3(qorig(oz, 2).long()) << 2))
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    big = 3.0e38
    # The scale's numerator on the lanes' device: a tensor divided by a
    # host scalar becomes a reciprocal product on the card.
    top = torch.full((), lim + 0.999, dtype=_F32, device=ox.device)

    def qdir(d):
        nd = d * inv_len
        lo = torch.where(live, nd, big).min()
        hi = torch.where(live, nd, -big).max()
        scale = top / torch.clamp(hi - lo, min=1e-6)
        return torch.clamp((nd - lo) * scale, 0.0, lim)

    dcode = (_spread3(qdir(dx).long()) | (_spread3(qdir(dy).long()) << 1)
             | (_spread3(qdir(dz).long()) << 2))
    key = torch.zeros_like(ocode)
    for i in range(4, -1, -1):  # the most significant triplets first
        key = (key << 3) | ((ocode >> (3 * i)) & 7)
        key = (key << 3) | ((dcode >> (3 * i)) & 7)
    return torch.where(live, key, DEAD_KEY)
