"""Kernel-speed gradients for sphere scenes (the port of the sphere subset
of ``rtow_tpu/ops/pallas_grad.py``).

One differentiable bounce is :class:`BounceGrad`, the counterpart of the
``bounce_grad`` custom_vjp (:573): its forward is the bounce kernel K4,
its backward the kernel K5, which replays the bounce from the saved input
state (the counter RNG makes the sweep, the draws and every discrete
decision reproduce exactly) and runs the adjoint of the shade.

* :func:`bounce_fwd` is K4's wrapper: on a CUDA table it launches
  ``csrc/grad_fwd.cu``, on a CPU table it runs
  :func:`bounce_fwd_reference`, on anything else it raises.
* :func:`bounce_bwd` is K5's: ``csrc/grad_bwd.cu`` or
  :func:`bounce_bwd_reference` (autograd through the plain shade).

:func:`render_rays_kernel` chains ``max_depth + 1`` bounces over
(pixel x sample) lanes; autograd's tape of the bounces' saved inputs
plays the role of the ``lax.scan`` carries.  The table cotangent flows
back into the Scene's leaves through ``build_sphere_table``'s gathers.

Lane state: ``cont`` (13, L) float32 = ox oy oz dx dy dz tm tpr tpg tpb
rr rg rb, ``ints`` (3, L) int32 = alive, bounce, lane id.  L is a
multiple of 1,024; padding lanes are dead.  The RNG salt is the bounce's
scan step ``it`` (0..max_depth), the same for every lane.

Covered: spheres, the sky or a flat background, Lambertian / metal /
dielectric.  Triangles, NEE, media, emission, checker and image
textures, sorted lanes and the sharded step raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Tuple, Union

import torch

from ..models.camera import Camera, Rays, camera_rays, pixel_coords
from ..models.scene import DIELECTRIC, Scene
from . import _cuda
from .megakernel import (
    BIG, TBL_COLS, background_args, build_sphere_table, check_table,
    draw_scatter, lane_hash, lane_state, nearest_sphere, shade, step_salt,
    winner_rows,
)

#: Continuous (cotangent-bearing) state rows.
N_CONT = 13
#: Winner-row columns that carry a cotangent (c0, dc, r, albedo, fuzz,
#: ir, kind; kind's is 0).
_N_PARAMS = 13

_F32 = torch.float32
_I32 = torch.int32


# ---------------------------------------------------------------------------
# The plain versions.


def _sweep_live(tbl, cont, alive) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_t, best_k) of the live lanes over the whole table; dead lanes
    get (BIG, 0).  The (chunk, 128) pair temporaries bound the chunk."""
    n = cont.shape[1]
    best_t = torch.full((n,), BIG, dtype=_F32, device=cont.device)
    best_k = torch.zeros((n,), dtype=torch.int64, device=cont.device)
    live = torch.nonzero(alive).flatten()
    chunk = 1 << 18 if cont.device.type == "cuda" else 1 << 14
    for start in range(0, live.numel(), chunk):
        idx = live[start:start + chunk]
        ox, oy, oz, dx, dy, dz, tm = cont[:7, idx]
        a = dx * dx + dy * dy + dz * dz
        best_t[idx], best_k[idx] = nearest_sphere(tbl, ox, oy, oz, dx, dy,
                                                  dz, tm, a, 1.0 / a)
    return best_t, best_k


def _replay(cont, ints, tbl, it, seed):
    """The bounce's discrete half: (alive, best_t, best_k, draws)."""
    alive = ints[0] > 0
    with torch.no_grad():
        best_t, best_k = _sweep_live(tbl, cont, alive)
    lane = lane_hash(ints[2].long())
    return alive, best_t, best_k, draw_scatter(lane, step_salt(seed, it))


def bounce_fwd_reference(cont, ints, tbl, *, it: int, seed: int,
                         max_depth: int, background="sky"):
    """Plain PyTorch version of K4: one bounce of every lane ->
    (cont, ints).  Same inputs and outputs as :func:`bounce_fwd`."""
    alive, best_t, best_k, draws = _replay(cont, ints, tbl, it, seed)
    state, can, bounce = shade(
        tuple(cont.unbind(0)), winner_rows(tbl, best_t, best_k), draws,
        best_t, alive, ints[1], max_depth, background)
    return torch.stack(state), torch.stack([can.to(_I32), bounce, ints[2]])


def bounce_bwd_reference(cont, ints, cot_out, tbl, *, it: int, seed: int,
                         max_depth: int, background="sky"):
    """Plain PyTorch version of K5 -> (cot_in (13, L), g_tbl (Npad, 16)).

    Replays the sweep and the draws, then takes ``torch.autograd.grad``
    of the plain shade w.r.t. the input state and the winner rows; each
    hit lane's row cotangent is added to its winner's row of ``g_tbl``
    (``pallas_grad.py:444-498``).  ``tm`` passes through the bounce, so
    its cotangent gets the downstream one added (:433-436): the stacked
    output below holds that identity."""
    alive, best_t, best_k, draws = _replay(cont, ints, tbl, it, seed)
    hit = best_t < BIG
    with torch.enable_grad():
        state = cont.detach().requires_grad_(True)
        rows = tbl.detach()[best_k, :_N_PARAMS].requires_grad_(True)
        out, _can, _bounce = shade(
            tuple(state.unbind(0)), torch.where(hit[:, None], rows, 0.0),
            draws, best_t, alive, ints[1], max_depth, background)
        cot_in, g_rows = torch.autograd.grad(torch.stack(out), (state, rows),
                                             cot_out)
    g_params = torch.zeros((tbl.shape[0], _N_PARAMS), dtype=_F32,
                           device=tbl.device)
    g_params.index_add_(0, best_k[hit], g_rows[hit])
    g_tbl = torch.cat([g_params, g_params.new_zeros(
        (tbl.shape[0], TBL_COLS - _N_PARAMS))], dim=1)
    return cot_in, g_tbl


# ---------------------------------------------------------------------------
# The wrappers.


def _check_state(tbl, cont, ints, cot=None) -> None:
    n = cont.shape[-1]
    for name, t, dtype, rows in (("cont", cont, _F32, N_CONT),
                                 ("ints", ints, _I32, 3),
                                 ("cot_out", cot, _F32, N_CONT)):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != (rows, n) \
                or not t.is_contiguous() or t.device != tbl.device:
            raise ValueError(
                f"{name} must be a contiguous ({rows}, L) {dtype} tensor on "
                f"the table's device, got {tuple(t.shape)} {t.dtype} "
                f"{t.device}")
    if not 0 < n < (1 << 31):
        raise ValueError(f"bad lane count {n}")


def _scalars(it, seed, max_depth):
    for v in (it, seed, max_depth):
        if not -(1 << 31) <= int(v) < (1 << 31):
            raise ValueError(f"kernel scalar {v} does not fit in int32")
    return int(it), int(seed), int(max_depth)


def bounce_fwd(cont: torch.Tensor, ints: torch.Tensor, tbl: torch.Tensor, *,
               it: int, seed: int, max_depth: int,
               background: Union[str, tuple] = "sky"):
    """One forward bounce (``_bounce_fwd_impl``, :592) -> (cont, ints).

    A CUDA ``tbl`` launches ``csrc/grad_fwd.cu`` (counted in
    ``bounce_fwd.launches``); a CPU ``tbl`` runs
    :func:`bounce_fwd_reference`; any other device raises."""
    check_table(tbl, "grad_fwd kernel")
    _check_state(tbl, cont, ints)
    it, seed, max_depth = _scalars(it, seed, max_depth)
    if tbl.device.type == "cpu":
        return bounce_fwd_reference(cont, ints, tbl, it=it, seed=seed,
                                    max_depth=max_depth,
                                    background=background)
    lib = _lib("grad_fwd")
    use_sky, (bgr, bgg, bgb) = background_args(background)
    cont_out = torch.empty_like(cont)
    ints_out = torch.empty_like(ints)
    err = lib.rtow_grad_fwd(
        tbl.data_ptr(), tbl.shape[0], cont.data_ptr(), ints.data_ptr(),
        cont.shape[1], it, seed, max_depth, int(use_sky), bgr, bgg, bgb,
        cont_out.data_ptr(), ints_out.data_ptr(), *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "grad_fwd")
    bounce_fwd.launches += 1
    return cont_out, ints_out


#: Kernel launches made by :func:`bounce_fwd` in this process.
bounce_fwd.launches = 0


def bounce_bwd(cont: torch.Tensor, ints: torch.Tensor, cot_out: torch.Tensor,
               tbl: torch.Tensor, *, it: int, seed: int, max_depth: int,
               background: Union[str, tuple] = "sky"):
    """One backward bounce (``_bounce_grad_bwd``, :639) from the bounce's
    saved input state -> (cot_in (13, L), g_tbl (Npad, 16)).

    A CUDA ``tbl`` launches ``csrc/grad_bwd.cu`` (counted in
    ``bounce_bwd.launches``); a CPU ``tbl`` runs
    :func:`bounce_bwd_reference`; any other device raises."""
    check_table(tbl, "grad_bwd kernel", copies=2)
    _check_state(tbl, cont, ints, cot_out)
    it, seed, max_depth = _scalars(it, seed, max_depth)
    if tbl.device.type == "cpu":
        return bounce_bwd_reference(cont, ints, cot_out, tbl, it=it,
                                    seed=seed, max_depth=max_depth,
                                    background=background)
    lib = _lib("grad_bwd")
    use_sky, (bgr, bgg, bgb) = background_args(background)
    cot_in = torch.empty_like(cot_out)
    g_tbl = torch.zeros_like(tbl)
    err = lib.rtow_grad_bwd(
        tbl.data_ptr(), tbl.shape[0], cont.data_ptr(), ints.data_ptr(),
        cot_out.data_ptr(), cont.shape[1], it, seed, max_depth, int(use_sky),
        bgr, bgg, bgb, cot_in.data_ptr(), g_tbl.data_ptr(),
        *_cuda.device_args(tbl))
    _cuda.check_launch(lib, err, "grad_bwd")
    bounce_bwd.launches += 1
    return cot_in, g_tbl


#: Kernel launches made by :func:`bounce_bwd` in this process.
bounce_bwd.launches = 0


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` (grad_fwd or grad_bwd), built at first use, with
    its launcher declared."""
    lib = _cuda.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "grad_fwd":
        lib.rtow_grad_fwd.argtypes = [p, i, p, p, i, i, i, i, i, f, f, f, p, p,
                                      i, p]
        lib.rtow_grad_fwd.restype = i
    else:
        lib.rtow_grad_bwd.argtypes = [p, i, p, p, p, i, i, i, i, i, f, f, f,
                                      p, p, i, p]
        lib.rtow_grad_bwd.restype = i
    return lib


class BounceGrad(torch.autograd.Function):
    """One differentiable bounce (``pallas_grad.bounce_grad``, :573):
    (cont, ints) -> (cont, ints), differentiable in ``cont`` and ``tbl``.

    The forward is :func:`bounce_fwd` and saves its input state (the
    tape); the backward is :func:`bounce_bwd` on that state.  ``ints``
    carries no cotangent."""

    @staticmethod
    def forward(ctx, cont, ints, tbl, it, seed, max_depth, background):
        cont_out, ints_out = bounce_fwd(cont, ints, tbl, it=it, seed=seed,
                                        max_depth=max_depth,
                                        background=background)
        ctx.save_for_backward(cont, ints, tbl)
        ctx.scalars = dict(it=it, seed=seed, max_depth=max_depth,
                           background=background)
        ctx.mark_non_differentiable(ints_out)
        return cont_out, ints_out

    @staticmethod
    def backward(ctx, g_cont, _g_ints):
        cont, ints, tbl = ctx.saved_tensors
        cot_in, g_tbl = bounce_bwd(cont, ints, g_cont.contiguous(), tbl,
                                   **ctx.scalars)
        return cot_in, None, g_tbl, None, None, None, None


def bounce_grad(cont, ints, tbl, *, it: int, seed: int, max_depth: int,
                background: Union[str, tuple] = "sky"):
    """:class:`BounceGrad` applied to one bounce."""
    return BounceGrad.apply(cont, ints, tbl, it, seed, max_depth, background)


# ---------------------------------------------------------------------------
# The differentiable render.


def _check_scene(scene: Scene) -> None:
    if scene.triangles.verts.shape[0]:
        raise NotImplementedError(
            "triangles in the gradient kernels are not ported yet "
            "(ROADMAP Queue 1 item 10)")
    if (bool((scene.materials.kind > DIELECTRIC).any())
            or scene.has_emissive or scene.has_checker):
        raise NotImplementedError(
            "emissive, checker, noise and image-texture materials in the "
            "gradient kernels are not ported yet (ROADMAP Queue 1 item 10)")
    if scene.volume_kinds:
        raise NotImplementedError(
            "constant-density media in the gradient kernels are not ported "
            "yet (ROADMAP Queue 1 item 10)")


def render_rays_kernel(scene: Scene, rays: Rays, *, n_pixels: int, spp: int,
                       max_depth: int, seed: int = 0) -> torch.Tensor:
    """Differentiable mean radiance of ``n_pixels`` pixels -> (P, 3), from
    their ``n_pixels * spp`` camera rays in (pixel, sample) order (the
    lane half of ``render_pixels_kernel``, pallas_grad.py:915-1001):
    :func:`lane_state`, then ``max_depth + 1`` bounces of
    :class:`BounceGrad`.  The render runs on the scene's device: the
    kernels on a card, their plain versions on the CPU."""
    _check_scene(scene)
    tbl, _boxes = build_sphere_table(scene)
    l_raw = n_pixels * spp
    cont, ints = lane_state(rays, l_raw, scene.device)
    for it in range(max_depth + 1):
        cont, ints = bounce_grad(cont, ints, tbl, it=it, seed=seed,
                                 max_depth=max_depth,
                                 background=scene.background)
    return cont[10:13, :l_raw].T.reshape(n_pixels, spp, 3).mean(dim=1)


def render_pixels_kernel(
    scene: Scene,
    camera: Camera,
    gen: torch.Generator,
    pixel_ids,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed: int = 0,
    jitter: bool = True,
    sort_lanes=None,
    nee: bool = False,
    grad_reduce_axes: Tuple = (),
) -> torch.Tensor:
    """Differentiable mean radiance of the given pixels -> (P, 3)
    (``render_pixels_kernel``, pallas_grad.py:761): camera rays from
    ``gen`` (a ``torch.Generator`` on the scene's device, in place of the
    JAX key) and :func:`render_rays_kernel`.  ``jitter=False`` pins rays
    to pixel centres (FD gates).  Gradients reach every scene leaf that
    ``build_sphere_table`` reads (sphere centers and radii, albedo, fuzz,
    ir)."""
    if sort_lanes:
        raise NotImplementedError(
            "sort_lanes=True needs the sorted-lane permutation "
            "(ROADMAP Queue 1 item 10)")
    if nee:
        raise NotImplementedError(
            "nee=True needs NEE in the gradient kernels "
            "(ROADMAP Queue 1 item 10)")
    if grad_reduce_axes:
        raise NotImplementedError(
            "grad_reduce_axes needs the sharded train step "
            "(ROADMAP Queue 1 item 11)")
    pixel_ids = torch.as_tensor(pixel_ids, device=scene.device).long()
    lane_pix = pixel_ids.repeat_interleave(spp)
    if jitter:
        s, t = pixel_coords(width, height, gen, lane_pix)
    else:
        row, col = lane_pix // width, lane_pix % width
        s = (col.to(_F32) + 0.5) / (width - 1)
        t = ((height - 1 - row).to(_F32) + 0.5) / (height - 1)
    return render_rays_kernel(scene, camera_rays(camera, gen, s, t),
                              n_pixels=pixel_ids.shape[0], spp=spp,
                              max_depth=max_depth, seed=seed)


def scene_value_and_grad(fn: Callable[[Scene], torch.Tensor],
                         scene: Scene) -> Tuple[torch.Tensor, Scene]:
    """(fn(scene), d fn / d scene) for a scalar ``fn``: the counterpart of
    ``jax.value_and_grad(fn, allow_int=True)``.  The gradient is a Scene
    whose float leaves hold the gradients (zeros where ``fn`` does not
    read the leaf) and whose integer leaves are None."""
    leaves = scene.leaves()
    params = {k: v.detach().requires_grad_(True)
              for k, v in leaves.items() if v.is_floating_point()}
    with torch.enable_grad():
        value = fn(scene.replace_leaves(params))
        grads = torch.autograd.grad(value, list(params.values()),
                                    allow_unused=True)
    out = {k: None for k in leaves}
    for (k, p), g in zip(params.items(), grads):
        out[k] = torch.zeros_like(p) if g is None else g
    return value.detach(), scene.replace_leaves(out)


def loss_and_grad_kernel(scene: Scene, camera: Camera, gen: torch.Generator,
                         target, pixel_ids,
                         **render_kw) -> Tuple[torch.Tensor, Scene]:
    """(loss, dloss/dscene) of the pixel MSE with kernel-speed forward and
    backward (``loss_and_grad_kernel``, pallas_grad.py:1004)."""
    target = torch.as_tensor(target, dtype=_F32, device=scene.device)

    def mse(s):
        img = render_pixels_kernel(s, camera, gen, pixel_ids, **render_kw)
        return torch.mean((img - target) ** 2)

    return scene_value_and_grad(mse, scene)
