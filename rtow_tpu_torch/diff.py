"""Differentiable rendering: the pixel loss, its gradient, and the
single-device train step (the port of ``rtow_tpu.diff``).

Gradients flow through hit positions, normals and attenuations; the
discrete hit/miss and material selections are piecewise-constant, so
their visibility delta terms are not estimated (standard inverse-
rendering practice, as in the JAX package).  Finite-difference checks
therefore use common random numbers: the same generator state and seed
for every evaluation.

The one renderer ported so far is the kernel path,
``ops/grad.render_pixels_kernel``, so the loss and the step call it
directly: the JAX step's ``renderer`` argument returns with the
reference integrator's ``render_pixels`` (ROADMAP Queue 1 item 5).  The
sharded step with its per-bounce gradient all-reduce (Queue 1 item 11)
is not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .models.camera import Camera
from .models.scene import Scene
from .ops.grad import render_pixels_kernel, scene_grads, scene_params
from .ops.tables import (
    LAYOUT_LEAVES, GradLayout, grad_layout, grad_rows,
)
from .utils.profiling import span


def image_mse(scene: Scene, camera: Camera, gen: torch.Generator, target,
              pixel_ids, **render_kw) -> torch.Tensor:
    """Scalar MSE between the pixels :func:`render_pixels_kernel` renders
    and target rows (``image_mse``, rtow_tpu/diff.py:129); ``render_kw``
    goes to the renderer (``sort_lanes``, ``_force_flat``, ...)."""
    img = render_pixels_kernel(scene, camera, gen, pixel_ids, **render_kw)
    target = torch.as_tensor(target, dtype=img.dtype, device=img.device)
    return torch.mean((img - target) ** 2)


def loss_and_grad(scene: Scene, camera: Camera, gen: torch.Generator,
                  target, pixel_ids, *, sort_lanes=None, nee: bool = False,
                  _force_flat: bool = False,
                  **kw) -> Tuple[torch.Tensor, Scene]:
    """(loss, dloss/dscene) (``loss_and_grad``, :142).  Integer leaves
    get None gradients, which :func:`sgd_update` skips.  ``sort_lanes``,
    ``nee`` and ``_force_flat`` build the scene's tables
    (``grad_tables``), ``kw`` goes to the renderer (``width``, ...).

    Its phases are profiler spans (``utils/profiling.span``):
    ``rtow.train.tables`` (the scene's tables), ``rtow.train.forward``
    (the camera rays, the bounces and the loss) and
    ``rtow.train.backward`` (``autograd.grad`` on this thread, while on
    a card the autograd engine runs K5 on its own thread)."""
    return _loss_and_grad(
        scene, camera, gen, target, pixel_ids,
        lambda s: grad_layout(s, sort_lanes=sort_lanes,
                              force_flat=_force_flat, nee=nee), **kw)


def _loss_and_grad(scene: Scene, camera: Camera, gen: torch.Generator,
                   target, pixel_ids,
                   layout_of: Callable[[Scene], GradLayout],
                   **kw) -> Tuple[torch.Tensor, Scene]:
    """:func:`loss_and_grad` with the scene's layout from
    ``layout_of(scene)`` and its rows gathered from fresh leaves."""
    with span("rtow.train.tables"), torch.enable_grad():
        layout = layout_of(scene)
        params = scene_params(scene)
        watched = scene.replace_leaves(params)
        tables = grad_rows(watched, layout)
    with span("rtow.train.forward"), torch.enable_grad():
        loss = image_mse(watched, camera, gen, target, pixel_ids,
                         tables=tables, **kw)
    with span("rtow.train.backward"):
        return loss.detach(), scene_grads(loss, params, scene)


def sgd_update(scene: Scene, grads: Scene, lr: float) -> Scene:
    """One SGD step on every real-valued leaf (``sgd_update``, :160)."""
    g = grads.leaves()
    return scene.replace_leaves({
        key: (p - lr * g[key]).detach()
        for key, p in scene.leaves().items()
        if g[key] is not None and p.is_floating_point()})


def mask_grads(grads: Scene, keep: Callable[[str], bool]) -> Scene:
    """Zero every gradient leaf whose dotted path fails ``keep``
    (``mask_grads``, :169), e.g. ``keep=lambda p: p.endswith("albedo")``."""
    return grads.replace_leaves({
        key: torch.zeros_like(g) for key, g in grads.leaves().items()
        if g is not None and not keep(key)})


def _unmoved(p: torch.Tensor, lr) -> bool:
    """Whether ``p - lr * 0`` gives ``p`` back bit for bit, so the tensor
    itself can stand for it: ``lr`` a number from +0 to the largest finite
    value of ``p``'s dtype (a negative one turns -0 into +0, one past the
    dtype's range makes the zero a NaN), and ``p`` no autograd leaf (the
    update detaches)."""
    return (isinstance(lr, (int, float)) and not p.requires_grad
            and (0.0 < lr <= torch.finfo(p.dtype).max
                 or (lr == 0.0 and math.copysign(1.0, lr) > 0.0)))


def _masked_update(scene: Scene, grads: Scene, lr: float,
                   keep: Optional[Callable[[str], bool]]) -> Scene:
    """``sgd_update(scene, mask_grads(grads, keep), lr)``, except that a
    leaf ``keep`` rejects comes back as the very tensor it was wherever
    that is the update's value (:func:`_unmoved`): an albedo fit leaves
    the geometry the same tensors, so the step keeps its layout."""
    if keep is not None:
        carried = {key: None for key, p in scene.leaves().items()
                   if not keep(key) and p.is_floating_point()
                   and _unmoved(p, lr)}
        grads = mask_grads(grads.replace_leaves(carried), keep)
    return sgd_update(scene, grads, lr)


def _geometry(scene: Scene) -> tuple:
    """What a scene's layout is built from, as a step compares it: the
    metadata, and each of ``LAYOUT_LEAVES`` itself with what a change in
    place moves (its version; its address, which ``t.data = ...`` moves
    and the version does not; its shape, dtype and device).  Host
    attributes only: no value is read from the card."""
    leaves = scene.leaves()
    return (scene.meta(),) + tuple(
        (t, t._version, t.data_ptr(), t.shape, t.dtype, t.device)
        for t in (leaves[k] for k in LAYOUT_LEAVES))


def _stands(new: tuple, old: Optional[tuple]) -> bool:
    """Whether geometry ``new`` (:func:`_geometry`) is ``old`` unchanged:
    the same metadata and the very same leaf tensors, unmodified."""
    return (old is not None and new[0] == old[0]
            and all(a[0] is b[0] and a[1:] == b[1:]
                    for a, b in zip(new[1:], old[1:])))


def build_train_step(camera: Camera, *, width: int, height: int, spp: int,
                     max_depth: int, lr: float = 1e-2,
                     keep: Optional[Callable[[str], bool]] = None,
                     seed: int = 0, **render_kw):
    """The training step on one device (``build_train_step``, :192,
    without the mesh): render every pixel -> MSE -> reverse-mode
    gradients -> SGD.  Returns ``step(scene, gen, target) -> (new scene,
    loss)``; ``target`` is (width * height, 3).  ``keep`` masks the
    gradients first (:func:`mask_grads`), e.g. the materials only, or the
    mesh's ``triangles.verts``; ``seed`` salts the kernels' counter RNG,
    ``gen`` draws the camera rays; ``render_kw`` goes to
    :func:`loss_and_grad` (``sort_lanes``, ``nee``, ``_force_flat``).

    The step keeps the scene's layout (``tables.grad_layout``: the
    orders, boxes, hierarchy, sort grid and image check) while the
    scene's geometry stands: the same leaf tensors, unmodified
    (:func:`_geometry`); a leaf that ``keep`` masks comes back as the
    very tensor it was (:func:`_masked_update`), so an albedo fit builds
    one layout and its later steps read nothing back from the card.  The
    rows are gathered from the step's leaves every step, so the loss,
    the gradients and the new scene are what :func:`loss_and_grad`,
    :func:`mask_grads` and :func:`sgd_update` give, bit for bit.

    The step is the span ``rtow.train.step``, tiled by
    :func:`loss_and_grad`'s three phases and ``rtow.train.update``."""
    pixel_ids = torch.arange(width * height, device=camera.origin.device)
    layout_kw = dict(sort_lanes=render_kw.pop("sort_lanes", None),
                     force_flat=render_kw.pop("_force_flat", False),
                     nee=render_kw.pop("nee", False))
    kept_geometry = kept_layout = None

    def layout_of(scene: Scene) -> GradLayout:
        nonlocal kept_geometry, kept_layout
        geometry = _geometry(scene)
        if not _stands(geometry, kept_geometry):
            kept_layout = grad_layout(scene, **layout_kw)
            kept_geometry = geometry
        return kept_layout

    def step(scene: Scene, gen: torch.Generator, target):
        with span("rtow.train.step"):
            loss, grads = _loss_and_grad(
                scene, camera, gen, target, pixel_ids, layout_of,
                width=width, height=height, spp=spp, max_depth=max_depth,
                seed=seed, **render_kw)
            with span("rtow.train.update"):
                return _masked_update(scene, grads, lr, keep), loss

    return step
