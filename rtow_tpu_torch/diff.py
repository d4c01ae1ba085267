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

from typing import Callable, Optional, Tuple

import torch

from .models.camera import Camera
from .models.scene import Scene
from .ops.grad import render_pixels_kernel, scene_grads, scene_params
from .ops.tables import grad_tables
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
    with span("rtow.train.tables"), torch.enable_grad():
        params = scene_params(scene)
        watched = scene.replace_leaves(params)
        tables = grad_tables(watched, sort_lanes=sort_lanes,
                             force_flat=_force_flat, nee=nee)
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

    The step is the span ``rtow.train.step``, tiled by
    :func:`loss_and_grad`'s three phases and ``rtow.train.update``."""
    pixel_ids = torch.arange(width * height, device=camera.origin.device)

    def step(scene: Scene, gen: torch.Generator, target):
        with span("rtow.train.step"):
            loss, grads = loss_and_grad(
                scene, camera, gen, target, pixel_ids, width=width,
                height=height, spp=spp, max_depth=max_depth, seed=seed,
                **render_kw)
            with span("rtow.train.update"):
                if keep is not None:
                    grads = mask_grads(grads, keep)
                return sgd_update(scene, grads, lr), loss

    return step
