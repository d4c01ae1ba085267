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
from .ops.grad import render_pixels_kernel, scene_value_and_grad


def image_mse(scene: Scene, camera: Camera, gen: torch.Generator, target,
              pixel_ids, **render_kw) -> torch.Tensor:
    """Scalar MSE between the pixels :func:`render_pixels_kernel` renders
    and target rows (``image_mse``, rtow_tpu/diff.py:129)."""
    img = render_pixels_kernel(scene, camera, gen, pixel_ids, **render_kw)
    target = torch.as_tensor(target, dtype=img.dtype, device=img.device)
    return torch.mean((img - target) ** 2)


def loss_and_grad(scene: Scene, camera: Camera, gen: torch.Generator,
                  target, pixel_ids, **kw) -> Tuple[torch.Tensor, Scene]:
    """(loss, dloss/dscene) (``loss_and_grad``, :142).  Integer leaves
    get None gradients, which :func:`sgd_update` skips."""
    return scene_value_and_grad(
        lambda s: image_mse(s, camera, gen, target, pixel_ids, **kw), scene)


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
                     seed: int = 0):
    """The training step on one device (``build_train_step``, :192,
    without the mesh): render every pixel -> MSE -> reverse-mode
    gradients -> SGD.  Returns ``step(scene, gen, target) -> (new scene,
    loss)``; ``target`` is (width * height, 3).  ``keep`` masks the
    gradients first (:func:`mask_grads`); ``seed`` salts the kernels'
    counter RNG, ``gen`` draws the camera rays."""

    def step(scene: Scene, gen: torch.Generator, target):
        pixel_ids = torch.arange(width * height, device=scene.device)
        loss, grads = loss_and_grad(
            scene, camera, gen, target, pixel_ids, width=width,
            height=height, spp=spp, max_depth=max_depth, seed=seed)
        if keep is not None:
            grads = mask_grads(grads, keep)
        return sgd_update(scene, grads, lr), loss

    return step
