"""The reference's first three steps of the albedo fit: the loss of each
step, the first step's gradient and the albedos after each step.

A step renders every pixel (``spp`` lanes each, camera rays from the
step's generator), takes the mean squared error against the target and
descends the materials' albedos by SGD.  With the albedos the only
leaves fitted, a lane's path does not depend on them: each bounce only
scales the throughput by the hit material's albedo (Lambertian or metal;
glass by 1).  So the paths are traced once a step, recording which
material scaled each bounce and the sky colour each path ended in, and
the radiance, the loss and its gradient are then taken by autograd over
that product.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera import generator_rays, make_camera
from .integrate import Paths, trace_lanes
from .tracer import build_scene


def radiance(paths: Paths, albedo: torch.Tensor) -> torch.Tensor:
    """Each lane's radiance (L, 3) under ``albedo`` (M, 3): the sky colour
    times the albedos that scaled its throughput, in bounce order."""
    tp = torch.ones_like(paths.sky)
    for k in range(paths.scaled.shape[1]):
        mat = paths.scaled[:, k]
        tp = tp * torch.where((mat >= 0)[:, None], albedo[mat.clamp(min=0)],
                              1.0)
    return tp * paths.sky


def image(paths: Paths, albedo, n_pixels: int, spp: int) -> torch.Tensor:
    """Mean radiance of each pixel (P, 3)."""
    return radiance(paths, albedo).reshape(n_pixels, spp, 3).mean(dim=1)


def steps(inputs: dict, camera: dict, *, width: int, height: int, spp: int,
          max_depth: int, seed: int, target_seed: int, feed_seeds,
          noise: np.ndarray, lr: float, device, dtype=torch.float32) -> dict:
    """The fit's first ``len(feed_seeds)`` steps from the true albedos
    plus ``noise`` (clamped to [0, 1]) toward a target rendered with the
    true albedos from ``target_seed``'s generator -> {"losses": [...],
    "albedo": [A0, A1, ...] (M, 3) float64, "grad": the first step's
    gradient}."""
    scene = build_scene(inputs, device, dtype)
    cam = make_camera(camera, device, dtype)
    n_pix = width * height
    pix = torch.arange(n_pix, device=device).repeat_interleave(spp)
    lane_ids = torch.arange(pix.numel(), device=device)

    def paths_of(gen_seed: int) -> Paths:
        gen = torch.Generator(device).manual_seed(int(gen_seed))
        o, d, tm = generator_rays(cam, gen, pix, width, height)
        return trace_lanes(scene, o, d, tm, lane_ids, seed, max_depth)

    with torch.no_grad():
        target = image(paths_of(target_seed), scene.albedo, n_pix, spp)
    noise_t = torch.as_tensor(np.asarray(noise, np.float32)).to(device,
                                                                dtype)
    albedo = (scene.albedo + noise_t).clamp(0.0, 1.0)
    out = {"losses": [], "albedo": [albedo], "grad": None}
    for gen_seed in feed_seeds:
        paths = paths_of(gen_seed)
        a = albedo.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.mean((image(paths, a, n_pix, spp) - target) ** 2)
            (grad,) = torch.autograd.grad(loss, [a])
        albedo = (a - lr * grad).detach()
        out["losses"].append(float(loss.detach()))
        out["albedo"].append(albedo)
        if out["grad"] is None:
            out["grad"] = grad
    out["albedo"] = [x.double().cpu().numpy() for x in out["albedo"]]
    out["grad"] = out["grad"].double().cpu().numpy()
    return out
