"""Render configuration — the port's copy of ``rtow_tpu.config.Config``.

Same fields, defaults and ``__str__`` (so ``--dry-run`` prints the same
text as ``rtow_tpu``), plus ``device``: the torch device the scene
tensors and the render live on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # -- knobs shared with the reference (same defaults) ------------------
    number_of_balls_sqrt: int = 11
    aspect_ratio: float = 3.0 / 2.0
    image_width: int = 200
    samples_per_pixel: int = 20
    moving_spheres: bool = True
    max_child_rays: int = 20
    model: Optional[str] = None  # OBJ path; selects the mesh scene
    lights_demo: bool = False
    cornell_demo: bool = False
    checker_ground: bool = False
    textures_demo: bool = False
    smoke_demo: bool = False
    globe_demo: bool = False

    # -- knobs of the JAX package, kept with the same defaults ------------
    n_devices: int = 1
    spp_shards: int = 1
    seed: int = 0
    rays_per_batch: int = 1 << 18
    use_bvh: bool = True
    russian_roulette: bool = False
    verbose: bool = False
    profile_dir: str = ""
    backend: str = "auto"

    # -- the port's own --------------------------------------------------
    #: torch device of the scene tensors and the render: "cuda" runs the
    #: CUDA megakernel, "cpu" its plain PyTorch version.
    device: str = "cuda"

    @property
    def image_height(self) -> int:
        # Same truncation as the reference (src/render.cpp:136).
        return int(self.image_width / self.aspect_ratio)

    def torch_device(self):
        """``device`` as a ``torch.device`` (see :func:`resolve_device`)."""
        return resolve_device(self.device)

    def __str__(self) -> str:  # --dry-run output, reference render.cpp:193
        return (
            "Config {\n"
            f"aspect_ratio: {self.aspect_ratio}\n"
            f"number_of_balls_sqrt: {self.number_of_balls_sqrt}\n"
            f"moving_spheres: {int(self.moving_spheres)}\n"
            f"image_width: {self.image_width}\n"
            f"samples_per_pixel: {self.samples_per_pixel}\n"
            f"max_child_rays: {self.max_child_rays}\n"
            f"n_devices: {self.n_devices}\n"
            f"seed: {self.seed}\n"
            f"backend: {self.backend}\n"
            "}\n"
        )


def resolve_device(device):
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    this process has no usable card (never falls back to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but "
            "torch.cuda.is_available() is False; pass --device cpu "
            "(or device=\"cpu\") to run the plain PyTorch version")
    return dev
