"""rtow_tpu_torch — the PyTorch/CUDA port of the rtow_tpu path tracer.

The same renderer as ``rtow_tpu`` (its JAX/Pallas counterpart, kept as
the reference), written in PyTorch for one NVIDIA Hopper GPU: scenes
and cameras are dataclasses of tensors on the card unless the caller
asks for the CPU, and every kernel is hand-written CUDA with a plain
PyTorch version beside it: the persistent render megakernel
(``csrc/megakernel.cu``, ops/megakernel.py) and the gradient path's
forward and backward bounces (``csrc/grad_fwd.cu``, ``csrc/grad_bwd.cu``,
ops/grad.py, driven by diff.py's train step).

This package never imports ``jax`` or ``rtow_tpu``; only the tests
import both.
"""
from .config import Config
from .models.builders import (
    cover_scene,
    one_sphere_scene,
    scene_for_config,
    three_sphere_scene,
)
from .models.camera import Camera, make_camera
from .models.scene import Scene, SceneBuilder

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Config",
    "Scene",
    "SceneBuilder",
    "cover_scene",
    "make_camera",
    "one_sphere_scene",
    "scene_for_config",
    "three_sphere_scene",
]
