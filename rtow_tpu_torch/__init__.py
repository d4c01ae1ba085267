"""rtow_tpu_torch — the PyTorch/CUDA port of the rtow_tpu path tracer.

The same renderer as ``rtow_tpu`` (its JAX/Pallas counterpart, kept as
the reference), written in PyTorch for one NVIDIA Hopper GPU: scenes
and cameras are dataclasses of tensors, plain functions take an
explicit ``device``, and the persistent megakernel is hand-written
CUDA (``csrc/megakernel.cu``) with a plain PyTorch version beside it.

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
