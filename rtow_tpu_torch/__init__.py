"""rtow_tpu_torch — the PyTorch/CUDA port of the rtow_tpu path tracer.

The same renderer as ``rtow_tpu`` (its JAX/Pallas counterpart, kept as
the reference), written in PyTorch for one NVIDIA Hopper GPU: scenes
and cameras are dataclasses of tensors on the card unless the caller
asks for the CPU, and every kernel is hand-written CUDA with a plain
PyTorch version beside it: the persistent render megakernel for spheres
and small meshes (``csrc/megakernel.cu``, ops/megakernel.py), the sorted
wavefront's bounce for large meshes (``csrc/flat_bounce.cu``,
ops/flat_bounce.py, driven by ops/wavefront.py) and the gradient path's
forward and backward bounces (``csrc/grad_fwd.cu``, ``csrc/grad_bwd.cu``,
ops/grad.py, driven by diff.py's train step).

This package never imports ``jax`` or ``rtow_tpu``; only the tests
import both.
"""
import torch


def _first_cpu_math_call() -> None:
    """Calls torch's CPU float32 cos, sin, exp and log once on one element.

    The plain versions compute on the CPU with these functions.  Their
    first call in a process, when torch splits it over several threads,
    can leave one thread's chunk accurate to about 11 bits: in fresh
    processes running ``torch.cos`` on 100,000 float32 values eight at a
    time (torch 2.13.0+cpu with oneAPI MKL 2024.2, 8 threads), 15 of 320
    first calls had a thread's 12,500-value chunk (two in one of them) off
    by up to 1.5e-4, and the same call again was right.  After one
    single-threaded call each, none of 640 was off.
    """
    one = torch.ones(1)
    for fn in (torch.cos, torch.sin, torch.exp, torch.log):
        fn(one)


_first_cpu_math_call()

from .config import Config  # noqa: E402
from .models.builders import (  # noqa: E402
    cover_scene,
    mesh_scene,
    one_sphere_scene,
    scene_for_config,
    three_sphere_scene,
)
from .models.camera import Camera, make_camera  # noqa: E402
from .models.scene import Scene, SceneBuilder  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Config",
    "Scene",
    "SceneBuilder",
    "cover_scene",
    "make_camera",
    "mesh_scene",
    "one_sphere_scene",
    "scene_for_config",
    "three_sphere_scene",
]
