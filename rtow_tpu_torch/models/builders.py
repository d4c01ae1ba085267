"""Scene builders (the port of ``rtow_tpu.models.builders``): the
procedural cover scene and the small config-ladder scenes.

``cover_scene`` replicates the distribution of the reference's
``lots_of_balls`` (reference src/main.cpp:23-83) from an explicit numpy
PCG64 seed, drawing in the same order as ``rtow_tpu``'s builder, so both
packages build identical scenes from one seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import Config, resolve_device
from ..utils.dtypes import REAL
from .camera import Camera, make_camera
from .scene import Scene, SceneBuilder


def cover_scene(cfg: Config, dtype=REAL,
                device=None) -> Tuple[Scene, Camera]:
    """The book-cover ball field (reference src/main.cpp:23-83), on
    ``device`` or, when it is None, on ``cfg.device``."""
    device = cfg.torch_device() if device is None else resolve_device(device)
    if cfg.checker_ground:
        raise NotImplementedError(
            "--checker needs the checker texture in the megakernel "
            "(ROADMAP Queue 1 item 7)")
    rng = np.random.default_rng(cfg.seed)
    u = lambda lo=0.0, hi=1.0: float(rng.uniform(lo, hi))
    u3 = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, size=3)

    cam = make_camera(
        lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        fov_degrees=20.0,
        aspect_ratio=cfg.aspect_ratio,
        aperture=0.1,
        focus_dist=10.0,
        t0=0.0,
        t1=1.0,
        dtype=dtype,
        device=device,
    )

    b = SceneBuilder()
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    n = cfg.number_of_balls_sqrt
    for a in range(-n, n):
        for bb in range(-n, n):
            choose_mat = u()
            center = np.array([a + 0.9 * u(), 0.2, bb + 0.9 * u()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = u3() * u3()
                mat = b.add_lambertian(albedo)
                if cfg.moving_spheres:
                    center2 = center + np.array([0.0, u(0.0, 0.5), 0.0])
                    b.add_moving_sphere(center, center2, 0.2, mat)
                else:
                    b.add_sphere(center, 0.2, mat)
            elif choose_mat < 0.95:
                mat = b.add_metal(u3(0.5, 1.0), u(0.0, 0.5))
                b.add_sphere(center, 0.2, mat)
            else:
                mat = b.add_dielectric(1.5)
                b.add_sphere(center, 0.2, mat)

    glass = b.add_dielectric(1.5)
    reddish = b.add_lambertian((0.4, 0.2, 0.1))
    reddish_metal = b.add_metal((0.7, 0.6, 0.5))
    b.add_sphere((0.0, 1.0, 0.0), 1.0, glass)
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, reddish)
    b.add_sphere((4.0, 1.0, 0.0), 1.0, reddish_metal)
    return b.build(dtype, device=device), cam


def one_sphere_scene(aspect_ratio: float = 16.0 / 9.0, dtype=REAL,
                     device="cuda") -> Tuple[Scene, Camera]:
    """BASELINE config (a): one Lambertian sphere + ground."""
    cam = make_camera(
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
        fov_degrees=90.0,
        aspect_ratio=aspect_ratio,
        aperture=0.0,
        focus_dist=1.0,
        dtype=dtype,
        device=device,
    )
    b = SceneBuilder()
    mat = b.add_lambertian((0.5, 0.5, 0.5))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, mat)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    return b.build(dtype, device=device), cam


def three_sphere_scene(aspect_ratio: float = 16.0 / 9.0, dtype=REAL,
                       device="cuda") -> Tuple[Scene, Camera]:
    """BASELINE config (b): lambertian/metal/dielectric trio with a
    defocus-blur camera."""
    cam = make_camera(
        lookfrom=(3.0, 3.0, 2.0),
        lookat=(0.0, 0.0, -1.0),
        fov_degrees=20.0,
        aspect_ratio=aspect_ratio,
        aperture=0.3,
        focus_dist=None,  # defaults to look distance
        dtype=dtype,
        device=device,
    )
    b = SceneBuilder()
    ground = b.add_lambertian((0.8, 0.8, 0.0))
    center = b.add_lambertian((0.1, 0.2, 0.5))
    left = b.add_dielectric(1.5)
    right = b.add_metal((0.8, 0.6, 0.2), 0.0)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, center)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, left)
    b.add_sphere((-1.0, 0.0, -1.0), -0.45, left)  # hollow-glass trick
    b.add_sphere((1.0, 0.0, -1.0), 0.5, right)
    return b.build(dtype, device=device), cam


#: Config switches whose scenes need parts of the JAX package this
#: slice has not ported, with the ROADMAP item that ports them.
_NOT_PORTED = (
    ("lights_demo", "--lights", "emission and NEE (ROADMAP Queue 1 item 7)"),
    ("cornell_demo", "--cornell",
     "emission, NEE and the triangle sweep (ROADMAP Queue 1 item 7)"),
    ("textures_demo", "--textures",
     "checker and noise textures (ROADMAP Queue 1 item 7)"),
    ("smoke_demo", "--smoke",
     "constant-density media (ROADMAP Queue 1 item 7)"),
    ("globe_demo", "--globe",
     "image textures on the reference integrator (ROADMAP Queue 1 item 5)"),
    ("model", "-l/--load",
     "OBJ meshes, the BVH and the mesh kernels (ROADMAP Queue 1 items 2, 7-9)"),
)


def scene_for_config(cfg: Config, dtype=REAL) -> Tuple[Scene, Camera]:
    """CLI dispatch mirroring reference main.cpp:165-169 on
    ``cfg.device``.  Scenes the slice does not cover raise
    ``NotImplementedError`` naming the ROADMAP item that ports them."""
    for field, flag, needs in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(f"{flag} needs {needs}")
    return cover_scene(cfg, dtype)
