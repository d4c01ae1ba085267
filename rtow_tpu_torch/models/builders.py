"""Scene builders (the port of ``rtow_tpu.models.builders``): the
procedural cover scene (with the checkered ground of ``--checker``), the
OBJ mesh scene, the small config-ladder scenes and the light-driven demo
scenes of ``--lights``, ``--textures``, ``--cornell`` and ``--smoke``.

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
from ..utils.obj import load_obj
from .camera import Camera, make_camera
from .scene import Scene, SceneBuilder


def cover_scene(cfg: Config, dtype=REAL,
                device=None) -> Tuple[Scene, Camera]:
    """The book-cover ball field (reference src/main.cpp:23-83), on
    ``device`` or, when it is None, on ``cfg.device``."""
    device = cfg.torch_device() if device is None else resolve_device(device)
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
    if cfg.checker_ground:
        # Book 2's checkered ground sphere (no reference counterpart).
        ground = b.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=3.2)
    else:
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


def mesh_scene(cfg: Config, dtype=REAL,
               device=None) -> Tuple[Scene, Camera]:
    """The OBJ mesh ``cfg.model`` under one gray Lambertian (reference
    ``foo``, src/main.cpp:85-136), on ``device`` or, when it is None, on
    ``cfg.device``."""
    if not cfg.model:
        raise ValueError("mesh_scene requires cfg.model (OBJ path)")
    device = cfg.torch_device() if device is None else resolve_device(device)
    cam = make_camera(
        lookfrom=(1.0, 0.0, -1.0),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        fov_degrees=35.0,
        aspect_ratio=cfg.aspect_ratio,
        aperture=0.01,
        focus_dist=None,
        t0=0.0,
        t1=1.0,
        dtype=dtype,
        device=device,
    )
    b = SceneBuilder()
    gray = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_mesh(load_obj(cfg.model), gray)
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


def light_scene(aspect_ratio: float = 16.0 / 9.0, dtype=REAL,
                device="cuda") -> Tuple[Scene, Camera]:
    """Emissive-material demo (``--lights``): two sphere lights over a
    dark ground, black background."""
    cam = make_camera(lookfrom=(6.0, 2.0, 4.0), lookat=(0.0, 0.8, 0.0),
                      fov_degrees=30.0, aspect_ratio=aspect_ratio,
                      aperture=0.0, focus_dist=None, dtype=dtype,
                      device=device)
    b = SceneBuilder()
    ground = b.add_lambertian((0.4, 0.4, 0.4))
    red = b.add_lambertian((0.65, 0.1, 0.1))
    mirror = b.add_metal((0.9, 0.9, 0.9), 0.02)
    lamp = b.add_light((6.0, 5.5, 4.5))  # warm, intensity > 1
    glow = b.add_light((1.0, 2.0, 6.0))  # cool accent
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((0.0, 0.8, 0.0), 0.8, red)
    b.add_sphere((-1.8, 0.6, 0.8), 0.6, mirror)
    b.add_sphere((1.4, 2.6, -1.0), 0.5, lamp)
    b.add_sphere((2.2, 0.35, 1.2), 0.35, glow)
    return b.build(dtype, background=(0.0, 0.0, 0.0), device=device), cam


def textures_scene(aspect_ratio: float = 1.5, dtype=REAL,
                   device="cuda") -> Tuple[Scene, Camera]:
    """Procedural-texture demo (``--textures``): a checkered ground, a
    marble sphere and a near-mirror metal sphere, sky-lit."""
    cam = make_camera(lookfrom=(0.0, 1.2, 3.2), lookat=(0.0, 0.4, 0.0),
                      fov_degrees=40.0, aspect_ratio=aspect_ratio,
                      aperture=0.0, focus_dist=3.2, dtype=dtype,
                      device=device)
    b = SceneBuilder()
    ground = b.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=6.0)
    marble = b.add_noise((0.92, 0.92, 0.92), (0.25, 0.1, 0.05), scale=3.0)
    mirror = b.add_metal((0.85, 0.85, 0.9), 0.03)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((-0.7, 0.55, 0.0), 0.55, marble)
    b.add_sphere((0.75, 0.45, 0.6), 0.45, mirror)
    return b.build(dtype, device=device), cam


def _cornell_materials(b: SceneBuilder):
    """The Cornell box's wall materials: (white, red, green)."""
    white = b.add_lambertian((0.73, 0.73, 0.73))
    red = b.add_lambertian((0.65, 0.05, 0.05))
    green = b.add_lambertian((0.12, 0.45, 0.15))
    return white, red, green


def _cornell_camera(aspect_ratio, dtype, device) -> Camera:
    return make_camera(lookfrom=(278.0, 278.0, -800.0),
                       lookat=(278.0, 278.0, 0.0), fov_degrees=40.0,
                       aspect_ratio=aspect_ratio, aperture=0.0,
                       focus_dist=10.0, dtype=dtype, device=device)


def _cornell_quads(b: SceneBuilder, white, red, green, s: float = 555.0):
    """The box's five walls, wound so their normals face the inside (the
    backface cull lets interior rays hit them)."""
    quad = b.add_quad  # corners CCW as seen from the normal side
    # Floor, ceiling, back wall; red at x = s (image left), green at 0.
    quad((0, 0, s), (s, 0, s), (s, 0, 0), (0, 0, 0), white)
    quad((s, s, 0), (s, s, s), (0, s, s), (0, s, 0), white)
    quad((0, s, s), (s, s, s), (s, 0, s), (0, 0, s), white)
    quad((s, 0, s), (s, s, s), (s, s, 0), (s, 0, 0), red)
    quad((0, s, 0), (0, s, s), (0, 0, s), (0, 0, 0), green)


def cornell_scene(aspect_ratio: float = 1.0, dtype=REAL,
                  device="cuda") -> Tuple[Scene, Camera]:
    """Cornell box (``--cornell``): an emissive triangle ceiling light,
    coloured walls, a mirror sphere and the book's tall box rotated 15
    degrees (baked into the vertices), black background."""
    cam = _cornell_camera(aspect_ratio, dtype, device)
    b = SceneBuilder()
    white, red, green = _cornell_materials(b)
    lamp = b.add_light((15.0, 15.0, 15.0))
    mirror = b.add_metal((0.95, 0.95, 0.95), 0.0)
    s = 555.0
    _cornell_quads(b, white, red, green, s)
    # A 130 x 105 emissive quad slightly below the ceiling.
    b.add_quad((343, s - 1, 227), (343, s - 1, 332), (213, s - 1, 332),
               (213, s - 1, 227), lamp)
    b.add_sphere((190.0, 90.0, 190.0), 90.0, mirror)
    b.add_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), white,
              rotate_y=15.0, translate=(265.0, 0.0, 295.0))
    return b.build(dtype, background=(0.0, 0.0, 0.0), device=device), cam


def smoke_scene(aspect_ratio: float = 1.0, dtype=REAL,
                device="cuda") -> Tuple[Scene, Camera]:
    """Cornell smoke (``--smoke``, book 2 ch. 9): the box with two
    constant-density media in place of the solid boxes, dark smoke in
    the tall one (rotate_y 15), white fog in the short one (rotate_y
    -18), under a larger ceiling light."""
    cam = _cornell_camera(aspect_ratio, dtype, device)
    b = SceneBuilder()
    white, red, green = _cornell_materials(b)
    lamp = b.add_light((7.0, 7.0, 7.0))
    s = 555.0
    _cornell_quads(b, white, red, green, s)
    b.add_quad((443, s - 1, 127), (443, s - 1, 432), (113, s - 1, 432),
               (113, s - 1, 127), lamp)
    b.add_fog_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), 0.01,
                  albedo=(0.0, 0.0, 0.0), rotate_y=15.0,
                  translate=(265.0, 0.0, 295.0))
    b.add_fog_box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), 0.01,
                  albedo=(1.0, 1.0, 1.0), rotate_y=-18.0,
                  translate=(130.0, 0.0, 65.0))
    return b.build(dtype, background=(0.0, 0.0, 0.0), device=device), cam


_DEMOS = (("lights_demo", light_scene), ("cornell_demo", cornell_scene),
          ("textures_demo", textures_scene), ("smoke_demo", smoke_scene))


def scene_for_config(cfg: Config, dtype=REAL) -> Tuple[Scene, Camera]:
    """CLI dispatch mirroring reference main.cpp:165-169, plus the demo
    scenes, in the JAX package's order (builders.py:347-362), on
    ``cfg.device``.  ``--globe`` raises ``NotImplementedError``: image
    textures belong to the reference integrator (ROADMAP Queue 1 item
    5)."""
    for field, build in _DEMOS:
        if getattr(cfg, field):
            return build(cfg.aspect_ratio, dtype, device=cfg.torch_device())
    if cfg.globe_demo:
        raise NotImplementedError(
            "--globe needs image textures on the reference integrator "
            "(ROADMAP Queue 1 item 5)")
    if cfg.model:
        return mesh_scene(cfg, dtype)
    return cover_scene(cfg, dtype)
