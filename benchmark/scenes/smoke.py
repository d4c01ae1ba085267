"""The Cornell smoke of *Ray Tracing: The Next Week* (``cornell_smoke()``,
chapter "Volumes"): the Cornell box's five walls, a 330 x 305 ceiling lamp
of radiance 7, and the two boxes replaced by constant-density media of
density 0.01 each, black smoke in the tall one (turned 15 degrees) and
white fog in the short one (turned -18 degrees); black background.

A frozen copy of the port's ``smoke_scene`` (materials, then the
triangles in the builder's order: the walls, the lamp's quad; then the
two media, each a box in its local frame with its turn about y in
degrees and its translation), so the yardstick does not move if that
builder changes.  The seed does not change the scene.
"""
from __future__ import annotations

import numpy as np

from benchmark.scenes.cornell import S, quad

LAMBERTIAN, EMISSIVE = 0, 3


def scene(config: dict, seed: int) -> dict:
    white, red, green, lamp = range(4)
    kind = [LAMBERTIAN, LAMBERTIAN, LAMBERTIAN, EMISSIVE]
    albedo = [(0.73, 0.73, 0.73), (0.65, 0.05, 0.05), (0.12, 0.45, 0.15),
              (7.0, 7.0, 7.0)]
    tris, mats = [], []

    def add(triangles, mat):
        tris.extend(triangles)
        mats.extend([mat] * len(triangles))

    s = S
    # Floor, ceiling, back wall; red at x = s (image left), green at 0.
    add(quad((0, 0, s), (s, 0, s), (s, 0, 0), (0, 0, 0)), white)
    add(quad((s, s, 0), (s, s, s), (0, s, s), (0, s, 0)), white)
    add(quad((0, s, s), (s, s, s), (s, 0, s), (0, 0, s)), white)
    add(quad((s, 0, s), (s, s, s), (s, s, 0), (s, 0, 0)), red)
    add(quad((0, s, 0), (0, s, s), (0, 0, s), (0, 0, 0)), green)
    add(quad((443, s - 1, 127), (443, s - 1, 432), (113, s - 1, 432),
             (113, s - 1, 127)), lamp)
    f64 = np.float64
    none = np.zeros((0, 3), f64)
    return {
        "materials": {"kind": np.asarray(kind, np.int32),
                      "albedo": np.asarray(albedo, f64),
                      "fuzz": np.zeros((4,), f64),
                      "ir": np.ones((4,), f64)},
        "spheres": {"center0": none, "center1": none.copy(),
                    "radius": np.zeros((0,), f64),
                    "material": np.zeros((0,), np.int32)},
        "triangles": {"verts": np.asarray(tris, f64).reshape(-1, 3, 3),
                      "material": np.asarray(mats, np.int32)},
        # Each medium a box turned about y (degrees, +angle takes +z
        # toward +x), then moved: the port's kind "r".
        "volumes": {"kind": ["r", "r"],
                    "p_min": np.zeros((2, 3), f64),
                    "p_max": np.asarray([[165.0, 330.0, 165.0],
                                         [165.0, 165.0, 165.0]], f64),
                    "density": np.asarray([0.01, 0.01], f64),
                    "albedo": np.asarray([[0.0, 0.0, 0.0],
                                          [1.0, 1.0, 1.0]], f64),
                    "rotate_y": np.asarray([15.0, -18.0], f64),
                    "translate": np.asarray([[265.0, 0.0, 295.0],
                                             [130.0, 0.0, 65.0]], f64)},
        "background": [0.0, 0.0, 0.0],
    }
