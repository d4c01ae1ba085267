"""The Cornell box of *Ray Tracing: The Next Week* (``cornell_box()``),
with the sphere of *The Rest of Your Life* beside the tall box: five
walls, a 130 x 105 ceiling lamp, the tall box turned 15 degrees, a mirror
sphere; black background.

A frozen copy of the port's ``cornell_scene`` (materials, then the
triangles in the builder's order: the walls, the lamp's quad, the box's
12), so the yardstick does not move if that builder changes.  The seed
does not change the scene.
"""
from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, EMISSIVE = 0, 1, 3
#: The box's side.
S = 555.0


def quad(p00, p10, p11, p01) -> list:
    """A quadrilateral as two triangles, corners counter-clockwise as
    seen from the side that rays hit."""
    return [(p00, p10, p11), (p00, p11, p01)]


def box(p_min, p_max, rotate_y: float, translate) -> list:
    """An axis-aligned box as 12 outward-wound triangles, turned about y
    by ``rotate_y`` degrees (+angle takes +z toward +x), then moved."""
    x0, y0, z0 = (float(v) for v in p_min)
    x1, y1, z1 = (float(v) for v in p_max)
    faces = [
        ((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)),
        ((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)),
        ((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)),
        ((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)),
        ((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)),
        ((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)),
    ]
    verts = np.array(faces, np.float64).reshape(-1, 3)
    th = np.radians(float(rotate_y))
    c, s = np.cos(th), np.sin(th)
    verts = verts @ np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]],
                             np.float64)
    verts = verts + np.asarray(translate, np.float64)
    out = []
    for q in verts.reshape(6, 4, 3):
        out += quad(*q)
    return out


def scene(config: dict, seed: int) -> dict:
    white, red, green, lamp, mirror = range(5)
    kind = [LAMBERTIAN, LAMBERTIAN, LAMBERTIAN, EMISSIVE, METAL]
    albedo = [(0.73, 0.73, 0.73), (0.65, 0.05, 0.05), (0.12, 0.45, 0.15),
              (15.0, 15.0, 15.0), (0.95, 0.95, 0.95)]
    fuzz = [0.0, 0.0, 0.0, 0.0, 0.0]
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
    add(quad((343, s - 1, 227), (343, s - 1, 332), (213, s - 1, 332),
             (213, s - 1, 227)), lamp)
    add(box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), 15.0,
            (265.0, 0.0, 295.0)), white)
    f64 = np.float64
    center = np.asarray([[190.0, 90.0, 190.0]], f64)
    return {
        "materials": {"kind": np.asarray(kind, np.int32),
                      "albedo": np.asarray(albedo, f64),
                      "fuzz": np.asarray(fuzz, f64),
                      "ir": np.ones((5,), f64)},
        "spheres": {"center0": center, "center1": center.copy(),
                    "radius": np.asarray([90.0], f64),
                    "material": np.asarray([mirror], np.int32)},
        "triangles": {"verts": np.asarray(tris, f64).reshape(-1, 3, 3),
                      "material": np.asarray(mats, np.int32)},
        "background": [0.0, 0.0, 0.0],
    }
