"""The final scene of *Ray Tracing in One Weekend* (``lots_of_balls``):
a ground sphere, a field of small spheres drawn from the seed (80%
Lambertian, moving upward over the shutter; 15% metal; 5% glass) and
three large spheres, glass, Lambertian and metal.

A frozen copy of the distribution as the port's ``cover_scene`` draws it
(numpy PCG64, in the same order), so the same seed gives the scene that
``rtweekend-torch --seed`` renders.
"""
from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2


def scene(config: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    u = lambda lo=0.0, hi=1.0: float(rng.uniform(lo, hi))  # noqa: E731
    u3 = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, size=3)  # noqa: E731
    kind, albedo, fuzz, ir = [], [], [], []
    c0, c1, radius, material = [], [], [], []

    def mat(k, al=(0.0, 0.0, 0.0), fz=0.0, index=1.0):
        kind.append(k)
        albedo.append(tuple(float(x) for x in al))
        fuzz.append(min(max(float(fz), 0.0), 1.0))
        ir.append(float(index))
        return len(kind) - 1

    def sphere(center, r, m, center1=None):
        c0.append(tuple(float(x) for x in center))
        c1.append(tuple(float(x) for x in (center if center1 is None
                                            else center1)))
        radius.append(float(r))
        material.append(m)

    sphere((0.0, -1000.0, 0.0), 1000.0, mat(LAMBERTIAN, (0.5, 0.5, 0.5)))
    n = int(config["number_of_balls_sqrt"])
    for a in range(-n, n):
        for b in range(-n, n):
            choose_mat = u()
            center = np.array([a + 0.9 * u(), 0.2, b + 0.9 * u()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                m = mat(LAMBERTIAN, u3() * u3())
                if config["moving_spheres"]:
                    sphere(center, 0.2, m,
                           center + np.array([0.0, u(0.0, 0.5), 0.0]))
                else:
                    sphere(center, 0.2, m)
            elif choose_mat < 0.95:
                sphere(center, 0.2, mat(METAL, u3(0.5, 1.0), u(0.0, 0.5)))
            else:
                sphere(center, 0.2, mat(DIELECTRIC, index=1.5))
    glass = mat(DIELECTRIC, index=1.5)
    reddish = mat(LAMBERTIAN, (0.4, 0.2, 0.1))
    reddish_metal = mat(METAL, (0.7, 0.6, 0.5))
    sphere((0.0, 1.0, 0.0), 1.0, glass)
    sphere((-4.0, 1.0, 0.0), 1.0, reddish)
    sphere((4.0, 1.0, 0.0), 1.0, reddish_metal)
    f64 = np.float64
    return {
        "materials": {"kind": np.asarray(kind, np.int32),
                      "albedo": np.asarray(albedo, f64).reshape(-1, 3),
                      "fuzz": np.asarray(fuzz, f64),
                      "ir": np.asarray(ir, f64)},
        "spheres": {"center0": np.asarray(c0, f64).reshape(-1, 3),
                    "center1": np.asarray(c1, f64).reshape(-1, 3),
                    "radius": np.asarray(radius, f64),
                    "material": np.asarray(material, np.int32)},
        "triangles": {"verts": np.zeros((0, 3, 3), f64),
                      "material": np.zeros((0,), np.int32)},
        "background": "sky",
    }
