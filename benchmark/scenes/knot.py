"""A trefoil-knot tube of ``2 x segments x rings`` triangles under one
Lambertian material, sky-lit: the upstream's OBJ deployment (``-l
model.obj``) with a generated mesh in place of its stripped
``dragon.obj``.

``make_knot`` is a frozen copy of the repository's ``tools/make_mesh.py``,
so the yardstick does not move if that tool changes.  The seed does not
change the scene.
"""
from __future__ import annotations

import numpy as np


def trefoil(t: np.ndarray) -> np.ndarray:
    x = np.sin(t) + 2.0 * np.sin(2.0 * t)
    y = np.cos(t) - 2.0 * np.cos(2.0 * t)
    z = -np.sin(3.0 * t)
    return np.stack([x, y, z], axis=-1) * 0.25


def make_knot(segments: int, rings: int, radius: float = 0.12) -> tuple:
    """(vertices (S * R, 3), faces (2 * S * R, 3)) of the knot's tube,
    wound so the outward faces are the front faces."""
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    c = trefoil(t)
    tang = trefoil(t + 1e-4) - trefoil(t - 1e-4)
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    n1 = np.cross(tang, np.array([0.0, 0.0, 1.0]))
    bad = np.linalg.norm(n1, axis=-1) < 1e-6
    n1[bad] = np.cross(tang[bad], [1.0, 0.0, 0.0])
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 = np.cross(tang, n1)
    phi = np.linspace(0.0, 2.0 * np.pi, rings, endpoint=False)
    verts = (c[:, None, :] + radius * (
        np.cos(phi)[None, :, None] * n1[:, None, :]
        + np.sin(phi)[None, :, None] * n2[:, None, :])).reshape(-1, 3)
    i = np.arange(segments)[:, None]
    j = np.arange(rings)[None, :]
    a = i * rings + j
    b = (i + 1) % segments * rings + j
    cc = (i + 1) % segments * rings + (j + 1) % rings
    d = i * rings + (j + 1) % rings
    faces = np.stack([np.stack([a, cc, b], -1), np.stack([a, d, cc], -1)],
                     axis=2).reshape(-1, 3)
    return verts, faces.astype(np.int64)


def scene(config: dict, seed: int) -> dict:
    verts, faces = make_knot(int(config["segments"]), int(config["rings"]),
                             float(config["tube_radius"]))
    if len(faces) != int(config["triangles"]):
        raise ValueError(f"make_knot({config['segments']}, {config['rings']})"
                         f" has {len(faces)} triangles, the configuration "
                         f"states {config['triangles']}")
    tri = verts[faces]
    f64 = np.float64
    return {
        "materials": {"kind": np.zeros((1,), np.int32),
                      "albedo": np.asarray([config["albedo"]], f64),
                      "fuzz": np.zeros((1,), f64),
                      "ir": np.ones((1,), f64)},
        "spheres": {"center0": np.zeros((0, 3), f64),
                    "center1": np.zeros((0, 3), f64),
                    "radius": np.zeros((0,), f64),
                    "material": np.zeros((0,), np.int32)},
        "triangles": {"verts": tri, "material": np.zeros(len(tri), np.int32)},
        "background": "sky",
    }
