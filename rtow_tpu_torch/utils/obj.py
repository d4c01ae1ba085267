"""Wavefront OBJ ingestion, triangles only (the port of the pure-Python
loader of ``rtow_tpu.utils.obj``).

The reference loads meshes with tinyobjloader in double precision and
accepts only triangular faces, throwing otherwise (reference
src/main.cpp:109-131).  This loader keeps that contract: ``v`` and ``f``
records, vertex indices only (the ``vt`` / ``vn`` parts of ``a/b/c`` face
entries are parsed and ignored, as the reference ignores them), negative
OBJ indices counted from the end, every other record skipped.  Like the
JAX package's loader it ingests every shape of a multi-object file, not
only ``shapes[0]``.
"""
from __future__ import annotations

import numpy as np


class ObjError(RuntimeError):
    pass


def load_obj(path: str) -> np.ndarray:
    """Load an OBJ file -> triangle vertex array (M, 3, 3) float64.

    Raises :class:`ObjError` on a face that is not a triangle, a
    malformed vertex, an index out of range, or a file without faces."""
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for lineno, raw in enumerate(f, 1):
            parts = raw.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                if len(parts) < 4:
                    raise ObjError(f"{path}:{lineno}: malformed vertex")
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif tag == "f":
                corners = parts[1:]
                if len(corners) != 3:
                    raise ObjError(
                        f"{path}:{lineno}: found a face that isn't a triangle "
                        f"({len(corners)} vertices)")
                # "v", "v/vt", "v//vn", "v/vt/vn": keep the vertex index;
                # OBJ is 1-based and negatives count from the end.
                idx = [int(c.split("/", 1)[0]) for c in corners]
                faces.append(tuple(v - 1 if v > 0 else len(verts) + v
                                   for v in idx))
    if not faces:
        raise ObjError(f"{path}: no triangular faces found")
    v = np.asarray(verts, dtype=np.float64)
    f_arr = np.asarray(faces, dtype=np.int64)
    if f_arr.min() < 0 or f_arr.max() >= len(v):
        raise ObjError(f"{path}: face index out of range")
    return v[f_arr]  # (M, 3 corners, 3 coords)
