"""The least work a frame or a step needs, whatever implements it: the
yardstick of the roofline shares (``metrics/*_roofline_pct.py``).

Counted per path segment (one ray from its origin to its nearest hit or
to the sky), from the bounce's arithmetic (``reference/tracer.py``,
which follows the port's): the winner's intersection test only (not the
rows swept or the boxes tested, which an implementation chooses), the
hit record and the cheapest scatter, the scatter's counter-hash draws,
the sky on a miss.  Every float32 add, multiply, divide, square root,
compare, min or max counts one operation, as does sine or cosine (a
lower bound of their cost); the hash's integer multiplies, shifts and
xors count one each against the same peak.  A path has at most one
miss, so of ``segments`` at least ``segments - samples`` are hits.

Bytes: the scene's tables and the camera read once, the image (or the
gradient tables) written once.
"""
from __future__ import annotations

#: NVIDIA H100 SXM (NVIDIA's data sheet): float32 outside the tensor
#: cores, and HBM3.  Stated against the card's 700 W limit.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

#: |d|^2 (5) and 1 / |d|^2 (1), each segment.
OPS_RAY = 6
#: The winner sphere's test: its centre at the ray's time (6), o - c (3),
#: h (5), c (7), the discriminant (3), its sign (1), the root (1), the
#: near and far roots (5), the pick (3).
OPS_SPHERE_TEST = 34
#: The winner triangle's test, Moller-Trumbore in the determinant form:
#: the normal (9), the determinant (6), its floor (1), 1 / det (1), o - v0
#: (3), the cross product (9), u (6), v (7), t (6), the bounds (6).
OPS_TRIANGLE_TEST = 54
#: The hit record: the point (6), the normal and its side (16).
OPS_HIT = 22
#: The cheapest scatter (Lambertian): n + unit (3), its degenerate test
#: (6), the pick (3); the throughput (3).
OPS_SCATTER = 15
#: One uniform of the counter hash: the key (2), the murmur3 finalizer
#: (8), to float (3).
OPS_UNIFORM = 13
#: The scatter's draws: three uniforms, the unit vector (11).
OPS_DRAW = 3 * OPS_UNIFORM + 11
#: A miss: the sky's blend (11), radiance += throughput x sky (6).
OPS_SKY = 17
#: A camera ray drawn on the card (the whole-frame render): five
#: uniforms, the pixel's coordinates (4), the lens sample (7), the origin
#: (12), the direction (15), the time (2).
OPS_CAMERA = 5 * OPS_UNIFORM + 40
#: The adjoint of the differentiable part of a segment (the winner's
#: test, the hit record, the scatter, the sky) takes at least two
#: operations for each of the forward's.
ADJOINT = 2

#: Bytes of the scene per sphere (centre, motion, radius, material id),
#: per triangle (three vertices, material id) and per material (kind,
#: albedo, fuzz, index); of the camera; of a pixel's radiance.
BYTES_SPHERE = 8 * 4
BYTES_TRIANGLE = 10 * 4
BYTES_MATERIAL = 6 * 4
BYTES_CAMERA = 21 * 4
BYTES_PIXEL = 3 * 4
#: A sphere's and a triangle's gradient row: their float parameters and
#: their material's.
BYTES_SPHERE_GRAD = (7 + 5) * 4
BYTES_TRIANGLE_GRAD = (9 + 5) * 4


def segment_ops(segments: int, samples: int, triangles: bool) -> int:
    """Operations of ``segments`` segments of ``samples`` paths: every
    segment's ray terms; at least ``segments - samples`` hits, each with
    its test, hit record, draws and scatter; the other segments the
    cheaper of a hit and a miss."""
    test = OPS_TRIANGLE_TEST if triangles else OPS_SPHERE_TEST
    hit = test + OPS_HIT + OPS_DRAW + OPS_SCATTER
    hits = max(segments - samples, 0)
    return (segments * OPS_RAY + hits * hit
            + (segments - hits) * min(hit, OPS_SKY))


def adjoint_ops(segments: int, samples: int, triangles: bool) -> int:
    """The adjoint of :func:`segment_ops`'s differentiable part (its draws
    have none)."""
    test = OPS_TRIANGLE_TEST if triangles else OPS_SPHERE_TEST
    hit = test + OPS_HIT + OPS_SCATTER
    hits = max(segments - samples, 0)
    return ADJOINT * (segments * OPS_RAY + hits * hit
                      + (segments - hits) * min(hit, OPS_SKY))


def scene_bytes(run: dict) -> int:
    return (run["n_spheres"] * BYTES_SPHERE
            + run["n_triangles"] * BYTES_TRIANGLE
            + run.get("n_materials", 1) * BYTES_MATERIAL + BYTES_CAMERA)


def image_bytes(run: dict) -> int:
    return run["width"] * run["height"] * BYTES_PIXEL


def grad_bytes(run: dict) -> int:
    return (run["n_spheres"] * BYTES_SPHERE_GRAD
            + run["n_triangles"] * BYTES_TRIANGLE_GRAD)


def least_seconds(ops: float, nbytes: float) -> float:
    """The roofline: the larger of the operations over the float32 peak
    and the bytes over the memory bandwidth."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def share(trace, pattern: str, counter: str, ops_of, bytes_of):
    """The roofline share (%) of the kernels ``pattern`` over the traced
    window: the least seconds of the work ``ops_of(segments, samples)`` and
    ``bytes_of()`` per unit, from the program's ``counter`` of segments,
    over the kernels' device seconds per unit; None where the trace holds
    no such kernel or the counter was not fed."""
    seconds = trace.kernel_s(pattern)
    if seconds is None or counter not in trace.counts or not trace.units:
        return None
    run = trace.run
    samples = run["width"] * run["height"] * run["spp"]
    segments = trace.counts[counter] / trace.units
    least = least_seconds(ops_of(segments, samples), bytes_of())
    return 100.0 * least / (seconds / trace.units)
