"""SoA scene representation: dataclasses of tensors (the port of
``rtow_tpu.models.scene``).

One array set per primitive kind and one flat material table.  Static
spheres and moving spheres share one array family:
``center(t) = center0 + t * dcenter`` with ``dcenter = 0`` for static
spheres (the reference's lerp over the shutter interval,
src/oo-primitives.h:63-66).

The port covers spheres, triangles (single triangles and whole meshes,
with the book's scale / rotate_y / translate instancing baked into the
vertices) and the Lambertian / metal / dielectric materials.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..config import resolve_device
from ..utils.dtypes import INDEX, REAL

#: The scene's parts, in the JAX scene's leaf order.
_PARTS = ("spheres", "triangles", "materials")

# Material kinds — the codes of rtow_tpu.models.scene (:36-57).  The
# port shades the first three; codes above DIELECTRIC (emission and the
# textures) are not ported yet.
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
#: The textured kinds (checker, noise, image), which the JAX package
#: allows on spheres only.
_TEXTURED = (4, 5, 6)


@dataclasses.dataclass
class Materials:
    kind: torch.Tensor  # (K,)  int32
    albedo: torch.Tensor  # (K, 3)
    fuzz: torch.Tensor  # (K,)  clamped to [0, 1] at build
    ir: torch.Tensor  # (K,)  dielectric refraction index
    albedo2: torch.Tensor  # (K, 3) second texture color (= albedo here)


@dataclasses.dataclass
class Spheres:
    center0: torch.Tensor  # (N, 3) center at shutter-open
    dcenter: torch.Tensor  # (N, 3) center1 - center0 (zero when static)
    radius: torch.Tensor  # (N,) may be negative (hollow-glass trick)
    material: torch.Tensor  # (N,) int32 index into Materials


@dataclasses.dataclass
class Triangles:
    verts: torch.Tensor  # (M, 3 corners, 3 coords)
    material: torch.Tensor  # (M,) int32


@dataclasses.dataclass
class Scene:
    spheres: Spheres
    triangles: Triangles
    materials: Materials
    #: "sky" (the reference's gradient) or a flat (r, g, b) tuple.
    background: Union[str, tuple] = "sky"

    @property
    def device(self) -> torch.device:
        return self.spheres.radius.device

    @property
    def n_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.material.shape[0]

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_triangles

    def leaves(self) -> Dict[str, Optional[torch.Tensor]]:
        """Every leaf under its dotted key (``"spheres.center0"``, ...,
        ``"materials.albedo2"``), the JAX scene's leaf paths."""
        return {f"{part}.{f.name}": getattr(getattr(self, part), f.name)
                for part in _PARTS
                for f in dataclasses.fields(getattr(self, part))}

    def replace_leaves(self, new: Mapping[str, Optional[torch.Tensor]]
                       ) -> "Scene":
        """A copy with the leaves under the given dotted keys replaced."""
        parts = {}
        for part in _PARTS:
            obj = getattr(self, part)
            kw = {f.name: new[f"{part}.{f.name}"]
                  for f in dataclasses.fields(obj)
                  if f"{part}.{f.name}" in new}
            parts[part] = dataclasses.replace(obj, **kw)
        return dataclasses.replace(self, **parts)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The inverse of :meth:`from_numpy`: every leaf as a numpy array
        under its dotted key.  Leaves that are None (the integer leaves of
        a gradient scene, see ``ops/grad.loss_and_grad_kernel``) are left
        out."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.leaves().items() if v is not None}

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], device,
                   background: Union[str, tuple] = "sky") -> "Scene":
        """Build a scene from the JAX scene's leaves, given as numpy
        arrays keyed ``"spheres.center0"``, ..., ``"materials.kind"``.

        Values are copied bit for bit (floats as float32, ids as
        int32).  Triangle keys may be absent (no triangles); keys of
        parts the port does not cover (volumes, textures) must be
        absent or empty."""
        def take(key, dtype):
            return torch.tensor(np.asarray(arrays[key]), dtype=dtype,
                                device=device)

        for key, val in arrays.items():
            part = key.split(".", 1)[0]
            if part not in _PARTS and np.size(val):
                raise NotImplementedError(
                    f"scene leaf {key!r} is not ported yet (ROADMAP Queue 1)")
        return cls(
            spheres=Spheres(
                center0=take("spheres.center0", REAL),
                dcenter=take("spheres.dcenter", REAL),
                radius=take("spheres.radius", REAL),
                material=take("spheres.material", INDEX),
            ),
            triangles=(Triangles(verts=take("triangles.verts", REAL),
                                 material=take("triangles.material", INDEX))
                       if "triangles.verts" in arrays
                       else _empty_triangles(device)),
            materials=Materials(
                kind=take("materials.kind", INDEX),
                albedo=take("materials.albedo", REAL),
                fuzz=take("materials.fuzz", REAL),
                ir=take("materials.ir", REAL),
                albedo2=take("materials.albedo2", REAL),
            ),
            background=background,
        )


def _empty_triangles(device) -> Triangles:
    return Triangles(verts=torch.zeros((0, 3, 3), dtype=REAL, device=device),
                     material=torch.zeros((0,), dtype=INDEX, device=device))


def _instance_transform(verts: np.ndarray, rotate_y: float,
                        translate) -> np.ndarray:
    """Rotate (P, 3) points about the world y-axis by ``rotate_y``
    degrees, then translate: the book's instance transforms (RTW book 2
    ch. 8) baked into the geometry (``rtow_tpu.models.scene``, :170)."""
    if rotate_y != 0.0:
        th = np.radians(float(rotate_y))
        c, s = np.cos(th), np.sin(th)
        # Book convention: +angle takes +z toward +x.
        verts = verts @ np.array(
            [[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], np.float64)
    return verts + np.asarray(tuple(float(t) for t in translate),
                              np.float64)


class SceneBuilder:
    """Host-side append API mirroring ``Scene::primitives().add<T>(...)``
    (reference src/render.h:22-33), frozen into dense tensors.

    Building happens in numpy float64 (the reference's precision) and is
    cast to the device dtype once, at freeze time — the same rounding as
    ``rtow_tpu.models.scene.SceneBuilder``, so both packages build
    identical arrays."""

    def __init__(self) -> None:
        self._mat_kind: list[int] = []
        self._mat_albedo: list[tuple] = []
        self._mat_fuzz: list[float] = []
        self._mat_ir: list[float] = []
        self._sph: list[tuple] = []  # (c0, c1, radius, mat)
        self._tri: list[tuple] = []  # (a, b, c, mat)
        self._tri_blocks: list[tuple] = []  # ((M, 3, 3) array, mat)

    # -- materials (the "boutique") ---------------------------------------
    def add_lambertian(self, albedo) -> int:
        return self._add_mat(LAMBERTIAN, albedo, 0.0, 1.0)

    def add_metal(self, albedo, fuzz: float = 0.0) -> int:
        return self._add_mat(METAL, albedo, fuzz, 1.0)

    def add_dielectric(self, ir: float, fuzz: float = 0.0) -> int:
        return self._add_mat(DIELECTRIC, (0.0, 0.0, 0.0), fuzz, ir)

    def _add_mat(self, kind, albedo, fuzz, ir) -> int:
        self._mat_kind.append(kind)
        self._mat_albedo.append(tuple(float(x) for x in albedo))
        # Reference clamps fuzz into [0, 1] at construction
        # (src/common-model.h:133, :145).
        self._mat_fuzz.append(min(max(float(fuzz), 0.0), 1.0))
        self._mat_ir.append(float(ir))
        return len(self._mat_kind) - 1

    # -- primitives --------------------------------------------------------
    def add_sphere(self, center, radius: float, material: int) -> None:
        c = tuple(float(x) for x in center)
        self._sph.append((c, c, float(radius), material))

    def add_moving_sphere(self, center0, center1, radius: float,
                          material: int) -> None:
        self._sph.append((tuple(float(x) for x in center0),
                          tuple(float(x) for x in center1),
                          float(radius), material))

    def add_triangle(self, a, b, c, material: int) -> None:
        self._tri.append((tuple(float(x) for x in a),
                          tuple(float(x) for x in b),
                          tuple(float(x) for x in c), material))

    def add_mesh(self, tri_verts: np.ndarray, material: int, *,
                 scale=1.0, rotate_y: float = 0.0,
                 translate=(0.0, 0.0, 0.0)) -> None:
        """Bulk-append (M, 3, 3) triangle vertices (the OBJ path), with
        the instance transforms scale -> rotate_y -> translate baked into
        the vertices.  Stored as one array block."""
        block = np.ascontiguousarray(tri_verts, dtype=np.float64)
        if block.ndim != 3 or block.shape[1:] != (3, 3):
            raise ValueError(f"expected (M, 3, 3) vertices, got {block.shape}")
        if (np.any(np.asarray(scale) != 1.0) or rotate_y != 0.0
                or any(float(t) != 0.0 for t in translate)):
            flat = block.reshape(-1, 3) * np.asarray(scale, np.float64)
            block = _instance_transform(flat, rotate_y,
                                        translate).reshape(-1, 3, 3)
        self._tri_blocks.append((block, int(material)))

    # -- freeze --------------------------------------------------------------
    def build(self, dtype=REAL, background="sky", device="cuda") -> Scene:
        """``background``: "sky" (reference gradient) or an (r, g, b)
        tuple.  Raises where CUDA is asked for and there is no card."""
        device = resolve_device(device)
        if not self._mat_kind:
            raise ValueError("scene has no materials")
        if not self._sph and not self._tri and not self._tri_blocks:
            raise ValueError("scene has no primitives")
        if background != "sky":
            background = tuple(float(x) for x in background)
            if len(background) != 3:
                raise ValueError("background must be 'sky' or (r, g, b)")

        c0 = np.array([s[0] for s in self._sph], np.float64).reshape(-1, 3)
        c1 = np.array([s[1] for s in self._sph], np.float64).reshape(-1, 3)
        rad = np.array([s[2] for s in self._sph], dtype=np.float64)
        smat = np.array([s[3] for s in self._sph], dtype=np.int32)
        tvs = [np.array([t[:3] for t in self._tri], np.float64)
               .reshape(-1, 3, 3)]
        tmats = [np.array([t[3] for t in self._tri], np.int32)]
        for block, mat in self._tri_blocks:
            tvs.append(block)
            tmats.append(np.full((block.shape[0],), mat, np.int32))
        tv, tmat = np.concatenate(tvs), np.concatenate(tmats)
        if any(self._mat_kind[m] in _TEXTURED for m in np.unique(tmat)):
            raise ValueError(
                "textured materials are sphere-only: the kernel's triangle"
                " table has no spare columns for the second color")
        albedo = np.array(self._mat_albedo, np.float64)

        def real(x):
            return torch.as_tensor(x).to(device=device, dtype=dtype)

        def index(x):
            return torch.as_tensor(x).to(device=device, dtype=INDEX)

        return Scene(
            spheres=Spheres(center0=real(c0), dcenter=real(c1 - c0),
                            radius=real(rad), material=index(smat)),
            triangles=Triangles(verts=real(tv), material=index(tmat)),
            materials=Materials(
                kind=index(np.array(self._mat_kind, np.int32)),
                albedo=real(albedo),
                fuzz=real(np.array(self._mat_fuzz, np.float64)),
                ir=real(np.array(self._mat_ir, np.float64)),
                albedo2=real(albedo),
            ),
            background=background,
        )
