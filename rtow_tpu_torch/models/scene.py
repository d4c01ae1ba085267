"""SoA scene representation: dataclasses of tensors (the port of
``rtow_tpu.models.scene``).

One array set per primitive kind and one flat material table.  Static
spheres and moving spheres share one array family:
``center(t) = center0 + t * dcenter`` with ``dcenter = 0`` for static
spheres (the reference's lerp over the shutter interval,
src/oo-primitives.h:63-66).

The port covers spheres, triangles (single triangles, quads, boxes and
whole meshes, with the book's scale / rotate_y / translate instancing
baked into the vertices), the Lambertian / metal / dielectric / emissive
/ checker / noise materials and constant-density media.  Image textures
(``IMAGE``, the globe) belong to the reference integrator and are not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..config import resolve_device
from ..utils.dtypes import INDEX, REAL

#: The scene's parts, in the JAX scene's leaf order.
_PARTS = ("spheres", "triangles", "materials", "volumes")

# Material kinds — the codes of rtow_tpu.models.scene (:36-57).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
#: A diffuse area light: ``albedo`` holds the emitted radiance.
EMISSIVE = 3
#: Lambertians whose albedo alternates (checker) or lerps (marble noise)
#: between ``albedo`` and ``albedo2``; the scale rides the ``ir`` column.
CHECKER = 4
NOISE = 5
#: An image-textured Lambertian (the reference integrator only).
IMAGE = 6
#: The textured kinds, which the JAX package allows on spheres only.
_TEXTURED = (CHECKER, NOISE, IMAGE)
#: NEE unrolls the light loop and the bounce the volume loop: at most
#: this many emissive primitives and volumes (scene.py:423-440).
MAX_LIGHTS = 16
MAX_VOLUMES = 8


@dataclasses.dataclass
class Materials:
    kind: torch.Tensor  # (K,)  int32
    albedo: torch.Tensor  # (K, 3)
    fuzz: torch.Tensor  # (K,)  clamped to [0, 1] at build
    ir: torch.Tensor  # (K,)  dielectric refraction index / texture scale
    albedo2: torch.Tensor  # (K, 3) second texture color (= albedo elsewhere)


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
class Volumes:
    """Constant-density media, each an analytic boundary: a sphere, an
    axis-aligned box, or a box rotated about y (``Scene.volume_kinds``:
    "s", "b", "r")."""
    p0: torch.Tensor  # (V, 3) sphere center / box min corner (local)
    p1: torch.Tensor  # (V, 3) (radius, 0, 0) / box max corner (local)
    density: torch.Tensor  # (V,) sigma per world length
    albedo: torch.Tensor  # (V, 3) scatter albedo
    rotate_y: torch.Tensor  # (V,) radians (kind "r")
    translate: torch.Tensor  # (V, 3) world offset of a rotated box


@dataclasses.dataclass
class Scene:
    spheres: Spheres
    triangles: Triangles
    materials: Materials
    #: "sky" (the reference's gradient) or a flat (r, g, b) tuple.
    background: Union[str, tuple] = "sky"
    #: Constant-density media, or None.
    volumes: Optional[Volumes] = None
    # Static metadata, derived in SceneBuilder.build as the JAX package
    # derives it (scene.py:423-482): whether any material is EMISSIVE,
    # ("s" | "t", primitive index) of each emissive sphere and triangle
    # (triangles in build order), whether any material is textured, and
    # the kind of each volume.
    has_emissive: bool = False
    light_ids: tuple = ()
    has_checker: bool = False
    volume_kinds: tuple = ()

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

    def _parts(self):
        return [p for p in _PARTS if getattr(self, p) is not None]

    def leaves(self) -> Dict[str, Optional[torch.Tensor]]:
        """Every leaf under its dotted key (``"spheres.center0"``, ...,
        ``"materials.albedo2"``, ``"volumes.p0"``, ...), the JAX scene's
        leaf paths."""
        return {f"{part}.{f.name}": getattr(getattr(self, part), f.name)
                for part in self._parts()
                for f in dataclasses.fields(getattr(self, part))}

    def meta(self) -> dict:
        """The static metadata, as keyword arguments of
        :meth:`from_numpy`."""
        return dict(background=self.background,
                    has_emissive=self.has_emissive,
                    light_ids=self.light_ids, has_checker=self.has_checker,
                    volume_kinds=self.volume_kinds)

    def replace_leaves(self, new: Mapping[str, Optional[torch.Tensor]]
                       ) -> "Scene":
        """A copy with the leaves under the given dotted keys replaced."""
        parts = {}
        for part in self._parts():
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
                   background: Union[str, tuple] = "sky", *,
                   volume_kinds: tuple = (), **meta) -> "Scene":
        """Build a scene from the JAX scene's leaves, given as numpy
        arrays keyed ``"spheres.center0"``, ..., ``"materials.kind"``,
        ``"volumes.p0"``, ...

        Values are copied bit for bit (floats as float32, ids as
        int32).  Triangle and volume keys may be absent (none of them).
        The metadata that the leaves determine (``has_emissive``,
        ``light_ids``, ``has_checker``) is derived from them as
        ``SceneBuilder.build`` derives it; where it is also given (as
        :meth:`meta` returns it) it must agree.  ``volume_kinds``, which
        the leaves do not determine, must name each volume's kind.
        Image textures (a ``texture`` leaf or an IMAGE material) are not
        ported."""
        def take(key, dtype):
            return torch.tensor(np.asarray(arrays[key]), dtype=dtype,
                                device=device)

        for key, val in arrays.items():
            part = key.split(".", 1)[0]
            if part not in _PARTS and np.size(val):
                raise NotImplementedError(
                    f"scene leaf {key!r} (image textures) belongs to the "
                    f"reference integrator (ROADMAP Queue 1 item 5)")
        n_vol = (np.shape(arrays["volumes.p0"])[0]
                 if "volumes.p0" in arrays else 0)
        if len(volume_kinds) != n_vol or not set(volume_kinds) <= {
                "s", "b", "r"}:
            raise ValueError(f"volume_kinds {volume_kinds!r} must name the "
                             f"kind of each of the {n_vol} volumes")
        volumes = (Volumes(**{f.name: take(f"volumes.{f.name}", REAL)
                              for f in dataclasses.fields(Volumes)})
                   if n_vol else None)
        kinds = np.asarray(arrays["materials.kind"])
        smat = np.asarray(arrays["spheres.material"])
        tmat = np.asarray(arrays.get("triangles.material",
                                     np.zeros((0,), np.int32)))
        derived = _derived_meta([int(k) for k in kinds], smat, tmat)
        for key, val in meta.items():
            if key not in derived:
                raise TypeError(f"unknown scene metadata {key!r}")
            if (tuple(map(tuple, val)) if key == "light_ids"
                    else val) != derived[key]:
                raise ValueError(f"scene metadata {key}={val!r} disagrees "
                                 f"with the leaves ({derived[key]!r})")
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
            volumes=volumes,
            volume_kinds=tuple(volume_kinds),
            **derived,
        )


def _derived_meta(kinds, smat, tmat) -> dict:
    """has_emissive, light_ids and has_checker from the material kinds
    and the spheres' and triangles' material ids (scene.py:474-482)."""
    return dict(
        has_emissive=EMISSIVE in kinds,
        light_ids=tuple(
            [("s", i) for i, m in enumerate(smat) if kinds[m] == EMISSIVE]
            + [("t", i) for i, m in enumerate(tmat)
               if kinds[m] == EMISSIVE]),
        has_checker=any(k in (CHECKER, NOISE) for k in kinds),
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
        self._mat_albedo2: list[tuple] = []
        self._sph: list[tuple] = []  # (c0, c1, radius, mat)
        self._tri: list[tuple] = []  # (a, b, c, mat)
        self._tri_blocks: list[tuple] = []  # ((M, 3, 3) array, mat)
        # (kind, p0, p1, density, albedo[, rotate_y radians, translate])
        self._vol: list[tuple] = []

    # -- materials (the "boutique") ---------------------------------------
    def add_lambertian(self, albedo) -> int:
        return self._add_mat(LAMBERTIAN, albedo, 0.0, 1.0)

    def add_metal(self, albedo, fuzz: float = 0.0) -> int:
        return self._add_mat(METAL, albedo, fuzz, 1.0)

    def add_dielectric(self, ir: float, fuzz: float = 0.0) -> int:
        return self._add_mat(DIELECTRIC, (0.0, 0.0, 0.0), fuzz, ir)

    def add_light(self, emit) -> int:
        """Diffuse area light: ``emit`` is the emitted radiance (r, g, b);
        a hit adds throughput * emit and ends the path."""
        return self._add_mat(EMISSIVE, emit, 0.0, 1.0)

    def add_checker(self, even, odd, scale: float = 10.0) -> int:
        """Checkerboard Lambertian: ``even`` or ``odd`` by the sign of
        prod(sin(scale * p)) at the hit point (scale in the ``ir``
        column)."""
        return self._add_mat(CHECKER, even, 0.0, float(scale), albedo2=odd)

    def add_noise(self, base, vein, scale: float = 4.0) -> int:
        """Marble Lambertian: the albedo lerps ``base`` <-> ``vein`` by
        ``models/materials.marble_t`` at ``scale``."""
        return self._add_mat(NOISE, base, 0.0, float(scale), albedo2=vein)

    def _add_mat(self, kind, albedo, fuzz, ir, albedo2=None) -> int:
        self._mat_kind.append(kind)
        self._mat_albedo.append(tuple(float(x) for x in albedo))
        # Reference clamps fuzz into [0, 1] at construction
        # (src/common-model.h:133, :145).
        self._mat_fuzz.append(min(max(float(fuzz), 0.0), 1.0))
        self._mat_ir.append(float(ir))
        self._mat_albedo2.append(
            tuple(float(x) for x in albedo2) if albedo2 is not None
            else self._mat_albedo[-1])
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

    def add_quad(self, p00, p10, p11, p01, material: int) -> None:
        """Quadrilateral as two triangles, corners CCW as seen from the
        normal side (the side the backface cull lets rays hit)."""
        self.add_triangle(p00, p10, p11, material)
        self.add_triangle(p00, p11, p01, material)

    def add_box(self, p_min, p_max, material: int, *,
                rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """Axis-aligned box as 12 outward-wound triangles, with the
        book's rotate_y (degrees) and translate baked into the vertices
        (scene.py:296-321)."""
        x0, y0, z0 = (float(v) for v in p_min)
        x1, y1, z1 = (float(v) for v in p_max)
        quads = [
            # +z, -z, +x, -x, +y, -y faces, CCW from outside.
            ((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)),
            ((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)),
            ((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)),
            ((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)),
            ((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)),
            ((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)),
        ]
        verts = np.array(quads, dtype=np.float64).reshape(-1, 3)
        verts = _instance_transform(verts, rotate_y, translate)
        for q in verts.reshape(6, 4, 3):
            self.add_quad(q[0], q[1], q[2], q[3], material)

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

    # -- constant-density media (book 2 ch. 9) -----------------------------
    def add_fog_sphere(self, center, radius: float, density: float,
                       albedo=(1.0, 1.0, 1.0)) -> None:
        """A medium of ``density`` inside an invisible sphere boundary,
        scattering isotropically with ``albedo``."""
        self._vol.append(("s", tuple(float(x) for x in center),
                          (float(radius), 0.0, 0.0), float(density),
                          tuple(float(x) for x in albedo)))

    def add_fog_box(self, p_min, p_max, density: float,
                    albedo=(1.0, 1.0, 1.0), *, rotate_y: float = 0.0,
                    translate=(0.0, 0.0, 0.0)) -> None:
        """A medium inside a box.  A pure translation bakes into the
        corners ("b"); with ``rotate_y`` (degrees) the box stays in its
        local frame and rays are inverse-rotated ("r")."""
        p_min = tuple(float(x) for x in p_min)
        p_max = tuple(float(x) for x in p_max)
        translate = tuple(float(x) for x in translate)
        albedo = tuple(float(x) for x in albedo)
        if rotate_y == 0.0:
            self._vol.append(("b", tuple(a + b for a, b in zip(p_min,
                                                                 translate)),
                              tuple(a + b for a, b in zip(p_max, translate)),
                              float(density), albedo))
        else:
            self._vol.append(("r", p_min, p_max, float(density), albedo,
                              float(np.radians(rotate_y)), translate))

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
        meta = _derived_meta(self._mat_kind, smat, tmat)
        if len(meta["light_ids"]) > MAX_LIGHTS:
            raise ValueError(
                f"at most {MAX_LIGHTS} emissive primitives supported (got "
                f"{len(meta['light_ids'])}) — NEE unrolls the light loop")
        if len(self._vol) > MAX_VOLUMES:
            raise ValueError(
                f"at most {MAX_VOLUMES} volumes supported (got "
                f"{len(self._vol)}) — the bounce unrolls the volume table")

        def real(x):
            return torch.as_tensor(x).to(device=device, dtype=dtype)

        def index(x):
            return torch.as_tensor(x).to(device=device, dtype=INDEX)

        volumes = None
        if self._vol:
            v = self._vol
            volumes = Volumes(
                p0=real(np.array([x[1] for x in v], np.float64)),
                p1=real(np.array([x[2] for x in v], np.float64)),
                density=real(np.array([x[3] for x in v], np.float64)),
                albedo=real(np.array([x[4] for x in v], np.float64)),
                rotate_y=real(np.array([x[5] if len(x) > 5 else 0.0
                                        for x in v], np.float64)),
                translate=real(np.array([x[6] if len(x) > 6 else (0.0,) * 3
                                         for x in v], np.float64)))
        return Scene(
            spheres=Spheres(center0=real(c0), dcenter=real(c1 - c0),
                            radius=real(rad), material=index(smat)),
            triangles=Triangles(verts=real(tv), material=index(tmat)),
            materials=Materials(
                kind=index(np.array(self._mat_kind, np.int32)),
                albedo=real(np.array(self._mat_albedo, np.float64)),
                fuzz=real(np.array(self._mat_fuzz, np.float64)),
                ir=real(np.array(self._mat_ir, np.float64)),
                albedo2=real(np.array(self._mat_albedo2, np.float64)),
            ),
            background=background,
            volumes=volumes,
            volume_kinds=tuple(x[0] for x in self._vol),
            **meta,
        )
