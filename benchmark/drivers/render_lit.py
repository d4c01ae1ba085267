"""Lit render traffic: :mod:`.render`'s closed loop of whole frames
through ``pipeline.render_auto`` on a scene with a light, which takes
K1's lit instance (emission with its MIS weight, next-event estimation
and its shadow sweep).

The scene is built through the program's ``SceneBuilder`` with its
lights (:func:`build_scene`), and the check holds the sampled tile rows
to the plain lit reference's (``reference/lit.py``), comparing the same
numbers as :mod:`.render`.
"""
from __future__ import annotations

import numpy as np

from . import render

#: The traffic kind whose faults and readings this one takes.
BASE = "render"
compare = render.compare
LAMBERTIAN, METAL, EMISSIVE = 0, 1, 3


def build_scene(inputs: dict, device):
    """The program's ``Scene`` of a lit scene's inputs: the materials in
    order (a light for each emissive row), the spheres, then every
    triangle in the inputs' order (which fixes the light rows' order and
    the triangle table's ties), and the flat background."""
    from rtow_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    m = inputs["materials"]
    for kind, albedo, fuzz in zip(m["kind"], m["albedo"], m["fuzz"]):
        if kind == LAMBERTIAN:
            b.add_lambertian(albedo)
        elif kind == METAL:
            b.add_metal(albedo, float(fuzz))
        elif kind == EMISSIVE:
            b.add_light(albedo)
        else:
            raise ValueError(f"material kind {kind} has no builder here")
    s = inputs["spheres"]
    for c0, c1, r, mat in zip(s["center0"], s["center1"], s["radius"],
                              s["material"]):
        b.add_moving_sphere(c0, c1, float(r), int(mat))
    t = inputs["triangles"]
    for v, mat in zip(np.asarray(t["verts"]), t["material"]):
        b.add_triangle(v[0], v[1], v[2], int(mat))
    return b.build(background=tuple(float(x) for x in inputs["background"]),
                   device=device)


class Driver(render.Driver):
    def setup(self) -> None:
        from benchmark import program
        from rtow_tpu_torch.config import Config

        ctx = self.ctx
        device = ctx.device
        self.scene = build_scene(ctx.inputs, device)
        self.camera = program.build_camera(ctx.camera(), device)
        num, den = ctx.size("aspect_ratio")
        self.cfg = Config(image_width=self.width, aspect_ratio=num / den,
                          samples_per_pixel=self.spp,
                          max_child_rays=self.max_depth,
                          seed=ctx.seeds.kernel, device=str(device))
        if self.cfg.image_height != self.height:
            raise ValueError(f"{self.width} px at aspect {num}/{den} is "
                             f"{self.cfg.image_height} rows, not "
                             f"{self.height}")
        self.draw()
        self.unit(-1)  # warm-up: builds and loads every kernel

    def reference(self, dtype=None):
        import torch

        from benchmark.reference.lit import render_sample_lit

        ctx = self.ctx
        return render_sample_lit(
            ctx.inputs, ctx.camera(), self.sample.tile_rows,
            seed=ctx.seeds.kernel, width=self.width, height=self.height,
            spp=self.spp, max_depth=self.max_depth, device=ctx.device,
            dtype=dtype or torch.float32)
