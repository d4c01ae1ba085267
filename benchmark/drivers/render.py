"""Render traffic: one client renders whole frames of one scene back to
back through the program's entry, ``pipeline.render_auto`` (the whole-
frame render K1 for sphere scenes and meshes of up to 16,384 triangles,
the sorted wavefront and K3 above), each frame copied to the host.

Every frame of a seed is the same image.  The check holds a sample of
each frame's pixels, drawn from the seed, to the reference's
(``reference/render.py``).  Two numbers are compared, each the worst
over the frames: the widest gap of a pixel (``pixel_gap``, in mean
radiance), and the share of the sample that differs at all
(``mismatch_share``).
"""
from __future__ import annotations

import numpy as np

from . import Check, Context


#: A pixel differs from the reference where its gap passes this (mean
#: radiance; ulps of a float32 sum of the samples stay far below it).
MISMATCH = 1e-5


def compare(frames, ref):
    """The compared numbers of the frames' sampled pixels (each (n, 3))
    against the reference's: the widest gap (``pixel_gap``) and the
    largest share of the sample that differs (``mismatch_share``) over the
    frames; and each frame's own numbers."""
    own = []
    for f in frames:
        gap = np.abs(np.asarray(f, np.float64) - ref).max(axis=1)
        own.append({"pixel_gap": float(gap.max()) if gap.size else np.inf,
                    "mismatch_share": float(np.mean(gap > MISMATCH))
                    if gap.size else np.inf})
    numbers = {k: max(o[k] for o in own) if own else np.inf
               for k in ("pixel_gap", "mismatch_share")}
    return numbers, own


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.traffic
        self.width, self.height = ctx.size("width"), ctx.size("height")
        self.spp, self.max_depth = ctx.size("spp"), ctx.size("max_depth")
        self.check_rows = t["check"]["tile_rows"]
        self.check_pixels = t["check"]["pixels"]
        self.frames = []

    def rays(self) -> int:
        return self.width * self.height * self.spp

    def draw(self) -> None:
        """The sample of pixels compared, drawn from the seed."""
        from benchmark.reference.render import draw_sample

        self.sample = draw_sample(
            self.ctx.inputs, self.width, self.height,
            np.random.default_rng(self.ctx.seeds.sample), self.check_rows,
            self.check_pixels)

    def setup(self) -> None:
        from benchmark import program
        from rtow_tpu_torch.config import Config

        ctx = self.ctx
        device = ctx.device
        self.scene = program.build_scene(ctx.inputs, device)
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

    def unit(self, i: int) -> int:
        from rtow_tpu_torch import pipeline

        img = pipeline.render_auto(self.scene, self.camera, self.cfg)
        self.frames.append(img[self.sample.rows, self.sample.cols])
        return self.rays()

    def release(self) -> None:
        self.scene = self.camera = None

    def reference(self, dtype=None):
        import torch

        from benchmark.reference.render import render_sample

        ctx = self.ctx
        return render_sample(
            ctx.inputs, ctx.camera(), self.sample, seed=ctx.seeds.kernel,
            width=self.width, height=self.height, spp=self.spp,
            max_depth=self.max_depth, device=ctx.device,
            dtype=dtype or torch.float32)

    def check(self, limits: dict) -> Check:
        numbers, own = compare(self.frames, self.reference())
        # The first frame is set-up's; the window's are the rest.
        failed = sum(any(v > limits.get(k, -np.inf) for k, v in o.items())
                     for o in own[1:])
        return Check(numbers, limits, failed=failed)
