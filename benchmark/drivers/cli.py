"""CLI traffic: one user runs the program's command line
(``rtweekend-torch``, ``cli.main``) on the book's cover, frame after
frame: the scene built from ``--seed``, the render, the PPM written to a
file under ``TMPDIR``.  Only the cover is rendered this way (the command
line builds its scenes itself).

The check reads the last PPM back and holds a sample of its pixels,
drawn from the seed, to the reference's, tone-mapped as the PPM is (the
book's gamma 2 and 8 bits); the number compared is the widest gap in
8-bit levels, ``ppm_gap``.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from . import Check, Context


def tonemap(mean: np.ndarray) -> np.ndarray:
    """The book's ``write_color``: gamma 2, clamped to [0, 0.999], x 256,
    truncated."""
    c = np.sqrt(np.maximum(np.asarray(mean, np.float64), 0.0))
    return (256.0 * np.clip(c, 0.0, 0.999)).astype(np.int64)


def read_ppm(path: str) -> np.ndarray:
    """A P3 PPM -> (H, W, 3) ints."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{path} is not a P3 PPM")
    w, h = int(tokens[1]), int(tokens[2])
    return np.asarray(tokens[4:4 + 3 * w * h], np.int64).reshape(h, w, 3)


class Driver:
    def __init__(self, ctx: Context):
        if ctx.config["scene"] != "cover":
            raise ValueError("the command line renders the cover only")
        self.ctx = ctx
        self.width, self.height = ctx.size("width"), ctx.size("height")
        self.spp, self.max_depth = ctx.size("spp"), ctx.size("max_depth")
        self.check_rows = ctx.traffic["check"]["tile_rows"]
        self.path = os.path.join(tempfile.gettempdir(), "bench-cli.ppm")

    def rays(self) -> int:
        return self.width * self.height * self.spp

    def seed(self) -> int:
        """The command line's one seed, of the scene and the draws alike."""
        return int(self.ctx.config.get("scene_seed", self.ctx.seeds.kernel))

    def argv(self) -> list:
        num, den = self.ctx.size("aspect_ratio")
        c = self.ctx.config
        return (["-w", str(self.width), "-a", repr(num / den),
                 "-s", str(self.spp), "-c", str(self.max_depth),
                 "-n", str(c["number_of_balls_sqrt"]),
                 "--seed", str(self.seed()), "-o", self.path,
                 "--device", self.ctx.device.type]
                + ([] if c["moving_spheres"] else ["--static-spheres"]))

    def setup(self) -> None:
        from benchmark.reference.render import draw_sample

        self.sample = draw_sample(self.ctx.inputs, self.width, self.height,
                                  np.random.default_rng(self.ctx.seeds.sample),
                                  self.check_rows, 0)
        self.unit(-1)

    def unit(self, i: int) -> int:
        from rtow_tpu_torch import cli

        if cli.main(self.argv()) != 0:
            raise RuntimeError("the command line failed")
        return self.rays()

    def release(self) -> None:
        pass

    def check(self, limits: dict) -> Check:
        import torch

        from benchmark.reference.render import render_sample

        ppm = read_ppm(self.path)
        os.remove(self.path)
        got = ppm[self.sample.rows, self.sample.cols]
        ref = tonemap(render_sample(
            self.ctx.inputs, self.ctx.camera(), self.sample,
            seed=self.seed(), width=self.width,
            height=self.height, spp=self.spp, max_depth=self.max_depth,
            device=self.ctx.device, dtype=torch.float32))
        return Check({"ppm_gap": float(np.max(np.abs(got - ref)))}, limits)
