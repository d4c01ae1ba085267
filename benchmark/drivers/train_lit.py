"""Lit train traffic: :mod:`.train`'s closed loop of albedo-fit steps
on a scene with a light, through ``diff.build_train_step(nee=True)``:
K4's and K5's lit instances, the light rows' cotangent.

The fit starts from the configuration's ``train.start`` rows (a lamp's
emission among them, which a clamp to [0, 1] would crush) with the
others at truth; the seed changes the camera rays and the kernels'
draws.  The check follows the first three steps with the plain lit
reference (``reference/lit.py``) and compares the same numbers as
:mod:`.train`.
"""
from __future__ import annotations

from . import Context, train
from .render_lit import build_scene

#: The traffic kind whose faults and readings this one takes.
BASE = "train"
compare = train.compare


class Driver(train.Driver):
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.width, self.height = ctx.size("width"), ctx.size("height")
        self.spp, self.max_depth = ctx.size("spp"), ctx.size("max_depth")
        fit = ctx.config["train"]
        self.lr = float(fit["lr"])
        self.start = fit["start"]
        self.sort_lanes = bool(ctx.traffic.get("sort_lanes", False))
        self.losses = []

    def setup(self) -> None:
        import torch

        from benchmark import program
        from benchmark.reference.lit import start_albedo
        from rtow_tpu_torch import diff
        from rtow_tpu_torch.ops.grad import render_pixels_kernel

        ctx = self.ctx
        dev = ctx.device
        scene = build_scene(ctx.inputs, dev)
        camera = program.build_camera(ctx.camera(), dev)
        kw = dict(width=self.width, height=self.height, spp=self.spp,
                  max_depth=self.max_depth, sort_lanes=self.sort_lanes,
                  nee=True)
        with torch.no_grad():
            self.target = render_pixels_kernel(
                scene, camera, torch.Generator(dev).manual_seed(
                    ctx.seeds.target),
                torch.arange(self.width * self.height, device=dev),
                seed=ctx.seeds.kernel, **kw)
        albedo = torch.as_tensor(start_albedo(ctx.inputs, self.start),
                                 dtype=torch.float32).to(dev)
        self.state = scene.replace_leaves({"materials.albedo": albedo})
        self.step = diff.build_train_step(
            camera, lr=self.lr, keep=lambda p: p.endswith("albedo"),
            seed=ctx.seeds.kernel, **kw)
        self.first = {"losses": [], "albedo": [
            self.state.materials.albedo.detach().double().cpu().numpy()]}
        for i in range(train.FIRST_STEPS):
            loss = self._step(i)
            self.first["losses"].append(float(loss))
            self.first["albedo"].append(
                self.state.materials.albedo.detach().double().cpu().numpy())

    def reference(self, dtype=None) -> dict:
        import torch

        from benchmark.reference.lit import steps_lit

        ctx = self.ctx
        return steps_lit(ctx.inputs, ctx.camera(), width=self.width,
                         height=self.height, spp=self.spp,
                         max_depth=self.max_depth, seed=ctx.seeds.kernel,
                         target_seed=ctx.seeds.target,
                         feed_seeds=[ctx.seeds.feed + i
                                     for i in range(train.FIRST_STEPS)],
                         start=self.start, lr=self.lr, device=ctx.device,
                         dtype=dtype or torch.float32)
