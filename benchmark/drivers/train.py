"""Train traffic: one client fits the scene's material albedos by SGD,
step after step, through the program's train step
(``diff.build_train_step``: every pixel rendered by the gradient
kernels K4, the mean squared error against a target, K5's adjoint, the
table sums, ``sgd_update``), each step timed to the synchronize after
it.

Set-up renders the target with the true albedos (the program's
``render_pixels_kernel``), perturbs the albedos by noise drawn from the
seed, builds the step and runs its first three steps: the same object
and call the window goes on with, each step on its own camera rays.  The
check follows those three steps with the reference
(``reference/train.py``) and compares, each as a gap of norms over the
reference's norm: every step's loss (``loss_gap``, the worst of the
three), the first step's gradient as SGD applied it (``grad_gap``, from
the albedos before and after it) and the albedos' change over the three
steps (``change_gap``).
"""
from __future__ import annotations

import numpy as np

from . import Check, Context

#: Steps that set-up runs and the reference follows.
FIRST_STEPS = 3


def gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / abs(ref) if ref else np.inf


def compare(prog: dict, ref: dict, lr: float) -> dict:
    """The three numbers compared from the program's and the reference's
    {"losses", "albedo": [A0, A1, ...]} (and the reference's "grad")."""
    a = [np.asarray(x, np.float64) for x in prog["albedo"]]
    b = [np.asarray(x, np.float64) for x in ref["albedo"]]
    norm = np.linalg.norm
    return {
        "loss_gap": max(gap(p, r) for p, r in zip(prog["losses"],
                                                   ref["losses"])),
        "grad_gap": gap(norm((a[0] - a[1]) / lr), norm(ref["grad"])),
        "change_gap": gap(norm(a[-1] - a[0]), norm(b[-1] - b[0])),
    }


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.width, self.height = ctx.size("width"), ctx.size("height")
        self.spp, self.max_depth = ctx.size("spp"), ctx.size("max_depth")
        train = ctx.config["train"]
        self.lr = float(train["lr"])
        self.perturb = float(train["perturb"])
        self.sort_lanes = ctx.traffic.get("sort_lanes")
        self.losses = []

    def rays(self) -> int:
        return self.width * self.height * self.spp

    def noise(self) -> np.ndarray:
        n = len(self.ctx.inputs["materials"]["kind"])
        rng = np.random.default_rng(self.ctx.seeds.perturb)
        return rng.uniform(-self.perturb, self.perturb, (n, 3)).astype(
            np.float32)

    def gen(self, i: int):
        import torch

        return torch.Generator(self.ctx.device).manual_seed(
            self.ctx.seeds.feed + i)

    def setup(self) -> None:
        import torch

        from benchmark import program
        from rtow_tpu_torch import diff
        from rtow_tpu_torch.ops.grad import render_pixels_kernel

        ctx = self.ctx
        dev = ctx.device
        scene = program.build_scene(ctx.inputs, dev)
        camera = program.build_camera(ctx.camera(), dev)
        kw = dict(width=self.width, height=self.height, spp=self.spp,
                  max_depth=self.max_depth)
        if self.sort_lanes is not None:
            kw["sort_lanes"] = self.sort_lanes
        with torch.no_grad():
            self.target = render_pixels_kernel(
                scene, camera, torch.Generator(dev).manual_seed(
                    ctx.seeds.target),
                torch.arange(self.width * self.height, device=dev),
                seed=ctx.seeds.kernel, **kw)
        albedo = scene.materials.albedo
        noise = torch.as_tensor(self.noise()).to(dev)
        self.state = scene.replace_leaves(
            {"materials.albedo": (albedo + noise).clamp(0.0, 1.0)})
        self.step = diff.build_train_step(
            camera, lr=self.lr, keep=lambda p: p.endswith("albedo"),
            seed=ctx.seeds.kernel, **kw)
        self.first = {"losses": [], "albedo": [
            self.state.materials.albedo.detach().double().cpu().numpy()]}
        for i in range(FIRST_STEPS):
            loss = self._step(i)
            self.first["losses"].append(float(loss))
            self.first["albedo"].append(
                self.state.materials.albedo.detach().double().cpu().numpy())

    def _step(self, i: int):
        self.state, loss = self.step(self.state, self.gen(i), self.target)
        return loss

    def unit(self, i: int) -> int:
        import torch

        self.losses.append(self._step(FIRST_STEPS + i))
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        return self.rays()

    def release(self) -> None:
        import torch

        self.failed = int(sum(not bool(torch.isfinite(x)) for x in
                              self.losses))
        self.losses = []
        self.state = self.step = self.target = None

    def reference(self, dtype=None) -> dict:
        import torch

        from benchmark.reference.train import steps

        ctx = self.ctx
        return steps(ctx.inputs, ctx.camera(), width=self.width,
                     height=self.height, spp=self.spp,
                     max_depth=self.max_depth, seed=ctx.seeds.kernel,
                     target_seed=ctx.seeds.target,
                     feed_seeds=[ctx.seeds.feed + i
                                 for i in range(FIRST_STEPS)],
                     noise=self.noise(), lr=self.lr, device=ctx.device,
                     dtype=dtype or torch.float32)

    def check(self, limits: dict) -> Check:
        return Check(compare(self.first, self.reference(), self.lr), limits,
                     failed=self.failed)
