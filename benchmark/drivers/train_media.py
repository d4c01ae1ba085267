"""Media train traffic: one client fits the densities and albedos of a
scene's constant-density media by SGD, step after step, through the
program's train step (``diff.build_train_step(nee=True)``: K4's and K5's
lit instances with the media's free-flight events, next-event estimation
from surface hits and volume events, the shadow rays' transmittance),
each step timed to the synchronize after it.

Set-up builds the scene through the program's ``SceneBuilder`` with its
media (``add_fog_box``), renders the target at the true leaves, puts in
the configuration's ``train.start`` leaves and runs the step's first
three steps, each on its own camera rays; the seed changes the camera
rays and the kernels' draws.  The check follows those three steps with
the plain media reference (``reference/media.py``) and compares, each as
the norm of the difference over the reference's norm: every step's loss
(``loss_gap``, the worst of the three), the first step's gradient as SGD
applied it, the densities' (``density_grad_gap``) apart from the
albedos' (``albedo_grad_gap``: the densities' gradients are tens of
times the albedos', and would hide a fault in them), and the change of
the whole float state the step returns over the three steps
(``change_gap``: the carried leaves too, whose change the reference
holds at zero).
"""
from __future__ import annotations

import numpy as np

from . import Check, train, train_lit
from .render_lit import EMISSIVE, LAMBERTIAN

#: The traffic kind whose faults and readings this one takes.
BASE = "train"
DENSITY, ALBEDO = "volumes.density", "volumes.albedo"
#: The leaves the fit trains.
FIT = (DENSITY, ALBEDO)


def norm_gap(prog, ref) -> float:
    """|prog - ref| / |ref| of two arrays (inf where ref is 0)."""
    ref = np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    num = np.linalg.norm(np.asarray(prog, np.float64) - ref)
    return float(num / den) if den else np.inf


def compare(prog: dict, ref: dict, lr: float) -> dict:
    """The four numbers compared from the program's and the reference's
    {"losses", "state": [{leaf: array}, ...]} (and the reference's
    "grad": {leaf: array}); a leaf that one side's states lack did not
    change there."""
    s, r = prog["state"], ref["state"]
    keys = sorted(set(s[0]) | set(r[0]))
    size = {k: np.size((s[0] if k in s[0] else r[0])[k]) for k in keys}

    def moved(states):
        return np.concatenate([
            (np.asarray(states[-1][k], np.float64)
             - np.asarray(states[0][k], np.float64)).ravel()
            if k in states[0] else np.zeros(size[k]) for k in keys])

    out = {"loss_gap": max(train.gap(p, q) for p, q in zip(prog["losses"],
                                                            ref["losses"]))}
    for name, k in (("density_grad_gap", DENSITY),
                    ("albedo_grad_gap", ALBEDO)):
        g = (np.asarray(s[0][k], np.float64)
             - np.asarray(s[1][k], np.float64)) / lr
        out[name] = norm_gap(g, ref["grad"][k])
    out["change_gap"] = norm_gap(moved(s), moved(r))
    return out


def build_scene(inputs: dict, device):
    """The program's ``Scene`` of a media scene's inputs: the materials in
    order (a light for each emissive row), every triangle in the inputs'
    order, the media through ``add_fog_box`` (each box in its local frame
    with its turn and translation), and the flat background."""
    from rtow_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    m = inputs["materials"]
    for kind, albedo in zip(m["kind"], m["albedo"]):
        if kind == LAMBERTIAN:
            b.add_lambertian(albedo)
        elif kind == EMISSIVE:
            b.add_light(albedo)
        else:
            raise ValueError(f"material kind {kind} has no builder here")
    t = inputs["triangles"]
    for v, mat in zip(np.asarray(t["verts"]), t["material"]):
        b.add_triangle(v[0], v[1], v[2], int(mat))
    v = inputs["volumes"]
    for lo, hi, density, albedo, turn, shift in zip(
            v["p_min"], v["p_max"], v["density"], v["albedo"],
            v["rotate_y"], v["translate"]):
        b.add_fog_box(lo, hi, float(density), albedo=albedo,
                      rotate_y=float(turn), translate=shift)
    return b.build(background=tuple(float(x) for x in inputs["background"]),
                   device=device)


def leaves(scene) -> dict:
    """Every float leaf of ``scene`` as float64 on the host."""
    return {k: x.detach().double().cpu().numpy()
            for k, x in scene.leaves().items()
            if x is not None and x.is_floating_point()}


class Driver(train_lit.Driver):
    def setup(self) -> None:
        import torch

        from benchmark import program
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
        self.state = scene.replace_leaves({
            k: torch.as_tensor(np.asarray(self.start[k], np.float64)).to(
                dev, torch.float32) for k in FIT})
        self.step = diff.build_train_step(
            camera, lr=self.lr, keep=lambda p: p in FIT,
            seed=ctx.seeds.kernel, **kw)
        self.first = {"losses": [], "state": [leaves(self.state)]}
        for i in range(train.FIRST_STEPS):
            loss = self._step(i)
            self.first["losses"].append(float(loss))
            self.first["state"].append(leaves(self.state))

    def reference(self, dtype=None) -> dict:
        import torch

        from benchmark.reference.media import steps_media

        ctx = self.ctx
        return steps_media(ctx.inputs, ctx.camera(), width=self.width,
                           height=self.height, spp=self.spp,
                           max_depth=self.max_depth, seed=ctx.seeds.kernel,
                           target_seed=ctx.seeds.target,
                           feed_seeds=[ctx.seeds.feed + i
                                       for i in range(train.FIRST_STEPS)],
                           start=self.start, lr=self.lr, device=ctx.device,
                           dtype=dtype or torch.float32)

    def check(self, limits: dict) -> Check:
        return Check(compare(self.first, self.reference(), self.lr), limits,
                     failed=self.failed)
