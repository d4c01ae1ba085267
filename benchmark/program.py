"""The benchmark's one door into the program: the scene and camera of the
benchmark's inputs built through ``rtow_tpu_torch``'s own scene builder,
and the counters the traced run reads from the program's entry points.

Nothing here imports the program at module level, so the harness's
checks and the reference run without it.
"""
from __future__ import annotations

import contextlib

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2


def build_scene(inputs: dict, device):
    """The program's ``Scene`` of the benchmark's inputs, through
    ``SceneBuilder``: the materials in order, then the spheres (moving
    ones from their two centres), then the triangles of each material as
    one mesh block."""
    import numpy as np

    from rtow_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder()
    m = inputs["materials"]
    for kind, albedo, fuzz, ir in zip(m["kind"], m["albedo"], m["fuzz"],
                                      m["ir"]):
        if kind == LAMBERTIAN:
            b.add_lambertian(albedo)
        elif kind == METAL:
            b.add_metal(albedo, float(fuzz))
        elif kind == DIELECTRIC:
            b.add_dielectric(float(ir), float(fuzz))
        else:
            raise ValueError(f"material kind {kind} has no builder here")
    s = inputs["spheres"]
    for c0, c1, r, mat in zip(s["center0"], s["center1"], s["radius"],
                              s["material"]):
        b.add_moving_sphere(c0, c1, float(r), int(mat))
    t = inputs["triangles"]
    mats = np.asarray(t["material"])
    for mat in np.unique(mats):
        b.add_mesh(np.asarray(t["verts"])[mats == mat], int(mat))
    return b.build(background=inputs.get("background", "sky"), device=device)


def build_camera(spec: dict, device):
    from rtow_tpu_torch.models.camera import make_camera

    return make_camera(
        lookfrom=spec["lookfrom"], lookat=spec["lookat"],
        vup=spec.get("vup", (0.0, 1.0, 0.0)),
        fov_degrees=spec["fov_degrees"], aspect_ratio=spec["aspect_ratio"],
        aperture=spec["aperture"], focus_dist=spec.get("focus_dist"),
        t0=spec.get("t0", 0.0), t1=spec.get("t1", 0.0), device=device)


class Counters:
    """The port's own work counters, passed to its kernels' entry points
    while the traced window runs (each adds one atomic per warp at the
    end of a launch): K1's ray steps (``render_blocks(steps=)``), K3's box
    tests, triangle tests and live lanes (``bounce_step(stats=)``), K4's
    box tests, triangle tests, live lanes and shadow rays
    (``bounce_fwd(stats=)``); K5 replays K4's lanes.

    ``counts()`` returns {"k1_steps", "k3_live", "k4_live"} for the
    counters that some launch fed."""

    def __init__(self, device):
        import torch

        self.steps = torch.zeros(1, dtype=torch.int64, device=device)
        self.k3 = torch.zeros(3, dtype=torch.int64, device=device)
        self.k4 = torch.zeros(4, dtype=torch.int64, device=device)
        self.fed = set()

    @contextlib.contextmanager
    def installed(self):
        """Within the block, every call of the program's K1, K3 and K4
        entry points feeds the counters."""
        from rtow_tpu_torch import pipeline
        from rtow_tpu_torch.ops import grad, wavefront

        saved = (pipeline.render_blocks, wavefront.bounce_step,
                 grad.bounce_fwd)
        k1, k3, k4 = saved

        def counted_k1(*a, **k):
            self.fed.add("k1_steps")
            return k1(*a, **{**k, "steps": self.steps})

        def counted_k3(*a, **k):
            self.fed.add("k3_live")
            return k3(*a, **{**k, "stats": self.k3})

        def counted_k4(*a, **k):
            self.fed.add("k4_live")
            return k4(*a, **{**k, "stats": self.k4})

        # The entry points count their own launches on the function
        # object that their module names: the wrappers carry the counts.
        for wrapper, inner in ((counted_k1, k1), (counted_k3, k3),
                               (counted_k4, k4)):
            wrapper.__dict__.update(inner.__dict__)
        pipeline.render_blocks = counted_k1
        wavefront.bounce_step = counted_k3
        grad.bounce_fwd = counted_k4
        try:
            yield self
        finally:
            pipeline.render_blocks, wavefront.bounce_step, grad.bounce_fwd = (
                saved)

    def counts(self) -> dict:
        out = {"k1_steps": int(self.steps[0]), "k3_live": int(self.k3[2]),
               "k4_live": int(self.k4[2])}
        return {k: v for k, v in out.items() if k in self.fed}
