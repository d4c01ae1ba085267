"""Faults planted under the timed path, to show that the output check
catches them: each is a context manager that patches the program while
it is open.

* ``unchanged``: a train step returns its state unchanged; a frame
  returns without rendering (an image of zeros).
* ``half``: half of the batch left out, the mean taken over the rest: a
  step's loss over the first half of the pixels; a frame's mean over half
  the samples of each pixel.
* ``altered``: an answer altered where it is produced: each step's new
  albedos of the first material off by 0.01; each frame's pixels off by
  0.01.

One chip: no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib
import dataclasses

#: What ``altered`` adds.
OFFSET = 0.01


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def planted(fault: str, kind: str):
    """Patch the program with ``fault`` for traffic of ``kind`` ("render"
    or "train")."""
    from rtow_tpu_torch import diff, pipeline

    if kind == "render":
        render = pipeline.render_auto

        def frame(scene, camera, cfg, progress=False):
            if fault == "unchanged":
                return 0.0 * render(scene, camera, cfg)
            if fault == "half":
                half = dataclasses.replace(
                    cfg, samples_per_pixel=max(cfg.samples_per_pixel // 2, 1))
                return render(scene, camera, half)
            if fault == "altered":
                return render(scene, camera, cfg) + OFFSET
            raise ValueError(f"no fault {fault!r}")

        with _patched(pipeline, "render_auto", frame):
            yield
        return
    if fault == "unchanged":
        build = diff.build_train_step

        def build_unchanged(*a, **k):
            step = build(*a, **k)

            def same(scene, gen, target):
                _, loss = step(scene, gen, target)
                return scene, loss
            return same

        with _patched(diff, "build_train_step", build_unchanged):
            yield
    elif fault == "half":
        def half_mse(scene, camera, gen, target, pixel_ids, **kw):
            import torch

            img = diff.render_pixels_kernel(scene, camera, gen, pixel_ids,
                                            **kw)
            target = torch.as_tensor(target, dtype=img.dtype,
                                     device=img.device)
            n = img.shape[0] // 2
            return torch.mean((img[:n] - target[:n]) ** 2)

        with _patched(diff, "image_mse", half_mse):
            yield
    elif fault == "altered":
        update = diff.sgd_update

        def altered(scene, grads, lr):
            new = update(scene, grads, lr)
            albedo = new.materials.albedo.clone()
            albedo[0] += OFFSET
            return new.replace_leaves({"materials.albedo": albedo})

        with _patched(diff, "sgd_update", altered):
            yield
    else:
        raise ValueError(f"no fault {fault!r}")


FAULTS = ("unchanged", "half", "altered")
