"""Render statistics: wall time and primary-ray throughput, printed by
the progress-enabled render path (the reference prints "Done in Nms",
src/render.cpp:188-190).  Same ``summary()`` text as
``rtow_tpu.utils.profiling.RenderStats``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RenderStats:
    wall_s: float
    n_pixels: int
    spp: int
    max_depth: int
    backend: str = "cuda"

    @property
    def primary_rays(self) -> int:
        return self.n_pixels * self.spp

    @property
    def primary_mrays_per_s(self) -> float:
        return self.primary_rays / self.wall_s / 1e6

    def summary(self) -> str:
        return (
            f"Done in {int(self.wall_s * 1000)}ms "
            f"({self.primary_mrays_per_s:.2f} Mprimary-rays/s, "
            f"{self.n_pixels}px x {self.spp}spp, depth {self.max_depth}, "
            f"{self.backend})"
        )
