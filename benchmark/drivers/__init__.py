"""The drivers of the traffic kinds, one module each
(``drivers/<kind>.py``, each defining ``Driver``).

A driver is built with the run's :class:`Context`.  ``setup()`` builds
the program's objects and warms up every shape the window uses (it may
run the window's own call); ``unit(i)`` runs one frame or step of the
closed loop, returning the primary rays it rendered; ``release()`` frees
the program's state; ``check(limits)`` runs the reference and returns a
:class:`Check`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class Seeds:
    """The numbers a run draws from its ``--seed`` (any integer): the
    kernels' salt and the cover's scene (``kernel``, below 2**31 less
    room for the wavefront's chunk salts), and the seeds of the target's
    and the steps' camera generators, the albedos' perturbation and the
    sample of pixels compared."""

    def __init__(self, seed: int):
        state = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(
            5, np.uint64)
        self.kernel = int(state[0] % np.uint64((1 << 31) - (1 << 24)))
        self.target = int(state[1] >> np.uint64(2))
        self.feed = int(state[2] >> np.uint64(2))
        self.perturb = int(state[3])
        self.sample = int(state[4])


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's configuration and traffic (their
    files' contents), the seeds, the device and the scene's inputs."""
    config: dict
    traffic: dict
    seeds: Seeds
    device: object
    inputs: dict
    #: Sizes that replace the traffic's (the CPU tests' small runs).
    sizes: Optional[dict] = None

    def size(self, key):
        if self.sizes and key in self.sizes:
            return self.sizes[key]
        return self.traffic[key]

    def camera(self) -> dict:
        """The configuration's camera at the traffic's aspect ratio."""
        num, den = self.size("aspect_ratio")
        return {**self.config["camera"], "aspect_ratio": num / den}


@dataclasses.dataclass
class Check:
    """The output check: each number compared with its limit, and the
    frames or steps of the window whose answers were wrong."""
    numbers: dict
    limits: dict
    failed: int = 0

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.numbers) and all(
            k in self.limits and np.isfinite(v) and v <= self.limits[k]
            for k, v in self.numbers.items()))
