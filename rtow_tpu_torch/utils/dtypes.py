"""Floating-point policy: float32 compute, int32 ids (as in
``rtow_tpu.utils.dtypes``).  Host-side scene generation stays in numpy
float64 and is cast once, when the scene is built."""
from __future__ import annotations

import torch

#: Default real dtype for device-side tracing.
REAL = torch.float32

#: Index dtype for primitive/material ids.
INDEX = torch.int32
