"""Carrying model tables from the JAX package into the port.

A model triple built by ``itrails_tpu`` arrives here as numpy arrays, so a
test can feed both packages identical tables independent of either
builder.  The YAML artifacts (``.best_model.yaml``, the history CSV) are
already in one format shared by both packages and need no conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from itrails_tpu_torch import resolve_device

__all__ = ["model_from_numpy"]


def model_from_numpy(a, b, pi, *, device, dtype=torch.float64):
    """``(a, b, pi)`` numpy arrays (M, M), (M, 256 or 625), (M,) -> the same
    tables as ``dtype`` tensors on ``device``."""
    dev = resolve_device(device)
    a, b, pi = (np.asarray(x) for x in (a, b, pi))
    m = a.shape[0]
    if a.shape != (m, m) or pi.shape != (m,) or b.ndim != 2 or b.shape[0] != m:
        raise ValueError(f"inconsistent model shapes: a {a.shape}, "
                         f"b {b.shape}, pi {pi.shape}")
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in (a, b, pi))
