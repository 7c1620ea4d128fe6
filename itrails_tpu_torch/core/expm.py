"""Batched float64 matrix exponential for the model builder.

The JAX package writes its own Pade-13 scaling-and-squaring
(``itrails_tpu/core/expm.py``) because XLA on a TPU has no f64 LU.  On the
card and on the CPU, ``torch.linalg.matrix_exp`` (Taylor-18 with
scaling-and-squaring, Bader-Blanes-Casas 2019) is accurate to the same
f64 round-off, so the builder calls it directly.  The value-only optimize
path needs no custom derivative.
"""

from __future__ import annotations

import torch

__all__ = ["expm_batch"]


def expm_batch(a: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of a batch of square matrices ``(..., n, n)``."""
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expm_batch takes (..., n, n), got {tuple(a.shape)}")
    return torch.linalg.matrix_exp(a)
