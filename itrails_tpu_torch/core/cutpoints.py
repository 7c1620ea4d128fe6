"""Time discretization of the coalescent epochs (reference cutpoints.py).

Interval cutpoints are quantiles of the coalescence-time distribution:
truncated exponential on [0, t_AB] for the two-sequence epoch, exponential
for the three-sequence epoch, in closed form on tensors.
"""

from __future__ import annotations

import torch

__all__ = ["cutpoints_ab", "cutpoints_abc"]


def cutpoints_ab(n_int_AB: int, t_AB, coal_AB, dtype=torch.float64, *,
                 device):
    """Quantiles i/n of a rate-``coal_AB`` exponential truncated to
    [0, t_AB] (reference cutpoints.py:5-28).  Shape (n_int_AB + 1,);
    first entry 0, last exactly t_AB."""
    t_AB = torch.as_tensor(t_AB, dtype=dtype, device=device)
    coal_AB = torch.as_tensor(coal_AB, dtype=dtype, device=device)
    q = torch.arange(n_int_AB + 1, dtype=dtype, device=device) / n_int_AB
    # -expm1 keeps the truncation mass below 1.0 in f64; with the naive
    # 1 - exp(-a) form, coal*t > ~36.7 rounds the mass to exactly 1 and
    # the last cutpoint overflows to inf
    mass = -torch.expm1(-coal_AB * t_AB)
    cut = -torch.log1p(-q * mass) / coal_AB
    # quantile 1 of the truncated distribution IS the truncation point
    return torch.cat([cut[:-1], t_AB.reshape(1)])


def cutpoints_abc(n_int_ABC: int, coal_ABC, dtype=torch.float64, *,
                  device):
    """Quantiles i/n of a rate-``coal_ABC`` exponential (reference
    cutpoints.py:29-45).  Shape (n_int_ABC + 1,).  The reference's last
    entry is +inf (the unbounded deepest interval); here it is 0.0 — every
    consumer treats the final interval analytically and never reads it."""
    q = torch.arange(n_int_ABC, dtype=dtype, device=device) / n_int_ABC
    cut = -torch.log1p(-q) / torch.as_tensor(coal_ABC, dtype=dtype,
                                             device=device)
    return torch.cat([cut, torch.zeros(1, dtype=dtype, device=device)])
