"""Full HMM model builder: parameters -> (a, b, pi).

The per-evaluation model rebuild of the reference (get_trans_emiss.py:
8-170): normalizes demographic parameters into coalescent units, builds the
joint transition table via the compiled interval-DP plan
(:class:`~itrails_tpu_torch.core.ctmc.JointMatrixFn`), the emission matrix
via batched JC69 tensor contractions
(:class:`~itrails_tpu_torch.core.emissions.EmissionMatrixFn`), and returns
the HMM parameter triple.  It runs in float64 on the device it was made
for; the default is the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from itrails_tpu_torch import resolve_device
from itrails_tpu_torch.core.ctmc import JointMatrixFn
from itrails_tpu_torch.core.cutpoints import cutpoints_ab, cutpoints_abc
from itrails_tpu_torch.core.emissions import EmissionMatrixFn
from itrails_tpu_torch.core.schedule import build_plan

__all__ = ["HmmModel", "build_model", "build_model_fn"]


@dataclass
class HmmModel:
    a: torch.Tensor  # (M, M) row-stochastic transition matrix
    b: torch.Tensor  # (M, 256) emission probabilities over unambiguous 4-mers
    pi: torch.Tensor  # (M,) stationary/initial distribution
    hidden_states: list  # sorted (topology, i, j) tuples
    cut_AB: torch.Tensor
    cut_ABC: torch.Tensor


def build_model_fn(n_int_AB: int, n_int_ABC: int, dtype=torch.float64,
                   device="cuda"):
    """A ``params -> (a, b, pi, cut_AB, cut_ABC)`` builder on ``device``.

    Parameters arrive mu-scaled exactly as in the reference workflows
    (times and Ne multiplied by the mutation rate, r divided by it;
    workflow_optimize.py:387-398), as Python floats or as 0-d float64
    tensors on ``device``; ``fn`` is plain tensor arithmetic, so torch
    autograd differentiates the tables in tensors that require grad.
    Everything that depends only on ``(n_int_AB, n_int_ABC)`` is compiled
    and uploaded once, here."""
    dev = resolve_device(device)
    plan = build_plan(n_int_AB, n_int_ABC)
    joint_fn = JointMatrixFn(plan, dtype, device=dev)
    emission_fn = EmissionMatrixFn(n_int_AB, n_int_ABC, device=dev)

    def fn(t_A, t_B, t_C, t_2, t_upper, t_out, N_AB, N_ABC, r):
        n_ref = N_ABC
        t_a = t_A / n_ref
        t_b = t_B / n_ref
        t_ab = t_2 / n_ref
        t_c = t_C / n_ref
        t_up = t_upper / n_ref
        t_o = t_out / n_ref
        rho = n_ref * r
        coal_ab = n_ref / N_AB
        coal_abc = 1.0
        mu_scale = n_ref * (4.0 / 3.0)

        cut_AB = cutpoints_ab(n_int_AB, t_ab, coal_ab, dtype, device=dev)
        cut_ABC = cutpoints_abc(n_int_ABC, coal_abc, dtype, device=dev)
        joint = joint_fn(
            coal_A=coal_ab, coal_B=coal_ab, coal_C=coal_ab, coal_AB=coal_ab,
            coal_ABC=coal_abc, rho_A=rho, rho_B=rho, rho_C=rho, rho_AB=rho,
            rho_ABC=rho, t_A=t_a, t_B=t_b, t_C=t_c, cut_AB=cut_AB,
            cut_ABC=cut_ABC,
        )
        pi = joint.sum(dim=1)
        a = joint / pi[:, None]
        b = emission_fn(
            t_A=t_a, t_B=t_b, t_C=t_c, t_AB=t_ab, t_upper=t_up, t_out=t_o,
            coal_AB=coal_ab, coal_ABC=coal_abc, mu_A=mu_scale,
            mu_B=mu_scale, mu_C=mu_scale, mu_D=mu_scale, mu_AB=mu_scale,
            mu_ABC=mu_scale, cut_AB=cut_AB, cut_ABC=cut_ABC,
        )
        return a, b, pi, cut_AB, cut_ABC

    return fn


def build_model(t_A, t_B, t_C, t_2, t_upper, t_out, N_AB, N_ABC, r,
                n_int_AB: int, n_int_ABC: int, dtype=torch.float64,
                device="cuda") -> HmmModel:
    """One model build, as an :class:`HmmModel` (the reference's
    trans_emiss_calc signature, get_trans_emiss.py:8-60)."""
    fn = build_model_fn(n_int_AB, n_int_ABC, dtype, device)
    a, b, pi, cut_ab, cut_abc = fn(t_A, t_B, t_C, t_2, t_upper, t_out, N_AB,
                                   N_ABC, r)
    return HmmModel(a=a, b=b, pi=pi,
                    hidden_states=build_plan(n_int_AB, n_int_ABC).hidden_states,
                    cut_AB=cut_ab, cut_ABC=cut_abc)
