"""Introgression HMM model builder: parameters -> (a, b, pi) (the JAX
package's ``itrails_tpu/introgression/builder.py``; reference
trans_emiss_calc_introgression, int_get_trans_emiss.py:9-185).

It runs in float64 on the device it was made for, as the plain builder
(``core/model.py``) does; the default is the card.
"""

from __future__ import annotations

import torch

from itrails_tpu_torch import resolve_device
from itrails_tpu_torch.core.cutpoints import cutpoints_ab, cutpoints_abc
from itrails_tpu_torch.core.emissions import IntrogressionEmissionFn
from itrails_tpu_torch.core.model import HmmModel
from itrails_tpu_torch.core.schedule import build_plan
from itrails_tpu_torch.introgression.model import IntJointMatrixFn

__all__ = ["build_model_introgression", "build_model_introgression_fn"]


def build_model_introgression_fn(n_int_AB: int, n_int_ABC: int,
                                 dtype=torch.float64, device="cuda"):
    """A ``params -> (a, b, pi, cut_AB, cut_ABC)`` builder of the
    introgression model on ``device``, taking ``t_A, t_B, t_C, t_2,
    t_upper, t_out, t_m, N_AB, N_BC, N_ABC, r, m`` (and optionally manual
    ``cut_AB`` / ``cut_ABC``), as :func:`itrails_tpu_torch.core.model.
    build_model_fn` takes the plain model's.

    Times and population sizes arrive mu-scaled, ``r`` divided by mu, as in
    the reference workflows; ``t_B`` and ``t_C`` run from the present to
    the migration event (int_get_trans_emiss.py:72-101).  ``m``, the
    admixture proportion, is dimensionless and is not mu-scaled (the JAX
    package's deliberate deviation from the reference,
    ``itrails_tpu/cli/common.py:249-252``).  ``fn`` is plain tensor
    arithmetic on Python floats or 0-d float64 tensors on ``device``."""
    dev = resolve_device(device)
    plan = build_plan(n_int_AB, n_int_ABC, introgression=True)
    joint_fn = IntJointMatrixFn(plan, dtype, device=dev)
    emission_fn = IntrogressionEmissionFn(n_int_AB, n_int_ABC, device=dev)

    def fn(t_A, t_B, t_C, t_2, t_upper, t_out, t_m, N_AB, N_BC, N_ABC, r, m,
           cut_AB=None, cut_ABC=None):
        n_ref = N_ABC
        t_a = t_A / n_ref
        t_b = t_B / n_ref
        t_ab = t_2 / n_ref
        t_c = t_C / n_ref
        t_mm = t_m / n_ref
        t_up = t_upper / n_ref
        t_o = t_out / n_ref
        rho = n_ref * r
        coal_ab = n_ref / N_AB
        coal_bc = n_ref / N_BC
        mu_scale = n_ref * (4.0 / 3.0)

        if cut_AB is None:
            cut_AB = cutpoints_ab(n_int_AB, t_ab, coal_ab, dtype, device=dev)
        if cut_ABC is None:
            cut_ABC = cutpoints_abc(n_int_ABC, 1.0, dtype, device=dev)
        joint = joint_fn(
            t_A=t_a, t_B=t_b, t_C=t_c, t_AB=t_ab, t_m=t_mm,
            coal_A=coal_ab, coal_B=coal_ab, coal_C=coal_bc,
            coal_AB=coal_ab, coal_BC=coal_bc, coal_ABC=1.0,
            rho=rho, m=m, cut_AB=cut_AB, cut_ABC=cut_ABC,
        )
        pi = joint.sum(dim=1)
        a = joint / pi[:, None]
        b = emission_fn(
            t_A=t_a, t_B=t_b, t_C=t_c, t_AB=t_ab, t_m=t_mm, t_upper=t_up,
            t_out=t_o, coal_AB=coal_ab, coal_BC=coal_bc, coal_ABC=1.0,
            mu=mu_scale, cut_AB=cut_AB, cut_ABC=cut_ABC,
        )
        return a, b, pi, cut_AB, cut_ABC

    return fn


def build_model_introgression(t_A, t_B, t_C, t_2, t_upper, t_out, t_m, N_AB,
                              N_BC, N_ABC, r, m, n_int_AB: int,
                              n_int_ABC: int, dtype=torch.float64,
                              device="cuda", cut_AB=None,
                              cut_ABC=None) -> HmmModel:
    """One introgression model build, as an :class:`HmmModel` (the
    reference's trans_emiss_calc_introgression signature).  ``cut_AB`` /
    ``cut_ABC`` optionally override the standard quantile cutpoints, as in
    :func:`itrails_tpu_torch.core.model.build_model`."""
    dev = resolve_device(device)
    fn = build_model_introgression_fn(n_int_AB, n_int_ABC, dtype, dev)
    cuts = {}
    if cut_AB is not None:
        cuts["cut_AB"] = torch.as_tensor(cut_AB, dtype=dtype, device=dev)
    if cut_ABC is not None:
        cut = torch.as_tensor(cut_ABC, dtype=dtype, device=dev)
        cuts["cut_ABC"] = torch.cat([cut[:n_int_ABC],
                                     torch.zeros(1, dtype=dtype, device=dev)])
    a, b, pi, cut_ab, cut_abc = fn(t_A, t_B, t_C, t_2, t_upper, t_out, t_m,
                                   N_AB, N_BC, N_ABC, r, m, **cuts)
    plan = build_plan(n_int_AB, n_int_ABC, introgression=True)
    return HmmModel(a=a, b=b, pi=pi, hidden_states=plan.hidden_states,
                    cut_AB=cut_ab, cut_ABC=cut_abc)
