"""The port's float64 model builder against the reference goldens and the
JAX package, on the CPU.

Tolerances: the goldens at the JAX tests' own (joint rtol 1e-7, model rtol
1e-6, tests/test_joint.py and tests/test_model.py); the JAX builder at
rtol 1e-9, both in f64 (the differences are summation order, the two
packages' f64 matrix exponentials and transcendentals, and their
amplification by cancellation in the closed-form emission integrals); the
build's VJP against ``jax.vjp`` of the JAX builder at rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden

torch.set_num_threads(1)

PARAMS = dict(t_A=0.0024, t_B=0.0024, t_C=0.0028, t_2=0.0004,
              t_upper=0.00745069, t_out=0.009312, N_AB=0.0005, N_ABC=0.0005,
              r=1.0)
PARAMS2 = dict(t_A=0.002, t_B=0.0031, t_C=0.0041, t_2=0.0007, t_upper=0.005,
               t_out=0.01, N_AB=0.0002, N_ABC=0.0006, r=0.4)
CPU = torch.device("cpu")


def test_host_compilers_match_the_jax_package():
    """statespace/schedule are copies: the same plans, bit for bit."""
    from itrails_tpu.core import schedule as jax_schedule
    from itrails_tpu_torch.core import schedule

    for n_ab, n_abc in ((1, 2), (3, 3), (2, 3)):
        mine = schedule.build_plan(n_ab, n_abc)
        ref = jax_schedule.build_plan(n_ab, n_abc)
        assert mine.hidden_states == ref.hidden_states
        for name in ("ab_masks", "abc_masks", "noabs_masks", "direct_src",
                     "direct_out", "entry_row", "entry_col",
                     "abc_init_from_ab"):
            np.testing.assert_array_equal(getattr(mine, name),
                                          getattr(ref, name))
        assert len(mine.abc_steps) == len(ref.abc_steps)
        for s_mine, s_ref in zip(mine.abc_steps, ref.abc_steps):
            np.testing.assert_array_equal(s_mine.vl_prop, s_ref.vl_prop)
            np.testing.assert_array_equal(s_mine.child, s_ref.child)


def test_cutpoints_match_reference():
    from itrails_tpu_torch.core.cutpoints import cutpoints_ab, cutpoints_abc

    g = load_golden("cutpoints.npz")
    for n in (1, 2, 3, 5):
        np.testing.assert_allclose(cutpoints_ab(n, 0.8, 1.3, device=CPU).numpy(),
                                   g[f"cut_AB_{n}"], rtol=1e-12)
        mine = cutpoints_abc(n, 0.7, device=CPU).numpy()
        np.testing.assert_allclose(mine[:-1], g[f"cut_ABC_{n}"][:-1],
                                   rtol=1e-12)
        assert mine[-1] == 0.0
    for coal, t_ab in ((15.7, 2.43), (50.0, 5.0), (1000.0, 1.0)):
        cut = cutpoints_ab(4, t_ab, coal, device=CPU).numpy()
        assert np.isfinite(cut).all() and cut[0] == 0.0 and cut[-1] == t_ab


def test_expm_matches_reference():
    from itrails_tpu_torch.core.expm import expm_batch

    g = load_golden("expm.npz")
    out = expm_batch(torch.as_tensor(g["mats"])).numpy()
    np.testing.assert_allclose(out, g["exps"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("scale", [1e-3, 1e-1, 1.0, 5.0, 50.0, 300.0])
def test_expm_matches_scipy_across_scales(scale):
    import scipy.linalg

    from itrails_tpu_torch.core.expm import expm_batch

    rng = np.random.default_rng(42)
    a = rng.standard_normal((17, 17)) * scale
    a = a - np.diag(a.sum(axis=1))
    np.testing.assert_allclose(expm_batch(torch.as_tensor(a)).numpy(),
                               scipy.linalg.expm(a), rtol=1e-8, atol=1e-10)


JOINT_CASES = [("1x2", PARAMS, 1, 2), ("2x2", PARAMS, 2, 2),
               ("2x3_p2", PARAMS2, 2, 3), ("3x3", PARAMS, 3, 3)]


@pytest.mark.parametrize("tag,params,n_ab,n_abc", JOINT_CASES)
def test_joint_matches_reference(tag, params, n_ab, n_abc):
    from itrails_tpu_torch.core.ctmc import JointMatrixFn
    from itrails_tpu_torch.core.schedule import build_plan

    g = load_golden(f"joint_{tag}.npz")
    n_ref = params["N_ABC"]
    coal = n_ref / params["N_AB"]
    rho = n_ref * params["r"]
    plan = build_plan(n_ab, n_abc)
    joint = JointMatrixFn(plan, torch.float64, device=CPU)(
        coal_A=coal, coal_B=coal, coal_C=coal, coal_AB=coal, coal_ABC=1.0,
        rho_A=rho, rho_B=rho, rho_C=rho, rho_AB=rho, rho_ABC=rho,
        t_A=params["t_A"] / n_ref, t_B=params["t_B"] / n_ref,
        t_C=params["t_C"] / n_ref, cut_AB=g["cut_ab"],
        cut_ABC=np.concatenate([g["cut_abc"][:-1], [0.0]]),
    ).numpy()
    index = {h: i for i, h in enumerate(plan.hidden_states)}
    ref = np.zeros_like(joint)
    for row, val in zip(g["keys"], g["vals"]):
        ref[index[tuple(row[:3])], index[tuple(row[3:])]] = val
    assert abs(joint.sum() - 1.0) < 1e-9
    np.testing.assert_allclose(joint, ref, rtol=1e-7, atol=1e-14)


@pytest.mark.parametrize("tag,params,n_ab,n_abc",
                         [("1x2", PARAMS, 1, 2), ("3x3", PARAMS, 3, 3),
                          ("2x3_p2", PARAMS2, 2, 3)])
def test_model_matches_reference(tag, params, n_ab, n_abc):
    from itrails_tpu_torch.core.model import build_model

    g = load_golden(f"model_{tag}.npz")
    model = build_model(n_int_AB=n_ab, n_int_ABC=n_abc, device="cpu", **params)
    assert model.hidden_states == [tuple(row) for row in g["hidden"]]
    np.testing.assert_allclose(model.pi.numpy(), g["pi"], rtol=1e-7, atol=1e-13)
    np.testing.assert_allclose(model.a.numpy(), g["a"], rtol=1e-6, atol=1e-13)
    np.testing.assert_allclose(model.b.numpy(), g["b"], rtol=1e-6, atol=1e-13)


@pytest.mark.parametrize("params", [PARAMS, PARAMS2])
def test_model_matches_jax_builder_at_3x3(params):
    from itrails_tpu.core.model import build_model as jax_build_model
    from itrails_tpu_torch.core.model import build_model

    ref = jax_build_model(n_int_AB=3, n_int_ABC=3, dtype=jnp.float64, **params)
    mine = build_model(n_int_AB=3, n_int_ABC=3, device="cpu", **params)
    for name in ("a", "b", "pi", "cut_AB"):
        np.testing.assert_allclose(getattr(mine, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(mine.cut_ABC.numpy()[:-1],
                               np.asarray(ref.cut_ABC)[:-1], rtol=1e-12)


def test_model_invariants():
    from itrails_tpu_torch.core.model import build_model

    model = build_model(n_int_AB=2, n_int_ABC=2, device="cpu", **PARAMS)
    np.testing.assert_allclose(model.a.sum(1).numpy(), 1.0, atol=1e-9)
    np.testing.assert_allclose(float(model.pi.sum()), 1.0, atol=1e-9)
    np.testing.assert_allclose(model.b.sum(1).numpy(), 1.0, atol=1e-8)
    assert bool((model.b >= -1e-15).all())


def test_case_algebra_matches_jax_package():
    from itrails_tpu.optim.cases import ALLOWED_CASES as JAX_CASES
    from itrails_tpu.optim.cases import resolve_times as jax_resolve
    from itrails_tpu_torch.optim.cases import ALLOWED_CASES, resolve_times

    assert ALLOWED_CASES == JAX_CASES
    base = dict(t_1=2.4e-3, t_A=2.4e-3, t_B=2.5e-3, t_C=2.9e-3, t_2=4e-4,
                t_upper=7.4e-3, N_ABC=5e-4, n_int_ABC=3)
    for case in ALLOWED_CASES:
        d = {k: v for k, v in base.items()
             if k not in ("t_1", "t_A", "t_B", "t_C") or k in case}
        assert resolve_times(case, d) == jax_resolve(case, d)


@pytest.mark.parametrize("tag,n", [("4x4", 4), ("7x7", 7)])
def test_large_models_match_reference(tag, n):
    """4x4 (M=46) and the 7x7 flagship (M=133) at the tolerances of
    tests/test_flagship_7x7.py, plus the joint's exchange symmetry."""
    from itrails_tpu_torch.core.model import build_model

    g = load_golden(f"model_{tag}.npz")
    model = build_model(n_int_AB=n, n_int_ABC=n, device="cpu", **PARAMS)
    assert model.hidden_states == [tuple(row) for row in g["hidden"]]
    np.testing.assert_allclose(model.pi.numpy(), g["pi"], rtol=1e-7)
    np.testing.assert_allclose(model.a.numpy(), g["a"], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(model.b.numpy(), g["b"], rtol=1e-5, atol=1e-12)
    joint = model.pi.numpy()[:, None] * model.a.numpy()
    np.testing.assert_allclose(joint, joint.T, rtol=1e-6, atol=1e-14)


@pytest.mark.parametrize("n_ab,n_abc", [(1, 1), (1, 2), (3, 3)])
def test_build_vjp_matches_jax(n_ab, n_abc):
    """The port's autograd VJP of the f64 build against ``jax.vjp`` of the
    JAX builder, for the same random cotangents on (a, b, pi)."""
    from itrails_tpu.core.model import build_model_fn as jax_build_model_fn
    from itrails_tpu_torch.core.model import build_model_fn

    x = torch.tensor(list(PARAMS.values()), dtype=torch.float64,
                     requires_grad=True)
    a, b, pi, _, _ = build_model_fn(n_ab, n_abc, device="cpu")(*x.unbind())
    rng = np.random.default_rng(n_ab * 10 + n_abc)
    cot = [rng.standard_normal(tuple(t.shape)) for t in (a, b, pi)]
    (g,) = torch.autograd.grad((a, b, pi), x, [torch.as_tensor(c) for c in cot])

    jfn = jax_build_model_fn(n_ab, n_abc, "float64", device=None)
    _, vjp = jax.vjp(lambda v: jfn(*(v[i] for i in range(9)))[:3],
                     jnp.asarray(list(PARAMS.values())))
    (g_ref,) = vjp(tuple(jnp.asarray(c) for c in cot))
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-8)
