"""The port's introgression builder against the reference goldens and the
JAX package, on the CPU: the partial state spaces, ``combine_to_abc``,
``fate_list`` and the introgression plan exactly; the f64 build at the JAX
test's tolerances against ``int_model_{1x2,2x2,3x3}.npz`` (pi rtol 1e-6,
a 1e-5, b 1e-6, atol 1e-12; ``tests/test_introgression.py``) and against
``itrails_tpu.introgression.builder.build_model_introgression`` at rtol
1e-9 (atol 1e-15, as the plain builder's test); the case algebra; and the
deep-epoch stage that the plain and the introgression builders share,
against the JAX package's ``run_abc_stage``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden

torch.set_num_threads(1)

# the goldens' parameters (tests/test_introgression.py)
INT_PARAMS = dict(
    t_A=0.0024, t_B=0.0016, t_C=0.0016, t_2=0.0004, t_upper=0.00745069,
    t_out=0.009312, t_m=0.0008, N_AB=0.0005, N_BC=0.0004, N_ABC=0.0005,
    r=1.0, m=0.1,
)
# the asymmetric set of tests/test_invariants.py:30
ASYM_PARAMS = dict(
    t_A=0.0024, t_B=0.0014, t_C=0.0015, t_2=0.0004, t_upper=0.006,
    t_out=0.0095, t_m=0.001, N_AB=0.0004, N_BC=0.0003, N_ABC=0.0005,
    r=0.9, m=0.25,
)
SIZES = [("1x2", 1, 2), ("2x2", 2, 2), ("3x3", 3, 3)]
A, B, C = 0, 1, 2
# the partial spaces of the four missing-lineage chains
PARTIALS = [((A, B), (A,)), ((A,), (A, B)), ((B, C), (C,)), ((C,), (B, C))]
MIXES = [(("full", (A, B)), ("full", (C,))),
         (("full", (B, C)), ("full", (A,))),
         (("partial", (A, B), (A,)), ("partial", (C,), (B, C))),
         (("partial", (B, C), (C,)), ("partial", (A,), (A, B)))]


def _build(params, n_ab, n_abc):
    from itrails_tpu_torch.introgression.builder import (
        build_model_introgression,
    )

    return build_model_introgression(n_int_AB=n_ab, n_int_ABC=n_abc,
                                     device="cpu", **params)


@pytest.mark.parametrize("left,right", PARTIALS)
def test_partial_spaces_match_the_jax_package(left, right):
    from itrails_tpu.core.statespace import partial_state_space as jax_space
    from itrails_tpu_torch.core.statespace import partial_state_space

    mine, ref = partial_state_space(left, right), jax_space(left, right)
    assert mine.n_states == ref.n_states == 5
    np.testing.assert_array_equal(mine.states, ref.states)
    assert mine.index == ref.index
    np.testing.assert_array_equal(mine.coal_pattern, ref.coal_pattern)
    np.testing.assert_array_equal(mine.rho_pattern, ref.rho_pattern)
    for locus in (0, 1):
        np.testing.assert_array_equal(mine.coalesced_mask(locus),
                                      ref.coalesced_mask(locus))


@pytest.mark.parametrize("layouts", MIXES)
def test_combine_to_abc_matches_the_jax_package(layouts):
    from itrails_tpu.core.statespace import combine_to_abc as jax_combine
    from itrails_tpu_torch.core.statespace import combine_to_abc

    mine = combine_to_abc(*layouts)
    np.testing.assert_array_equal(mine, jax_combine(*layouts))
    # one-hot: every product state lands in exactly one ABC state
    np.testing.assert_array_equal(mine.sum(axis=0), 1.0)


@pytest.mark.parametrize("tag,n_ab,n_abc", SIZES)
def test_fate_list_and_the_int_plan_match_the_jax_package(tag, n_ab, n_abc):
    from itrails_tpu.core import schedule as jax_schedule
    from itrails_tpu_torch.core import schedule

    assert schedule.fate_list(n_ab) == jax_schedule.fate_list(n_ab)
    mine = schedule.build_plan(n_ab, n_abc, introgression=True)
    ref = jax_schedule.build_plan(n_ab, n_abc, introgression=True)
    assert mine.hidden_states == ref.hidden_states
    assert mine.hidden_states == schedule.hidden_state_list(n_ab, n_abc, True)
    # V0 and V4 on (i, j); V1-V3 on i <= j
    assert len(mine.hidden_states) == (2 * n_ab * n_abc
                                       + 3 * n_abc * (n_abc + 1) // 2)
    for name in ("ab_masks", "abc_masks", "noabs_masks", "direct_src",
                 "direct_out", "entry_row", "entry_col", "abc_init_from_ab",
                 "keep_mask"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    assert mine.ab_steps == [] and mine.abc_n_keys == ref.abc_n_keys
    assert len(mine.abc_steps) == len(ref.abc_steps)
    for s_mine, s_ref in zip(mine.abc_steps, ref.abc_steps):
        for name in ("parent", "child", "m_start", "m_end", "vl_prop"):
            np.testing.assert_array_equal(getattr(s_mine, name),
                                          getattr(s_ref, name))
    assert [(g.m, g.src.tolist()) for g in mine.deep_groups] == [
        (g.m, g.src.tolist()) for g in ref.deep_groups]
    # the plain plan is untouched by the flag's default
    plain = schedule.build_plan(n_ab, n_abc)
    assert all(h[0] != 4 for h in plain.hidden_states)
    assert plain.hidden_states == jax_schedule.build_plan(
        n_ab, n_abc).hidden_states


@pytest.mark.parametrize("tag,n_ab,n_abc", SIZES)
def test_int_model_matches_the_reference_goldens(tag, n_ab, n_abc):
    g = load_golden(f"int_model_{tag}.npz")
    model = _build(INT_PARAMS, n_ab, n_abc)
    assert model.hidden_states == [tuple(row) for row in g["hidden"]]
    np.testing.assert_allclose(model.pi.numpy(), g["pi"], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(model.a.numpy(), g["a"], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(model.b.numpy(), g["b"], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("params", [INT_PARAMS, ASYM_PARAMS],
                         ids=["golden", "asymmetric"])
@pytest.mark.parametrize("tag,n_ab,n_abc", SIZES)
def test_int_model_matches_the_jax_builder(tag, n_ab, n_abc, params):
    from itrails_tpu.introgression.builder import (
        build_model_introgression as jax_build,
    )

    ref = jax_build(n_int_AB=n_ab, n_int_ABC=n_abc, dtype=jnp.float64,
                    **params)
    mine = _build(params, n_ab, n_abc)
    assert mine.hidden_states == ref.hidden_states
    for name in ("a", "b", "pi", "cut_AB"):
        np.testing.assert_allclose(getattr(mine, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(mine.cut_ABC.numpy()[:-1],
                               np.asarray(ref.cut_ABC)[:-1], rtol=1e-12)


@pytest.mark.parametrize("m", [0.0, 0.99])
def test_int_model_is_finite_at_the_ends_of_m(m):
    """At m = 0 the missing-lineage chains start with no mass, and the
    reference's cross-normalizers divide by it (NaN there); the port's
    safe divide keeps the joint, pi and b finite, and every table a
    distribution.  At m = 0 no lineage migrates, so the V4 states carry no
    mass and their rows of ``a`` are 0 / 0, as in the JAX builder (the
    optimize configs bound m above 0)."""
    from itrails_tpu.introgression.builder import (
        build_model_introgression as jax_build,
    )

    params = dict(ASYM_PARAMS, m=m)
    model = _build(params, 3, 3)
    pi, a = model.pi.numpy(), model.a.numpy()
    assert np.isfinite(pi).all() and bool(torch.isfinite(model.b).all())
    joint = pi[:, None] * np.where(pi[:, None] > 0, a, 0.0)
    assert np.isfinite(joint).all()
    np.testing.assert_allclose(joint.sum(), 1.0, atol=1e-8)
    live = pi > 0
    dead = [h for h, x in zip(model.hidden_states, live) if not x]
    assert dead == ([h for h in model.hidden_states if h[0] == 4]
                    if m == 0.0 else [])
    np.testing.assert_allclose(a[live].sum(1), 1.0, atol=1e-8)
    np.testing.assert_allclose(model.b.sum(1).numpy(), 1.0, atol=1e-8)
    np.testing.assert_allclose(pi.sum(), 1.0, atol=1e-8)
    ref = jax_build(n_int_AB=3, n_int_ABC=3, **params)
    np.testing.assert_allclose(pi, np.asarray(ref.pi), rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(a, np.asarray(ref.a), rtol=1e-9, atol=1e-15)


def test_int_model_invariants():
    """The joint is exchangeable (pi-weighted a symmetric) and every
    table is a distribution, at the asymmetric parameters."""
    model = _build(ASYM_PARAMS, 3, 2)
    a, b, pi = model.a.numpy(), model.b.numpy(), model.pi.numpy()
    assert len(pi) == 2 * 3 * 2 + 3 * 2 + 3 * 1
    np.testing.assert_allclose(pi.sum(), 1.0, atol=1e-8)
    np.testing.assert_allclose(a.sum(1), 1.0, atol=1e-8)
    np.testing.assert_allclose(b.sum(1), 1.0, atol=1e-7)
    assert (a >= -1e-12).all()
    joint = a * pi[:, None]
    np.testing.assert_allclose(joint, joint.T, rtol=1e-6, atol=1e-14)


def test_int_builder_takes_manual_cutpoints():
    """Manual cutpoints reach both the joint and the emissions, as in the
    JAX builder."""
    from itrails_tpu.introgression.builder import (
        build_model_introgression as jax_build,
    )

    cut_ab, cut_abc = [0.0, 0.3, 0.8], [0.0, 0.5, 1.4]
    ref = jax_build(n_int_AB=2, n_int_ABC=3, cut_AB=cut_ab, cut_ABC=cut_abc,
                    **INT_PARAMS)
    from itrails_tpu_torch.introgression.builder import (
        build_model_introgression,
    )

    mine = build_model_introgression(n_int_AB=2, n_int_ABC=3, device="cpu",
                                     cut_AB=cut_ab, cut_ABC=cut_abc,
                                     **INT_PARAMS)
    for name in ("a", "b", "pi"):
        np.testing.assert_allclose(getattr(mine, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-15)


def test_case_algebra_for_introgression_matches_the_jax_package():
    from itrails_tpu.optim.cases import (
        resolve_times_introgression as jax_resolve,
    )
    from itrails_tpu_torch.optim.cases import (
        ALLOWED_CASES,
        resolve_times_introgression,
    )

    base = dict(t_1=2.4e-3, t_A=2.4e-3, t_B=1.5e-3, t_C=1.7e-3, t_2=4e-4,
                t_m=8e-4, t_upper=7.4e-3, N_ABC=5e-4, n_int_ABC=3)
    for case in ALLOWED_CASES:
        d = {k: v for k, v in base.items()
             if k not in ("t_1", "t_A", "t_B", "t_C") or k in case}
        assert resolve_times_introgression(case, d) == jax_resolve(case, d)
        fixed_out = dict(d, t_out=0.02)
        assert (resolve_times_introgression(case, fixed_out)
                == jax_resolve(case, fixed_out))
    with pytest.raises(ValueError, match="Invalid combination"):
        resolve_times_introgression(frozenset(["t_A"]), base)


@pytest.mark.parametrize("n_ab,n_abc,introgression",
                         [(1, 2, False), (2, 3, False), (2, 3, True)])
def test_abc_stage_matches_the_jax_package(n_ab, n_abc, introgression):
    """The deep epoch and the final interval, factored out of the plain
    builder into ``ctmc.AbcStage`` and shared with the introgression
    builder, against the JAX package's ``run_abc_stage`` on the same
    random initial vectors and rates."""
    from itrails_tpu.core.ctmc import run_abc_stage
    from itrails_tpu.core.schedule import build_plan as jax_plan
    from itrails_tpu_torch.core.ctmc import AbcStage, _rate_matrix
    from itrails_tpu_torch.core.schedule import build_plan
    from itrails_tpu_torch.core.statespace import state_space

    plan = build_plan(n_ab, n_abc, introgression=introgression)
    rng = np.random.default_rng(n_ab * 10 + n_abc)
    pi_abc = rng.random((len(plan.abc_init_from_ab), 203)) / 203
    sp3 = state_space(3)
    q = _rate_matrix(torch.as_tensor(sp3.coal_pattern),
                     torch.as_tensor(sp3.rho_pattern), 1.0, 0.7)
    cut = np.concatenate([-np.log1p(-np.arange(n_abc) / n_abc), [0.0]])
    mine = AbcStage(plan, device="cpu")(torch.as_tensor(pi_abc), q,
                                        torch.as_tensor(cut))
    ref_plan = jax_plan(n_ab, n_abc, introgression=introgression)
    ref = jax.jit(lambda p, q_, c: run_abc_stage(ref_plan, p, q_, c))(
        jnp.asarray(pi_abc), jnp.asarray(q.numpy()), jnp.asarray(cut))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-18)


def test_int_build_differentiates_through_torch_autograd():
    """The build is plain tensor arithmetic: autograd reaches every
    parameter, finite (the exact-gradient optimize path is the next
    slice; this holds that nothing in the build breaks the graph)."""
    from itrails_tpu_torch.introgression.builder import (
        build_model_introgression_fn,
    )

    x = torch.tensor(list(ASYM_PARAMS.values()), dtype=torch.float64,
                     requires_grad=True)
    a, b, pi, _, _ = build_model_introgression_fn(1, 2, device="cpu")(
        *x.unbind())
    (g,) = torch.autograd.grad((a.sum() + b.sum() + pi.sum()), x)
    assert bool(torch.isfinite(g).all())


def test_jax_int_tables_carry_over_through_model_from_numpy():
    """``convert.model_from_numpy`` takes any M and the 256-column ``b``,
    so the JAX package's int tables (M = 36 at 3x3) arrive unchanged and
    equal the port's own build."""
    from itrails_tpu.introgression.builder import (
        build_model_introgression as jax_build,
    )
    from itrails_tpu_torch.convert import model_from_numpy

    ref = jax_build(n_int_AB=3, n_int_ABC=3, **INT_PARAMS)
    a, b, pi = model_from_numpy(np.asarray(ref.a), np.asarray(ref.b),
                                np.asarray(ref.pi), device="cpu")
    assert a.shape == (36, 36) and b.shape == (36, 256) and pi.shape == (36,)
    mine = _build(INT_PARAMS, 3, 3)
    for x, y in ((a, mine.a), (b, mine.b), (pi, mine.pi)):
        assert x.dtype == torch.float64
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-9,
                                   atol=1e-15)
