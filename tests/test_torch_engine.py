"""The port's data path and likelihood engine against the JAX package, on
the CPU: MAF tokens, window packing, simulation, and the total
log-likelihood of ``LoglikEngine`` (rtol 1e-10, both in f64)."""

import os

import jax  # noqa: F401  (both frameworks share the test process)
import numpy as np
import pytest
import torch

from tests.conftest import GOLDENS

torch.set_num_threads(1)

MAF = os.path.join(GOLDENS, "synthetic.maf")
SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]
PARAMS = dict(t_1=2.4e-3, t_2=4e-4, t_upper=7.45069e-3, N_AB=5e-4, N_ABC=5e-4,
              r=1.0)


def _resolved(n_ab, n_abc):
    from itrails_tpu_torch.optim.cases import resolve_times

    return resolve_times(frozenset(["t_1"]),
                         dict(PARAMS, n_int_AB=n_ab, n_int_ABC=n_abc))


def test_maf_tokens_match_jax_package():
    from itrails_tpu.data.maf import _maf_tokens_py
    from itrails_tpu_torch.data.maf import maf_tokens

    mine = maf_tokens(MAF, SPECIES)
    ref = _maf_tokens_py(MAF, SPECIES)
    assert len(mine) == len(ref) > 0
    for x, y in zip(mine, ref):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.int32


def test_maf_tokens_refuse_other_than_four_species():
    from itrails_tpu_torch.data.maf import maf_tokens

    with pytest.raises(ValueError, match="exactly 4 species"):
        maf_tokens(MAF, SPECIES[:3])


def test_tokens_and_windows_match_jax_package():
    from itrails_tpu.data import tokens as jax_tokens
    from itrails_tpu.hmm import windows as jax_windows
    from itrails_tpu_torch.data import tokens
    from itrails_tpu_torch.hmm import windows

    assert tokens.token_strings() == jax_tokens.token_strings()
    np.testing.assert_array_equal(tokens.aggregation_matrix(),
                                  jax_tokens.aggregation_matrix())
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 400_000, size=60).tolist()
    assert (windows.plan_buckets(lengths, 1)
            == jax_windows.plan_buckets(lengths, 1))
    seqs = [rng.integers(0, 625, size=n) for n in (5, 130, 17)]
    for x, y in zip(windows.pack_windows(seqs, pad_length_to=128),
                    jax_windows.pack_windows(seqs, pad_length_to=128)):
        np.testing.assert_array_equal(x, y)


def test_simulated_maf_round_trips_through_the_tokenizer(tmp_path):
    from itrails_tpu_torch.convert import model_from_numpy
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.data.simulate import simulate_token_batch, write_maf
    from tests.conftest import load_golden

    g = load_golden("model_3x3.npz")
    a, b, pi = model_from_numpy(g["a"], g["b"], g["pi"], device="cpu")
    gen = torch.Generator().manual_seed(5)
    tok = simulate_token_batch(a, b, pi, 6, 700, gen, n_frac=0.05, n_run=8)
    again = simulate_token_batch(a, b, pi, 6, 700,
                                 torch.Generator().manual_seed(5),
                                 n_frac=0.05, n_run=8)
    assert torch.equal(tok, again)
    assert tok.shape == (6, 700) and tok.dtype == torch.int32
    assert int(tok.min()) >= 0 and int(tok.max()) < 625
    assert bool((tok >= 256).any())  # the NNNN runs
    blocks = [tok[i].numpy() for i in range(6)]
    write_maf(tmp_path / "sim.maf", blocks, SPECIES)
    back = maf_tokens(tmp_path / "sim.maf", SPECIES)
    assert len(back) == 6
    for x, y in zip(back, blocks):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_ab,n_abc", [(1, 2), (3, 3)])
def test_engine_total_matches_jax_engine(n_ab, n_abc):
    from itrails_tpu.optim.optimizer import LoglikEngine as JaxEngine
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    v_lst = maf_tokens(MAF, SPECIES)
    params = _resolved(n_ab, n_abc)
    mine = LoglikEngine(v_lst, n_ab, n_abc, device="cpu")
    ref = JaxEngine(v_lst, n_ab, n_abc).loglik(params)
    assert mine.n_buckets >= 1 and mine.n_long == 0
    np.testing.assert_allclose(mine.loglik(params), ref, rtol=1e-10)


def test_long_block_runs_as_a_one_window_batch():
    """Blocks above the threshold leave the buckets and still give the
    exact total of the JAX engine (which evaluates them on its
    transfer-operator path)."""
    from itrails_tpu.optim.optimizer import LoglikEngine as JaxEngine
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    v_lst = maf_tokens(MAF, SPECIES)
    rng = np.random.default_rng(4)
    v_lst = v_lst + [rng.integers(0, 625, size=700).astype(np.int32)]
    params = _resolved(1, 2)
    mine = LoglikEngine(v_lst, 1, 2, device="cpu", long_threshold=500)
    assert mine.n_long == 1 and len(mine.batches) == mine.n_buckets + 1
    assert mine.batches[-1].shape == (1, 700)
    ref = JaxEngine(v_lst, 1, 2, long_threshold=500).loglik(params)
    np.testing.assert_allclose(mine.loglik(params), ref, rtol=1e-10)
    whole = LoglikEngine(v_lst, 1, 2, device="cpu")
    np.testing.assert_allclose(mine.loglik(params), whole.loglik(params),
                               rtol=1e-12)


def test_engine_rejects_tokens_outside_the_alphabet():
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    with pytest.raises(ValueError, match="tokens must lie"):
        LoglikEngine([np.array([0, 625], np.int32)], 1, 2, device="cpu")


def _grad_case(tag):
    """(v_lst, n_int_AB, n_int_ABC, variables, x0, fixed): the 1x1 case of
    tests/test_grad.py:75-102 and a 1x2 case on goldens/synthetic.maf."""
    from itrails_tpu_torch.data.maf import maf_tokens

    if tag == "1x1":
        rng = np.random.default_rng(5)
        v_lst = [rng.integers(0, 625, size=150).astype(np.int32)]
        fixed = {"n_int_AB": 1, "n_int_ABC": 1, "t_2": 0.0004,
                 "t_upper": 0.00745069, "N_AB": 0.0005, "r": 1.0}
        x0 = np.array([0.0024, 0.0005])
        return v_lst, 1, 1, ["t_1", "N_ABC"], x0, fixed
    fixed = {"n_int_AB": 1, "n_int_ABC": 2, "t_upper": PARAMS["t_upper"],
             "N_ABC": PARAMS["N_ABC"]}
    names = ["t_1", "t_2", "N_AB", "r"]
    return (maf_tokens(MAF, SPECIES), 1, 2, names,
            np.array([PARAMS[n] for n in names]), fixed)


@pytest.mark.parametrize("tag", ["1x1", "1x2"])
def test_engine_gradient_matches_jax_engine_and_finite_differences(tag):
    """Value rtol 1e-10 and gradient rtol 1e-8 against the JAX engine
    (both f64); the gradient against central differences of the port's
    own loglik at rtol 1e-3, as tests/test_grad.py:102."""
    from itrails_tpu.optim.cases import resolve_times as jax_resolve
    from itrails_tpu.optim.optimizer import LoglikEngine as JaxEngine
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    v_lst, n_ab, n_abc, names, x0, fixed = _grad_case(tag)
    case = frozenset(["t_1"])
    engine = LoglikEngine(v_lst, n_ab, n_abc, device="cpu")
    ll, g = engine.loglik_and_grad_fn(names, fixed, case, resolve_times)(x0)
    ll_ref, g_ref = JaxEngine(v_lst, n_ab, n_abc).loglik_and_grad_fn(
        names, fixed, case, jax_resolve)(x0)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(ll, ll_ref, rtol=1e-10)
    np.testing.assert_allclose(g, g_ref, rtol=1e-8)
    assert set(engine.seconds) == {"build", "decode", "build_backward"}

    def f(x):
        return engine.loglik(resolve_times(case, {**fixed, **dict(zip(names, x))}))

    np.testing.assert_allclose(ll, f(x0), rtol=1e-12)
    for k in range(len(x0)):
        e = np.zeros(len(x0))
        e[k] = x0[k] * 1e-6
        fd = (f(x0 + e) - f(x0 - e)) / (2 * e[k])
        np.testing.assert_allclose(g[k], fd, rtol=1e-3)


def test_long_block_gradient_runs_as_a_one_window_batch():
    """A block above the threshold takes the gradient path as its own
    one-window batch and gives the gradient of the bucketed layout."""
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    rng = np.random.default_rng(4)
    v_lst = maf_tokens(MAF, SPECIES) + [rng.integers(0, 625, size=700)
                                        .astype(np.int32)]
    _, _, _, names, x0, fixed = _grad_case("1x2")
    case = frozenset(["t_1"])
    split = LoglikEngine(v_lst, 1, 2, device="cpu", long_threshold=500)
    assert split.n_long == 1 and split.batches[-1].shape == (1, 700)
    whole = LoglikEngine(v_lst, 1, 2, device="cpu")
    ll, g = split.loglik_and_grad_fn(names, fixed, case, resolve_times)(x0)
    ll_w, g_w = whole.loglik_and_grad_fn(names, fixed, case, resolve_times)(x0)
    np.testing.assert_allclose(ll, ll_w, rtol=1e-12)
    np.testing.assert_allclose(g, g_w, rtol=1e-10)
