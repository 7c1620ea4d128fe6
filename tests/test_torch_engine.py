"""The port's data path and likelihood engine against the JAX package, on
the CPU: MAF tokens, window packing, simulation, and the total
log-likelihood of ``LoglikEngine`` (rtol 1e-10, both in f64); on the card,
the engine's f64 value against the CPU's at rtol 1e-12."""

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


def test_long_block_runs_on_the_operator_path(monkeypatch):
    """A block above the threshold leaves the buckets: the value takes it
    through the transfer operators (K5's plain version here) and launches
    no one-window batch for it, and still gives the exact total of the JAX
    engine (which evaluates it on its own operator path) and of the engine
    with no long block."""
    from itrails_tpu.optim.optimizer import LoglikEngine as JaxEngine
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    v_lst = maf_tokens(MAF, SPECIES)
    rng = np.random.default_rng(4)
    v_lst = v_lst + [rng.integers(0, 625, size=700).astype(np.int32)]
    params = _resolved(1, 2)
    mine = LoglikEngine(v_lst, 1, 2, device="cpu", long_threshold=500)
    assert mine.n_long == 1 and len(mine.batches) == mine.n_buckets
    assert mine.long_blocks[0].shape == (700,)
    seen = {"forward": [], "operators": []}
    forward, operators = cuda_fwd.forward_fused, cuda_longseq.chunk_operators_fused

    def spy_forward(a, bfull, pi, tokens):
        seen["forward"].append(tuple(tokens.shape))
        return forward(a, bfull, pi, tokens)

    def spy_operators(a, bfull, stream):
        seen["operators"].append(tuple(stream.shape))
        return operators(a, bfull, stream)

    monkeypatch.setattr(cuda_fwd, "forward_fused", spy_forward)
    monkeypatch.setattr(cuda_longseq, "chunk_operators_fused", spy_operators)
    value = mine.loglik(params)
    assert (1, 700) not in seen["forward"]
    assert len(seen["forward"]) == mine.n_buckets
    assert seen["operators"] == [(1, 1024)]
    ref = JaxEngine(v_lst, 1, 2, long_threshold=500).loglik(params)
    np.testing.assert_allclose(value, ref, rtol=1e-10)
    whole = LoglikEngine(v_lst, 1, 2, device="cpu")
    np.testing.assert_allclose(value, whole.loglik(params), rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_value_is_decoded_in_the_engine_dtype(dtype, monkeypatch):
    """The value path (K1 on the buckets, K5 on a long block) gets the
    tables in the engine's ``dtype``, as it does on the card, where
    float64 is what scipy's finite differences need."""
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    v_lst = maf_tokens(MAF, SPECIES)
    rng = np.random.default_rng(6)
    v_lst = v_lst + [rng.integers(0, 625, size=700).astype(np.int32)]
    engine = LoglikEngine(v_lst, 1, 2, dtype=dtype, device="cpu",
                          long_threshold=500)
    assert engine.dtype == engine.grad_dtype == getattr(torch, dtype)
    seen = []
    forward, operators = cuda_fwd.forward_fused, cuda_longseq.chunk_operators_fused

    def spy_forward(a, bfull, pi, tokens):
        seen.append(("K1", a.dtype, bfull.dtype, pi.dtype))
        return forward(a, bfull, pi, tokens)

    def spy_operators(a, bfull, stream):
        seen.append(("K5", a.dtype, bfull.dtype))
        return operators(a, bfull, stream)

    monkeypatch.setattr(cuda_fwd, "forward_fused", spy_forward)
    monkeypatch.setattr(cuda_longseq, "chunk_operators_fused", spy_operators)
    value = engine.loglik(_resolved(1, 2))
    want = getattr(torch, dtype)
    assert np.isfinite(value)
    assert [x[0] for x in seen] == ["K1"] * engine.n_buckets + ["K5"]
    assert all(d == want for x in seen for d in x[1:])


@pytest.mark.gpu
def test_engine_on_the_card_decodes_the_value_in_f64_and_the_gradient_in_f32():
    """On the card the value path honours ``dtype`` (default float64: K1
    and K5 in f64, within 1e-12 of the CPU engine) and the gradient runs
    K2 in float32."""
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    v_lst = maf_tokens(MAF, SPECIES)
    rng = np.random.default_rng(6)
    v_lst = v_lst + [rng.integers(0, 625, size=3000).astype(np.int32)]
    card = LoglikEngine(v_lst, 1, 2, device="cuda", long_threshold=2000)
    cpu = LoglikEngine(v_lst, 1, 2, device="cpu", long_threshold=2000)
    assert card.dtype == torch.float64 and card.grad_dtype == torch.float32
    k1, k5 = cuda_fwd.forward_fused.launches, cuda_longseq.chunk_operators_fused.launches
    params = _resolved(1, 2)
    np.testing.assert_allclose(card.loglik(params), cpu.loglik(params),
                               rtol=1e-12)
    assert cuda_fwd.forward_fused.launches - k1 == card.n_buckets
    assert cuda_longseq.chunk_operators_fused.launches - k5 == 1
    names = ["t_1", "t_2"]
    fixed = {k: v for k, v in dict(PARAMS, n_int_AB=1, n_int_ABC=2).items()
             if k not in names}
    ll, g = card.loglik_and_grad_fn(names, fixed, frozenset(["t_1"]),
                                    resolve_times)(
        np.array([PARAMS[n] for n in names]))
    np.testing.assert_allclose(ll, cpu.loglik(params), rtol=1e-6)
    assert np.isfinite(g).all()


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


def test_long_block_gradient_runs_through_the_chunk_route(monkeypatch):
    """A block above the threshold leaves the buckets on the gradient path
    too: K5 builds its chunks' operators and one K2 call takes every chunk
    as a window (no one-window batch of it), and the gradient is that of
    the bucketed layout."""
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.hmm import cuda_grad, cuda_longseq, longseq
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    rng = np.random.default_rng(4)
    v_lst = maf_tokens(MAF, SPECIES) + [rng.integers(0, 625, size=700)
                                        .astype(np.int32)]
    _, _, _, names, x0, fixed = _grad_case("1x2")
    case = frozenset(["t_1"])
    split = LoglikEngine(v_lst, 1, 2, device="cpu", long_threshold=500)
    assert split.n_long == 1 and split.long_blocks[0].shape == (700,)
    assert all(tok.shape[1] < 700 for tok in split.batches)
    whole = LoglikEngine(v_lst, 1, 2, device="cpu")
    monkeypatch.setattr(longseq, "ROUTE_CHUNK", 64)
    seen = {"K2": [], "K5": []}
    k2, k5 = cuda_grad.loglik_and_grads_fused, cuda_longseq.chunk_operators_fused

    def spy_k2(a, bfull, pi, tokens, **rows):
        seen["K2"].append((tuple(tokens.shape), sorted(rows)))
        return k2(a, bfull, pi, tokens, **rows)

    def spy_k5(a, bfull, stream):
        seen["K5"].append(tuple(stream.shape))
        return k5(a, bfull, stream)

    monkeypatch.setattr(cuda_grad, "loglik_and_grads_fused", spy_k2)
    monkeypatch.setattr(cuda_longseq, "chunk_operators_fused", spy_k5)
    ll, g = split.loglik_and_grad_fn(names, fixed, case, resolve_times)(x0)
    assert seen["K5"] == [(11, 64)]
    assert seen["K2"] == ([(tuple(tok.shape), []) for tok in split.batches]
                          + [((11, 65), ["entry_alpha", "exit_beta"])])
    ll_w, g_w = whole.loglik_and_grad_fn(names, fixed, case, resolve_times)(x0)
    np.testing.assert_allclose(ll, ll_w, rtol=1e-12)
    np.testing.assert_allclose(g, g_w, rtol=1e-10)


def test_engine_gradient_with_a_long_block_matches_jax_engine(monkeypatch):
    """Value rtol 1e-10 and gradient rtol 1e-8 against the JAX engine with
    the same threshold, which differentiates forward_loglik_long_remat for
    the long block (both f64); the port's route cuts it into 47 chunks."""
    from itrails_tpu.optim.cases import resolve_times as jax_resolve
    from itrails_tpu.optim.optimizer import LoglikEngine as JaxEngine
    from itrails_tpu_torch.hmm import longseq
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    rng = np.random.default_rng(8)
    long_block = rng.integers(0, 625, size=3001).astype(np.int32)
    v_lst, n_ab, n_abc, names, x0, fixed = _grad_case("1x2")
    v_lst = v_lst + [long_block]
    case = frozenset(["t_1"])
    monkeypatch.setattr(longseq, "ROUTE_CHUNK", 64)
    engine = LoglikEngine(v_lst, n_ab, n_abc, device="cpu", long_threshold=500)
    assert engine.n_long == 1
    ll, g = engine.loglik_and_grad_fn(names, fixed, case, resolve_times)(x0)
    ll_ref, g_ref = JaxEngine(v_lst, n_ab, n_abc, long_threshold=500
                              ).loglik_and_grad_fn(names, fixed, case,
                                                   jax_resolve)(x0)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(ll, ll_ref, rtol=1e-10)
    np.testing.assert_allclose(g, g_ref, rtol=1e-8)
