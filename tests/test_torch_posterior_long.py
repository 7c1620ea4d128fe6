"""A long block's posterior by the sequence-parallel route
(``hmm/longseq.py:posterior_long``: K5's operators on ``a`` and on
``a^T``, entry and exit rows, one K4 call over the chunk windows) against
the JAX package's ``longseq.posterior_long`` and the port's one-window
posterior, on the CPU; on the card, the route against its plain version.

Tolerances: in f64 against the JAX function at rtol 5e-6 / atol 1e-9, as
tests/test_longseq.py:49 holds the JAX function against the sequential
posterior, and against the one-window plain posterior
(``cuda_posterior.posterior_fused_plain``) at atol 1e-10 (the same
recursion entered through rows made from products in another order); f32
tables against f64 at 2e-5, as K4 in f32 is held; the route in groups
against one group at 1e-12 (the groups' rows come from products taken in
another order).  On the card, the route against ``posterior_long_plain`` on
the card at 1e-10 in f64 and 2e-5 in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden

torch.set_num_threads(1)

# (T, chunk): two columns, one chunk and a column, an exact multiple of
# the chunk, and several chunks with a PAD tail in the last
CASES = [(2, 16), (17, 16), (1 + 4 * 64, 64), (700, 64)]


def _random_model(m, seed):
    """``(a, bfull, pi)`` in f64 numpy, ``a`` far from symmetric."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, m)) ** 3 + np.eye(m)
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    return a, bfull, pi


def _golden_model(tag):
    from itrails_tpu_torch.data.tokens import aggregation_matrix

    g = load_golden(f"model_{tag}.npz")
    return g["a"], g["b"] @ aggregation_matrix().T, g["pi"]


def _model(name):
    return _random_model(3, seed=1) if name == "M3" else _golden_model(name)


def _block(t_len, seed, pad=True):
    """``t_len`` uniform tokens (ambiguity codes >= 256 among them), with a
    PAD run and a PAD tail where the block is long enough."""
    tok = np.random.default_rng(seed).integers(0, 625, size=t_len)
    if pad and t_len > 100:
        tok[t_len // 3:t_len // 3 + 40] = -1
        tok[-9:] = -1
    return tok.astype(np.int32)


def _torch(tables, dtype=torch.float64):
    return [torch.as_tensor(np.asarray(x), dtype=dtype) for x in tables]


def _one_window(tables, tok):
    from itrails_tpu_torch.hmm import cuda_posterior

    post, _ = cuda_posterior.posterior_fused_plain(*tables, torch.as_tensor(tok)[None])
    return post[:, 0, :].numpy()


@pytest.mark.parametrize("name", ["M3", "3x3"])
@pytest.mark.parametrize("t_len,chunk", CASES)
def test_route_matches_jax_posterior_long(name, t_len, chunk):
    from itrails_tpu.hmm.longseq import posterior_long as jax_posterior_long
    from itrails_tpu_torch.hmm import longseq

    tables = _model(name)
    tok = _block(t_len, seed=t_len)
    assert (tok >= 256).any() or t_len < 100
    got = longseq.posterior_long(*_torch(tables), torch.as_tensor(tok),
                                 chunk=chunk)
    ref = np.asarray(jax_posterior_long(*(jnp.asarray(x) for x in tables),
                                        jnp.asarray(tok), chunk=chunk))
    assert got.dtype == torch.float64 and tuple(got.shape) == (t_len, len(tables[2]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["M3", "3x3"])
@pytest.mark.parametrize("t_len,chunk", CASES + [(3001, 128), (700, 700)])
def test_route_matches_the_one_window_posterior(name, t_len, chunk):
    """Every column, PAD columns included, of the route and of K4's plain
    version walking the block as one window."""
    from itrails_tpu_torch.hmm import longseq

    tables = _torch(_model(name))
    tok = _block(t_len, seed=t_len + 1)
    got = longseq.posterior_long(*tables, torch.as_tensor(tok), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _one_window(tables, tok), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("t_len", [1, 2, 300])
def test_a_pad_first_column_follows_the_ports_pad_rule(t_len):
    """A block that starts with PAD enters as pi (PAD's emission row is
    ones), as the one-window posterior does; one column is K4's own."""
    from itrails_tpu_torch.hmm import longseq

    tables = _torch(_model("3x3"))
    tok = _block(t_len, seed=5)
    tok[0] = -1
    got = longseq.posterior_long(*tables, torch.as_tensor(tok), chunk=32)
    np.testing.assert_allclose(got.numpy(), _one_window(tables, tok), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("name", ["M3", "3x3"])
def test_f32_tables_stay_within_k4s_tolerance(name):
    from itrails_tpu_torch.hmm import longseq

    tables = _model(name)
    tok = torch.as_tensor(_block(3001, seed=7))
    got = longseq.posterior_long(*_torch(tables, torch.float32), tok, chunk=64)
    ref = longseq.posterior_long(*_torch(tables), tok, chunk=64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("rate", [1.0, 0.1, 0.01])
def test_f32_route_on_long_runs_errs_no_more_than_the_jax_route(rate):
    """65,536 columns simulated from the 3x3 model with its recombination
    rate scaled by ``rate`` (one state's runs of ~630, ~6,300 and ~63,000
    columns), both routes on the same float32 tables: the port's
    ``posterior_long`` and the JAX ``longseq.posterior_long``, the route the
    JAX posterior CLI takes at ``--precision float32``.  Each is held
    against the JAX route in f64 on the same tables upcast; the port's
    error must be no larger than the JAX package's."""
    from itrails_tpu.hmm.longseq import posterior_long as jax_posterior_long
    from itrails_tpu_torch.core.model import build_model_fn
    from itrails_tpu_torch.data.simulate import simulate_token_batch
    from itrails_tpu_torch.data.tokens import aggregation_matrix
    from itrails_tpu_torch.hmm import decoders, longseq
    from itrails_tpu_torch.optim.cases import resolve_times

    d = resolve_times(frozenset(["t_1"]), dict(
        t_1=2.4e-3, t_2=4e-4, t_upper=7.450693855e-3, N_AB=5e-4, N_ABC=5e-4,
        r=rate, n_int_AB=3, n_int_ABC=3))
    a, b, pi, _, _ = build_model_fn(3, 3, device="cpu")(
        d["t_A"], d["t_B"], d["t_C"], d["t_2"], d["t_upper"], d["t_out"],
        d["N_AB"], d["N_ABC"], d["r"])
    bfull = decoders.emission_table(b, aggregation_matrix())
    tok = simulate_token_batch(a, b, pi, 1, 65_536,
                               torch.Generator().manual_seed(21)).reshape(-1)
    f32 = [x.float().contiguous() for x in (a, bfull, pi)]
    ref = np.asarray(jax_posterior_long(
        *(jnp.asarray(x.double().numpy()) for x in f32), jnp.asarray(tok.numpy())))
    jax32 = np.asarray(jax_posterior_long(
        *(jnp.asarray(x.numpy()) for x in f32), jnp.asarray(tok.numpy())))
    port32 = longseq.posterior_long(*f32, tok).double().numpy()
    err_jax = np.abs(jax32 - ref).max()
    err_port = np.abs(port32 - ref).max()
    print(f"rate x{rate:g}: port {err_port:.3g}, JAX route {err_jax:.3g}")
    assert jax32.dtype == np.float32 and err_jax > 0
    assert err_port <= err_jax, (err_port, err_jax)


def test_exit_rows_of_a_transposed_are_the_posteriors_beta():
    """With an ``a`` far from symmetric: entry rows of the operators of
    ``a`` are alpha at each chunk's entry, exit rows of the operators of
    ``a^T`` beta at each chunk's exit, both against the columns' products
    written out one by one in each direction; exit rows of the operators of
    ``a`` (the gradient's textbook beta) are not the posterior's."""
    from itrails_tpu_torch.hmm import cuda_fwd, longseq

    chunk, n_chunks = 8, 6
    a, bfull, pi = _torch(_random_model(5, seed=3))
    tok = torch.as_tensor(_block(1 + chunk * n_chunks, seed=4, pad=False))
    stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
    g_ops, _ = longseq.chunk_operators(a, bfull, stream.reshape(-1), chunk)
    k_ops, _ = longseq.chunk_operators(a.T.contiguous(), bfull,
                                       stream.reshape(-1), chunk)
    e = cuda_fwd.emission_rows(bfull.T, tok)  # (T, M)
    alpha0 = pi * e[0]
    entry = longseq.entry_rows(g_ops, alpha0)
    exit_ = longseq.exit_rows(k_ops, torch.ones(5, dtype=torch.float64))
    textbook = longseq.exit_rows(g_ops, torch.ones(5, dtype=torch.float64))
    for c in range(n_chunks):
        want = alpha0
        for t in range(1, 1 + c * chunk):  # alpha' = (alpha a) * e_t
            want = (want @ a) * e[t]
        np.testing.assert_allclose(entry[c].numpy(), (want / want.sum()).numpy(),
                                   rtol=1e-12)
        want = torch.ones(5, dtype=torch.float64)
        for t in range(len(tok) - 1, (c + 1) * chunk, -1):  # a^T (e_t * beta)
            want = a.T @ (e[t] * want)
        np.testing.assert_allclose(exit_[c].numpy(), (want / want.sum()).numpy(),
                                   rtol=1e-12)
    assert float((textbook[:-1] - exit_[:-1]).abs().max()) > 1e-3


def test_groups_under_lowered_budgets_equal_one_group(monkeypatch):
    """Under a budget of three chunks' operators, then of two chunks'
    stores, a first pass keeps each group's products in both directions,
    and each group's operators are built again for its rows and its own K4
    call; the rows are one group's, one piece a group."""
    from itrails_tpu_torch.hmm import cuda_posterior, longseq

    tables = _torch(_model("3x3"))
    tok = torch.as_tensor(_block(1 + 11 * 32 - 5, seed=8))
    whole = longseq.posterior_long(*tables, tok, chunk=32)
    m = 27
    k5, k4 = longseq.cuda_longseq.chunk_operators_fused, cuda_posterior.posterior_fused
    for budgets, sizes in (
            ((3 * 2 * m * m * 16, None), [3, 3, 3, 2]),
            ((None, 2 * 33 * m * 8), [2, 2, 2, 2, 2, 1])):
        calls = {"K5": [], "K4": []}

        def spy_k5(a, bfull, stream):
            calls["K5"].append((stream.shape[0], bool(torch.equal(a, tables[0]))))
            return k5(a, bfull, stream)

        def spy_k4(a, bfull, pi, tokens, **rows):
            calls["K4"].append(tuple(tokens.shape))
            return k4(a, bfull, pi, tokens, **rows)

        with monkeypatch.context() as patch:
            ops_budget, store_budget = budgets
            if ops_budget is not None:
                patch.setattr(longseq, "OPERATOR_BUDGET_BYTES", ops_budget)
            if store_budget is not None:
                patch.setattr(cuda_posterior, "POSTERIOR_BUDGET_BYTES", store_budget)
            patch.setattr(longseq.cuda_longseq, "chunk_operators_fused", spy_k5)
            patch.setattr(cuda_posterior, "posterior_fused", spy_k4)
            pieces = list(longseq.posterior_long_pieces(*tables, tok, chunk=32))
        g = len(sizes)
        assert calls["K4"] == [(n, 33) for n in sizes]
        assert [n for n, _ in calls["K5"]] == (
            sizes[:-1] + sizes[:0:-1] + [x for n in sizes for x in (n, n)])
        assert [fwd for _, fwd in calls["K5"]] == (
            [True] * (g - 1) + [False] * (g - 1) + [True, False] * g)
        assert [len(p) for p in pieces] == (
            [1 + 32 * sizes[0]] + [32 * n for n in sizes[1:-1]]
            + [len(tok) - 1 - 32 * sum(sizes[:-1])])
        np.testing.assert_allclose(torch.cat(pieces).numpy(), whole.numpy(),
                                   rtol=0, atol=1e-12)


def test_cpu_route_runs_the_plain_versions_and_counts_no_launch():
    from itrails_tpu_torch.hmm import cuda_longseq, cuda_posterior, longseq

    tables = _torch(_model("M3"))
    tok = torch.as_tensor(_block(300, seed=9))
    k4 = (cuda_posterior.posterior_fused.calls, cuda_posterior.posterior_fused.launches)
    k5 = cuda_longseq.chunk_operators_fused.launches
    got = longseq.posterior_long(*tables, tok, chunk=32)
    ref = longseq.posterior_long_plain(*tables, tok, chunk=32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-13)
    assert (cuda_posterior.posterior_fused.calls,
            cuda_posterior.posterior_fused.launches) == k4
    assert cuda_longseq.chunk_operators_fused.launches == k5


def test_run_posterior_sends_long_blocks_through_the_route(monkeypatch):
    """The posterior CLI's decode with the long-block threshold lowered and
    the store budget at three chunk windows: the short blocks in window
    groups, each long block in pieces of three chunks through the route, in
    block and column order, every block's rows within 1e-10 of the
    one-window plain rows."""
    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.hmm import cuda_posterior, longseq

    tables = _torch(_model("3x3"))
    v_lst = [_block(n, seed=n) for n in (40, 700, 1301, 90, 95, 2)]
    monkeypatch.setattr(decode, "LONG_BLOCK_THRESHOLD", 100)
    monkeypatch.setattr(longseq, "ROUTE_CHUNK", 64)
    monkeypatch.setattr(cuda_posterior, "POSTERIOR_BUDGET_BYTES", 3 * 65 * 27 * 8)
    route = []
    pieces_of = longseq.posterior_long_pieces

    def spy(a, bfull, pi, tokens):
        route.append(len(tokens))
        return pieces_of(a, bfull, pi, tokens)

    monkeypatch.setattr(longseq, "posterior_long_pieces", spy)
    pieces = list(decode.run_posterior(*tables, v_lst))
    assert route == [700, 1301]
    # 699 columns after column 0: 11 chunks of 64, 4 groups; 1300: 21, 7
    assert [i for i, _ in pieces] == [0] + [1] * 4 + [2] * 7 + [3, 4, 5]
    for i, v in enumerate(v_lst):
        rows = np.concatenate([r for j, r in pieces if j == i])
        assert rows.dtype == np.float64 and rows.shape == (len(v), 27)
        np.testing.assert_allclose(rows, _one_window(tables, v), rtol=0,
                                   atol=1e-10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,t_len,chunk", [(27, 50_001, 512), (27, 20_000, 256),
                                           (133, 20_001, 512)])
@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)])
def test_route_on_the_card_matches_the_plain_route(cuda_device, m, t_len, chunk,
                                                   dtype, atol):
    from itrails_tpu_torch.hmm import cuda_longseq, cuda_posterior, longseq

    tables = [x.to(cuda_device) for x in _torch(_random_model(m, seed=m))]
    tok = torch.as_tensor(_block(t_len, seed=m + chunk), device=cuda_device)
    k4 = (cuda_posterior.posterior_fused.calls, cuda_posterior.posterior_fused.launches)
    k5 = cuda_longseq.chunk_operators_fused.launches
    got = longseq.posterior_long(*(x.to(dtype).contiguous() for x in tables), tok,
                                 chunk=chunk)
    torch.cuda.synchronize()
    assert (cuda_posterior.posterior_fused.calls - k4[0],
            cuda_posterior.posterior_fused.launches - k4[1]) == (1, 2)
    assert cuda_longseq.chunk_operators_fused.launches == k5 + 2
    ref = longseq.posterior_long_plain(*tables, tok, chunk=chunk)
    assert got.dtype == dtype and got.shape == ref.shape == (t_len, m)
    assert float((got.double() - ref).abs().max()) <= atol


@pytest.mark.gpu
def test_route_on_the_card_launches_k5_twice_a_group(cuda_device, monkeypatch):
    """Four groups: K5 twice a group for the rows, and once a direction for
    each group's product in the first pass; K4 once a group."""
    from itrails_tpu_torch.hmm import cuda_longseq, cuda_posterior, longseq

    tables = [x.to(cuda_device) for x in _torch(_model("3x3"))]
    tok = torch.as_tensor(_block(1 + 40 * 256, seed=10), device=cuda_device)
    one = longseq.posterior_long(*tables, tok, chunk=256)
    monkeypatch.setattr(cuda_posterior, "POSTERIOR_BUDGET_BYTES", 10 * 257 * 32 * 8)
    k4 = cuda_posterior.posterior_fused.calls
    k5 = cuda_longseq.chunk_operators_fused.launches
    grouped = longseq.posterior_long(*tables, tok, chunk=256)
    torch.cuda.synchronize()
    assert cuda_posterior.posterior_fused.calls == k4 + 4
    assert cuda_longseq.chunk_operators_fused.launches == k5 + 2 * 4 + 2 * 3
    assert float((grouped - one).abs().max()) <= 1e-12


@pytest.mark.gpu
def test_route_raises_on_inputs_the_kernels_do_not_take(cuda_device):
    from itrails_tpu_torch.hmm import cuda_longseq, cuda_posterior, longseq

    a, bfull, pi = (x.to(cuda_device) for x in _torch(_model("3x3")))
    tok = torch.as_tensor(_block(2000, seed=11), device=cuda_device)
    k4 = cuda_posterior.posterior_fused.launches
    k5 = cuda_longseq.chunk_operators_fused.launches
    with pytest.raises(ValueError, match="int32"):
        longseq.posterior_long(a, bfull, pi, tok.long(), chunk=64)
    with pytest.raises(ValueError, match="float64"):
        longseq.posterior_long(a, bfull.float(), pi, tok, chunk=64)
    with pytest.raises(ValueError, match="float32 or float64"):
        longseq.posterior_long(a.half(), bfull.half(), pi.half(), tok, chunk=64)
    assert cuda_posterior.posterior_fused.launches == k4
    assert cuda_longseq.chunk_operators_fused.launches == k5
