"""The port's long-block value path and gradient route against the JAX
package, on the CPU; kernel K5 and the gradient route against their plain
versions on the card.

Tolerances: the contract ``chunk_operators`` against the JAX
``longseq.chunk_operators`` in f64 at rtol 1e-12 (the same operations in
the same order), and K5's plain version ``chunk_rows`` folded
(``fold_rows``) against it at atol 1e-12 on the operators (max entry 1) and
rtol 1e-12 on the log scales (power-of-two scales are exact; the rounding
is the products' and the fold's); in f32 both against the Pallas kernel
``tools/exp_opkernel.chunk_operators_fused(..., interpret=True)``, after
folding each to one max-normalized operator and one log scale per chunk,
at atol 5e-5 and rtol 1e-6 (the Pallas kernel reads its emissions from a
split-bf16 table and rescales rows every four columns).
``forward_loglik_long`` against the JAX function and the sequential forward
in f64 at rtol 1e-9, as tests/test_longseq.py holds the JAX function.  On
the card, K5 against the contract in f64 at atol 5e-5 on the operators and
rtol 1e-6 on the log scales (f32 products over one chunk), and K5 on f64
tables at atol 1e-10 and rtol 1e-12; K5's rows against ``chunk_rows`` in
f64 at the same gates, each row brought to the reference's exponent sum.

The gradient route ``forward_loglik_long_and_grads`` in f64 against
``jax.value_and_grad(forward_loglik_long_remat)``: loglik rtol 1e-10, every
gradient entry rtol 1e-8 (no absolute slack: a token absent from the block
has an exact 0 on both sides); against the port's one-window walk
(``loglik_and_grads_plain``) at rtol 1e-10 on every entry (both sum
non-negative terms, in another order).  On the card, the route in f32
against its plain version in f64: loglik rtol 1e-6, every gradient entry
rtol 2e-3 (f32 normalizers over a chunk, f32 operators).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden

torch.set_num_threads(1)

# (T, chunk) cases of tests/test_longseq.py
LONG_CASES = [(1000, 64), (513, 128), (64, 256), (2, 16), (257, 256)]


def _tables(tag, dtype=torch.float64):
    """(a, bfull, pi) of a golden model, numpy f64 and torch ``dtype``."""
    from itrails_tpu_torch.data.tokens import aggregation_matrix

    g = load_golden(f"model_{tag}.npz")
    bfull = g["b"] @ aggregation_matrix().T
    np_tables = (g["a"], bfull, g["pi"])
    return np_tables, [torch.as_tensor(x, dtype=dtype) for x in np_tables]


def _stream(c, length, seed):
    """(C, L) uniform tokens with a PAD run, an all-PAD chunk and a PAD
    tail."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 625, size=(c, length)).astype(np.int32)
    tok[0, 3:11] = -1
    tok[2] = -1
    tok[-1, length // 2:] = -1
    return tok


def _fold_rows(ops, logz):
    """Per chunk, operators with per-row log scales (C, M) folded into one
    max-normalized operator and one log scale (numpy f64)."""
    ops, logz = np.asarray(ops, np.float64), np.asarray(logz, np.float64)
    top = logz.max(axis=1)
    g = ops * np.exp(logz - top[:, None])[:, :, None]
    z = g.max(axis=(1, 2))
    return g / z[:, None, None], top + np.log(z)


@pytest.mark.parametrize("tag", ["1x2", "3x3"])
def test_chunk_operators_match_jax_in_f64(tag):
    from itrails_tpu.hmm import longseq as jax_longseq
    from itrails_tpu_torch.hmm import longseq

    (a, bfull, _), (ta, tb, _) = _tables(tag)
    tok = _stream(6, 40, seed=3)
    ops, logz = longseq.chunk_operators(ta, tb, torch.as_tensor(tok.reshape(-1)),
                                        40)
    ops_ref, logz_ref = jax_longseq.chunk_operators(
        jnp.asarray(a), jnp.asarray(bfull), jnp.asarray(tok.reshape(-1)), 40)
    assert ops.dtype == torch.float64 and logz.dtype == torch.float64
    np.testing.assert_allclose(ops.numpy(), np.asarray(ops_ref), rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_ref), rtol=1e-12)
    # the all-PAD chunk is the identity with no scale
    np.testing.assert_array_equal(ops[2].numpy(), np.eye(a.shape[0]))
    assert float(logz[2]) == 0.0


def test_chunk_operators_match_the_pallas_kernel_in_f32():
    from itrails_tpu_torch.hmm import longseq
    from tools.exp_opkernel import chunk_operators_fused as pallas_operators

    (a, bfull, _), (ta, tb, _) = _tables("3x3", torch.float32)
    tok = _stream(8, 64, seed=4)
    ops, logz = longseq.chunk_operators(ta, tb, torch.as_tensor(tok.reshape(-1)),
                                        64)
    p_ops, p_logz = pallas_operators(
        jnp.asarray(a, jnp.float32), jnp.asarray(bfull, jnp.float32),
        jnp.asarray(tok), chunk=64, cb=8, interpret=True)
    want_ops, want_logz = _fold_rows(p_ops, p_logz)
    got_ops, got_logz = _fold_rows(ops.numpy(), logz.numpy()[:, None])
    np.testing.assert_allclose(got_ops, want_ops, atol=5e-5)
    np.testing.assert_allclose(got_logz, want_logz, rtol=1e-6)


@pytest.mark.parametrize("tag", ["1x2", "3x3"])
def test_chunk_rows_folded_match_jax_in_f64(tag):
    """K5's plain version, its rows folded, against the JAX contract; the
    all-PAD chunk is exactly the identity with log scale 0."""
    from itrails_tpu.hmm import longseq as jax_longseq
    from itrails_tpu_torch.hmm import cuda_longseq

    (a, bfull, _), (ta, tb, _) = _tables(tag)
    tok = _stream(6, 40, seed=3)
    x, k = cuda_longseq.chunk_rows(ta, tb, torch.as_tensor(tok.reshape(-1)), 40)
    ops, logz = cuda_longseq.fold_rows(x, k)
    ops_ref, logz_ref = jax_longseq.chunk_operators(
        jnp.asarray(a), jnp.asarray(bfull), jnp.asarray(tok.reshape(-1)), 40)
    assert ops.dtype == torch.float64 and logz.dtype == torch.float64
    np.testing.assert_allclose(ops.numpy(), np.asarray(ops_ref), atol=1e-12)
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_ref), rtol=1e-12)
    assert torch.equal(ops[2], torch.eye(a.shape[0], dtype=torch.float64))
    assert float(logz[2]) == 0.0


def test_chunk_rows_match_the_pallas_kernel_in_f32():
    """K5's plain version's rows, each with its log scale ln2 k, folded as
    the Pallas kernel's per-row form is folded."""
    from itrails_tpu_torch.hmm import cuda_longseq
    from tools.exp_opkernel import chunk_operators_fused as pallas_operators

    (a, bfull, _), (ta, tb, _) = _tables("3x3", torch.float32)
    tok = _stream(8, 64, seed=4)
    x, k = cuda_longseq.chunk_rows(ta, tb, torch.as_tensor(tok.reshape(-1)), 64)
    p_ops, p_logz = pallas_operators(
        jnp.asarray(a, jnp.float32), jnp.asarray(bfull, jnp.float32),
        jnp.asarray(tok), chunk=64, cb=8, interpret=True)
    want_ops, want_logz = _fold_rows(p_ops, p_logz)
    got_ops, got_logz = _fold_rows(x.numpy(), k.numpy() * np.log(2.0))
    np.testing.assert_allclose(got_ops, want_ops, atol=5e-5)
    np.testing.assert_allclose(got_logz, want_logz, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_an_all_pad_chunk_folds_to_the_identity(dtype):
    """Rows of PAD columns stay the unit vectors with exponent sum 0, and
    fold to exactly I with log scale 0, beside chunks that do move."""
    from itrails_tpu_torch.hmm import cuda_longseq

    _, (a, bfull, _) = _tables("3x3", dtype)
    m = a.shape[0]
    tok = _stream(4, 16, seed=10)  # chunk 2 is all PAD too
    tok[1] = -1
    x, k = cuda_longseq.chunk_rows(a, bfull, torch.as_tensor(tok.reshape(-1)), 16)
    assert torch.equal(x[1], torch.eye(m, dtype=dtype))
    assert torch.equal(k[1], torch.zeros(m, dtype=torch.int32))
    ops, logz = cuda_longseq.chunk_operators_fused(a, bfull, torch.as_tensor(tok))
    assert torch.equal(ops[1], torch.eye(m, dtype=dtype)) and float(logz[1]) == 0.0
    assert float(logz[0]) < 0.0 and float(logz[3]) < 0.0


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_a_row_far_below_the_max_row_folds_as_the_contract(dtype, rtol):
    """State 0 keeps to itself with emission 1e-3 a column, so after ten
    columns row 0 of the operator lies ~1e-28 below the max: its own
    scale keeps its rows, and the fold gives the contract's entry (rtol
    1e-12 in f64; 1e-5 in f32, ten f32 products and the fold's rounding)."""
    from itrails_tpu_torch.hmm import cuda_longseq

    m = 6
    rng = np.random.default_rng(11)
    a = np.zeros((m, m))
    a[0, 0] = 1.0
    rest = rng.random((m - 1, m - 1)) + np.eye(m - 1)
    a[1:, 1:] = rest / rest.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.5 + 0.5
    bfull[0] = 1e-3
    ta, tb = (torch.as_tensor(v, dtype=dtype) for v in (a, bfull))
    tok = torch.as_tensor(rng.integers(0, 625, size=(2, 10)).astype(np.int32))
    x, k = cuda_longseq.chunk_rows(ta, tb, tok.reshape(-1), 10)
    assert float(x[:, 0, 0].min()) >= 1.0  # row 0 carries its own scale
    ops, logz = cuda_longseq.fold_rows(x, k)
    ref, logz_ref = cuda_longseq.chunk_operators(ta.double(), tb.double(),
                                                 tok.reshape(-1), 10)
    assert 1e-31 < float(ref[:, 0, 0].max()) < 1e-27
    np.testing.assert_allclose(ops[:, 0].double().numpy(), ref[:, 0].numpy(),
                               rtol=rtol, atol=0)
    np.testing.assert_allclose(ops.double().numpy(), ref.numpy(), atol=rtol)
    np.testing.assert_allclose(logz.numpy(), logz_ref.numpy(), rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exponent_sums_are_exact_integers(dtype):
    """With a = 0.5 P (P a permutation) and emissions that are powers of
    two, every row is one entry of an exact power of two: x is 1 there and
    k the exponent of the exact product, taken by hand."""
    from itrails_tpu_torch.hmm import cuda_longseq

    m, length = 7, 30
    rng = np.random.default_rng(12)
    perm = rng.permutation(m)
    a = 0.5 * np.eye(m)[perm]
    expo = rng.integers(0, 21, size=(m, 625))
    bfull = np.ldexp(1.0, -expo)
    tok = rng.integers(0, 625, size=(3, length)).astype(np.int32)
    tok[1, 5:12] = -1
    x, k = cuda_longseq.chunk_rows(torch.as_tensor(a, dtype=dtype),
                                   torch.as_tensor(bfull, dtype=dtype),
                                   torch.as_tensor(tok.reshape(-1)), length)
    assert k.dtype == torch.int32
    for c in range(3):
        for i in range(m):
            state, want = i, 0
            for t in tok[c]:
                if t < 0:
                    continue
                state = int(np.flatnonzero(a[state])[0])
                want += -1 - int(expo[state, t])
            row = np.zeros(m)
            row[state] = 1.0
            assert int(k[c, i]) == want
            assert np.array_equal(x[c, i].double().numpy(), row)


@pytest.mark.parametrize("m", [1, 5, 27, 36])
def test_dmma_fragments_give_the_product(m):
    """The f64 kernel's product, emulated on its fragments: k step (j, h)
    takes state 8j + 2t + h from lane (g, t)'s own accumulator of the last
    column, and lane (g', t) supplies a[8j + 2t + h, 8n + g'] for tile n;
    summed over the steps it is X @ a, exactly on integers."""
    from itrails_tpu_torch.hmm import cuda_longseq

    rng = np.random.default_rng(m)
    a = rng.integers(0, 9, (m, m)).astype(np.float64)
    fr = cuda_longseq.dmma_fragments(torch.as_tensor(a)).numpy()
    nt = fr.shape[0]
    assert fr.shape == (nt, nt, 8, 4, 2) and nt == -(-m // 8)
    x = np.zeros((16, 8 * nt))
    x[:, :m] = rng.integers(0, 9, (16, m))
    got = np.zeros((16, 8 * nt))
    for j in range(nt):
        for h in range(2):
            for t in range(4):
                # (16 rows) x (n, g') += X[:, 8j+2t+h] * fr[j, n, g', t, h]
                got += x[:, 8 * j + 2 * t + h, None] * fr[j, :, :, t, h].reshape(-1)
    np.testing.assert_array_equal(got[:, :m], x[:, :m] @ a)
    assert not got[:, m:].any()


@pytest.mark.parametrize("tag", ["1x2", "3x3"])
def test_forward_loglik_long_matches_jax_and_the_sequential_forward(tag):
    from itrails_tpu.hmm import longseq as jax_longseq
    from itrails_tpu_torch.hmm import decoders, longseq

    (a, bfull, pi), tables = _tables(tag)
    rng = np.random.default_rng(5)
    for t_len, chunk in LONG_CASES:
        tok = rng.integers(0, 625, size=t_len).astype(np.int32)
        tok[1 + t_len // 3:6 + t_len // 3] = -1  # a PAD run after column 0
        got = longseq.forward_loglik_long(*tables, torch.as_tensor(tok),
                                          chunk=chunk)
        ref = jax_longseq.forward_loglik_long(
            jnp.asarray(a), jnp.asarray(bfull), jnp.asarray(pi),
            jnp.asarray(tok), chunk=chunk)
        seq = decoders.forward_loglik(*tables, torch.as_tensor(tok)[None])
        plain = longseq.forward_loglik_long_plain(*tables, torch.as_tensor(tok),
                                                  chunk=chunk)
        assert got.dtype == torch.float64 and got.dim() == 0
        # on the CPU K5's wrapper folds its plain rows; the plain route
        # builds the contract's operators
        np.testing.assert_allclose(float(plain), float(got), rtol=1e-12,
                                   err_msg=f"T={t_len} chunk={chunk}")
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-9,
                                   err_msg=f"T={t_len} chunk={chunk}")
        np.testing.assert_allclose(float(got), float(seq), rtol=1e-9,
                                   err_msg=f"T={t_len} chunk={chunk}")


def test_the_log_normalizer_leg_is_f64(monkeypatch):
    """With f32 tables the value is f64, and a block whose per-chunk log
    scales sum past 1e8 nats keeps increments that an f32 sum would drop
    (one f32 ulp is 8 nats there).  The chunks' operators come from a stub
    of K5: identity operators and chosen log scales."""
    from itrails_tpu_torch.hmm import cuda_longseq, longseq

    _, (a, bfull, pi) = _tables("1x2", torch.float32)
    m = a.shape[0]
    scales = [-1.25e8] + [-0.375] * 7

    def stub(a, bfull, stream):
        c = stream.shape[0]
        ops = torch.eye(m, dtype=a.dtype).expand(c, m, m).clone()
        return ops, torch.tensor(scales[:c], dtype=torch.float64)

    monkeypatch.setattr(cuda_longseq, "chunk_operators_fused", stub)
    tok = torch.zeros(1 + 8 * 16, dtype=torch.int32)
    got = longseq.forward_loglik_long(a, bfull, pi, tok, chunk=16)
    alpha0 = (pi * bfull[:, 0]).double().sum()
    want = float(torch.log(alpha0)) + sum(scales)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-15, abs=0)
    f32_sum = float(torch.tensor(scales, dtype=torch.float32).sum())
    assert abs((float(got) - float(torch.log(alpha0))) - f32_sum) >= 2.0


def test_grouped_fold_equals_one_group(monkeypatch):
    """Under a budget of a few operators, the chunks are built and folded
    group by group into the running product; the value is that of one
    group."""
    from itrails_tpu_torch.hmm import longseq

    _, tables = _tables("3x3")
    m = tables[0].shape[0]
    rng = np.random.default_rng(7)
    tok = torch.as_tensor(rng.integers(0, 625, size=1 + 11 * 32).astype(np.int32))
    whole = longseq.forward_loglik_long(*tables, tok, chunk=32)
    monkeypatch.setattr(longseq, "OPERATOR_BUDGET_BYTES", 3 * m * m * 8)
    calls = []
    real = longseq.cuda_longseq.chunk_operators_fused

    def spy(a, bfull, stream):
        calls.append(stream.shape[0])
        return real(a, bfull, stream)

    monkeypatch.setattr(longseq.cuda_longseq, "chunk_operators_fused", spy)
    grouped = longseq.forward_loglik_long(*tables, tok, chunk=32)
    assert calls == [3, 3, 3, 2]
    np.testing.assert_allclose(float(grouped), float(whole), rtol=1e-13)


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    """On the CPU the wrapper is K5's plain version, its rows folded."""
    from itrails_tpu_torch.hmm import cuda_longseq

    _, (a, bfull, _) = _tables("1x2")
    tok = torch.as_tensor(_stream(3, 16, seed=8))
    before = (cuda_longseq.chunk_operators_fused.calls,
              cuda_longseq.chunk_operators_fused.launches)
    got = cuda_longseq.chunk_operators_fused(a, bfull, tok)
    want = cuda_longseq.fold_rows(*cuda_longseq.chunk_rows(a, bfull,
                                                           tok.reshape(-1), 16))
    assert (cuda_longseq.chunk_operators_fused.calls,
            cuda_longseq.chunk_operators_fused.launches) == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_kernel_build_needs_the_cuda_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to another path."""
    from itrails_tpu_torch.hmm import cuda_longseq

    monkeypatch.setattr(cuda_longseq, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_longseq.build()


def _simulated_block(tag, t_len=3001, seed=21):
    """A ``t_len``-column block simulated from a golden model, with a PAD
    run inside and a PAD tail; its tables in f64 (numpy and torch)."""
    from itrails_tpu_torch.data.simulate import simulate_token_batch

    np_tables, tables = _tables(tag)
    b = torch.as_tensor(load_golden(f"model_{tag}.npz")["b"])
    gen = torch.Generator().manual_seed(seed)
    tok = simulate_token_batch(tables[0], b, tables[2], 1, t_len, gen)[0]
    tok[t_len // 3:t_len // 3 + 90] = -1
    tok[-37:] = -1
    return np_tables, tables, tok


def _assert_entries(got, ref, rtol):
    """Every entry of every gradient within ``rtol`` of the reference."""
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r, np.float64), rtol=rtol, atol=0)


@pytest.mark.parametrize("tag", ["1x2", "3x3"])
def test_long_gradient_matches_jax_value_and_grad(tag):
    """47 chunks of 64 columns against the JAX remat route's autodiff."""
    from itrails_tpu.hmm import longseq as jax_longseq
    from itrails_tpu_torch.hmm import longseq

    (a, bfull, pi), tables, tok = _simulated_block(tag)
    ll, grads = longseq.forward_loglik_long_and_grads(*tables, tok, chunk=64)
    remat = functools.partial(jax_longseq.forward_loglik_long_remat, chunk=64,
                              seg_chunks=8, inner=32)
    ll_ref, g_ref = jax.value_and_grad(remat, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(bfull), jnp.asarray(pi),
        jnp.asarray(tok.numpy()))
    assert ll.dtype == torch.float64 and ll.dim() == 0
    assert all(g.dtype == torch.float64 for g in grads)
    np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-10)
    _assert_entries([g.numpy() for g in grads], g_ref, rtol=1e-8)


@pytest.mark.parametrize("tag,chunk", [("1x2", 64), ("3x3", 64),
                                       ("3x3", 1024), ("3x3", 3000)])
def test_long_gradient_matches_the_one_window_walk(tag, chunk):
    """The route equals K2's plain version walking the block as one window,
    with many chunks, one chunk with a PAD tail, and one chunk exactly."""
    from itrails_tpu_torch.hmm import cuda_grad, longseq

    _, tables, tok = _simulated_block(tag)
    ll, grads = longseq.forward_loglik_long_and_grads(*tables, tok, chunk=chunk)
    ll_ref, g_ref = cuda_grad.loglik_and_grads_plain(*tables, tok[None])
    np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-10)
    _assert_entries(grads, g_ref, rtol=1e-10)


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 7, 8, 13])
def test_boundary_rows_are_the_exclusive_products(n_chunks):
    """alpha[c] ~ entry G_0 ... G_{c-1} and beta[c] ~ G_{c+1} ... exit,
    each summing to 1, against the products taken one by one."""
    from itrails_tpu_torch.hmm import longseq

    rng = np.random.default_rng(n_chunks)
    ops = torch.as_tensor(rng.random((n_chunks, 5, 5)))
    entry, exit_ = (torch.as_tensor(rng.random(5)) for _ in range(2))
    alpha, beta = longseq.boundary_rows(ops, entry, exit_)
    assert alpha.shape == beta.shape == (n_chunks, 5)
    want = entry / entry.sum()
    for c in range(n_chunks):
        np.testing.assert_allclose(alpha[c].numpy(), want.numpy(), rtol=1e-13)
        want = want @ ops[c]
        want = want / want.sum()
    want = exit_ / exit_.sum()
    for c in range(n_chunks - 1, -1, -1):
        np.testing.assert_allclose(beta[c].numpy(), want.numpy(), rtol=1e-13)
        want = ops[c] @ want
        want = want / want.sum()


def test_grouped_gradient_equals_one_group(monkeypatch):
    """Under a budget of three chunks' operators, a first pass keeps each
    group's product, and each group's operators are built again for its
    boundary rows and its own K2 call; the value and gradient are one
    group's."""
    from itrails_tpu_torch.hmm import cuda_grad, longseq

    _, tables, tok = _simulated_block("3x3", t_len=1 + 11 * 32)
    whole = longseq.forward_loglik_long_and_grads(*tables, tok, chunk=32)
    m = tables[0].shape[0]
    monkeypatch.setattr(longseq, "OPERATOR_BUDGET_BYTES", 3 * m * m * 8)
    calls = {"K5": [], "K2": []}
    k5, k2 = longseq.cuda_longseq.chunk_operators_fused, cuda_grad.loglik_and_grads_fused

    def spy_k5(a, bfull, stream):
        calls["K5"].append(stream.shape[0])
        return k5(a, bfull, stream)

    def spy_k2(a, bfull, pi, tokens, **rows):
        calls["K2"].append(tuple(tokens.shape))
        return k2(a, bfull, pi, tokens, **rows)

    monkeypatch.setattr(longseq.cuda_longseq, "chunk_operators_fused", spy_k5)
    monkeypatch.setattr(cuda_grad, "loglik_and_grads_fused", spy_k2)
    grouped = longseq.forward_loglik_long_and_grads(*tables, tok, chunk=32)
    assert calls["K5"] == [3, 3, 3, 2] * 2
    assert calls["K2"] == [(3, 33), (3, 33), (3, 33), (2, 33)]
    np.testing.assert_allclose(float(grouped[0]), float(whole[0]), rtol=1e-13)
    _assert_entries(grouped[1], whole[1], rtol=1e-12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


def _random_tables(m, dev):
    """A random model with a sticky diagonal and an aggregation-consistent
    emission table, f64 on ``dev``."""
    from itrails_tpu_torch.data.tokens import aggregation_matrix

    rng = np.random.default_rng(m)
    a = rng.random((m, m)) + 5 * np.eye(m)
    a /= a.sum(1, keepdims=True)
    bfull = (rng.random((m, 256)) * 0.01 + 1e-4) @ aggregation_matrix().T
    pi = rng.random(m)
    pi /= pi.sum()
    return [torch.as_tensor(x, device=dev) for x in (a, bfull, pi)]


K5_STATES = [27, 36, 96, 133, 160, 182, 224]


@pytest.mark.gpu
@pytest.mark.parametrize("m", K5_STATES)
def test_k5_matches_plain_on_the_card(cuda_device, m):
    from itrails_tpu_torch.hmm import cuda_longseq

    a, bfull, _ = _random_tables(m, cuda_device)
    tok = torch.as_tensor(_stream(6, 128, seed=m), device=cuda_device)
    before = cuda_longseq.chunk_operators_fused.launches
    ops, logz = cuda_longseq.chunk_operators_fused(a.float().contiguous(),
                                                   bfull.float().contiguous(), tok)
    torch.cuda.synchronize()
    assert cuda_longseq.chunk_operators_fused.launches == before + 1
    assert ops.dtype == torch.float32 and logz.dtype == torch.float64
    ops_ref, logz_ref = cuda_longseq.chunk_operators(a, bfull, tok.reshape(-1), 128)
    np.testing.assert_allclose(ops.double().cpu().numpy(), ops_ref.cpu().numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(logz.cpu().numpy(), logz_ref.cpu().numpy(),
                               rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("m", K5_STATES)
def test_k5_in_f64_matches_plain_on_the_card(cuda_device, m):
    """K5 on f64 tables: 16-row tiles with the rows in registers (M <= 64)
    or staged in shared memory (M <= 136), 8-row tiles (M <= 160), and a's
    fragments read from L2 (M > 160)."""
    from itrails_tpu_torch.hmm import cuda_longseq

    a, bfull, _ = _random_tables(m, cuda_device)
    tok = torch.as_tensor(_stream(6, 128, seed=m), device=cuda_device)
    before = cuda_longseq.chunk_operators_fused.launches
    ops, logz = cuda_longseq.chunk_operators_fused(a.contiguous(),
                                                   bfull.contiguous(), tok)
    torch.cuda.synchronize()
    assert cuda_longseq.chunk_operators_fused.launches == before + 1
    assert ops.dtype == torch.float64 and logz.dtype == torch.float64
    ops_ref, logz_ref = cuda_longseq.chunk_operators(a, bfull, tok.reshape(-1), 128)
    np.testing.assert_allclose(ops.cpu().numpy(), ops_ref.cpu().numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(logz.cpu().numpy(), logz_ref.cpu().numpy(),
                               rtol=1e-12)
    assert torch.equal(ops[2], torch.eye(m, dtype=torch.float64,
                                         device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 5e-5, 1e-6),
                                             (torch.float64, 1e-10, 1e-12)])
@pytest.mark.parametrize("m", [27, 133])
def test_k5_tiles_that_mix_chunks_on_the_card(cuda_device, m, dtype, atol, rtol):
    """7 chunks: C M is not a multiple of a warp's 8 or 16 rows, so tiles
    hold rows of two chunks, with different tokens, PAD runs in different
    places and an all-PAD chunk beside live ones."""
    from itrails_tpu_torch.hmm import cuda_longseq

    a, bfull, _ = _random_tables(m, cuda_device)
    tok = _stream(7, 96, seed=m + 1)
    tok[3, 40:90] = -1
    tok[4, :7] = -1
    tok[5, 1::2] = -1
    assert (7 * m) % 16 and (7 * m) % 8
    tok = torch.as_tensor(tok, device=cuda_device)
    ops, logz = cuda_longseq.chunk_operators_fused(a.to(dtype).contiguous(),
                                                   bfull.to(dtype).contiguous(), tok)
    ops_ref, logz_ref = cuda_longseq.chunk_operators(a, bfull, tok.reshape(-1), 96)
    assert ops.dtype == dtype
    np.testing.assert_allclose(ops.double().cpu().numpy(), ops_ref.cpu().numpy(),
                               atol=atol)
    np.testing.assert_allclose(logz.cpu().numpy(), logz_ref.cpu().numpy(),
                               rtol=rtol)
    assert torch.equal(ops[2], torch.eye(m, dtype=dtype, device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-5),
                                        (torch.float64, 1e-10)])
@pytest.mark.parametrize("m", [27, 133, 182])
def test_k5_rows_match_chunk_rows_on_the_card(cuda_device, m, dtype, atol):
    """The kernel's rows and exponent sums against its plain version in f64
    on the same tables.  Where a row's max lies near a power of two the two
    may take exponents one apart, so each row is brought to the reference's
    sum (exactly, by a power of two) before the rows are compared."""
    from itrails_tpu_torch.hmm import cuda_longseq

    a, bfull, _ = _random_tables(m, cuda_device)
    a, bfull = a.to(dtype).contiguous(), bfull.to(dtype).contiguous()
    tok = torch.as_tensor(_stream(5, 128, seed=m + 2), device=cuda_device)
    x, k = cuda_longseq.launch_rows(a, bfull, tok)
    x_ref, k_ref = cuda_longseq.chunk_rows(a.double(), bfull.double(),
                                           tok.reshape(-1), 128)
    assert x.dtype == dtype and k.dtype == torch.int32 and x.shape == x_ref.shape
    assert int((k - k_ref).abs().max()) <= 1
    got = torch.ldexp(x.double(), (k - k_ref).double()[..., None])
    np.testing.assert_allclose(got.cpu().numpy(), x_ref.cpu().numpy(), atol=atol)
    assert torch.equal(k[2], torch.zeros_like(k[2]))


@pytest.mark.gpu
def test_k5_f64_issues_dmma_and_no_block_barrier_in_its_loop(cuda_device):
    """Every f64 instantiation of K5 runs its product on the FP64 tensor
    cores (DMMA), no f32 one does, and every one has one block barrier, the
    one before its column loop."""
    import re

    from itrails_tpu_torch.hmm import _build, cuda_longseq

    path, _ = cuda_longseq.build()
    funcs = {n: body for n, body in _build.sass_functions(path).items()
             if "k5_rows" in n}
    f64 = [n for n in funcs if "k5_rows_f64" in n]
    f32 = [n for n in funcs if "k5_rows_f32" in n]
    assert len(f64) == 28 and len(f32) == 7
    for n in f64:
        assert "DMMA" in funcs[n], n
    for n in f32:
        assert "DMMA" not in funcs[n] and "HMMA" not in funcs[n], n
    for n, body in funcs.items():
        assert len(re.findall(r"\bBAR\.SYNC", body)) == 1, n


@pytest.mark.gpu
def test_long_value_on_the_card_matches_the_f64_plain_version(cuda_device):
    from itrails_tpu_torch.hmm import cuda_fwd, longseq

    a, bfull, pi = _random_tables(27, cuda_device)
    rng = np.random.default_rng(9)
    tok = torch.as_tensor(rng.integers(0, 625, size=50_001).astype(np.int32),
                          device=cuda_device)
    got = longseq.forward_loglik_long(*(x.float().contiguous() for x in (a, bfull, pi)),
                                      tok)
    ref = longseq.forward_loglik_long_plain(a, bfull, pi, tok)
    seq = cuda_fwd.forward_loglik_fused(a.cpu(), bfull.cpu(), pi.cpu(),
                                        tok.cpu()[None])  # f64, on the CPU
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(ref), float(seq), rtol=1e-9)
    got64 = longseq.forward_loglik_long(*(x.contiguous() for x in (a, bfull, pi)),
                                        tok)
    np.testing.assert_allclose(float(got64), float(ref), rtol=1e-12)


@pytest.mark.gpu
def test_k5_wrapper_raises_on_inputs_it_does_not_take(cuda_device):
    from itrails_tpu_torch.hmm import cuda_longseq

    m = 27
    a = torch.full((m, m), 1.0 / m, device=cuda_device)
    bfull = torch.full((m, 625), 0.01, device=cuda_device)
    tok = torch.zeros((2, 5), dtype=torch.int32, device=cuda_device)
    before = cuda_longseq.chunk_operators_fused.launches
    with pytest.raises(ValueError, match="float32"):
        cuda_longseq.chunk_operators_fused(a.double(), bfull, tok)
    with pytest.raises(ValueError, match="int32"):
        cuda_longseq.chunk_operators_fused(a, bfull, tok.long())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_longseq.chunk_operators_fused(a.T, bfull, tok)
    with pytest.raises(ValueError, match="states"):
        big = torch.full((225, 225), 1.0 / 225, device=cuda_device)
        cuda_longseq.chunk_operators_fused(
            big, torch.full((225, 625), 0.01, device=cuda_device), tok)
    assert cuda_longseq.chunk_operators_fused.launches == before
    cuda_longseq.chunk_operators_fused(a, bfull, tok)
    assert cuda_longseq.chunk_operators_fused.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,t_len,chunk", [(27, 50_001, 1024), (27, 20_000, 256),
                                           (133, 20_001, 512)])
def test_long_gradient_on_the_card_matches_the_f64_plain_route(cuda_device, m,
                                                               t_len, chunk):
    from itrails_tpu_torch.hmm import cuda_grad, cuda_longseq, longseq

    a, bfull, pi = _random_tables(m, cuda_device)
    rng = np.random.default_rng(m + chunk)
    tok = rng.integers(0, 625, size=t_len).astype(np.int32)
    tok[t_len // 2:t_len // 2 + 700] = -1
    tok = torch.as_tensor(tok, device=cuda_device)
    k2, k5 = (cuda_grad.loglik_and_grads_fused.calls,
              cuda_longseq.chunk_operators_fused.launches)
    ll, grads = longseq.forward_loglik_long_and_grads(
        *(x.float().contiguous() for x in (a, bfull, pi)), tok, chunk=chunk)
    torch.cuda.synchronize()
    assert cuda_grad.loglik_and_grads_fused.calls == k2 + 1
    assert cuda_longseq.chunk_operators_fused.launches == k5 + 1
    ll_ref, g_ref = longseq.forward_loglik_long_and_grads_plain(a, bfull, pi, tok,
                                                                chunk=chunk)
    assert ll.dtype == torch.float64
    np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-6)
    for g, r in zip(grads, g_ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.double().cpu().numpy(), r.cpu().numpy(),
                                   rtol=2e-3, atol=0)
