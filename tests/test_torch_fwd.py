"""Kernel K1's plain version and the port's decoders against the JAX
package, on the CPU; K1 itself against its plain version on the card.

Tolerances: f64 against ``itrails_tpu.hmm.decoders.forward`` at rtol 1e-10
(the scaled-linear and the log-space recurrences agree to f64 round-off);
f32 against ``pallas_fwd.forward_fused(..., interpret=True)`` at atol 2e-4
per window, as in tests/test_pallas_fwd.py.  K1's own arithmetic, the rows
with power-of-two scales (``forward_rows_plain`` through ``scaled_rows``)
folded by ``fold_forward``, against the JAX scan in f64 at loglik rtol
1e-12 and alpha atol 1e-12 (power-of-two scales are exact; the rounding is
the products' and the fold's), and against the Pallas kernel in f32 at the
tolerances above.  On the card, the kernel's per-window loglik against the
plain version in f64 at rtol 1e-5: f32 rounding of the products over T
steps; K1 on f64 tables at rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden

torch.set_num_threads(1)


def _random_model(m, seed=0):
    """Random model with an aggregation-consistent emission table, as
    every production table is (numpy, f64)."""
    from itrails_tpu_torch.data.tokens import aggregation_matrix

    rng = np.random.default_rng(seed)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    b = rng.random((m, 256)) * 0.01 + 1e-4
    bfull = b @ aggregation_matrix().T
    pi = rng.random(m)
    pi /= pi.sum()
    return a, bfull, pi


def _tokens(w, t, seed=1):
    """Uniform tokens with ragged PAD tails, an interior PAD and an all-PAD
    window."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 625, size=(w, t)).astype(np.int32)
    tok[1, t // 2:] = -1
    tok[2, :] = -1
    tok[3, 5] = -1
    tok[3, t - 3:] = -1
    return tok


def _torch(*xs, dtype=torch.float64, device="cpu"):
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in xs]


def _golden_tables(tag):
    """(a, bfull, pi) of a golden model (numpy f64)."""
    from itrails_tpu_torch.data.tokens import aggregation_matrix

    g = load_golden(f"model_{tag}.npz")
    return g["a"], g["b"] @ aggregation_matrix().T, g["pi"]


def _k1_rows_folded(a, bfull, pi, tok):
    """K1's arithmetic in plain PyTorch, folded to forward_fused's contract."""
    from itrails_tpu_torch.hmm import cuda_fwd

    return cuda_fwd.fold_forward(*cuda_fwd.forward_rows_plain(a, bfull, pi, tok))


@pytest.mark.parametrize("m", [27, 133])
def test_plain_k1_matches_jax_scan_in_f64(m):
    from itrails_tpu.hmm import decoders as jax_decoders
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _random_model(m)
    tok = _tokens(5, 47)
    alpha_ref, ll_ref = jax_decoders.forward(jnp.asarray(a), jnp.asarray(bfull),
                                             jnp.asarray(pi), jnp.asarray(tok))
    al, ll = cuda_fwd.forward_fused(*_torch(a, bfull, pi), torch.as_tensor(tok))
    assert ll.dtype == torch.float64
    # atol: the all-PAD window's loglik is log(sum(pi)) = 0 up to f64 round-off
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(torch.log(al).numpy() + ll.numpy()[:, None],
                               np.asarray(alpha_ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("m", [27, 133])
def test_plain_k1_matches_pallas_interpret_in_f32(m):
    from itrails_tpu.hmm import pallas_fwd
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _random_model(m, seed=2)
    tok = _tokens(4, 33, seed=3)
    f32 = [jnp.asarray(x, jnp.float32) for x in (a, bfull, pi)]
    al_ref, ll_ref = pallas_fwd.forward_fused(*f32, jnp.asarray(tok),
                                              block_w=128, chunk_t=16,
                                              interpret=True)
    al, ll = cuda_fwd.forward_fused(*_torch(a, bfull, pi, dtype=torch.float32),
                                    torch.as_tensor(tok))
    assert ll.dtype == torch.float32
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), atol=2e-4)
    np.testing.assert_allclose(al.numpy(), np.asarray(al_ref), atol=2e-5)


@pytest.mark.parametrize("tag", ["1x2", "3x3"])
def test_k1_rows_folded_match_jax_scan_in_f64(tag):
    """K1's rows, started from column 0's alpha before its normalization,
    with their exponent sums folded, against the JAX log-space scan."""
    from itrails_tpu.hmm import decoders as jax_decoders

    a, bfull, pi = _golden_tables(tag)
    tok = _tokens(5, 47)
    alpha_ref, ll_ref = jax_decoders.forward(jnp.asarray(a), jnp.asarray(bfull),
                                             jnp.asarray(pi), jnp.asarray(tok))
    al, ll = _k1_rows_folded(*_torch(a, bfull, pi), torch.as_tensor(tok))
    assert al.dtype == torch.float64 and ll.dtype == torch.float64
    ll_ref = np.asarray(ll_ref)
    np.testing.assert_allclose(ll.numpy(), ll_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(al.numpy(), np.exp(np.asarray(alpha_ref)
                                                  - ll_ref[:, None]),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("m", [27, 133])
def test_k1_rows_folded_match_pallas_interpret_in_f32(m):
    from itrails_tpu.hmm import pallas_fwd

    a, bfull, pi = _random_model(m, seed=2)
    tok = _tokens(4, 33, seed=3)
    f32 = [jnp.asarray(x, jnp.float32) for x in (a, bfull, pi)]
    al_ref, ll_ref = pallas_fwd.forward_fused(*f32, jnp.asarray(tok),
                                              block_w=128, chunk_t=16,
                                              interpret=True)
    al, ll = _k1_rows_folded(*_torch(a, bfull, pi, dtype=torch.float32),
                             torch.as_tensor(tok))
    assert al.dtype == torch.float32 and ll.dtype == torch.float64
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), atol=2e-4)
    np.testing.assert_allclose(al.numpy(), np.asarray(al_ref), atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_rows_take_exact_exponent_sums(dtype):
    """With a = 0.5 P (P a permutation), one-hot pi and emissions that are
    powers of two, every row is one entry of an exact power of two: after a
    live column x is exactly 1 there, k the exponent of the exact product
    over columns 1..T-1 times column 0's value, taken by hand, and the
    folded loglik ln2 times the exponent of the whole product."""
    from itrails_tpu_torch.hmm import cuda_fwd

    m, t_len = 7, 30
    rng = np.random.default_rng(12)
    perm = rng.permutation(m)
    a = 0.5 * np.eye(m)[perm]
    expo = rng.integers(0, 21, size=(m, 625))
    bfull = np.ldexp(1.0, -expo)
    pi = np.zeros(m)
    pi[3] = 1.0
    tok = rng.integers(0, 625, size=(4, t_len)).astype(np.int32)
    tok[1, 5:12] = -1
    tok[2, 1:] = -1  # no live column after column 0
    ta, tb, tp = _torch(a, bfull, pi, dtype=dtype)
    x, k = cuda_fwd.forward_rows_plain(ta, tb, tp, torch.as_tensor(tok))
    _, ll = cuda_fwd.fold_forward(x, k)
    assert k.dtype == torch.int32
    for w in range(4):
        state, total, live = 3, -int(expo[3, tok[w, 0]]), False
        for t in tok[w, 1:]:
            if t < 0:
                continue
            state = int(np.flatnonzero(a[state])[0])
            total += -1 - int(expo[state, t])
            live = True
        row = np.zeros(m)
        row[state] = 1.0 if live else 2.0 ** -int(expo[3, tok[w, 0]])
        assert int(k[w]) == (total if live else 0)
        assert np.array_equal(x[w].double().numpy(), row)
        assert float(ll[w]) == total * np.log(2.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_an_all_pad_window_keeps_column0_exactly(dtype):
    """A window with no live column after column 0 (PAD after a live first
    column, or PAD throughout) folds to column 0's alpha and log-normalizer
    bit for bit: its row is column 0's alpha before normalization, and its
    exponent sum 0."""
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _torch(*_random_model(9, seed=7), dtype=dtype)
    tok = _tokens(5, 12, seed=8)
    tok[4, 1:] = -1
    tok = torch.as_tensor(tok)
    x, k = cuda_fwd.forward_rows_plain(a, bfull, pi, tok)
    al, ll = cuda_fwd.fold_forward(x, k)
    _, al0, s0 = cuda_fwd.column0(bfull, pi, tok[:, 0])
    for w in (2, 4):
        assert int(k[w]) == 0
        assert torch.equal(al[w], al0[w])
        assert float(ll[w]) == float(torch.log(s0[w].double()))
    assert float(ll[0]) < float(torch.log(s0[0].double()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_rows_with_a_token_outside_the_alphabet_give_non_finite_loglik(dtype):
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _torch(*_random_model(7), dtype=dtype)
    tok = np.zeros((3, 9), np.int32)
    tok[0, 3] = 700
    tok[2, 0] = 625
    x, k = cuda_fwd.forward_rows_plain(a, bfull, pi, torch.as_tensor(tok))
    _, ll = cuda_fwd.fold_forward(x, k)
    assert not np.isfinite(float(ll[0])) and not np.isfinite(float(ll[2]))
    assert np.isfinite(float(ll[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunk_rows_through_scaled_rows_stay_bit_equal(dtype):
    """K5's plain rows, now one call of the shared ``scaled_rows`` over
    every chunk's rows, against the chunk-batched loop they were before,
    bit for bit."""
    from itrails_tpu_torch.data.tokens import PAD_TOKEN
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq

    a, bfull, _ = _torch(*_random_model(27, seed=9), dtype=dtype)
    m, c, chunk = 27, 6, 33
    tok = _tokens(c, chunk, seed=10)
    tok[4, 7] = 700
    tok = torch.as_tensor(tok.reshape(-1))
    x_ref = torch.eye(m, dtype=dtype).repeat(c, 1, 1)
    k_ref = torch.zeros((c, m), dtype=torch.int32)
    for t in range(chunk):
        col = tok.reshape(c, chunk)[:, t]
        new = (x_ref @ a) * cuda_fwd.emission_rows(bfull.T, col)[:, None, :]
        kt = cuda_fwd._row_exponents(new.amax(dim=2))
        live = (col != PAD_TOKEN)[:, None]
        x_ref = torch.where(live[..., None],
                            new * cuda_fwd._pow2_neg(kt, dtype)[..., None], x_ref)
        k_ref = k_ref + torch.where(live, kt, 0)
    x, k = cuda_longseq.chunk_rows(a, bfull, tok, chunk)
    assert x.shape == (c, m, m) and k.shape == (c, m)
    assert torch.equal(x, x_ref) and torch.equal(k, k_ref)


def test_build_tag_covers_every_source_and_header(tmp_path):
    """The library's name carries a hash of every file of ``csrc/``: an
    edited header (``rows.cuh``, which ``fwd.cu`` and ``operators.cu``
    include, or ``forward.cuh``, which ``rows.cuh``, ``grad.cu`` and
    ``posterior.cu`` include) or source gives a new tag, so no stale library
    is loaded."""
    import shutil

    from itrails_tpu_torch.hmm import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert ({"rows.cuh", "forward.cuh", "fwd.cu", "operators.cu"}
            <= {p.name for p in csrc.iterdir()})
    tag = _build.source_tag(csrc)
    assert tag == _build.source_tag(_build.CSRC)
    seen = {tag}
    for name in ("rows.cuh", "forward.cuh", "fwd.cu"):
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "// edited\n")
        seen.add(_build.source_tag(csrc))
        path.write_text(text)
        assert _build.source_tag(csrc) == tag
    assert len(seen) == 4


def test_loglik_total_is_summed_in_f64():
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _random_model(9)
    tok = _tokens(6, 20)
    a32, b32, p32 = _torch(a, bfull, pi, dtype=torch.float32)
    total = cuda_fwd.forward_loglik_fused(a32, b32, p32, torch.as_tensor(tok))
    _, ll = cuda_fwd.forward_fused(a32, b32, p32, torch.as_tensor(tok))
    assert total.dtype == torch.float64
    assert float(total) == float(ll.double().sum())


@pytest.mark.parametrize("tag", ["1x2", "3x3", "4x4", "7x7"])
def test_port_decoders_match_hmm_goldens(tag):
    from itrails_tpu_torch.data.tokens import aggregation_matrix
    from itrails_tpu_torch.hmm import decoders

    model = load_golden(f"model_{tag}.npz")
    g = load_golden(f"hmm_{tag}.npz")
    a, b, pi = _torch(model["a"], model["b"], model["pi"])
    bfull = decoders.emission_table(b, aggregation_matrix())
    for v in ("v1", "v2"):
        tok = torch.as_tensor(g[f"{v}_tokens"])[None, :]
        ref = float(g[f"{v}_loglik"])
        np.testing.assert_allclose(float(decoders.forward_loglik(a, bfull, pi, tok)),
                                   ref, rtol=1e-10)
        np.testing.assert_allclose(
            float(decoders.forward_loglik_fast(a, bfull, pi, tok.to(torch.int32))),
            ref, rtol=1e-10)


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _random_model(5)
    tok = torch.as_tensor(_tokens(4, 9))
    before = cuda_fwd.forward_fused.launches
    got = cuda_fwd.forward_fused(*_torch(a, bfull, pi), tok)
    want = cuda_fwd.forward_fused_plain(*_torch(a, bfull, pi), tok)
    assert cuda_fwd.forward_fused.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_kernel_build_needs_the_cuda_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to another path."""
    from itrails_tpu_torch.hmm import cuda_fwd

    monkeypatch.setattr(cuda_fwd, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_fwd.build()


def test_invalid_token_gives_non_finite_loglik():
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _random_model(7)
    tok = np.zeros((2, 6), np.int32)
    tok[0, 3] = 700
    _, ll = cuda_fwd.forward_fused(*_torch(a, bfull, pi), torch.as_tensor(tok))
    assert not np.isfinite(float(ll[0])) and np.isfinite(float(ll[1]))


@pytest.mark.parametrize("decoder", ["forward_fused", "forward"])
def test_decoders_share_one_pad_and_invalid_token_rule(decoder):
    """K1's plain version and the log-space reference read emissions
    through one rule: a PAD column is a no-op, a token outside the alphabet
    makes the window's loglik non-finite."""
    from itrails_tpu_torch.hmm import cuda_fwd, decoders

    fn = getattr(cuda_fwd if decoder == "forward_fused" else decoders, decoder)
    a, bfull, pi = _torch(*_random_model(6, seed=4))
    rng = np.random.default_rng(5)
    clean = rng.integers(0, 625, size=8).astype(np.int32)
    tok = np.full((3, 11), -1, np.int32)
    tok[0, :8] = clean
    tok[1, [0, 1, 3, 4, 6, 7, 8, 10]] = clean
    tok[2, :8] = clean
    tok[2, 5] = 625
    _, ll = fn(a, bfull, pi, torch.as_tensor(tok))
    np.testing.assert_allclose(float(ll[1]), float(ll[0]), rtol=1e-12)
    assert np.isfinite(float(ll[0])) and not np.isfinite(float(ll[2]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,w,t", [(27, 64, 300), (36, 40, 200), (133, 48, 257),
                                   (182, 20, 100), (27, 3, 1)])
def test_k1_matches_plain_on_the_card(cuda_device, m, w, t):
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _torch(*_random_model(m), device=cuda_device)
    tok = torch.as_tensor(_tokens(max(w, 4), t) if t > 5 else
                          np.zeros((w, t), np.int32), device=cuda_device)
    before = cuda_fwd.forward_fused.launches
    al, ll = cuda_fwd.forward_fused(a.float(), bfull.float(), pi.float(), tok)
    torch.cuda.synchronize()
    assert cuda_fwd.forward_fused.launches == before + 1
    al_ref, ll_ref = cuda_fwd.forward_fused_plain(a, bfull, pi, tok)
    np.testing.assert_allclose(ll.double().cpu().numpy(), ll_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(al.double().cpu().numpy(), al_ref.cpu().numpy(),
                               atol=1e-6)


def test_check_inputs_takes_one_dtype_among_those_allowed():
    """The kernels' shared input check: the tables are all of one dtype,
    and that dtype is one the kernel is instantiated on."""
    from itrails_tpu_torch.hmm.cuda_fwd import check_inputs

    a, bfull, pi = _torch(*_random_model(5))
    tok = torch.zeros((2, 3), dtype=torch.int32)
    both = (torch.float32, torch.float64)
    check_inputs("k", a, bfull, pi, tok, 224, both)
    check_inputs("k", a.float(), bfull.float(), pi.float(), tok, 224, both)
    with pytest.raises(ValueError, match="must be float32, got torch.float64"):
        check_inputs("k", a, bfull, pi, tok, 224)
    with pytest.raises(ValueError, match="bfull must be float64"):
        check_inputs("k", a, bfull.float(), pi, tok, 224, both)
    with pytest.raises(ValueError, match="float32 or float64, got torch.float16"):
        check_inputs("k", a.half(), bfull.half(), pi.half(), tok, 224, both)
    check_inputs("k", a, bfull, None, tok, 224, both)  # a kernel without pi


@pytest.mark.gpu
@pytest.mark.parametrize("m,w,t", [(27, 64, 300), (133, 48, 257), (182, 20, 100),
                                   (224, 12, 80)])
def test_k1_in_f64_matches_plain_on_the_card(cuda_device, m, w, t):
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _torch(*_random_model(m), device=cuda_device)
    tok = torch.as_tensor(_tokens(w, t), device=cuda_device)
    before = cuda_fwd.forward_fused.launches
    al, ll = cuda_fwd.forward_fused(a, bfull, pi, tok)
    torch.cuda.synchronize()
    assert cuda_fwd.forward_fused.launches == before + 1
    assert al.dtype == torch.float64 and ll.dtype == torch.float64
    al_ref, ll_ref = cuda_fwd.forward_fused_plain(a, bfull, pi, tok)
    np.testing.assert_allclose(ll.cpu().numpy(), ll_ref.cpu().numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(al.cpu().numpy(), al_ref.cpu().numpy(),
                               atol=1e-10)


K1_STATES = [9, 27, 36, 96, 133, 160, 182, 224]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", K1_STATES)
def test_k1_rows_kernel_matches_plain_at_every_tile_layout(cuda_device, m, dtype):
    """K1 at every row-kernel layout (f32: registers or shared a, 4 or 8
    rows a warp; f64: X in registers or staged, a's fragments in shared
    memory or L2, 8-row tiles at every M) against the plain f64 version, at
    the existing gates: f32 loglik rtol 1e-5, alpha atol 1e-6; f64 1e-10."""
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _torch(*_random_model(m, seed=m), device=cuda_device)
    tok = torch.as_tensor(_tokens(40, 150, seed=m), device=cuda_device)
    before = cuda_fwd.forward_fused.launches
    al, ll = cuda_fwd.forward_fused(*(x.to(dtype).contiguous() for x in (a, bfull, pi)),
                                    tok)
    torch.cuda.synchronize()
    assert cuda_fwd.forward_fused.launches == before + 1
    assert al.dtype == dtype and ll.dtype == torch.float64
    if dtype == torch.float64:
        assert cuda_fwd.kernel_attributes(m, True)["rows_per_warp"] == 8
    al_ref, ll_ref = cuda_fwd.forward_fused_plain(a, bfull, pi, tok)
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (1e-10, 1e-10)
    np.testing.assert_allclose(ll.cpu().numpy(), ll_ref.cpu().numpy(),
                               rtol=rtol, atol=atol if dtype == torch.float32 else 0)
    np.testing.assert_allclose(al.double().cpu().numpy(), al_ref.cpu().numpy(),
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w,t", [(1, 300), (17, 120), (100, 64), (9, 1)])
def test_k1_windows_off_the_tile_on_the_card(cuda_device, w, t, dtype):
    """W not a multiple of a tile's rows (1, 17, 100 windows: tiles with
    rows beyond W), and T = 1 (no column after column 0: the rows keep
    column 0's alpha)."""
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = _torch(*_random_model(27, seed=w), device=cuda_device)
    rng = np.random.default_rng(w + t)
    tok = rng.integers(0, 625, size=(w, t)).astype(np.int32)
    if w > 2:
        tok[1, t // 2:] = -1
    tok = torch.as_tensor(tok, device=cuda_device)
    al, ll = cuda_fwd.forward_fused(*(x.to(dtype).contiguous() for x in (a, bfull, pi)),
                                    tok)
    al_ref, ll_ref = cuda_fwd.forward_fused_plain(a, bfull, pi, tok)
    assert al.shape == (w, 27) and ll.shape == (w,)
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    np.testing.assert_allclose(ll.cpu().numpy(), ll_ref.cpu().numpy(), rtol=rtol,
                               atol=1e-6 if dtype == torch.float32 else 0)
    np.testing.assert_allclose(al.double().cpu().numpy(), al_ref.cpu().numpy(),
                               atol=1e-6 if dtype == torch.float32 else 1e-10)
    if t == 1:
        _, al0, _ = cuda_fwd.column0(bfull.to(dtype), pi.to(dtype), tok[:, 0])
        assert torch.equal(al, al0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-5),
                                        (torch.float64, 1e-10)])
@pytest.mark.parametrize("m", [27, 133, 182])
def test_k1_rows_match_forward_rows_plain_on_the_card(cuda_device, m, dtype, atol):
    """The kernel's rows and exponent sums against its plain version in f64
    on the same tables.  Where a row's max lies near a power of two the two
    may take exponents one apart, so each row is brought to the reference's
    sum (exactly, by a power of two) before the rows are compared."""
    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi = (x.to(dtype).contiguous() for x in
                    _torch(*_random_model(m, seed=m + 1), device=cuda_device))
    tok = torch.as_tensor(_tokens(21, 128, seed=m + 2), device=cuda_device)
    x, k = cuda_fwd._launch_k1_rows(a, bfull, pi, tok)
    x_ref, k_ref = cuda_fwd.forward_rows_plain(a.double(), bfull.double(),
                                               pi.double(), tok)
    assert x.dtype == dtype and k.dtype == torch.int32 and x.shape == x_ref.shape
    assert int((k - k_ref).abs().max()) <= 1
    got = torch.ldexp(x.double(), (k - k_ref).double()[:, None])
    scale = x_ref.abs().amax(dim=1, keepdim=True)
    np.testing.assert_allclose((got / scale).cpu().numpy(),
                               (x_ref / scale).cpu().numpy(), atol=atol)
    assert int(k[2]) == 0  # the all-PAD window


@pytest.mark.gpu
def test_k1_f64_issues_dmma_and_no_block_barrier_in_its_loop(cuda_device):
    """Every f64 instantiation of K1 (8-row tiles, one a size) runs its
    product on the FP64 tensor cores (DMMA),
    no f32 one does, and every one has one block barrier, the one before
    its column loop."""
    import re

    from itrails_tpu_torch.hmm import _build, cuda_fwd

    path, _ = cuda_fwd.build()
    funcs = {n: body for n, body in _build.sass_functions(path).items()
             if "k1_rows" in n}
    f64 = [n for n in funcs if "k1_rows_f64" in n]
    f32 = [n for n in funcs if "k1_rows_f32" in n]
    assert len(f64) == 28 and len(f32) == 7
    for n in f64:
        assert "DMMA" in funcs[n], n
    for n in f32:
        assert "DMMA" not in funcs[n] and "HMMA" not in funcs[n], n
    for n, body in funcs.items():
        assert len(re.findall(r"\bBAR\.SYNC", body)) == 1, n
