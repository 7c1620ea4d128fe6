"""The port's posterior (kernel K4's plain version,
``hmm/cuda_posterior.py:posterior_fused_plain``) against the JAX package's
log-space scan (``itrails_tpu.hmm.decoders.posterior``), its Pallas kernel
in interpret mode, ``longseq.posterior_long`` and the original iTRAILS
posteriors (goldens/hmm_*.npz); the segmented route against one pass, bit
for bit (the CLI's long-block route: tests/test_torch_posterior_long.py);
the posterior CSV writer against the JAX package's, byte for byte; and, on
the card, K4 against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


def _decode_setup():
    """The resolved decode setup of tests/test_workflows.py's 1x2 config."""
    from itrails_tpu_torch.cli.common import prepare_decode_setup
    from tests.test_workflows import _decode_config

    return prepare_decode_setup(_decode_config())


def _random_model(m, seed=0):
    """``(a, bfull, pi)`` in f64 numpy."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    return a, bfull, pi


def _tokens(w, t, seed):
    """(W, T) tokens with ragged PAD tails and an all-PAD window."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 625, size=(w, t)).astype(np.int32)
    tok[1, t // 2:] = -1
    tok[2, 3:] = -1
    tok[-1, :] = -1
    return tok


def _masked(post, tok):
    """The posterior (T, W, M) with its PAD steps zeroed."""
    return np.where((np.asarray(tok) != -1).T[:, :, None], post, 0.0)


def _block_rows(a, bfull, pi, v):
    """The plain posterior (T, M) of one block, on torch tables."""
    from itrails_tpu_torch.hmm import cuda_posterior

    post, _ = cuda_posterior.posterior_fused_plain(a, bfull, pi,
                                                   torch.tensor(v)[None, :])
    return post[:, 0, :].numpy()


def _plain(a, bfull, pi, tok, dtype=np.float64):
    from itrails_tpu_torch.hmm import cuda_posterior

    post, _ = cuda_posterior.posterior_fused_plain(
        *(torch.tensor(np.asarray(x, dtype)) for x in (a, bfull, pi)),
        torch.tensor(tok))
    return post.numpy()


@pytest.mark.parametrize("m", [9, 27, 133])
def test_plain_matches_jax_scan(m):
    from itrails_tpu.hmm import decoders

    a, bfull, pi = _random_model(m, seed=m)
    tok = _tokens(5, 47, seed=m + 1)
    ref = np.asarray(decoders.posterior(
        *(jnp.asarray(x) for x in (a, bfull, pi)), jnp.asarray(tok)))
    got = _plain(a, bfull, pi, tok)
    assert got.shape == ref.shape == (47, 5, m)
    np.testing.assert_allclose(_masked(got, tok), _masked(ref, tok),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("m,shape,seed", [(9, (3, 41), 7), (27, (3, 41), 7),
                                          (133, (640, 5), 21)])
def test_plain_matches_pallas_kernel(m, shape, seed):
    """The cases of tests/test_pallas_fwd.py:78 (PAD tail) and :201 (M=133),
    the kernel at its exact precision in interpret mode, in f32."""
    from itrails_tpu.data.tokens import aggregation_matrix
    from itrails_tpu.hmm import decoders, pallas_fwd

    rng = np.random.default_rng(seed)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    b = rng.random((m, 256)) * 0.01 + 1e-4
    bfull = np.asarray(decoders.emission_table(
        jnp.asarray(b, jnp.float32), jnp.asarray(aggregation_matrix(), jnp.float32)))
    pi = rng.random(m)
    pi /= pi.sum()
    tok = rng.integers(0, 625, size=shape).astype(np.int32)
    if shape[1] > 30:
        tok[1, 30:] = -1
    ref = np.asarray(pallas_fwd.posterior_fused(
        *(jnp.asarray(x, jnp.float32) for x in (a, bfull, pi)), jnp.asarray(tok),
        block_w=128, chunk_t=8, interpret=True))
    got = _plain(a, bfull, pi, tok, np.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(_masked(got, tok), _masked(ref, tok), atol=2e-5)


@pytest.mark.parametrize("tag", ["1x2", "3x3", "4x4", "7x7"])
@pytest.mark.parametrize("seq", ["v1", "v2"])
def test_plain_matches_reference_goldens(tag, seq):
    from itrails_tpu_torch.data.tokens import aggregation_matrix
    from itrails_tpu_torch.hmm import decoders

    m = load_golden(f"model_{tag}.npz")
    h = load_golden(f"hmm_{tag}.npz")
    bfull = decoders.emission_table(torch.tensor(m["b"]), aggregation_matrix())
    tok = torch.tensor(h[f"{seq}_tokens"].astype(np.int32))[None, :]
    post = decoders.posterior_fast(torch.tensor(m["a"]), bfull,
                                   torch.tensor(m["pi"]), tok)[:, 0, :]
    np.testing.assert_allclose(post.numpy(), h[f"{seq}_post"], rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("t_len", [700, 256, 129])
def test_one_window_block_matches_posterior_long(t_len):
    """A long block is a one-window batch in the port; the JAX package
    decodes it with transfer operators (tolerance of
    tests/test_longseq.py:48)."""
    from itrails_tpu.data.tokens import aggregation_matrix
    from itrails_tpu.hmm import decoders
    from itrails_tpu.hmm.longseq import posterior_long

    m = load_golden("model_1x2.npz")
    bfull = np.asarray(decoders.emission_table(jnp.asarray(m["b"]),
                                               aggregation_matrix()))
    tok = np.random.default_rng(9).integers(0, 625, size=t_len).astype(np.int32)
    ref = np.asarray(posterior_long(jnp.asarray(m["a"]), jnp.asarray(bfull),
                                    jnp.asarray(m["pi"]), jnp.asarray(tok),
                                    chunk=64))
    got = _plain(m["a"], bfull, m["pi"], tok[None, :])[:, 0, :]
    np.testing.assert_allclose(got, ref, rtol=5e-6, atol=1e-9)


def test_fast_dispatch_on_cpu_is_the_plain_version():
    """A CPU call runs the plain version and counts no launch."""
    from itrails_tpu_torch.hmm import cuda_posterior, decoders

    a, bfull, pi = (torch.tensor(x) for x in _random_model(11, seed=5))
    tok = torch.tensor(_tokens(4, 31, seed=6))
    calls = cuda_posterior.posterior_fused.calls
    launches = cuda_posterior.posterior_fused.launches
    got = decoders.posterior_fast(a, bfull, pi, tok)
    beta = cuda_posterior.beta_sweep(a, bfull, tok)
    assert torch.equal(got, cuda_posterior.posterior_fused_plain(a, bfull, pi, tok)[0])
    assert torch.equal(beta, cuda_posterior.beta_sweep_plain(a, bfull, tok))
    assert got.dtype == torch.float64 and tuple(got.shape) == (31, 4, 11)
    assert cuda_posterior.posterior_fused.calls == calls
    assert cuda_posterior.posterior_fused.launches == launches


def test_kernel_build_needs_the_cuda_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to another path."""
    from itrails_tpu_torch.hmm import cuda_posterior

    monkeypatch.setattr(cuda_posterior, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_posterior.build()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_entry_alpha_and_exit_beta_continue_a_window(dtype):
    """A window cut in two, overlapping at column 24: the first part from
    the beta that the second part's sweep hands back, the second from the
    first part's final alpha, give the one-pass posterior bit for bit."""
    from itrails_tpu_torch.hmm import cuda_posterior

    a, bfull, pi = (torch.tensor(x, dtype=dtype) for x in _random_model(27, seed=7))
    tok = torch.tensor(_tokens(4, 60, seed=8))
    full, alpha = cuda_posterior.posterior_fused(a, bfull, pi, tok)
    second = tok[:, 24:].contiguous()
    beta = cuda_posterior.beta_sweep(a, bfull, second)
    first, al_mid = cuda_posterior.posterior_fused(
        a, bfull, pi, tok[:, :25].contiguous(), beta_exit=beta)
    rest, al_end = cuda_posterior.posterior_fused(a, bfull, pi, second,
                                                  alpha0=al_mid)
    assert torch.equal(first, full[:25])
    assert torch.equal(rest, full[24:])
    assert torch.equal(al_end, alpha)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segmented_route_matches_one_pass(dtype, monkeypatch):
    """posterior_segmented with the segment length lowered: each block's
    pieces come in column order and join into its one-pass rows (a
    one-window batch), bit for bit, and those are the plain version's on
    the block alone, exactly."""
    from itrails_tpu_torch.hmm import decoders

    dt = getattr(torch, dtype)
    a, bfull, pi = (torch.tensor(x, dtype=dt) for x in _random_model(27, seed=9))
    rng = np.random.default_rng(10)
    v_lst = [rng.integers(0, 625, size=n).astype(np.int32)
             for n in (40, 700, 1301, 90, 95)]
    one_pass = [decoders.posterior_fast(a, bfull, pi, torch.tensor(v)[None, :])
                [:, 0, :].numpy() for v in v_lst]
    monkeypatch.setattr(decoders, "SEGMENT_COLUMNS", 128)
    pieces = [(i, p.numpy()) for i, v in enumerate(v_lst)
              for p in decoders.posterior_segmented(a, bfull, pi, torch.tensor(v))]
    assert [i for i, _ in pieces] == [0] + [1] * 6 + [2] * 11 + [3, 4]
    for i, v in enumerate(v_lst):
        seg = np.concatenate([r for j, r in pieces if j == i])
        np.testing.assert_array_equal(seg, one_pass[i])
        np.testing.assert_array_equal(one_pass[i], _block_rows(a, bfull, pi, v))
        assert seg.dtype == getattr(np, dtype) and seg.shape == (len(v), 27)


@pytest.mark.parametrize("seg_cols", [1, 5, 58, 59, 60, 200])
def test_segment_edges(seg_cols, monkeypatch):
    """Segments of one column, of a length that leaves a one-column
    segment, and of the whole block; the pieces cover the columns in
    order."""
    from itrails_tpu_torch.hmm import decoders

    a, bfull, pi = (torch.tensor(x) for x in _random_model(9, seed=11))
    tok = np.random.default_rng(12).integers(0, 625, size=60).astype(np.int32)
    ref = _block_rows(a, bfull, pi, tok)
    monkeypatch.setattr(decoders, "SEGMENT_COLUMNS", seg_cols)
    pieces = [p.numpy() for p in
              decoders.posterior_segmented(a, bfull, pi, torch.tensor(tok))]
    n_seg = -(-59 // seg_cols)
    assert len(pieces) == n_seg
    assert [len(p) for p in pieces[1:]] == [
        min(seg_cols, 59 - k * seg_cols) for k in range(1, n_seg)]
    np.testing.assert_array_equal(np.concatenate(pieces), ref)


def test_window_groups_bound_the_store(monkeypatch):
    """Short blocks go in consecutive groups whose padded store stays under
    the budget; a long block goes alone; the order is the block order.  The
    store is sized as the device allocates it: 32S float32 a column on the
    card, M of the tables' dtype in the plain version."""
    from itrails_tpu_torch.hmm import cuda_posterior, decoders

    monkeypatch.setattr(cuda_posterior, "POSTERIOR_BUDGET_BYTES", 3 * 100 * 128)
    card = cuda_posterior.store_row_bytes(27, "cuda", torch.float32)
    assert card == 128
    lengths = [50, 100, 90, 10, 400, 20, 20, 20, 20, 301, 5]
    groups = decoders.posterior_groups(lengths, card, 300)
    assert groups == [[0, 1, 2], [3], [4], [5, 6, 7, 8], [9], [10]]
    assert cuda_posterior.window_group(100, card) == 3
    # 64 floats a column
    assert cuda_posterior.window_group(
        100, cuda_posterior.store_row_bytes(33, "cuda", torch.float32)) == 1
    assert cuda_posterior.store_row_bytes(27, "cpu", torch.float64) == 216
    assert cuda_posterior.store_row_bytes(27, "cpu", torch.float32) == 108
    assert cuda_posterior.window_group(100, 216) == 1


def _jax_writer(path, results, coords):
    from itrails_tpu.cli.decode import write_posterior_csv

    write_posterior_csv(str(path), results, coords)
    return path.read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_coords", [False, True])
def test_writer_bytes_match_the_jax_writer(dtype, with_coords, tmp_path,
                                           monkeypatch):
    """The same arrays through both writers: the same bytes, whether a block
    comes whole or in pieces, and in chunks of rows."""
    from itrails_tpu_torch.cli import decode

    rng = np.random.default_rng(2)
    results = [rng.random((37, 5)).astype(dtype),
               rng.random((11, 5)).astype(dtype),
               rng.random((23, 5)).astype(dtype)]
    results[0][:4] = [[0.0, 1.0, 1e-20, 5e-324, 0.1], [1e-5, 1e-4, 0.5, 1 / 3, 2e-7],
                      [np.nextafter(1.0, 0.0)] * 5, [7e-45, 1e-38, 3e-8, 0.25, 0.75]]
    coords = None
    if with_coords:
        gaps = rng.random(37) < 0.3
        coords = [np.where(gaps, -9, np.arange(500, 537)), np.arange(90, 101),
                  np.arange(10**9, 10**9 + 23)]
    want = _jax_writer(tmp_path / "jax.csv", results, coords)
    port = tmp_path / "port.csv"
    decode.write_posterior_csv(str(port), enumerate(results), coords)
    assert port.read_bytes() == want
    assert want.startswith(b"alignment_block_idx,position_idx,prob_state_0,")
    assert want.count(b"\r\n") == 1 and want.count(b"\n") == 1 + 37 + 11 + 23
    monkeypatch.setattr(decode, "POSTERIOR_CHUNK_ROWS", 4)
    pieces = [(0, results[0][:10]), (0, results[0][10:11]), (0, results[0][11:]),
              (1, results[1]), (2, results[2][:20]), (2, results[2][20:])]
    decode.write_posterior_csv(str(port), iter(pieces), coords)
    assert port.read_bytes() == want


def test_writer_without_blocks_matches_the_jax_writer(tmp_path):
    from itrails_tpu_torch.cli import decode

    want = _jax_writer(tmp_path / "jax.csv", [], None)
    decode.write_posterior_csv(str(tmp_path / "port.csv"), iter(()), None)
    assert (tmp_path / "port.csv").read_bytes() == want


@pytest.mark.gpu
@pytest.mark.parametrize("m", [9, 27, 33, 133, 224])
def test_k4_matches_plain_on_the_card(m, cuda_device):
    from itrails_tpu_torch.hmm import cuda_posterior

    a, bfull, pi = (torch.tensor(x, device=cuda_device)
                    for x in _random_model(m, seed=m))
    tok = torch.tensor(_tokens(67, 301, seed=13), device=cuda_device)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))
    launches = cuda_posterior.posterior_fused.launches
    post, alpha = cuda_posterior.posterior_fused(a32, b32, p32, tok)
    torch.cuda.synchronize()
    assert cuda_posterior.posterior_fused.launches == launches + 2
    ref, al_ref = cuda_posterior.posterior_fused_plain(a, bfull, pi, tok)
    real = (tok != -1).T[:, :, None]
    err = torch.where(real, (post.double() - ref).abs(), 0.0)
    assert float(err.max()) <= 2e-5
    assert float((alpha.double() - al_ref).abs().max()) <= 2e-5
    sums = post.double().sum(dim=2)
    assert float(torch.where(real[:, :, 0], (sums - 1).abs(), 0.0).max()) <= 1e-5
    beta = cuda_posterior.beta_sweep(a32, b32, tok)
    beta_ref = cuda_posterior.beta_sweep_plain(a, bfull, tok)
    assert float((beta.double() - beta_ref).abs().max()) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("m", [27, 133, 160, 182, 224])
def test_k4_in_f64_matches_plain_on_the_card(m, cuda_device):
    """K4 on f64 tables runs in f64 (a read from global memory above
    M = 160) and meets the f64 plain version at atol 1e-10."""
    from itrails_tpu_torch.hmm import cuda_posterior

    a, bfull, pi = (torch.tensor(x, device=cuda_device)
                    for x in _random_model(m, seed=m))
    tok = torch.tensor(_tokens(21, 301, seed=13), device=cuda_device)
    launches = cuda_posterior.posterior_fused.launches
    post, alpha = cuda_posterior.posterior_fused(a, bfull, pi, tok)
    torch.cuda.synchronize()
    assert cuda_posterior.posterior_fused.launches == launches + 2
    assert post.dtype == torch.float64 and alpha.dtype == torch.float64
    ref, al_ref = cuda_posterior.posterior_fused_plain(a, bfull, pi, tok)
    real = (tok != -1).T[:, :, None]
    assert float(torch.where(real, (post - ref).abs(), 0.0).max()) <= 1e-10
    assert float((alpha - al_ref).abs().max()) <= 1e-10
    beta = cuda_posterior.beta_sweep(a, bfull, tok)
    beta_ref = cuda_posterior.beta_sweep_plain(a, bfull, tok)
    assert float((beta - beta_ref).abs().max()) <= 1e-10


@pytest.mark.parametrize("posterior", [True, False])
def test_decode_build_keeps_the_precision_flag(posterior):
    """``--precision`` sets the decode's dtype on the CPU for both decode
    CLIs; on the card the posterior keeps it too (test below)."""
    from itrails_tpu_torch.cli import decode

    setup = _decode_setup()
    for precision in ("float64", "float32"):
        _, a, bfull, pi = decode.build(setup, precision, "cpu",
                                       posterior=posterior)
        assert a.dtype == bfull.dtype == pi.dtype == getattr(torch, precision)


@pytest.mark.gpu
def test_posterior_decode_on_the_card_keeps_f64(cuda_device):
    """On the card the posterior decode takes ``--precision`` (default
    float64); the Viterbi decode stays float32 (K3 takes float32 only)."""
    from itrails_tpu_torch.cli import decode

    setup = _decode_setup()
    _, a, _, _ = decode.build(setup, "float64", cuda_device, posterior=True)
    assert a.dtype == torch.float64
    _, a, _, _ = decode.build(setup, "float64", cuda_device, posterior=False)
    assert a.dtype == torch.float32


@pytest.mark.gpu
def test_k4_segments_and_groups_on_the_card(cuda_device, monkeypatch):
    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.hmm import decoders

    a, bfull, pi = (torch.tensor(x, dtype=torch.float32, device=cuda_device)
                    for x in _random_model(27, seed=14))
    row = torch.tensor(np.random.default_rng(16).integers(
        0, 625, size=5000).astype(np.int32), device=cuda_device)
    one = decoders.posterior_fast(a, bfull, pi, row[None, :])[:, 0, :]
    monkeypatch.setattr(decoders, "SEGMENT_COLUMNS", 777)
    seg = torch.cat(list(decoders.posterior_segmented(a, bfull, pi, row)))
    assert torch.equal(seg, one)
    v_lst = [np.random.default_rng(k).integers(0, 625, size=n).astype(np.int32)
             for k, n in enumerate((300, 120, 5000, 7))]
    monkeypatch.setattr(decode, "LONG_BLOCK_THRESHOLD", 1000)
    on_card = list(decode.run_posterior(a, bfull, pi, v_lst))
    on_cpu = list(decode.run_posterior(a.cpu(), bfull.cpu(), pi.cpu(), v_lst))
    assert [i for i, _ in on_card] == [i for i, _ in on_cpu] == [0, 1, 2, 3]
    for (_, x), (_, y) in zip(on_card, on_cpu):
        np.testing.assert_allclose(x, y, atol=2e-5)
