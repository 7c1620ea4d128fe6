"""The port's Viterbi (kernel K3's plain version,
``hmm/cuda_viterbi.py:viterbi_fused_plain``) against the JAX package's scan
(``itrails_tpu.hmm.decoders.viterbi``), its Pallas kernel in interpret mode
and the original iTRAILS paths (goldens/hmm_*.npz), exactly, ties
included; the segmented route against the one-pass route; and, on the
card, K3 against its plain version."""

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


def _k3_launches(cuda_viterbi):
    """K3's kernel launches so far: a window batch is its forward, then its
    backtrack."""
    return (cuda_viterbi.viterbi_forward.launches
            + cuda_viterbi.viterbi_backtrack.launches)


def _random_model(m, seed=0, tie=False):
    """``(a, bfull, pi)`` in f64 numpy.  With ``tie``, states 0 and 1 are
    exchangeable (equal rows and columns of a, equal emission rows, equal
    pi), so every step has exact ties between them."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, m))
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    if tie:
        a[1] = a[0]
        a[:, 1] = a[:, 0]
        bfull[1] = bfull[0]
        pi[1] = pi[0]
    a /= a.sum(1, keepdims=True)
    pi /= pi.sum()
    return a, bfull, pi


def _tokens(w, t, seed):
    """(W, T) tokens with a ragged PAD tail and an all-PAD window."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 625, size=(w, t)).astype(np.int32)
    tok[1, t // 2:] = -1
    tok[2, 3:] = -1
    tok[-1, :] = -1
    return tok


def _jax_viterbi(a, bfull, pi, tok, dtype):
    from itrails_tpu.hmm import decoders

    return np.asarray(decoders.viterbi(
        *(jnp.asarray(x, dtype) for x in (a, bfull, pi)), jnp.asarray(tok)))


def _plain(a, bfull, pi, tok):
    """K3's plain version on torch tables: log tables, column 0, then the
    recursion, as the wrapper's CPU branch runs it."""
    from itrails_tpu_torch.hmm import cuda_viterbi

    log_a, log_bt, log_pi = cuda_viterbi.log_tables(a, bfull, pi)
    omega0 = cuda_viterbi.column0(log_bt, log_pi, tok[:, 0])
    return cuda_viterbi.viterbi_fused_plain(log_a, log_bt, omega0, tok)[0]


def _port_viterbi(a, bfull, pi, tok, dtype):
    tables = (torch.tensor(x.astype(dtype)) for x in (a, bfull, pi))
    return _plain(*tables, torch.tensor(tok)).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,tie", [(27, False), (133, False), (27, True),
                                   (133, True)])
def test_plain_matches_jax_scan(m, tie, dtype):
    a, bfull, pi = _random_model(m, seed=m, tie=tie)
    tok = _tokens(5, 47, seed=m + 1)
    ref = _jax_viterbi(a, bfull, pi, tok, dtype)
    got = _port_viterbi(a, bfull, pi, tok, dtype)
    np.testing.assert_array_equal(got, ref)
    if tie:  # the first index wins every tie: state 1 is never taken
        assert not (got == 1).any()


@pytest.mark.parametrize("m,tie", [(27, False), (133, False), (27, True),
                                   (133, True)])
def test_plain_matches_pallas_kernel(m, tie):
    from itrails_tpu.hmm import pallas_viterbi

    a, bfull, pi = _random_model(m, seed=2 * m, tie=tie)
    tok = _tokens(4, 40, seed=3)
    ref = np.asarray(pallas_viterbi.viterbi_fused(
        *(jnp.asarray(x, jnp.float32) for x in (a, bfull, pi)),
        jnp.asarray(tok), block_w=128, chunk_t=8, interpret=True))
    np.testing.assert_array_equal(_port_viterbi(a, bfull, pi, tok, np.float32),
                                  ref)


def test_uniform_model_ties_everywhere():
    """Every score ties: the path is state 0 at every column, in both
    packages and both dtypes."""
    m = 9
    a = np.full((m, m), 1.0 / m)
    bfull = np.full((m, 625), 0.01)
    pi = np.full(m, 1.0 / m)
    tok = _tokens(3, 20, seed=4)
    for dtype in (np.float32, np.float64):
        got = _port_viterbi(a, bfull, pi, tok, dtype)
        np.testing.assert_array_equal(got, _jax_viterbi(a, bfull, pi, tok, dtype))
        assert not got.any()


def test_token_outside_the_alphabet_reads_the_clamped_row():
    """The JAX scan's gather clamps an index above 624 to the last row; the
    port's emission rule does the same."""
    a, bfull, pi = _random_model(9, seed=17)
    tok = _tokens(4, 30, seed=18)
    tok[0, [0, 5, 6]] = 700
    tok[3, 2] = 625
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(_port_viterbi(a, bfull, pi, tok, dtype),
                                      _jax_viterbi(a, bfull, pi, tok, dtype))


def test_kernel_build_needs_the_cuda_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to another path."""
    from itrails_tpu_torch.hmm import cuda_viterbi

    monkeypatch.setattr(cuda_viterbi, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_viterbi.build()


@pytest.mark.parametrize("tag", ["1x2", "3x3", "7x7"])
@pytest.mark.parametrize("seq", ["v1", "v2"])
def test_plain_matches_reference_goldens(tag, seq):
    from itrails_tpu_torch.data.tokens import aggregation_matrix
    from itrails_tpu_torch.hmm import decoders

    m = load_golden(f"model_{tag}.npz")
    h = load_golden(f"hmm_{tag}.npz")
    bfull = decoders.emission_table(torch.tensor(m["b"]), aggregation_matrix())
    tok = torch.tensor(h[f"{seq}_tokens"].astype(np.int32))[None, :]
    path = _plain(torch.tensor(m["a"]), bfull, torch.tensor(m["pi"]), tok)[0]
    np.testing.assert_array_equal(path.numpy(), h[f"{seq}_viterbi"])


def test_fast_dispatch_on_cpu_is_the_plain_version():
    from itrails_tpu_torch.hmm import cuda_viterbi, decoders

    a, bfull, pi = (torch.tensor(x) for x in _random_model(11, seed=5))
    tok = torch.tensor(_tokens(4, 31, seed=6))
    calls = cuda_viterbi.viterbi_fused.calls
    launches = _k3_launches(cuda_viterbi)
    got = decoders.viterbi_fast(a, bfull, pi, tok)
    assert torch.equal(got, _plain(a, bfull, pi, tok))
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 31)
    assert cuda_viterbi.viterbi_fused.calls == calls
    assert _k3_launches(cuda_viterbi) == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_entry_omega_and_final_state_continue_a_window(dtype):
    """A window cut in two: the second half from the first half's final
    omega, backtracked from the one-pass path's last state, gives the
    one-pass path over its columns."""
    from itrails_tpu_torch.hmm import cuda_viterbi

    a, bfull, pi = (torch.tensor(x, dtype=dtype)
                    for x in _random_model(27, seed=7))
    tok = torch.tensor(np.random.default_rng(8).integers(
        0, 625, size=(2, 60)).astype(np.int32))
    full, omega = cuda_viterbi.viterbi_fused(a, bfull, pi, tok)
    _, om_mid = cuda_viterbi.viterbi_fused(a, bfull, pi, tok[:, :25])
    second, om_end = cuda_viterbi.viterbi_fused(
        a, bfull, pi, tok[:, 24:].contiguous(), omega0=om_mid,
        last=full[:, -1].contiguous())
    assert torch.equal(second, full[:, 24:])
    assert torch.equal(om_end, omega)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segmented_route_matches_one_pass(dtype, monkeypatch):
    """run_viterbi with the long-block threshold lowered (its long blocks
    through the sequence-parallel route) and ``viterbi_segmented`` in
    128-column segments, which the CLI no longer calls and the card holds
    the route against: both give the one-pass plain decoder's paths, bit
    for bit."""
    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.hmm import decoders, longseq

    dt = getattr(torch, dtype)
    a, bfull, pi = (torch.tensor(x, dtype=dt) for x in _random_model(27, seed=9))
    rng = np.random.default_rng(10)
    v_lst = [rng.integers(0, 625, size=n).astype(np.int32)
             for n in (40, 700, 1301, 90)]
    monkeypatch.setattr(decode, "LONG_BLOCK_THRESHOLD", 100)
    monkeypatch.setattr(longseq, "ROUTE_CHUNK", 64)
    routed = decode.run_viterbi(a, bfull, pi, v_lst)
    monkeypatch.setattr(decoders, "SEGMENT_COLUMNS", 128)
    for v, p1 in zip(v_lst, routed):
        tok = torch.tensor(v)
        ref = _plain(a, bfull, pi, tok[None, :])[0]
        np.testing.assert_array_equal(
            decoders.viterbi_segmented(a, bfull, pi, tok).numpy(), ref.numpy())
        np.testing.assert_array_equal(p1, ref.numpy())
        assert p1.dtype == np.int32 and len(p1) == len(v)


@pytest.mark.parametrize("seg_cols", [1, 5, 58, 59, 60, 200])
def test_segment_edges(seg_cols, monkeypatch):
    """Segments of one column, of a length that leaves a one-column
    segment, and of the whole block."""
    from itrails_tpu_torch.hmm import decoders

    a, bfull, pi = (torch.tensor(x) for x in _random_model(9, seed=11))
    tok = torch.tensor(np.random.default_rng(12).integers(
        0, 625, size=60).astype(np.int32))
    ref = _plain(a, bfull, pi, tok[None, :])[0]
    monkeypatch.setattr(decoders, "SEGMENT_COLUMNS", seg_cols)
    assert torch.equal(decoders.viterbi_segmented(a, bfull, pi, tok), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("m,tie", [(27, False), (27, True), (133, False),
                                   (133, True), (250, False)])
def test_k3_matches_plain_on_the_card(m, tie, cuda_device):
    from itrails_tpu_torch.hmm import cuda_viterbi

    a, bfull, pi = (torch.tensor(x, dtype=torch.float32, device=cuda_device)
                    for x in _random_model(m, seed=m, tie=tie))
    tok = torch.tensor(_tokens(67, 301, seed=13), device=cuda_device)
    launches = _k3_launches(cuda_viterbi)
    path, omega = cuda_viterbi.viterbi_fused(a, bfull, pi, tok)
    torch.cuda.synchronize()
    assert _k3_launches(cuda_viterbi) == launches + 2
    log_a, log_bt, log_pi = cuda_viterbi.log_tables(a, bfull, pi)
    om0 = cuda_viterbi.column0(log_bt, log_pi, tok[:, 0])
    ref, om_ref = cuda_viterbi.viterbi_fused_plain(log_a, log_bt, om0, tok)
    assert torch.equal(path, ref)
    assert torch.equal(omega, om_ref)
    cpu = cuda_viterbi.viterbi_fused(a.cpu(), bfull.cpu(), pi.cpu(), tok.cpu())
    assert torch.equal(path.cpu(), cpu[0])


@pytest.mark.gpu
def test_k3_window_groups_and_segments_on_the_card(cuda_device, monkeypatch):
    from itrails_tpu_torch.hmm import cuda_viterbi, decoders

    a, bfull, pi = (torch.tensor(x, dtype=torch.float32, device=cuda_device)
                    for x in _random_model(27, seed=14))
    tok = torch.tensor(_tokens(50, 400, seed=15), device=cuda_device)
    whole = cuda_viterbi.viterbi_fused(a, bfull, pi, tok)[0]
    monkeypatch.setattr(cuda_viterbi, "POINTER_BUDGET_BYTES", 7 * 399 * 27)
    launches = _k3_launches(cuda_viterbi)
    grouped = cuda_viterbi.viterbi_fused(a, bfull, pi, tok)[0]
    assert torch.equal(grouped, whole)
    assert _k3_launches(cuda_viterbi) == launches + 2 * 8  # 50 / 7
    row = torch.tensor(np.random.default_rng(16).integers(
        0, 625, size=5000).astype(np.int32), device=cuda_device)
    one = decoders.viterbi_fast(a, bfull, pi, row[None, :])[0]
    monkeypatch.setattr(decoders, "SEGMENT_COLUMNS", 777)
    assert torch.equal(decoders.viterbi_segmented(a, bfull, pi, row), one)
