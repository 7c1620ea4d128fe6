"""Kernel K1's plain version and the port's decoders against the JAX
package, on the CPU; K1 itself against its plain version on the card.

Tolerances: f64 against ``itrails_tpu.hmm.decoders.forward`` at rtol 1e-10
(the scaled-linear and the log-space recurrences agree to f64 round-off);
f32 against ``pallas_fwd.forward_fused(..., interpret=True)`` at atol 2e-4
per window, as in tests/test_pallas_fwd.py.  On the card, the kernel's
per-window loglik against the plain version in f64 at rtol 1e-5: f32
rounding of the per-step normalizers, summed over T steps; K1 on f64
tables at rtol 1e-10.
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
