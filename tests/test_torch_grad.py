"""Kernel K2's plain version, the decode's autograd function and the
matrix exponential's derivative on the CPU, against the JAX package where
it has the same function; K2 itself against its plain version on the card.

Tolerances:
* K2's plain version in f64 against ``jax.value_and_grad`` of
  ``itrails_tpu.hmm.grad.forward_loglik_remat``: loglik rtol 1e-10,
  gradients rtol 1e-8 with atol 1e-8 * max|ref|.  Both are exact f64
  algebra and differ only in summation order.
* In f32 against ``pallas_grad.loglik_and_grads_fused(...,
  interpret=True)``: the tests/test_pallas_grad.py rule, loglik rtol 1e-4,
  gradients rtol 2e-3 with atol 2e-3 * max|ref| (f32 rounding of the
  per-step normalizers, in another order on each side).
* On the card, K2 in f32 against its plain version in f64: total rtol
  1e-6 (an f64 sum of f32 windows), gradients rtol 2e-3 on every entry with
  no absolute slack (each entry is a sum of non-negative terms, so none
  cancels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _random_model(m, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    return a, bfull, pi


def _tokens(case):
    """The token batches of tests/test_pallas_grad.py, by name."""
    if case == "basic":
        return np.random.default_rng(1).integers(0, 625, size=(3, 70))
    if case == "padding":
        tok = np.random.default_rng(2).integers(0, 625, size=(4, 45))
        tok[1, 30:] = -1
        tok[2, 5:] = -1
        tok[3, :] = -1  # fully empty window
        return tok
    if case == "m27":
        return np.random.default_rng(4).integers(0, 625, size=(2, 130))
    if case == "single_column":
        return np.random.default_rng(6).integers(0, 625, size=(2, 1))
    t_len = int(case.split("=")[1])
    return np.random.default_rng(8).integers(0, 625, size=(2, t_len))


# (token case, M, model seed), as in tests/test_pallas_grad.py
CASES = [("basic", 9, 0), ("padding", 7, 3), ("m27", 27, 5),
         ("single_column", 5, 7), ("T=15", 6, 9), ("T=16", 6, 9),
         ("T=17", 6, 9), ("T=33", 6, 9)]


def _torch(*xs, dtype=torch.float64, device="cpu"):
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in xs]


def _assert_grads(got, ref, rtol):
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        np.testing.assert_allclose(g, r, rtol=rtol,
                                   atol=rtol * np.abs(r).max())


@pytest.mark.parametrize("case,m,seed", [CASES[0], CASES[1]])
def test_plain_k2_matches_jax_autodiff_in_f64(case, m, seed):
    from itrails_tpu.hmm.grad import forward_loglik_remat
    from itrails_tpu_torch.hmm import cuda_grad

    a, bfull, pi = _random_model(m, seed)
    tok = np.asarray(_tokens(case), np.int32)
    ll_ref, g_ref = jax.value_and_grad(forward_loglik_remat, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(bfull), jnp.asarray(pi), jnp.asarray(tok))
    ll, grads = cuda_grad.loglik_and_grads_fused(*_torch(a, bfull, pi),
                                                 torch.as_tensor(tok))
    assert ll.dtype == torch.float64 and all(g.dtype == torch.float64
                                             for g in grads)
    np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-10)
    _assert_grads([g.numpy() for g in grads], g_ref, rtol=1e-8)


@pytest.mark.parametrize("case,m,seed", CASES)
def test_plain_k2_matches_pallas_interpret_in_f32(case, m, seed):
    from itrails_tpu.hmm import pallas_grad
    from itrails_tpu_torch.hmm import cuda_grad

    a, bfull, pi = _random_model(m, seed)
    tok = np.asarray(_tokens(case), np.int32)
    f32 = [jnp.asarray(x, jnp.float32) for x in (a, bfull, pi)]
    ll_ref, g_ref = pallas_grad.loglik_and_grads_fused(
        *f32, jnp.asarray(tok), block_w=128, chunk_t=16, interpret=True)
    ll, grads = cuda_grad.loglik_and_grads_fused(
        *_torch(a, bfull, pi, dtype=torch.float32), torch.as_tensor(tok))
    assert all(g.dtype == torch.float32 for g in grads)
    np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-4)
    _assert_grads([g.numpy() for g in grads], g_ref, rtol=2e-3)


def test_expm_grad_matches_finite_differences():
    from itrails_tpu_torch.core.expm import expm_batch

    rng = np.random.default_rng(2)
    a = torch.tensor(rng.normal(size=(5, 5)) * 2.0, requires_grad=True)
    w = torch.as_tensor(rng.normal(size=(5, 5)))

    def f(x):
        return (expm_batch(x[None])[0] * w).sum()

    (g,) = torch.autograd.grad(f(a), a)
    eps = 1e-6
    for i, j in ((2, 3), (0, 0), (4, 1)):
        e = torch.zeros(5, 5, dtype=torch.float64)
        e[i, j] = eps
        with torch.no_grad():
            fd = (float(f(a + e)) - float(f(a - e))) / (2 * eps)
        np.testing.assert_allclose(float(g[i, j]), fd, rtol=1e-5)


def test_loglik_fn_sums_batches_and_scales_its_gradient():
    """LoglikFn's value is the f64 sum over batches, and its backward hands
    autograd the summed K2 gradients times the incoming gradient."""
    from itrails_tpu_torch.hmm import cuda_grad
    from itrails_tpu_torch.hmm.grad import LoglikFn

    a, bfull, pi = _random_model(8, seed=11)
    tok = np.asarray(_tokens("padding"), np.int32)
    batches = [torch.as_tensor(tok[:2]), torch.as_tensor(tok[2:, :20].copy())]
    leaves = [x.requires_grad_() for x in _torch(a, bfull, pi)]
    total = LoglikFn.apply(*leaves, *batches)
    (3.0 * total).backward()
    parts = [cuda_grad.loglik_and_grads_plain(*_torch(a, bfull, pi), t)
             for t in batches]
    np.testing.assert_allclose(float(total.detach()),
                               sum(float(v) for v, _ in parts), rtol=1e-14)
    for k, leaf in enumerate(leaves):
        want = 3.0 * sum(g[k] for _, g in parts)
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-13 * float(want.abs().max()))


def test_cpu_calls_run_the_plain_version_and_count_no_call():
    from itrails_tpu_torch.hmm import cuda_grad

    a, bfull, pi = _torch(*_random_model(5))
    tok = torch.as_tensor(np.asarray(_tokens("padding"), np.int32))
    before = cuda_grad.loglik_and_grads_fused.calls
    ll, grads = cuda_grad.loglik_and_grads_fused(a, bfull, pi, tok)
    ll_p, grads_p = cuda_grad.loglik_and_grads_plain(a, bfull, pi, tok)
    assert cuda_grad.loglik_and_grads_fused.calls == before
    assert torch.equal(ll, ll_p)
    for x, y in zip(grads, grads_p):
        assert torch.equal(x, y)


def test_k2_build_needs_the_cuda_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to another path."""
    from itrails_tpu_torch.hmm import cuda_grad

    monkeypatch.setattr(cuda_grad, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found: building kernel K2"):
        cuda_grad.build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,w,t", [(27, 64, 300), (36, 40, 200), (133, 48, 257),
                                   (160, 20, 100), (27, 3, 1), (9, 5, 17)])
def test_k2_matches_plain_on_the_card(cuda_device, m, w, t):
    from itrails_tpu_torch.hmm import cuda_grad

    a, bfull, pi = _torch(*_random_model(m), device=cuda_device)
    rng = np.random.default_rng(m + w + t)
    tok = rng.integers(0, 625, size=(w, t)).astype(np.int32)
    if t > 5:
        tok[1, t // 2:] = -1
        tok[2, :] = -1
        tok[3, 5] = -1
    tok = torch.as_tensor(tok, device=cuda_device)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))
    before = cuda_grad.loglik_and_grads_fused.calls
    ll, grads = cuda_grad.loglik_and_grads_fused(a32, b32, p32, tok)
    torch.cuda.synchronize()
    assert cuda_grad.loglik_and_grads_fused.calls == before + 1
    ll_ref, g_ref = cuda_grad.loglik_and_grads_plain(a, bfull, pi, tok)
    np.testing.assert_allclose(float(ll), float(ll_ref), rtol=1e-6)
    for g, r in zip(grads, g_ref):
        np.testing.assert_allclose(g.double().cpu().numpy(), r.cpu().numpy(),
                                   rtol=2e-3, atol=0)
    # the block partials are summed in a fixed order: the same bits again
    ll2, grads2 = cuda_grad.loglik_and_grads_fused(a32, b32, p32, tok)
    assert torch.equal(ll, ll2)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))
