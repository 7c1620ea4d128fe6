"""Kernel K2: the forward log-likelihood and its exact gradient on the card,
its wrapper, its plain PyTorch version and its build.

K2 (``csrc/grad.cu``) replaces the Pallas TPU kernel
``itrails_tpu/hmm/pallas_grad.py:203 loglik_and_grads_fused``.  It returns
``(total loglik, (dA, dbfull, dpi))`` of a (W, T) token batch, the contract
of ``jax.value_and_grad(itrails_tpu.hmm.grad.forward_loglik_remat,
argnums=(0, 1, 2))``: a forward pass that keeps alpha only at chunk
entries, then a reverse sweep that recomputes each chunk's alpha and
accumulates the Baum-Welch statistics

    dA[i, j]      += u_i (e * beta)_j / Z_t
    dbfull[j, v]  += (a^T u)_j beta_j / Z_t      (v = tok_t)
    Z_t            = sum_j (a^T u)_j (e * beta)_j,   u = alpha_{t-1}.

Column 0 (``pi`` and its emission) is done here, in torch, from beta at the
origin, as ``pallas_grad.py:307-321`` does: ``dpi`` is not masked for an
all-PAD window, which contributes ``log(sum(pi))`` to the value.

:func:`loglik_and_grads_fused` launches K2 for tensors on a CUDA device and
runs :func:`loglik_and_grads_plain` only for tensors on the CPU; a CUDA
input that the kernel does not take raises.  The kernel's per-block
partial sums are added in a fixed order, so a call's result does not
change from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from itrails_tpu_torch.data.tokens import N_TOKENS, PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library
from itrails_tpu_torch.hmm.cuda_fwd import check_inputs, column0, emission_rows

__all__ = ["build", "loglik_and_grads_fused", "loglik_and_grads_plain"]

_SRC = CSRC / "grad.cu"
_TINY = 1e-30  # the clamp of every normalizer in the reverse sweep
_lib = None


def build():
    """Compile ``csrc/grad.cu`` unless this source was built before; see
    :func:`itrails_tpu_torch.hmm._build.compile_library`."""
    return compile_library(_SRC, "libk2_grad", BUILD_DIR, "kernel K2")


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.k2_loglik_and_grads.restype = ctypes.c_int
        lib.k2_loglik_and_grads.argtypes = ([ctypes.c_void_p] * 10
                                            + [ctypes.c_int] * 3
                                            + [ctypes.c_void_p])
        for name, n_args in (("k2_table_width", 1), ("k2_max_states", 0),
                             ("k2_chunk", 1), ("k2_blocks", 2)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * n_args
        lib.k2_error_string.restype = ctypes.c_char_p
        lib.k2_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _column0_grads(e0, al0, s0, beta0, pi, tok0):
    """``(dpi, dbfull of column 0)`` from beta at the origin (W, M):
    ``dpi_j = e0_j beta0_j / (Z0 s0)`` and
    ``dbfull[j, tok0] += pi_j beta0_j / (Z0 s0)`` for a token in the
    alphabet.  The scatter is a product with the one-hot token matrix, so
    its sum order is fixed."""
    coef = 1.0 / ((al0 * beta0).sum(dim=1) * s0).clamp(min=_TINY)
    dpi = (e0 * beta0 * coef[:, None]).sum(dim=0)
    q0 = pi[None, :] * beta0 * coef[:, None]
    onehot = (tok0.long()[:, None]
              == torch.arange(N_TOKENS, device=tok0.device)[None, :])
    return dpi, q0.T @ onehot.to(q0.dtype)


def loglik_and_grads_plain(a, bfull, pi, tokens):
    """:func:`loglik_and_grads_fused` in plain PyTorch, in the dtype of
    ``a``: a forward pass that stores every alpha, then a beta sweep that
    accumulates dA, dbfull and dpi with the kernel's formulas (not autograd
    of the forward, so it holds the kernel's algebra independently).  The
    CPU path and the reference the kernel is held against on the card."""
    bt = bfull.T
    tok0 = tokens[:, 0]
    e0, al0, s0 = column0(bfull, pi, tok0)
    al = al0
    ll = torch.log(s0)
    alphas = []  # alphas[t - 1] = alpha before column t
    for t in range(1, tokens.shape[1]):
        alphas.append(al)
        tok = tokens[:, t]
        nx = (al @ a) * emission_rows(bt, tok)
        s = nx.sum(dim=1)
        pad = tok == PAD_TOKEN
        al = torch.where(pad[:, None], al, nx / s[:, None])
        ll = ll + torch.where(pad, torch.zeros_like(s), torch.log(s))

    beta = torch.ones_like(al0)
    da = torch.zeros_like(a)
    db = torch.zeros((N_TOKENS, a.shape[0]), dtype=a.dtype, device=a.device)
    for t in range(tokens.shape[1] - 1, 0, -1):
        tok = tokens[:, t].long()
        live = tok != PAD_TOKEN
        u = alphas[t - 1]
        atu = u @ a
        v = emission_rows(bt, tok) * beta
        zinv = live / (atu * v).sum(dim=1).clamp(min=_TINY)
        da += u.T @ (v * zinv[:, None])
        valid = (tok >= 0) & (tok < N_TOKENS)
        db.index_add_(0, tok[valid], (atu * beta * zinv[:, None])[valid])
        nb = v @ a.T
        beta = torch.where(live[:, None],
                           nb / nb.sum(dim=1, keepdim=True).clamp(min=_TINY),
                           beta)
    dpi, db0 = _column0_grads(e0, al0, s0, beta, pi, tok0)
    return ll.to(torch.float64).sum(), (da, db.T + db0, dpi)


def loglik_and_grads_fused(a, bfull, pi, tokens):
    """``(total loglik, (dA, dbfull, dpi))`` of a (W, T) token batch.

    Args:
      a: (M, M) row-stochastic transition matrix.
      bfull: (M, 625) emission table over the full alphabet.
      pi: (M,) initial distribution.
      tokens: (W, T) integer tokens, right-padded with PAD_TOKEN.

    The total is float64, the per-window logliks summed in f64.  On CUDA
    the inputs must be contiguous float32 (int32 tokens) and the gradients
    are float32; on the CPU the plain version runs in the dtype of ``a``.
    """
    if tokens.device.type == "cpu":
        return loglik_and_grads_plain(a, bfull, pi, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"loglik_and_grads_fused: unsupported device "
                         f"{tokens.device}")
    lib = _library()
    check_inputs("loglik_and_grads_fused", a, bfull, pi, tokens,
                 lib.k2_max_states())
    dev = tokens.device
    w, t_len = tokens.shape
    m = a.shape[0]
    mp = lib.k2_table_width(m)
    n_chunks = -(-(t_len - 1) // lib.k2_chunk(m))
    n_blocks = lib.k2_blocks(w, m)
    f32 = {"dtype": torch.float32, "device": dev}

    with torch.cuda.device(dev):
        tok0 = tokens[:, 0]
        e0, al0, s0 = column0(bfull, pi, tok0)
        al0 = al0.contiguous()
        ll0 = torch.log(s0).contiguous()
        bt = torch.zeros((N_TOKENS, mp), **f32)
        bt[:, :m] = bfull.T
        chk = torch.empty((n_chunks, w, mp), **f32)
        ll = torch.empty((w,), **f32)
        beta0 = torch.empty((w, mp), **f32)
        da_part = torch.zeros((n_blocks, mp, mp), **f32)
        db_part = torch.zeros((n_blocks, N_TOKENS, mp), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.k2_loglik_and_grads(
            a.data_ptr(), bt.data_ptr(), al0.data_ptr(), ll0.data_ptr(),
            tokens.data_ptr(), chk.data_ptr(), ll.data_ptr(),
            beta0.data_ptr(), da_part.data_ptr(), db_part.data_ptr(),
            w, t_len, m, stream)
        if rc != 0:
            raise RuntimeError("K2 launch failed: "
                               f"{lib.k2_error_string(rc).decode()} ({rc})")
        loglik_and_grads_fused.calls += 1
        da = da_part.sum(dim=0)[:m, :m]
        db = db_part.sum(dim=0)[:, :m]
        dpi, db0 = _column0_grads(e0, al0, s0, beta0[:, :m], pi, tok0)
    return ll.to(torch.float64).sum(), (da, db.T + db0, dpi)


# K2 calls since the last reset to 0; each call launches two kernels
loglik_and_grads_fused.calls = 0
