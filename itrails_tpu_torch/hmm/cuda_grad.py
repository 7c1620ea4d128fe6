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

A window may also be one chunk of a long block (``hmm/longseq.py``): with
``entry_alpha`` every window's column 0 is no emission (its token is not
read), the forward starts from the window's given row, normalized, and
the window adds nothing to the value, ``dpi`` or column 0's ``dbfull``;
with ``exit_beta`` the reverse sweep starts from the window's given row,
normalized, instead of ones.

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
from itrails_tpu_torch.hmm.cuda_fwd import (check_inputs, check_state, column0,
                                            emission_rows)

__all__ = ["build", "column0_grads", "loglik_and_grads_fused",
           "loglik_and_grads_plain"]

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
        lib.k2_loglik_and_grads.argtypes = ([ctypes.c_void_p] * 11
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


def column0_grads(e0, al0, s0, beta0, pi, tok0):
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


def _normalized(rows):
    """Boundary rows (W, M) divided by their sums (floored at 1e-30)."""
    return (rows / rows.sum(dim=1, keepdim=True).clamp(min=_TINY)).contiguous()


def _entry(bfull, pi, tokens, entry_alpha):
    """Each window's alpha after column 0 (W, M) and its log-normalizer
    (W,), and column 0's ``(e0, s0)``, or None with ``entry_alpha``."""
    if entry_alpha is None:
        e0, al0, s0 = column0(bfull, pi, tokens[:, 0])
        return al0.contiguous(), torch.log(s0).contiguous(), (e0, s0)
    al0 = _normalized(entry_alpha)
    return al0, torch.zeros_like(al0[:, 0]), None


def _grads(da, db, beta0, pi, tokens, al0, col0):
    """``(dA, dbfull, dpi)`` from the columns' sums (dA (M, M), dB
    (625, M)) and, unless the windows were entered with ``entry_alpha``,
    column 0's terms from beta at the origin."""
    if col0 is None:
        return da, db.T, torch.zeros_like(pi)
    e0, s0 = col0
    dpi, db0 = column0_grads(e0, al0, s0, beta0, pi, tokens[:, 0])
    return da, db.T + db0, dpi


def loglik_and_grads_plain(a, bfull, pi, tokens, *, entry_alpha=None,
                           exit_beta=None):
    """:func:`loglik_and_grads_fused` in plain PyTorch, in the dtype of
    ``a``: a forward pass that stores every alpha, then a beta sweep that
    accumulates dA, dbfull and dpi with the kernel's formulas (not autograd
    of the forward, so it holds the kernel's algebra independently).  The
    CPU path and the reference the kernel is held against on the card.
    ``entry_alpha`` and ``exit_beta`` as for the kernel."""
    bt = bfull.T
    al0, ll, col0 = _entry(bfull, pi, tokens, entry_alpha)
    al = al0
    alphas = []  # alphas[t - 1] = alpha before column t
    for t in range(1, tokens.shape[1]):
        alphas.append(al)
        tok = tokens[:, t]
        nx = (al @ a) * emission_rows(bt, tok)
        s = nx.sum(dim=1)
        pad = tok == PAD_TOKEN
        al = torch.where(pad[:, None], al, nx / s[:, None])
        ll = ll + torch.where(pad, torch.zeros_like(s), torch.log(s))

    beta = torch.ones_like(al0) if exit_beta is None else _normalized(exit_beta)
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
    return (ll.to(torch.float64).sum(),
            _grads(da, db, beta, pi, tokens, al0, col0))


def loglik_and_grads_fused(a, bfull, pi, tokens, *, entry_alpha=None,
                           exit_beta=None):
    """``(total loglik, (dA, dbfull, dpi))`` of a (W, T) token batch.

    Args:
      a: (M, M) row-stochastic transition matrix.
      bfull: (M, 625) emission table over the full alphabet.
      pi: (M,) initial distribution.
      tokens: (W, T) integer tokens, right-padded with PAD_TOKEN.
      entry_alpha: None, or (W, M) alpha before column 1 of each window
        (any positive scale): column 0 is then no emission and adds
        nothing to the value, ``dpi`` or ``dbfull``.
      exit_beta: None, or (W, M) beta at column T-1 of each window (any
        positive scale) in place of ones.

    The total is float64, the per-window logliks summed in f64 (on CUDA
    each is K1's compensated sum, already f64).  On CUDA
    the inputs must be contiguous float32 (int32 tokens) and the gradients
    are float32; on the CPU the plain version runs in the dtype of ``a``.
    """
    if tokens.device.type == "cpu":
        return loglik_and_grads_plain(a, bfull, pi, tokens,
                                      entry_alpha=entry_alpha,
                                      exit_beta=exit_beta)
    if tokens.device.type != "cuda":
        raise ValueError(f"loglik_and_grads_fused: unsupported device "
                         f"{tokens.device}")
    lib = _library()
    check_inputs("loglik_and_grads_fused", a, bfull, pi, tokens,
                 lib.k2_max_states())
    dev = tokens.device
    w, t_len = tokens.shape
    m = a.shape[0]
    for name, rows in (("entry_alpha", entry_alpha), ("exit_beta", exit_beta)):
        if rows is not None:
            check_state("loglik_and_grads_fused", name, rows, (w, m),
                        torch.float32, dev)
    mp = lib.k2_table_width(m)
    n_chunks = -(-(t_len - 1) // lib.k2_chunk(m))
    n_blocks = lib.k2_blocks(w, m)
    f32 = {"dtype": torch.float32, "device": dev}

    with torch.cuda.device(dev):
        al0, ll0, col0 = _entry(bfull, pi, tokens, entry_alpha)
        beta_in = None if exit_beta is None else _normalized(exit_beta)
        bt = torch.zeros((N_TOKENS, mp), **f32)
        bt[:, :m] = bfull.T
        chk = torch.empty((n_chunks, w, mp), **f32)
        ll = torch.empty((w,), dtype=torch.float64, device=dev)
        beta0 = torch.empty((w, mp), **f32)
        da_part = torch.zeros((n_blocks, mp, mp), **f32)
        db_part = torch.zeros((n_blocks, N_TOKENS, mp), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.k2_loglik_and_grads(
            a.data_ptr(), bt.data_ptr(), al0.data_ptr(), ll0.data_ptr(),
            tokens.data_ptr(),
            None if beta_in is None else beta_in.data_ptr(),
            chk.data_ptr(), ll.data_ptr(),
            beta0.data_ptr(), da_part.data_ptr(), db_part.data_ptr(),
            w, t_len, m, stream)
        if rc != 0:
            raise RuntimeError("K2 launch failed: "
                               f"{lib.k2_error_string(rc).decode()} ({rc})")
        loglik_and_grads_fused.calls += 1
        grads = _grads(da_part.sum(dim=0)[:m, :m], db_part.sum(dim=0)[:, :m],
                       beta0[:, :m], pi, tokens, al0, col0)
    return ll.sum(), grads


# K2 calls since the last reset to 0; each call launches two kernels
loglik_and_grads_fused.calls = 0
