"""Kernel K1: the fused forward log-likelihood on the card, its wrapper, its
plain PyTorch version and its build.

K1 (``csrc/fwd.cu``) replaces the Pallas TPU kernel
``itrails_tpu/hmm/pallas_fwd.py:327 forward_fused``.  It computes the
Rabiner-scaled linear forward recurrence over a (W, T) token batch in f32:
exact table lookups and a full-f32 transition product.  The source note in
``fwd.cu`` states what bounds it and what its design does about that.

:func:`forward_fused` launches K1 for tensors on a CUDA device and runs
:func:`forward_fused_plain`, the same function in plain PyTorch, only for
tensors on the CPU.  It never moves a CUDA tensor to the plain version: a
CUDA input that the kernel does not take raises.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first use
(``hmm/_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from itrails_tpu_torch.data.tokens import N_TOKENS, PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library

__all__ = ["build", "check_inputs", "column0", "emission_rows",
           "forward_fused", "forward_fused_plain", "forward_loglik_fused"]

_SRC = CSRC / "fwd.cu"
_lib = None


def build():
    """Compile ``csrc/fwd.cu`` unless this source was built before; see
    :func:`itrails_tpu_torch.hmm._build.compile_library`."""
    return compile_library(_SRC, "libk1_fwd", BUILD_DIR, "kernel K1")


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.k1_forward.restype = ctypes.c_int
        lib.k1_forward.argtypes = ([ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.k1_table_width.restype = ctypes.c_int
        lib.k1_table_width.argtypes = [ctypes.c_int]
        lib.k1_max_states.restype = ctypes.c_int
        lib.k1_max_states.argtypes = []
        lib.k1_error_string.restype = ctypes.c_char_p
        lib.k1_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def emission_rows(bt, tok):
    """Rows ``bt[tok]`` of a (625, M) table for a (W,) token vector: ones
    for PAD (a no-op step) and zeros for a token outside the alphabet (the
    kernel's contract: such a window's loglik is not finite).  Every
    decoder of the port reads its emissions through this one rule."""
    tok = tok.long()
    rows = bt[tok.clamp(0, N_TOKENS - 1)]
    valid = ((tok >= 0) & (tok < N_TOKENS))[:, None]
    pad = (tok == PAD_TOKEN)[:, None]
    return torch.where(valid, rows, pad.to(rows.dtype))


def column0(bfull, pi, tok0):
    """Column 0, outside the kernels as in pallas_fwd.py:368-378 and
    pallas_grad.py:225-236: its emission rows e0 (W, M), the normalized
    ``pi * e0`` and its normalizer s0 (W,)."""
    e0 = emission_rows(bfull.T, tok0)
    al0 = pi[None, :] * e0
    s0 = al0.sum(dim=1)
    return e0, al0 / s0[:, None], s0


def check_inputs(name, a, bfull, pi, tokens, max_states):
    """Raise unless the tables and tokens are what a kernel takes: a (W, T)
    int32 token batch and float32 tables a (M, M), bfull (M, 625), pi (M,)
    with 1 <= M <= ``max_states``, all contiguous on the tokens' device."""
    dev = tokens.device
    if tokens.dim() != 2 or tokens.dtype != torch.int32:
        raise ValueError(f"{name}: tokens must be a (W, T) int32 tensor, "
                         f"got {tuple(tokens.shape)} {tokens.dtype}")
    m = a.shape[0]
    expect = {"a": (a, (m, m)), "bfull": (bfull, (m, N_TOKENS)),
              "pi": (pi, (m,))}
    for label, (x, shape) in expect.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be float32 on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {label} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not tokens.is_contiguous():
        raise ValueError(f"{name}: tokens must be contiguous")
    if not 1 <= m <= max_states:
        raise ValueError(f"{name}: the kernel takes 1..{max_states} states, "
                         f"got {m}")
    if tokens.shape[0] == 0 or tokens.shape[1] == 0:
        raise ValueError(f"{name}: empty token batch")


def forward_fused_plain(a, bfull, pi, tokens):
    """:func:`forward_fused` in plain PyTorch, in the dtype of ``a``: one
    (W, M) @ (M, M) product per column.  The CPU path and the reference the
    kernel is held against on the card."""
    bt = bfull.T
    _, al, s0 = column0(bfull, pi, tokens[:, 0])
    ll = torch.log(s0)
    for t in range(1, tokens.shape[1]):
        tok = tokens[:, t]
        nx = (al @ a) * emission_rows(bt, tok)
        s = nx.sum(dim=1)
        pad = tok == PAD_TOKEN
        al = torch.where(pad[:, None], al, nx / s[:, None])
        ll = ll + torch.where(pad, torch.zeros_like(s), torch.log(s))
    return al, ll


def forward_fused(a, bfull, pi, tokens):
    """Scaled-linear forward pass over a (W, T) token batch.

    Args:
      a: (M, M) row-stochastic transition matrix.
      bfull: (M, 625) emission table over the full alphabet.
      pi: (M,) initial distribution.
      tokens: (W, T) integer tokens, right-padded with PAD_TOKEN.

    Returns ``(alpha, loglik)``: alpha (W, M), the normalized final state
    distribution, and loglik (W,), the per-window log-likelihoods;
    ``log(alpha) + loglik[:, None]`` is the log-space alpha of
    ``decoders.forward``.  On CUDA the inputs must be contiguous float32
    (int32 tokens) and the result is float32; on the CPU the plain version
    runs in the dtype of ``a``.
    """
    if tokens.device.type == "cpu":
        return forward_fused_plain(a, bfull, pi, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"forward_fused: unsupported device {tokens.device}")
    lib = _library()
    check_inputs("forward_fused", a, bfull, pi, tokens, lib.k1_max_states())
    dev = tokens.device
    w, t_len = tokens.shape
    m = a.shape[0]

    with torch.cuda.device(dev):
        _, al0, s0 = column0(bfull, pi, tokens[:, 0])
        al0, ll0 = al0.contiguous(), torch.log(s0)
        bt = torch.zeros((N_TOKENS, lib.k1_table_width(m)),
                         dtype=torch.float32, device=dev)
        bt[:, :m] = bfull.T
        alpha = torch.empty((w, m), dtype=torch.float32, device=dev)
        ll = torch.empty((w,), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.k1_forward(a.data_ptr(), bt.data_ptr(), al0.data_ptr(),
                            ll0.data_ptr(), tokens.data_ptr(),
                            alpha.data_ptr(), ll.data_ptr(), w, t_len, m,
                            stream)
        if rc != 0:
            raise RuntimeError("K1 launch failed: "
                               f"{lib.k1_error_string(rc).decode()} ({rc})")
        forward_fused.launches += 1
    return alpha, ll


forward_fused.launches = 0  # K1 launches since the last reset to 0


def forward_loglik_fused(a, bfull, pi, tokens):
    """Total log-likelihood of a (W, T) token batch.  The per-window values
    are summed in f64: a genome-scale total is ~1e6 nats where one f32 ULP
    is 0.125, coarse enough to hide a short optimizer step's improvement."""
    _, ll = forward_fused(a, bfull, pi, tokens)
    return ll.to(torch.float64).sum()
