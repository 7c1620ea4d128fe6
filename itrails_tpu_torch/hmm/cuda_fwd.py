"""Kernel K1: the fused forward log-likelihood on the card, its wrapper, its
plain PyTorch versions and its build.

K1 (``csrc/fwd.cu``) replaces the Pallas TPU kernel
``itrails_tpu/hmm/pallas_fwd.py:327 forward_fused``.  Its contract is
:func:`forward_fused_plain`: the Rabiner-scaled linear forward recurrence
over a (W, T) token batch in the tables' dtype, float32 or float64.  The
kernel computes every window as a row with its own power-of-two scale
(the row kernels of ``csrc/rows.cuh``, which K5 runs too), started from
column 0's alpha before its normalization: :func:`forward_rows_plain`
(through :func:`scaled_rows`) is its plain version, and
:func:`fold_forward` folds rows and exponent sums into the contract in
f64.  f32 runs on the FMA pipes, f64 on the FP64 tensor cores.  The source
note in ``fwd.cu`` states what bounds K1 and what its design does about
that.

:func:`forward_fused` launches K1 for tensors on a CUDA device and runs
:func:`forward_fused_plain` only for tensors on the CPU.  It never moves a
CUDA tensor to the plain version: a CUDA input that the kernel does not
take raises.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first use
(``hmm/_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from itrails_tpu_torch.data.tokens import N_TOKENS, PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library

__all__ = ["bind_layout", "build", "check_inputs", "check_state", "column0",
           "dmma_fragments", "emission_rows", "fold_forward", "forward_fused",
           "forward_fused_plain", "forward_loglik_fused", "forward_rows_plain",
           "kernel_attributes", "padded_tables", "scaled_rows"]

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
        lib.k1_forward.argtypes = ([ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.k1_attributes.restype = ctypes.c_int
        lib.k1_attributes.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        bind_layout(lib)
        lib.k1_error_string.restype = ctypes.c_char_p
        lib.k1_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def bind_layout(lib):
    """Declares the exports of ``csrc/forward.cuh`` that give the tables'
    layout on the card, which every library that includes it carries:
    ``k1_table_width(M)``, ``k1_a_stride(M, f64)`` and ``k1_max_states()``."""
    lib.k1_table_width.restype = ctypes.c_int
    lib.k1_table_width.argtypes = [ctypes.c_int]
    lib.k1_a_stride.restype = ctypes.c_int
    lib.k1_a_stride.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k1_max_states.restype = ctypes.c_int
    lib.k1_max_states.argtypes = []


def padded_tables(lib, a, bfull, stride):
    """The tables as a kernel reads them: the transposed emission table
    zero-padded to (625, 32S) (``lib.k1_table_width``), and ``a`` itself,
    or, where ``stride`` is not 0, a zero-padded (32S, ``stride``) copy
    that the kernel reads from global memory (L2)."""
    m = a.shape[0]
    width = lib.k1_table_width(m)
    bt = torch.zeros((N_TOKENS, width), dtype=a.dtype, device=a.device)
    bt[:, :m] = bfull.T
    if stride:
        padded = torch.zeros((width, stride), dtype=a.dtype, device=a.device)
        padded[:m, :m] = a
        a = padded
    return a, bt


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


def check_inputs(name, a, bfull, pi, tokens, max_states,
                 dtypes=(torch.float32,)):
    """Raise unless the tables and tokens are what a kernel takes: a (W, T)
    int32 token batch and tables a (M, M), bfull (M, 625), pi (M,) (unless
    it is None: a kernel that does not read it), all of one dtype among
    ``dtypes``, with 1 <= M <= ``max_states``, all contiguous on the
    tokens' device."""
    if a.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name}: the tables must be {names}, got {a.dtype}")
    dtype = a.dtype
    dev = tokens.device
    if tokens.dim() != 2 or tokens.dtype != torch.int32:
        raise ValueError(f"{name}: tokens must be a (W, T) int32 tensor, "
                         f"got {tuple(tokens.shape)} {tokens.dtype}")
    m = a.shape[0]
    expect = {"a": (a, (m, m)), "bfull": (bfull, (m, N_TOKENS))}
    if pi is not None:
        expect["pi"] = (pi, (m,))
    for label, (x, shape) in expect.items():
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: {label} must be "
                             f"{str(dtype).removeprefix('torch.')} on {dev}, "
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


def check_state(kernel, name, x, shape, dtype, dev):
    """Raise unless ``x``, a state a kernel takes in place of one it would
    compute, is a contiguous ``shape`` tensor of ``dtype`` on ``dev``."""
    if x.device != dev or x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype} on {dev}, "
                         f"got {x.dtype} on {x.device}")
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous "
                         f"{shape} tensor, got {tuple(x.shape)}")


def _row_exponents(mx):
    """ilogb of each entry of ``mx`` (>= 0), floored at that of the dtype's
    smallest normal and capped so that 2^-k is normal, read from the bits
    as the row kernels read them; int32."""
    if mx.dtype == torch.float32:
        e = (mx.view(torch.int32) >> 23) & 0xFF
        return (e.clamp(1, 253) - 127).to(torch.int32)
    e = (mx.view(torch.int64) >> 52) & 0x7FF
    return (e.clamp(1, 2045) - 1023).to(torch.int32)


def _pow2_neg(k, dtype):
    """2^-k in ``dtype``, built from the bits (exact)."""
    if dtype == torch.float32:
        return ((127 - k).to(torch.int32) << 23).view(torch.float32)
    return ((1023 - k).to(torch.int64) << 52).view(torch.float64)


def scaled_rows(x0, a, bfull, tokens):
    """Forward rows, each with its own power-of-two scale: the plain version
    of the row kernels of K1 and K5 (``csrc/rows.cuh``), in the dtype of
    ``a``; vectorised over rows, a loop over columns.

    Row r starts from ``x0[r]`` and reads the columns ``tokens[r]`` (an
    (R, L) integer tensor).  A non-PAD column takes ``x <- (x @ a) *
    e(tok)``, then divides x by 2^k, k the exponent of its max (floored at
    the dtype's smallest normal), and adds k to the row's sum; a PAD column
    keeps both, and a token outside the alphabet zeroes the row.  Returns
    ``(x, k)``: the rows (R, M) and the exponent sums (R,) int32."""
    bt = bfull.T
    x = x0
    k = torch.zeros((x0.shape[0],), dtype=torch.int32, device=x0.device)
    for t in range(tokens.shape[1]):
        col = tokens[:, t]
        new = (x @ a) * emission_rows(bt, col)
        kt = _row_exponents(new.amax(dim=1))
        live = col != PAD_TOKEN
        x = torch.where(live[:, None], new * _pow2_neg(kt, a.dtype)[:, None], x)
        k = k + torch.where(live, kt, 0)
    return x, k


def _column0_rows(bfull, pi, tok0):
    """K1's rows' start: column 0's alpha ``pi * e(tok0)`` before its
    normalization (W, M), as :func:`column0` computes it."""
    return pi[None, :] * emission_rows(bfull.T, tok0)


def forward_rows_plain(a, bfull, pi, tokens):
    """K1's kernel in plain PyTorch: every window a row started from column
    0's alpha before its normalization, over columns 1..T-1
    (:func:`scaled_rows`).  Returns ``(x (W, M), k (W,) int32)``, which
    :func:`fold_forward` folds into :func:`forward_fused`'s contract."""
    return scaled_rows(_column0_rows(bfull, pi, tokens[:, 0]), a, bfull,
                       tokens[:, 1:])


def fold_forward(x, k):
    """K1's rows and exponent sums folded into :func:`forward_fused`'s
    contract: with ``s = x.sum(1)`` (in the dtype of ``x``, as
    :func:`column0` sums its normalizer), ``alpha = x / s`` in the dtype of
    ``x`` and ``loglik = ln2 k + log(s)`` in f64.  The rows start from
    column 0's alpha before its normalization, so column 0's log-normalizer
    is inside ``s``, and a window with no live column after column 0
    (``x = pi * e0``, ``k = 0``) folds to column 0's alpha and
    ``log(s0)`` exactly."""
    s = x.sum(dim=1)
    return x / s[:, None], math.log(2.0) * k.double() + torch.log(s.double())


def dmma_fragments(a):
    """``a`` as the f64 row kernels read it: zero-padded to MP = 8 NT
    states and laid out as (NT, NT, 8, 4, 2), entry (j, n, g, t, h) =
    a[8j + 2t + h, 8n + g]: the B fragments of the k steps (j, 0) and
    (j, 1) of the 8-column tile n, one double2 for lane 4g + t
    (``csrc/rows.cuh``)."""
    m = a.shape[0]
    nt = -(-m // 8)
    ap = torch.zeros((8 * nt, 8 * nt), dtype=a.dtype, device=a.device)
    ap[:m, :m] = a
    return ap.view(nt, 4, 2, nt, 8).permute(0, 3, 4, 1, 2).contiguous()


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
    ``decoders.forward``.  On CUDA the tables must be contiguous, all
    float32 or all float64, and the tokens int32; alpha is then in the
    tables' dtype and loglik float64, folded (:func:`fold_forward`) from
    K1's rows and their exact power-of-two exponent sums.  On the CPU the
    plain version runs in the dtype of ``a``.
    """
    if tokens.device.type == "cpu":
        return forward_fused_plain(a, bfull, pi, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"forward_fused: unsupported device {tokens.device}")
    return fold_forward(*_launch_k1_rows(a, bfull, pi, tokens))


forward_fused.launches = 0  # K1 launches since the last reset to 0


def _launch_k1_rows(a, bfull, pi, tokens):
    """Launches K1 on CUDA tensors: ``(x, k)``, :func:`forward_rows_plain`'s
    contract, unfolded.  Every launch adds one to
    ``forward_fused.launches``."""
    lib = _library()
    check_inputs("forward_fused", a, bfull, pi, tokens, lib.k1_max_states(),
                 (torch.float32, torch.float64))
    dev = tokens.device
    w, t_len = tokens.shape
    m = a.shape[0]
    f64 = a.dtype == torch.float64
    with torch.cuda.device(dev):
        x0 = _column0_rows(bfull, pi, tokens[:, 0])
        _, bt = padded_tables(lib, a, bfull, 0)
        a_k = dmma_fragments(a) if f64 else a
        x = torch.empty((w, m), dtype=a.dtype, device=dev)
        k = torch.empty((w,), dtype=torch.int32, device=dev)
        rc = lib.k1_forward(a_k.data_ptr(), bt.data_ptr(), x0.data_ptr(),
                            tokens.data_ptr(), x.data_ptr(), k.data_ptr(), w,
                            t_len, m, int(f64),
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("K1 launch failed: "
                           f"{lib.k1_error_string(rc).decode()} ({rc})")
    forward_fused.launches += 1
    return x, k


def forward_loglik_fused(a, bfull, pi, tokens):
    """Total log-likelihood of a (W, T) token batch.  The per-window values
    are summed in f64: a genome-scale total is ~1e6 nats where one f32 ULP
    is 0.125, coarse enough to hide a short optimizer step's improvement;
    on the card each window's value is already f64 (K1's exponent sum and
    one log, folded in f64)."""
    _, ll = forward_fused(a, bfull, pi, tokens)
    return ll.to(torch.float64).sum()


def kernel_attributes(m: int, f64: bool):
    """What K1 runs at ``m`` states on f32 or f64 tables, on the current
    card: a dict of its registers and local (spill) bytes a thread, its rows
    a warp and its warps a block at most."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    rc = lib.k1_attributes(m, int(f64), out)
    if rc != 0:
        raise RuntimeError(f"K1 attributes: {lib.k1_error_string(rc).decode()}")
    return dict(zip(("registers", "local_bytes", "rows_per_warp",
                     "max_warps"), out))
