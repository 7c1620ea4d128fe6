"""Kernel K4: posterior decoding on the card, its wrapper, its plain PyTorch
version and its build.

K4 (``csrc/posterior.cu``) replaces the Pallas TPU kernel
``itrails_tpu/hmm/pallas_fwd.py:493 posterior_fused``.  It computes that
kernel's recursion, operation for operation, over a (W, T) token batch:

- ``alpha_0 = normalize(pi * e(tok_0))``, where a PAD token's row is ones;
- ``alpha_t = normalize((a^T alpha_{t-1}) * e(tok_t))``;
- ``beta_{T-1} = 1`` and ``beta_{t-1} = normalize(a^T (e(tok_t) * beta_t))``;
- ``gamma_t = normalize(alpha_t * beta_t)``.

``normalize`` divides by the sum; a sum of 0 divides by 1
(pallas_fwd.py:472, :477).  A PAD step keeps alpha and keeps beta, so a
padded step's gamma is garbage, as in the JAX contract: callers slice each
window to its length.  The reverse sweep contracts over the source state,
``a^T x``, as the reference's backward does
(``itrails_tpu/hmm/decoders.py:196-201``): the forward's own operator, not
the textbook ``a x``.  Emission rows follow ``cuda_fwd.emission_rows``, the
port's one PAD/invalid-token rule.

K4 runs in float32 or in float64, the dtype of the tables it is given: the
same kernels instantiated on each scalar.  In both, the two products
``a^T x`` accumulate in f64 and are rounded to the tables' dtype once; the
rest runs in that dtype.  With the products in f32 the port's f32 route on
a long block erred more than the JAX package's f32 route
(``tests/test_torch_posterior_long.py``).  The posterior CLI's default,
``--precision float64``, runs K4 in f64 on the card.

:func:`posterior_fused` launches K4 for tensors on a CUDA device and runs
:func:`posterior_fused_plain` only for tensors on the CPU; a CUDA input
that the kernel does not take raises.  It takes an entry alpha in place of
column 0 and an exit beta in place of the ones, and :func:`beta_sweep` runs
the reverse sweep alone: a long block's chunk route
(``hmm/longseq.py:posterior_long_pieces``) enters and leaves each chunk
window through the first two, and its bounded-memory reference
(``hmm/decoders.py:posterior_segmented``) needs all three.  A call holds
one store, the alpha that the reverse sweep overwrites with gamma: (T, W,
32S) on the card, (T, W, M) in the plain version, in the tables' dtype.  Callers keep it under POSTERIOR_BUDGET_BYTES with
:func:`store_row_bytes` and :func:`window_group`.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first use
(``hmm/_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library
from itrails_tpu_torch.hmm.cuda_fwd import (bind_layout, check_inputs,
                                            check_state, column0,
                                            emission_rows, padded_tables)

__all__ = ["POSTERIOR_BUDGET_BYTES", "beta_sweep", "beta_sweep_plain", "build",
           "posterior_fused", "posterior_fused_plain", "store_row_bytes",
           "window_group"]

_SRC = CSRC / "posterior.cu"
# Bytes of one call's store: on the card 4096 windows of 8192 columns at
# M <= 32 in float32, 2048 in float64.  A long block's chunk windows go in
# groups under it (hmm/longseq.py:posterior_long_pieces).
POSTERIOR_BUDGET_BYTES = 1 << 32
# Columns whose emission rows the plain version gathers at once.
_CHUNK = 1024
_lib = None


def build():
    """Compile ``csrc/posterior.cu`` unless this source was built before;
    see :func:`itrails_tpu_torch.hmm._build.compile_library`."""
    return compile_library(_SRC, "libk4_posterior", BUILD_DIR, "kernel K4")


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.k4_forward.restype = ctypes.c_int
        lib.k4_forward.argtypes = ([ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.k4_reverse.restype = ctypes.c_int
        lib.k4_reverse.argtypes = ([ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        bind_layout(lib)
        lib.k4_max_states.restype = ctypes.c_int
        lib.k4_max_states.argtypes = []
        lib.k4_error_string.restype = ctypes.c_char_p
        lib.k4_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _normalize(x):
    s = x.sum(dim=1, keepdim=True)
    return x / torch.where(s > 0, s, torch.ones_like(s))


def _at_x(x, a64):
    """``x @ a`` (rows of x times the f64 ``a64``) in f64, rounded once to
    the dtype of x: K4's products."""
    return (x.double() @ a64).to(x.dtype)


def _emissions(bt, tokens, lo, hi):
    """Emission rows (hi-lo, W, M) and PAD masks (hi-lo, W, 1) of columns
    lo..hi-1."""
    tok = tokens[:, lo:hi].T
    e = emission_rows(bt, tok.reshape(-1)).view(hi - lo, tokens.shape[0], -1)
    return e, (tok == PAD_TOKEN)[:, :, None]


def _reverse_plain(a, bfull, tokens, store, beta_exit):
    """The reverse sweep: gamma over the alpha ``store`` (T, W, M) in place,
    unless it is None; returns beta at column 0."""
    bt = bfull.T
    a64 = a.double()
    t_len = tokens.shape[1]
    beta = (torch.ones((tokens.shape[0], a.shape[0]), dtype=a.dtype,
                       device=tokens.device)
            if beta_exit is None else beta_exit)
    for hi in range(t_len, 1, -_CHUNK):  # columns lo..hi-1, lo >= 1
        lo = max(1, hi - _CHUNK)
        e, pad = _emissions(bt, tokens, lo, hi)
        for k in range(hi - lo - 1, -1, -1):
            if store is not None:
                store[lo + k] = _normalize(store[lo + k] * beta)
            beta = torch.where(pad[k], beta, _normalize(_at_x(e[k] * beta, a64)))
    if store is not None:
        store[0] = _normalize(store[0] * beta)
    return beta


def posterior_fused_plain(a, bfull, pi, tokens, alpha0=None, beta_exit=None):
    """K4's function in plain PyTorch, in the dtype of ``a`` with the
    products in f64: the CPU path and the reference K4 is held against on
    the card.

    Args:
      a, bfull, pi: the model's (M, M), (M, 625) and (M,) tables.
      tokens: (W, T) integer tokens, right-padded with PAD_TOKEN.
      alpha0: optional (W, M) normalized alpha at column 0, in place of
        ``pi`` and token 0 (which is then not read).
      beta_exit: optional (W, M) beta at column T-1, in place of ones.

    Returns ``(post, alpha)``: the posterior (T, W, M) and the normalized
    alpha (W, M) at column T-1."""
    w, t_len = tokens.shape
    bt = bfull.T
    a64 = a.double()
    store = torch.empty((t_len, w, a.shape[0]), dtype=a.dtype,
                        device=tokens.device)
    al = column0(bfull, pi, tokens[:, 0])[1] if alpha0 is None else alpha0
    store[0] = al
    for lo in range(1, t_len, _CHUNK):
        hi = min(t_len, lo + _CHUNK)
        e, pad = _emissions(bt, tokens, lo, hi)
        for k in range(hi - lo):
            nx = _at_x(al, a64) * e[k]
            al = torch.where(pad[k], al, nx / nx.sum(dim=1, keepdim=True))
            store[lo + k] = al
    alpha = store[-1].clone()
    _reverse_plain(a, bfull, tokens, store, beta_exit)
    return store, alpha


def beta_sweep_plain(a, bfull, tokens, beta_exit=None):
    """:func:`beta_sweep` in plain PyTorch, in the dtype of ``a``."""
    return _reverse_plain(a, bfull, tokens, None, beta_exit)


def store_row_bytes(m: int, device, dtype) -> int:
    """Bytes of the store that one column of one window takes in a call on
    ``device`` with tables of ``dtype``: 32S elements on the card, M in the
    plain version."""
    size = torch.empty((), dtype=dtype).element_size()
    if torch.device(device).type == "cuda":
        return size * 32 * -(-m // 32)
    return m * size


def window_group(t_len: int, row_bytes: int) -> int:
    """Windows of T = ``t_len`` columns per call, for a store of
    ``row_bytes`` a column (:func:`store_row_bytes`): as many as keep it
    within POSTERIOR_BUDGET_BYTES, at least one."""
    return max(1, POSTERIOR_BUDGET_BYTES // max(1, t_len * row_bytes))


def _prepare(name, a, bfull, pi, tokens, beta_exit):
    """Checks the inputs of a launch; returns the library, the matrix a as
    the kernel reads it (in f64 whatever the tables' dtype, a zero-padded
    copy where it reads a from global memory), the padded transposed
    emission table (625, 32S) and the f64 flag of the launch."""
    if tokens.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tokens.device}")
    lib = _library()
    check_inputs(name, a, bfull, pi, tokens, lib.k4_max_states(),
                 (torch.float32, torch.float64))
    m = a.shape[0]
    if beta_exit is not None:
        check_state(name, "beta_exit", beta_exit, (tokens.shape[0], m),
                    a.dtype, tokens.device)
    f64 = int(a.dtype == torch.float64)
    a_k, bt = padded_tables(lib, a, bfull, lib.k1_a_stride(m, 1))
    return lib, a_k.double().contiguous(), bt, f64


def _check_rc(lib, rc):
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: {lib.k4_error_string(rc).decode()} "
                           f"({rc})")


def _ptr(x):
    return None if x is None else x.data_ptr()


def posterior_fused(a, bfull, pi, tokens, alpha0=None, beta_exit=None):
    """Posterior state probabilities, the contract of
    ``itrails_tpu.hmm.pallas_fwd.posterior_fused`` with
    ``layout="twm"``, with an optional entry alpha and exit beta (see
    :func:`posterior_fused_plain`).

    Returns ``(post, alpha)``: post (T, W, M), in which padded steps are
    garbage (mask with ``tokens != PAD_TOKEN``), and the normalized alpha
    (W, M) at column T-1.  On CUDA the inputs must be contiguous float32 or
    float64 tables, all of one dtype, and int32 tokens, with M <= 224; post
    is then a view of the (T, W, 32S) store in that dtype, and the call
    launches K4's two kernels.  On the CPU the plain version runs in the
    dtype of ``a``.
    """
    if tokens.device.type == "cpu":
        return posterior_fused_plain(a, bfull, pi, tokens, alpha0, beta_exit)
    lib, a_k, bt, f64 = _prepare("posterior_fused", a, bfull, pi, tokens,
                                 beta_exit)
    dev = tokens.device
    w, t_len = tokens.shape
    m = a.shape[0]
    if alpha0 is not None:
        check_state("posterior_fused", "alpha0", alpha0, (w, m), a.dtype, dev)

    with torch.cuda.device(dev):
        al0 = (column0(bfull, pi, tokens[:, 0])[1].contiguous()
               if alpha0 is None else alpha0)
        store = torch.empty((t_len, w, bt.shape[1]), dtype=a.dtype, device=dev)
        alpha = torch.empty((w, m), dtype=a.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check_rc(lib, lib.k4_forward(
            a_k.data_ptr(), bt.data_ptr(), al0.data_ptr(), tokens.data_ptr(),
            store.data_ptr(), alpha.data_ptr(), w, t_len, m, f64, stream))
        posterior_fused.launches += 1
        _check_rc(lib, lib.k4_reverse(
            a_k.data_ptr(), bt.data_ptr(), tokens.data_ptr(), _ptr(beta_exit),
            alpha.data_ptr(), store.data_ptr(), None, w, t_len, m, f64,
            stream))
        posterior_fused.launches += 1
    posterior_fused.calls += 1
    return store[:, :, :m], alpha


posterior_fused.calls = 0  # calls that launched K4, since the last reset to 0
posterior_fused.launches = 0  # K4's kernel launches, since the last reset to 0


def beta_sweep(a, bfull, tokens, beta_exit=None):
    """The reverse sweep alone: beta (W, M) at column 0 of each window of a
    (W, T) token batch, from ``beta_exit`` (default ones) at column T-1; no
    alpha and no posterior is made.  On CUDA it launches K4's reverse kernel
    once (counted in ``posterior_fused.launches``); on the CPU the plain
    version runs."""
    if tokens.device.type == "cpu":
        return beta_sweep_plain(a, bfull, tokens, beta_exit)
    lib, a_k, bt, f64 = _prepare("beta_sweep", a, bfull, None, tokens,
                                 beta_exit)
    dev = tokens.device
    w, t_len = tokens.shape
    with torch.cuda.device(dev):
        beta0 = torch.empty((w, a.shape[0]), dtype=a.dtype, device=dev)
        _check_rc(lib, lib.k4_reverse(
            a_k.data_ptr(), bt.data_ptr(), tokens.data_ptr(), _ptr(beta_exit),
            None, None, beta0.data_ptr(), w, t_len, a.shape[0], f64,
            torch.cuda.current_stream(dev).cuda_stream))
        posterior_fused.launches += 1
    return beta0
