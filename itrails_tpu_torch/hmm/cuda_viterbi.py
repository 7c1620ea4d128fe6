"""Kernel K3: Viterbi decoding on the card, its wrapper, its plain PyTorch
version and its build.

K3 (``csrc/viterbi.cu``) replaces the Pallas TPU kernel
``itrails_tpu/hmm/pallas_viterbi.py:299 viterbi_fused``.  It computes what
``itrails_tpu/hmm/decoders.py:220 viterbi`` computes, operation for
operation: log-probabilities clamped at ``NEG`` (never -inf), omega
rescaled by its per-window max every step, the argmax over the
pre-emission scores with the first index winning ties, and a padded step
that keeps omega and writes the identity pointer, so padded steps repeat
the last state.  The source note in ``viterbi.cu`` states what bounds it
and what its design does about that.

The log tables and column 0 are made here, in torch, once, and the same
tensors go to the kernel and to :func:`viterbi_fused_plain`; every later
operation is an exact f32 add, compare or subtract, so on the same inputs
the two take the same decisions, ties included.

:func:`viterbi_fused` launches K3 for tensors on a CUDA device and runs
the plain version only for tensors on the CPU; a CUDA input that the
kernel does not take raises.  It takes an entry omega in place of column
0 and a final state in place of the argmax, which the segmented route
(``hmm/decoders.py:viterbi_segmented``) needs.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first use
(``hmm/_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from itrails_tpu_torch.data.tokens import N_TOKENS, PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library
from itrails_tpu_torch.hmm.cuda_fwd import check_inputs, check_state

__all__ = ["NEG", "POINTER_BUDGET_BYTES", "build", "column0", "log_tables",
           "viterbi_fused", "viterbi_fused_plain", "window_group"]

_SRC = CSRC / "viterbi.cu"
NEG = -1e4  # "impossible" log-probability: max-plus sums stay finite
# Bytes of one window group's pointer table on the card (W_g x (T-1) x M
# uint8); a single window above it takes a table of its own.
POINTER_BUDGET_BYTES = 1 << 30
_lib = None


def build():
    """Compile ``csrc/viterbi.cu`` unless this source was built before; see
    :func:`itrails_tpu_torch.hmm._build.compile_library`."""
    return compile_library(_SRC, "libk3_viterbi", BUILD_DIR, "kernel K3")


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.k3_viterbi.restype = ctypes.c_int
        lib.k3_viterbi.argtypes = ([ctypes.c_void_p] * 8
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.k3_table_width.restype = ctypes.c_int
        lib.k3_table_width.argtypes = [ctypes.c_int]
        lib.k3_max_states.restype = ctypes.c_int
        lib.k3_max_states.argtypes = []
        lib.k3_error_string.restype = ctypes.c_char_p
        lib.k3_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _log_clip(x):
    """``max(log(max(x, 0)), NEG)`` in the dtype of ``x``.  The log is
    taken in f64 and rounded once, so an f32 table has the same bits on
    the card and on the CPU, whose f32 logs may differ in the last place."""
    return torch.log(x.double().clamp(min=0)).clamp(min=NEG).to(x.dtype)


def log_tables(a, bfull, pi):
    """``(log_a (M, M), log_bt (625, M), log_pi (M,))``, clamped at NEG, in
    the dtype of the inputs."""
    return _log_clip(a), _log_clip(bfull).T.contiguous(), _log_clip(pi)


def _log_emission(log_bt, tok):
    """Rows ``log_bt[tok]`` of a (W,) token vector: 0 for PAD, the clamped
    row for a token outside the alphabet (the JAX gather's rule)."""
    e = log_bt[tok.long().clamp(0, N_TOKENS - 1)]
    return torch.where((tok == PAD_TOKEN)[:, None], torch.zeros_like(e), e)


def column0(log_bt, log_pi, tok0):
    """Omega after column 0, (W, M): ``log pi + log e(tok0)``, rescaled by
    its per-window max (pallas_viterbi.py:347-351)."""
    om = log_pi[None, :] + _log_emission(log_bt, tok0)
    return om - om.max(dim=1, keepdim=True).values


def viterbi_fused_plain(log_a, log_bt, omega0, tokens, last=None):
    """K3's function in plain PyTorch, in the dtype of the tables.

    Args:
      log_a, log_bt: the tables of :func:`log_tables`.
      omega0: (W, M) omega after column 0 (:func:`column0`).
      tokens: (W, T) integer tokens; column 0 is not read.
      last: optional (W,) final states; default argmax of the final omega.

    Returns ``(path (W, T) int32, omega (W, M))``, the final omega.  The CPU
    path and the reference K3 is held against on the card."""
    w, t_len = tokens.shape
    m = log_a.shape[0]
    dev = tokens.device
    ptr_dtype = torch.uint8 if m <= 255 else torch.int32
    ptrs = torch.empty((max(t_len - 1, 0), w, m), dtype=ptr_dtype, device=dev)
    ident = torch.arange(m, device=dev)[None, :]
    rows = tokens.long().clamp(0, N_TOKENS - 1)
    is_pad = (tokens == PAD_TOKEN)[:, :, None]
    omega = omega0
    for t in range(1, t_len):
        best, arg = (omega[:, :, None] + log_a[None, :, :]).max(dim=1)
        new = best + log_bt[rows[:, t]]  # a PAD row's value is not kept
        new = new - new.max(dim=1, keepdim=True).values
        omega = torch.where(is_pad[:, t], omega, new)
        ptrs[t - 1] = torch.where(is_pad[:, t], ident, arg)
    state = (omega.argmax(dim=1) if last is None else last.long())[:, None]
    path = torch.empty((w, t_len), dtype=torch.int32, device=dev)
    path[:, -1] = state[:, 0]
    for t in range(t_len - 1, 0, -1):
        state = ptrs[t - 1].gather(1, state).long()
        path[:, t - 1] = state[:, 0]
    return path, omega


def window_group(t_len: int, m: int) -> int:
    """Windows per launch group: as many as keep the group's pointer table
    within POINTER_BUDGET_BYTES, at least one."""
    return max(1, POINTER_BUDGET_BYTES // max(1, (t_len - 1) * m))


def viterbi_fused(a, bfull, pi, tokens, omega0=None, last=None):
    """Most-probable state path per window, the contract of
    ``itrails_tpu.hmm.pallas_viterbi.viterbi_fused``.

    Args:
      a: (M, M) transition matrix; bfull: (M, 625) emission table;
        pi: (M,) initial distribution.
      tokens: (W, T) integer tokens, right-padded with PAD_TOKEN.
      omega0: optional (W, M) omega after column 0, in place of
        ``pi`` and token 0 (which is then not read).
      last: optional (W,) int32 final states, in place of the argmax of
        the final omega; each must lie in [0, M).

    Returns ``(path, omega)``: path (W, T) int32, in which padded steps
    repeat the last real state, and the final rescaled omega (W, M).  On
    CUDA the tables must be contiguous float32, the tokens int32, and
    M <= 255; on the CPU the plain version runs in the dtype of ``a``.
    """
    if tokens.device.type == "cpu":
        log_a, log_bt, log_pi = log_tables(a, bfull, pi)
        om0 = column0(log_bt, log_pi, tokens[:, 0]) if omega0 is None else omega0
        return viterbi_fused_plain(log_a, log_bt, om0, tokens, last)
    if tokens.device.type != "cuda":
        raise ValueError(f"viterbi_fused: unsupported device {tokens.device}")
    lib = _library()
    check_inputs("viterbi_fused", a, bfull, pi, tokens, lib.k3_max_states())
    dev = tokens.device
    w, t_len = tokens.shape
    m = a.shape[0]
    if omega0 is not None:
        check_state("viterbi_fused", "omega0", omega0, (w, m), torch.float32, dev)
    if last is not None:
        check_state("viterbi_fused", "last", last, (w,), torch.int32, dev)
        if bool(((last < 0) | (last >= m)).any()):  # the kernel indexes by it
            raise ValueError(f"viterbi_fused: last must lie in [0, {m})")

    with torch.cuda.device(dev):
        log_a, log_bt, log_pi = log_tables(a, bfull, pi)
        om0 = (column0(log_bt, log_pi, tokens[:, 0]).contiguous()
               if omega0 is None else omega0)
        mp = lib.k3_table_width(m)
        la = torch.full((m, mp), NEG, dtype=torch.float32, device=dev)
        la[:, :m] = log_a
        lbt = torch.zeros((N_TOKENS, mp), dtype=torch.float32, device=dev)
        lbt[:, :m] = log_bt
        path = torch.empty((w, t_len), dtype=torch.int32, device=dev)
        omega = torch.empty((w, m), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        group = window_group(t_len, m)
        for g0 in range(0, w, group):
            g1 = min(w, g0 + group)
            ptr = torch.empty((g1 - g0) * (t_len - 1) * m, dtype=torch.uint8,
                              device=dev)
            rc = lib.k3_viterbi(
                la.data_ptr(), lbt.data_ptr(), om0[g0:g1].data_ptr(),
                tokens[g0:g1].data_ptr(),
                None if last is None else last[g0:g1].data_ptr(),
                ptr.data_ptr(), omega[g0:g1].data_ptr(), path[g0:g1].data_ptr(),
                g1 - g0, t_len, m, stream)
            if rc != 0:
                raise RuntimeError("K3 launch failed: "
                                   f"{lib.k3_error_string(rc).decode()} ({rc})")
            viterbi_fused.launches += 2  # the forward and the backtrack
            del ptr  # the next group's table reuses it, in stream order
    viterbi_fused.calls += 1
    return path, omega


viterbi_fused.calls = 0  # calls that launched K3, since the last reset to 0
viterbi_fused.launches = 0  # K3's kernel launches, since the last reset to 0
