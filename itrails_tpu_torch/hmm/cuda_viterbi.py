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

K3's kernels are entry points of their own, each with its own wrapper,
launch count and plain version; :func:`viterbi_fused` runs each window
group through the first and the last of them, and a long block's route
(``hmm/longseq.py:viterbi_long``) through all four:
:func:`viterbi_forward` (the pointer table and the final omega of a
batch of chunk windows, each entered through its own omega),
:func:`entry_map` (for every window and exit state, the state at the
window's column 0), :func:`chain` (every window's exit state from the
last one's, through the maps) and :func:`viterbi_backtrack` (each window's
path from its exit state).  Pointer tables are (W, T-1, M), uint8 on the
card, on the CPU too up to 255 states.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first use
(``hmm/_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from itrails_tpu_torch.data.tokens import N_TOKENS, PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library
from itrails_tpu_torch.hmm.cuda_fwd import check_inputs, check_state

__all__ = ["NEG", "POINTER_BUDGET_BYTES", "build", "chain", "chain_plain",
           "check_log_tables", "column0", "entry_map", "entry_map_plain",
           "log_tables", "padded_log_tables", "viterbi_backtrack",
           "viterbi_backtrack_plain", "viterbi_forward",
           "viterbi_forward_plain", "viterbi_fused", "viterbi_fused_plain",
           "window_group"]

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
        ptr, num = ctypes.c_void_p, ctypes.c_int
        for name, args in (
                ("k3_forward", [ptr] * 6 + [num] * 3 + [ptr]),
                ("k3_backtrack", [ptr] * 4 + [num] * 3 + [ptr]),
                ("k3_entry_map", [ptr] * 2 + [num] * 3 + [ptr]),
                ("k3_chain", [ptr] * 4 + [num] * 2 + [ptr])):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = args
        lib.k3_max_states.restype = ctypes.c_int
        lib.k3_max_states.argtypes = []
        lib.k3_error_string.restype = ctypes.c_char_p
        lib.k3_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _raise_on(rc, lib):
    if rc != 0:
        raise RuntimeError("K3 launch failed: "
                           f"{lib.k3_error_string(rc).decode()} ({rc})")


def _log_clip(x):
    """``max(log(max(x, 0)), NEG)`` in the dtype of ``x``.  The log is
    taken in f64 and rounded once, so an f32 table has the same bits on
    the card and on the CPU, whose f32 logs may differ in the last place."""
    return torch.log(x.double().clamp(min=0)).clamp(min=NEG).to(x.dtype)


def log_tables(a, bfull, pi):
    """``(log_a (M, M), log_bt (625, M), log_pi (M,))``, clamped at NEG, in
    the dtype of the inputs."""
    return _log_clip(a), _log_clip(bfull).T.contiguous(), _log_clip(pi)


def padded_log_tables(log_a, log_bt):
    """The layout K3 and K6 read: ``log_a`` (M, 32S) padded with NEG and
    ``log_bt`` (625, 32S) padded with 0, float32, for S = ceil(M / 32)."""
    m = log_a.shape[0]
    mp = 32 * -(-m // 32)
    la = torch.full((m, mp), NEG, dtype=torch.float32, device=log_a.device)
    la[:, :m] = log_a
    lbt = torch.zeros((N_TOKENS, mp), dtype=torch.float32, device=log_a.device)
    lbt[:, :m] = log_bt
    return la, lbt


def check_log_tables(name, log_a, log_bt, tokens, max_states):
    """Raise unless the log tables and the (W, T) tokens are what a kernel
    of the max-plus recursion takes: float32 ``log_a`` (M, M) and
    ``log_bt`` (625, M), int32 tokens, all contiguous on one CUDA device,
    1 <= M <= ``max_states``."""
    dev = tokens.device
    m = log_a.shape[0]
    if not 1 <= m <= max_states:
        raise ValueError(f"{name}: M={m} states, the kernel takes 1 to "
                         f"{max_states}")
    check_state(name, "log_a", log_a, (m, m), torch.float32, dev)
    check_state(name, "log_bt", log_bt, (N_TOKENS, m), torch.float32, dev)
    if tokens.dim() != 2 or tokens.dtype != torch.int32 \
            or not tokens.is_contiguous():
        raise ValueError(f"{name}: tokens must be a contiguous (W, T) int32 "
                         f"tensor, got {tuple(tokens.shape)} {tokens.dtype}")


def _on_cuda(name, x):
    """True for a CUDA tensor, False for a CPU one; raises on another
    device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


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


def viterbi_forward_plain(log_a, log_bt, omega0, tokens):
    """K3's forward in plain PyTorch, in the dtype of the tables.

    Args:
      log_a, log_bt: the tables of :func:`log_tables`.
      omega0: (W, M) omega after column 0 (:func:`column0`).
      tokens: (W, T) integer tokens; column 0 is not read.

    Returns ``(ptrs (W, T-1, M), omega (W, M))``: the pointers (uint8, int32
    above 255 states; a PAD column's is the identity) and the final
    rescaled omega."""
    w, t_len = tokens.shape
    m = log_a.shape[0]
    dev = tokens.device
    ptr_dtype = torch.uint8 if m <= 255 else torch.int32
    ptrs = torch.empty((w, max(t_len - 1, 0), m), dtype=ptr_dtype, device=dev)
    ident = torch.arange(m, device=dev)[None, :]
    rows = tokens.long().clamp(0, N_TOKENS - 1)
    is_pad = (tokens == PAD_TOKEN)[:, :, None]
    omega = omega0
    for t in range(1, t_len):
        best, arg = (omega[:, :, None] + log_a[None, :, :]).max(dim=1)
        new = best + log_bt[rows[:, t]]  # a PAD row's value is not kept
        new = new - new.max(dim=1, keepdim=True).values
        omega = torch.where(is_pad[:, t], omega, new)
        ptrs[:, t - 1] = torch.where(is_pad[:, t], ident, arg)
    return ptrs, omega


def viterbi_backtrack_plain(ptrs, omega, last=None):
    """K3's backtrack in plain PyTorch: the (W, T) int32 path of each window
    of a (W, T-1, M) pointer table, from ``last`` (W,) or, by default, the
    argmax of the final omega (W, M), first index on ties."""
    w, n, _ = ptrs.shape
    state = (omega.argmax(dim=1) if last is None else last.long())[:, None]
    path = torch.empty((w, n + 1), dtype=torch.int32, device=ptrs.device)
    path[:, -1] = state[:, 0]
    for t in range(n, 0, -1):
        state = ptrs[:, t - 1].gather(1, state).long()
        path[:, t - 1] = state[:, 0]
    return path


def entry_map_plain(ptrs):
    """The entry map in plain PyTorch: (W, M) int32, entry ``[w, s]`` the
    state at column 0 of window w on the path that leaves it in state s,
    walked back through the (W, T-1, M) pointer table."""
    w, n, m = ptrs.shape
    state = torch.arange(m, device=ptrs.device).expand(w, m)
    for t in range(n, 0, -1):
        state = ptrs[:, t - 1].gather(1, state).long()
    return state.to(torch.int32)


def chain_plain(maps, omega_last=None, start=None):
    """The chain in plain PyTorch: (W + 1,) int32 states, ``states[W]`` the
    last window's exit state (``start[0]``, or the argmax of
    ``omega_last`` (M,), first index on ties) and ``states[w] =
    maps[w, states[w + 1]]``: window w's state at column 0, which is window
    w-1's exit state."""
    w = maps.shape[0]
    s = int(omega_last.argmax() if start is None else start[0])
    rows = maps.tolist()
    states = [0] * (w + 1)
    states[w] = s
    for i in range(w - 1, -1, -1):
        s = rows[i][s]
        states[i] = s
    return torch.tensor(states, dtype=torch.int32, device=maps.device)


def viterbi_fused_plain(log_a, log_bt, omega0, tokens, last=None):
    """K3's function in plain PyTorch, in the dtype of the tables: its
    forward (:func:`viterbi_forward_plain`), then its backtrack
    (:func:`viterbi_backtrack_plain`) from ``last`` (W,), by default the
    argmax of the final omega.

    Returns ``(path (W, T) int32, omega (W, M))``, the final omega.  The CPU
    path and the reference K3 is held against on the card."""
    ptrs, omega = viterbi_forward_plain(log_a, log_bt, omega0, tokens)
    return viterbi_backtrack_plain(ptrs, omega, last), omega


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
    if not _on_cuda("viterbi_fused", tokens):
        log_a, log_bt, log_pi = log_tables(a, bfull, pi)
        om0 = column0(log_bt, log_pi, tokens[:, 0]) if omega0 is None else omega0
        return viterbi_fused_plain(log_a, log_bt, om0, tokens, last)
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
        path = torch.empty((w, t_len), dtype=torch.int32, device=dev)
        omega = torch.empty((w, m), dtype=torch.float32, device=dev)
        group = window_group(t_len, m)
        for g0 in range(0, w, group):
            g1 = min(w, g0 + group)
            ptrs, omega[g0:g1] = viterbi_forward(log_a, log_bt, om0[g0:g1],
                                                 tokens[g0:g1])
            path[g0:g1] = viterbi_backtrack(
                ptrs, omega[g0:g1], None if last is None else last[g0:g1])
            del ptrs  # the next group's table reuses it, in stream order
    viterbi_fused.calls += 1
    return path, omega


viterbi_fused.calls = 0  # calls that launched K3, since the last reset to 0


def viterbi_forward(log_a, log_bt, omega0, tokens):
    """K3's forward alone on a (W, T) window batch, each window entered
    through its own omega: ``(ptrs (W, T-1, M) uint8, omega (W, M))``, the
    contract of :func:`viterbi_forward_plain`, which runs for tensors on
    the CPU.  On CUDA the kernel takes the float32 tables of
    :func:`check_log_tables`, a contiguous float32 ``omega0`` (W, M) and
    M <= 255; one launch, whose pointer table the caller sizes."""
    if not _on_cuda("viterbi_forward", tokens):
        return viterbi_forward_plain(log_a, log_bt, omega0, tokens)
    lib = _library()
    check_log_tables("viterbi_forward", log_a, log_bt, tokens,
                     lib.k3_max_states())
    dev = tokens.device
    w, t_len = tokens.shape
    m = log_a.shape[0]
    check_state("viterbi_forward", "omega0", omega0, (w, m), torch.float32, dev)
    with torch.cuda.device(dev):
        la, lbt = padded_log_tables(log_a, log_bt)
        ptrs = torch.empty((w, t_len - 1, m), dtype=torch.uint8, device=dev)
        omega = torch.empty((w, m), dtype=torch.float32, device=dev)
        _raise_on(lib.k3_forward(
            la.data_ptr(), lbt.data_ptr(), omega0.data_ptr(),
            tokens.data_ptr(), ptrs.data_ptr(), omega.data_ptr(), w, t_len, m,
            torch.cuda.current_stream(dev).cuda_stream), lib)
    viterbi_forward.launches += 1
    return ptrs, omega


viterbi_forward.launches = 0  # launches since the last reset to 0


def _check_pointers(name, ptrs, max_states):
    if ptrs.dim() != 3 or ptrs.dtype != torch.uint8 or not ptrs.is_contiguous():
        raise ValueError(f"{name}: pointers must be a contiguous (W, T-1, M) "
                         f"uint8 tensor, got {tuple(ptrs.shape)} {ptrs.dtype}")
    w, _, m = ptrs.shape
    if w < 1 or not 1 <= m <= max_states:
        raise ValueError(f"{name}: {w} windows of {m} states, the kernel "
                         f"takes W >= 1 and 1 <= M <= {max_states}")


def viterbi_backtrack(ptrs, omega, last=None):
    """K3's backtrack alone: the (W, T) int32 path of each window of a
    forward's pointer table (W, T-1, M), from ``last`` (W,) int32, or by
    default the argmax of ``omega`` (W, M); the contract of
    :func:`viterbi_backtrack_plain`, which runs for tensors on the CPU.
    ``last`` is not checked against M on the card (the route hands the
    chain's states over without a synchronisation)."""
    if not _on_cuda("viterbi_backtrack", ptrs):
        return viterbi_backtrack_plain(ptrs, omega, last)
    lib = _library()
    _check_pointers("viterbi_backtrack", ptrs, lib.k3_max_states())
    dev = ptrs.device
    w, n, m = ptrs.shape
    check_state("viterbi_backtrack", "omega", omega, (w, m), torch.float32, dev)
    if last is not None:
        check_state("viterbi_backtrack", "last", last, (w,), torch.int32, dev)
    with torch.cuda.device(dev):
        path = torch.empty((w, n + 1), dtype=torch.int32, device=dev)
        _raise_on(lib.k3_backtrack(
            ptrs.data_ptr(), omega.data_ptr(),
            None if last is None else last.data_ptr(), path.data_ptr(), w,
            n + 1, m, torch.cuda.current_stream(dev).cuda_stream), lib)
    viterbi_backtrack.launches += 1
    return path


viterbi_backtrack.launches = 0  # launches since the last reset to 0


def entry_map(ptrs):
    """The entry map of a forward's pointer table (W, T-1, M): (W, M) int32,
    the contract of :func:`entry_map_plain`, which runs for tensors on the
    CPU; on CUDA one thread a (window, exit state)."""
    if not _on_cuda("entry_map", ptrs):
        return entry_map_plain(ptrs)
    lib = _library()
    _check_pointers("entry_map", ptrs, lib.k3_max_states())
    dev = ptrs.device
    w, n, m = ptrs.shape
    with torch.cuda.device(dev):
        maps = torch.empty((w, m), dtype=torch.int32, device=dev)
        _raise_on(lib.k3_entry_map(
            ptrs.data_ptr(), maps.data_ptr(), w, n + 1, m,
            torch.cuda.current_stream(dev).cuda_stream), lib)
    entry_map.launches += 1
    return maps


entry_map.launches = 0  # launches since the last reset to 0


def chain(maps, omega_last, start=None):
    """Every window's exit state from the last one's: (W + 1,) int32, the
    contract of :func:`chain_plain`, which runs for tensors on the CPU.
    ``maps`` (W, M) int32 from :func:`entry_map`; ``omega_last`` (M,) the
    last window's final omega, whose argmax is its exit state unless
    ``start`` (1,) int32 gives it.  On CUDA one thread walks the W maps,
    and nothing goes to the host."""
    if not _on_cuda("chain", maps):
        return chain_plain(maps, omega_last, start)
    lib = _library()
    dev = maps.device
    if maps.dim() != 2:
        raise ValueError(f"chain: maps must be (W, M), got {tuple(maps.shape)}")
    w, m = maps.shape
    check_state("chain", "maps", maps, (w, m), torch.int32, dev)
    check_state("chain", "omega_last", omega_last, (m,), torch.float32, dev)
    if start is not None:
        check_state("chain", "start", start, (1,), torch.int32, dev)
    with torch.cuda.device(dev):
        states = torch.empty((w + 1,), dtype=torch.int32, device=dev)
        _raise_on(lib.k3_chain(
            maps.data_ptr(), omega_last.data_ptr(),
            None if start is None else start.data_ptr(), states.data_ptr(), w,
            m, torch.cuda.current_stream(dev).cuda_stream), lib)
    chain.launches += 1
    return states


chain.launches = 0  # launches since the last reset to 0
