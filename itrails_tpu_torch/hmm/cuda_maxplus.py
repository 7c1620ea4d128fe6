"""Kernel K6: the max-plus chunk operators of one long block and the scan
of omega at every chunk's entry, on the card; their wrappers, their plain
PyTorch versions and their build.

K6 (``csrc/maxplus.cu``) replaces no Pallas kernel: the JAX package's
Viterbi route (``itrails_tpu/hmm/longseq.py:298 viterbi_long``) builds its
operators with XLA ops (``mp_matmul`` and ``op_step``, :328-342) and scans
them with ``lax.associative_scan`` (:344-346).  The port's route
(``hmm/longseq.py:viterbi_long``) runs K3's clamped and rescaled recursion
instead (``hmm/cuda_viterbi.py``), so these operators are K3's forward:
row i of chunk c's operator is the forward over the chunk's columns from
the unit omega (0 at i, NEG elsewhere), rescaled by its max every column,
kept as the rescaled row ``g`` (float32 on the card) and the sum of the
rescale offsets ``off`` in f64.  ``R_c[i, j] = g[c, i, j] + off[c, i]``.

The scan reads omega at every chunk's entry from them, in f64, one chunk
after another: ``omega_{c+1}[j] = max_i (omega_c[i] + off_c[i]) +
g_c[i, j]``, rescaled by its max; each entry goes to K3 in the tables'
dtype.  On the card one block walks the chunks.

Each wrapper launches its kernel for tensors on a CUDA device and runs the
plain version only for tensors on the CPU; a CUDA input that the kernel
does not take raises.  The plain versions take the same operations in the
same order (max is exact in any order; each sum has one order), so the
card's operators and entries equal theirs bit for bit.  The kernels are
compiled with ``nvcc`` for ``sm_90a`` at their first use
(``hmm/_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from itrails_tpu_torch.data.tokens import N_TOKENS, PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library
from itrails_tpu_torch.hmm.cuda_fwd import check_state
from itrails_tpu_torch.hmm.cuda_viterbi import (NEG, check_log_tables,
                                                padded_log_tables)

__all__ = ["build", "entry_scan", "entry_scan_plain", "maxplus_operators",
           "maxplus_operators_plain"]

_SRC = CSRC / "maxplus.cu"
_lib = None


def build():
    """Compile ``csrc/maxplus.cu`` unless this source was built before; see
    :func:`itrails_tpu_torch.hmm._build.compile_library`."""
    return compile_library(_SRC, "libk6_maxplus", BUILD_DIR, "kernel K6")


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        ptr, num = ctypes.c_void_p, ctypes.c_int
        lib.k6_operators.restype = ctypes.c_int
        lib.k6_operators.argtypes = [ptr] * 5 + [num] * 3 + [ptr]
        lib.k6_scan.restype = ctypes.c_int
        lib.k6_scan.argtypes = [ptr] * 5 + [num] * 2 + [ptr]
        lib.k6_max_states.restype = ctypes.c_int
        lib.k6_max_states.argtypes = []
        lib.k6_error_string.restype = ctypes.c_char_p
        lib.k6_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _raise_on(rc, lib):
    if rc != 0:
        raise RuntimeError("K6 launch failed: "
                           f"{lib.k6_error_string(rc).decode()} ({rc})")


def maxplus_operators_plain(log_a, log_bt, stream):
    """The max-plus operators of a (C, L) token matrix in plain PyTorch, in
    the dtype of the tables: ``(g (C, M, M), off (C, M) float64)``.

    From ``g[c] = 0`` on the diagonal and NEG elsewhere, each non-PAD
    column takes ``best[c, i, j] = max_k g[c, i, k] + log_a[k, j]``, ``nv =
    best + log_bt[tok, j]``, ``g = nv - max_j nv`` and ``off[c, i] += max_j
    nv`` (in f64); a PAD column keeps ``g`` and ``off``.  A token outside
    the alphabet reads the last row (K3's rule)."""
    c, length = stream.shape
    m = log_a.shape[0]
    dev = stream.device
    g = torch.full((c, m, m), NEG, dtype=log_a.dtype, device=dev)
    g.diagonal(dim1=1, dim2=2).fill_(0)
    off = torch.zeros((c, m), dtype=torch.float64, device=dev)
    rows = stream.long().clamp(0, N_TOKENS - 1)
    for t in range(length):
        pad = (stream[:, t] == PAD_TOKEN)[:, None]
        best = g[:, :, 0, None] + log_a[0]
        for k in range(1, m):
            best = torch.maximum(best, g[:, :, k, None] + log_a[k])
        nv = best + log_bt[rows[:, t]][:, None, :]
        mx = nv.amax(dim=2)
        g = torch.where(pad[:, :, None], g, nv - mx[:, :, None])
        off = torch.where(pad, off, off + mx.double())
    return g, off


def maxplus_operators(log_a, log_bt, stream):
    """K6: the max-plus operators of a (C, L) token matrix, ``(g (C, M, M),
    off (C, M) float64)``, the contract of :func:`maxplus_operators_plain`,
    which runs for tensors on the CPU.  On CUDA the kernel takes the
    float32 tables of ``cuda_viterbi.check_log_tables``, contiguous int32
    tokens and M <= 224; g is float32."""
    if stream.device.type == "cpu":
        return maxplus_operators_plain(log_a, log_bt, stream)
    if stream.device.type != "cuda":
        raise ValueError(f"maxplus_operators: unsupported device {stream.device}")
    lib = _library()
    check_log_tables("maxplus_operators", log_a, log_bt, stream,
                     lib.k6_max_states())
    dev = stream.device
    c, length = stream.shape
    m = log_a.shape[0]
    with torch.cuda.device(dev):
        la, lbt = padded_log_tables(log_a, log_bt)
        g = torch.empty((c, m, m), dtype=torch.float32, device=dev)
        off = torch.empty((c, m), dtype=torch.float64, device=dev)
        _raise_on(lib.k6_operators(
            la.data_ptr(), lbt.data_ptr(), stream.data_ptr(), g.data_ptr(),
            off.data_ptr(), c, length, m,
            torch.cuda.current_stream(dev).cuda_stream), lib)
    maxplus_operators.launches += 1
    return g, off


maxplus_operators.launches = 0  # K6 launches, since the last reset to 0


def entry_scan_plain(g, off, omega):
    """Omega at every chunk's entry in plain PyTorch: ``(entries (C, M) in
    the dtype of g, omega_out (M,) float64)``.  ``omega`` (M,) float64 is
    omega at chunk 0's entry, rescaled (max 0); ``entries[c]`` is omega at
    chunk c's entry, and ``omega_out`` at the entry of the chunk after the
    last, for the next group of chunks.  Each step, in f64:
    ``max_i (omega[i] + off[c, i]) + g[c, i, j]``, then minus its max."""
    c, m, _ = g.shape
    entries = torch.empty((c, m), dtype=g.dtype, device=g.device)
    for i in range(c):
        entries[i] = omega.to(g.dtype)
        v = ((omega + off[i])[:, None] + g[i].double()).amax(dim=0)
        omega = v - v.max()
    return entries, omega


def entry_scan(g, off, omega):
    """The entry scan over K6's operators, ``(entries (C, M), omega_out
    (M,) float64)``, the contract of :func:`entry_scan_plain`, which runs
    for tensors on the CPU.  On CUDA one block of the kernel takes
    contiguous float32 g (C, M, M), float64 off (C, M) and omega (M,), M <=
    224; the entries are float32."""
    if g.device.type == "cpu":
        return entry_scan_plain(g, off, omega)
    if g.device.type != "cuda":
        raise ValueError(f"entry_scan: unsupported device {g.device}")
    lib = _library()
    dev = g.device
    if g.dim() != 3:
        raise ValueError(f"entry_scan: g must be (C, M, M), got {tuple(g.shape)}")
    c, m, _ = g.shape
    if not (c >= 1 and 1 <= m <= lib.k6_max_states()):
        raise ValueError(f"entry_scan: {c} chunks of {m} states, the kernel "
                         f"takes C >= 1 and 1 <= M <= {lib.k6_max_states()}")
    check_state("entry_scan", "g", g, (c, m, m), torch.float32, dev)
    check_state("entry_scan", "off", off, (c, m), torch.float64, dev)
    check_state("entry_scan", "omega", omega, (m,), torch.float64, dev)
    with torch.cuda.device(dev):
        entries = torch.empty((c, m), dtype=torch.float32, device=dev)
        out = torch.empty((m,), dtype=torch.float64, device=dev)
        _raise_on(lib.k6_scan(
            g.data_ptr(), off.data_ptr(), omega.data_ptr(), entries.data_ptr(),
            out.data_ptr(), c, m, torch.cuda.current_stream(dev).cuda_stream),
            lib)
    entry_scan.launches += 1
    return entries, out


entry_scan.launches = 0  # launches of the scan kernel, since the last reset to 0
