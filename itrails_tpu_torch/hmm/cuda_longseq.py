"""Kernel K5: the per-chunk transfer operators of one long block on the
card, its wrapper, its plain PyTorch versions and its build.

K5 (``csrc/operators.cu``) replaces the Pallas TPU kernel
``tools/exp_opkernel.py:97 chunk_operators_fused``.  Its contract is
:func:`chunk_operators`, the port of ``itrails_tpu/hmm/longseq.py:38``,
over a (C, L) token matrix: from ``G = I``, for each column of a chunk,
``G <- (G @ a) * e(tok)`` followed by a division by the max entry, whose
log is added to the chunk's log scale; a PAD column keeps G and adds
nothing.  The kernel computes the operators' rows instead, each from its
unit vector with its own power-of-two scale (:func:`chunk_rows`, its plain
version), and :func:`fold_rows` folds rows and exponent sums into the
contract in f64.  The operators are in the tables' dtype, float32 or
float64 (K5 is instantiated on each: FMAs in f32, the FP64 tensor cores in
f64), and the log scales float64.  The source note in ``operators.cu``
states what bounds K5 and what its design does about that.

:func:`chunk_operators_fused` launches K5 for tensors on a CUDA device and
runs :func:`chunk_rows` only for tensors on the CPU, and folds either; a
CUDA input that the kernel does not take raises.  The kernel is compiled
with ``nvcc`` for ``sm_90a`` at its first use (``hmm/_build.py``) and
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library
from itrails_tpu_torch.hmm.cuda_fwd import (bind_layout, check_inputs,
                                            dmma_fragments, emission_rows,
                                            padded_tables, scaled_rows)

__all__ = ["MAX_CHUNK", "build", "chunk_operators",
           "chunk_operators_fused", "chunk_rows", "dmma_fragments", "fold_rows",
           "kernel_attributes", "launch_rows"]

_SRC = CSRC / "operators.cu"
_lib = None
# Columns of a chunk at most: a row's exponent sum (int32) moves by at most
# 1,022 a column.
MAX_CHUNK = 1 << 20


def build():
    """Compile ``csrc/operators.cu`` unless this source was built before;
    see :func:`itrails_tpu_torch.hmm._build.compile_library`."""
    return compile_library(_SRC, "libk5_operators", BUILD_DIR, "kernel K5")


def _bind(path):
    """Loads the built K5 library and declares its exports."""
    lib = ctypes.CDLL(str(path))
    lib.k5_rows.restype = ctypes.c_int
    lib.k5_rows.argtypes = ([ctypes.c_void_p] * 5
                            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    bind_layout(lib)
    lib.k5_attributes.restype = ctypes.c_int
    lib.k5_attributes.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.k5_max_states.restype = ctypes.c_int
    lib.k5_max_states.argtypes = []
    lib.k5_error_string.restype = ctypes.c_char_p
    lib.k5_error_string.argtypes = [ctypes.c_int]
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = _bind(build()[0])
    return _lib


def chunk_operators(a, bfull, tokens, chunk: int):
    """Per-chunk transfer operators of a 1-D token array whose length is a
    multiple of ``chunk`` (pad with PAD_TOKEN; a PAD column is the
    identity), operation for operation
    ``itrails_tpu/hmm/longseq.py:38 chunk_operators``: K5's plain version,
    in the dtype of ``a``.

    Returns ``(ops, logz)``: (C, M, M) operators, each divided by its max
    entry after every column, and (C,) float64 sums of the logs of those
    maxima."""
    m = a.shape[0]
    c = tokens.shape[0] // chunk
    tok = tokens.reshape(c, chunk)
    bt = bfull.T
    tiny = torch.finfo(a.dtype).tiny
    g = torch.eye(m, dtype=a.dtype, device=a.device).expand(c, m, m)
    logz = torch.zeros((c,), dtype=torch.float64, device=a.device)
    for k in range(chunk):
        col = tok[:, k]
        new = (g @ a) * emission_rows(bt, col)[:, None, :]
        z = new.amax(dim=(1, 2)).clamp(min=tiny)
        valid = col != PAD_TOKEN
        g = torch.where(valid[:, None, None], new / z[:, None, None], g)
        logz = logz + torch.where(valid, torch.log(z.double()), 0.0)
    return g, logz


def chunk_rows(a, bfull, tokens, chunk: int):
    """The rows of every chunk's transfer operator, each with its own
    power-of-two scale: K5's plain version, in the dtype of ``a``.

    ``tokens`` is 1-D, its length a multiple of ``chunk`` (pad with
    PAD_TOKEN).  Row i of chunk c starts from the unit vector e_i and reads
    the chunk's columns (:func:`cuda_fwd.scaled_rows`, K1's plain rows
    too): a non-PAD column takes ``x <- (x @ a) * e(tok)``, then divides x
    by 2^k, k the exponent of its max (floored at the dtype's smallest
    normal), and adds k to the row's sum; a PAD column keeps both.  Returns
    ``(x, k)``: the rows (C, M, M) and the exponent sums (C, M) int32."""
    m = a.shape[0]
    c = tokens.shape[0] // chunk
    x0 = torch.eye(m, dtype=a.dtype, device=a.device).repeat(c, 1)
    tok = tokens.reshape(c, chunk).repeat_interleave(m, dim=0)
    x, k = scaled_rows(x0, a, bfull, tok)
    return x.view(c, m, m), k.view(c, m)


def fold_rows(x, k):
    """Rows and exponent sums (:func:`chunk_rows`' contract) folded into
    :func:`chunk_operators`' contract, in place of ``x``: with
    ``lr = ln2 k`` in f64, ``logz_c = max_i (lr_ci + log max_j x_cij)`` and
    ``ops_c = x_c exp(lr_c - logz_c)[:, None]`` in the dtype of ``x``.
    Returns ``(ops, logz)``.  A chunk of PAD columns (x = I, k = 0) comes
    out as exactly I with logz 0."""
    lr = k.double() * math.log(2.0)
    tiny = torch.finfo(x.dtype).tiny
    top = torch.log(x.amax(dim=2).clamp(min=tiny).double()) + lr
    logz = top.amax(dim=1)
    return x.mul_(torch.exp(lr - logz[:, None]).to(x.dtype)[:, :, None]), logz


def chunk_operators_fused(a, bfull, stream):
    """The transfer operators of a (C, L) token matrix, one chunk a row:
    ``(ops (C, M, M), logz (C,) float64)``, the contract of
    :func:`chunk_operators`, folded (:func:`fold_rows`) from K5's rows.

    On CUDA this launches K5, which takes contiguous tables a (M, M) and
    bfull (M, 625), both float32 or both float64, with M <= 224, and
    contiguous int32 tokens with L <= MAX_CHUNK; ops are in the tables'
    dtype.  On the CPU the plain version runs in the dtype of ``a``."""
    if stream.device.type == "cpu":
        return fold_rows(*chunk_rows(a, bfull, stream.reshape(-1),
                                     stream.shape[1]))
    if stream.device.type != "cuda":
        raise ValueError(f"chunk_operators_fused: unsupported device "
                         f"{stream.device}")
    x, k = launch_rows(a, bfull, stream)
    chunk_operators_fused.launches += 1
    chunk_operators_fused.calls += 1
    return fold_rows(x, k)


chunk_operators_fused.calls = 0  # calls that launched K5, since the last reset to 0
chunk_operators_fused.launches = 0  # K5 launches, since the last reset to 0


def launch_rows(a, bfull, stream):
    """Launches K5 on CUDA tensors: ``(x, k)``, :func:`chunk_rows`'
    contract, unfolded.  Counts nothing: :func:`chunk_operators_fused`
    counts its launches."""
    lib = _library()
    check_inputs("chunk_operators_fused", a, bfull, None, stream,
                 lib.k5_max_states(), (torch.float32, torch.float64))
    dev = stream.device
    c, length = stream.shape
    if length > MAX_CHUNK:
        raise ValueError(f"chunk_operators_fused: chunks of {length} columns, "
                         f"more than {MAX_CHUNK}")
    m = a.shape[0]
    f64 = int(a.dtype == torch.float64)
    with torch.cuda.device(dev):
        _, bt = padded_tables(lib, a, bfull, 0)
        a_k = dmma_fragments(a) if f64 else a
        x = torch.empty((c, m, m), dtype=a.dtype, device=dev)
        k = torch.empty((c, m), dtype=torch.int32, device=dev)
        rc = lib.k5_rows(a_k.data_ptr(), bt.data_ptr(), stream.data_ptr(),
                         x.data_ptr(), k.data_ptr(), c, length, m, f64,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("K5 launch failed: "
                           f"{lib.k5_error_string(rc).decode()} ({rc})")
    return x, k


def kernel_attributes(m: int, f64: bool):
    """What K5 runs at ``m`` states on f32 or f64 tables, on the current
    card: a dict of its registers and local (spill) bytes a thread, its rows
    a warp and its warps a block at most."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    rc = lib.k5_attributes(m, int(f64), out)
    if rc != 0:
        raise RuntimeError(f"K5 attributes: {lib.k5_error_string(rc).decode()}")
    return dict(zip(("registers", "local_bytes", "rows_per_warp",
                     "max_warps"), out))
