"""Kernel K5: the per-chunk transfer operators of one long block on the
card, its wrapper, its plain PyTorch version and its build.

K5 (``csrc/operators.cu``) replaces the Pallas TPU kernel
``tools/exp_opkernel.py:97 chunk_operators_fused``.  It computes
:func:`chunk_operators`, the port of ``itrails_tpu/hmm/longseq.py:38``,
over a (C, L) token matrix: from ``G = I``, for each column of a chunk,
``G <- (G @ a) * e(tok)`` followed by a division by the max entry, whose
log is added to the chunk's log scale; a PAD column keeps G and adds
nothing.  The operators are in the tables' dtype, float32 or float64
(K5 is instantiated on each), and the log scales float64.  The source
note in ``operators.cu`` states what bounds K5 and what its design does
about that.

:func:`chunk_operators_fused` launches K5 for tensors on a CUDA device and
runs :func:`chunk_operators` only for tensors on the CPU; a CUDA input
that the kernel does not take raises.  The kernel is compiled with
``nvcc`` for ``sm_90a`` at its first use (``hmm/_build.py``) and loaded
with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm._build import BUILD_DIR, CSRC, compile_library
from itrails_tpu_torch.hmm.cuda_fwd import (bind_layout, check_inputs,
                                            emission_rows, padded_tables)

__all__ = ["build", "chunk_operators", "chunk_operators_fused"]

_SRC = CSRC / "operators.cu"
_lib = None


def build():
    """Compile ``csrc/operators.cu`` unless this source was built before;
    see :func:`itrails_tpu_torch.hmm._build.compile_library`."""
    return compile_library(_SRC, "libk5_operators", BUILD_DIR, "kernel K5")


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.k5_operators.restype = ctypes.c_int
        lib.k5_operators.argtypes = ([ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        bind_layout(lib)
        lib.k5_a_stride.restype = ctypes.c_int
        lib.k5_a_stride.argtypes = [ctypes.c_int]
        lib.k5_g_scratch.restype = ctypes.c_int
        lib.k5_g_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.k5_max_states.restype = ctypes.c_int
        lib.k5_max_states.argtypes = []
        lib.k5_error_string.restype = ctypes.c_char_p
        lib.k5_error_string.argtypes = [ctypes.c_int]
        _lib = lib
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


def chunk_operators_fused(a, bfull, stream):
    """The transfer operators of a (C, L) token matrix, one chunk a row:
    ``(ops (C, M, M), logz (C,) float64)``, the contract of
    :func:`chunk_operators`.

    On CUDA this launches K5, which takes contiguous tables a (M, M) and
    bfull (M, 625), both float32 or both float64, with M <= 224, and
    contiguous int32 tokens; ops are in the tables' dtype.  On the CPU the
    plain version runs in the dtype of ``a``."""
    if stream.device.type == "cpu":
        return chunk_operators(a, bfull, stream.reshape(-1), stream.shape[1])
    if stream.device.type != "cuda":
        raise ValueError(f"chunk_operators_fused: unsupported device "
                         f"{stream.device}")
    lib = _library()
    check_inputs("chunk_operators_fused", a, bfull, None, stream,
                 lib.k5_max_states(), (torch.float32, torch.float64))
    dev = stream.device
    c, length = stream.shape
    m = a.shape[0]
    f64 = int(a.dtype == torch.float64)

    with torch.cuda.device(dev):
        a_k, bt = padded_tables(lib, a, bfull, lib.k5_a_stride(m))
        ops = torch.empty((c, m, m), dtype=a.dtype, device=dev)
        logz = torch.empty((c,), dtype=torch.float64, device=dev)
        scratch = lib.k5_g_scratch(m, f64)  # G in global memory, per chunk
        gbuf = (torch.empty((c, scratch), dtype=a.dtype, device=dev)
                if scratch else None)
        rc = lib.k5_operators(a_k.data_ptr(), bt.data_ptr(), stream.data_ptr(),
                              ops.data_ptr(), logz.data_ptr(),
                              None if gbuf is None else gbuf.data_ptr(), c,
                              length, m, f64,
                              torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("K5 launch failed: "
                               f"{lib.k5_error_string(rc).decode()} ({rc})")
        chunk_operators_fused.launches += 1
    chunk_operators_fused.calls += 1
    return ops, logz


chunk_operators_fused.calls = 0  # calls that launched K5, since the last reset to 0
chunk_operators_fused.launches = 0  # K5 launches, since the last reset to 0
