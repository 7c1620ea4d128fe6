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

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first use into
``build/itrails_tpu_torch/`` at the root of the checkout (the file name
carries a hash of the source, so an edited source is never served by a
stale library) and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from itrails_tpu_torch.data.tokens import N_TOKENS, PAD_TOKEN

__all__ = ["build", "emission_rows", "forward_fused", "forward_fused_plain",
           "forward_loglik_fused"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "itrails_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building kernel K1 needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> tuple[Path, str]:
    """Compile ``csrc/fwd.cu`` unless this source was built before.

    Returns the shared library's path and the compiler's ``-Xptxas -v``
    report (registers, shared memory and spills of every instantiation),
    which is kept beside the library."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libk1_fwd_{tag}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


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


def _step0(bfull, pi, tok0):
    """Column 0, outside the kernel as in pallas_fwd.py:368-378: the
    normalized ``pi * e`` and its log-norm."""
    al0 = pi[None, :] * emission_rows(bfull.T, tok0)
    s0 = al0.sum(dim=1)
    return al0 / s0[:, None], torch.log(s0)


def forward_fused_plain(a, bfull, pi, tokens):
    """:func:`forward_fused` in plain PyTorch, in the dtype of ``a``: one
    (W, M) @ (M, M) product per column.  The CPU path and the reference the
    kernel is held against on the card."""
    bt = bfull.T
    al, ll = _step0(bfull, pi, tokens[:, 0])
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
    dev = tokens.device
    if tokens.dim() != 2 or tokens.dtype != torch.int32:
        raise ValueError("forward_fused: tokens must be a (W, T) int32 tensor, "
                         f"got {tuple(tokens.shape)} {tokens.dtype}")
    w, t_len = tokens.shape
    m = a.shape[0]
    expect = {"a": (a, (m, m)), "bfull": (bfull, (m, N_TOKENS)),
              "pi": (pi, (m,))}
    for name, (x, shape) in expect.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"forward_fused: {name} must be float32 on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"forward_fused: {name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"forward_fused: {name} must be contiguous")
    if not tokens.is_contiguous():
        raise ValueError("forward_fused: tokens must be contiguous")
    if not 1 <= m <= lib.k1_max_states():
        raise ValueError(f"forward_fused: K1 takes 1..{lib.k1_max_states()} "
                         f"states, got {m}")
    if w == 0 or t_len == 0:
        raise ValueError("forward_fused: empty token batch")

    with torch.cuda.device(dev):
        al0, ll0 = (x.contiguous() for x in _step0(bfull, pi, tokens[:, 0]))
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
