"""Build of the port's CUDA sources (``csrc/*.cu``).

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at its first use, into
``build/itrails_tpu_torch/`` at the root of the checkout.  The file name
carries a hash of every source in ``csrc/`` (``grad.cu`` includes
``fwd.cu``) and the flags, so an edited source is never served by a stale
library.  The libraries are loaded with ``ctypes``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "compile_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "itrails_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc(what: str) -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found: building {what} needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def compile_library(src: Path, stem: str, build_dir: Path,
                    what: str) -> tuple[Path, str]:
    """Compile ``src`` into ``build_dir/<stem>_<hash>.so`` unless this
    source was built before.

    Returns the library's path and the compiler's ``-Xptxas -v`` report
    (registers, shared memory and spills of every instantiation), which is
    kept beside the library.  ``what`` names the kernel in errors."""
    text = b"".join(p.read_bytes() for p in sorted(src.parent.glob("*.cu")))
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = build_dir / f"{stem}_{tag}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(what), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""
