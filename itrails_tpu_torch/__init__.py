"""itrails-tpu-torch: the coalescent-HMM engine in PyTorch for NVIDIA Hopper.

The same model and contracts as ``itrails_tpu`` (the JAX package beside it,
which is the numerical reference): a float64 model builder
``params -> (a, b, pi)`` (``core``), window-batched HMM decoding (``hmm``)
whose forward recurrence runs in a hand-written CUDA kernel
(``hmm/cuda_fwd.py``, ``csrc/fwd.cu``), and the Nelder-Mead optimize
workflow with the reference's CSV/YAML artifacts (``optim``, ``cli``).

Every entry point takes an explicit ``device``.  The default is ``"cuda"``;
without a card it raises instead of running on the CPU.  ``device="cpu"``
runs the plain PyTorch version of every kernel.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The torch device for an entry point's ``device`` argument.

    Raises when a CUDA device is asked for and none is present: the port
    never moves work to the CPU unless the caller passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but no CUDA device is available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
