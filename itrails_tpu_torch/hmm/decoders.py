"""HMM forward decoding over window batches.

``emission_table``, ``forward`` and ``forward_loglik`` are the plain
reference decoders: a log-space forward scan with a per-step max shift
(reference optimizer.py:165-188), one (W, M) @ (M, M) product per column.
``forward_loglik_fast`` is what the optimizer calls: kernel K1
(``hmm/cuda_fwd.py``) on the card, its plain version on the CPU.

Padding: windows are right-padded with ``PAD_TOKEN``; padded steps carry
state through unchanged so every quantity equals the unpadded computation.
"""

from __future__ import annotations

import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm import cuda_fwd

__all__ = ["emission_table", "forward", "forward_loglik",
           "forward_loglik_fast"]


def emission_table(b, agg):
    """(M, 625) emission table over the full (ambiguity-resolved) alphabet:
    ``b @ agg.T`` where agg is data.tokens.aggregation_matrix()."""
    return b @ torch.as_tensor(agg, dtype=b.dtype, device=b.device).T


def forward(a, bfull, pi, tokens):
    """Log-space forward pass over a (W, T) token batch.

    Returns ``(alpha_T, logliks)``: the final (W, M) log state vector and the
    per-window log-likelihoods (W,).
    """
    bt = bfull.T
    alpha = torch.log(pi[None, :] * cuda_fwd.emission_rows(bt, tokens[:, 0]))
    for t in range(1, tokens.shape[1]):
        tok = tokens[:, t]
        x = alpha.max(dim=1, keepdim=True).values
        new = torch.log((torch.exp(alpha - x) @ a)
                        * cuda_fwd.emission_rows(bt, tok)) + x
        alpha = torch.where((tok == PAD_TOKEN)[:, None], alpha, new)
    x = alpha.max(dim=1).values
    loglik = torch.log(torch.exp(alpha - x[:, None]).sum(dim=1)) + x
    return alpha, loglik


def forward_loglik(a, bfull, pi, tokens):
    """Total log-likelihood of a (W, T) token batch (sum over windows)."""
    return forward(a, bfull, pi, tokens)[1].sum()


def forward_loglik_fast(a, bfull, pi, tokens):
    """Total log-likelihood (f64 scalar tensor) of a (W, T) token batch.

    On the card this is kernel K1, which takes contiguous float32 tables;
    on the CPU it is K1's plain version in the tables' dtype."""
    return cuda_fwd.forward_loglik_fused(a, bfull, pi, tokens)
