"""HMM decoding over window batches.

``emission_table``, ``forward`` and ``forward_loglik`` are the plain
reference decoders: a log-space forward scan with a per-step max shift
(reference optimizer.py:165-188), one (W, M) @ (M, M) product per column.
``forward_loglik_fast`` is what the optimizer calls: kernel K1
(``hmm/cuda_fwd.py``) on the card, its plain version on the CPU.
``viterbi_fast`` is the max-plus decoder the Viterbi CLI calls: kernel K3
(``hmm/cuda_viterbi.py``) on the card, its plain version on the CPU.
``viterbi_segmented`` decodes one long block in bounded memory.

Padding: windows are right-padded with ``PAD_TOKEN``; padded steps carry
state through unchanged so every quantity equals the unpadded computation.
"""

from __future__ import annotations

import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm import cuda_fwd, cuda_viterbi

__all__ = ["emission_table", "forward", "forward_loglik",
           "forward_loglik_fast", "viterbi_fast", "viterbi_segmented"]

# Columns of one segment of viterbi_segmented: its pointer table is
# SEGMENT_COLUMNS x M bytes (27 MB at M = 27, 133 MB at M = 133).
SEGMENT_COLUMNS = 1 << 20


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


def viterbi_fast(a, bfull, pi, tokens):
    """Most-probable state path per window: (W, T) int32
    (itrails_tpu/hmm/decoders.py:161 viterbi_fast).  On the card this is
    kernel K3, which takes contiguous float32 tables and int32 tokens; on
    the CPU it is K3's plain version (``cuda_viterbi.viterbi_fused_plain``)
    in the tables' dtype.

    Padded steps repeat the last real state; mask with
    ``tokens != PAD_TOKEN`` when consuming.  The recursion is that of
    itrails_tpu/hmm/decoders.py:220 viterbi, operation for operation:
    log-probabilities clamped at -1e4, omega rescaled by its per-window max
    every step, and the argmax over the pre-emission scores, first index on
    ties.  In f64 on real models this is the reference max-plus recursion
    (optimizer.py:305-333): the rescale shifts all scores of a window and
    never changes an argmax at real-model margins."""
    return cuda_viterbi.viterbi_fused(a, bfull, pi, tokens)[0]


def viterbi_segmented(a, bfull, pi, tokens):
    """Viterbi path (T,) int32 of one block, a 1-D token tensor, in bounded
    memory (the counterpart of itrails_tpu/hmm/longseq.py:441).

    The one-pass decode keeps a (T-1) x M pointer table.  Here columns
    1..T-1 are cut into segments of SEGMENT_COLUMNS: a first pass keeps only
    omega at each segment's entry; a reverse pass reruns K3 (its plain
    version on the CPU) on one segment at a time from its entry omega and
    backtracks from the state that the later segment handed down.  The
    rescale of every step is deterministic, so the path is the one-pass
    path bit for bit; the cost is a second forward pass over all but the
    last segment."""
    t_len = tokens.shape[0]
    bounds = list(range(1, t_len, SEGMENT_COLUMNS)) + [t_len]
    if len(bounds) <= 2:
        return viterbi_fast(a, bfull, pi, tokens[None, :])[0]

    def segment(k, **state):
        # segment k covers columns bounds[k]..bounds[k+1]-1; its window
        # starts one column earlier, where the entry omega stands
        window = tokens[None, bounds[k] - 1:bounds[k + 1]]
        return cuda_viterbi.viterbi_fused(a, bfull, pi, window, **state)

    entries = [None]  # omega at each segment's entry; segment 0: column 0
    for k in range(len(bounds) - 2):
        entries.append(segment(k, omega0=entries[k])[1])
    path = torch.empty(t_len, dtype=torch.int32, device=tokens.device)
    last = None  # the final segment ends at the argmax of the final omega
    for k in range(len(bounds) - 2, -1, -1):
        seg_path = segment(k, omega0=entries[k], last=last)[0][0]
        path[bounds[k] - 1:bounds[k + 1]] = seg_path
        last = seg_path[:1].contiguous()
    return path
