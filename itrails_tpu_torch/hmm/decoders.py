"""HMM decoding over window batches.

``emission_table``, ``forward`` and ``forward_loglik`` are the plain
reference decoders: a log-space forward scan with a per-step max shift
(reference optimizer.py:165-188), one (W, M) @ (M, M) product per column.
``forward_loglik_fast`` is what the optimizer calls: kernel K1
(``hmm/cuda_fwd.py``) on the card, its plain version on the CPU.
``viterbi_fast`` is the max-plus decoder the Viterbi CLI calls: kernel K3
(``hmm/cuda_viterbi.py``) on the card, its plain version on the CPU.
``viterbi_segmented`` decodes one long block in bounded memory as one
warp's walk in segments, bit for bit the one-pass path: off the Viterbi
CLI's path since the sequence-parallel route ``longseq.viterbi_long``
took long blocks, and the card's reference for it.
``posterior_fast`` is K4's dispatch: kernel K4 (``hmm/cuda_posterior.py``)
on the card, its plain version on the CPU; ``posterior_stream``, what the
posterior CLI calls, streams every block's posterior in bounded memory, a
long block's through the sequence-parallel route
``longseq.posterior_long_pieces``.  ``posterior_segmented`` streams one
long block's posterior in bounded memory as one warp's walk, bit for bit
the one-window rows: the card's reference for the route.

Padding: windows are right-padded with ``PAD_TOKEN``; padded steps carry
state through unchanged so every quantity equals the unpadded computation.
"""

from __future__ import annotations

import numpy as np
import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm import (cuda_fwd, cuda_posterior, cuda_viterbi,
                                   longseq, windows)

__all__ = ["emission_table", "forward", "forward_loglik",
           "forward_loglik_fast", "posterior_fast", "posterior_groups",
           "posterior_segmented", "posterior_stream", "viterbi_fast",
           "viterbi_segmented"]

# Columns of one segment of viterbi_segmented and posterior_segmented: the
# pointer table of one is SEGMENT_COLUMNS x M bytes (27 MB at M = 27, 133 MB
# at M = 133), K4's store SEGMENT_COLUMNS x 32S floats (134 MB at M = 27,
# 671 MB at M = 133).
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

    On the card this is kernel K1, which takes contiguous float32 or
    float64 tables; on the CPU it is K1's plain version in the tables'
    dtype."""
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


def posterior_fast(a, bfull, pi, tokens):
    """Posterior state probabilities, (T, W, M), of a (W, T) token batch
    (itrails_tpu/hmm/decoders.py:147 posterior_fast).  On the card this is
    kernel K4, which takes contiguous float32 or float64 tables and int32
    tokens, and the result is a view of its store; on the CPU it is K4's
    plain version (``cuda_posterior.posterior_fused_plain``) in the tables'
    dtype.

    Padded steps are garbage: mask with ``tokens != PAD_TOKEN``.  The
    recursion is K4's, a scaled-linear forward and reverse sweep in which
    the reverse sweep contracts over the source state as the reference does
    (optimizer.py:210); in f64 it is the reference posterior
    (itrails_tpu/hmm/decoders.py:209 posterior) up to rounding."""
    return cuda_posterior.posterior_fused(a, bfull, pi, tokens)[0]


def posterior_segmented(a, bfull, pi, tokens):
    """Posterior of one block, a 1-D token tensor, in bounded memory: yields
    each segment's (rows, M) posterior in column order, so a writer can
    stream it (the counterpart of itrails_tpu/hmm/longseq.py:77, which
    holds the whole block).

    Columns 1..T-1 are cut into segments of SEGMENT_COLUMNS, each decoded as
    a window that starts one column earlier.  A reverse pass runs K4's beta
    sweep alone (its plain version on the CPU) over the segments from last
    to first and keeps only beta at each segment's last column.  A forward
    pass then runs K4 on one segment at a time, from the alpha the previous
    segment ended in and the stored exit beta, and hands the segment's rows
    on before the next segment runs.  Every step's normalization is
    deterministic from its carry, so the rows are the one-pass rows bit for
    bit; the device holds one segment's store and one beta a segment."""
    t_len = tokens.shape[0]
    bounds = list(range(1, t_len, SEGMENT_COLUMNS)) + [t_len]
    if len(bounds) <= 2:
        yield posterior_fast(a, bfull, pi, tokens[None, :])[:, 0, :]
        return

    def window(k):
        # segment k covers columns bounds[k]..bounds[k+1]-1; its window
        # starts at bounds[k]-1, the column of its entry alpha
        return tokens[None, bounds[k] - 1:bounds[k + 1]]

    n_seg = len(bounds) - 1
    exits = [None] * n_seg  # beta at each segment's last column: ones last
    for k in range(n_seg - 1, 0, -1):
        exits[k - 1] = cuda_posterior.beta_sweep(a, bfull, window(k), exits[k])
    alpha = None  # segment 0 starts from pi and column 0
    for k in range(n_seg):
        post, alpha = cuda_posterior.posterior_fused(
            a, bfull, pi, window(k), alpha0=alpha, beta_exit=exits[k])
        rows = post[0 if k == 0 else 1:, 0, :]  # column bounds[k]-1 was sent
        del post
        exits[k] = None
        yield rows
        del rows


def posterior_groups(lengths, row_bytes, long_threshold):
    """The batches of :func:`posterior_stream`, in block order: runs of
    consecutive blocks of at most ``long_threshold`` columns, each cut so
    that its padded (W, T_max) store of ``row_bytes`` a column
    (``cuda_posterior.store_row_bytes``) stays one window group
    (``cuda_posterior.window_group``), and each longer block alone.
    Returns lists of block indices."""
    groups, cur, t_max = [], [], 0
    for i, n in enumerate(lengths):
        if n > long_threshold:
            groups += [cur, [i]] if cur else [[i]]
            cur, t_max = [], 0
            continue
        if cur and len(cur) + 1 > cuda_posterior.window_group(max(t_max, n),
                                                              row_bytes):
            groups.append(cur)
            cur, t_max = [], 0
        cur.append(i)
        t_max = max(t_max, n)
    return groups + [cur] if cur else groups


def posterior_stream(a, bfull, pi, v_lst, long_threshold):
    """Posterior of every block of ``v_lst`` (1-D token arrays) on the
    tables' device, as a generator of ``(block_idx, rows)`` in block and
    column order, rows a (n, M) numpy array in the tables' dtype.

    Each batch of :func:`posterior_groups` is decoded, copied to the host
    and handed on before the next one runs: the short blocks as padded
    window groups, and each block above ``long_threshold`` through the
    sequence-parallel route ``longseq.posterior_long_pieces`` (K5's
    operators in both directions, then one K4 call over the block's chunk
    windows), one piece a group of its chunks.  So the device holds at most
    one window group's store or one chunk group's operators and store,
    whatever the number of states and the alignment's size, and the host
    one group's rows."""
    dev = a.device
    m = a.shape[0]
    row_bytes = cuda_posterior.store_row_bytes(m, dev, a.dtype)
    lengths = [len(v) for v in v_lst]
    for group in posterior_groups(lengths, row_bytes, long_threshold):
        i = group[0]
        if lengths[i] <= long_threshold:
            tokens, _, _ = windows.pack_windows([v_lst[j] for j in group])
            post = posterior_fast(
                a, bfull, pi, torch.as_tensor(tokens, device=dev)).cpu().numpy()
            for w, j in enumerate(group):
                yield j, post[: lengths[j], w, :]
            del post
            continue
        v = torch.as_tensor(np.asarray(v_lst[i], np.int32), device=dev)
        for piece in longseq.posterior_long_pieces(a, bfull, pi, v):
            rows = piece.cpu().numpy()
            del piece  # the piece goes before the next group runs
            yield i, rows
