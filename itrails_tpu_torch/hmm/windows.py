"""Packing alignment blocks into fixed-shape window batches.

The reference processes each MAF block as one variable-length numba loop on
one CPU core (optimizer.py:56-62).  Here blocks are right-padded with
``PAD_TOKEN`` into a dense (W, T) int32 batch: padding is provably neutral
for every decoder (pad steps carry state unchanged; an all-pad window
contributes exactly log(sum(pi)) = 0 to the log-likelihood), so W and T can
be rounded up freely.
"""

from __future__ import annotations

import numpy as np

from itrails_tpu_torch.data.tokens import PAD_TOKEN

__all__ = ["pack_windows", "plan_buckets"]

# Blocks longer than this leave the length-class buckets: padding a bucket
# to such a length would multiply the work of every short block in it.
# The engine (optim/optimizer.py) and the decode CLIs take each of them on
# its own, sequence-parallel (hmm/longseq.py).
LONG_BLOCK_THRESHOLD = 262_144


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


def pack_windows(
    seqs,
    pad_windows_to: int = 1,
    pad_length_to: int = 1,
    max_window_len: int | None = None,
):
    """Pack variable-length token sequences into a padded (W, T) batch.

    ``max_window_len`` splits longer blocks into consecutive windows — note
    that splitting changes the forward recurrence at the seam, so leave it
    None for exact-parity likelihoods and decoding.

    Returns ``(tokens, lengths, owner)`` where ``owner[w]`` is the index of
    the source sequence of window ``w`` (useful to reassemble split blocks)
    and ``lengths[w]`` its true length.
    """
    pieces = []
    owners = []
    for i, s in enumerate(seqs):
        s = np.asarray(s, dtype=np.int32)
        if max_window_len is None or len(s) <= max_window_len:
            pieces.append(s)
            owners.append(i)
        else:
            for off in range(0, len(s), max_window_len):
                pieces.append(s[off : off + max_window_len])
                owners.append(i)

    n_w = _round_up(max(len(pieces), 1), pad_windows_to)
    t_len = _round_up(max((len(p) for p in pieces), default=1), pad_length_to)
    tokens = np.full((n_w, t_len), PAD_TOKEN, dtype=np.int32)
    lengths = np.zeros(n_w, dtype=np.int32)
    owner = np.full(n_w, -1, dtype=np.int32)
    for w, p in enumerate(pieces):
        tokens[w, : len(p)] = p
        lengths[w] = len(p)
        owner[w] = owners[w]
    return tokens, lengths, owner


def plan_buckets(
    lengths,
    n_dev: int = 1,
    long_threshold: int = LONG_BLOCK_THRESHOLD,
    min_len: int = 512,
    min_windows: int | None = None,
):
    """Group alignment blocks into same-length-class batches.

    The reference parallelises over whole blocks with one process per block
    (reference optimizer.py:56-62), so a mixed layout costs it nothing; a
    single padded (W, T_max) batch, in contrast, pads EVERY block to the
    longest one.  Bucketing by power-of-two length classes bounds padding
    waste at <2x (typically ~1.3x) with a handful of batch shapes, and
    blocks longer than ``long_threshold`` leave the batch entirely.  Every
    block stays one whole window,
    so the summed log-likelihood is identical to single-batch packing (up
    to float summation order).

    Returns ``(buckets, long_idx)``: ``buckets`` is a list of lists of block
    indices (ascending length class), ``long_idx`` the indices routed long.
    """
    min_windows = 2 * n_dev if min_windows is None else min_windows
    long_idx = [i for i, t in enumerate(lengths) if t > long_threshold]
    groups: dict[int, list[int]] = {}
    for i, t in enumerate(lengths):
        if t > long_threshold:
            continue
        key = max(min_len, 1 << (max(int(t), 1) - 1).bit_length())
        groups.setdefault(key, []).append(i)
    keys = sorted(groups)
    buckets: list[list[int]] = []
    carry: list[int] = []
    for k, key in enumerate(keys):
        members = carry + groups[key]
        # merge sparse classes upward (bounded 4x padding) so the number of
        # compiled decode shapes stays small
        if (len(members) < min_windows and k + 1 < len(keys)
                and keys[k + 1] <= 4 * key):
            carry = members
            continue
        buckets.append(members)
        carry = []
    if carry:
        buckets.append(carry)
    return buckets, long_idx
