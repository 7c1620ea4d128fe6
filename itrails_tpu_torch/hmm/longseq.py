"""Sequence-parallel forward log-likelihood of one long block (the value
path of ``itrails_tpu/hmm/longseq.py``).

The forward recurrence is sequential in the column, so one long block
walked as a one-window batch keeps one warp of the card busy.  Written as
products, ``alpha' = alpha @ (a diag(e_t))``: any run of columns collapses
into one M x M transfer operator, the ordered product of its columns'
operators.  :func:`forward_loglik_long` cuts the block's columns into
chunks, builds every chunk's operator at once with kernel K5
(``hmm/cuda_longseq.py``; its plain version :func:`chunk_operators` on the
CPU), multiplies the operators in column order, and reads the
log-likelihood from ``(pi * e_0) @ P``.  The sequential depth drops from T
to the chunk's length.

The log-normalizer is carried in f64 from end to end: K5's per-chunk log
scales, each product's log scale and the final log.  A chromosome-scale
block reaches ~1e8 nats, where one f32 ulp is 8 nats.
"""

from __future__ import annotations

import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq
from itrails_tpu_torch.hmm.cuda_longseq import chunk_operators

__all__ = ["CHUNK", "OPERATOR_BUDGET_BYTES", "chunk_operators",
           "forward_loglik_long", "forward_loglik_long_plain"]

# Columns of one chunk: the JAX engine's (itrails_tpu/optim/optimizer.py:66).
CHUNK = 1024
# Bytes of the (C_g, M, M) operators of one group of chunks, built and folded
# before the next group is built: 368,224 chunks (377 M columns) at M = 27,
# 15,175 chunks (15.5 M columns) at M = 133 in float32, half as many in
# float64.
OPERATOR_BUDGET_BYTES = 1 << 30


def _normalize_(g):
    """Divides ``g`` in place by its max entry per matrix (floored at the
    dtype's tiny); returns it and the logs of those maxima in f64."""
    z = g.amax(dim=(-2, -1)).clamp(min=torch.finfo(g.dtype).tiny)
    return g.div_(z[..., None, None]), torch.log(z.double())


def _combine(left, right):
    """Associative combine of rescaled transfer operators with their f64
    log scales (``itrails_tpu/hmm/longseq.py:67``)."""
    (gl, zl), (gr, zr) = left, right
    g, z = _normalize_(gl @ gr)
    return g, zl + zr + z


def _group_product(operators, a, bfull, stream):
    """The ordered product of the transfer operators of a (C, chunk) token
    matrix, as one rescaled f64 operator and its f64 log scale.  K5 builds
    the operators; pairs of neighbours are then multiplied level by level,
    an odd last operator joining the last pair.  The f64 copy of the
    operators replaces K5's output, and each level's products replace the
    level before, so at most 12 bytes an entry of the (C, M, M) operators
    are held at once: 3x their float32 bytes, 1.5x their float64 bytes
    (K5's own output is then the f64 copy), plus, in float64 above
    M = 96, K5's scratch for G while it runs (32S/M x the operators'
    bytes).  ``operators`` is K5's wrapper or its plain version."""
    ops, logz = operators(a, bfull, stream)
    ops = ops.double()
    z = logz.sum()
    while ops.shape[0] > 1:
        n = ops.shape[0]
        even = n - n % 2
        g = ops[0:even:2] @ ops[1:even:2]
        if n % 2:
            g[-1] = g[-1] @ ops[-1]
        del ops
        ops, zc = _normalize_(g)
        z = z + zc.sum()
    return ops[0], z


def forward_loglik_long(a, bfull, pi, tokens, *, chunk: int = CHUNK):
    """Log-likelihood of one block, a 1-D token tensor, sequence-parallel
    (``itrails_tpu/hmm/longseq.py:179``); a 0-d float64 tensor.

    Column 0 enters as ``pi * e(tok_0)``; columns 1..T-1 are right-padded
    with PAD to a multiple of ``chunk`` (padding is neutral).  The chunks'
    operators are built and folded in groups whose (C_g, M, M) operators
    fit OPERATOR_BUDGET_BYTES, each group multiplied into the running
    product in column order, so the device holds one group's operators
    whatever the block's length.  The products of operators run in f64:
    they are O(C M^3), 1/``chunk`` of the chunks' own work, and no TF32
    setting of the caller's reaches them.  The operators come from
    ``cuda_longseq.chunk_operators_fused``: K5 on the card, where the
    tables must be contiguous float32 or float64, and its plain version on
    the CPU, each in the tables' dtype."""
    return _forward_loglik_long(cuda_longseq.chunk_operators_fused, a, bfull,
                                pi, tokens, chunk)


def forward_loglik_long_plain(a, bfull, pi, tokens, *, chunk: int = CHUNK):
    """:func:`forward_loglik_long` with the operators of K5's plain version
    on the tables' device and dtype: the reference the K5 route is held
    against on the card."""
    def plain(a, bfull, stream):
        return chunk_operators(a, bfull, stream.reshape(-1), stream.shape[1])

    return _forward_loglik_long(plain, a, bfull, pi, tokens, chunk)


def _forward_loglik_long(operators, a, bfull, pi, tokens, chunk):
    t_len = tokens.shape[0]
    m = a.shape[0]
    alpha0 = (pi * cuda_fwd.emission_rows(bfull.T, tokens[:1])[0]).double()
    if t_len == 1:
        return torch.log(alpha0.sum())
    n_chunks = -(-(t_len - 1) // chunk)
    per_group = max(1, OPERATOR_BUDGET_BYTES // (m * m * a.element_size()))
    prod = None
    for lo in range(0, n_chunks, per_group):
        hi = min(n_chunks, lo + per_group)
        cols = tokens[1 + lo * chunk:1 + hi * chunk]
        if cols.shape[0] < (hi - lo) * chunk:  # the last chunk's PAD tail
            tail = torch.full(((hi - lo) * chunk - cols.shape[0],), PAD_TOKEN,
                              dtype=cols.dtype, device=cols.device)
            cols = torch.cat([cols, tail])
        group = _group_product(operators, a, bfull,
                               cols.view(hi - lo, chunk))
        prod = group if prod is None else _combine(prod, group)
    g, z = prod
    return torch.log((alpha0 @ g).sum()) + z
