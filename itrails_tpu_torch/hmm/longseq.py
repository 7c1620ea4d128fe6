"""Sequence-parallel forward log-likelihood of one long block and its exact
gradient (``itrails_tpu/hmm/longseq.py``).

The forward recurrence is sequential in the column, so one long block
walked as a one-window batch keeps one warp of the card busy.  Written as
products, ``alpha' = alpha @ (a diag(e_t))``: any run of columns collapses
into one M x M transfer operator, the ordered product of its columns'
operators.  :func:`forward_loglik_long` cuts the block's columns into
chunks, builds every chunk's operator at once with kernel K5
(``hmm/cuda_longseq.py``: every row of every chunk with its own
power-of-two scale, folded to one scale a chunk; on the CPU its plain
version ``cuda_longseq.chunk_rows``, folded), multiplies the operators in
column order, and reads the log-likelihood from ``(pi * e_0) @ P``.  The
sequential depth drops from T to the chunk's length.

The log-normalizer is carried in f64 from end to end: K5's per-chunk log
scales, each product's log scale and the final log.  A chromosome-scale
block reaches ~1e8 nats, where one f32 ulp is 8 nats.

:func:`forward_loglik_long_and_grads` gives the value and its exact
gradient in ``(a, bfull, pi)``, the contract of
``jax.value_and_grad(itrails_tpu.hmm.longseq.forward_loglik_long_remat)``.
The gradient is a sum over columns of terms that need only alpha before
the column and beta at it, so each chunk is an ordinary window of kernel
K2 (``hmm/cuda_grad.py``) once alpha at its entry and beta at its exit
are known.  Those come from K5's operators: ``alpha_c ~ alpha_0 G_0 ...
G_{c-1}`` and ``beta_c ~ G_{c+1} ... G_{C-1} 1``, exclusive prefix and
suffix products read from one tree of pairwise products in f64.  Every
chunk then goes through one K2 call as a (C, chunk + 1) batch: the
sequential depth is the chunk's length, and the card runs a warp a chunk.

:func:`posterior_long` gives the block's posterior, the contract of
``itrails_tpu/hmm/longseq.py:77``, by the same route with kernel K4
(``hmm/cuda_posterior.py``) in K2's place: alpha at every chunk's entry
from K5's operators of ``a``, beta at every chunk's exit from K5's
operators of ``a^T`` (the posterior's backward contracts over the source
state), then one K4 call over the chunk windows.
:func:`posterior_long_pieces` streams it, one group of chunks at a time.

:func:`viterbi_long` gives the block's Viterbi path, the contract of
``itrails_tpu/hmm/longseq.py:298``, in the (max, +) semiring: kernel K6
(``hmm/cuda_maxplus.py``) builds every chunk's max-plus operator, its scan
reads omega at every chunk's entry, and one K3 forward
(``hmm/cuda_viterbi.py``) takes every chunk as a window entered through
its omega; K3's entry map, a chain of one lookup a chunk and K3's
backtrack then give the path with no walk longer than a chunk.
"""

from __future__ import annotations

import torch

from itrails_tpu_torch.data.tokens import PAD_TOKEN
from itrails_tpu_torch.hmm import (cuda_fwd, cuda_grad, cuda_longseq,
                                   cuda_maxplus, cuda_posterior, cuda_viterbi)
from itrails_tpu_torch.hmm.cuda_longseq import chunk_operators

__all__ = ["CHUNK", "OPERATOR_BUDGET_BYTES", "ROUTE_CHUNK",
           "boundary_rows", "chunk_matrix", "chunk_operators", "entry_rows",
           "exit_rows", "forward_loglik_long", "forward_loglik_long_and_grads",
           "forward_loglik_long_and_grads_plain", "forward_loglik_long_plain",
           "posterior_long", "posterior_long_pieces", "posterior_long_plain",
           "posterior_ranges", "viterbi_long", "viterbi_long_plain",
           "viterbi_ranges"]

# Columns of one chunk of the value path: the JAX engine's
# (itrails_tpu/optim/optimizer.py:66).
CHUNK = 1024
# Columns of one chunk of the long-block routes, the gradient's, the
# posterior's and the Viterbi path's: K5's and K6's chunk, and K2's, K3's
# and K4's window less its entry column
# (chip_smoke.py's phases 11 and 12 time the gradient's and the posterior's
# routes at 256, 512 and 1,024; PERF.md).
ROUTE_CHUNK = 512
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
    (K5's own output is then the f64 copy); K5 folds its rows in place.
    ``operators`` is K5's wrapper or its plain version."""
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
    return _forward_loglik_long(_plain_operators, a, bfull, pi, tokens, chunk)


def _plain_operators(a, bfull, stream):
    """K5's plain version with the wrapper's signature, on any device."""
    return chunk_operators(a, bfull, stream.reshape(-1), stream.shape[1])


def chunk_matrix(tokens, lo, hi, chunk):
    """Chunks ``lo`` to ``hi`` of a block's columns 1..T-1 as a
    (hi - lo, chunk) token matrix, the last chunk right-padded with PAD."""
    cols = tokens[1 + lo * chunk:1 + hi * chunk]
    if cols.shape[0] < (hi - lo) * chunk:  # the last chunk's PAD tail
        tail = torch.full(((hi - lo) * chunk - cols.shape[0],), PAD_TOKEN,
                          dtype=cols.dtype, device=cols.device)
        cols = torch.cat([cols, tail])
    return cols.view(hi - lo, chunk)


def _groups(t_len, m, size, chunk):
    """``(lo, hi)`` chunk ranges of a block's columns 1..T-1 whose (M, M)
    operators of ``size`` bytes an entry fit OPERATOR_BUDGET_BYTES."""
    return _ranges(t_len, chunk, OPERATOR_BUDGET_BYTES // (m * m * size))


def _ranges(t_len, chunk, per_group):
    """``(lo, hi)`` ranges of at most ``per_group`` (at least one) of the
    chunks of a block's columns 1..T-1."""
    n_chunks = -(-(t_len - 1) // chunk)
    per_group = max(1, per_group)
    return [(lo, min(n_chunks, lo + per_group))
            for lo in range(0, n_chunks, per_group)]


def _forward_loglik_long(operators, a, bfull, pi, tokens, chunk):
    t_len = tokens.shape[0]
    m = a.shape[0]
    alpha0 = (pi * cuda_fwd.emission_rows(bfull.T, tokens[:1])[0]).double()
    if t_len == 1:
        return torch.log(alpha0.sum())
    prod = None
    for lo, hi in _groups(t_len, m, a.element_size(), chunk):
        group = _group_product(operators, a, bfull,
                               chunk_matrix(tokens, lo, hi, chunk))
        prod = group if prod is None else _combine(prod, group)
    g, z = prod
    return torch.log((alpha0 @ g).sum()) + z


def _unit(v):
    """Rows of ``v`` divided by their sums (floored at the dtype's tiny)."""
    return v / v.sum(dim=-1, keepdim=True).clamp(min=torch.finfo(v.dtype).tiny)


def _tree(ops):
    """The levels of the tree of pairwise products of ``ops`` (C, M, M):
    level 0 is ``ops``; node i of a level is the product of nodes 2i and
    2i+1 of the level below, in f64 and divided by its max entry, an odd
    last node passing up alone."""
    levels = [ops]
    while levels[-1].shape[0] > 1:
        g = levels[-1]
        n = g.shape[0]
        even = n - n % 2
        p = g[0:even:2].double() @ g[1:even:2].double()
        if n % 2:
            p = torch.cat([p, g[-1:].double()])
        levels.append(_normalize_(p)[0])
    return levels


def _entry_pass(levels, entry):
    """One pass down a :func:`_tree`: a left child enters where its parent
    enters and a right child after its left sibling."""
    alpha = _unit(entry.double())[None]
    for g in reversed(levels[:-1]):
        n, m = g.shape[0], g.shape[1]
        half = n // 2
        al = torch.empty((n, m), dtype=torch.float64, device=g.device)
        al[0::2] = alpha
        al[1::2] = _unit((alpha[:half, None, :] @ g[0:2 * half:2].double())[:, 0])
        alpha = al
    return alpha


def _exit_pass(levels, exit_):
    """One pass down a :func:`_tree`: a right child exits where its parent
    exits and a left child before its right sibling."""
    beta = _unit(exit_.double())[None]
    for g in reversed(levels[:-1]):
        n, m = g.shape[0], g.shape[1]
        half = n // 2
        be = torch.empty((n, m), dtype=torch.float64, device=g.device)
        be[1::2] = beta[:half]
        be[0:2 * half:2] = _unit((g[1:2 * half:2].double()
                                  @ beta[:half, :, None])[..., 0])
        if n % 2:
            be[-1] = beta[-1]
        beta = be
    return beta


def entry_rows(ops, entry):
    """Alpha at every chunk's entry, (C, M) in f64, each row summing to 1:
    ``alpha[c] ~ entry G_0 ... G_{c-1}`` for the chunks' transfer operators
    ``ops`` (C, M, M) (any scale, any float dtype) and ``entry`` (M,), alpha
    before chunk 0.  Exclusive prefix products, read from one tree of
    pairwise products (see :func:`boundary_rows`)."""
    return _entry_pass(_tree(ops), entry)


def exit_rows(ops, exit_):
    """Beta at every chunk's exit, (C, M) in f64, each row summing to 1:
    ``beta[c] ~ G_{c+1} ... G_{C-1} exit_`` for the operators ``ops``
    (C, M, M) and ``exit_`` (M,), beta after chunk C-1.  Exclusive suffix
    products, read from one tree of pairwise products (see
    :func:`boundary_rows`)."""
    return _exit_pass(_tree(ops), exit_)


def boundary_rows(ops, entry, exit_):
    """Alpha at every chunk's entry and beta at every chunk's exit, in f64,
    each row summing to 1: ``(entry_rows(ops, entry), exit_rows(ops,
    exit_))`` from one tree.

    ``ops`` (C, M, M) are the chunks' transfer operators G_c (any scale,
    any float dtype); ``entry`` (M,) is alpha before chunk 0 and ``exit_``
    (M,) beta after chunk C-1.  Returns ``(alpha, beta)``, both (C, M):
    ``alpha[c] ~ entry G_0 ... G_{c-1}`` and ``beta[c] ~ G_{c+1} ... G_{C-1}
    exit_``.  One tree of pairwise products (node i of a level is the
    product of nodes 2i and 2i+1 of the level below, an odd last node
    passing up alone), each divided by its max entry, then one pass down
    it for each: a left child enters where its parent enters and a right
    child after its left sibling; a right child exits where its parent
    exits and a left child before its right sibling.  log2(C) levels of
    batched products; the levels above ``ops`` hold about C f64 operators
    in all.  This beta is the textbook one, ``G x``, that K2
    differentiates; the posterior's backward contracts over the source
    state and takes :func:`exit_rows` of the operators of ``a^T``
    (:func:`posterior_long`)."""
    levels = _tree(ops)
    return _entry_pass(levels, entry), _exit_pass(levels, exit_)


def forward_loglik_long_and_grads(a, bfull, pi, tokens, *, chunk=None):
    """``(value, (dA, dbfull, dpi))`` of one block, a 1-D token tensor,
    sequence-parallel: the contract of ``jax.value_and_grad(
    itrails_tpu.hmm.longseq.forward_loglik_long_remat, argnums=(0, 1, 2))``
    (``itrails_tpu/hmm/longseq.py:206``).

    Columns 1..T-1 are cut into chunks of ``chunk`` columns (default
    ROUTE_CHUNK), the last right-padded with PAD.  K5 builds the chunks'
    operators, :func:`boundary_rows` reads alpha at each chunk's entry
    (from ``alpha_0 = pi * e(tok_0)``) and beta at its exit (from ones),
    and one K2 call takes every chunk as a window entered and left through
    those rows.  Column 0 is done here: its log, and ``dpi`` and its
    ``dbfull`` column from beta at the origin, ``G_0`` applied to chunk
    0's exit row.

    The value is column 0's log plus the chunks' f64 logliks from K2 (not
    the f64 fold of the operators' log scales): those are the sums whose
    gradient K2 returns, so the value and the gradient come from the same
    recursion, and K2 gives them at no cost.  The chunks are taken in the
    value path's groups, whose operators fit OPERATOR_BUDGET_BYTES; above
    one group, a first pass keeps each group's product (K5, then a fold in
    f64), the groups' entry and exit rows come from those, and each group's
    operators are built again for its rows and its K2 call.  The device
    then holds one group's operators, their tree of f64 products (about
    four times their float32 bytes at most), K2's buffers for the group's
    windows and O(C M) rows, whatever the block's length.

    On the card K5 and K2 run in float32 (the tables must be contiguous
    float32, the value is f64 and the gradients float32); on the CPU their
    plain versions run in the dtype of ``a``."""
    return _long_and_grads(cuda_longseq.chunk_operators_fused,
                           cuda_grad.loglik_and_grads_fused, a, bfull, pi,
                           tokens, ROUTE_CHUNK if chunk is None else chunk)


def forward_loglik_long_and_grads_plain(a, bfull, pi, tokens, *, chunk=None):
    """:func:`forward_loglik_long_and_grads` with the plain versions of K5
    and K2 on the tables' device and dtype: the reference the route is held
    against on the card."""
    return _long_and_grads(_plain_operators, cuda_grad.loglik_and_grads_plain,
                           a, bfull, pi, tokens,
                           ROUTE_CHUNK if chunk is None else chunk)


def _long_and_grads(operators, k2, a, bfull, pi, tokens, chunk):
    t_len = tokens.shape[0]
    if t_len == 1:
        return k2(a, bfull, pi, tokens[None])
    m = a.shape[0]
    e0, al0, s0 = cuda_fwd.column0(bfull, pi, tokens[:1])
    groups = _groups(t_len, m, a.element_size(), chunk)
    # each group's entry and exit rows, from the groups' products
    entries = [al0[0].double()]
    exits = [torch.ones((m,), dtype=torch.float64, device=a.device)]
    if len(groups) > 1:
        prods = [_group_product(operators, a, bfull,
                                chunk_matrix(tokens, lo, hi, chunk))[0]
                 for lo, hi in groups]
        for p in prods[:-1]:
            entries.append(_unit(entries[-1] @ p))
        for p in prods[:0:-1]:
            exits.insert(0, _unit(p @ exits[0]))
        del prods
    total = torch.log(s0[0].double())
    grads = [torch.zeros_like(x) for x in (a, bfull, pi)]
    for (lo, hi), entry, exit_ in zip(groups, entries, exits):
        stream = chunk_matrix(tokens, lo, hi, chunk)
        ops, _ = operators(a, bfull, stream)
        alpha, beta = boundary_rows(ops, entry, exit_)
        if lo == 0:
            origin = _unit(ops[0].double() @ beta[0])
        del ops
        pad = torch.full((hi - lo, 1), PAD_TOKEN, dtype=stream.dtype,
                         device=stream.device)
        ll, parts = k2(a, bfull, pi, torch.cat([pad, stream], dim=1),
                       entry_alpha=alpha.to(a.dtype),
                       exit_beta=beta.to(a.dtype))
        total = total + ll
        for acc, g in zip(grads, parts):
            acc += g
    dpi, db0 = cuda_grad.column0_grads(e0, al0, s0, origin[None].to(a.dtype),
                                       pi, tokens[:1])
    grads[1] += db0
    grads[2] += dpi
    return total, tuple(grads)


def posterior_long(a, bfull, pi, tokens, *, chunk=None):
    """Posterior state probabilities (T, M) of one block, a 1-D token
    tensor, sequence-parallel: the contract of
    ``itrails_tpu/hmm/longseq.py:77 posterior_long``, the rows of
    :func:`posterior_long_pieces` joined."""
    return torch.cat(list(posterior_long_pieces(a, bfull, pi, tokens,
                                                chunk=chunk)))


def posterior_long_pieces(a, bfull, pi, tokens, *, chunk=None):
    """The posterior of one block, a 1-D token tensor, as a generator of
    (n, M) row pieces in column order, one a group of chunks, in the
    tables' dtype on their device; the pieces joined are
    :func:`posterior_long`.

    Columns 1..T-1 are cut into chunks of ``chunk`` columns (default
    ROUTE_CHUNK), the last right-padded with PAD.  K5 builds the
    chunks' forward operators ``G_c = prod (a diag e_k)`` and, on ``a^T``,
    their backward operators ``K_c = prod (a^T diag e_k)``: the posterior's
    backward, ``beta_{t-1} = a^T (e_t * beta_t)``, contracts over the
    source state (``cuda_posterior``), so its exit rows are not those of
    the G's.  :func:`entry_rows` of the G's gives alpha at every chunk's
    entry (from column 0's normalized alpha), :func:`exit_rows` of the K's
    beta at every chunk's exit (from ones).  One K4 call then takes every
    chunk as a window of ``chunk + 1`` columns, window c being block
    columns ``c chunk .. (c + 1) chunk``, entered through its entry row in
    place of column 0 (whose token it does not read) and left through its
    exit row; column 0 of window c > 0 repeats window c-1's last column and
    is dropped, and the last window is cut to the block's length.  The
    rows' scales cancel in gamma's normalization, so the operators' log
    scales are not used.

    The chunks are taken in groups whose two directions' operators and
    their f64 trees fit OPERATOR_BUDGET_BYTES and whose K4 store
    (``cuda_posterior.store_row_bytes`` a column of a window) fits
    ``cuda_posterior.POSTERIOR_BUDGET_BYTES``.  Above one group, a first
    pass keeps each group's forward and backward products (K5, then a fold
    in f64), the groups' entry and exit rows come from those, and each
    group's operators are built again for its rows and its K4 call; the
    device then holds one group's operators, trees and store, whatever the
    block's length.

    On the card K5 and K4 run in the tables' dtype (contiguous float32 or
    float64 tables, int32 tokens), with the boundary rows made in f64 and
    cast to it; on the CPU their plain versions run."""
    return _posterior_pieces(cuda_longseq.chunk_operators_fused,
                             cuda_posterior.posterior_fused, a, bfull, pi,
                             tokens, ROUTE_CHUNK if chunk is None else chunk)


def posterior_long_plain(a, bfull, pi, tokens, *, chunk=None):
    """:func:`posterior_long` with the plain versions of K5 (the contract
    ``chunk_operators``) and K4 on the tables' device and dtype: the
    reference the route is held against on the card."""
    return torch.cat(list(_posterior_pieces(
        _plain_operators, cuda_posterior.posterior_fused_plain, a, bfull, pi,
        tokens, ROUTE_CHUNK if chunk is None else chunk)))


def posterior_ranges(t_len, m, device, dtype, chunk=None):
    """``(lo, hi)`` chunk ranges of the groups in which
    :func:`posterior_long_pieces` takes a ``t_len``-column block at ``m``
    states, on ``device`` with tables of ``dtype``: their two directions'
    operators and f64 trees fit OPERATOR_BUDGET_BYTES and their K4 store
    fits ``cuda_posterior.POSTERIOR_BUDGET_BYTES``."""
    chunk = ROUTE_CHUNK if chunk is None else chunk
    size = torch.empty((), dtype=dtype).element_size()
    row_bytes = cuda_posterior.store_row_bytes(m, device, dtype)
    by_operators = OPERATOR_BUDGET_BYTES // (2 * m * m * (size + 8))
    by_store = cuda_posterior.POSTERIOR_BUDGET_BYTES // ((chunk + 1) * row_bytes)
    return _ranges(t_len, chunk, min(by_operators, by_store))


def _posterior_pieces(operators, k4, a, bfull, pi, tokens, chunk):
    t_len = tokens.shape[0]
    if t_len == 1:
        yield k4(a, bfull, pi, tokens[None])[0][:, 0, :]
        return
    m = a.shape[0]
    a_t = a.T.contiguous()
    _, al0, _ = cuda_fwd.column0(bfull, pi, tokens[:1])
    groups = posterior_ranges(t_len, m, a.device, a.dtype, chunk)
    # each group's entry and exit rows, from the groups' products
    entries = [al0[0].double()]
    exits = [torch.ones((m,), dtype=torch.float64, device=a.device)]
    for lo, hi in groups[:-1]:
        p = _group_product(operators, a, bfull,
                           chunk_matrix(tokens, lo, hi, chunk))[0]
        entries.append(_unit(entries[-1] @ p))
    for lo, hi in groups[:0:-1]:
        q = _group_product(operators, a_t, bfull,
                           chunk_matrix(tokens, lo, hi, chunk))[0]
        exits.insert(0, _unit(q @ exits[0]))
    for (lo, hi), entry, exit_ in zip(groups, entries, exits):
        stream = chunk_matrix(tokens, lo, hi, chunk)
        alpha = entry_rows(operators(a, bfull, stream)[0], entry)
        beta = exit_rows(operators(a_t, bfull, stream)[0], exit_)
        first = tokens[lo * chunk:hi * chunk:chunk, None]
        post, _ = k4(a, bfull, pi, torch.cat([first, stream], dim=1),
                     alpha0=alpha.to(a.dtype), beta_exit=beta.to(a.dtype))
        del alpha, beta
        # block columns lo chunk + 1 .. min(hi chunk, T - 1), and column 0
        # in the first group
        head = int(lo == 0)
        n = min(hi * chunk, t_len - 1) - lo * chunk
        rows = torch.empty((head + (hi - lo) * chunk, m), dtype=post.dtype,
                           device=post.device)
        rows[head:].view(hi - lo, chunk, m).copy_(post[1:].transpose(0, 1))
        if head:
            rows[0] = post[0, 0]
        del post  # the group's store goes before the next group runs
        yield rows[:head + n]


def viterbi_long(a, bfull, pi, tokens, *, chunk=None):
    """Viterbi path (T,) int32 of one block, a 1-D token tensor,
    sequence-parallel: the contract of ``itrails_tpu/hmm/longseq.py:298
    viterbi_long``, in K3's recursion (``hmm/cuda_viterbi.py``: logs
    clamped at NEG, omega rescaled by its max every column, the first index
    winning ties).

    Columns 1..T-1 are cut into chunks of ``chunk`` columns (default
    ROUTE_CHUNK), the last right-padded with PAD.  A first pass builds the
    chunks' max-plus operators with K6 (``cuda_maxplus.maxplus_operators``)
    and reads omega at every chunk's entry from them
    (``cuda_maxplus.entry_scan``, in f64 from column 0's omega); only those
    (C, M) entries are kept.  A second pass takes the chunks from last to
    first: one K3 forward (``cuda_viterbi.viterbi_forward``) over the
    (C, chunk + 1) windows, window c being block columns ``c chunk ..
    (c + 1) chunk`` entered through its entry omega; K3's entry map
    (``cuda_viterbi.entry_map``: for every window and exit state, the
    state at its column 0); the chain (``cuda_viterbi.chain``): the last
    window leaves in the argmax of its final omega, and window c leaves in
    the state at window c+1's column 0; then K3's backtrack
    (``cuda_viterbi.viterbi_backtrack``) of every window from its exit
    state.  No walk is longer than a chunk.

    The chunks are taken in the groups of :func:`viterbi_ranges`, whose
    operators fit OPERATOR_BUDGET_BYTES and whose pointer table fits
    ``cuda_viterbi.POINTER_BUDGET_BYTES``: the first pass carries omega
    from group to group, and the second hands each group the state at the
    next group's first column.  The device then holds one group's
    operators or pointer table, and the (C, M) entries, whatever the
    block's length.

    On the card the kernels run in float32 (the tables must be contiguous
    float32, M <= 224); on the CPU their plain versions run in the dtype of
    ``a``.  The kernels take the plain versions' operations in their order,
    so the card's path equals the CPU's float32 path bit for bit."""
    return _viterbi_long(False, a, bfull, pi, tokens, chunk)


def viterbi_long_plain(a, bfull, pi, tokens, *, chunk=None):
    """:func:`viterbi_long` with the plain versions of K6, its scan and K3's
    parts on the tables' device and dtype: the reference the route is held
    against on the card."""
    return _viterbi_long(True, a, bfull, pi, tokens, chunk)


def viterbi_ranges(t_len, m, dtype, chunk=None):
    """``(lo, hi)`` chunk ranges of the groups in which :func:`viterbi_long`
    takes a ``t_len``-column block at ``m`` states with tables of
    ``dtype``: their operators (M^2 entries of the dtype and M f64 offsets
    a chunk) fit OPERATOR_BUDGET_BYTES and their pointer table (``chunk``
    x M a chunk, uint8; int32 above 255 states) fits
    ``cuda_viterbi.POINTER_BUDGET_BYTES``."""
    chunk = ROUTE_CHUNK if chunk is None else chunk
    size = torch.empty((), dtype=dtype).element_size()
    ptr_size = 1 if m <= 255 else 4
    by_operators = OPERATOR_BUDGET_BYTES // (m * m * size + 8 * m)
    by_pointers = cuda_viterbi.POINTER_BUDGET_BYTES // (chunk * m * ptr_size)
    return _ranges(t_len, chunk, min(by_operators, by_pointers))


def _route_steps(plain):
    """K6, its scan and K3's four parts: the wrappers, or their plain
    versions."""
    if plain:
        return (cuda_maxplus.maxplus_operators_plain,
                cuda_maxplus.entry_scan_plain,
                cuda_viterbi.viterbi_forward_plain,
                cuda_viterbi.entry_map_plain, cuda_viterbi.chain_plain,
                cuda_viterbi.viterbi_backtrack_plain)
    return (cuda_maxplus.maxplus_operators, cuda_maxplus.entry_scan,
            cuda_viterbi.viterbi_forward, cuda_viterbi.entry_map,
            cuda_viterbi.chain, cuda_viterbi.viterbi_backtrack)


def _viterbi_long(plain, a, bfull, pi, tokens, chunk):
    operators, scan, forward, entry_map, chain, backtrack = _route_steps(plain)
    chunk = ROUTE_CHUNK if chunk is None else chunk
    t_len = tokens.shape[0]
    log_a, log_bt, log_pi = cuda_viterbi.log_tables(a, bfull, pi)
    omega = cuda_viterbi.column0(log_bt, log_pi, tokens[:1])[0]
    if t_len == 1:
        return omega.argmax().to(torch.int32).reshape(1)
    groups = viterbi_ranges(t_len, a.shape[0], a.dtype, chunk)
    entries = []
    omega = omega.double()
    for lo, hi in groups:
        g, off = operators(log_a, log_bt, chunk_matrix(tokens, lo, hi, chunk))
        ent, omega = scan(g, off, omega)
        del g, off
        entries.append(ent)
    path = torch.empty((t_len,), dtype=torch.int32, device=tokens.device)
    start = None  # the last group leaves in the argmax of its final omega
    for (lo, hi), ent in zip(groups[::-1], entries[::-1]):
        first = tokens[lo * chunk:hi * chunk:chunk, None]
        windows = torch.cat([first, chunk_matrix(tokens, lo, hi, chunk)], dim=1)
        ptrs, om = forward(log_a, log_bt, ent, windows)
        states = chain(entry_map(ptrs), om[-1], start)
        rows = backtrack(ptrs, om, states[1:])
        del ptrs
        # block columns lo chunk + 1 .. min(hi chunk, T - 1)
        n = min(hi * chunk, t_len - 1) - lo * chunk
        path[lo * chunk + 1:lo * chunk + 1 + n] = rows[:, 1:].reshape(-1)[:n]
        start = states[:1]  # the state at this group's first column
    path[0] = start[0]
    return path
