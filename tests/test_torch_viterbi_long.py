"""A long block's Viterbi path by the sequence-parallel route
(``hmm/longseq.py:viterbi_long``: K6's max-plus chunk operators, omega at
every chunk's entry from its scan, one K3 forward over the chunk windows,
K3's entry map, the chain and K3's backtrack) against the JAX package's
``longseq.viterbi_long`` and the port's one-window path, on the CPU; on
the card, every kernel of the route against its plain version and the
route against the CPU's float32 route.

Paths are held exactly, first-index ties included, as
tests/test_pallas_viterbi.py holds the TPU kernel.  The operators and the
entry omegas are held against max-plus products and the one-window omega
written out here at atol 1e-9 in f64 (the same maxima, summed in another
order); on the card, every kernel against its plain version bit for
bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden

torch.set_num_threads(1)

# (T, chunk): two columns, one chunk and a column, T-1 a multiple of the
# chunk, several chunks with a PAD run over a whole chunk and a PAD tail,
# and one chunk holding the whole block
CASES = [(2, 16), (17, 16), (1 + 4 * 64, 64), (700, 64), (3001, 128),
         (700, 700)]


def _random_model(m, seed, tie=False):
    """``(a, bfull, pi)`` in f64 numpy, ``a`` far from symmetric.  With
    ``tie``, states 0 and 1 are exchangeable (equal rows and columns of a,
    equal emission rows, equal pi), so every column holds exact ties."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, m)) ** 3 + np.eye(m)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    if tie:
        a[1] = a[0]
        a[:, 1] = a[:, 0]
        bfull[1] = bfull[0]
        pi[1] = pi[0]
    a /= a.sum(1, keepdims=True)
    pi /= pi.sum()
    return a, bfull, pi


def _golden_model(tag):
    from itrails_tpu_torch.data.tokens import aggregation_matrix

    g = load_golden(f"model_{tag}.npz")
    return g["a"], g["b"] @ aggregation_matrix().T, g["pi"]


def _model(name):
    if name == "ties":
        return _random_model(27, seed=3, tie=True)
    return _golden_model(name)


def _block(t_len, seed):
    """``t_len`` uniform tokens (ambiguity codes >= 256 among them), with a
    PAD run of 90 columns and a PAD tail where the block is long enough."""
    tok = np.random.default_rng(seed).integers(0, 625, size=t_len)
    if t_len > 100:
        tok[t_len // 3:t_len // 3 + 90] = -1
        tok[-9:] = -1
    return tok.astype(np.int32)


def _torch(tables, dtype=torch.float64):
    return [torch.as_tensor(np.asarray(x), dtype=dtype) for x in tables]


def _one_window(tables, tok):
    from itrails_tpu_torch.hmm import cuda_viterbi

    return cuda_viterbi.viterbi_fused(*tables, torch.as_tensor(tok)[None])[0][0]


def _log_score(tables, tok, path):
    """f64 log-score of a state path under the JAX package's logs of the
    tables: log pi, the log emissions of its columns, its log transitions;
    PAD columns add nothing."""
    a, bfull, pi = (np.log(np.asarray(x)) for x in tables)
    real = tok >= 0
    e = bfull.T[np.clip(tok, 0, 624), path]
    return (pi[path[0]] + e[real].sum()
            + a[path[:-1], path[1:]][real[1:]].sum())


@pytest.mark.parametrize("name", ["1x2", "3x3", "ties"])
@pytest.mark.parametrize("t_len,chunk", CASES)
def test_route_matches_jax_viterbi_long(name, t_len, chunk):
    """Against the JAX ``viterbi_long`` at the same chunk, and against the
    JAX package's sequential decoder (``decoders.viterbi``, whose
    first-index rule the JAX route documents), exactly.  The golden models
    hold exchangeable states, whose exact ties the JAX route can break
    otherwise than its own sequential decoder (its associative scan rounds
    in another order: at 2 of 3,001 columns in each golden model here).
    At such a column the port follows the sequential decoder, and the two
    paths' log-scores tie."""
    from itrails_tpu.hmm import decoders as jax_decoders
    from itrails_tpu.hmm.longseq import viterbi_long as jax_viterbi_long
    from itrails_tpu_torch.hmm import longseq

    tables = _model(name)
    tok = _block(t_len, seed=t_len)
    got = longseq.viterbi_long(*_torch(tables), torch.as_tensor(tok),
                               chunk=chunk)
    jt = [jnp.asarray(x) for x in tables]
    ref = np.asarray(jax_viterbi_long(*jt, jnp.asarray(tok), chunk=chunk))
    seq = np.asarray(jax_decoders.viterbi(*jt, jnp.asarray(tok)[None]))[0]
    assert got.dtype == torch.int32 and tuple(got.shape) == (t_len,)
    np.testing.assert_array_equal(got.numpy(), seq)
    apart = ref != seq  # where the JAX route leaves its sequential path
    np.testing.assert_array_equal(got.numpy()[~apart], ref[~apart])
    if apart.any():
        assert name != "ties" and apart.sum() <= 2
        assert _log_score(tables, tok, ref) == pytest.approx(
            _log_score(tables, tok, seq), rel=1e-15, abs=1e-9)
    if name == "ties":  # the first index wins every tie: state 1 never
        assert not (ref == 1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["3x3", "ties"])
@pytest.mark.parametrize("t_len,chunk", CASES)
def test_route_matches_the_one_window_path(name, t_len, chunk, dtype):
    """Every column, PAD columns included, of the route and of K3's plain
    version walking the block as one window, in both dtypes."""
    from itrails_tpu_torch.hmm import longseq

    tables = _torch(_model(name), dtype)
    tok = torch.as_tensor(_block(t_len, seed=t_len + 1))
    got = longseq.viterbi_long(*tables, tok, chunk=chunk)
    assert torch.equal(got, _one_window(tables, tok))


@pytest.mark.parametrize("t_len", [1, 2, 300])
def test_a_pad_first_column_follows_the_ports_pad_rule(t_len):
    """A block that starts with PAD enters as log pi (PAD's log emission
    row is 0), as the one-window path does; one column is column 0's
    argmax."""
    from itrails_tpu_torch.hmm import longseq

    tables = _torch(_model("3x3"))
    tok = _block(t_len, seed=5)
    tok[0] = -1
    got = longseq.viterbi_long(*tables, torch.as_tensor(tok), chunk=32)
    assert torch.equal(got, _one_window(tables, tok))


def test_map_and_chain_backtrack_is_a_serial_walk():
    """On one pointer table of chunk windows: the entry map, the chain and
    the backtrack from each window's exit state give the path a serial walk
    back through the whole table gives, state for state."""
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    a, bfull, pi = _torch(_model("3x3"))
    chunk, t_len = 40, 1 + 9 * 40 - 7
    tok = torch.as_tensor(_block(t_len, seed=9))
    log_a, log_bt, log_pi = cuda_viterbi.log_tables(a, bfull, pi)
    omega = cuda_viterbi.column0(log_bt, log_pi, tok[:1])[0].double()
    stream = longseq.chunk_matrix(tok, 0, 9, chunk)
    entries, _ = cuda_maxplus.entry_scan(
        *cuda_maxplus.maxplus_operators(log_a, log_bt, stream), omega)
    windows = torch.cat([tok[0:9 * chunk:chunk, None], stream], dim=1)
    ptrs, om = cuda_viterbi.viterbi_forward(log_a, log_bt, entries, windows)
    maps = cuda_viterbi.entry_map(ptrs)
    states = cuda_viterbi.chain(maps, om[-1])
    rows = cuda_viterbi.viterbi_backtrack(ptrs, om, states[1:])

    flat = ptrs.reshape(-1, 27)  # block columns 1 .. 9 chunk, in order
    state = int(om[-1].argmax())
    serial = [state]
    for t in range(flat.shape[0] - 1, -1, -1):
        state = int(flat[t, state])
        serial.append(state)
    serial = torch.tensor(serial[::-1], dtype=torch.int32)
    assert torch.equal(rows[:, 1:].reshape(-1), serial[1:])
    assert torch.equal(rows[:, 0], states[:-1])
    assert torch.equal(rows[:, -1], states[1:])
    assert int(states[0]) == int(serial[0])
    for w in range(9):  # the map is each window's own walk, exit by exit
        for s in range(27):
            state = s
            for t in range(chunk - 1, -1, -1):
                state = int(ptrs[w, t, state])
            assert int(maps[w, s]) == state


def test_operators_are_the_max_plus_products_of_the_columns():
    """K6's plain operators, ``g + off``, against the (max, +) product of
    each chunk's column operators ``log_a + log_e(tok)`` written out in f64
    (a PAD column the (max, +) identity), from the unit operator with NEG
    off the diagonal."""
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi

    a, bfull, pi = _torch(_random_model(7, seed=4))
    tok = torch.as_tensor(_block(3 * 30, seed=10).reshape(3, 30))
    tok[1, 5:25] = -1
    tok[2, :] = -1  # an all-PAD chunk: the unit operator, offsets 0
    log_a, log_bt, _ = cuda_viterbi.log_tables(a, bfull, pi)
    g, off = cuda_maxplus.maxplus_operators(log_a, log_bt, tok)
    assert g.dtype == torch.float64 and off.dtype == torch.float64
    for c in range(3):
        want = torch.full((7, 7), cuda_viterbi.NEG, dtype=torch.float64)
        want.fill_diagonal_(0)
        for t in range(30):
            if tok[c, t] >= 0:
                step = log_a + log_bt[int(tok[c, t])][None, :]
                want = (want[:, :, None] + step[None]).amax(dim=1)
        np.testing.assert_allclose((g[c] + off[c][:, None]).numpy(),
                                   want.numpy(), rtol=0, atol=1e-9)
    assert torch.equal(off[2], torch.zeros(7, dtype=torch.float64))
    assert float(g.amax(dim=2).abs().max()) == 0.0  # every row's max is 0


def test_entry_omegas_are_the_one_window_omegas():
    """The scan's omega at every chunk's entry against K3's one-window omega
    at the same block column (both rescaled to max 0)."""
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    a, bfull, pi = _torch(_model("3x3"))
    chunk, n_chunks = 32, 7
    tok = torch.as_tensor(_block(1 + n_chunks * chunk, seed=12))
    log_a, log_bt, log_pi = cuda_viterbi.log_tables(a, bfull, pi)
    om0 = cuda_viterbi.column0(log_bt, log_pi, tok[:1])
    stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
    entries, out = cuda_maxplus.entry_scan(
        *cuda_maxplus.maxplus_operators(log_a, log_bt, stream), om0[0].double())
    for c in range(n_chunks + 1):
        _, om = cuda_viterbi.viterbi_forward_plain(
            log_a, log_bt, om0, tok[None, :1 + c * chunk])
        got = entries[c] if c < n_chunks else out
        np.testing.assert_allclose(got.numpy(), om[0].numpy(), rtol=0,
                                   atol=1e-9)


def test_groups_under_lowered_budgets_equal_one_group(monkeypatch):
    """Under a budget of three chunks' operators, then of two chunks'
    pointer tables, the first pass carries omega from group to group and
    the second hands each group the next group's first state: the path is
    one group's, with one launch of each part a group."""
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    tables = _torch(_model("3x3"))
    tok = torch.as_tensor(_block(1 + 11 * 32 - 5, seed=8))
    whole = longseq.viterbi_long(*tables, tok, chunk=32)
    m = 27
    for budgets, sizes in (((3 * (m * m * 8 + 8 * m), None), [3, 3, 3, 2]),
                           ((None, 2 * 32 * m), [2, 2, 2, 2, 2, 1])):
        calls = {"K6": [], "forward": []}
        k6, fwd = cuda_maxplus.maxplus_operators, cuda_viterbi.viterbi_forward

        def spy_k6(log_a, log_bt, stream):
            calls["K6"].append(stream.shape[0])
            return k6(log_a, log_bt, stream)

        def spy_forward(log_a, log_bt, omega0, windows):
            calls["forward"].append(tuple(windows.shape))
            return fwd(log_a, log_bt, omega0, windows)

        with monkeypatch.context() as patch:
            ops_budget, ptr_budget = budgets
            if ops_budget is not None:
                patch.setattr(longseq, "OPERATOR_BUDGET_BYTES", ops_budget)
            if ptr_budget is not None:
                patch.setattr(cuda_viterbi, "POINTER_BUDGET_BYTES", ptr_budget)
            patch.setattr(cuda_maxplus, "maxplus_operators", spy_k6)
            patch.setattr(cuda_viterbi, "viterbi_forward", spy_forward)
            assert [hi - lo for lo, hi in longseq.viterbi_ranges(
                len(tok), m, torch.float64, 32)] == sizes
            got = longseq.viterbi_long(*tables, tok, chunk=32)
        assert calls["K6"] == sizes
        assert calls["forward"] == [(n, 33) for n in sizes[::-1]]
        assert torch.equal(got, whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_chromosome_block_at_133_states_stays_under_the_budgets(dtype):
    """1e7 columns at M = 133: every group's operators fit the operator
    budget and its pointer table the pointer budget."""
    from itrails_tpu_torch.hmm import cuda_viterbi, longseq

    m, t_len, size = 133, 10_000_000, torch.empty((), dtype=dtype).element_size()
    groups = longseq.viterbi_ranges(t_len, m, dtype)
    chunk = longseq.ROUTE_CHUNK
    assert groups[0][0] == 0 and groups[-1][1] == -(-(t_len - 1) // chunk)
    assert all(b[0] == a[1] for a, b in zip(groups, groups[1:]))
    for lo, hi in groups:
        assert (hi - lo) * (m * m * size + 8 * m) <= longseq.OPERATOR_BUDGET_BYTES
        assert (hi - lo) * chunk * m <= cuda_viterbi.POINTER_BUDGET_BYTES
    assert len(groups) == (2 if dtype == torch.float32 else 3)


def test_cpu_route_runs_the_plain_versions_and_counts_no_launch():
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    counters = (cuda_maxplus.maxplus_operators, cuda_maxplus.entry_scan,
                cuda_viterbi.viterbi_forward, cuda_viterbi.entry_map,
                cuda_viterbi.chain, cuda_viterbi.viterbi_backtrack)
    before = [f.launches for f in counters]
    tables = _torch(_model("3x3"), torch.float32)
    tok = torch.as_tensor(_block(500, seed=13))
    got = longseq.viterbi_long(*tables, tok, chunk=64)
    assert torch.equal(got, longseq.viterbi_long_plain(*tables, tok, chunk=64))
    assert [f.launches for f in counters] == before


def test_run_viterbi_sends_long_blocks_through_the_route(monkeypatch):
    """Every block above the threshold goes through the route, whatever
    its length; the short blocks stay one window batch; no one-window K3
    call and no segmented route walks a long block."""
    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.hmm import cuda_viterbi, decoders, longseq

    tables = _torch(_model("3x3"), torch.float32)
    rng = np.random.default_rng(14)
    v_lst = [rng.integers(0, 625, size=n).astype(np.int32)
             for n in (40, 700, 90, 1301)]
    monkeypatch.setattr(decode, "LONG_BLOCK_THRESHOLD", 100)
    monkeypatch.setattr(longseq, "ROUTE_CHUNK", 64)
    routed, batches = [], []
    route, fused = longseq.viterbi_long, cuda_viterbi.viterbi_fused

    def spy_route(a, bfull, pi, tokens, **kw):
        routed.append(len(tokens))
        return route(a, bfull, pi, tokens, **kw)

    def spy_fused(a, bfull, pi, tokens, **kw):
        batches.append(tuple(tokens.shape))
        return fused(a, bfull, pi, tokens, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the segmented route is off the CLI's path")

    monkeypatch.setattr(longseq, "viterbi_long", spy_route)
    monkeypatch.setattr(cuda_viterbi, "viterbi_fused", spy_fused)
    monkeypatch.setattr(decoders, "viterbi_segmented", refuse)
    paths = decode.run_viterbi(*tables, v_lst)
    assert routed == [700, 1301]
    assert len(batches) == 1 and batches[0][0] == 2
    for v, p in zip(v_lst, paths):
        assert p.dtype == np.int32
        np.testing.assert_array_equal(p, _one_window(tables, v).numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,tie", [(27, False), (27, True), (36, False),
                                   (133, False), (224, False)])
def test_kernels_of_the_route_match_their_plain_versions(cuda_device, m, tie):
    """K6, the scan, and K3's forward, entry map, chain and backtrack on the
    card against their plain versions on the same inputs, bit for bit."""
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    a, bfull, pi = _torch(_random_model(m, seed=m, tie=tie), torch.float32)
    tok = torch.as_tensor(_block(1 + 23 * 64 - 11, seed=m))
    log_a, log_bt, log_pi = (x.to(cuda_device) for x in
                             cuda_viterbi.log_tables(a, bfull, pi))
    tok = tok.to(cuda_device)
    omega = cuda_viterbi.column0(log_bt, log_pi, tok[:1])[0].double()
    stream = longseq.chunk_matrix(tok, 0, 23, 64)
    g, off = cuda_maxplus.maxplus_operators(log_a, log_bt, stream)
    g_ref, off_ref = cuda_maxplus.maxplus_operators_plain(log_a, log_bt, stream)
    assert torch.equal(g, g_ref) and torch.equal(off, off_ref)
    entries, out = cuda_maxplus.entry_scan(g, off, omega)
    ent_ref, out_ref = cuda_maxplus.entry_scan_plain(g, off, omega)
    assert torch.equal(entries, ent_ref) and torch.equal(out, out_ref)
    windows = torch.cat([tok[0:23 * 64:64, None], stream], dim=1)
    ptrs, om = cuda_viterbi.viterbi_forward(log_a, log_bt, entries, windows)
    p_ref, om_ref = cuda_viterbi.viterbi_forward_plain(log_a, log_bt, entries,
                                                       windows)
    assert torch.equal(ptrs, p_ref) and torch.equal(om, om_ref)
    maps = cuda_viterbi.entry_map(ptrs)
    assert torch.equal(maps, cuda_viterbi.entry_map_plain(ptrs))
    states = cuda_viterbi.chain(maps, om[-1])
    assert torch.equal(states, cuda_viterbi.chain_plain(maps, om[-1]))
    start = states[3:4]
    assert torch.equal(cuda_viterbi.chain(maps, om[-1], start),
                       cuda_viterbi.chain_plain(maps, om[-1], start))
    rows = cuda_viterbi.viterbi_backtrack(ptrs, om, states[1:])
    assert torch.equal(rows, cuda_viterbi.viterbi_backtrack_plain(
        ptrs, om, states[1:]))
    assert torch.equal(cuda_viterbi.viterbi_backtrack(ptrs, om),
                       cuda_viterbi.viterbi_backtrack_plain(ptrs, om))


@pytest.mark.gpu
@pytest.mark.parametrize("m,tie", [(27, False), (27, True), (133, False)])
def test_route_on_the_card_is_the_cpu_float32_route(cuda_device, m, tie,
                                                    monkeypatch):
    """The route on the card, in one group and in several, equals the CPU's
    float32 route bit for bit, with one launch of each of its six kernels a
    group."""
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    tables = _torch(_random_model(m, seed=2 * m, tie=tie), torch.float32)
    tok = torch.as_tensor(_block(1 + 40 * 64 - 3, seed=2 * m))
    cpu = longseq.viterbi_long(*tables, tok, chunk=64)
    gpu = [x.to(cuda_device) for x in tables]
    counters = (cuda_maxplus.maxplus_operators, cuda_maxplus.entry_scan,
                cuda_viterbi.viterbi_forward, cuda_viterbi.entry_map,
                cuda_viterbi.chain, cuda_viterbi.viterbi_backtrack)
    for budget, groups in ((None, 1), (7 * 64 * m, 6)):
        with monkeypatch.context() as patch:
            if budget is not None:
                patch.setattr(cuda_viterbi, "POINTER_BUDGET_BYTES", budget)
            before = [f.launches for f in counters]
            got = longseq.viterbi_long(*gpu, tok.to(cuda_device), chunk=64)
            torch.cuda.synchronize()
            assert [f.launches - b for f, b in zip(counters, before)] == [groups] * 6
        assert torch.equal(got.cpu(), cpu)
    if tie:
        assert not bool((cpu == 1).any())


@pytest.mark.gpu
def test_route_raises_on_inputs_the_kernels_do_not_take(cuda_device):
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    a, bfull, pi = (x.to(cuda_device) for x in
                    _torch(_random_model(27, seed=1), torch.float32))
    tok = torch.as_tensor(_block(600, seed=2)).to(cuda_device)
    before = cuda_maxplus.maxplus_operators.launches
    with pytest.raises(ValueError, match="float32"):
        longseq.viterbi_long(a.double(), bfull.double(), pi.double(), tok)
    with pytest.raises(ValueError, match="tokens"):
        longseq.viterbi_long(a, bfull, pi, tok.long())
    big = torch.full((225, 225), 1.0 / 225, device=cuda_device)
    with pytest.raises(ValueError, match="states"):
        longseq.viterbi_long(big, torch.full((225, 625), 0.01, device=cuda_device),
                             torch.full((225,), 1.0 / 225, device=cuda_device), tok)
    assert cuda_maxplus.maxplus_operators.launches == before
    log_a, log_bt, _ = cuda_viterbi.log_tables(a, bfull, pi)
    g, off = cuda_maxplus.maxplus_operators(
        log_a, log_bt, longseq.chunk_matrix(tok, 0, 2, 64))
    with pytest.raises(ValueError, match="off"):
        cuda_maxplus.entry_scan(g, off.float(), torch.zeros(27, dtype=torch.float64,
                                                           device=cuda_device))
