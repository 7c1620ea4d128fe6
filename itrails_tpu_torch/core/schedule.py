"""Host-side schedule compiler for the discretized-interval CTMC dynamic
program.

The reference implementation (run_markov_chain_AB.py / run_markov_chain_ABC.py)
carries a Python dict keyed by *gene-tree paths* ``((l0,l1,l2),(r0,r1,r2))``
(per-locus: topology code, first- and second-coalescence interval, with -1
sentinels) and, at every time interval, fans each key out over "coalesce now /
don't" candidates with omega-class mask products, Van Loan integrals for
multi-coalescence intervals, and t->inf integrals in the last interval.

The fan-out structure depends only on ``(n_int_AB, n_int_ABC)`` — never on the
model parameters.  This module traces it ONCE into a :class:`Plan` of static
integer index/mask arrays; ``core.ctmc`` then executes the plan as a handful
of batched masked matmuls / expms per interval.  Hidden-state
bookkeeping (sorted state order, joint-matrix scatter indices) is also
resolved here.

Key semantic anchors in the reference (cited for parity review):
  * candidate fan-out:          run_markov_chain_ABC.py:360-392
  * Van Loan trigger condition: run_markov_chain_ABC.py:412-420
  * omega of a path key:        helper_omegas.py:25-87
  * Van Loan path enumeration:  vanloan.py:6-252  (+ key transform :362-385)
  * final-interval case split:  run_markov_chain_ABC.py:536-769
  * deepest-TI path enumeration: deepest_ti.py:4-144
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from itrails_tpu_torch.core.statespace import (
    OMEGA_CODE_TO_TOPOLOGY,
    StateSpace,
    state_space,
)

__all__ = ["Plan", "build_plan", "hidden_state_list"]

UNSET = -1
Side = tuple  # (code, i, j)
Key = tuple  # (Side, Side)
START: Key = ((-1, -1, -1), (-1, -1, -1))


def side_omega(side: Side) -> int:
    """Omega class of one locus of a path key (reference
    helper_omegas.py:25-87; code 4 = introgressed first coalescence B+C in
    the BC population, omega class 6, int family only)."""
    c, i, j = side
    if c == -1:
        return 7 if (i == j and i != -1) else 0
    if j != -1:
        return 7
    return {0: 3, 1: 3, 2: 5, 3: 6, 4: 6}[c]


def key_omega(key: Key) -> tuple:
    return (side_omega(key[0]), side_omega(key[1]))


def _needs_vanloan(side: Side) -> bool:
    """Reference run_markov_chain_ABC.py:412-420: a candidate side routed
    through the Van Loan branch.  Codes 0 and 4 carry an earlier-epoch
    interval index in ``i``, so ``i == j`` is coincidental for them, not a
    same-interval double coalescence."""
    c, i, j = side
    return c not in (0, 4) and i == j and i != -1


class _MaskRegistry:
    """Interns omega-class sets -> small integer ids and materialises the
    corresponding boolean state masks.  A key is either a single
    ``(l_omega, r_omega)`` pair or a frozenset of pairs (union mask)."""

    def __init__(self, space: StateSpace, keep: np.ndarray | None = None):
        self.space = space
        self.keep = keep  # optional bool mask restricting the state set
        self.keys: list = []
        self._ids: dict = {}

    def intern(self, pair: tuple) -> int:
        return self._intern(pair)

    def intern_union(self, pairs) -> int:
        return self._intern(frozenset(pairs))

    def _intern(self, key) -> int:
        if key not in self._ids:
            pairs = key if isinstance(key, frozenset) else (key,)
            for p in pairs:
                if p not in self.space.omega_masks:
                    raise KeyError(
                        f"omega class {p} is empty for species={self.space.species}"
                    )
            self._ids[key] = len(self.keys)
            self.keys.append(key)
        return self._ids[key]

    def materialize(self) -> np.ndarray:
        n_cols = self.space.n_states if self.keep is None else int(self.keep.sum())
        if not self.keys:
            return np.zeros((0, n_cols), dtype=np.float64)
        out = []
        for key in self.keys:
            pairs = key if isinstance(key, frozenset) else (key,)
            m = np.zeros(self.space.n_states, dtype=bool)
            for p in pairs:
                m |= self.space.omega_masks[p]
            out.append(m)
        masks = np.stack(out)
        if self.keep is not None:
            masks = masks[:, self.keep]
        return masks.astype(np.float64)


def enumerate_vl_paths(start: tuple, end: tuple, events: dict):
    """All monotone omega-lattice paths ``start -> end`` advancing one
    non-reversible coalescence on the left, the right, or both per step
    (reference vanloan.py:6-252).

    Returns a list of ``(path, by_l, by_r)`` where ``path`` is the list of
    omega pairs visited (inclusive of endpoints) and ``by_l``/``by_r`` is the
    first intermediate single-coalescence omega on that side when the side
    takes two steps (else -1).
    """
    singles = [o for o, k in events.items() if k == 1]
    out = []

    def rec(cur, path, by_l, by_r):
        if cur == end:
            out.append((list(path), by_l, by_r))
            return
        cl, cr = events[cur[0]], events[cur[1]]
        el, er = events[end[0]], events[end[1]]
        moves = []
        if cl < el:
            for ol in sorted(singles) if cl + 1 == 1 else [end[0]]:
                # next left omega has event count cl+1; count-1 omegas are the
                # single-coalescence codes, count-2 is 7 (== end code here)
                moves.append((ol, cur[1]))
        if cr < er:
            for orr in sorted(singles) if cr + 1 == 1 else [end[1]]:
                moves.append((cur[0], orr))
        if cl < el and cr < er:
            lefts = sorted(singles) if cl + 1 == 1 else [end[0]]
            rights = sorted(singles) if cr + 1 == 1 else [end[1]]
            for ol in lefts:
                for orr in rights:
                    moves.append((ol, orr))
        for nxt in moves:
            nl = by_l
            nr = by_r
            if nxt[0] != cur[0] and by_l == -1 and events[nxt[0]] == 1 and cl + 1 != el:
                nl = nxt[0]
            if nxt[1] != cur[1] and by_r == -1 and events[nxt[1]] == 1 and cr + 1 != er:
                nr = nxt[1]
            path.append(nxt)
            rec(nxt, path, nl, nr)
            path.pop()

    rec(start, [start], -1, -1)
    return out


def enumerate_deep_paths(start: tuple, events: dict):
    """Paths towards the absorbing class (7,7), terminated as soon as each
    side has at most one coalescence left (reference deepest_ti.py:4-144).

    Returns ``(path, by_l, by_r)`` tuples like :func:`enumerate_vl_paths`.
    """
    singles = [o for o, k in events.items() if k == 1]
    end = (7, 7)
    out = []

    def rec(cur, path, by_l, by_r):
        cl, cr = events[cur[0]], events[cur[1]]
        el, er = events[end[0]], events[end[1]]
        if el - cl <= 1 and er - cr <= 1:
            out.append((list(path), by_l, by_r))
            return
        moves = []
        if cl < el:
            for ol in sorted(singles) if cl + 1 == 1 else [7]:
                moves.append((ol, cur[1]))
        if cr < er:
            for orr in sorted(singles) if cr + 1 == 1 else [7]:
                moves.append((cur[0], orr))
        if cl < el and cr < er:
            lefts = sorted(singles) if cl + 1 == 1 else [7]
            rights = sorted(singles) if cr + 1 == 1 else [7]
            for ol in lefts:
                for orr in rights:
                    moves.append((ol, orr))
        for nxt in moves:
            nl = by_l
            nr = by_r
            if nxt[0] != cur[0] and by_l == -1 and events[nxt[0]] == 1 and cl + 1 != el:
                nl = nxt[0]
            if nxt[1] != cur[1] and by_r == -1 and events[nxt[1]] == 1 and cr + 1 != er:
                nr = nxt[1]
            path.append(nxt)
            rec(nxt, path, nl, nr)
            path.pop()

    rec(start, [start], -1, -1)
    return out


@dataclass
class StepPlan:
    """One time-interval update of the interval DP.

    Normal transitions: ``child_val = (P[parent] * mask[m_start]) @ E_s
    * mask[m_end]`` (``m_start == -1`` means no start mask — first AB step).

    Multi-coalescence ("Van Loan") transitions use a *union-restricted*
    propagator instead of the reference's per-subpath Van Loan block
    exponentials: because omega classes advance monotonically, the sum of the
    reference's Van Loan integrals over all subpath interleavings of a
    ``(by_l, by_r)`` group (vanloan.py:255-425, run_markov_chain_ABC.py:
    412-456) equals ``diag(m_start) expm(diag(u) Q diag(u) * dt)
    diag(m_end)`` where ``u`` is the union of the omega-class masks visited
    by the group's subpaths (verified to machine precision in
    tests/test_joint.py).  So: ``child_val = (P[vl_parent] * mask[vl_m_start])
    @ E_u[vl_prop] * mask[vl_m_end]`` with one extra batched expm per step
    over ``vl_unions``.
    """

    parent: np.ndarray
    child: np.ndarray
    m_start: np.ndarray
    m_end: np.ndarray
    # Van Loan transitions
    vl_parent: np.ndarray
    vl_child: np.ndarray
    vl_m_start: np.ndarray
    vl_m_end: np.ndarray
    vl_prop: np.ndarray  # (V,) index into vl_unions
    vl_unions: np.ndarray  # (U,) union-mask registry ids for this step


@dataclass
class DeepGroup:
    """Deepest-interval (t->inf) contributions with a common chain length m
    (= number of omega states on the path).

    value contribution to joint[out] = sum_states( (P[src][keep]) @ N A_1 N
    A_2 ... N A_{m-1} ) where A_i = diag(mask[path[i-1]]) Q_noabs
    diag(mask[path[i]]) and N = (-Q_noabs)^{-1}  (block-bidiagonal inverse of
    the reference's (-C)^{-1}[:n,-n:] @ A_last, deepest_ti.py:215-256).
    """

    m: int
    src: np.ndarray  # (P,) source key index
    out: np.ndarray  # (P,) output entry index (into final joint scatter)
    path: np.ndarray  # (P, m) mask ids (over the no-absorbing state set)


@dataclass
class Plan:
    n_int_AB: int
    n_int_ABC: int
    # --- AB chain ---
    ab_n_keys: int
    ab_steps: list
    ab_masks: np.ndarray  # (n_ab_masks, 15)
    ab_final_keys: list  # key tuples, index-aligned with AB key ids
    # --- ABC chain ---
    abc_n_keys: int
    abc_init_from_ab: np.ndarray  # (ab_n_keys,) ABC key id of each AB final key
    abc_steps: list
    abc_masks: np.ndarray  # (n_abc_masks, 203)
    # --- final interval ---
    keep_mask: np.ndarray  # (203,) bool, False at the 2 absorbing states
    noabs_masks: np.ndarray  # (n_deep_masks, 201)
    direct_src: np.ndarray  # (D,) key index whose total mass goes to an entry
    direct_out: np.ndarray  # (D,) output entry index
    deep_groups: list  # list[DeepGroup]
    n_entries: int
    # --- joint-matrix assembly ---
    hidden_states: list  # sorted (code, i, j) tuples
    entry_row: np.ndarray  # (n_entries,) hidden row index
    entry_col: np.ndarray  # (n_entries,) hidden col index


def hidden_state_list(n_int_AB: int, n_int_ABC: int,
                      introgression: bool = False) -> list:
    """All HMM hidden states, sorted as the reference sorts them
    (get_trans_emiss.py:150).  With ``introgression`` the V4 family
    ``(4, i, j)`` — first coalescence B+C in BC interval ``i`` — is added
    (reference int_get_emission_prob_mat.py:1054-1105)."""
    states = []
    for i in range(n_int_AB):
        for j in range(n_int_ABC):
            states.append((0, i, j))
            if introgression:
                states.append((4, i, j))
    for c in (1, 2, 3):
        for i in range(n_int_ABC):
            for j in range(i, n_int_ABC):
                states.append((c, i, j))
    return sorted(states)


def fate_list(n_int_AB: int) -> list:
    """Per-locus fates at the second speciation in the introgression model:
    deep (uncoalesced), V0 at AB interval i, introgressed at BC interval i
    (reference int_get_tab.py tab_names, rows ordered here as the canonical
    initial-key order of the int ABC chain)."""
    fates = [(-1, -1, -1)]
    fates += [(0, i, -1) for i in range(n_int_AB)]
    fates += [(4, i, -1) for i in range(n_int_AB)]
    return fates


def _ab_side_candidates(side: Side, step: int):
    if side[0] == -1:
        return [side, (0, step, -1)]
    return [side]


def _abc_side_candidates(side: Side, step: int):
    c, i, j = side
    if c == -1:
        return [side, (-1, step, step), (1, step, -1), (2, step, -1), (3, step, -1)]
    if j == -1:
        return [side, (c, i, step)]
    return [side]


def _trace_chain(n_steps, side_candidates, registry, events, vanloan: bool,
                 first_step_unmasked: bool, init_keys):
    """Trace one interval chain; returns (key_index dict, steps list)."""
    key_index = {}
    for k in init_keys:
        key_index[k] = len(key_index)
    steps = []
    for s in range(n_steps):
        alive = list(key_index.keys())
        normal = []  # (parent, child, ms, me)
        vl = []  # (parent, child, ms, me, [(path_ids, )...])
        claimed = {}
        for pkey in alive:
            p_idx = key_index[pkey]
            omega_p = key_omega(pkey)
            cands = []
            for ls in side_candidates(pkey[0], s):
                for rs in side_candidates(pkey[1], s):
                    if (ls, rs) not in cands:
                        cands.append((ls, rs))
            for cand in cands:
                omega_c = key_omega(cand)
                if vanloan and (_needs_vanloan(cand[0]) or _needs_vanloan(cand[1])):
                    # Enumerate omega paths; group by (by_l, by_r) into
                    # transformed child keys (vanloan.py:362-385).
                    paths = enumerate_vl_paths(omega_p, omega_c, events)
                    groups = {}
                    for path, by_l, by_r in paths:
                        groups.setdefault((by_l, by_r), []).append(path)
                    for (by_l, by_r), sub in groups.items():
                        nl = OMEGA_CODE_TO_TOPOLOGY.get(by_l, cand[0][0])
                        nr = OMEGA_CODE_TO_TOPOLOGY.get(by_r, cand[1][0])
                        child = ((nl, cand[0][1], cand[0][2]), (nr, cand[1][1], cand[1][2]))
                        union_classes = {pair for subpath in sub for pair in subpath}
                        _claim(claimed, child, (pkey, cand, (by_l, by_r)))
                        if child not in key_index:
                            key_index[child] = len(key_index)
                        vl.append(
                            (
                                p_idx,
                                key_index[child],
                                registry.intern(omega_p),
                                registry.intern(omega_c),
                                registry.intern_union(union_classes),
                            )
                        )
                else:
                    child = cand
                    _claim(claimed, child, (pkey, cand))
                    if child not in key_index:
                        key_index[child] = len(key_index)
                    ms = -1 if (first_step_unmasked and s == 0) else registry.intern(omega_p)
                    normal.append((p_idx, key_index[child], ms, registry.intern(omega_c)))

        steps.append(_pack_step(normal, vl))
    return key_index, steps


def _claim(claimed, child, owner):
    prev = claimed.get(child)
    if prev is not None and prev[0] != owner[0]:
        raise AssertionError(f"child {child} written by two parents: {prev} / {owner}")
    claimed[child] = owner


def _pack_step(normal, vl) -> StepPlan:
    normal_arr = np.array(normal, dtype=np.int64).reshape(-1, 4)
    # dedupe the union-propagator ids used this step
    union_ids = sorted({t[4] for t in vl})
    local = {u: i for i, u in enumerate(union_ids)}
    return StepPlan(
        parent=normal_arr[:, 0],
        child=normal_arr[:, 1],
        m_start=normal_arr[:, 2],
        m_end=normal_arr[:, 3],
        vl_parent=np.array([t[0] for t in vl], dtype=np.int64),
        vl_child=np.array([t[1] for t in vl], dtype=np.int64),
        vl_m_start=np.array([t[2] for t in vl], dtype=np.int64),
        vl_m_end=np.array([t[3] for t in vl], dtype=np.int64),
        vl_prop=np.array([local[t[4]] for t in vl], dtype=np.int64),
        vl_unions=np.array(union_ids, dtype=np.int64),
    )


@functools.lru_cache(maxsize=None)
def build_plan(n_int_AB: int, n_int_ABC: int, introgression: bool = False) -> Plan:
    sp2 = state_space(2)
    sp3 = state_space(3)
    events3 = sp3.omega_events

    if introgression:
        # The AB-epoch fate table is built by introgression.model (four
        # parallel population chains + migration split); the ABC chain
        # starts from one key per per-locus fate pair.
        fates = fate_list(n_int_AB)
        ab_index = {}
        ab_steps = []
        reg_ab = _MaskRegistry(sp2)
        ab_final_keys = [(l, r) for l in fates for r in fates]
    else:
        # ---- AB chain (no Van Loan possible with a single coalescence) ----
        reg_ab = _MaskRegistry(sp2)
        ab_index, ab_steps = _trace_chain(
            n_int_AB,
            _ab_side_candidates,
            reg_ab,
            sp2.omega_events,
            vanloan=False,
            first_step_unmasked=True,
            init_keys=[START],
        )
        ab_final_keys = list(ab_index.keys())  # insertion order == index order

    # ---- ABC chain: initial keys are the AB stage's final keys ----
    reg_abc = _MaskRegistry(sp3)
    abc_index, abc_steps = _trace_chain(
        n_int_ABC - 1,
        _abc_side_candidates,
        reg_abc,
        events3,
        vanloan=True,
        first_step_unmasked=False,
        init_keys=ab_final_keys,
    )
    abc_init_from_ab = np.array(
        [abc_index[k] for k in ab_final_keys], dtype=np.int64
    )

    # ---- final interval ----
    absorbing = sp3.omega_masks[(7, 7)]
    keep = ~absorbing
    reg_deep = _MaskRegistry(sp3, keep=keep)
    last = n_int_ABC - 1

    hidden = hidden_state_list(n_int_AB, n_int_ABC, introgression)
    hidden_idx = {h: i for i, h in enumerate(hidden)}

    entries = {}  # final key -> entry index

    def entry_of(key: Key) -> int:
        if key not in entries:
            entries[key] = len(entries)
        return entries[key]

    def fill(side: Side) -> Side:
        c, i, j = side
        return (c, i if i != -1 else last, j if j != -1 else last)

    direct = []
    deep = []  # (src, out_entry, path_ids list)
    for key, idx in abc_index.items():
        l, r = key
        l_unco = l[0] == -1
        r_unco = r[0] == -1
        if not l_unco and not r_unco:
            out_key = (fill(l), fill(r))
            direct.append((idx, entry_of(out_key)))
            continue
        # at least one uncoalesced side -> deepest-TI path enumeration
        base = (fill(l), fill(r))
        omega_start = key_omega(key)
        for path, by_l, by_r in enumerate_deep_paths(omega_start, events3):
            nl = base[0][0]
            nr = base[1][0]
            if by_l != -1 and nl == -1:
                nl = OMEGA_CODE_TO_TOPOLOGY[by_l]
            if by_r != -1 and nr == -1:
                nr = OMEGA_CODE_TO_TOPOLOGY[by_r]
            out_key = ((nl, base[0][1], base[0][2]), (nr, base[1][1], base[1][2]))
            path_ids = tuple(reg_deep.intern(tuple(p)) for p in path)
            deep.append((idx, entry_of(out_key), path_ids))

    # group deep contributions by chain length
    deep_by_m = {}
    for src, out, path_ids in deep:
        deep_by_m.setdefault(len(path_ids), []).append((src, out, path_ids))
    deep_groups = []
    for m, rows in sorted(deep_by_m.items()):
        deep_groups.append(
            DeepGroup(
                m=m,
                src=np.array([r[0] for r in rows], dtype=np.int64),
                out=np.array([r[1] for r in rows], dtype=np.int64),
                path=np.array([r[2] for r in rows], dtype=np.int64),
            )
        )

    entry_keys = list(entries.keys())
    entry_row = np.array([hidden_idx[k[0]] for k in entry_keys], dtype=np.int64)
    entry_col = np.array([hidden_idx[k[1]] for k in entry_keys], dtype=np.int64)

    direct_arr = np.array(direct, dtype=np.int64).reshape(-1, 2)

    return Plan(
        n_int_AB=n_int_AB,
        n_int_ABC=n_int_ABC,
        ab_n_keys=len(ab_index),
        ab_steps=ab_steps,
        ab_masks=reg_ab.materialize(),
        ab_final_keys=ab_final_keys,
        abc_n_keys=len(abc_index),
        abc_init_from_ab=abc_init_from_ab,
        abc_steps=abc_steps,
        abc_masks=reg_abc.materialize(),
        keep_mask=keep,
        noabs_masks=reg_deep.materialize(),
        direct_src=direct_arr[:, 0],
        direct_out=direct_arr[:, 1],
        deep_groups=deep_groups,
        n_entries=len(entries),
        hidden_states=hidden,
        entry_row=entry_row,
        entry_col=entry_col,
    )
