"""Host-side state-space compiler for the two-locus ancestral process.

Everything in this module is integer/boolean combinatorics that depends only on
the number of species (1, 2, or 3) — never on model parameters.  It therefore
runs ONCE per process (cached) on the host in NumPy, and its outputs are
uploaded once per builder as constant index/mask tensors.  The reference re-enumerates this state
space on every optimizer evaluation (reference: get_joint_prob_mat.py:85-93,
trans_mat.py:577-598); here it is a compile-time artifact.

Model semantics (reference: trans_mat.py):

* A state of the ``n``-species two-locus ancestral process is a set partition
  of ``2n`` lineage slots — slots ``0..n-1`` carry the *left* locus of species
  ``0..n-1`` and slots ``n..2n-1`` carry the *right* locus.  A block of the
  partition is one ancestral lineage (chromosome) carrying the ancestral
  material of its member slots.  Bell(2n) states: 2 / 15 / 203 for n=1/2/3.
* Transitions:
  - *reversible coalescence* (rate ``coal``): a lineage carrying only
    left-locus material merges with one carrying only right-locus material
    (linking the loci); the reverse move is *recombination* (rate ``rho``).
  - *non-reversible coalescence* (rate ``coal``): two lineages that both carry
    material at a common locus merge; this reduces the per-locus lineage count
    and can never be undone.
* Each state is classified per locus by its *omega* code: the bitmask (bit
  ``i`` = species ``i``) of slots at that locus that share their lineage with
  another slot *of the same locus* (i.e. species whose material at that locus
  has already coalesced with another species').  For 3 species the codes are
  0 (none), 3 (A+B), 5 (A+C), 6 (B+C), 7 (all).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "StateSpace",
    "state_space",
    "bell_number",
    "canonical",
    "enumerate_states",
    "combine_partitions_map",
    "automorphism_perms",
    "OMEGA_CODE_TO_TOPOLOGY",
    "PartialSpace",
    "partial_state_space",
    "combine_to_abc",
]

# Omega code of a locus -> HMM topology code for the *first* coalescence:
# 3 = A+B -> V1(=1), 5 = A+C -> V2(=2), 6 = B+C -> V3(=3).
OMEGA_CODE_TO_TOPOLOGY = {3: 1, 5: 2, 6: 3}


def bell_number(n: int) -> int:
    """Number of set partitions of an ``n``-element set."""
    row = [1]
    for _ in range(n):
        new = [row[-1]]
        for v in row:
            new.append(new[-1] + v)
        row = new
    return row[0]


def canonical(labels) -> tuple:
    """Relabel a partition-labelling so labels appear in first-occurrence
    order starting from 1 (e.g. (2, 5, 5, 2) -> (1, 2, 2, 1))."""
    remap = {}
    out = []
    for v in labels:
        if v not in remap:
            remap[v] = len(remap) + 1
        out.append(remap[v])
    return tuple(out)


def _partitions(n_slots: int):
    """Yield all set partitions of slots ``0..n_slots-1`` as canonical label
    tuples, via the standard 'assign each element to an existing block or a
    new one' recursion (yields in restricted-growth-string order)."""
    labels = [0] * n_slots

    def rec(i: int, n_blocks: int):
        if i == n_slots:
            yield tuple(labels)
            return
        for b in range(1, n_blocks + 2):
            labels[i] = b
            yield from rec(i + 1, max(n_blocks, b))

    yield from rec(0, 0)


def enumerate_states(species: int) -> np.ndarray:
    """All canonical states for ``species`` species, sorted lexicographically.

    Returns an int array of shape ``(bell(2*species), 2*species)``.
    """
    states = sorted(_partitions(2 * species))
    return np.array(states, dtype=np.int64)


def _locus_omega(state: np.ndarray, species: int, locus: int) -> int:
    """Omega bitmask of one locus of a state (see module docstring)."""
    part = state[locus * species : (locus + 1) * species]
    omega = 0
    for i in range(species):
        for j in range(species):
            if i != j and part[i] == part[j]:
                omega |= 1 << i
                break
    return int(omega)


@dataclass(frozen=True)
class StateSpace:
    """Static description of the ``species``-species two-locus state space."""

    species: int
    states: np.ndarray  # (S, 2*species) canonical partition labels
    index: dict  # tuple(state) -> row index
    # Rate-matrix skeleton: Q = coal * coal_pattern + rho * rho_pattern with
    # diagonal = -rowsum.  Patterns are dense 0/1 float arrays (S, S).
    coal_pattern: np.ndarray
    rho_pattern: np.ndarray
    omega_pairs: np.ndarray  # (S, 2) omega code of (left, right) locus
    # omega mask lookup: (l_omega, r_omega) -> bool (S,) membership mask
    omega_masks: dict = field(repr=False)
    # omega code -> number of non-reversible coalescences it embodies
    omega_events: dict

    @property
    def n_states(self) -> int:
        return int(self.states.shape[0])

    def mask(self, l_omega: int, r_omega: int) -> np.ndarray:
        return self.omega_masks[(l_omega, r_omega)]

    def rate_matrix(self, coal: float, rho: float) -> np.ndarray:
        """Dense rate matrix for given coalescence/recombination rates
        (float64; reference: trans_mat.py:487-508)."""
        q = coal * self.coal_pattern + rho * self.rho_pattern
        np.fill_diagonal(q, 0.0)
        np.fill_diagonal(q, -q.sum(axis=1))
        return q


def _transitions(states: np.ndarray, index: dict, species: int):
    """Enumerate all transition edges.

    Returns two lists of (src, dst) index pairs: coalescence edges (rate
    ``coal``) and recombination edges (rate ``rho``).
    """
    coal_edges = []
    rho_edges = []
    for src, state in enumerate(states):
        left = state[:species]
        right = state[species:]
        l_labels = set(int(v) for v in left)
        r_labels = set(int(v) for v in right)

        # Reversible coalescence: a right-only lineage merges into a
        # left-only lineage (and the reverse recombination edge).
        for r_only in sorted(r_labels - l_labels):
            for l_only in sorted(l_labels - r_labels):
                merged = np.where(state == r_only, l_only, state)
                dst = index[canonical(merged)]
                coal_edges.append((src, dst))
                rho_edges.append((dst, src))

        # Non-reversible coalescence: merge two lineages that co-occur at a
        # locus.  A label pair co-occurring at both loci is still one event.
        seen_pairs = set()
        for locus_labels in (left, right):
            distinct = sorted(set(int(v) for v in locus_labels))
            for a, b in itertools.combinations(distinct, 2):
                if (a, b) in seen_pairs:
                    continue
                seen_pairs.add((a, b))
                merged = np.where((state == a) | (state == b), min(a, b), state)
                dst = index[canonical(merged)]
                coal_edges.append((src, dst))
    return coal_edges, rho_edges


@functools.lru_cache(maxsize=None)
def state_space(species: int) -> StateSpace:
    """Build (and cache) the full static state space for 1, 2, or 3 species."""
    if species not in (1, 2, 3):
        raise ValueError("species must be 1, 2 or 3")
    states = enumerate_states(species)
    index = {tuple(int(v) for v in row): i for i, row in enumerate(states)}
    n = len(states)

    coal_edges, rho_edges = _transitions(states, index, species)
    coal_pattern = np.zeros((n, n), dtype=np.float64)
    rho_pattern = np.zeros((n, n), dtype=np.float64)
    # De-duplicated assignment semantics (an edge pattern entry is 0/1, never
    # accumulated — matches reference trans_mat.py:505 assignment).
    for s, d in coal_edges:
        coal_pattern[s, d] = 1.0
    for s, d in rho_edges:
        rho_pattern[s, d] = 1.0

    omega_pairs = np.array(
        [[_locus_omega(row, species, 0), _locus_omega(row, species, 1)] for row in states],
        dtype=np.int64,
    )
    omega_masks = {}
    for i, (lo, ro) in enumerate(omega_pairs):
        key = (int(lo), int(ro))
        if key not in omega_masks:
            omega_masks[key] = np.zeros(n, dtype=bool)
        omega_masks[key][i] = True

    omega_events = {0: 0}
    bits = [1 << i for i in range(species)]
    for size in range(2, species + 1):
        for combo in itertools.combinations(bits, size):
            omega_events[sum(combo)] = size - 1

    return StateSpace(
        species=species,
        states=states,
        index=index,
        coal_pattern=coal_pattern,
        rho_pattern=rho_pattern,
        omega_pairs=omega_pairs,
        omega_masks=omega_masks,
        omega_events=omega_events,
    )


@functools.lru_cache(maxsize=None)
def automorphism_perms(species: int) -> tuple:
    """State-index permutations induced by relabeling the species.

    Each species permutation sigma acts on a two-locus partition state by
    permuting the species slots of BOTH loci and re-canonicalising; since
    the transition structure is pure partition combinatorics with a single
    per-epoch ``coal``/``rho`` rate, ``coal_pattern[p][:, p] ==
    coal_pattern`` exactly (same for rho) for every such ``p`` — the basis
    for the Van Loan orbit dedup in :func:`core.ctmc._precompute_vl`.
    (The rate-matrix *diagonal* is the floating row-sum, whose summation
    order differs under the permutation — equal only to ~1 ulp.)

    Returns a tuple of ``species!`` int64 index arrays; the identity is
    first.
    """
    sp = state_space(species)
    out = []
    for sigma in itertools.permutations(range(species)):
        sel = list(sigma)
        p = np.empty(sp.n_states, dtype=np.int64)
        for i, st in enumerate(sp.states):
            relabeled = np.concatenate([st[:species][sel], st[species:][sel]])
            p[i] = sp.index[canonical(relabeled)]
        out.append(p)
    return tuple(out)


@dataclass(frozen=True)
class PartialSpace:
    """Two-locus ancestral process where each locus carries an arbitrary
    subset of species (used for the introgression model's missing-lineage
    chains, where one locus of species B migrated away; reference
    int_get_joint_prob_mat.py:306-339 hard-codes the 2x5-state variants).

    ``left``/``right`` are tuples of species ids present at each locus.
    """

    left: tuple
    right: tuple
    states: np.ndarray  # (S, n_slots) canonical partition labels
    index: dict
    coal_pattern: np.ndarray
    rho_pattern: np.ndarray

    @property
    def n_states(self) -> int:
        return int(self.states.shape[0])

    @property
    def n_left(self) -> int:
        return len(self.left)

    def rate_matrix(self, coal: float, rho: float) -> np.ndarray:
        q = coal * self.coal_pattern + rho * self.rho_pattern
        np.fill_diagonal(q, 0.0)
        np.fill_diagonal(q, -q.sum(axis=1))
        return q

    def coalesced_mask(self, locus: int) -> np.ndarray:
        """Boolean mask of states whose given locus has any two species'
        material in one lineage (i.e. the locus' coalescence happened)."""
        n_l = self.n_left
        sl = slice(0, n_l) if locus == 0 else slice(n_l, None)
        out = np.zeros(self.n_states, dtype=bool)
        for i, row in enumerate(self.states):
            part = row[sl]
            out[i] = len(part) > len(set(int(v) for v in part))
        return out


@functools.lru_cache(maxsize=None)
def partial_state_space(left: tuple, right: tuple) -> PartialSpace:
    """Enumerate the two-locus ancestral process over an asymmetric slot
    layout (same transition rules as :func:`state_space`)."""
    n_l = len(left)
    slots = n_l + len(right)
    states = sorted(_partitions(slots))
    states = np.array(states, dtype=np.int64)
    index = {tuple(int(v) for v in row): i for i, row in enumerate(states)}
    n = len(states)
    coal_pattern = np.zeros((n, n), dtype=np.float64)
    rho_pattern = np.zeros((n, n), dtype=np.float64)
    coal_edges, rho_edges = _transitions(states, index, n_l) if len(left) == len(
        right
    ) else _transitions_general(states, index, n_l)
    for s, d in coal_edges:
        coal_pattern[s, d] = 1.0
    for s, d in rho_edges:
        rho_pattern[s, d] = 1.0
    return PartialSpace(
        left=left, right=right, states=states, index=index,
        coal_pattern=coal_pattern, rho_pattern=rho_pattern,
    )


def _transitions_general(states: np.ndarray, index: dict, n_left: int):
    """Transition enumeration for asymmetric locus layouts (the symmetric
    :func:`_transitions` assumes ``species`` slots per locus)."""
    coal_edges = []
    rho_edges = []
    for src, state in enumerate(states):
        l_part = state[:n_left]
        r_part = state[n_left:]
        l_labels = set(int(v) for v in l_part)
        r_labels = set(int(v) for v in r_part)
        for r_only in sorted(r_labels - l_labels):
            for l_only in sorted(l_labels - r_labels):
                merged = np.where(state == r_only, l_only, state)
                dst = index[canonical(merged)]
                coal_edges.append((src, dst))
                rho_edges.append((dst, src))
        seen = set()
        for part in (l_part, r_part):
            distinct = sorted(set(int(v) for v in part))
            for a, b in itertools.combinations(distinct, 2):
                if (a, b) in seen:
                    continue
                seen.add((a, b))
                merged = np.where((state == a) | (state == b), min(a, b), state)
                coal_edges.append((src, index[canonical(merged)]))
    return coal_edges, rho_edges


# ABC slot order: (A_l, B_l, C_l, A_r, B_r, C_r); species ids 0=A, 1=B, 2=C.
ABC_SLOT = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 3, (1, 1): 4, (1, 2): 5}


@functools.lru_cache(maxsize=None)
def combine_to_abc(*layouts) -> np.ndarray:
    """General population-merge map into the 203-state ABC space.

    Each layout is ``(kind, spec)``:
      * ``("full", (s1, ..))``  — a symmetric :func:`state_space` over those
        species (both loci present), slots mapped to the ABC slots of the
        named species;
      * ``("partial", left_species, right_species)`` — a
        :func:`partial_state_space`.

    Returns a one-hot tensor of shape ``(203, S_1, ..., S_k)`` such that
    ``pi_ABC = einsum('i,j,..,mij..->m', f_1, f_2, .., C)``.  The layouts'
    slots must exactly cover the six ABC slots.
    """
    spaces = []
    slot_maps = []  # per layout: list of ABC slot index per local slot
    for lay in layouts:
        if lay[0] == "full":
            specs = lay[1]
            sp = state_space(len(specs))
            spaces.append(sp.states)
            slot_maps.append(
                [ABC_SLOT[(0, s)] for s in specs] + [ABC_SLOT[(1, s)] for s in specs]
            )
        else:
            _, left, right = lay
            sp = partial_state_space(tuple(left), tuple(right))
            spaces.append(sp.states)
            slot_maps.append(
                [ABC_SLOT[(0, s)] for s in left] + [ABC_SLOT[(1, s)] for s in right]
            )
    covered = sorted(s for m in slot_maps for s in m)
    if covered != list(range(6)):
        raise ValueError(f"layouts must cover the 6 ABC slots, got {covered}")
    abc = state_space(3)
    shape = (abc.n_states,) + tuple(len(s) for s in spaces)
    out = np.zeros(shape, dtype=np.float64)
    for combo in itertools.product(*[range(len(s)) for s in spaces]):
        merged = np.zeros(6, dtype=np.int64)
        offset = 0
        for k, (states, smap) in enumerate(zip(spaces, slot_maps)):
            row = states[combo[k]]
            for local, abc_slot in enumerate(smap):
                merged[abc_slot] = row[local] + offset
            offset += 1000
        target = abc.index[canonical(merged)]
        out[(target,) + combo] = 1.0
    return out


@functools.lru_cache(maxsize=None)
def combine_partitions_map(species_1: int, species_2: int) -> np.ndarray:
    """Static tensor mapping product states of two independent processes to
    states of the combined process.

    When two populations merge (A x B -> AB, AB x C -> ABC), the combined
    partition places system 1's slots at positions (left: 0..s1-1,
    right: s..s+s1-1) and system 2's at (left: s1..s-1, right: s+s1..2s-1)
    with s = s1+s2; blocks never span systems (reference:
    combine_states.py:5-80).

    Returns a float64 one-hot tensor ``C`` of shape (S_sum, S_1, S_2) such
    that ``pi_sum = einsum('i,j,kij->k', f1, f2, C)``.
    """
    sp1 = state_space(species_1)
    sp2 = state_space(species_2)
    total = species_1 + species_2
    sp_sum = state_space(total)
    out = np.zeros((sp_sum.n_states, sp1.n_states, sp2.n_states), dtype=np.float64)
    for i, s1 in enumerate(sp1.states):
        for j, s2 in enumerate(sp2.states):
            combined = np.concatenate(
                [
                    s1[:species_1],
                    s2[:species_2] + 1000,  # disjoint label pool
                    s1[species_1:],
                    s2[species_2:] + 1000,
                ]
            )
            k = sp_sum.index[canonical(combined)]
            out[k, i, j] = 1.0
    return out
