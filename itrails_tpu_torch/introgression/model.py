"""Introgression (migration) model: B -> C admixture at time ``t_m`` before
the first speciation (the JAX package's ``itrails_tpu/introgression/
model.py``; reference int_get_joint_prob_mat.py, int_get_tab.py).

Backwards in time each B lineage independently migrates to the C
population with probability ``m`` at the admixture event, so the epoch
between migration and the second speciation runs six chains:

  * AB and BC (15 states each): A + both B loci that stayed, C + both B
    loci that migrated;
  * AB-miss and BC-miss (5 states, left and right): A or C + a single B
    locus, the other one having gone the other way.

Each locus' *fate* (deep / V0 coalescence with A in AB interval i /
introgressed coalescence with C in BC interval i) is tracked with masked
interval products (reference int_get_tab.py:132-760).  At the second
speciation the chains' finals are mixed into the 203-state ABC space per
fate pair (reference mix_probs, int_get_tab.py:17-129), and the deep epoch
runs through :class:`~itrails_tpu_torch.core.ctmc.AbcStage` on the
introgression plan, as the plain builder's does.

Everything that depends only on the plan is computed once in NumPy when an
:class:`IntJointMatrixFn` is made and uploaded to its device.  A call then
runs a fixed, small number of tensor operations: the six chains go as two
batched chains (the two 15-state ones, the four 5-state ones), and the
(2 n_int_AB + 1)^2 fate pairs are mixed in four batched products, one per
kind of pair, not pair by pair.
"""

from __future__ import annotations

import numpy as np
import torch

from itrails_tpu_torch.core.ctmc import AbcStage, _rate_matrix
from itrails_tpu_torch.core.expm import expm_batch
from itrails_tpu_torch.core.schedule import Plan, fate_list
from itrails_tpu_torch.core.statespace import (
    canonical,
    combine_partitions_map,
    combine_to_abc,
    partial_state_space,
    state_space,
)

__all__ = ["IntJointMatrixFn"]

A, B, C = 0, 1, 2

# the four missing-lineage chains: (left species, right species) of the
# partial space, the locus that carries B, the species of the full chain
# that seeds it
_MISS = (((A, B), (A,), 0, A),   # AB-miss left: B_l stayed, B_r migrated
         ((A,), (A, B), 1, A),   # AB-miss right
         ((B, C), (C,), 0, C),   # BC-miss left: B_l migrated, B_r stayed
         ((C,), (B, C), 1, C))   # BC-miss right


def _full_masks(n_int):
    """Boundary class masks for a 15-state chain: for each joint fate
    (fl, fr) over {deep(-1)} + intervals, and each boundary k=1..n, the
    allowed omega class (left-done(k), right-done(k))."""
    sp2 = state_space(2)
    omegas = {
        (False, False): sp2.omega_masks[(0, 0)],
        (True, False): sp2.omega_masks[(3, 0)],
        (False, True): sp2.omega_masks[(0, 3)],
        (True, True): sp2.omega_masks[(3, 3)],
    }
    fates = [-1] + list(range(n_int))
    patterns = []
    for fl in fates:
        for fr in fates:
            rows = []
            for k in range(1, n_int + 1):
                ld = fl != -1 and k > fl
                rd = fr != -1 and k > fr
                rows.append(omegas[(ld, rd)])
            patterns.append(np.stack(rows))
    return np.stack(patterns).astype(np.float64)  # (F2, n, 15)


def _miss_masks(space, locus, n_int):
    """Boundary masks for a 5-state missing-lineage chain: single fate on
    the B-carrying locus."""
    coal = space.coalesced_mask(locus)
    nocoal = ~coal
    patterns = []
    for f in [-1] + list(range(n_int)):
        rows = []
        for k in range(1, n_int + 1):
            rows.append(coal if (f != -1 and k > f) else nocoal)
        patterns.append(np.stack(rows))
    return np.stack(patterns).astype(np.float64)  # (F1, n, 5)


def _single_to_partial_map(partial, first_species):
    """Map (2-state single-sequence chain of ``first_species``) x (a lone
    single-locus B lineage) into a partial space: one-hot (S_partial, 2)."""
    out = np.zeros((partial.n_states, 2), dtype=np.float64)
    # slots of the partial space in order left..right; the merged
    # partition: the species linked (1,1) or split (1,2) plus the lone
    # lineage
    lay = [(0, s) for s in partial.left] + [(1, s) for s in partial.right]
    for idx, x_state in enumerate([(1, 1), (1, 2)]):
        labels = [x_state[locus] if sp == first_species else 99
                  for locus, sp in lay]
        out[partial.index[canonical(labels)], idx] = 1.0
    return out


def _pair_tables(n_int):
    """For each kind of fate pair at the second speciation, the pairs'
    rows in the (n_f^2, 203) table (``fate_list`` x ``fate_list`` order)
    and the rows of the chain finals they read: B stayed entirely (full AB
    chain), migrated entirely (full BC chain), B_l stayed and B_r migrated,
    B_l migrated and B_r stayed (the missing-lineage chains)."""
    fates = fate_list(n_int)
    slot = [-1] + list(range(n_int))

    def full_idx(fl, fr):
        fi = fl[1] if fl[0] != -1 else -1
        ri = fr[1] if fr[0] != -1 else -1
        return slot.index(fi) * (n_int + 1) + slot.index(ri)

    def miss_idx(f):
        return 0 if f[0] == -1 else f[1] + 1

    kinds = {k: ([], [], []) for k in ("ab", "bc", "split", "split2")}
    for p, (fl, fr) in enumerate((fl, fr) for fl in fates for fr in fates):
        l_ab, r_ab = fl[0] in (-1, 0), fr[0] in (-1, 0)
        l_bc, r_bc = fl[0] in (-1, 4), fr[0] in (-1, 4)
        for kind, on, x, y in (
                ("ab", l_ab and r_ab, full_idx(fl, fr), 0),
                ("bc", l_bc and r_bc, full_idx(fl, fr), 0),
                ("split", l_ab and r_bc, miss_idx(fl), miss_idx(fr)),
                ("split2", l_bc and r_ab, miss_idx(fl), miss_idx(fr))):
            if on:
                kinds[kind][0].append(p)
                kinds[kind][1].append(x)
                kinds[kind][2].append(y)
    return len(fates) ** 2, kinds


def _inv(z):
    """``1 / z`` for z > 0, else 0 (the reference gives NaN at m = 0 or
    x = 0); the clamp keeps the branch not taken finite too."""
    return torch.where(z > 0, 1.0 / z.clamp(min=1e-300), torch.zeros_like(z))


class IntJointMatrixFn:
    """``rates -> (M, M)`` joint probability matrix of the introgression
    model over (left, right) hidden gene-tree states, for one
    introgression plan (``build_plan(..., introgression=True)``), on one
    device (the JAX package's ``int_joint_matrix``,
    ``itrails_tpu/introgression/model.py:121``).

    Rows and columns follow ``plan.hidden_states``; rows sum to the
    state's stationary mass."""

    def __init__(self, plan: Plan, dtype=torch.float64, *, device):
        self.plan = plan
        self.dtype = dtype
        self.device = torch.device(device)
        n_int = plan.n_int_AB

        def f(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        def ix(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64),
                                   device=self.device)

        sp1, sp2, sp3 = state_space(1), state_space(2), state_space(3)
        miss = [partial_state_space(left, right)
                for left, right, _, _ in _MISS]
        self._pat1 = (f(sp1.coal_pattern), f(sp1.rho_pattern))
        self._pat2 = (f(sp2.coal_pattern), f(sp2.rho_pattern))
        self._pat3 = (f(sp3.coal_pattern), f(sp3.rho_pattern))
        self._pat_miss = [(f(sp.coal_pattern), f(sp.rho_pattern))
                          for sp in miss]
        self._start = sp1.index[(1, 1)]
        self._split = sp1.index[(1, 2)]
        self._combine2 = f(combine_partitions_map(1, 1))  # (15, 2, 2)
        # (4, 5, 2): the seeding species' single chain into each partial
        self._miss_maps = f(np.stack([
            _single_to_partial_map(sp, first)
            for sp, (_, _, _, first) in zip(miss, _MISS)]))
        self._full_masks = f(_full_masks(n_int))  # (F2, n, 15)
        self._miss_masks = f(np.stack([  # (4, F1, n, 5)
            _miss_masks(sp, locus, n_int)
            for sp, (_, _, locus, _) in zip(miss, _MISS)]))

        # the mixes into the ABC space, as (S_1 S_2, 203) one-hot products
        def mix(*layouts):
            t = combine_to_abc(*layouts)
            return f(t.reshape(t.shape[0], -1).T)

        self._mix = {
            "ab": mix(("full", (A, B)), ("full", (C,))),
            "bc": mix(("full", (B, C)), ("full", (A,))),
            "split": mix(("partial", (A, B), (A,)), ("partial", (C,), (B, C))),
            "split2": mix(("partial", (B, C), (C,)),
                          ("partial", (A,), (A, B))),
        }
        self._n_pairs, kinds = _pair_tables(n_int)
        self._pairs = {k: tuple(ix(v) for v in idx)
                       for k, idx in kinds.items()}
        self._abc = AbcStage(plan, dtype, device=self.device)

    def __call__(self, *, t_A, t_B, t_C, t_AB, t_m, coal_A, coal_B, coal_C,
                 coal_AB, coal_BC, coal_ABC, rho, m, cut_AB, cut_ABC):
        """All times in coalescent units; ``t_B``/``t_C`` run from the
        present to the migration event.  ``cut_AB`` has ``n_int_AB + 1``
        entries, ``cut_ABC`` ``n_int_ABC + 1`` with the last one unused."""
        kw = {"dtype": self.dtype, "device": self.device}
        n_int = self.plan.n_int_AB
        cut_AB = torch.as_tensor(cut_AB, **kw)
        dt_ab = cut_AB[1:] - cut_AB[:-1]
        dt_bc = torch.cat([dt_ab[:1] + t_m, dt_ab[1:]])

        q_a = _rate_matrix(*self._pat1, coal_A, rho)
        q_b = _rate_matrix(*self._pat1, coal_B, rho)
        q_c = _rate_matrix(*self._pat1, coal_C, rho)
        q_ab = _rate_matrix(*self._pat2, coal_AB, rho)
        q_bc = _rate_matrix(*self._pat2, coal_BC, rho)
        q_miss = [_rate_matrix(*pat, coal, rho) for pat, coal in
                  zip(self._pat_miss, (coal_AB, coal_AB, coal_BC, coal_BC))]

        start = self._start
        singles = expm_batch(torch.stack([
            q_a * t_A, q_b * t_B, q_c * t_C, q_a * (t_A + t_AB),
            q_c * (t_C + t_m + t_AB), q_b * t_m,
        ]))
        f_a, f_b, f_c = (singles[k, start] for k in range(3))
        f_a_bis, f_c_bis = singles[3, start], singles[4, start]
        e_b_tm = singles[5]

        # ---- migration split (reference split_migration, :266-303) ----
        x = f_b[self._split]
        half = 0.5 * (1.0 - m) * m * x
        w_left = torch.stack([(1.0 - x) * (1.0 - m), (1.0 - m) ** 2 * x,
                              half, half])
        w_right = torch.stack([(1.0 - x) * m, x * m ** 2, half, half])

        # ---- initial vectors of the six chains ----
        b_left_full = w_left[:2] @ e_b_tm
        pi_ab = torch.einsum("i,j,mij->m", f_a, b_left_full, self._combine2)
        pi_bc = torch.einsum("i,j,mij->m", w_right[:2], f_c, self._combine2)
        # (4, 5): AB-miss l/r from f_a, BC-miss l/r from f_c
        seeds = torch.stack([f_a, f_a, f_c, f_c])
        weights = torch.stack([w_left[2], w_left[3], w_right[2], w_right[3]])
        pi_miss = (torch.einsum("kij,kj->ki", self._miss_maps, seeds)
                   * weights[:, None])

        # ---- interval propagators: (2, n, 15, 15) and (4, n, 5, 5) ----
        dts = torch.stack([dt_ab, dt_bc])
        e_full = expm_batch(torch.stack([q_ab, q_bc])[:, None]
                            * dts[:, :, None, None])
        miss_dt = dts[[0, 0, 1, 1]]
        e_miss = expm_batch(torch.stack(q_miss)[:, None]
                            * miss_dt[:, :, None, None])

        # ---- fate-pattern finals per chain (reference get_AB_precomp +
        # get_ordered, get_tab.py:35-54): G[f] = pi * prod_k (E_k, mask_k[f])
        g_full = torch.stack([pi_ab, pi_bc])[:, None, :].expand(
            2, self._full_masks.shape[0], -1)
        g_miss = pi_miss[:, None, :].expand(4, self._miss_masks.shape[1], -1)
        for k in range(n_int):
            g_full = torch.bmm(g_full, e_full[:, k]) * self._full_masks[:, k]
            g_miss = (torch.bmm(g_miss, e_miss[:, k])
                      * self._miss_masks[:, :, k])
        g_ab, g_bc = g_full[0], g_full[1]

        # ---- mix into the 203-state ABC space per fate pair ----
        # cross-normalizers: reference mix_probs divides one factor of each
        # split product by that chain's initial mass
        z = _inv(pi_miss.sum(dim=1))  # AB-miss l, r, BC-miss l, r
        # each kind of pair: (left factor, right factor, weight); the left
        # factor's rows are read at the pairs' i, the right one's at j
        # (the full chains' partner is one vector for every pair)
        factors = {
            "ab": (g_ab, f_c_bis, None),
            "bc": (g_bc, f_a_bis, None),
            "split": (g_miss[0], g_miss[3], z[0] + z[3]),
            "split2": (g_miss[2], g_miss[1], z[2] + z[1]),
        }
        pi_abc = torch.zeros((self._n_pairs, 203), **kw)
        for kind, (left, right, weight) in factors.items():
            rows, i, j = self._pairs[kind]
            if rows.numel() == 0:
                continue
            r = right[j] if right.dim() == 2 else right.expand(i.numel(), -1)
            outer = left[i][:, :, None] * r[:, None, :]
            add = outer.reshape(outer.shape[0], -1) @ self._mix[kind]
            if weight is not None:
                add = weight * add
            pi_abc = pi_abc.index_put((rows,), pi_abc[rows] + add)

        return self._abc(pi_abc, _rate_matrix(*self._pat3, coal_ABC, rho),
                         cut_ABC)
