"""Executor for the interval-DP :class:`~itrails_tpu_torch.core.schedule.Plan`.

Given model rates, computes the joint probability matrix over pairs of HMM
hidden states (left locus tree, right locus tree) as a fixed sequence of
batched masked matmuls, one batched matrix exponential per chain, batched
Van Loan block exponentials (grouped and deduplicated by omega path), and a
block-bidiagonal-inverse chain for the final t->inf integrals:

    reference pipeline                         here
    ------------------------------------       --------------------------------
    expm per interval (expm.py)                one expm_batch per chain
    per-path dict fan-out + joblib matmuls     gather -> mask -> (K,S)@(S,S)
      (run_markov_chain_{AB,ABC}.py)             -> mask -> scatter
    vanloan() block expm per subpath           expm_batch per support size
      (vanloan.py:392-425)                       over unique omega paths
    deepest_ti() inverse of (201*m)^2 block    N = (-Q)^{-1} once + masked
      (deepest_ti.py:215-256)                    matmul chains (block-
                                                 bidiagonal inverse identity)

Everything that depends only on the plan — gather/scatter indices, masks,
support buckets, orbit representatives — is computed once in NumPy when a
:class:`JointMatrixFn` is made and uploaded to its device; a call then runs
only tensor operations on that device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from itrails_tpu_torch.core.expm import expm_batch
from itrails_tpu_torch.core.schedule import Plan
from itrails_tpu_torch.core.statespace import (
    automorphism_perms,
    combine_partitions_map,
    state_space,
)

__all__ = ["AbcStage", "JointMatrixFn"]


# finer steps around 64-96: at 7x7 the 73-88-state supports are 90% of
# the Van Loan expm flops, and padding them to 96 costs an extra ~2 Gflop
_BUCKET_SIZES = (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112,
                 128, 160, 208)


def _vl_buckets(step, masks_np):
    """Grouping of a step's union propagators by padded support size.

    The union-restricted generator diag(u) Q diag(u) is zero outside the
    union's state support, so its exponential is block-diagonal: the
    restriction to the support plus identity elsewhere.  The identity part
    never contributes (start/end class masks lie inside the support), so
    each propagator shrinks to its support block.
    """
    supports = [np.where(m > 0.0)[0] for m in masks_np[step.vl_unions]]
    buckets = {}
    for ui, sup in enumerate(supports):
        size = next(b for b in _BUCKET_SIZES if b >= len(sup))
        buckets.setdefault(size, []).append(ui)
    out = []
    prop = step.vl_prop
    for size, uis in sorted(buckets.items()):
        sup_idx = np.full((len(uis), size), masks_np.shape[1], dtype=np.int64)
        local = np.full(len(supports), -1, dtype=np.int64)
        for k, ui in enumerate(uis):
            sup_idx[k, : len(supports[ui])] = supports[ui]
            local[ui] = k
        t_sel = np.where(local[prop] >= 0)[0]
        out.append((sup_idx, t_sel, local[prop[t_sel]]))
    return out


def _space_autoperms(n: int):
    """Automorphism permutations of the ``n``-state space (species
    relabelings), or just the identity when ``n`` matches no full space.

    Every returned non-identity perm preserves the space's coal/rho rate
    patterns exactly, so any generator ``coal * coal_pattern + rho *
    rho_pattern`` (one scalar rate per class, :func:`_rate_matrix`) is
    invariant under it and the orbit dedup can reuse one exponential per
    orbit."""
    for species in (3, 2):
        space = state_space(species)
        if space.n_states == n:
            ident = np.arange(n, dtype=np.int64)
            return tuple(
                p for p in automorphism_perms(species)
                if np.array_equal(p, ident) or all(
                    np.array_equal(pat[np.ix_(p, p)], pat)
                    for pat in (space.coal_pattern, space.rho_pattern)
                )
            )
    return (np.arange(n, dtype=np.int64),)


def _group_apps(t_sel, local_prop, n_unions):
    """Grouping of a bucket's propagator applications by union.

    Gathering one (S, S) propagator per application streams each
    propagator once per application.  Grouping the applications per union
    (padded to power-of-two class sizes, <=2x row padding) turns the
    product into per-class (Ug, K, S) @ (Ug, S, S) batched matmuls that
    read each propagator once.  Returns (classes, inv_pos): classes =
    [(union_ids (Ug,), app_idx (Ug, K) padded with -1)], inv_pos (n_apps,)
    mapping each application to its row in the concatenated outputs."""
    order = np.argsort(local_prop, kind="stable")
    counts = np.bincount(local_prop, minlength=n_unions)
    classes = {}
    start = 0
    for u in range(n_unions):
        apps = order[start:start + counts[u]]
        start += counts[u]
        if counts[u] == 0:
            continue
        k = 1 << (int(counts[u]) - 1).bit_length()
        classes.setdefault(k, []).append((u, apps))
    cl_out = []
    inv_pos = np.empty(local_prop.size, dtype=np.int64)
    flat = 0
    for k in sorted(classes):
        uids = np.array([u for u, _ in classes[k]], dtype=np.int64)
        app_idx = np.full((len(uids), k), -1, dtype=np.int64)
        for i, (u, apps) in enumerate(classes[k]):
            app_idx[i, : apps.size] = apps
            inv_pos[apps] = flat + i * k + np.arange(apps.size)
        flat += len(uids) * k
        cl_out.append((uids, app_idx))
    return cl_out, inv_pos


def _vl_representatives(plan_steps, masks_np):
    """Support buckets of every Van Loan step, with one representative
    support per (step, orbit) and size class.

    The per-epoch rates are species-symmetric, so supports related by a
    species relabeling have permutation-identical restricted generators
    (statespace.automorphism_perms): ``expm(P^T A P) == P^T expm(A) P``.
    Each support is canonicalised under the group and only one
    representative per (step, orbit) is exponentiated; the job's
    gather/scatter index row is reordered into representative order so the
    representative's exponential applies directly.

    Returns ``(per_step, classes, rids)``: per step the list of buckets
    ``(sup_idx, t_sel, local_prop)`` (sup_idx in representative order),
    per size class ``(rep_sup (U, size), rep_step (U,))``, and for every
    (step, bucket) its ``(class index, representative row per union)``."""
    n = masks_np.shape[1]
    perms = _space_autoperms(n)
    per_step = []
    by_size = {}
    for s, step in enumerate(plan_steps):
        buckets = _vl_buckets(step, masks_np) if step.vl_parent.size else []
        per_step.append(buckets)
        for bi, (sup_idx, _, _) in enumerate(buckets):
            by_size.setdefault(sup_idx.shape[1], []).append((s, bi, sup_idx))
    classes = []
    rids = {}
    for size, jobs in sorted(by_size.items()):
        uniq = {}  # (step, canonical support bytes) -> unique row id
        rep_sup, rep_step = [], []
        for s, bi, sup_idx in jobs:
            rid = np.empty(sup_idx.shape[0], dtype=np.int64)
            new_sup = sup_idx.copy()
            for k, row in enumerate(sup_idx):
                real = row[row < n]
                best = None
                for p in perms:
                    mapped = p[real]
                    order = np.argsort(mapped)
                    key = mapped[order].tobytes()
                    if best is None or key < best[0]:
                        best = (key, mapped[order], order)
                key, canon, order = best
                uk = (s, key)
                if uk not in uniq:
                    uniq[uk] = len(rep_sup)
                    rep = np.full(size, n, dtype=np.int64)
                    rep[: canon.size] = canon
                    rep_sup.append(rep)
                    rep_step.append(s)
                rid[k] = uniq[uk]
                # position j of the representative is state canon[j] =
                # p[real[order[j]]], whose original state is real[order[j]]
                new_sup[k, : real.size] = real[order]
            rids[(s, bi)] = (len(classes), rid)
            t_sel, local_prop = per_step[s][bi][1], per_step[s][bi][2]
            per_step[s][bi] = (new_sup, t_sel, local_prop)
        classes.append((np.stack(rep_sup, axis=0),
                        np.array(rep_step, dtype=np.int64)))
    return per_step, classes, rids


@dataclass
class _VlBucket:
    t_sel: torch.Tensor  # (Vb,) application rows of this bucket
    groups: list  # [(glob (Ug, K), cols (Ug, S), e_idx (Ug,))]
    inv_pos: torch.Tensor  # (Vb,)
    rows: torch.Tensor  # (Vb, S) scatter columns (n = discarded pad slot)
    cls: int  # size-class index of the bucket's exponentials


@dataclass
class _Step:
    normal: list  # [(parents (R,), support (|supp|,) or None)]
    gather: torch.Tensor  # row of the concatenated products per child
    m_end: torch.Tensor
    child: torch.Tensor
    vl_parent: torch.Tensor | None = None
    vl_child: torch.Tensor | None = None
    vl_m_start: torch.Tensor | None = None
    vl_m_end: torch.Tensor | None = None
    vl_buckets: list | None = None


def _prepare_chain(plan_steps, masks_np, device, vanloan: bool):
    """Static tensors of one interval chain (see :class:`JointMatrixFn`)."""
    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)

    if vanloan:
        per_step, classes, rids = _vl_representatives(plan_steps, masks_np)
    else:
        per_step, classes, rids = [[] for _ in plan_steps], [], {}
    steps = []
    for s, step in enumerate(plan_steps):
        # normal transitions: (P[parent] * m_start) @ E * m_end.  Two
        # plan-time reductions on the dominant matmul:
        # 1. children sharing (parent, m_start) share the product row;
        # 2. the row is zero outside the start class's support (masks are
        #    0/1), so the contraction slices to (rows, |supp|) @
        #    (|supp|, S).  Dropping exact zeros from a dot product is
        #    bit-exact.
        pairs = np.stack([step.parent, step.m_start], axis=1)
        upairs, inv = np.unique(pairs, axis=0, return_inverse=True)
        inv = np.asarray(inv).reshape(-1)
        normal, order = [], []
        for c in np.unique(upairs[:, 1]):
            rows = np.where(upairs[:, 1] == c)[0]
            supp = None if c < 0 else t(np.where(masks_np[c] > 0)[0])
            normal.append((t(upairs[rows, 0]), supp))
            order.append(rows)
        perm = np.concatenate(order)
        invperm = np.empty(upairs.shape[0], dtype=np.int64)
        invperm[perm] = np.arange(upairs.shape[0])
        st = _Step(normal=normal, gather=t(invperm[inv]), m_end=t(step.m_end),
                   child=t(step.child))
        if per_step[s]:
            n_v = step.vl_parent.size
            buckets = []
            for bi, (sup_idx, t_sel, local_prop) in enumerate(per_step[s]):
                cls, rid = rids[(s, bi)]
                groups, inv_pos = _group_apps(t_sel, local_prop,
                                              sup_idx.shape[0])
                buckets.append(_VlBucket(
                    t_sel=t(t_sel),
                    groups=[(t(np.where(app_idx >= 0, t_sel[app_idx], n_v)),
                             t(sup_idx[union_ids]), t(rid[union_ids]))
                            for union_ids, app_idx in groups],
                    inv_pos=t(inv_pos),
                    rows=t(sup_idx[local_prop]),
                    cls=cls,
                ))
            st.vl_parent = t(step.vl_parent)
            st.vl_child = t(step.vl_child)
            st.vl_m_start = t(step.vl_m_start)
            st.vl_m_end = t(step.vl_m_end)
            st.vl_buckets = buckets
        steps.append(st)
    classes = [(t(rep_sup), t(rep_step)) for rep_sup, rep_step in classes]
    return steps, classes


def _run_chain(steps, masks, p, expms, vl_expms=None):
    """Run the interval DP: ``p`` is the (n_keys, S) key-probability table,
    ``expms`` the (n_steps, S, S) interval propagators and ``vl_expms`` the
    per-size-class support-block exponentials."""
    n = p.shape[1]
    for s, st in enumerate(steps):
        e = expms[s]
        new_p = p.clone()
        zs = [p[par] @ e if supp is None else p[par][:, supp] @ e[supp]
              for par, supp in st.normal]
        z = torch.cat(zs, dim=0)
        new_p[st.child] = z[st.gather] * masks[st.m_end]
        if st.vl_buckets:
            # multi-coalescence transitions via support-compressed
            # union-restricted propagators (see schedule.StepPlan docstring)
            y = p[st.vl_parent] * masks[st.vl_m_start]
            # zero row (padded application slots) + zero col (padded
            # support slots, index n)
            y_pad = F.pad(y, (0, 1, 0, 1))
            child_vals = torch.zeros(y.shape, dtype=p.dtype, device=p.device)
            for bk in st.vl_buckets:
                e_cls = vl_expms[bk.cls]
                outs = [
                    torch.bmm(y_pad[glob[:, :, None], cols[:, None, :]],
                              e_cls[e_idx]).reshape(-1, cols.shape[1])
                    for glob, cols, e_idx in bk.groups
                ]
                out_sub = torch.cat(outs, dim=0)[bk.inv_pos]
                scat = torch.zeros((bk.rows.shape[0], n + 1), dtype=p.dtype,
                                   device=p.device)
                scat.scatter_add_(1, bk.rows, out_sub)
                child_vals[bk.t_sel] = scat[:, :n]
            new_p[st.vl_child] = child_vals * masks[st.vl_m_end]
        p = new_p
    return p


def _index_sum(out, idx, v):
    """``out[idx] += v``, repeated indices summed in one fixed order.  On
    the card ``index_add_`` sums them with atomics, in an order that can
    change from call to call, so two builds of one model could differ in
    their last bits; ``index_put_``'s accumulate sorts the indices first.
    On the CPU ``index_add_`` sums in index order."""
    if out.is_cuda:
        return out.index_put_((idx,), v, accumulate=True)
    return out.index_add_(0, idx, v)


def _rate_matrix(coal_pattern, rho_pattern, coal, rho):
    q = coal * coal_pattern + rho * rho_pattern
    return q - torch.diag(q.sum(dim=1))


class AbcStage:
    """The deep (ABC) epoch and the final interval of one plan, on one
    device: per-initial-key probability vectors ``pi_abc`` of shape
    (len(plan.abc_init_from_ab), 203) -> the (M, M) joint hidden-state
    matrix.  Shared by the plain builder (:class:`JointMatrixFn`) and the
    introgression builder (``introgression/model.py``), as the JAX
    package shares ``itrails_tpu/core/ctmc.py:375 run_abc_stage``."""

    def __init__(self, plan: Plan, dtype=torch.float64, *, device):
        self.plan = plan
        self.dtype = dtype
        self.device = torch.device(device)

        def f(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        def ix(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64),
                                   device=self.device)

        self._abc_masks = f(plan.abc_masks)
        self._abc_steps, self._vl_classes = _prepare_chain(
            plan.abc_steps, plan.abc_masks, self.device, vanloan=True)
        self._abc_init = ix(plan.abc_init_from_ab)
        self._keep = ix(np.where(plan.keep_mask)[0])
        self._no_masks = f(plan.noabs_masks)
        self._direct_src = ix(plan.direct_src)
        self._direct_out = ix(plan.direct_out)
        self._deep = [(g.m, ix(g.src), ix(g.out), ix(g.path))
                      for g in plan.deep_groups]
        m = len(plan.hidden_states)
        self._m = m
        self._entry_flat = ix(plan.entry_row * m + plan.entry_col)

    def __call__(self, pi_abc, q_abc, cut_ABC):
        """``cut_ABC`` has ``n_int_ABC + 1`` entries with the last one
        unused (infinity in the reference)."""
        plan = self.plan
        kw = {"dtype": self.dtype, "device": self.device}
        cut_ABC = torch.as_tensor(cut_ABC, **kw)
        dt_abc = cut_ABC[1:] - cut_ABC[:-1]  # last entry unused

        p_abc = torch.zeros((plan.abc_n_keys, q_abc.shape[0]), **kw)
        p_abc[self._abc_init] = pi_abc
        n_steps = plan.n_int_ABC - 1
        if n_steps:
            e_abc = expm_batch(q_abc[None] * dt_abc[:n_steps, None, None])
            q_ext = F.pad(q_abc, (0, 1, 0, 1))  # zero padding row/col
            vl_expms = [
                expm_batch(q_ext[rep[:, :, None], rep[:, None, :]]
                           * dt_abc[rep_step][:, None, None])
                for rep, rep_step in self._vl_classes
            ]
            p_abc = _run_chain(self._abc_steps, self._abc_masks, p_abc, e_abc,
                               vl_expms)

        # ---- final (infinite) interval ----
        entries = torch.zeros(plan.n_entries, **kw)
        _index_sum(entries, self._direct_out,
                   p_abc[self._direct_src].sum(dim=1))
        keep = self._keep
        q_no = q_abc[keep][:, keep]
        n_mat = torch.linalg.solve(
            q_no, -torch.eye(keep.numel(), **kw))
        p_no = p_abc[:, keep]
        for m, src, out, path in self._deep:
            x = p_no[src] @ n_mat
            for i in range(1, m):
                mf = self._no_masks[path[:, i - 1]]
                mt = self._no_masks[path[:, i]]
                x = ((x * mf) @ q_no) * mt
                if i < m - 1:
                    x = x @ n_mat
            _index_sum(entries, out, x.sum(dim=1))

        joint = torch.zeros(self._m * self._m, **kw)
        _index_sum(joint, self._entry_flat, entries)
        return joint.view(self._m, self._m)


class JointMatrixFn:
    """``rates -> (M, M)`` joint probability matrix over (left, right)
    hidden gene-tree states for one plan, on one device.

    Rows and columns follow ``plan.hidden_states``; rows sum to the
    state's stationary mass (reference get_trans_emiss.py:159-168 consumes
    it the same way)."""

    def __init__(self, plan: Plan, dtype=torch.float64, *, device):
        self.plan = plan
        self.dtype = dtype
        self.device = torch.device(device)

        def f(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        sp1, sp2, sp3 = state_space(1), state_space(2), state_space(3)
        self._pat = {k: (f(sp.coal_pattern), f(sp.rho_pattern))
                     for k, sp in ((1, sp1), (2, sp2), (3, sp3))}
        self._start_1 = sp1.index[(1, 1)]
        self._combine2 = f(combine_partitions_map(1, 1))  # (15, 2, 2)
        self._combine3 = f(combine_partitions_map(2, 1))  # (203, 15, 2)
        self._ab_masks = f(plan.ab_masks)
        self._ab_steps, _ = _prepare_chain(plan.ab_steps, plan.ab_masks,
                                           self.device, vanloan=False)
        self._abc = AbcStage(plan, dtype, device=self.device)

    def __call__(self, *, coal_A, coal_B, coal_C, coal_AB, coal_ABC,
                 rho_A, rho_B, rho_C, rho_AB, rho_ABC, t_A, t_B, t_C,
                 cut_AB, cut_ABC):
        """``cut_AB`` has ``n_int_AB + 1`` finite entries; ``cut_ABC`` has
        ``n_int_ABC + 1`` entries with the last one unused (infinity in
        the reference)."""
        plan = self.plan
        kw = {"dtype": self.dtype, "device": self.device}
        q_a = _rate_matrix(*self._pat[1], coal_A, rho_A)
        q_b = _rate_matrix(*self._pat[1], coal_B, rho_B)
        q_c = _rate_matrix(*self._pat[1], coal_C, rho_C)
        q_ab = _rate_matrix(*self._pat[2], coal_AB, rho_AB)
        q_abc = _rate_matrix(*self._pat[3], coal_ABC, rho_ABC)

        cut_AB = torch.as_tensor(cut_AB, **kw)
        dt_ab = cut_AB[1:] - cut_AB[:-1]

        # single-sequence initial chains: start in the "left and right
        # linked" state (1,1) (reference get_joint_prob_mat.py:101-123)
        singles = expm_batch(
            torch.stack([q_a * t_A, q_b * t_B, q_c * t_C])
        )[:, self._start_1, :]
        f_a, f_b, f_c = singles[0], singles[1], singles[2]
        pi_ab = torch.einsum("i,j,mij->m", f_a, f_b, self._combine2)

        # ---- AB epoch ----
        e_ab = expm_batch(q_ab[None] * dt_ab[:, None, None])
        p_ab = torch.zeros((plan.ab_n_keys, q_ab.shape[0]), **kw)
        p_ab[0] = pi_ab
        p_ab = _run_chain(self._ab_steps, self._ab_masks, p_ab, e_ab)

        # ---- combine with C, run the ABC epoch and the final interval ----
        pi_abc = torch.einsum("ki,j,mij->km", p_ab, f_c, self._combine3)
        return self._abc(pi_abc, q_abc, cut_ABC)
