"""InterPodAffinity: featurization and the plain PyTorch filter and score.

Counterpart of ``kubernetes_tpu/ops/interpodaffinity.py``.  Reference
(plugins/interpodaffinity/):
  * Filter (filtering.go:354-383 satisfy*): (1) existing pods' required
    anti-affinity terms matching the incoming pod forbid every node sharing
    the term's topology pair with a carrier; (2) the incoming pod's required
    affinity terms need, per term, a node whose domain hosts a pod matching
    ALL terms (all topology keys present, with the lonely-first-pod
    self-match exception); (3) the incoming pod's required anti-affinity
    terms forbid domains hosting any matching pod.
  * Score (scoring.go:80-124): the incoming pod's preferred terms (±w per
    matching pod in the node's domain) plus existing pods' terms matching
    the pod (hard affinity weight, ±w); min-max normalized to 0..100 over
    the feasible nodes.

Existing pods' terms are interned into a term vocabulary; the cluster state
carries per-(term, node) carrier counts (et_counts), and the pass keeps the
per-domain tables ``group_dom`` (G, TK, DV) and ``et_dom`` (ET, DV)
(engine/pass_.py DomTables, bound on ``PassContext.dom`` per pass).
Featurization matches the incoming pod against every interned term once and
compiles the pod's own terms to group bitmasks.

The functions below are the plain versions over a chunk of C pods: every
feature leaf is (C, …) and the result is (C, N).  They compute in f32 where
the JAX op does; the values are integer counts times weights of at most
100, exact below 2^24.  On the card the ``ipa_eval`` kernel
(kernels/csrc/ipa_eval.cu) computes the same numbers with gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from ..framework.config import MAX_NODE_SCORE
from ..intern import term_key
from ..snapshot import _bucket
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register

# Existing-term categories (intern.term_id).
CAT_REQ_AFF, CAT_REQ_ANTI, CAT_PREF_AFF, CAT_PREF_ANTI = 0, 1, 2, 3


def _term_matches_pod(key, pod: t.Pod, ns_labels: dict[str, dict[str, str]]) -> bool:
    """AffinityTerm.Matches (framework/types.go:479): namespace membership or
    namespaceSelector over the pod's namespace labels, AND label selector."""
    _cat, _w, _topo, ns_tuple, ns_sel, selector = key
    ns_ok = pod.namespace in ns_tuple or (
        ns_sel is not None
        and t.label_selector_matches(ns_sel, ns_labels.get(pod.namespace, {}))
    )
    return ns_ok and t.label_selector_matches(selector, pod.metadata.labels)


def _term_group_ns_ids(term: t.PodAffinityTerm, pod: t.Pod, fctx: FeaturizeContext):
    """Namespace-id set an incoming pod's term selects."""
    it = fctx.interns
    ns = set(term.namespaces)
    if not ns and term.namespace_selector is None:
        ns = {pod.namespace}
    ids = {it.namespaces.id(n) for n in ns}
    if term.namespace_selector is not None:
        # Evaluate the selector over every namespace any group references.
        nsl = fctx.builder.namespace_labels
        for nid in range(len(it.namespaces)):
            name = it.namespaces.value(nid)
            if t.label_selector_matches(term.namespace_selector, nsl.get(name, {})):
                ids.add(nid)
    return ids


def _own_term_feats(terms, pod: t.Pod, fctx: FeaturizeContext, prefix: str, weights=None) -> dict:
    """Compile the incoming pod's terms: per-term topo slot + group bitmask."""
    builder = fctx.builder
    dim = _bucket(max(len(terms), 1), 1)
    valid = np.zeros(dim, np.bool_)
    slots = np.zeros(dim, np.int32)
    masks = np.zeros((dim, builder.schema.G), np.bool_)
    wvec = np.zeros(dim, np.int64)
    for i, term in enumerate(terms):
        valid[i] = True
        slots[i] = builder.ensure_topo_key(term.topology_key)
        ns_ids = _term_group_ns_ids(term, pod, fctx)
        m = builder.group_index.match_selector(term.label_selector, ns_ids)
        masks[i, : m.shape[0]] = m
        if weights is not None:
            wvec[i] = weights[i]
    host = np.zeros(dim, np.bool_)
    for i, term in enumerate(terms):
        host[i] = term.topology_key == fctx.interns.HOSTNAME_KEY
    out = {
        f"{prefix}_valid": valid,
        f"{prefix}_slot": slots,
        f"{prefix}_groups": masks,
        f"{prefix}_host": host,
    }
    if weights is not None:
        out[f"{prefix}_w"] = wvec
    return out


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    it = fctx.interns
    builder = fctx.builder
    aff = pod.spec.affinity
    pa = aff.pod_affinity if aff else None
    paa = aff.pod_anti_affinity if aff else None
    req_aff = list(pa.required) if pa else []
    req_anti = list(paa.required) if paa else []
    pref = [(wt.term, wt.weight) for wt in (pa.preferred if pa else ())]
    pref += [(wt.term, -wt.weight) for wt in (paa.preferred if paa else ())]

    feats = _own_term_feats(req_aff, pod, fctx, "ipa_ra")
    feats.update(_own_term_feats(req_anti, pod, fctx, "ipa_rs"))
    feats.update(
        _own_term_feats([term for term, _ in pref], pod, fctx, "ipa_pf", [w for _, w in pref])
    )
    # Required affinity counts pods matching ALL terms
    # (podMatchesAllAffinityTerms): intersect the per-term group masks.  The
    # per-term masks stay on the host: only the intersection is read.
    ra_groups = feats.pop("ipa_ra_groups")
    if req_aff:
        allmask = ra_groups[: len(req_aff)].all(axis=0)
    else:
        allmask = np.zeros(builder.schema.G, np.bool_)
    feats["ipa_ra_allmask"] = allmask
    # podMatchesAllAffinityTerms(pod's own terms, pod) for the
    # lonely-first-pod exception (filtering.go:345).
    feats["ipa_ra_self"] = np.bool_(
        bool(req_aff)
        and all(
            _term_matches_pod(
                term_key(CAT_REQ_AFF, 0, term, pod.namespace), pod, builder.namespace_labels
            )
            for term in req_aff
        )
    )

    # Match the pod against every interned existing-pod term: one column of
    # the incremental term↔group matrix (intern.TermIndex).
    builder._ensure(ET=max(len(it.terms), 1))
    et = builder.schema.ET
    et_match = np.zeros(et, np.bool_)
    et_anti = np.zeros(et, np.bool_)
    et_w = np.zeros(et, np.int64)
    hard_w = fctx.profile.hard_pod_affinity_weight if fctx.profile else 1
    gid = it.group_id(pod.namespace, pod.metadata.labels)
    builder.term_index.sync(builder.ns_epoch)
    col, cats, weights = builder.term_index.column(gid)
    nt = col.shape[0]
    et_match[:nt] = col
    et_anti[:nt] = col & (cats == CAT_REQ_ANTI)
    et_w[:nt] = np.where(
        col,
        np.where(
            cats == CAT_REQ_AFF,
            hard_w,
            np.where(
                cats == CAT_PREF_AFF,
                weights,
                np.where(cats == CAT_PREF_ANTI, -weights, 0),
            ),
        ),
        0,
    )
    feats.update(ipa_et_match=et_match, ipa_et_anti=et_anti, ipa_et_w=et_w)
    return feats


def _gather_dv(tbl: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """tbl[..., vals] along the last axis, 0 where vals lies outside
    [0, DV): the read-back the JAX op does with the topology one-hot, whose
    rows are zero for missing keys and for hostname values (≥ DV)."""
    dv = tbl.shape[-1]
    ok = (vals >= 0) & (vals < dv)
    got = torch.gather(tbl, -1, vals.clamp(0, dv - 1).to(torch.int64))
    return torch.where(ok, got, torch.zeros((), dtype=tbl.dtype, device=tbl.device))


def _own_term_tallies(state, dom, slots, masks, host):
    """Per-term domain tallies of the incoming pods' own terms.

    ``slots`` (C, T) topology slots, ``masks`` (C, T, G) group bitmasks,
    ``host`` (C, T) hostname-key flags.  Returns (key_present (C, T, N),
    cnt_node (C, T, N), at_node (C, T, N), tbl (C, T, DV)): the per-node
    count of matching pods, the term's domain tally at each node (0 where
    the key is missing) and the per-domain table."""
    n, tk = state.topo_vals.shape
    sl = slots.to(torch.int64)
    vals = state.topo_vals.T[sl]  # (C, T, N)
    key_present = vals >= 0
    mf = masks.to(torch.float32)
    cnt_node = mf @ state.group_counts.to(torch.float32)  # (C, T, N)
    by_slot = torch.einsum("ctg,gkd->ctkd", mf, dom.group_dom)  # (C, T, TK, DV)
    dv = by_slot.shape[-1]
    tbl = torch.gather(by_slot, 2, sl[:, :, None, None].expand(-1, -1, 1, dv))[:, :, 0]
    gathered = _gather_dv(tbl, vals)  # (C, T, N)
    at_node = torch.where(key_present, torch.where(host[:, :, None], cnt_node, gathered), 0.0)
    return key_present, cnt_node, at_node, tbl


def _affinity_ok(state, pf, ctx: PassContext):
    """Incoming required-affinity check (2): (C, N) bool."""
    ra_valid = pf["ipa_ra_valid"]  # (C, RA)
    any_ra = ra_valid.any(dim=1)
    host = pf["ipa_ra_host"]
    # All required terms share one intersection mask (podMatchesAllAffinityTerms).
    allmask = pf["ipa_ra_allmask"][:, None, :].expand(-1, ra_valid.shape[1], -1)
    key_ra, cnt_node, at_ra, tbl = _own_term_tallies(state, ctx.dom, pf["ipa_ra_slot"], allmask, host)
    off = ~ra_valid[:, :, None]
    keys_ok = (key_ra | off).all(dim=1)
    pods_exist = ((at_ra > 0.5) | off).all(dim=1)
    # len(affinityCounts) == 0 ⟺ no key-bearing node hosts a matching pod.
    per_term_total = torch.where(host, (key_ra.to(torch.float32) * cnt_node).sum(-1), tbl.sum(-1))
    counts_empty = torch.where(ra_valid, per_term_total, 0.0).sum(dim=1) == 0
    lonely = (counts_empty & pf["ipa_ra_self"])[:, None]
    return ~any_ra[:, None] | (keys_ok & (pods_exist | lonely))


def _slot_tables(pf_e, et_dom, et_slot, tk: int) -> torch.Tensor:
    """(C, TK, DV): per pod, Σ over the terms e of pf_e[c, e] · et_dom[e, d]
    at term e's own slot (the terms merge per slot)."""
    slot_oh = et_slot[:, None] == torch.arange(tk, device=et_slot.device)[None, :]
    return torch.einsum("ce,ek,ed->ckd", pf_e, slot_oh.to(torch.float32), et_dom)


def _read_slots(kd: torch.Tensor, topo_vals: torch.Tensor) -> torch.Tensor:
    """(C, N): Σ_k kd[c, k, topo_vals[n, k]], skipping missing keys."""
    c = kd.shape[0]
    vals = topo_vals.T[None].expand(c, -1, -1)  # (C, TK, N)
    return _gather_dv(kd, vals).sum(dim=1)


def _term_keys(state, dom) -> torch.Tensor:
    """(ET, N) bool: node n has term e's topology key."""
    return state.topo_vals[:, dom.et_slot.to(torch.int64)].T >= 0


def _existing_anti_fail(state, pf, ctx: PassContext):
    """(1) Existing pods' required anti-affinity: a node fails if any of its
    topology domains carries a matching term (filtering.go:306); hostname
    terms check their per-node carrier counts directly.  (C, N) bool."""
    dom = ctx.dom
    active_e = pf["ipa_et_match"] & pf["ipa_et_anti"]  # (C, ET)
    nonhost = (active_e & ~dom.et_host[None, :]).to(torch.float32)
    tk = state.topo_vals.shape[1]
    forbidden = _slot_tables(nonhost, (dom.et_dom > 0.5).to(torch.float32), dom.et_slot, tk)
    fail_nonhost = _read_slots(forbidden, state.topo_vals) > 0.5
    host_active = (active_e & dom.et_host[None, :]).to(torch.float32)
    key_e = _term_keys(state, dom)
    fail_host = (host_active @ ((state.et_counts > 0) & key_e).to(torch.float32)) > 0.5
    return fail_nonhost | fail_host


def filter_fn(state, pf, ctx: PassContext):
    fail_existing = _existing_anti_fail(state, pf, ctx)
    aff_ok = _affinity_ok(state, pf, ctx)
    # (3) Incoming required anti-affinity.
    rs_valid = pf["ipa_rs_valid"]
    key_rs, _cnt, at_rs, _tbl = _own_term_tallies(
        state, ctx.dom, pf["ipa_rs_slot"], pf["ipa_rs_groups"], pf["ipa_rs_host"]
    )
    fail_anti = (rs_valid[:, :, None] & key_rs & (at_rs > 0.5)).any(dim=1)
    return ~fail_existing & aff_ok & ~fail_anti


def hard_filter_fn(state, pf, ctx: PassContext):
    """(C, N) bool: nodes the incoming required affinity rejects, which
    deleting pods never fixes (interpodaffinity.py:300); preemption's
    candidacy check excludes them."""
    return ~_affinity_ok(state, pf, ctx)


def raw_score(state, pf, ctx: PassContext) -> torch.Tensor:
    """(C, N) i64 raw score before normalization."""
    dom = ctx.dom
    # Incoming pod's preferred terms: ±w × (matching pods in the node's domain).
    pf_valid = pf["ipa_pf_valid"]
    key_p, _cnt, at_p, _tbl = _own_term_tallies(
        state, dom, pf["ipa_pf_slot"], pf["ipa_pf_groups"], pf["ipa_pf_host"]
    )
    raw = (
        torch.where(pf_valid[:, :, None] & key_p, at_p, 0.0)
        * pf["ipa_pf_w"][:, :, None].to(torch.float32)
    ).sum(dim=1)
    # Existing pods' terms matching the incoming pod: carriers in the node's
    # domain × signed weight; hostname terms use per-node carrier counts.
    active_e = pf["ipa_et_match"] & (pf["ipa_et_w"] != 0)
    wts = pf["ipa_et_w"].to(torch.float32)
    wsum = _slot_tables(torch.where(active_e & ~dom.et_host[None, :], wts, 0.0), dom.et_dom,
                        dom.et_slot, state.topo_vals.shape[1])
    raw = raw + _read_slots(wsum, state.topo_vals)
    host_w = torch.where(active_e & dom.et_host[None, :], wts, 0.0)
    key_e = _term_keys(state, dom)
    raw = raw + host_w @ (state.et_counts.to(torch.float32) * key_e)
    return raw.to(torch.int64)


def normalize(raw: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """Min-max normalization over each pod's feasible nodes to 0..100 with
    int64 floor division; 0 when every feasible node ties (scoring.go:265)."""
    big = 2**62
    mn = torch.where(feasible, raw, big).min(dim=1, keepdim=True).values
    mx = torch.where(feasible, raw, -big).max(dim=1, keepdim=True).values
    diff = mx - mn
    norm = torch.where(
        diff > 0,
        torch.div(MAX_NODE_SCORE * (raw - mn), diff.clamp(min=1), rounding_mode="floor"),
        0,
    )
    return torch.where(feasible, norm, 0)


def score_fn(state, pf, ctx: PassContext, feasible):
    return normalize(raw_score(state, pf, ctx), feasible)


for _k, _fill in [
    ("ipa_ra_valid", 0), ("ipa_ra_slot", 0), ("ipa_ra_allmask", 0), ("ipa_ra_self", 0),
    ("ipa_ra_host", 0),
    ("ipa_rs_valid", 0), ("ipa_rs_slot", 0), ("ipa_rs_groups", 0), ("ipa_rs_host", 0),
    ("ipa_pf_valid", 0), ("ipa_pf_slot", 0), ("ipa_pf_groups", 0), ("ipa_pf_w", 0),
    ("ipa_pf_host", 0),
    ("ipa_et_match", 0), ("ipa_et_anti", 0), ("ipa_et_w", 0),
]:
    feature_fill(_k, _fill)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    # Inactive only when the pod has no pod (anti-)affinity AND no existing
    # pod carries any term (PreFilter Skip, filtering.go:257).
    if len(fctx.interns.terms) > 0:
        return True
    aff = pod.spec.affinity
    return bool(aff and (aff.pod_affinity or aff.pod_anti_affinity))


register(
    OpDef(
        name="InterPodAffinity",
        featurize=featurize,
        filter=filter_fn,
        score=score_fn,
        hard_filter=hard_filter_fn,
        is_active=is_active,
    )
)
