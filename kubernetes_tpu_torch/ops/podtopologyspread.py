"""PodTopologySpread: featurization and the plain PyTorch filter and score.

Counterpart of ``kubernetes_tpu/ops/podtopologyspread.py``.  Reference
(plugins/podtopologyspread/):
  * Filter (filtering.go:283): for each DoNotSchedule constraint the node
    must carry the topology key, and ``matchNum + selfMatch − minMatchNum
    ≤ maxSkew``, where matchNum counts selector-matching pods in the node's
    domain and minMatchNum is the global minimum over existing domains (0
    below minDomains domains; MaxInt32 when no eligible domain exists).
  * Score (scoring.go): per ScheduleAnyway constraint a node is credited
    ``cnt·log(topoSize+2) + (maxSkew−1)`` (per-node count for the hostname
    key); nodes missing a key score 0; the sum is rounded half up and
    normalized to ``100·(max + min − s)/max`` over the scored nodes.
  * Counting eligibility (filtering.go:262 processNode): nodes must carry
    every constraint's key, and the node-inclusion policies apply
    (nodeAffinityPolicy Honor: the pod's NodeAffinity filter;
    nodeTaintsPolicy Honor: its TaintToleration filter).

Pods with identical (namespace, labels) share an interned group and the
state keeps per-(group, node) pod counts, so a constraint's selector is a
(G,) group mask.  The functions below are the plain versions over a chunk
of C pods; on the card the ``spread_filter`` and ``late_scores`` entries of
``kernels/csrc/spread_eval.cu`` compute them per pod with shared-memory
domain tables, reading the NodeAffinity and TaintToleration filters from
the ``node_filters`` kernel's per-batch bits.

The f64 score takes ``log(topoSize + 2)`` from a table built with Python's
``math.log`` (``helpers.log_table``): ``torch.log`` on the CPU differs from it, and
from XLA's, in the last bit for some integers, which can flip the rounding;
the kernel reads the same table.

The DoNotSchedule group masks (``tps_h_groups``) also feed the chunk-mate
conflict table (engine/pass_.py) and the packer's conflict classes
(engine/packing.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import types as t
from ..framework.config import MAX_NODE_SCORE
from ..intern import InternTable
from ..snapshot import _bucket
from . import nodeaffinity, tainttoleration
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register
from .helpers import domain_tables, log_table

HOSTNAME_KEY = InternTable.HOSTNAME_KEY
MAX_INT32 = 2**31 - 1


def groups_matching(it, g_cap: int, ns_ids: set[int] | None, selector) -> np.ndarray:
    """(G,) bitmask of pod label-groups matched by ``selector`` within the
    given namespace-id set (None = any namespace): the scalar analog of
    countPodsMatchSelector, which GroupIndex.match_selector vectorizes."""
    mask = np.zeros(g_cap, np.bool_)
    for gid in range(len(it.groups)):
        ns_id, fs = it.groups.value(gid)
        if ns_ids is not None and ns_id not in ns_ids:
            continue
        if t.label_selector_matches(selector, dict(fs)):
            mask[gid] = True
    return mask


def _constraint_feats(constraints, pod: t.Pod, fctx: FeaturizeContext, prefix: str) -> dict:
    it = fctx.interns
    builder = fctx.builder
    cdim = _bucket(max(len(constraints), 1), 1)
    ns_id = it.namespaces.id(pod.namespace)
    slots = np.zeros(cdim, np.int32)
    skew = np.ones(cdim, np.int32)
    mindom = np.ones(cdim, np.int32)
    selfm = np.zeros(cdim, np.bool_)
    hostname = np.zeros(cdim, np.bool_)
    honor_aff = np.zeros(cdim, np.bool_)
    honor_taint = np.zeros(cdim, np.bool_)
    valid = np.zeros(cdim, np.bool_)
    masks = np.zeros((cdim, builder.schema.G), np.bool_)
    # With NodeInclusionPolicyInPodTopologySpread off the legacy fixed
    # policy applies (honor affinity, ignore taints); with
    # MatchLabelKeysInPodTopologySpread off matchLabelKeys are ignored.
    incl = fctx.gates.enabled("NodeInclusionPolicyInPodTopologySpread")
    mlk = fctx.gates.enabled("MatchLabelKeysInPodTopologySpread")
    for i, c in enumerate(constraints):
        slots[i] = builder.ensure_topo_key(c.topology_key)
        valid[i] = True
        skew[i] = c.max_skew
        mindom[i] = c.min_domains or 1
        sel = t.spread_effective_selector(c, pod.metadata.labels) if mlk else c.label_selector
        selfm[i] = t.label_selector_matches(sel, pod.metadata.labels)
        hostname[i] = c.topology_key == HOSTNAME_KEY
        honor_aff[i] = (c.node_affinity_policy == t.POLICY_HONOR) if incl else True
        honor_taint[i] = (c.node_taints_policy == t.POLICY_HONOR) if incl else False
        m = builder.group_index.match_selector(sel, {ns_id})
        masks[i, : m.shape[0]] = m
    return {
        f"{prefix}_valid": valid,
        f"{prefix}_slot": slots,
        f"{prefix}_skew": skew,
        f"{prefix}_mindom": mindom,
        f"{prefix}_self": selfm,
        f"{prefix}_hostname": hostname,
        f"{prefix}_aff": honor_aff,
        f"{prefix}_taint": honor_taint,
        f"{prefix}_groups": masks,
    }


def _effective_constraints(pod: t.Pod, fctx: FeaturizeContext):
    """The pod's constraints, or the profile's defaultConstraints for pods
    without any (types_pluginargs.go:72), with the pod's own full label set
    as the selector; label-less pods skip defaulting."""
    cons = pod.spec.topology_spread_constraints
    if cons:
        return cons
    prof = fctx.profile
    if prof is None or not prof.pts_default_constraints or not pod.metadata.labels:
        return cons
    sel = t.LabelSelector(match_labels=tuple(sorted(pod.metadata.labels.items())))
    return tuple(dataclasses.replace(c, label_selector=sel) for c in prof.pts_default_constraints)


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    cons = _effective_constraints(pod, fctx)
    hard = [c for c in cons if c.when_unsatisfiable == t.DO_NOT_SCHEDULE]
    soft = [c for c in cons if c.when_unsatisfiable == t.SCHEDULE_ANYWAY]
    feats = _constraint_feats(hard, pod, fctx, "tps_h")
    feats.update(_constraint_feats(soft, pod, fctx, "tps_s"))
    # The node-inclusion policies read the NodeAffinity and TaintToleration
    # filters: their features must exist whenever spread is active, even
    # when those ops are batch-inactive or absent from the profile.
    if fctx.active is None or "NodeAffinity" not in fctx.active:
        feats.update(nodeaffinity.featurize(pod, fctx))
    if fctx.active is None or "TaintToleration" not in fctx.active:
        feats.update(tainttoleration.featurize(pod, fctx))
    return feats


def per_constraint(state, pf, ctx: PassContext, prefix: str, na_ok=None, taint_ok=None):
    """Shared geometry (podtopologyspread.py:169) for a chunk: (valid (C, K),
    vals (C, K, N), key_present, all_keys (C, N), elig (C, K, N), cnt
    (C, K, N) f32 eligible matching-pod counts, cnt_raw).  ``na_ok`` and
    ``taint_ok`` (C, N) are the NodeAffinity and TaintToleration filters,
    computed here when not given."""
    valid = pf[f"{prefix}_valid"]
    vals = state.topo_vals.T[pf[f"{prefix}_slot"].to(torch.int64)]  # (C, K, N)
    key_present = vals >= 0
    all_keys = (key_present | ~valid[:, :, None]).all(dim=1)
    if na_ok is None:
        na_ok = nodeaffinity.filter_fn(state, pf, ctx)
    if taint_ok is None:
        taint_ok = tainttoleration.filter_fn(state, pf, ctx)
    elig = (
        (state.valid[None, :] & all_keys)[:, None, :]
        & torch.where(pf[f"{prefix}_aff"][:, :, None], na_ok[:, None, :], True)
        & torch.where(pf[f"{prefix}_taint"][:, :, None], taint_ok[:, None, :], True)
    )
    # Matching-pod counts per node: integer counts, exact in f32.
    cnt_raw = pf[f"{prefix}_groups"].to(torch.float32) @ state.group_counts.to(torch.float32)
    cnt = torch.where(elig, cnt_raw, 0.0)
    return valid, vals, key_present, all_keys, elig, cnt, cnt_raw


def _gather_dv(tbl: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """tbl[c, k, vals[c, k, n]], 0 where vals lies outside [0, DV)."""
    dv = tbl.shape[-1]
    got = torch.gather(tbl, 2, vals.clamp(0, dv - 1).to(torch.int64))
    return torch.where((vals >= 0) & (vals < dv), got, torch.zeros((), dtype=tbl.dtype))


def filter_fn(state, pf, ctx: PassContext, na_ok=None, taint_ok=None):
    """(C, N) bool (podtopologyspread.py:219)."""
    valid, vals, key_present, _all, elig, cnt, _raw = per_constraint(
        state, pf, ctx, "tps_h", na_ok, taint_ok)
    dv = ctx.schema.DV
    host = pf["tps_h_hostname"]  # (C, K)
    slots = pf["tps_h_slot"]
    # Generic path: per-domain tables over the (hostname-free) DV vocabulary.
    _v, _k, _m, tbl = domain_tables(state, slots, cnt, dv)
    _v, _k, _m, pres = domain_tables(state, slots, elig.to(torch.float32), dv)
    present = pres > 0.5
    tbl = tbl.to(torch.int64)
    min_g = torch.where(present, tbl, MAX_INT32).min(dim=2).values
    dom_g = present.sum(dim=2)
    match_g = _gather_dv(tbl, vals)
    # Hostname: every domain is one node, so counts and minima are per node.
    cnt_i = cnt.to(torch.int64)
    min_h = torch.where(elig, cnt_i, MAX_INT32).min(dim=2).values
    dom_h = elig.sum(dim=2)
    min_tbl = torch.where(host, min_h, min_g)
    domains = torch.where(host, dom_h, dom_g)
    match_n = torch.where(host[:, :, None], cnt_i, match_g)
    min_match = torch.where(domains < pf["tps_h_mindom"], 0, min_tbl)
    skew = match_n + pf["tps_h_self"][:, :, None].to(torch.int64) - min_match[:, :, None]
    ok = key_present & (skew <= pf["tps_h_skew"][:, :, None])
    return (ok | ~valid[:, :, None]).all(dim=1)


def hard_filter_fn(state, pf, ctx: PassContext):
    """(C, N) bool: nodes missing a DoNotSchedule constraint's topology key,
    UnschedulableAndUnresolvable (podtopologyspread.py:338); skew
    violations are not."""
    vals = state.topo_vals.T[pf["tps_h_slot"].to(torch.int64)]  # (C, K, N)
    return ((vals < 0) & pf["tps_h_valid"][:, :, None]).any(dim=1)


def raw_score(state, pf, ctx: PassContext, feasible, na_ok=None, taint_ok=None):
    """(scored (C, N) bool, raw (C, N) i64): the rounded f64 sum of the
    ScheduleAnyway terms (podtopologyspread.py:261-311), before the
    normalization."""
    valid, vals, key_present, all_keys, elig, cnt, cnt_raw = per_constraint(
        state, pf, ctx, "tps_s", na_ok, taint_ok)
    # Nodes missing a constraint's key are "ignored" (score 0).
    scored = feasible & all_keys
    dv = ctx.schema.DV
    slots = pf["tps_s_slot"]
    _v, _k, _m, tbl = domain_tables(state, slots, cnt, dv)
    # topoSize counts distinct domains among the scored nodes; for the
    # hostname key it is the number of scored nodes.
    cand = scored[:, None, :].expand(vals.shape).to(torch.float32)
    _v, _k, _m, pres = domain_tables(state, slots, cand, dv)
    pair_cnt = _gather_dv(tbl, vals)
    host = pf["tps_s_hostname"]
    # Hostname counts the node's own pods, with no eligibility mask.
    cnt_for_node = torch.where(host[:, :, None], cnt_raw, pair_cnt)
    topo_size = torch.where(host, scored.sum(dim=1, keepdim=True), (pres > 0.5).sum(dim=2))
    w = log_table(max(state.valid.shape[0], dv), vals.device)[topo_size]  # (C, K) f64
    term = key_present.to(torch.float64) * (
        cnt_for_node.to(torch.float64) * w[:, :, None]
        + (pf["tps_s_skew"][:, :, None].to(torch.float64) - 1.0)
    )
    # Summed over the constraints in order, as XLA's reduction adds them.
    raw = torch.zeros(scored.shape, dtype=torch.float64, device=scored.device)
    for k in range(term.shape[1]):
        raw = raw + torch.where(valid[:, k, None], term[:, k], 0.0)
    return scored, torch.floor(raw + 0.5).to(torch.int64)


def normalize(scored, raw, any_constraint) -> torch.Tensor:
    """``100·(max + min − s) // max`` over the scored nodes; 0 elsewhere,
    and 0 everywhere for a pod with no ScheduleAnyway constraint."""
    big = 2**62
    mn = torch.where(scored, raw, big).min(dim=1, keepdim=True).values
    mn = torch.where(scored.any(dim=1, keepdim=True), mn, 0)
    mx = torch.where(scored, raw, 0).max(dim=1, keepdim=True).values
    norm = torch.where(
        mx == 0,
        MAX_NODE_SCORE,
        torch.div(MAX_NODE_SCORE * (mx + mn - raw), mx.clamp(min=1), rounding_mode="floor"),
    )
    norm = torch.where(scored, norm, 0)
    return torch.where(any_constraint[:, None], norm, 0)


def score_fn(state, pf, ctx: PassContext, feasible, na_ok=None, taint_ok=None):
    scored, raw = raw_score(state, pf, ctx, feasible, na_ok, taint_ok)
    return normalize(scored, raw, pf["tps_s_valid"].any(dim=1))


for _k, _fill in [
    ("tps_h_valid", 0), ("tps_h_slot", 0), ("tps_h_skew", 1), ("tps_h_mindom", 1),
    ("tps_h_self", 0), ("tps_h_hostname", 0), ("tps_h_aff", 0), ("tps_h_taint", 0),
    ("tps_h_groups", 0),
    ("tps_s_valid", 0), ("tps_s_slot", 0), ("tps_s_skew", 1), ("tps_s_mindom", 1),
    ("tps_s_self", 0), ("tps_s_hostname", 0), ("tps_s_aff", 0), ("tps_s_taint", 0),
    ("tps_s_groups", 0),
]:
    feature_fill(_k, _fill)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    # No constraints: PreFilter and PreScore Skip.  Profile default
    # constraints make the op active for any labelled pod of the profile.
    if pod.spec.topology_spread_constraints:
        return True
    prof = fctx.profile
    return bool(prof is not None and prof.pts_default_constraints and pod.metadata.labels)


register(
    OpDef(
        name="PodTopologySpread",
        featurize=featurize,
        filter=filter_fn,
        score=score_fn,
        hard_filter=hard_filter_fn,
        is_active=is_active,
    )
)
