"""The batched scheduling pass: one call schedules a whole batch.

Counterpart of ``kubernetes_tpu/engine/pass_.py`` (build_pass, :345-744).
The JAX pass is a ``lax.scan`` over chunks of C pods; here it is a Python
loop over chunks that launches its kernels per chunk on the current stream
and does no host sync inside the loop:

  spread_filter   PodTopologySpread's filter (when it filters this pass),
                  a mask that eval_chunk reads
  vol_filter      VolumeRestrictions' and NodeVolumeLimits' filters (when
                  either filters this pass), bits that eval_chunk reads
  eval_chunk      filters + weighted score of the chunk against all N nodes
  ipa_eval        InterPodAffinity's filter and normalized score on top of
                  eval_chunk's result (only when the op is active); when
                  the profile orders a filter after it (the default
                  profile's DynamicResources), its filter launch, then a
                  second eval_chunk launch with those filters on the nodes
                  it left, then its score launch, so every fail bit is the
                  first filter that rejected the node in profile order
  truncate_feasible  truncated mode only: the feasible set cut to the first
                  numFeasibleNodesToFind nodes in rotated scan order, the
                  scan start advanced on the device
  late_scores     the NodeAffinity, TaintToleration and PodTopologySpread
                  scores, which normalize over the final feasible set
  select_host     one pick per pod (hashed tie-break, nominated fast path)
  resolve_commit  chunk deferral + exact cumulative fit, then the commit

and, once per batch before the loop, ``build_dom`` (the per-domain tables,
unless carried from the previous batch), ``node_filters`` (NodeAffinity's,
TaintToleration's, VolumeBinding's and VolumeZone's filters of every pod of
the batch, when one of them filters or spread's inclusion policies read
them), ``image_counts`` and ``image_scores`` (ImageLocality's spread counts
and its raw score of every pod on every node, when the op scores; images
and node validity do not change within a pass, so one plane serves every
chunk, the fused strict tail and, read at the pin, the pinned pass) and,
when the batch carries affinity, spread, volume-id or host-port features,
``conflict_pairs`` (the chunk-mate conflict table).  ``eval_chunk`` also
runs NodePorts' filter against the live port counts.  ``resolve_commit``
also commits device uses, CSI attachments and host ports, and defers
attach-limited pods that share a node with an earlier limited mate.

With chunk=1 each step is one reference scheduling cycle.  With chunk>1
pods that could observe an earlier chunk-mate's commit defer (pick = -2);
the fused strict tail (node-axis-only op sets) or the scheduler's host tail
re-runs them against the committed state.  Result picks: node row ≥ 0, -1
unschedulable, -2 deferred.

The domain tables (``group_dom``/``et_dom``) are built once per pass by
``build_dom`` (or carried from the previous batch under ``carry_dom``),
bound on the ops' ``PassContext.dom`` and updated in place by the commit.
The cluster state is also updated IN PLACE: the returned state is the
same tensors as the input.

Truncated (parity) mode, percentage_of_nodes_to_score != 100 (pass_.py:
408-432, 510-532, 564-569), runs chunk 1 only: each step is one reference
scheduling cycle that scans the zone-interleaved node order
(``inv["order_pos"]``) from a start carried on the device from step to
step (``inv["scan_start"]``) and keeps the first numFeasibleNodesToFind
feasible nodes.  The step order is eval_chunk → ipa_eval's filter →
truncate_feasible → ipa_eval's score → late_scores → select_host in pos
mode (ties in scan order): the scores normalize over the truncated set,
as the JAX pass scores after its cut.  ``PassResult.processed`` holds each
real pod's processedNodes; the caller advances its start by their sum.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..framework.config import Profile
from ..kernels import plain
from ..kernels.plain import IL, IPA, NA, NODE_FILTER_OPS, NVL, PTS, TT, VR
from ..ops import common as opcommon
from ..snapshot import ClusterState, Schema


class PassResult(NamedTuple):
    picks: torch.Tensor  # (K,) i32 — chosen node row, -1 unschedulable, -2 deferred
    scores: torch.Tensor  # (K,) i64 — winning node's total score
    feasible_counts: torch.Tensor  # (K,) i32 — nodes passing all filters
    # (K,) i32 — truncated mode: the nodes each pod's scan examined
    # (processedNodes), 0 on padding lanes; zeros in full evaluation
    processed: torch.Tensor
    # (K,) i32 bits — bit b set ⟺ filter op b rejected ≥1 node that passed
    # every earlier filter.  Bit order = filter_op_names(profile, active).
    fail_masks: torch.Tensor


def filter_op_names(profile: Profile, active: frozenset[str] | None) -> list[str]:
    """Filter-op bit order of PassResult.fail_masks for one pass."""
    return [
        n
        for n in profile.filters
        if (active is None or n in active) and opcommon.get(n).filter is not None
    ]


def score_op_names(profile: Profile, active: frozenset[str] | None) -> list[tuple[str, int]]:
    """Score-op (name, weight) row order of build_attribution_pass's score
    columns (pass_.py:799) — the scorer analog of filter_op_names."""
    return [
        (n, w)
        for n, w in profile.scorers
        if (active is None or n in active) and opcommon.get(n).score is not None
    ]


class DomTables(NamedTuple):
    """Per-domain aggregate tables (pass_.py:76-93): built once per pass
    and maintained incrementally by the commit."""

    group_dom: torch.Tensor  # (G, TK, DV) f32 — pods of group g in domain (k, d)
    et_dom: torch.Tensor  # (ET, DV) f32 — carriers of term t in its key's domain d
    et_slot: torch.Tensor  # (ET,) i32 — term t's topology-key slot
    et_host: torch.Tensor  # (ET,) bool — term t's key is the hostname key


def build_dom(
    state: ClusterState, et_slot: torch.Tensor, et_host: torch.Tensor, dv: int,
    aggregates=kernels.build_dom,
) -> DomTables:
    """Full rebuild of the domain tables from the cluster state
    (``aggregates``: the build_dom kernel or its plain version)."""
    group_dom, et_dom = aggregates(state, et_slot, dv)
    return DomTables(group_dom, et_dom, et_slot, et_host)


def _conflict_pairs(pf: dict, nchunks: int, c: int, pairs_fn) -> torch.Tensor:
    """(nchunks, C, C) bool: does pod i's commit possibly affect pod j's
    decision (pass_.py:266-342)?  Pairs come from the hard reads of
    inter-pod affinity (required (anti-)affinity group masks, matched
    existing anti-affinity terms against own-term writes) and of topology
    spread (DoNotSchedule group masks), against each pod's label-group
    write, from the volumes (a shared device or CSI volume id, or two claims
    that race at PreBind), from a shared host-port key and from DRA (a
    shared claim, or two pods whose unallocated claims race for free
    devices) (``pairs_fn``, the conflict_pairs kernel or its plain
    version).  A batch with none of these features (density) keeps the
    all-false table and launches nothing."""
    if c > 1 and any(key in pf for key in _PAIR_SOURCES):
        return pairs_fn(pf, nchunks, c)
    return torch.zeros((nchunks, c, c), dtype=torch.bool, device=pf["valid"].device)


# Features any of which makes the conflict table non-trivial.
_PAIR_SOURCES = ("ipa_ra_allmask", "tps_h_groups", "vol_dev_ids", "vol_csi_ids", "vol_unbound", "port_keys",
                 "dra_claim_ids")


# Ops whose filter/score read only node-axis state (no domain tables, no
# cross-pod conflict classes) — the JAX package's PINNED_SAFE_OPS
# (pass_.py:891), which gates the fused strict tail.
PINNED_SAFE_OPS = frozenset({
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "ImageLocality",
    "ThroughputAware", "LearnedScorer",
})

class _Fns(NamedTuple):
    """The kernels a pass launches, or their plain versions."""

    dom: object
    eval: object
    ipa: object
    select: object
    commit: object
    pairs: object
    nodes: object
    spread: object
    late: object
    vol: object
    counts: object
    il: object
    trunc: object
    eval_cols: object
    ipa_cols: object
    late_cols: object


_KERNEL_FNS = _Fns(
    kernels.build_dom, kernels.eval_chunk, kernels.ipa_eval, kernels.select_host,
    kernels.resolve_commit, kernels.conflict_pairs, kernels.node_filters,
    kernels.spread_filter, kernels.late_scores, kernels.vol_filter, kernels.image_counts,
    kernels.image_scores, kernels.truncate_feasible, kernels.eval_chunk_cols, kernels.ipa_eval_cols,
    kernels.late_scores_cols,
)
_PLAIN_FNS = _Fns(
    plain.build_dom, plain.eval_chunk, plain.ipa_eval, plain.select_host,
    plain.resolve_commit, plain.conflict_pairs, plain.node_filters,
    plain.spread_filter, plain.late_scores, plain.vol_filter, plain.image_counts,
    plain.image_scores, plain.truncate_feasible, plain.eval_chunk_cols, plain.ipa_eval_cols,
    plain.late_scores_cols,
)
# Scorers that normalize over the final feasible set, added by late_scores.
_LATE = (NA, TT, PTS)


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _pass_ops(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None,
):
    """(PassContext, active filters in fail-bit order, active (scorer,
    weight) pairs) of one pass."""
    ops = [opcommon.get(n) for n in profile.filters if active is None or n in active]
    scored = [(opcommon.get(n), w) for n, w in profile.scorers if active is None or n in active]
    static: dict = {}
    for op in {o.name: o for o in ops + [o for o, _ in scored]}.values():
        if op.static is not None:
            static.update(op.static(profile, schema, builder_res_col))
    ctx = opcommon.PassContext(profile=profile, schema=schema, static=static)
    filters = tuple(op.name for op in ops if op.filter is not None)
    scorers = tuple((op.name, w) for op, w in scored if op.score is not None)
    return ctx, filters, scorers


def eval_spec(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
) -> kernels.EvalSpec:
    """What eval_chunk evaluates for one (profile, schema, active-op-set):
    the active filters in fail-bit order up to InterPodAffinity (all of
    them when it does not filter), the active (scorer, weight) pairs and
    the ops' static config — all but InterPodAffinity, which ipa_eval
    applies on top (ipa_spec), the filters after it (after_spec) and the
    scores late_scores adds (late_spec).  NodeAffinity's,
    TaintToleration's and PodTopologySpread's filters, and the four volume
    ops', are read from precomputed planes (plain.PLANE_BITS)."""
    ctx, filters, scorers = _pass_ops(profile, schema, builder_res_col, active)
    return kernels.EvalSpec(
        ctx=ctx,
        filters=filters[: filters.index(IPA)] if IPA in filters else filters,
        scorers=tuple((n, w) for n, w in scorers if n != IPA and n not in _LATE),
    )


def after_spec(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
) -> kernels.EvalSpec | None:
    """The filters a profile orders after an active InterPodAffinity filter
    (the default profile's DynamicResources), for a second eval_chunk
    launch on the nodes ipa_eval's filter leaves, their fail bits from the
    one after InterPodAffinity's on; or None when no filter follows it
    (then one eval_chunk launch evaluates every filter)."""
    ctx, filters, _scorers = _pass_ops(profile, schema, builder_res_col, active)
    if IPA not in filters or filters[-1] == IPA:
        return None
    at = filters.index(IPA) + 1
    return kernels.EvalSpec(ctx=ctx, filters=filters[at:], scorers=(), bit0=at)


def late_spec(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
) -> kernels.LateSpec | None:
    """What late_scores adds for one pass (the weights of NodeAffinity,
    TaintToleration and PodTopologySpread), or None when none of them
    scores."""
    ctx, _filters, scorers = _pass_ops(profile, schema, builder_res_col, active)
    weights = dict(scorers)
    if not any(n in weights for n in _LATE):
        return None
    return kernels.LateSpec(ctx=ctx, na_weight=weights.get(NA, 0),
                            taint_weight=weights.get(TT, 0), spread_weight=weights.get(PTS, 0))


def ipa_spec(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
) -> kernels.IpaSpec | None:
    """What ipa_eval applies for one pass (its fail bit and score weight),
    or None when InterPodAffinity is inactive."""
    ctx, filters, scorers = _pass_ops(profile, schema, builder_res_col, active)
    weights = dict(scorers)
    if IPA not in filters and IPA not in weights:
        return None
    return kernels.IpaSpec(ctx=ctx, filters=filters, weight=weights.get(IPA, 0))


class _Plan(NamedTuple):
    """What one pass launches for a (profile, schema, active-op-set): the
    specs of eval_chunk, of its launch after InterPodAffinity, of ipa_eval
    and of late_scores, the kernels (or their plain versions) and which
    per-pass planes and per-chunk filters run."""

    spec: kernels.EvalSpec
    after: kernels.EvalSpec | None
    ipa0: kernels.IpaSpec | None
    late: kernels.LateSpec | None
    filters: tuple[str, ...]
    scorers: tuple[tuple[str, int], ...]
    effective: frozenset
    fns: _Fns
    do_il: bool
    need_nodes: bool
    spread_filters: bool
    do_vr: bool
    do_nvl: bool
    ipa_filters: bool


def _plan(profile: Profile, schema: Schema, builder_res_col: dict[str, int], active, _impl: str) -> _Plan:
    if _impl not in ("kernel", "plain"):
        raise ValueError(f"_impl must be 'kernel' or 'plain', not {_impl!r}")
    spec = eval_spec(profile, schema, builder_res_col, active)
    after = after_spec(profile, schema, builder_res_col, active)
    ipa0 = ipa_spec(profile, schema, builder_res_col, active)
    _ctx, filters, scorers = _pass_ops(profile, schema, builder_res_col, active)
    effective = frozenset(filters) | frozenset(n for n, _ in scorers)
    # node_filters runs when eval_chunk reads its bits (NodeAffinity,
    # TaintToleration, VolumeBinding or VolumeZone filters) or spread's
    # inclusion policies do; vol_filter when VolumeRestrictions or
    # NodeVolumeLimits filters.
    chain = spec.filters + (after.filters if after is not None else ())
    return _Plan(
        spec=spec, after=after, ipa0=ipa0, late=late_spec(profile, schema, builder_res_col, active),
        filters=filters, scorers=scorers, effective=effective,
        fns=_PLAIN_FNS if _impl == "plain" else _KERNEL_FNS,
        do_il=IL in dict(spec.scorers),
        need_nodes=bool(set(NODE_FILTER_OPS) & set(chain)) or PTS in effective,
        spread_filters=PTS in chain, do_vr=VR in chain, do_nvl=NVL in chain,
        ipa_filters=ipa0 is not None and IPA in ipa0.filters,
    )


def _setup(plan: _Plan, state: ClusterState, tb: dict, inv: dict, dom: DomTables | None):
    """The per-pass inputs of the chunk steps: the domain tables (``dom``,
    or built from the state), the pass's IpaSpec bound to them, the
    nominated-pod overlay and the per-batch planes.  NodeAffinity's and
    TaintToleration's filters read only node state that no commit changes,
    so one node_filters evaluation serves every chunk; ImageLocality reads
    only images and node validity, so one image plane of the whole batch
    does too."""
    dev = state.valid.device
    fns = plan.fns
    if dom is None:
        dom = build_dom(state, _to_device(inv["et_slot"], dev), _to_device(inv["et_host"], dev),
                        plan.spec.ctx.schema.DV, fns.dom)
    nom = None
    if "nom_req" in inv:
        nom = tuple(_to_device(inv[key], dev) for key in ("nom_req", "nom_cnt", "nom_prio"))
    # The ops read the domain tables through PassContext.dom, bound for
    # this pass (the tables are the same tensors the commit updates).
    ipa = None
    if plan.ipa0 is not None:
        ipa = dataclasses.replace(plan.ipa0, ctx=dataclasses.replace(plan.ipa0.ctx, dom=dom))
    node_bits = fns.nodes(state, tb, plan.spec.ctx) if plan.need_nodes else None
    il = fns.il(state, tb, fns.counts(state, int(inv["image_vocab"]))) if plan.do_il else None
    return dom, ipa, nom, node_bits, il


def _chunk_planes(plan: _Plan, state: ClusterState, pf: dict, node_bits, il) -> tuple:
    """The ``ext`` planes of one chunk: node_filters' rows, spread_filter's
    and vol_filter's masks (per chunk: the commits change their counts) and
    the image plane's rows."""
    fns = plan.fns
    spread_ok = fns.spread(state, pf, node_bits, plan.spec.ctx) if plan.spread_filters else None
    vol_bits = fns.vol(state, pf, plan.spec.ctx, plan.do_vr, plan.do_nvl) if plan.do_vr or plan.do_nvl else None
    return node_bits, spread_ok, vol_bits, il


def _evaluate(plan: _Plan, state: ClusterState, ipa, pf: dict, nom, node_bits, il, scan=None):
    """One chunk's filter chain and weighted scores (pass_.py:494-540), the
    part of a step that the batch pass and the eval pass share: eval_chunk,
    InterPodAffinity's filter, the filters after it, truncated mode's cut
    (``scan``: the scan order, the start, the node count and
    numFeasibleNodesToFind), InterPodAffinity's score and late_scores.
    Returns (feasible, total, fail_mask, pos, processed); ``total`` is 0 on
    infeasible nodes."""
    eval_fn, ipa_fn, late_fn, trunc_fn = plan.fns.eval, plan.fns.ipa, plan.fns.late, plan.fns.trunc
    ext = _chunk_planes(plan, state, pf, node_bits, il)
    feasible, total, fails = eval_fn(state, pf, plan.spec, nom, ext)
    pos = None
    if scan is None and plan.after is None:
        processed = torch.zeros_like(fails)
        if ipa is not None:
            ipa_fn(state, pf, feasible, total, fails, ipa)
    else:
        # Every filter in profile order — InterPodAffinity's, then the
        # filters after it on what it left — before the scores that
        # normalize over the feasible set (pass_.py:494-540); in
        # truncated mode the cut comes between them.
        if plan.ipa_filters:
            ipa_fn(state, pf, feasible, total, fails, ipa, plain.IPA_FILTER)
        if plan.after is not None:
            eval_fn(state, pf, plan.after, nom, ext, None, (feasible, total, fails))
        if scan is None:
            processed = torch.zeros_like(fails)
        else:
            order_pos, start, nvalid, limit = scan
            feasible, pos, processed = trunc_fn(feasible, state.valid, order_pos, start, pf["valid"], nvalid, limit)
        if ipa is not None and ipa.weight:
            ipa_fn(state, pf, feasible, total, fails, ipa, plain.IPA_SCORE)
    if plan.late is not None:
        late_fn(state, pf, feasible, total, node_bits, plan.late)
    return feasible, total, fails, pos, processed


def build_pass(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
    chunk: int = 1,
    carry_dom: bool = False,
    _impl: str = "kernel",
):
    """Build the batch pass for one (profile, schema, active-op-set, chunk).

    Returns run(state, batch, inv, seed_base) → (state, PassResult), where
    ``inv`` holds the batch invariants (et_slot, et_host), optionally the
    nominated-pod overlay (nom_req, nom_cnt, nom_prio) and, when
    ImageLocality scores, ``image_vocab`` (an int: the size of the image
    name vocabulary, which bounds the ids that image_counts counts).
    ``batch`` values may be numpy arrays or tensors.

    ``batch["step_offset"]`` (optional, (K,) i32): per-pod tie-break step
    offsets; absent, positions default to arange.  ``batch["uniform_all"]``
    (optional scalar): every pod is featurization-identical, which enables
    the all-fail shortcut.

    In truncated mode (percentage_of_nodes_to_score != 100, chunk 1 only)
    ``inv`` also holds ``order_pos`` ((N,) i32, cache.order_pos),
    ``scan_start``, a (1,) i64 tensor on the state's device that the pass
    advances in place, and ``scan_nodes``, the host's node count (an int,
    so the pass needs no device sync for it).

    ``carry_dom=True`` changes the signature to
    run(state, batch, inv, seed_base, dom_group, dom_et, dom_valid)
    → (state, PassResult, (group_dom, et_dom)): when ``dom_valid`` the
    aggregate rebuild is skipped and the carried tables are used (and
    updated in place).

    ``_impl="plain"`` runs the plain versions of the kernels; it exists
    only to compare the kernels with them."""
    truncated = profile.percentage_of_nodes_to_score != 100
    if truncated and chunk != 1:
        raise ValueError("truncated (parity) mode requires chunk_size=1")
    pct = profile.percentage_of_nodes_to_score or 0
    plan = _plan(profile, schema, builder_res_col, active, _impl)
    spec = plan.spec
    eval_fn, select_fn, commit_fn, pairs_fn = plan.fns.eval, plan.fns.select, plan.fns.commit, plan.fns.pairs
    c = chunk
    fuse_tail = chunk > 1 and plan.effective <= PINNED_SAFE_OPS
    seed_mul = ((profile.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF

    def step(state, dom, ipa, pf, steps, pairs, nom, node_bits, il, scan) -> PassResult:
        feasible, total, fails, pos, processed = _evaluate(plan, state, ipa, pf, nom, node_bits, il, scan)
        picks, bests, feas = select_fn(feasible, total, steps, seed_mul, pf.get("nominated_row"), pos)
        # No spread branch in the commit: spread reads group_counts, which
        # the base commit maintains (pass_.py:166-192).  The device, CSI and
        # host-port branches commit when the chunk carries their features.
        out = commit_fn(state, dom, pf, picks, pairs, c == 1)
        return PassResult(out, bests, feas, processed, fails)

    def _run(state, batch, inv, seed_base, dom_group=None, dom_et=None, dom_valid=None):
        dev = state.valid.device
        batch = dict(batch)
        uniform_all = batch.pop("uniform_all", None)
        step_off = batch.pop("step_offset", None)
        tb = {key: _to_device(v, dev) for key, v in batch.items()}
        k = tb["valid"].shape[0]
        if k % c:
            raise ValueError(f"batch size {k} not a multiple of chunk {c}")
        offs = (
            torch.arange(k, dtype=torch.int64, device=dev)
            if step_off is None
            else _to_device(step_off, dev).to(torch.int64)
        )
        steps = (int(seed_base) + offs) & 0xFFFFFFFF
        dom = None
        if carry_dom and bool(dom_valid):
            # The previous pass maintained these tables; skip the rebuild.
            dom = DomTables(dom_group, dom_et, _to_device(inv["et_slot"], dev), _to_device(inv["et_host"], dev))
        dom, ipa, nom, node_bits, il = _setup(plan, state, tb, inv, dom)
        nchunks = k // c
        pairs = _conflict_pairs(tb, nchunks, c, pairs_fn)
        # Truncated mode's scan order and its start, carried on the device
        # from step to step (pass_.py:564-569, 626-628), and the node count
        # and numFeasibleNodesToFind, constants of the pass (:422-432), from
        # the host's node count (no sync).
        scan = None
        if truncated:
            scan = (_to_device(inv["order_pos"], dev), inv["scan_start"],
                    *plain.scan_counts(int(inv["scan_nodes"]), pct))

        def chunk_of(i: int, src: dict) -> dict:
            return {key: v[i * c : (i + 1) * c] for key, v in src.items()}

        def rows_of(plane, i: int):
            return None if plane is None else plane[i * c : (i + 1) * c]

        def run_chunks(src: dict, idx) -> list[PassResult]:
            return [
                step(state, dom, ipa, chunk_of(i, src), steps[i * c : (i + 1) * c], pairs[i], nom,
                     rows_of(node_bits, i), rows_of(il, i), scan)
                for i in idx
            ]

        def cat(results: list[PassResult]) -> PassResult:
            return PassResult(*(torch.cat(parts) for parts in zip(*results)))

        out = None
        if fuse_tail and uniform_all is not None and bool(uniform_all):
            # Template-batch all-fail shortcut (pass_.py:636-667): every pod
            # is featurization-identical, so if the first one is feasible
            # nowhere, every pod fails identically and nothing commits.
            pf0 = {key: v[:1] for key, v in tb.items()}
            ext0 = (None if node_bits is None else node_bits[:1], None, None,
                    None if il is None else il[:1])
            feas0_mask, total0, fail0 = eval_fn(state, pf0, spec, nom, ext0)
            _p0, _b0, feas0 = select_fn(feas0_mask, total0, steps[:1], seed_mul, pf0.get("nominated_row"), None)
            if int(feas0[0]) == 0 and bool(tb["valid"][0]):
                valid = tb["valid"]
                out = PassResult(
                    picks=torch.full((k,), -1, dtype=torch.int32, device=dev),
                    scores=torch.zeros(k, dtype=torch.int64, device=dev),
                    feasible_counts=torch.zeros(k, dtype=torch.int32, device=dev),
                    processed=torch.zeros(k, dtype=torch.int32, device=dev),
                    fail_masks=torch.where(valid, fail0[0], 0).to(torch.int32),
                )
        if out is None:
            out = cat(run_chunks(tb, range(nchunks)))
            if fuse_tail:
                # Fused strict tail (pass_.py:673-732): chunk-deferred pods
                # re-run against the committed state with their own step
                # seeds.  One fetch finds the chunks that hold deferred rows;
                # only those re-run (the lax.cond skip at :702).
                deferred1 = out.picks == -2
                todo = torch.nonzero(deferred1.view(nchunks, c).any(dim=1)).flatten().tolist()
                if todo:
                    tb2 = dict(tb)
                    tb2["valid"] = tb["valid"] & deferred1
                    for i, r in zip(todo, run_chunks(tb2, todo)):
                        sl = slice(i * c, (i + 1) * c)
                        d = deferred1[sl]
                        for mine, theirs in zip(out, r):
                            if mine is not out.processed:
                                mine[sl] = torch.where(d, theirs, mine[sl])
        return state, out, (dom.group_dom, dom.et_dom)

    if carry_dom:
        return _run

    def run(state: ClusterState, batch: dict, inv: dict, seed_base):
        st, out, _dom = _run(state, batch, inv, seed_base)
        return st, out

    return run


def _one_pod(pf: dict, dev) -> dict:
    """A featurized one-pod batch (leading axis 1) on the device, valid."""
    tb = {key: _to_device(v, dev) for key, v in pf.items() if key not in ("uniform_all", "step_offset", "pin_row")}
    tb["valid"] = torch.ones(1, dtype=torch.bool, device=dev)
    if "nominated_row" in tb:
        tb["nominated_row"] = tb["nominated_row"].reshape(1).to(torch.int32)
    return tb


def build_eval_pass(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
    _impl: str = "kernel",
):
    """The eval-only one-pod pass (pass_.py:747-796): the filter chain and
    the weighted scores with NO commit, for the extender path, whose chain
    filters and prioritizes on the host between this pass and selectHost.

    Returns run(state, pf, inv) → (feasible (N,) bool, total (N,) i64).
    ``pf`` is the pod's featurized batch of one (numpy arrays or tensors
    with a leading axis of 1, ``nominated_row`` its own nomination's row or
    -1); ``inv`` as build_pass takes it.  The launches are a batch pass's at
    chunk 1 — build_dom, the per-batch planes, eval_chunk, InterPodAffinity's
    filter and score, the filters after it, late_scores — without
    select_host, resolve_commit or truncation (the JAX eval pass never
    truncates).  ``total`` is 0 on infeasible nodes where the JAX pass keeps
    the raw weighted sum: every caller reads feasible rows only (ROADMAP
    §3, a designed divergence)."""
    plan = _plan(dataclasses.replace(profile, percentage_of_nodes_to_score=100), schema, builder_res_col, active,
                 _impl)

    def run(state: ClusterState, pf: dict, inv: dict):
        tb = _one_pod(pf, state.valid.device)
        _dom, ipa, nom, node_bits, il = _setup(plan, state, tb, inv, None)
        feasible, total, _fails, _pos, _processed = _evaluate(plan, state, ipa, tb, nom, node_bits, il)
        return feasible[0], total[0]

    return run


def build_attribution_pass(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
    _impl: str = "kernel",
):
    """The attribution variant of the eval pass, for decision provenance
    (pass_.py:812-886): the same ops, every intermediate column returned.

    Returns run(state, pf, inv) → (ok_cols (F, N) bool, each filter's own
    verdict on every node in filter_op_names order; feasible (N,) bool,
    their conjunction over the valid nodes; score_cols (S, N) i64, each
    scorer's column before its weight, normalized over the final feasible
    set, in score_op_names order; total (N,) i64, the weighted sum).  Every
    entry equals the JAX pass's on every node, infeasible ones included.

    Launches: the per-batch planes, spread_filter and vol_filter, then the
    columns modes — eval_chunk's (every filter but InterPodAffinity in one
    launch, its verdict bits, the conjunction and its scorers' columns),
    ipa_eval's filter (its verdict, ANDed into the conjunction) and score
    over the final feasible set, and late_scores' (NodeAffinity's,
    TaintToleration's and PodTopologySpread's columns).  Each adds its
    weighted columns into ``total``.  A read path: one launch of each per
    explained pod; scheduling never builds this pass."""
    plan = _plan(dataclasses.replace(profile, percentage_of_nodes_to_score=100), schema, builder_res_col, active,
                 _impl)
    eval_cols, ipa_cols, late_cols = plan.fns.eval_cols, plan.fns.ipa_cols, plan.fns.late_cols
    names = filter_op_names(profile, active)
    scored = score_op_names(profile, active)
    # eval_chunk's columns launch: every filter but InterPodAffinity, in
    # profile order (the bits name them), and its own scorers.
    spec = dataclasses.replace(plan.spec, filters=tuple(n for n in names if n != IPA), bit0=0,
                               _device_config={})
    late = plan.late

    def run(state: ClusterState, pf: dict, inv: dict):
        tb = _one_pod(pf, state.valid.device)
        _dom, ipa, nom, node_bits, il = _setup(plan, state, tb, inv, None)
        ext = _chunk_planes(plan, state, tb, node_bits, il)
        bits, feasible, cols, total = eval_cols(state, tb, spec, nom, ext)
        ok_ipa = col_ipa = None
        if IPA in names:
            ok_ipa = ipa_cols(state, tb, feasible, total, ipa, plain.IPA_FILTER)
        if ipa is not None and ipa.weight:
            col_ipa = ipa_cols(state, tb, feasible, total, ipa, plain.IPA_SCORE)
        late_c = late_cols(state, tb, feasible, total, node_bits, late) if late is not None else None
        rows, b = [], 0
        for name in names:
            if name == IPA:
                rows.append(ok_ipa[0])
            else:
                rows.append(((bits[0] >> b) & 1).to(torch.bool))
                b += 1
        own = dict(zip((n for n, _ in spec.scorers), cols[:, 0]))
        score_rows = []
        for name, _w in scored:
            if name == IPA:
                score_rows.append(col_ipa[0])
            elif name in _LATE:
                score_rows.append(late_c[_LATE.index(name), 0])
            else:
                score_rows.append(own[name])
        n = state.valid.shape[0]
        dev = state.valid.device
        ok_stack = torch.stack(rows) if rows else torch.zeros((0, n), dtype=torch.bool, device=dev)
        sc_stack = torch.stack(score_rows) if score_rows else torch.zeros((0, n), dtype=torch.int64, device=dev)
        return ok_stack, feasible[0], sc_stack, total[0]

    return run


def build_pinned_pass(
    profile: Profile,
    schema: Schema,
    builder_res_col: dict[str, int],
    active: frozenset[str] | None = None,
    _impl: str = "kernel",
):
    """The pinned-batch pass (pass_.py:901-1047): every pod arrives resolved
    to ONE candidate row (``batch["pin_row"]``, -1 when the pin names no
    live node) — its NodeName/metadata.name pin or its live nomination.
    The whole batch runs in one launch of each kernel: node_filters,
    eval_chunk (and late_scores when NodeAffinity or TaintToleration
    scores) in pinned mode evaluate every pod on its own row alone —
    filter verdicts, fail bits and scores normalized over that single
    node, as the JAX pass's vmapped own-row evaluation computes them (a
    pod whose pin names no node is evaluated on row 0 and then held
    infeasible, as there;
    ImageLocality's score comes from image_scores at the pins, its spread
    over the pinned row alone, as the JAX pass's one-row state slice
    computes it);
    pinned_fit applies the same-row rule in closed form (a feasible pod
    places when the inclusive prefix of its feasible mates' requests fits
    the row's free capacity before the batch, and defers otherwise); a
    strict resolve_commit commits the placed pods.  Eligibility (every
    pod pinned, active ⊆ PINNED_SAFE_OPS) is the scheduler's job.

    Returns run(state, batch, inv) → (state, PassResult); ``batch`` values
    are numpy arrays or device tensors, ``pin_row`` and ``nominated_row``
    numpy (the host reads them).  The state is committed in place."""
    if _impl not in ("kernel", "plain"):
        raise ValueError(f"_impl must be 'kernel' or 'plain', not {_impl!r}")
    spec = eval_spec(profile, schema, builder_res_col, active)
    late = late_spec(profile, schema, builder_res_col, active)
    _ctx, filters, scorers = _pass_ops(profile, schema, builder_res_col, active)
    effective = frozenset(filters) | frozenset(n for n, _ in scorers)
    if not effective <= PINNED_SAFE_OPS:
        raise ValueError(f"pinned pass: {sorted(effective - PINNED_SAFE_OPS)} read more than the own row")
    fns = _PLAIN_FNS if _impl == "plain" else _KERNEL_FNS
    eval_fn, commit_fn, nodes_fn, late_fn, il_fn = fns.eval, fns.commit, fns.nodes, fns.late, fns.il
    fit_fn = plain.pinned_fit if _impl == "plain" else kernels.pinned_fit
    do_il = IL in dict(spec.scorers)
    need_nodes = bool(set(NODE_FILTER_OPS) & set(spec.filters)) or late is not None

    def run(state: ClusterState, batch: dict, inv: dict):
        dev = state.valid.device
        rows = np.asarray(batch["pin_row"], np.int32)
        safe = np.maximum(rows, 0).astype(np.int32)
        tb = {
            key: _to_device(v, dev)
            for key, v in batch.items()
            if key not in ("uniform_all", "step_offset", "pin_row", "nominated_row")
        }
        # The fit filter's nominated self-exclusion applies on the pinned
        # row when the nomination is the pin (pass_.py:972-976).
        nomrow = np.asarray(batch["nominated_row"], np.int32)
        tb["nominated_row"] = _to_device(np.where(nomrow == rows, safe, -1).astype(np.int32), dev)
        pin, pin_row = _to_device(safe, dev), _to_device(rows, dev)
        nom = None
        if "nom_req" in inv:
            nom = tuple(_to_device(inv[key], dev) for key in ("nom_req", "nom_cnt", "nom_prio"))
        node_bits = nodes_fn(state, tb, spec.ctx, pin) if need_nodes else None
        il = il_fn(state, tb, None, pin) if do_il else None
        own_ok, total, fails = eval_fn(state, tb, spec, nom, (node_bits, None, None, il), pin)
        if late is not None:
            late_fn(state, tb, own_ok, total, node_bits, late, pin)
        picks, feasible = fit_fn(own_ok[:, 0], pin_row, tb["valid"], tb["req"], state)
        # One strict commit of the placed pods per 1024 lanes; the domain
        # tables it also updates are scratch (the scheduler drops its
        # carried tables after a pinned batch).
        tk, dv = state.topo_vals.shape[1], schema.DV
        scratch = DomTables(
            torch.zeros((state.group_counts.shape[0], tk, dv), dtype=torch.float32, device=dev),
            torch.zeros((state.et_counts.shape[0], dv), dtype=torch.float32, device=dev),
            _to_device(inv["et_slot"], dev), _to_device(inv["et_host"], dev),
        )
        k = rows.shape[0]
        for lo in range(0, k, kernels.MAX_CHUNK):
            sl = slice(lo, min(lo + kernels.MAX_CHUNK, k))
            commit_fn(state, scratch, {key: v[sl] for key, v in tb.items()}, picks[sl], None, True)
        return state, PassResult(
            picks=picks,
            scores=total[:, 0],
            feasible_counts=feasible,
            processed=torch.zeros(k, dtype=torch.int32, device=dev),
            fail_masks=fails,
        )

    return run


class PassCache:
    """Built-pass cache keyed by (profile, schema, resource columns,
    batch-active op set, and the kind of pass: chunk, carry_dom and
    implementation for the batch pass; pinned, eval or attribution)."""

    def __init__(self, _impl: str = "kernel") -> None:
        self._impl = _impl
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self._cache)

    def _memo(self, profile: Profile, schema: Schema, res_col: dict[str, int], active, kind: tuple, build):
        key = (profile, schema, tuple(sorted(res_col.items())), active, *kind)
        fn = self._cache.get(key)
        if fn is None:
            fn = build()
            self._cache[key] = fn
        return fn

    def get(
        self,
        profile: Profile,
        schema: Schema,
        res_col: dict[str, int],
        active: frozenset[str] | None = None,
        chunk: int = 1,
        carry_dom: bool = False,
    ):
        return self._memo(profile, schema, res_col, active, (chunk, carry_dom), lambda: build_pass(
            profile, schema, res_col, active, chunk, carry_dom, _impl=self._impl))

    def get_pinned(
        self,
        profile: Profile,
        schema: Schema,
        res_col: dict[str, int],
        active: frozenset[str] | None = None,
    ):
        return self._memo(profile, schema, res_col, active, ("pinned",), lambda: build_pinned_pass(
            profile, schema, res_col, active, _impl=self._impl))

    def get_eval(self, profile: Profile, schema: Schema, res_col: dict[str, int], active=None):
        """The eval-only pass (build_eval_pass), built on first use."""
        return self._memo(profile, schema, res_col, active, ("eval",), lambda: build_eval_pass(
            profile, schema, res_col, active, _impl=self._impl))

    def get_attribution(self, profile: Profile, schema: Schema, res_col: dict[str, int], active=None):
        """The attribution pass (build_attribution_pass), built on first use:
        only explain_pod asks for one."""
        return self._memo(profile, schema, res_col, active, ("attribution",), lambda: build_attribution_pass(
            profile, schema, res_col, active, _impl=self._impl))
