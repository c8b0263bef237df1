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
                  eval_chunk's result (only when the op is active)
  late_scores     the NodeAffinity, TaintToleration and PodTopologySpread
                  scores, which normalize over the final feasible set
  select_host     one pick per pod (hashed tie-break, nominated fast path)
  resolve_commit  chunk deferral + exact cumulative fit, then the commit

and, once per batch before the loop, ``build_dom`` (the per-domain tables,
unless carried from the previous batch), ``node_filters`` (NodeAffinity's,
TaintToleration's, VolumeBinding's and VolumeZone's filters of every pod of
the batch, when one of them filters or spread's inclusion policies read
them) and, when the batch carries affinity, spread or volume-id features,
``conflict_pairs`` (the chunk-mate conflict table).  ``resolve_commit``
also commits device uses and CSI attachments and defers attach-limited
pods that share a node with an earlier limited mate.

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

Truncated (parity) mode, percentage_of_nodes_to_score != 100, is a later
slice and raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..framework.config import Profile
from ..kernels import plain
from ..kernels.plain import IPA, NA, NODE_FILTER_OPS, NVL, PTS, TT, VR
from ..ops import common as opcommon
from ..snapshot import ClusterState, Schema


class PassResult(NamedTuple):
    picks: torch.Tensor  # (K,) i32 — chosen node row, -1 unschedulable, -2 deferred
    scores: torch.Tensor  # (K,) i64 — winning node's total score
    feasible_counts: torch.Tensor  # (K,) i32 — nodes passing all filters
    processed: torch.Tensor  # (K,) i32 — truncated mode only; zeros here
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
    decision (pass_.py:266)?  Pairs come from the hard reads of inter-pod
    affinity (required (anti-)affinity group masks, matched existing
    anti-affinity terms against own-term writes) and of topology spread
    (DoNotSchedule group masks), against each pod's label-group write, and
    from the volumes: a shared device or CSI volume id, or two claims that
    race at PreBind (``pairs_fn``, the conflict_pairs kernel or its plain
    version).  A batch with none of these features (density) keeps the
    all-false table and launches nothing.  Host-port keys and DRA ids
    belong to unported ops: a batch that carries such a feature raises, so
    the slice that ports the op must port its pairs too."""
    found = sorted(_PAIR_FEATURES.intersection(pf))
    if found:
        raise NotImplementedError(f"conflict pairs from {found} are not yet ported")
    if c > 1 and any(key in pf for key in _PAIR_SOURCES):
        return pairs_fn(pf, nchunks, c)
    return torch.zeros((nchunks, c, c), dtype=torch.bool, device=pf["valid"].device)


# Batch features of unported ops from which the JAX pass derives conflict
# pairs.
_PAIR_FEATURES = frozenset({"port_keys", "dra_claim_ids", "dra_claim_unalloc"})
# Features any of which makes the conflict table non-trivial.
_PAIR_SOURCES = ("ipa_ra_allmask", "tps_h_groups", "vol_dev_ids", "vol_csi_ids", "vol_unbound")


# Ops whose filter/score read only node-axis state (no domain tables, no
# cross-pod conflict classes) — the JAX package's PINNED_SAFE_OPS
# (pass_.py:891), which gates the fused strict tail.
PINNED_SAFE_OPS = frozenset({
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "ImageLocality",
    "ThroughputAware", "LearnedScorer",
})

_KERNEL_FNS = (
    kernels.build_dom, kernels.eval_chunk, kernels.ipa_eval, kernels.select_host,
    kernels.resolve_commit, kernels.conflict_pairs, kernels.node_filters,
    kernels.spread_filter, kernels.late_scores, kernels.vol_filter,
)
_PLAIN_FNS = (
    plain.build_dom, plain.eval_chunk, plain.ipa_eval, plain.select_host,
    plain.resolve_commit, plain.conflict_pairs, plain.node_filters,
    plain.spread_filter, plain.late_scores, plain.vol_filter,
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
    weight) pairs) of one pass.  An active op that is not yet ported
    raises."""
    ops = [opcommon.get(n) for n in profile.filters if active is None or n in active]
    scored = [(opcommon.get(n), w) for n, w in profile.scorers if active is None or n in active]
    for op in ops + [o for o, _ in scored]:
        if op.unported:
            raise NotImplementedError(f"{op.name} is not yet ported")
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
    the active filters in fail-bit order, the active (scorer, weight) pairs
    and the ops' static config — all but InterPodAffinity, which ipa_eval
    applies on top (ipa_spec), and the scores late_scores adds
    (late_spec).  NodeAffinity's, TaintToleration's and
    PodTopologySpread's filters, and the four volume ops', are read from
    precomputed planes (plain.PLANE_BITS)."""
    ctx, filters, scorers = _pass_ops(profile, schema, builder_res_col, active)
    return kernels.EvalSpec(
        ctx=ctx,
        filters=tuple(n for n in filters if n != IPA),
        scorers=tuple((n, w) for n, w in scorers if n != IPA and n not in _LATE),
    )


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
    ``inv`` holds the batch invariants (et_slot, et_host) and optionally the
    nominated-pod overlay (nom_req, nom_cnt, nom_prio).  ``batch`` values
    may be numpy arrays or tensors.

    ``batch["step_offset"]`` (optional, (K,) i32): per-pod tie-break step
    offsets; absent, positions default to arange.  ``batch["uniform_all"]``
    (optional scalar): every pod is featurization-identical, which enables
    the all-fail shortcut.

    ``carry_dom=True`` changes the signature to
    run(state, batch, inv, seed_base, dom_group, dom_et, dom_valid)
    → (state, PassResult, (group_dom, et_dom)): when ``dom_valid`` the
    aggregate rebuild is skipped and the carried tables are used (and
    updated in place).

    ``_impl="plain"`` runs the plain versions of the kernels; it exists
    only to compare the kernels with them."""
    if profile.percentage_of_nodes_to_score != 100:
        raise NotImplementedError("truncated (parity) mode is not yet ported")
    if _impl not in ("kernel", "plain"):
        raise ValueError(f"_impl must be 'kernel' or 'plain', not {_impl!r}")
    spec = eval_spec(profile, schema, builder_res_col, active)
    ipa0 = ipa_spec(profile, schema, builder_res_col, active)
    late = late_spec(profile, schema, builder_res_col, active)
    _ctx, filters, scorers = _pass_ops(profile, schema, builder_res_col, active)
    effective = frozenset(filters) | frozenset(n for n, _ in scorers)
    (dom_fn, eval_fn, ipa_fn, select_fn, commit_fn, pairs_fn, nodes_fn, spread_fn,
     late_fn, vol_fn) = _PLAIN_FNS if _impl == "plain" else _KERNEL_FNS
    # node_filters runs when eval_chunk reads its bits (NodeAffinity,
    # TaintToleration, VolumeBinding or VolumeZone filters) or spread's
    # inclusion policies do; vol_filter when VolumeRestrictions or
    # NodeVolumeLimits filters.
    spread_filters = PTS in spec.filters
    need_nodes = bool(set(NODE_FILTER_OPS) & set(spec.filters)) or PTS in effective
    do_vr, do_nvl = VR in spec.filters, NVL in spec.filters
    c = chunk
    fuse_tail = chunk > 1 and effective <= PINNED_SAFE_OPS
    seed_mul = ((profile.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF

    def step(state, dom, ipa, pf, steps, pairs, nom, node_bits) -> PassResult:
        spread_ok = spread_fn(state, pf, node_bits, spec.ctx) if spread_filters else None
        vol_bits = vol_fn(state, pf, spec.ctx, do_vr, do_nvl) if do_vr or do_nvl else None
        feasible, total, fails = eval_fn(state, pf, spec, nom, (node_bits, spread_ok, vol_bits))
        if ipa is not None:
            ipa_fn(state, pf, feasible, total, fails, ipa)
        if late is not None:
            late_fn(state, pf, feasible, total, node_bits, late)
        picks, bests, feas = select_fn(feasible, total, steps, seed_mul, pf.get("nominated_row"))
        # No spread branch in the commit: spread reads group_counts, which
        # the base commit maintains (pass_.py:166-192).  The device and CSI
        # branches commit when the chunk carries their features.
        out = commit_fn(state, dom, pf, picks, pairs, c == 1)
        return PassResult(out, bests, feas, torch.zeros_like(feas), fails)

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
        et_slot = _to_device(inv["et_slot"], dev)
        et_host = _to_device(inv["et_host"], dev)
        if carry_dom and bool(dom_valid):
            # The previous pass maintained these tables; skip the rebuild.
            dom = DomTables(dom_group, dom_et, et_slot, et_host)
        else:
            dom = build_dom(state, et_slot, et_host, schema.DV, dom_fn)
        nom = None
        if "nom_req" in inv:
            nom = tuple(_to_device(inv[key], dev) for key in ("nom_req", "nom_cnt", "nom_prio"))
        # The ops read the domain tables through PassContext.dom, bound for
        # this pass (the tables are the same tensors the commit updates).
        ipa = None
        if ipa0 is not None:
            ipa = dataclasses.replace(ipa0, ctx=dataclasses.replace(ipa0.ctx, dom=dom))
        nchunks = k // c
        pairs = _conflict_pairs(tb, nchunks, c, pairs_fn)
        # NodeAffinity's and TaintToleration's filters read only node state
        # that no commit changes: one evaluation serves every chunk.
        node_bits = nodes_fn(state, tb, spec.ctx) if need_nodes else None

        def chunk_of(i: int, src: dict) -> dict:
            return {key: v[i * c : (i + 1) * c] for key, v in src.items()}

        def run_chunks(src: dict, idx) -> list[PassResult]:
            return [
                step(state, dom, ipa, chunk_of(i, src), steps[i * c : (i + 1) * c], pairs[i], nom,
                     None if node_bits is None else node_bits[i * c : (i + 1) * c])
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
            ext0 = (None if node_bits is None else node_bits[:1], None)
            feas0_mask, total0, fail0 = eval_fn(state, pf0, spec, nom, ext0)
            _p0, _b0, feas0 = select_fn(feas0_mask, total0, steps[:1], seed_mul, pf0.get("nominated_row"))
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
    The whole batch runs in one launch of each kernel: eval_chunk (and
    late_scores when NodeAffinity or TaintToleration scores) in pinned
    mode evaluates every pod on its own row alone — filter verdicts, fail
    bits and scores normalized over that single node, as the JAX pass's
    vmapped own-row evaluation computes them (a pod whose pin names no
    node is evaluated on row 0 and then held infeasible, as there);
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
    (_dom_fn, eval_fn, _ipa_fn, _select_fn, commit_fn, _pairs_fn, nodes_fn, _spread_fn,
     late_fn, _vol_fn) = _PLAIN_FNS if _impl == "plain" else _KERNEL_FNS
    fit_fn = plain.pinned_fit if _impl == "plain" else kernels.pinned_fit
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
        node_bits = nodes_fn(state, tb, spec.ctx) if need_nodes else None
        own_ok, total, fails = eval_fn(state, tb, spec, nom, (node_bits, None), pin)
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
    batch-active op set, chunk, carry_dom, implementation)."""

    def __init__(self, _impl: str = "kernel") -> None:
        self._impl = _impl
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self._cache)

    def get(
        self,
        profile: Profile,
        schema: Schema,
        res_col: dict[str, int],
        active: frozenset[str] | None = None,
        chunk: int = 1,
        carry_dom: bool = False,
    ):
        key = (profile, schema, tuple(sorted(res_col.items())), active, chunk, carry_dom)
        fn = self._cache.get(key)
        if fn is None:
            fn = build_pass(profile, schema, res_col, active, chunk, carry_dom, _impl=self._impl)
            self._cache[key] = fn
        return fn

    def get_pinned(
        self,
        profile: Profile,
        schema: Schema,
        res_col: dict[str, int],
        active: frozenset[str] | None = None,
    ):
        key = (profile, schema, tuple(sorted(res_col.items())), active, "pinned")
        fn = self._cache.get(key)
        if fn is None:
            fn = build_pinned_pass(profile, schema, res_col, active, _impl=self._impl)
            self._cache[key] = fn
        return fn
