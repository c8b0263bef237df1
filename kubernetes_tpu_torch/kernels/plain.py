"""Plain PyTorch versions of the batch-pass kernels.

Each function computes what its CUDA kernel computes, with the same
signature, and is the reference the kernel is held against on the card
(chip_smoke.py) and what runs for tensors on the CPU.  They follow the JAX
batch pass (kubernetes_tpu/engine/pass_.py) operation by operation.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from ..cache import NO_POS
from ..ops import common as opcommon
from ..ops import dynamicresources as dra_op
from ..ops import interpodaffinity as ipa_op
from ..ops import nodeports as ports_op
from ..ops import nodeaffinity as na_op
from ..ops import podtopologyspread as spread_op
from ..ops import tainttoleration as taint_op
from ..ops import volumes as vol_op
from ..ops.helpers import make_topo_onehot
from ..ops.imagelocality import image_counts, image_scores  # noqa: F401  (the image_locality.cu pair)
# The plain versions of eval_chunk's RequestedToCapacityRatio (NodeResourcesFit's
# score with that strategy), throughput and learned score terms, which
# eval_chunk below reaches through the ops' score functions.
from ..ops.learned import score_fn as learned_score  # noqa: F401
from ..ops.noderesources import score_fn as fit_score  # noqa: F401
from ..ops.throughput import score_fn as throughput_score  # noqa: F401
from ..ops.volumes import NVL, VB, VR, VZ

IPA = "InterPodAffinity"
NA, TT, PTS = "NodeAffinity", "TaintToleration", "PodTopologySpread"
IL = "ImageLocality"
TP, LS = "ThroughputAware", "LearnedScorer"
# Filters eval_chunk reads from a precomputed plane instead of evaluating,
# and where: NodeAffinity, TaintToleration, VolumeBinding and VolumeZone
# from node_filters' bits 0-3 (per batch), VolumeRestrictions and
# NodeVolumeLimits from vol_filter's bits 0-1 (per chunk),
# PodTopologySpread from spread_filter's mask (per chunk).
PLANE_BITS = {NA: ("node_bits", 0), TT: ("node_bits", 1), VB: ("node_bits", 2),
              VZ: ("node_bits", 3), VR: ("vol_bits", 0), NVL: ("vol_bits", 1),
              PTS: ("spread_ok", 0)}
EXT_FILTERS = tuple(PLANE_BITS)
NODE_FILTER_OPS = (NA, TT, VB, VZ)
# Pods per block of the plain node_filters (bounds its temporaries), and
# the elements a block's (pods, T, Q, N, LS) label match may hold; the node
# fields it reads (gathered at the pins in pinned mode).
_NODE_FILTER_BLOCK = 256
_NODE_FILTER_ELEMS = 2**28
_NODE_FILTER_FIELDS = ("label_key_ids", "label_pair_ids", "label_int_vals", "name_id", "taint_ids")

_MASK32 = 0xFFFFFFFF
NEG_SCORE = -(2**62)


def build_dom(state, et_slot, dv: int):
    """(group_dom (G, TK, DV) f32, et_dom (ET, DV) f32): the per-domain
    aggregate products (pass_.py:96-119) of the carrier counts with the
    topology one-hot.  Plain f32 products with TF32 off: the counts stay
    exact below 2^24."""
    onehot = make_topo_onehot(state.topo_vals, dv)
    group_dom = torch.einsum("gn,nkd->gkd", state.group_counts.to(torch.float32), onehot)
    et_f = state.et_counts.to(torch.float32)  # (ET, N)
    et_dom = torch.zeros((et_f.shape[0], dv), dtype=torch.float32, device=et_f.device)
    for k in range(state.topo_vals.shape[1]):
        sel = torch.where((et_slot == k)[:, None], et_f, 0.0)
        et_dom = et_dom + sel @ onehot[:, k, :]
    return group_dom.contiguous(), et_dom


def ext_planes(ext) -> dict:
    """The planes of an ``ext`` tuple (node_bits (C, N) u8, spread_ok (C, N)
    bool[, vol_bits (C, N) u8[, il_scores (C, N) u8]]) by name; any may be
    None when no filter or score reads it.  In pinned mode il_scores is
    (C, 1), each pod's score on its own node (image_scores with ``pin``)."""
    names = ("node_bits", "spread_ok", "vol_bits", "il_scores")
    ext = tuple(ext) if ext is not None else ()
    return {name: ext[i] if i < len(ext) else None for i, name in enumerate(names)}


def ext_filter(name: str, ext) -> torch.Tensor:
    """(C, N) bool result of an EXT_FILTERS op from its plane (PLANE_BITS)."""
    plane_name, bit = PLANE_BITS[name]
    plane = ext_planes(ext)[plane_name]
    if plane is None:
        raise ValueError(f"eval_chunk: {name} needs its precomputed plane")
    if plane_name == "spread_ok":
        return plane.to(torch.bool)
    return (plane & (1 << bit)) != 0


def pin_view(state, pf: dict, pin, nom=None, planes=()):
    """The own-node view of a pinned chunk: the state's node axis gathered
    at ``pin`` (node j of the view is pod j's pin), the nominated overlay
    likewise, the (C, 1) ``planes`` (each pod's bytes on its own node, as
    node_filters and image_scores give them with ``pin``) spread over the
    view's nodes to be read on the diagonal, ``nominated_row`` mapped onto
    the view (pod c's own node is node c), and the (C, C) diagonal that
    holds each pod to its own node.  A view's (C, C) results read on the
    diagonal are the pinned pass's own-row evaluation (pass_.py:951-985)."""
    from ..snapshot import ClusterState, _NODE_AXIS

    idx = pin.to(torch.int64)
    view = ClusterState(**{
        f.name: getattr(state, f.name).index_select(_NODE_AXIS[f.name], idx)
        for f in dataclasses.fields(state)
    })
    c = idx.shape[0]
    local = torch.arange(c, dtype=torch.int32, device=idx.device)
    pf = dict(pf)
    if "nominated_row" in pf:
        pf["nominated_row"] = torch.where(pf["nominated_row"] == pin, local, -1).to(torch.int32)
    nom = None if nom is None else tuple(x.index_select(0, idx) for x in nom)
    planes = tuple(None if p is None else p.expand(-1, c) for p in planes)
    return view, pf, nom, planes, torch.eye(c, dtype=torch.bool, device=idx.device)


def eval_chunk(state, pf: dict, spec, nom, ext=None, pin=None, into=None):
    """(feasible (C, N) bool, total (C, N) i64, fail_mask (C,) i32) of one
    chunk — eval_pod's filter chain and weighted score sum (pass_.py:494-539).
    The EXT_FILTERS ops' results come from ``ext`` (see ext_filter), and
    ImageLocality's raw score from its il_scores plane (image_scores).
    ``total`` is 0 on infeasible nodes (select_host never reads it there).
    With ``pin`` each pod is evaluated on its pinned node alone (see
    pin_view): (C, 1) outputs and that node's fail bits.  With ``into``
    (feasible, total, fail_mask of an earlier launch) the filters run on
    that feasible set only, with fail bits from ``spec.bit0`` on, the
    scores add to ``total``, and the three tensors are updated IN PLACE and
    returned."""
    planes = ext_planes(ext)
    il = planes.pop("il_scores")
    c = pf["req"].shape[0]
    own = None
    if pin is not None:  # the (C, 1) planes are read on the view's diagonal
        state, pf, nom, ext, own = pin_view(state, pf, pin, nom, tuple(planes.values()))
        if il is not None:
            il = il.expand(-1, c)
    ctx = dataclasses.replace(spec.ctx, nom=nom)
    n = state.valid.shape[0]
    feasible = state.valid[None, :].expand(c, n).clone()
    if own is not None:
        feasible &= own
    if into is not None:  # a filter range runs only where the earlier launch left nodes
        feasible &= into[0]
    fail = torch.zeros(c, dtype=torch.int32, device=feasible.device)
    for bit, name in enumerate(spec.filters, spec.bit0):
        if name in EXT_FILTERS:
            ok = ext_filter(name, ext)
        else:
            ok = opcommon.get(name).filter(state, pf, ctx)
        newly = feasible & ~ok
        fail = fail | torch.where(newly.any(dim=1), 1 << bit, 0).to(torch.int32)
        feasible = feasible & ok
    total = torch.zeros((c, n), dtype=torch.int64, device=feasible.device)
    for name, weight in spec.scorers:
        if name == IL:
            if il is None:
                raise ValueError(f"eval_chunk: {IL} needs its il_scores plane")
            total = total + il.to(torch.int64) * weight
        else:
            total = total + opcommon.get(name).score(state, pf, ctx, feasible) * weight
    if own is not None:
        feasible, total = feasible.diagonal()[:, None].clone(), total.diagonal()[:, None].clone()
    if into is not None:
        total = total + into[1]
    total = torch.where(feasible, total, 0)
    if into is not None:
        into[0].copy_(feasible)
        into[1].copy_(total)
        into[2].bitwise_or_(fail)
        return into
    return feasible, total, fail


def eval_chunk_cols(state, pf: dict, spec, nom, ext=None):
    """Columns mode of eval_chunk, for the attribution pass
    (pass_.py:812-886): (ok_bits (C, N) i32, bit b set where filter b's
    own verdict passes the node; feasible (C, N) bool, the valid nodes that
    pass every filter; cols (len(spec.scorers), C, N) i64, each scorer's
    column before its weight; total (C, N) i64, Σ weight × column).  Every
    output covers every node: no verdict is masked by the filters before
    it and no score by the feasible set (none of eval_chunk's scorers
    normalizes over it).  Planes as in eval_chunk."""
    planes = ext_planes(ext)
    il = planes.pop("il_scores")
    ctx = dataclasses.replace(spec.ctx, nom=nom)
    c, n = pf["req"].shape[0], state.valid.shape[0]
    dev = state.valid.device
    bits = torch.zeros((c, n), dtype=torch.int32, device=dev)
    feasible = state.valid[None, :].expand(c, n).clone()
    for b, name in enumerate(spec.filters):
        ok = ext_filter(name, ext) if name in EXT_FILTERS else opcommon.get(name).filter(state, pf, ctx)
        bits |= ok.to(torch.int32) << b
        feasible &= ok
    cols = torch.zeros((len(spec.scorers), c, n), dtype=torch.int64, device=dev)
    total = torch.zeros((c, n), dtype=torch.int64, device=dev)
    for k, (name, weight) in enumerate(spec.scorers):
        if name == IL:
            if il is None:
                raise ValueError(f"eval_chunk: {IL} needs its il_scores plane")
            cols[k] = il.to(torch.int64)
        else:
            cols[k] = opcommon.get(name).score(state, pf, ctx, feasible)
        total += cols[k] * weight
    return bits, feasible, cols, total


def ipa_bit(ipa) -> int:
    """InterPodAffinity's fail bit for an IpaSpec (its place in the
    profile's filter order), or -1 when the op only scores.  Filters
    ordered after it run in a second eval_chunk launch on what its filter
    leaves (engine/pass_.py)."""
    return ipa.filters.index(IPA) if IPA in ipa.filters else -1


# ipa_eval's phases: the filter, the score, or both in one launch.  Truncated
# mode runs the filter, truncates the feasible set, then runs the score over
# what is left (pass_.py:494-540).
IPA_FILTER, IPA_SCORE, IPA_BOTH = 1, 2, 3


def ipa_eval(state, pf: dict, feasible, total, fail, ipa, phase: int = IPA_BOTH):
    """InterPodAffinity on top of eval_chunk's (feasible, total, fail_mask),
    IN PLACE: the filter (ops/interpodaffinity.py filter_fn) sets the op's
    fail bit for nodes that passed every earlier filter and clears them
    from ``feasible``; the score adds weight × the normalized score on the
    final feasible set; ``total`` is 0 on every infeasible node.  ``phase``
    (IPA_FILTER, IPA_SCORE or IPA_BOTH) picks which of the two run.  The
    domain tables come from ``ipa.ctx.dom``.  Returns the three tensors."""
    bit = ipa_bit(ipa) if phase & IPA_FILTER else -1
    weight = ipa.weight if phase & IPA_SCORE else 0
    if bit >= 0:
        ok = ipa_op.filter_fn(state, pf, ipa.ctx)
        newly = (feasible & ~ok).any(dim=1)
        fail |= torch.where(newly, 1 << bit, 0).to(torch.int32)
        feasible &= ok
    if weight:
        total += ipa_op.score_fn(state, pf, ipa.ctx, feasible) * weight
    total.masked_fill_(~feasible, 0)
    return feasible, total, fail


def ipa_eval_cols(state, pf: dict, feasible, total, ipa, phase: int):
    """Columns mode of ipa_eval, for the attribution pass.  IPA_FILTER:
    InterPodAffinity's own verdict on every node, (C, N) bool, ANDed into
    ``feasible`` IN PLACE.  IPA_SCORE: its score column before its weight,
    normalized over ``feasible`` (0 off it, as the op gives it), (C, N)
    i64, with weight × column added into ``total`` IN PLACE.  Returns the
    verdict or the column."""
    if phase == IPA_FILTER:
        ok = ipa_op.filter_fn(state, pf, ipa.ctx)
        feasible &= ok
        return ok
    col = ipa_op.score_fn(state, pf, ipa.ctx, feasible)
    total += col * ipa.weight
    return col


def conflict_pairs(pf: dict, nchunks: int, c: int):
    """(nchunks, C, C) bool — _conflict_pairs (pass_.py:266-342) with
    gathers in place of the one-hot einsums: pairs[i, j] =
    reads_g[j, group[i]] ∨ ∃a hard_t[j, own[i, a]] ∨ (i and j share a
    device or CSI volume id, a host-port key or a DRA claim id) ∨ (both
    vol_unbound) ∨ (both have an unallocated DRA claim), where reads_g is
    InterPodAffinity's ipa_ra_allmask ∨ any(ipa_rs_groups) and spread's
    any(tps_h_groups) and hard_t = ipa_et_match ∧ ipa_et_anti (each part
    only when the batch carries its features), over the pods of one chunk,
    diagonal cleared."""
    dev = pf["valid"].device
    reads = None
    if "ipa_ra_allmask" in pf:
        reads = pf["ipa_ra_allmask"] | pf["ipa_rs_groups"].any(dim=1)
    if "tps_h_groups" in pf:
        spread = pf["tps_h_groups"].any(dim=1)
        reads = spread if reads is None else reads | spread
    pairs = torch.zeros((nchunks, c, c), dtype=torch.bool, device=dev)
    if reads is not None:
        g = reads.shape[1]
        reads = reads.view(nchunks, c, g)
        group = pf["group"].to(torch.int64).clamp(0, g - 1).view(nchunks, 1, c).expand(-1, c, -1)
        # reads.gather(...)[b, j, i] = reads[b, j, group[b, i]]
        pairs = reads.gather(2, group).transpose(1, 2)
    for key in ("vol_dev_ids", "vol_csi_ids", "port_keys", "dra_claim_ids"):
        if key in pf:
            ids = pf[key].view(nchunks, c, -1)
            ok = ids >= 0
            eq = (ids[:, :, None, :, None] == ids[:, None, :, None, :]) & (
                ok[:, :, None, :, None] & ok[:, None, :, None, :])
            pairs = pairs | eq.flatten(3).any(dim=3)
    if "vol_unbound" in pf:
        u = pf["vol_unbound"].view(nchunks, c)
        pairs = pairs | (u[:, :, None] & u[:, None, :])
    if "dra_claim_unalloc" in pf:
        need = pf["dra_claim_unalloc"].any(dim=1).view(nchunks, c)
        pairs = pairs | (need[:, :, None] & need[:, None, :])
    if "ipa_et_match" in pf:
        hard = (pf["ipa_et_match"] & pf["ipa_et_anti"]).view(nchunks, c, -1)
        et = hard.shape[2]
        own = pf["ipa_own_terms"].to(torch.int64)
        own = own.view(nchunks, c, own.shape[1])
        for a in range(own.shape[2]):
            ids = own[:, :, a]
            idx = ids.clamp(0, et - 1)[:, None, :].expand(-1, c, -1)
            hit = hard.gather(2, idx).transpose(1, 2) & ((ids >= 0) & (ids < et))[:, :, None]
            pairs = pairs | hit
    eye = torch.eye(c, dtype=torch.bool, device=dev)
    return (pairs & ~eye).contiguous()


def node_filters(state, pf: dict, ctx, pin=None):
    """(K, N) u8 per-batch node filters: bit 0 NodeAffinity's filter
    (nodeaffinity.py:285, with the profile's added affinity), bit 1
    TaintToleration's (tainttoleration.py:52), bit 2 VolumeBinding's
    (volumes.py:146), bit 3 VolumeZone's (volumes.py:191); a bit whose
    features the batch does not carry is 1.  They read only node state no
    commit changes, so one evaluation serves every chunk of the batch.
    With ``pin`` ((K,) i32 rows), (K, 1): each pod on its own row alone,
    through a view of the label and taint rows gathered at the pins (pod c
    against node c of the view), as the JAX pinned pass evaluates each pod
    on its one-row slice (pass_.py:941-993)."""
    k, n = pf["valid"].shape[0], state.valid.shape[0]
    dev = state.valid.device
    ops = ((na_op.filter_fn, "na_sel_pairs"), (taint_op.filter_fn, "taint_intol_hard"),
           (vol_op.vb_filter, "vb_op"), (vol_op.vz_filter, "vz_op"))

    def bits_of(view, sub: dict, m: int, width: int, own: bool) -> torch.Tensor:
        bits = torch.zeros((m, width), dtype=torch.uint8, device=dev)
        for b, (fn, key) in enumerate(ops):
            ok = fn(view, sub, ctx, own) if key in sub else torch.ones((m, width), dtype=torch.bool, device=dev)
            bits |= ok.to(torch.uint8) << b
        return bits

    if pin is not None:
        idx = pin.to(torch.int64)
        view = SimpleNamespace(**{f: getattr(state, f).index_select(0, idx) for f in _NODE_FILTER_FIELDS})
        return bits_of(view, pf, k, 1, True)
    out = torch.empty((k, n), dtype=torch.uint8, device=dev)
    widest = max((pf[key].shape[1] * pf[key].shape[2] for key in ("na_req_op", "na_add_op", "vb_op", "vz_op")
                  if key in pf), default=1)
    per_pod = widest * n * state.label_key_ids.shape[1]
    block = max(1, min(_NODE_FILTER_BLOCK, _NODE_FILTER_ELEMS // max(per_pod, 1)))
    for lo in range(0, k, block):
        sub = {key: v[lo : lo + block] for key, v in pf.items()}
        m = sub["valid"].shape[0]
        out[lo : lo + m] = bits_of(state, sub, m, n, False)
    return out


def vol_filter(state, pf: dict, ctx, do_vr: bool, do_nvl: bool):
    """(C, N) u8 per-chunk volume filters: bit 0 VolumeRestrictions'
    (volumes.py:217), bit 1 NodeVolumeLimits' (volumes.py:238), each 1 when
    not asked for.  They read dev_counts, dev_rw_counts, csivol_counts and
    csi_used, which the chunk commits change."""
    c, n = pf["valid"].shape[0], state.valid.shape[0]
    ones = torch.ones((c, n), dtype=torch.bool, device=state.valid.device)
    vr = vol_op.vr_filter(state, pf, ctx) if do_vr else ones
    nvl = vol_op.nvl_filter(state, pf, ctx) if do_nvl else ones
    return vr.to(torch.uint8) | (nvl.to(torch.uint8) << 1)


def _node_oks(node_bits):
    return (node_bits & 1) != 0, (node_bits & 2) != 0


def spread_filter(state, pf: dict, node_bits, ctx):
    """(C, N) bool: PodTopologySpread's filter (podtopologyspread.py:219)
    for one chunk, its inclusion policies read from the chunk's
    node_filters bits."""
    return spread_op.filter_fn(state, pf, ctx, *_node_oks(node_bits))


def late_scores(state, pf: dict, feasible, total, node_bits, late, pin=None):
    """The scores that normalize over the final feasible set, added IN
    PLACE into ``total`` with their weights: NodeAffinity's
    (nodeaffinity.py:307), TaintToleration's reversed (tainttoleration.py:56)
    and PodTopologySpread's (podtopologyspread.py:261, inclusion policies
    from the node_filters bits); ``total`` stays 0 on infeasible nodes.
    With ``pin``, ``feasible`` and ``total`` are (C, 1) on each pod's
    pinned node (see pin_view), and spread must not score.  Returns
    ``total``."""
    if pin is not None:
        if late.spread_weight:
            raise ValueError("late_scores: PodTopologySpread does not score on pinned nodes")
        view, pf, _nom, (bits,), own = pin_view(state, pf, pin, None, (node_bits,))
        feas = own & feasible[:, 0][:, None]
        tot = torch.where(own, total[:, 0][:, None], 0)
        late_scores(view, pf, feas, tot, bits, late)
        total[:, 0] = tot.diagonal()
        return total
    ctx = late.ctx
    if late.na_weight:
        total += na_op.score_fn(state, pf, ctx, feasible) * late.na_weight
    if late.taint_weight:
        total += taint_op.score_fn(state, pf, ctx, feasible) * late.taint_weight
    if late.spread_weight:
        total += spread_op.score_fn(state, pf, ctx, feasible, *_node_oks(node_bits)) * late.spread_weight
    total.masked_fill_(~feasible, 0)
    return total


def late_scores_cols(state, pf: dict, feasible, total, node_bits, late):
    """Columns mode of late_scores, for the attribution pass: (3, C, N) i64,
    NodeAffinity's, TaintToleration's and PodTopologySpread's columns
    before their weights, normalized over ``feasible`` and given on every
    node as the ops give them (the first two are not masked: an infeasible
    node keeps raw·100 // max, or the op's value for a zero max; spread's
    is 0 off its scored nodes); a column whose weight is 0 stays 0.
    Weight × column is added into ``total`` IN PLACE."""
    c, n = feasible.shape
    cols = torch.zeros((3, c, n), dtype=torch.int64, device=feasible.device)
    ctx = late.ctx
    if late.na_weight:
        cols[0] = na_op.score_fn(state, pf, ctx, feasible)
    if late.taint_weight:
        cols[1] = taint_op.score_fn(state, pf, ctx, feasible)
    if late.spread_weight:
        cols[2] = spread_op.score_fn(state, pf, ctx, feasible, *_node_oks(node_bits))
    total += cols[0] * late.na_weight + cols[1] * late.taint_weight + cols[2] * late.spread_weight
    return cols


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """_hash_u32 (pass_.py:122) in int64 with a 32-bit mask after each step
    (torch has no uint32 shifts, remainders or comparisons on the CPU)."""
    x = x & _MASK32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def select_host(feasible, total, steps, seed_mul: int, nominated_row, pos=None):
    """(pick (C,) i32, best (C,) i64, feasible count (C,) i32): argmax with
    the hashed uniform tie-break in row order (pass_.py:136-163) and the
    nominated-node fast path (:548-553).  ``steps`` (C,) i64 holds each
    pod's uint32 step; ``seed_mul`` is tie_break_seed·2654435761 mod 2^32.
    With ``pos`` ((N,) i32, truncated mode: each row's place in the
    rotated scan order, truncate_feasible's) the ties count in that order
    instead of row order (:154-159)."""
    masked = torch.where(feasible, total, NEG_SCORE)
    best = masked.max(dim=1).values
    ties = feasible & (masked == best[:, None])
    m = ties.sum(dim=1)
    tie_rand = hash_u32(seed_mul + steps)
    kth = tie_rand % torch.clamp(m, min=1)
    if pos is None:
        order = torch.cumsum(ties.to(torch.int64), dim=1) - 1
        pick = torch.argmax((ties & (order == kth[:, None])).to(torch.int32), dim=1)
    else:
        tpos = torch.where(ties, pos[None, :], NO_POS)
        idx = torch.clamp(kth, 0, tpos.shape[1] - 1)[:, None]
        thr = torch.sort(tpos, dim=1).values.gather(1, idx)
        pick = torch.argmax((ties & (tpos == thr)).to(torch.int32), dim=1)
    pick = torch.where(m > 0, pick, -1).to(torch.int32)
    if nominated_row is not None:
        safe = torch.clamp(nominated_row, min=0).to(torch.int64)
        use = (nominated_row >= 0) & feasible.gather(1, safe[:, None])[:, 0]
        pick = torch.where(use, nominated_row, pick).to(torch.int32)
        best = torch.where(use, total.gather(1, safe[:, None])[:, 0], best)
    return pick, best, feasible.sum(dim=1).to(torch.int32)


def num_to_find(nvalid: torch.Tensor, pct: int) -> torch.Tensor:
    """numFeasibleNodesToFind (schedule_one.go:676-702, pass_.py:423-431)
    of an i32 node count: ``pct`` when non-zero, else the adaptive 50 −
    nodes/125 percent floored at 5; at least 100 nodes; every node below
    100."""
    if pct:
        percentage = torch.full_like(nvalid, pct)
    else:
        percentage = torch.clamp(50 - nvalid // 125, min=5)
    num = torch.clamp(nvalid * percentage // 100, min=100)
    return torch.where(nvalid < 100, nvalid, num)


def scan_counts(nvalid: int, pct: int) -> tuple[int, int]:
    """(nvalid, numFeasibleNodesToFind) of a truncated pass: constants of
    the pass (node validity does not change inside it, so every step of
    the JAX pass computes the same two from its state), handed to every
    truncate_feasible launch as host ints.  ``nvalid`` is the node count:
    the host's own (the cache's), so no device sync is needed."""
    return nvalid, int(num_to_find(torch.tensor(nvalid, dtype=torch.int32), pct))


def truncate_feasible(feasible, valid, order_pos, start, pod_valid, nvalid: int, limit: int):
    """Truncated (parity) mode's search cut (pass_.py:510-532, 564-569):
    each pod keeps only its first numFeasibleNodesToFind feasible nodes in
    rotated zone-interleaved order.  ``feasible`` (C, N) bool is cut IN
    PLACE; ``valid`` (N,) bool are the node rows, ``order_pos`` (N,) i32
    each row's place in the cache's node order, ``start`` (1,) i64 the
    scan start, advanced IN PLACE by the valid pods' processed counts
    modulo the node count; ``pod_valid`` (C,) bool; ``nvalid`` and
    ``limit`` the pass's node count and numFeasibleNodesToFind
    (scan_counts).  Returns (feasible, pos (N,) i32: each row's place in
    the rotated order (NO_POS off the node rows), processed (C,) i32: the
    nodes each pod's scan examined, 0 on padding lanes).  The cutoff is the
    limit-th smallest feasible pos, found by a sort as the JAX pass does;
    the start is i64 here (torch has no uint32 arithmetic on the CPU) and
    every value stays below the node count."""
    nv = max(nvalid, 1)
    pos = torch.where(valid, (order_pos.to(torch.int64) - start) % nv, NO_POS).to(torch.int32)
    n = pos.shape[0]
    c = feasible.shape[0]
    total_feas = feasible.sum(dim=1)
    fpos = torch.sort(torch.where(feasible, pos[None, :], NO_POS), dim=1).values
    over = total_feas > limit
    at = lambda rank: torch.full((c, 1), min(max(rank, 0), n - 1), dtype=torch.int64, device=pos.device)  # noqa: E731
    cutoff = fpos.gather(1, at(limit - 1))
    processed = fpos.gather(1, at(limit))[:, 0]
    feasible &= ~over[:, None] | (pos[None, :] <= cutoff)
    processed = torch.where(over, processed, nvalid)
    processed = torch.where(pod_valid, processed, 0).to(torch.int32)
    start.copy_((start + processed.sum()) % nv)
    return feasible, pos, processed


def resolve_commit(state, dom, pf: dict, picks, pairs, strict: bool):
    """Chunk deferral + exact cumulative fit (pass_.py:570-617) and the
    commit (_commit_chunk, :166-210): the base fields, and the pod's own
    affinity terms into et_counts and et_dom (at the node's value at each
    term's own slot; values outside [0, DV) are dropped, as the JAX
    scatter drops them), IN PLACE on ``state`` and the domain tables
    ``dom``.  Returns the chunk's output picks (-2 deferred, -1
    invalid/unschedulable)."""
    group_dom = dom.group_dom
    valid = pf["valid"]
    c = valid.shape[0]
    att = valid & (picks >= 0)
    defer = torch.zeros(c, dtype=torch.bool, device=valid.device)
    if not strict:
        before = torch.triu(torch.ones((c, c), dtype=torch.bool, device=valid.device), diagonal=1)
        defer = (pairs & before & att[:, None]).any(dim=0) & valid
        att = att & ~defer
        samei = (
            (picks[:, None] == picks[None, :])
            & att[:, None]
            & att[None, :]
            & torch.triu(torch.ones((c, c), dtype=torch.bool, device=valid.device))
        )
        req = pf["req"]
        cum_req = torch.where(samei[:, :, None], req[:, None, :], 0).sum(dim=0)  # (C, R)
        cum_cnt = samei.sum(dim=0).to(torch.int32)
        rows = torch.where(att, picks, 0).to(torch.int64)
        free = (state.alloc - state.req)[rows]
        ok = ((req == 0) | (cum_req <= free)).all(dim=-1) & (
            state.num_pods[rows] + cum_cnt <= state.allowed_pods[rows]
        )
        overflow = att & ~ok
        lim = pf.get("vol_csi_lim")
        if lim is not None:
            # A limited pod whose pick an earlier attempting limited mate
            # also took defers: distinct volumes still share one per-driver
            # budget on a node (pass_.py:605-613).
            prev_same = samei & ~torch.eye(c, dtype=torch.bool, device=valid.device)
            overflow = overflow | (att & (prev_same & lim[:, None] & lim[None, :]).any(dim=0))
        defer = defer | overflow
        att = att & ~overflow
    rows = torch.where(att, picks, 0).to(torch.int64)
    state.req.index_add_(0, rows, torch.where(att[:, None], pf["req"], 0))
    state.nonzero_req.index_add_(0, rows, torch.where(att[:, None], pf["nonzero"], 0))
    state.num_pods.index_add_(0, rows, att.to(torch.int32))
    group = pf["group"].to(torch.int64)
    gc = state.group_counts
    gc.view(-1).index_add_(0, group * gc.shape[1] + rows, att.to(torch.int32))
    tk, dv = group_dom.shape[1], group_dom.shape[2]
    dvals = state.topo_vals[rows].to(torch.int64)  # (C, TK)
    inc = (att[:, None] & (dvals >= 0) & (dvals < dv)).to(torch.float32)
    flat = (group[:, None] * tk + torch.arange(tk, device=dvals.device)[None, :]) * dv + dvals.clamp(0, dv - 1)
    group_dom.view(-1).index_add_(0, flat.reshape(-1), inc.reshape(-1))
    own = pf.get("ipa_own_terms")
    if own is not None:
        et_counts, et_dom = state.et_counts, dom.et_dom
        n = et_counts.shape[1]
        act = att[:, None] & (own >= 0)  # (C, A)
        safe = own.clamp(min=0).to(torch.int64)
        et_counts.view(-1).index_add_(
            0, (safe * n + rows[:, None]).reshape(-1), act.to(torch.int32).reshape(-1)
        )
        d_a = dvals.gather(1, dom.et_slot.to(torch.int64)[safe])  # (C, A)
        inc_a = (act & (d_a >= 0) & (d_a < dv)).to(torch.float32)
        et_dom.view(-1).index_add_(
            0, (safe * dv + d_a.clamp(0, dv - 1)).reshape(-1), inc_a.reshape(-1)
        )
    _commit_volumes(state, pf, att, rows)
    _commit_ports(state, pf, att, rows)
    _commit_dra(state, pf, att, rows)
    return torch.where(defer, -2, torch.where(valid, picks, -1)).to(torch.int32)


def _commit_ports(state, pf: dict, att, rows) -> None:
    """The host-port branch of _commit_chunk (pass_.py:195-201), in place:
    port_counts at each placed pod's triples and portkey_counts at its
    keys, one per active slot."""
    triples = pf.get("port_triples")
    if triples is None:
        return
    n = state.valid.shape[0]
    act = (att[:, None] & (triples >= 0)).to(torch.int32).reshape(-1)
    for ids, counts in ((triples, state.port_counts), (pf["port_keys"], state.portkey_counts)):
        flat = (ids.clamp(min=0).to(torch.int64) * n + rows[:, None]).reshape(-1)
        counts.view(-1).index_add_(0, flat, act)


def _commit_dra(state, pf: dict, att, rows) -> None:
    """The DRA branch of _commit_chunk (pass_.py:237-260), in place: a
    claim's count moves at its ``first`` slot, and every slot whose claim
    was reserved by no pod of the node before the chunk (the count is read
    before any is written) charges its pool's column of dra_alloc."""
    kids = pf.get("dra_claim_ids")
    if kids is None:
        return
    n = state.valid.shape[0]
    act = att[:, None] & (kids >= 0)
    flat = (kids.clamp(min=0).to(torch.int64) * n + rows[:, None]).reshape(-1)
    prev = state.dra_claim_counts.view(-1)[flat].view(act.shape)
    state.dra_claim_counts.view(-1).index_add_(
        0, flat, (act & pf["dra_claim_first"]).to(torch.int32).reshape(-1))
    cls = pf["dra_claim_cls"].to(torch.int64)
    dc = state.dra_alloc.shape[0]
    newly = act & (prev == 0) & (cls >= 0) & (cls < dc)
    flat_c = (cls.clamp(0, dc - 1) * n + rows[:, None]).reshape(-1)
    state.dra_alloc.view(-1).index_add_(
        0, flat_c, torch.where(newly, pf["dra_claim_cnt"], 0).to(torch.int32).reshape(-1))


def _commit_volumes(state, pf: dict, att, rows) -> None:
    """The device and CSI branches of _commit_chunk (pass_.py:211-236), in
    place: dev_counts and dev_rw_counts scatter-add; csivol_counts += 1 and
    csi_used += 1 where the volume's count before the chunk was 0 (every
    count is read before any is written)."""
    n = state.valid.shape[0]
    dev = pf.get("vol_dev_ids")
    if dev is not None:
        act = att[:, None] & (dev >= 0)
        flat = (dev.clamp(min=0).to(torch.int64) * n + rows[:, None]).reshape(-1)
        state.dev_counts.view(-1).index_add_(0, flat, act.to(torch.int32).reshape(-1))
        rw = act & pf["vol_dev_rw"]
        state.dev_rw_counts.view(-1).index_add_(0, flat, rw.to(torch.int32).reshape(-1))
    csi = pf.get("vol_csi_ids")
    if csi is not None:
        act = att[:, None] & (csi >= 0)
        flat = (csi.clamp(min=0).to(torch.int64) * n + rows[:, None]).reshape(-1)
        prev = state.csivol_counts.view(-1)[flat].view(act.shape)
        state.csivol_counts.view(-1).index_add_(0, flat, act.to(torch.int32).reshape(-1))
        drv = pf["vol_csi_drv"].to(torch.int64)
        dr = state.csi_used.shape[0]
        newly = act & (prev == 0) & (drv >= 0) & (drv < dr)
        flat_d = (drv.clamp(0, dr - 1) * n + rows[:, None]).reshape(-1)
        state.csi_used.view(-1).index_add_(0, flat_d, newly.to(torch.int32).reshape(-1))


def pinned_fit(own_ok, pin_row, valid, req, state):
    """(picks (K,) i32, feasible (K,) i32): the pinned-batch pass's
    same-row rule (pass_.py:1003-1032).  A feasible pod (valid, pinned to a
    live node, own-node filters passed) places when the inclusive prefix,
    in batch order, of its feasible same-row mates' requests fits the
    row's free capacity before the batch and their count its free pod
    slots; otherwise it defers (-2)."""
    k = pin_row.shape[0]
    feas = valid & (pin_row >= 0) & own_ok
    upto = torch.tril(torch.ones((k, k), dtype=torch.bool, device=pin_row.device))
    mates = (pin_row[:, None] == pin_row[None, :]) & feas[None, :] & upto  # [i, j]: j counts for i
    within = torch.where(mates[:, :, None], req[None, :, :], 0).sum(dim=1)  # (K, R)
    count = mates.sum(dim=1)
    row = pin_row.clamp(min=0).to(torch.int64)
    free = (state.alloc - state.req)[row]
    fit = ((req == 0) | (within <= free)).all(dim=1) & (state.num_pods[row] + count <= state.allowed_pods[row])
    picks = torch.where(feas, torch.where(fit, pin_row, -2), -1).to(torch.int32)
    return picks, feas.to(torch.int32)


# -- data moves (rows.cu) -------------------------------------------------------


def scatter_rows(dst, axis: int, rows, src) -> None:
    """dst's node rows ``rows`` (axis 0) or columns (axis 1) ← ``src``, in
    place (snapshot.py:796 _scatter_rows, preemption.py:137
    _scatter_buf_rows)."""
    if axis == 0:
        dst[rows] = src
    else:
        dst[:, rows] = src


def scatter_fields(dsts, axes, buf, layout) -> None:
    """Each of ``dsts``' node rows (axis 0) or columns (axis 1) ← its rows
    in the packed buffer ``buf`` (u8; kernels.pack_rows' ``layout``, the row
    index first), field by field with scatter_rows (snapshot.py:796
    _scatter_rows over every field)."""
    m = layout.nrows
    rows = buf[:8 * m].view(torch.int64)
    for dst, axis, slot in zip(dsts, axes, layout.slots):
        src = buf[slot.offset:slot.offset + slot.outer * m * slot.inner].view(dst.dtype)
        scatter_rows(dst, axis, rows, src.reshape((m,) + tuple(dst.shape[1:]) if axis == 0 else (slot.outer, m)))


def expand_rows(src, k: int):
    """(k, ...) copies of row 0 of ``src`` (scheduler.py:44 _expand_uniform)."""
    return src[0].expand((k,) + tuple(src.shape[1:])).clone()


# -- preemption (victims.cu, preempt.cu, preempt_search.cu) ----------------------

I32_MAX = 2**31 - 1
# Criteria rows of preempt_eval's (5, N) output, in pickOneNodeForPreemption
# order: PDB violations, max victim priority, priority sum, victim count,
# start key.
N_CRIT = 5
# Empty-slot fills of the victim features (preemption.py:89 _VFEAT_PAD):
# id columns -1, counts and flags 0.
VFEAT_PAD = {"group": -1, "terms": -1, "port_triples": -1, "port_keys": -1, "vol_dev_ids": -1, "csi_ids": -1,
             "dra_kid": -1}
# preempt_eval's modes: the whole dry-run in one call (no domain op in the
# search), or its prologue (the carry) and its criteria tail around a host
# loop of dom_release and search_step.
FULL, PROLOGUE, TAIL = 0, 1, 2
# search_step's steps besides the reprieve slots s >= 0: the hard filters on
# the live state, and phase 1 (every lower-priority victim released).
HARD_STEP, PHASE1 = -2, -1
# SearchCarry.flags bits: the release-independent filters pass, the hard
# filters pass, phase 1 is feasible, the node may reprieve.
F_BASE, F_HARD, F_FEAS, F_REPRIEVE = 1, 2, 4, 8


def unpack_victims(buf, r: int, n_pdbs: int, pdb_words: int, v: int, inline_allowed: bool, vf_cols=()):
    """The staged (N, vu, cols) int64 victim buffer → (prio (N, v) i32, req
    (N, v, R) i64, nonzero (N, v, 2) i64, start (N, v) f64, pdb (N, v, P)
    bool, allowed (P,) i64 or None, vfeat {name: (N, v[, W]) i32}), the
    occupied slots padded to ``v`` with the empty-slot sentinels
    (preemption.py:94 _unpack_victims).  ``vf_cols`` lists the victim
    feature columns after the PDB words as (name, width, ndim), ndim 2 for
    one column per slot."""
    n, vu, _cols = buf.shape
    pad = v - vu

    def padded(x, fill):
        if pad == 0:
            return x
        shape = (n, pad) + tuple(x.shape[2:])
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=1)

    prio = padded(buf[..., 0].to(torch.int32), I32_MAX)
    req = padded(buf[..., 1 : 1 + r], 0)
    nonzero = padded(buf[..., 1 + r : 3 + r], 0)
    start = padded(buf[..., 3 + r].contiguous().view(torch.float64), float("inf"))
    idx = torch.arange(n_pdbs, device=buf.device)
    words = buf[..., 4 + r : 4 + r + pdb_words]
    bits = (words[..., idx // 64] >> (idx % 64)) & 1
    pdb = padded(bits.to(torch.bool), False)
    allowed = buf[:n_pdbs, 0, -1].clone() if inline_allowed else None
    vfeat = {}
    off = 4 + r + pdb_words
    for name, width, ndim in vf_cols:
        col = buf[..., off] if ndim == 2 else buf[..., off : off + width]
        vfeat[name] = padded(col.to(torch.int32), VFEAT_PAD.get(name, 0)).contiguous()
        off += width
    return (prio.contiguous(), req.contiguous(), nonzero.contiguous(), start.contiguous(),
            pdb.contiguous(), allowed, vfeat)


def mate_valid(pf: dict):
    """(C,) bool: the dry-run's valid mates — ``valid``, or under the
    speculative chain ``elig & (spec_picks < 0)`` (preemption.py:155)."""
    if "valid" in pf:
        return pf["valid"]
    return pf["elig"] & (pf["spec_picks"] < 0)


def _rep(pf: dict) -> int:
    """The chunk's representative: its first valid mate, 0 when none."""
    valid = mate_valid(pf)
    return int(torch.argmax(valid.to(torch.int32))) if bool(valid.any()) else 0


def slot_mask(bits, v: int):
    """(N,) i64 victim-slot bitmasks → (N, v) bool."""
    return ((bits[:, None] >> torch.arange(v, device=bits.device)) & 1).to(torch.bool)


def slot_bits(mask):
    """(N, V) bool → (N,) i64 bitmasks (slot j is bit j)."""
    shifts = torch.arange(mask.shape[1], device=mask.device)
    return (mask.to(torch.int64) << shifts).sum(dim=1)


def _prologue(state, vic, pf: dict, spec):
    """The carry of one dry-run: every victim below the representative's
    priority masked, their released requests and count, and the flags of
    the release-independent filters (the hard filters pass until
    search_step's HARD_STEP says otherwise)."""
    from . import SearchCarry

    i0 = _rep(pf)
    base = state.valid.clone()
    if spec.check_unsched:
        base &= ~state.unschedulable | pf["tolerates_unschedulable"][i0]
    if spec.check_nodename:
        want = pf["nodename_id"][i0]
        base &= (want == -1) | (state.name_id == want)
    if spec.bits_mask:
        base &= (pf["node_bits"][i0].to(torch.int32) & spec.bits_mask) == spec.bits_mask
    if spec.dra:
        # DynamicResources' unresolvable half: a missing claim or a pin
        # elsewhere (preemption.py:237-243, 362-366).
        base &= ~dra_op.hard_filter_fn(state, {key: val[i0 : i0 + 1] for key, val in pf.items()}, spec.ctx)[0]
    lower = vic.prio < pf["priority"][i0].to(torch.int32)
    rel = torch.where(lower[:, :, None], vic.req, 0).sum(dim=1)
    cnt = lower.sum(dim=1).to(torch.int32)
    flags = (torch.where(base, F_BASE, 0) | F_HARD).to(torch.uint8)
    return SearchCarry(slot_bits(lower), rel, cnt, flags)


def _tail(state, vic, pf: dict, carry):
    """The five criteria over each node's final victim set (preemption.py:
    457-536): (possible, crit, vic_mask, n_vic, rel, relnz)."""
    i0 = _rep(pf)
    mask = slot_mask(carry.mask, vic.prio.shape[1])
    n_vic = mask.sum(dim=1).to(torch.int32)
    need = F_BASE | F_HARD | F_FEAS
    possible = ((carry.flags.to(torch.int32) & need) == need) & (n_vic >= 1) & mate_valid(pf)[i0]
    cnt_p = (mask[:, :, None] & vic.pdb).sum(dim=1).to(torch.int64)  # (N, P)
    violations = (cnt_p - vic.allowed[None, :]).clamp(min=0).sum(dim=1)
    max_prio = torch.where(mask, vic.prio, -1).max(dim=1).values
    prio_sum = torch.where(mask, vic.prio.to(torch.int64), 0).sum(dim=1)
    top = mask & (vic.prio == max_prio[:, None])
    min_start = torch.where(top, vic.start, float("inf")).min(dim=1).values
    start_key = torch.where(
        torch.isfinite(min_start), -min_start * 1e6, torch.full_like(min_start, -(2.0**61))
    ).to(torch.int64)
    relnz = torch.where(mask[:, :, None], vic.nonzero, 0).sum(dim=1)
    crit = torch.stack([violations, max_prio.to(torch.int64), prio_sum, n_vic.to(torch.int64), start_key])
    return possible, crit, mask, n_vic, carry.rel, relnz


def preempt_eval(state, vic, pf: dict, spec, mode: int = FULL, carry=None):
    """One dry-run of the chunk's representative preemptor (the first valid
    mate) against every node — eval_one (preemption.py:257).  FULL runs it
    whole (the node-local ops of the search, NodePorts, VolumeRestrictions
    and NodeVolumeLimits, in the reprieve loop) and returns (possible (N,)
    bool, crit (5, N) i64, vic_mask (N, V) bool, n_vic (N,) i32, rel (N, R)
    i64, relnz (N, 2) i64); PROLOGUE returns the SearchCarry that
    search_step advances; TAIL returns FULL's outputs from that carry."""
    if mode == PROLOGUE:
        return _prologue(state, vic, pf, spec)
    if mode == TAIL:
        return _tail(state, vic, pf, carry)
    if spec.domain:
        raise ValueError("preempt_eval: a domain op of the search needs PROLOGUE, search_step and TAIL")
    carry = _prologue(state, vic, pf, spec)
    search_step(state, vic, pf, spec, carry, PHASE1)
    for s in range(vic.prio.shape[1] - 1, -1, -1):
        search_step(state, vic, pf, spec, carry, s)
    return _tail(state, vic, pf, carry)


def _minus_at(table, rows, cols):
    """A copy of ``table`` with 1 taken off at each (rows[i], cols[i])."""
    out = table.clone()
    if rows.numel():
        out.index_put_((rows.to(torch.int64), cols.to(torch.int64)),
                       torch.full((rows.numel(),), -1, dtype=out.dtype, device=out.device), accumulate=True)
    return out


def released_counts(state, vic, tent):
    """The group and own-term counts with each node's masked victims
    removed (preemption.py:274-297): (group_counts, et_counts)."""
    n, v = tent.shape
    node = torch.arange(n, device=tent.device)[:, None].expand(n, v)
    vf = vic.vfeat or {}
    gc, ec = state.group_counts, state.et_counts
    if "group" in vf:
        g = vf["group"]
        m = tent & (g >= 0)
        gc = _minus_at(gc, g[m], node[m])
    if "terms" in vf:
        tm = vf["terms"]
        m = tent[:, :, None] & (tm >= 0)
        ec = _minus_at(ec, tm[m], node[:, :, None].expand(tm.shape)[m])
    return gc, ec


def dom_release(dom, state, vic, carry, s: int):
    """(group_dom, et_dom) of the state with the carry's masked victims
    removed, slot ``s`` restored on every node when s >= 0 — build_dom of
    preemption.py:274 released(mask), :411-415."""
    tent = slot_mask(carry.mask, vic.prio.shape[1])
    if s >= 0:
        tent[:, s] = False
    gc, ec = released_counts(state, vic, tent)
    st2 = dataclasses.replace(state, group_counts=gc, et_counts=ec)
    return build_dom(st2, dom.et_slot, dom.group_dom.shape[2])


def _released_ports(state, vic, tent):
    """port_counts and portkey_counts with the masked victims' host ports
    released, both by the triple slots' decrement (preemption.py:298-307)."""
    vf = vic.vfeat or {}
    if "port_triples" not in vf:
        return state.port_counts, state.portkey_counts
    pt, pk = vf["port_triples"], vf["port_keys"]
    dec = tent[:, :, None] & (pt >= 0)
    node = torch.arange(tent.shape[0], device=tent.device)[:, None, None].expand(pt.shape)[dec]
    return _minus_at(state.port_counts, pt[dec], node), _minus_at(state.portkey_counts, pk.clamp(min=0)[dec], node)


def _held(ids, vf_ids, live):
    """(S, N): per wanted id, the node's live victim slots holding it."""
    same = (vf_ids[None] == ids[:, None, None, None]) & live[None]
    return same.sum(dim=(2, 3))


def _vr_released(state, vic, tent, pf1) -> torch.Tensor:
    """VolumeRestrictions (volumes.py:217) on the state released by
    ``tent``, the ReadWriteOncePod check forced true; only the wanted
    devices' rows are read (preemption.py:309-318)."""
    n = tent.shape[0]
    ids = pf1.get("vol_dev_ids")
    vf = vic.vfeat or {}
    if ids is None:
        return torch.ones(n, dtype=torch.bool, device=tent.device)
    ids = ids[0].to(torch.int64)
    safe = ids.clamp(min=0)
    uses = state.dev_counts[safe].to(torch.int64)
    rw_uses = state.dev_rw_counts[safe].to(torch.int64)
    if "vol_dev_ids" in vf:
        di, dw = vf["vol_dev_ids"], vf["vol_dev_rw"]
        live = tent[:, :, None] & (di >= 0)
        uses = uses - _held(ids, di, live)
        rw_uses = rw_uses - _held(ids, di, live & (dw > 0))
    ro = ~pf1["vol_dev_rw"][0]
    conflict = torch.where(ro[:, None], rw_uses > 0, uses > 0) & (ids >= 0)[:, None]
    return ~conflict.any(dim=0)


def _nvl_released(state, vic, tent, pf1) -> torch.Tensor:
    """NodeVolumeLimits (volumes.py:238) on the state released by ``tent``:
    each wanted volume's count less the node's masked victim slots holding
    it, and csi_used less one per masked slot whose volume's count crosses
    to 0 (preemption.py:320-334; two victims sharing a volume free it only
    together, and then both slots count).  csivol_counts is read at the
    wanted and the victims' ids only, never copied."""
    n = tent.shape[0]
    ids = pf1.get("vol_csi_ids")
    vf = vic.vfeat or {}
    if ids is None:
        return torch.ones(n, dtype=torch.bool, device=tent.device)
    ids = ids[0].to(torch.int64)
    count = state.csivol_counts[ids.clamp(min=0)].to(torch.int64)  # (S, N)
    used = state.csi_used.to(torch.int64)
    if "csi_ids" in vf:
        ci, cd = vf["csi_ids"], vf["csi_drv"]
        live = tent[:, :, None] & (ci >= 0)
        count = count - _held(ids, ci, live)
        node = torch.arange(n, device=tent.device)[:, None, None].expand(ci.shape)
        same = ((ci[:, :, :, None, None] == ci[:, None, None, :, :]) & live[:, None, None, :, :]).sum(dim=(3, 4))
        crossed = live & (state.csivol_counts[ci.clamp(min=0).to(torch.int64), node].to(torch.int64) - same == 0)
        used = _minus_at(used, cd.clamp(min=0)[crossed], node[crossed])
    newv = (ids >= 0)[:, None] & ~(count > 0)
    drv = pf1["vol_csi_drv"][0]
    ok = torch.ones(n, dtype=torch.bool, device=tent.device)
    for d in range(used.shape[0]):
        new_cnt = (newv & (drv == d)[:, None]).sum(dim=0)
        ok &= (used[d] + new_cnt <= state.csi_limit[d].to(torch.int64)) | (new_cnt == 0)
    return ok


def _dra_released(state, vic, tent, pf1) -> torch.Tensor:
    """DynamicResources (dynamicresources.py:53) on the state released by
    ``tent`` (preemption.py:335-353): a claim's count less the node's
    masked ``first`` victim slots holding it, and each pool's dra_alloc less
    the devices of every masked slot whose claim's count so reaches 0.
    dra_claim_counts is read at the wanted and the victims' ids only, never
    copied."""
    ok = (~pf1["dra_missing"][:, None] & dra_op.pins_ok(state, pf1))[0]
    if "dra_claim_ids" not in pf1:
        return ok
    n = tent.shape[0]
    kids = pf1["dra_claim_ids"][0].to(torch.int64)
    counts = state.dra_claim_counts[kids.clamp(min=0)].to(torch.int64)  # (S, N)
    alloc = state.dra_alloc.to(torch.int64)
    vf = vic.vfeat or {}
    if "dra_kid" in vf:
        kid = vf["dra_kid"]
        live = tent[:, :, None] & (kid >= 0)
        moves = live & (vf["dra_first"] > 0)
        counts = counts - _held(kids, kid, moves)
        node = torch.arange(n, device=tent.device)[:, None, None].expand(kid.shape)
        same = ((kid[:, :, :, None, None] == kid[:, None, None, :, :]) & moves[:, None, None, :, :]).sum(dim=(3, 4))
        crossed = live & (state.dra_claim_counts[kid.clamp(min=0).to(torch.int64), node].to(torch.int64) - same == 0)
        flat = (vf["dra_cid"].clamp(min=0).to(torch.int64) * n + node)[crossed]
        alloc = alloc.reshape(-1).index_add(0, flat, -vf["dra_cnt"].to(torch.int64)[crossed]).view(alloc.shape)
    _present, demand = dra_op.claim_demand(state, pf1)
    need = (demand[0][:, :, None] * (counts <= 0)[:, None, :]).sum(dim=0)  # (DC, N)
    return ok & ((need == 0) | (alloc + need <= state.dra_cap)).all(dim=0)


def _search_ok(state, vic, pf1: dict, spec, tent, dom_rel) -> torch.Tensor:
    """(N,) bool: the search ops' filters (preemption.py:391-431 ok_search)
    for the representative ``pf1`` (a one-pod chunk) on the state released
    by ``tent``; the domain tables ``dom_rel`` are those of that state."""
    n = tent.shape[0]
    ok = torch.ones(n, dtype=torch.bool, device=tent.device)
    ctx = spec.ctx
    if spec.ipa or spec.pts:
        gc, ec = released_counts(state, vic, tent)
        st2 = dataclasses.replace(state, group_counts=gc, et_counts=ec)
        if spec.ipa:
            ok &= ipa_op.filter_fn(st2, pf1, dataclasses.replace(ctx, dom=dom_rel))[0]
        if spec.pts:
            ok &= spread_op.filter_fn(st2, pf1, ctx, *_node_oks(pf1["node_bits"]))[0]
    if spec.ports:
        pc, pkc = _released_ports(state, vic, tent)
        ok &= ports_op.filter_fn(dataclasses.replace(state, port_counts=pc, portkey_counts=pkc), pf1, ctx)[0]
    if spec.vr:
        ok &= _vr_released(state, vic, tent, pf1)
    if spec.nvl:
        ok &= _nvl_released(state, vic, tent, pf1)
    if spec.dra:
        ok &= _dra_released(state, vic, tent, pf1)
    return ok


def search_step(state, vic, pf: dict, spec, carry, s: int, dom=None, dom_rel=None) -> None:
    """One step of the dry-run's search, IN PLACE on ``carry``
    (preemption.py:391-455) for the chunk's representative:
      HARD_STEP  the hard filters of InterPodAffinity and PodTopologySpread
                 on the live state (``dom``) clear F_HARD where they reject;
      PHASE1     the closed-form fit and the search ops with every masked
                 victim released set F_FEAS, and F_REPRIEVE unless the
                 preemptor is ReadWriteOncePod-blocked (evict all, no
                 reprieve);
      s >= 0     the reprieve of slot s: the state releases the masked
                 victims but slot s on EVERY node (``dom_rel`` is that
                 state's domain tables), and a node that may reprieve and
                 still fits takes it back.
    The closed form reads the carried release, the search ops the released
    counts."""
    i0 = _rep(pf)
    pf1 = {key: val[i0 : i0 + 1] for key, val in pf.items()}
    n, v = vic.prio.shape
    if s == HARD_STEP:
        ok = torch.ones(n, dtype=torch.bool, device=carry.flags.device)
        if spec.ipa:
            ok &= ~ipa_op.hard_filter_fn(state, pf1, dataclasses.replace(spec.ctx, dom=dom))[0]
        if spec.pts:
            ok &= ~spread_op.hard_filter_fn(state, pf1, spec.ctx)[0]
        carry.flags.copy_(torch.where(ok, carry.flags, carry.flags & ~F_HARD))
        return
    mask = slot_mask(carry.mask, v)
    tent = mask.clone()
    demand = pf["req"][i0]
    if s >= 0:
        has = mask[:, s]
        tent[:, s] = False
        t_rel = carry.rel - torch.where(has[:, None], vic.req[:, s], 0)
        t_cnt = carry.cnt - has.to(torch.int32)
    else:
        t_rel, t_cnt = carry.rel, carry.cnt
    free = state.alloc - (state.req - t_rel)
    ok = ((demand[None, :] == 0) | (demand[None, :] <= free)).all(dim=-1)
    ok &= state.num_pods - t_cnt + 1 <= state.allowed_pods
    ok &= _search_ok(state, vic, pf1, spec, tent, dom_rel)
    if s == PHASE1:
        add = torch.where(ok, F_FEAS, 0)
        if not (spec.vr and not bool(pf["vr_rwop_ok"][i0])):
            add = add | torch.where(ok, F_REPRIEVE, 0)
        carry.flags.copy_(carry.flags | add.to(torch.uint8))
        return
    take = ((carry.flags & F_REPRIEVE) != 0) & ok & has
    mask[:, s] &= ~take
    carry.mask.copy_(slot_bits(mask))
    carry.rel.copy_(torch.where(take[:, None], t_rel, carry.rel))
    carry.cnt.copy_(torch.where(take, t_cnt, carry.cnt))


def preempt_pick(possible, crit, pf: dict, chunk_mode: bool):
    """(C,) i32 picks of the chunk's mates: eligible mates (valid, same
    signature as the representative) take the node at their cumsum rank in
    the exact lexicographic order of the five criteria with row as the last
    key; at chunk > 1 a valid mate left without a node defers (-2)
    (preemption.py:499-520 and :542-600)."""
    valid = mate_valid(pf)
    c = valid.shape[0]
    n = possible.shape[0]
    i0 = int(torch.argmax(valid.to(torch.int32))) if bool(valid.any()) else 0
    eligible = valid & (pf["sig"] == pf["sig"][i0])
    big = 2**62
    vio_m = torch.where(possible, crit[0], big)
    keys = [crit[4], crit[3], crit[2], crit[1], vio_m]
    order = torch.arange(n, device=possible.device)
    for key in keys:  # stable sorts, least significant key first (lexsort)
        order = order[torch.sort(key[order], stable=True).indices]
    srt = vio_m[order]
    rank = torch.cumsum(eligible.to(torch.int64), 0) - 1
    safe = rank.clamp(0, n - 1)
    has = eligible & (srt[safe] < big)
    picks = torch.where(has, order[safe], -1).to(torch.int32)
    if chunk_mode:
        picks = torch.where(valid & ~has, -2, picks).to(torch.int32)
    return picks


def preempt_commit(carry, vic_prio, ev, picks):
    """The step's commit (preemption.py:601-617), in place on the carried
    (req, nonzero_req, num_pods) and ``vic_prio``: the picked rows' release
    comes off and the chosen victims are raised to INT32_MAX.  Returns the
    mates' (vic_mask (C, V) bool, n_victims (C,) i32)."""
    req, nonzero_req, num_pods = carry
    _possible, _crit, vic_mask, n_vic, rel, relnz = ev
    do = picks >= 0
    rows = torch.where(do, picks, 0).to(torch.int64)
    chosen = vic_mask[rows] & do[:, None]
    nvics = torch.where(do, n_vic[rows], 0).to(torch.int32)
    req.index_add_(0, rows, -torch.where(do[:, None], rel[rows], 0))
    nonzero_req.index_add_(0, rows, -torch.where(do[:, None], relnz[rows], 0))
    num_pods.index_add_(0, rows, -nvics)
    # Consumption only raises priorities to the sentinel, so mates sharing
    # a row (only the clipped rank makes them) write the same values.
    r = rows[do]
    vic_prio[r] = torch.where(chosen[do], I32_MAX, vic_prio[r])
    return chosen, nvics
