"""Plain PyTorch versions of the batch-pass kernels.

Each function computes what its CUDA kernel computes, with the same
signature, and is the reference the kernel is held against on the card
(chip_smoke.py) and what runs for tensors on the CPU.  They follow the JAX
batch pass (kubernetes_tpu/engine/pass_.py) operation by operation.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import common as opcommon
from ..ops import interpodaffinity as ipa_op
from ..ops import nodeaffinity as na_op
from ..ops import podtopologyspread as spread_op
from ..ops import tainttoleration as taint_op
from ..ops import volumes as vol_op
from ..ops.helpers import make_topo_onehot
from ..ops.volumes import NVL, VB, VR, VZ

IPA = "InterPodAffinity"
NA, TT, PTS = "NodeAffinity", "TaintToleration", "PodTopologySpread"
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
# the elements a block's (pods, T, Q, N, LS) label match may hold.
_NODE_FILTER_BLOCK = 256
_NODE_FILTER_ELEMS = 2**28

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
    bool[, vol_bits (C, N) u8]) by name; any may be None when no filter
    reads it."""
    names = ("node_bits", "spread_ok", "vol_bits")
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
    and the (C, N) ``planes`` likewise, ``nominated_row`` mapped onto the
    view (pod c's own node is node c), and the (C, C) diagonal that holds
    each pod to its own node.  A view's (C, C) results read on the
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
    planes = tuple(None if p is None else p.index_select(1, idx) for p in planes)
    return view, pf, nom, planes, torch.eye(c, dtype=torch.bool, device=idx.device)


def eval_chunk(state, pf: dict, spec, nom, ext=None, pin=None):
    """(feasible (C, N) bool, total (C, N) i64, fail_mask (C,) i32) of one
    chunk — eval_pod's filter chain and weighted score sum (pass_.py:494-539).
    The EXT_FILTERS ops' results come from ``ext`` (see ext_filter).
    ``total`` is 0 on infeasible nodes (select_host never reads it there).
    With ``pin`` each pod is evaluated on its pinned node alone (see
    pin_view): (C, 1) outputs and that node's fail bits."""
    own = None
    if pin is not None:
        state, pf, nom, ext, own = pin_view(state, pf, pin, nom, tuple(ext_planes(ext).values()))
    ctx = dataclasses.replace(spec.ctx, nom=nom)
    c = pf["req"].shape[0]
    n = state.valid.shape[0]
    feasible = state.valid[None, :].expand(c, n).clone()
    if own is not None:
        feasible &= own
    fail = torch.zeros(c, dtype=torch.int32, device=feasible.device)
    for bit, name in enumerate(spec.filters):
        if name in EXT_FILTERS:
            ok = ext_filter(name, ext)
        else:
            ok = opcommon.get(name).filter(state, pf, ctx)
        newly = feasible & ~ok
        fail = fail | torch.where(newly.any(dim=1), 1 << bit, 0).to(torch.int32)
        feasible = feasible & ok
    total = torch.zeros((c, n), dtype=torch.int64, device=feasible.device)
    for name, weight in spec.scorers:
        total = total + opcommon.get(name).score(state, pf, ctx, feasible) * weight
    total = torch.where(feasible, total, 0)
    if own is not None:
        return feasible.diagonal()[:, None].clone(), total.diagonal()[:, None].clone(), fail
    return feasible, total, fail


def ipa_bit(ipa) -> int:
    """InterPodAffinity's fail bit for an IpaSpec, or -1 when the op only
    scores.  ipa_eval runs after eval_chunk, so every filter eval_chunk
    evaluates must precede InterPodAffinity in the profile's filter order:
    its bit is then the position after theirs."""
    if IPA not in ipa.filters:
        return -1
    bit = ipa.filters.index(IPA)
    if bit != len(ipa.filters) - 1:
        raise NotImplementedError(
            f"filters {list(ipa.filters[bit + 1:])} after {IPA}: ipa_eval runs after eval_chunk"
        )
    return bit


def ipa_eval(state, pf: dict, feasible, total, fail, ipa):
    """InterPodAffinity on top of eval_chunk's (feasible, total, fail_mask),
    IN PLACE: the filter (ops/interpodaffinity.py filter_fn) sets the op's
    fail bit for nodes that passed every earlier filter and clears them
    from ``feasible``; the score adds weight × the normalized score on the
    final feasible set; ``total`` is 0 on every infeasible node.  The
    domain tables come from ``ipa.ctx.dom``.  Returns the three tensors."""
    bit = ipa_bit(ipa)
    if bit >= 0:
        ok = ipa_op.filter_fn(state, pf, ipa.ctx)
        newly = (feasible & ~ok).any(dim=1)
        fail |= torch.where(newly, 1 << bit, 0).to(torch.int32)
        feasible &= ok
    if ipa.weight:
        total += ipa_op.score_fn(state, pf, ipa.ctx, feasible) * ipa.weight
    total.masked_fill_(~feasible, 0)
    return feasible, total, fail


def conflict_pairs(pf: dict, nchunks: int, c: int):
    """(nchunks, C, C) bool — _conflict_pairs (pass_.py:266-342) with
    gathers in place of the one-hot einsums: pairs[i, j] =
    reads_g[j, group[i]] ∨ ∃a hard_t[j, own[i, a]] ∨ (i and j share a
    device or CSI volume id) ∨ (both vol_unbound), where reads_g is
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
    for key in ("vol_dev_ids", "vol_csi_ids"):
        if key in pf:
            ids = pf[key].view(nchunks, c, -1)
            ok = ids >= 0
            eq = (ids[:, :, None, :, None] == ids[:, None, :, None, :]) & (
                ok[:, :, None, :, None] & ok[:, None, :, None, :])
            pairs = pairs | eq.flatten(3).any(dim=3)
    if "vol_unbound" in pf:
        u = pf["vol_unbound"].view(nchunks, c)
        pairs = pairs | (u[:, :, None] & u[:, None, :])
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


def node_filters(state, pf: dict, ctx):
    """(K, N) u8 per-batch node filters: bit 0 NodeAffinity's filter
    (nodeaffinity.py:285, with the profile's added affinity), bit 1
    TaintToleration's (tainttoleration.py:52), bit 2 VolumeBinding's
    (volumes.py:146), bit 3 VolumeZone's (volumes.py:191); a bit whose
    features the batch does not carry is 1.  They read only node state no
    commit changes, so one evaluation serves every chunk of the batch."""
    k, n = pf["valid"].shape[0], state.valid.shape[0]
    out = torch.empty((k, n), dtype=torch.uint8, device=state.valid.device)
    ops = ((na_op.filter_fn, "na_sel_pairs"), (taint_op.filter_fn, "taint_intol_hard"),
           (vol_op.vb_filter, "vb_op"), (vol_op.vz_filter, "vz_op"))
    widest = max((pf[key].shape[1] * pf[key].shape[2] for key in ("na_req_op", "na_add_op", "vb_op", "vz_op")
                  if key in pf), default=1)
    per_pod = widest * n * state.label_key_ids.shape[1]
    block = max(1, min(_NODE_FILTER_BLOCK, _NODE_FILTER_ELEMS // max(per_pod, 1)))
    for lo in range(0, k, block):
        sub = {key: v[lo : lo + block] for key, v in pf.items()}
        m = sub["valid"].shape[0]
        bits = torch.zeros((m, n), dtype=torch.uint8, device=out.device)
        for b, (fn, key) in enumerate(ops):
            ok = fn(state, sub, ctx) if key in sub else torch.ones((m, n), dtype=torch.bool, device=out.device)
            bits |= ok.to(torch.uint8) << b
        out[lo : lo + m] = bits
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


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """_hash_u32 (pass_.py:122) in int64 with a 32-bit mask after each step
    (torch has no uint32 shifts, remainders or comparisons on the CPU)."""
    x = x & _MASK32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _MASK32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def select_host(feasible, total, steps, seed_mul: int, nominated_row):
    """(pick (C,) i32, best (C,) i64, feasible count (C,) i32): argmax with
    the hashed uniform tie-break in row order (pass_.py:136-163) and the
    nominated-node fast path (:548-553).  ``steps`` (C,) i64 holds each
    pod's uint32 step; ``seed_mul`` is tie_break_seed·2654435761 mod 2^32."""
    masked = torch.where(feasible, total, NEG_SCORE)
    best = masked.max(dim=1).values
    ties = feasible & (masked == best[:, None])
    m = ties.sum(dim=1)
    tie_rand = hash_u32(seed_mul + steps)
    kth = tie_rand % torch.clamp(m, min=1)
    order = torch.cumsum(ties.to(torch.int64), dim=1) - 1
    pick = torch.argmax((ties & (order == kth[:, None])).to(torch.int32), dim=1)
    pick = torch.where(m > 0, pick, -1).to(torch.int32)
    if nominated_row is not None:
        safe = torch.clamp(nominated_row, min=0).to(torch.int64)
        use = (nominated_row >= 0) & feasible.gather(1, safe[:, None])[:, 0]
        pick = torch.where(use, nominated_row, pick).to(torch.int32)
        best = torch.where(use, total.gather(1, safe[:, None])[:, 0], best)
    return pick, best, feasible.sum(dim=1).to(torch.int32)


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
    return torch.where(defer, -2, torch.where(valid, picks, -1)).to(torch.int32)


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


def expand_rows(src, k: int):
    """(k, ...) copies of row 0 of ``src`` (scheduler.py:44 _expand_uniform)."""
    return src[0].expand((k,) + tuple(src.shape[1:])).clone()


# -- preemption (victims.cu, preempt.cu) ---------------------------------------

I32_MAX = 2**31 - 1
# Criteria rows of preempt_eval's (5, N) output, in pickOneNodeForPreemption
# order: PDB violations, max victim priority, priority sum, victim count,
# start key.
N_CRIT = 5


def unpack_victims(buf, r: int, n_pdbs: int, pdb_words: int, v: int, inline_allowed: bool):
    """The staged (N, vu, cols) int64 victim buffer → (prio (N, v) i32, req
    (N, v, R) i64, nonzero (N, v, 2) i64, start (N, v) f64, pdb (N, v, P)
    bool, allowed (P,) i64 or None), the occupied slots padded to ``v``
    with the empty-slot sentinels (preemption.py:94 _unpack_victims)."""
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
    return (prio.contiguous(), req.contiguous(), nonzero.contiguous(), start.contiguous(),
            pdb.contiguous(), allowed)


def mate_valid(pf: dict):
    """(C,) bool: the dry-run's valid mates — ``valid``, or under the
    speculative chain ``elig & (spec_picks < 0)`` (preemption.py:155)."""
    if "valid" in pf:
        return pf["valid"]
    return pf["elig"] & (pf["spec_picks"] < 0)


def preempt_eval(state, vic, pf: dict, spec):
    """One dry-run of the chunk's representative preemptor (the first
    valid mate) against every node: (possible (N,) bool, crit (5, N) i64,
    vic_mask (N, V) bool, n_vic (N,) i32, rel (N, R) i64, relnz (N, 2) i64)
    — eval_one (preemption.py:257) in its closed form."""
    valid = mate_valid(pf)
    i0 = int(torch.argmax(valid.to(torch.int32))) if bool(valid.any()) else 0
    n, v = vic.prio.shape
    base = state.valid.clone()
    if spec.check_unsched:
        base &= ~state.unschedulable | pf["tolerates_unschedulable"][i0]
    if spec.check_nodename:
        want = pf["nodename_id"][i0]
        base &= (want == -1) | (state.name_id == want)
    if spec.bits_mask:
        base &= (pf["node_bits"][i0].to(torch.int32) & spec.bits_mask) == spec.bits_mask
    prio = pf["priority"][i0].to(torch.int32)
    demand = pf["req"][i0]
    lower = vic.prio < prio

    def ok_closed(rel_m, cnt):
        free = state.alloc - (state.req - rel_m)
        ok = ((demand[None, :] == 0) | (demand[None, :] <= free)).all(-1)
        return ok & (state.num_pods - cnt + 1 <= state.allowed_pods)

    rel = torch.where(lower[:, :, None], vic.req, 0).sum(dim=1)
    cnt = lower.sum(dim=1).to(torch.int32)
    feas_all = ok_closed(rel, cnt)
    mask = lower.clone()
    for s in range(v - 1, -1, -1):
        has = mask[:, s]
        t_rel = rel - torch.where(has[:, None], vic.req[:, s], 0)
        t_cnt = cnt - has.to(torch.int32)
        take = feas_all & ok_closed(t_rel, t_cnt) & has
        mask[:, s] &= ~take
        rel = torch.where(take[:, None], t_rel, rel)
        cnt = torch.where(take, t_cnt, cnt)
    n_vic = mask.sum(dim=1).to(torch.int32)
    possible = base & feas_all & (n_vic >= 1) & valid[i0]
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
    return possible, crit, mask, n_vic, rel, relnz


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
