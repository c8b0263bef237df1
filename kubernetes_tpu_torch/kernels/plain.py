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
from ..ops.helpers import make_topo_onehot

IPA = "InterPodAffinity"
NA, TT, PTS = "NodeAffinity", "TaintToleration", "PodTopologySpread"
# Filters eval_chunk reads from a precomputed plane instead of evaluating:
# NodeAffinity and TaintToleration from node_filters' bits 0 and 1,
# PodTopologySpread from spread_filter's mask.
EXT_FILTERS = (NA, TT, PTS)
# Pods per block of the plain node_filters (bounds its temporaries).
_NODE_FILTER_BLOCK = 256

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


def ext_filter(name: str, ext) -> torch.Tensor:
    """(C, N) bool result of an EXT_FILTERS op from its plane: ``ext`` is
    (node_bits (C, N) u8, spread_ok (C, N) bool), either may be None when
    no filter reads it."""
    node_bits, spread_ok = ext if ext is not None else (None, None)
    plane = spread_ok if name == PTS else node_bits
    if plane is None:
        raise ValueError(f"eval_chunk: {name} needs its precomputed plane")
    if name == PTS:
        return plane.to(torch.bool)
    return (plane & (1 if name == NA else 2)) != 0


def eval_chunk(state, pf: dict, spec, nom, ext=None):
    """(feasible (C, N) bool, total (C, N) i64, fail_mask (C,) i32) of one
    chunk — eval_pod's filter chain and weighted score sum (pass_.py:494-539).
    The EXT_FILTERS ops' results come from ``ext`` (see ext_filter).
    ``total`` is 0 on infeasible nodes (select_host never reads it there)."""
    ctx = dataclasses.replace(spec.ctx, nom=nom)
    c = pf["req"].shape[0]
    n = state.valid.shape[0]
    feasible = state.valid[None, :].expand(c, n).clone()
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
    return feasible, torch.where(feasible, total, 0), fail


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
    """(nchunks, C, C) bool — _conflict_pairs' hard reads (pass_.py:266-306)
    with gathers in place of the one-hot einsums: pairs[i, j] =
    reads_g[j, group[i]] ∨ ∃a hard_t[j, own[i, a]], where reads_g is
    InterPodAffinity's ipa_ra_allmask ∨ any(ipa_rs_groups) and spread's
    any(tps_h_groups) (whichever the batch carries) and hard_t =
    ipa_et_match ∧ ipa_et_anti, over the pods of one chunk, diagonal
    cleared."""
    dev = pf["valid"].device
    reads = None
    if "ipa_ra_allmask" in pf:
        reads = pf["ipa_ra_allmask"] | pf["ipa_rs_groups"].any(dim=1)
    if "tps_h_groups" in pf:
        spread = pf["tps_h_groups"].any(dim=1)
        reads = spread if reads is None else reads | spread
    g = reads.shape[1]
    reads = reads.view(nchunks, c, g)
    group = pf["group"].to(torch.int64).clamp(0, g - 1).view(nchunks, 1, c).expand(-1, c, -1)
    # reads.gather(...)[b, j, i] = reads[b, j, group[b, i]]
    pairs = reads.gather(2, group).transpose(1, 2)
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
    TaintToleration's (tainttoleration.py:52); a bit whose features the
    batch does not carry is 1.  They read only node state no commit
    changes, so one evaluation serves every chunk of the batch."""
    k, n = pf["valid"].shape[0], state.valid.shape[0]
    out = torch.empty((k, n), dtype=torch.uint8, device=state.valid.device)
    for lo in range(0, k, _NODE_FILTER_BLOCK):
        sub = {key: v[lo : lo + _NODE_FILTER_BLOCK] for key, v in pf.items()}
        m = sub["valid"].shape[0]
        na = na_op.filter_fn(state, sub, ctx) if "na_sel_pairs" in sub else torch.ones(
            (m, n), dtype=torch.bool, device=out.device)
        tt = taint_op.filter_fn(state, sub, ctx) if "taint_intol_hard" in sub else torch.ones(
            (m, n), dtype=torch.bool, device=out.device)
        out[lo : lo + m] = na.to(torch.uint8) | (tt.to(torch.uint8) << 1)
    return out


def _node_oks(node_bits):
    return (node_bits & 1) != 0, (node_bits & 2) != 0


def spread_filter(state, pf: dict, node_bits, ctx):
    """(C, N) bool: PodTopologySpread's filter (podtopologyspread.py:219)
    for one chunk, its inclusion policies read from the chunk's
    node_filters bits."""
    return spread_op.filter_fn(state, pf, ctx, *_node_oks(node_bits))


def late_scores(state, pf: dict, feasible, total, node_bits, late):
    """The scores that normalize over the final feasible set, added IN
    PLACE into ``total`` with their weights: NodeAffinity's
    (nodeaffinity.py:307), TaintToleration's reversed (tainttoleration.py:56)
    and PodTopologySpread's (podtopologyspread.py:261, inclusion policies
    from the node_filters bits); ``total`` stays 0 on infeasible nodes.
    Returns ``total``."""
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
    return torch.where(defer, -2, torch.where(valid, picks, -1)).to(torch.int32)
