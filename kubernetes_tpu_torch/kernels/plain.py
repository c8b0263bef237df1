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
from ..ops.helpers import make_topo_onehot

IPA = "InterPodAffinity"

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


def eval_chunk(state, pf: dict, spec, nom):
    """(feasible (C, N) bool, total (C, N) i64, fail_mask (C,) i32) of one
    chunk — eval_pod's filter chain and weighted score sum (pass_.py:494-539).
    ``total`` is 0 on infeasible nodes (select_host never reads it there)."""
    ctx = dataclasses.replace(spec.ctx, nom=nom)
    c = pf["req"].shape[0]
    n = state.valid.shape[0]
    feasible = state.valid[None, :].expand(c, n).clone()
    fail = torch.zeros(c, dtype=torch.int32, device=feasible.device)
    for bit, name in enumerate(spec.filters):
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
    """(nchunks, C, C) bool — _conflict_pairs' affinity terms
    (pass_.py:287-306) with gathers in place of the one-hot einsums:
    pairs[i, j] = reads_g[j, group[i]] ∨ ∃a hard_t[j, own[i, a]], where
    reads_g = ipa_ra_allmask ∨ any(ipa_rs_groups) and hard_t = ipa_et_match
    ∧ ipa_et_anti, over the pods of one chunk, diagonal cleared."""
    dev = pf["valid"].device
    g = pf["ipa_ra_allmask"].shape[1]
    reads = (pf["ipa_ra_allmask"] | pf["ipa_rs_groups"].any(dim=1)).view(nchunks, c, g)
    group = pf["group"].to(torch.int64).clamp(0, g - 1).view(nchunks, 1, c).expand(-1, c, -1)
    # reads.gather(...)[b, j, i] = reads[b, j, group[b, i]]
    pairs = reads.gather(2, group).transpose(1, 2)
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
