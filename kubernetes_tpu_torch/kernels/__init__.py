"""The hand-written CUDA kernels of the batch pass, and their wrappers.

  build_dom       csrc/build_dom.cu       per-domain tables, once per pass
  eval_chunk      csrc/eval_chunk.cu      filters + weighted score, (C, N)
  ipa_eval        csrc/ipa_eval.cu        InterPodAffinity filter + score on top
  select_host     csrc/select_host.cu     argmax with hashed tie-break
  resolve_commit  csrc/resolve_commit.cu  chunk deferral, cumulative fit, commit
  conflict_pairs  csrc/conflict_pairs.cu  chunk-mate conflict table, per batch
  node_filters    csrc/node_filters.cu    NodeAffinity + TaintToleration filter bits, per batch
  spread_filter   csrc/spread_eval.cu     PodTopologySpread's filter, per chunk, before eval_chunk
  late_scores     csrc/spread_eval.cu     NodeAffinity, TaintToleration and spread scores over the
                                          final feasible set, per chunk, after ipa_eval

Each wrapper checks its inputs and launches its kernel on the current CUDA
stream for tensors on a CUDA device, or runs the plain version
(kernels/plain.py) for tensors on the CPU.  There is no fallback: on a CUDA
tensor it launches or raises.  ``<wrapper>.launches`` counts the launches
(reset with ``reset_launches``), so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from ..framework.config import LEAST_ALLOCATED, MOST_ALLOCATED
from ..ops.helpers import log_table
from . import build, plain

# Filter codes of eval_chunk (2 bits each, packed in fail-bit order).  Code
# 3 reads a precomputed plane, chosen by a second 2-bit field (_EXT_SEL):
# node_filters' bit 0 (NodeAffinity) or 1 (TaintToleration), or
# spread_filter's mask (PodTopologySpread).
_EXT_SEL = {name: i for i, name in enumerate(plain.EXT_FILTERS)}
_FILTER_CODES = {"NodeUnschedulable": 0, "NodeName": 1, "NodeResourcesFit": 2, **dict.fromkeys(_EXT_SEL, 3)}
_SCORERS = ("NodeResourcesFit", "NodeResourcesBalancedAllocation")
_MAX_BALANCED = 8
_MAX_CHUNK = 64
# Shared memory an ipa_eval block may use for its per-pod tables (of the
# H100's 227 KB a block can have).
IPA_SMEM_CAP = 200 * 1024
# The same for a spread_filter or late_scores block's domain tables.
SPREAD_SMEM_CAP = 200 * 1024


@dataclass
class EvalSpec:
    """What eval_chunk evaluates for one compiled pass: the pass context
    (profile, schema, static op config), the active filters in fail-bit
    order and the active (scorer, weight) pairs."""

    ctx: object  # ops.common.PassContext
    filters: tuple[str, ...]
    scorers: tuple[tuple[str, int], ...]
    _device_config: dict = field(default_factory=dict)

    def device_config(self, device: torch.device) -> dict:
        """eval_chunk's static arguments, built once per device."""
        cfg = self._device_config.get(device)
        if cfg is None:
            cfg = _eval_config(self, device)
            self._device_config[device] = cfg
        return cfg


@dataclass(frozen=True)
class IpaSpec:
    """What ipa_eval applies on top of eval_chunk for one pass: the pass
    context (its ``dom`` bound to the pass's domain tables), every active
    filter in fail-bit order (InterPodAffinity's bit is its position) and
    the op's score weight (0 when it does not score)."""

    ctx: object  # ops.common.PassContext
    filters: tuple[str, ...]
    weight: int


@dataclass(frozen=True)
class LateSpec:
    """What late_scores adds after the filters for one pass: the pass
    context and the score weights of NodeAffinity, TaintToleration and
    PodTopologySpread (0 for an op that does not score in this pass)."""

    ctx: object  # ops.common.PassContext
    na_weight: int
    taint_weight: int
    spread_weight: int


def spread_smem_bytes(k: int, dv: int) -> int:
    """Dynamic shared memory of one spread_filter or late_scores block with
    ``k`` constraints: the (K, DV) count and presence tables and the
    per-constraint scalars.  Raises NotImplementedError above
    SPREAD_SMEM_CAP: such a pass needs the tables in device memory, which
    these kernels do not do."""
    nbytes = 8 * k + 8 * 4 + 4 * (2 * k * dv + 3 * k + 1)
    if nbytes > SPREAD_SMEM_CAP:
        raise NotImplementedError(
            f"spread_eval: {nbytes} bytes of per-pod domain tables exceed its shared-memory cap "
            f"SPREAD_SMEM_CAP={SPREAD_SMEM_CAP} ({k} constraints, DV={dv})"
        )
    return nbytes


def ipa_smem_bytes(ra: int, rs: int, pf: int, tk: int, dv: int) -> int:
    """Dynamic shared memory of one ipa_eval block: the own-term tallies
    ((RA+RS+PF) x DV), the forbidden and weighted tables (2 x TK x DV) and
    the list lengths, as int32.  Raises NotImplementedError above
    IPA_SMEM_CAP: such a pass needs the tables in device memory, which
    this kernel does not do."""
    nbytes = 4 * ((ra + rs + pf) * dv + 2 * tk * dv + (1 + rs + pf) + 2)
    if nbytes > IPA_SMEM_CAP:
        raise NotImplementedError(
            f"ipa_eval: {nbytes} bytes of per-pod tables exceed its shared-memory cap "
            f"IPA_SMEM_CAP={IPA_SMEM_CAP} (terms {ra}+{rs}+{pf}, TK={tk}, DV={dv})"
        )
    return nbytes


def _eval_config(spec: EvalSpec, device: torch.device) -> dict:
    unknown = [n for n in spec.filters if n not in _FILTER_CODES]
    unknown += [n for n, _ in spec.scorers if n not in _SCORERS]
    if unknown:
        raise NotImplementedError(f"eval_chunk kernel does not evaluate {unknown}")
    if len(spec.filters) > 15:
        raise ValueError("eval_chunk packs at most 15 filters")
    weights = dict(spec.scorers)
    static = spec.ctx.static
    profile = spec.ctx.profile
    strategy = profile.scoring_strategy.type
    if "NodeResourcesFit" in weights and strategy not in (LEAST_ALLOCATED, MOST_ALLOCATED):
        raise NotImplementedError(f"eval_chunk kernel: scoring strategy {strategy} is not yet ported")
    r = spec.ctx.schema.R
    ignored = torch.zeros(r, dtype=torch.bool)
    for col in static.get("fit_ignored_cols", ()):
        ignored[col] = True
    strat = static.get("fit_strategy_cols", ())
    bal = static.get("balanced_cols", ())
    if len(bal) > _MAX_BALANCED:
        raise NotImplementedError(f"eval_chunk kernel: more than {_MAX_BALANCED} balanced resources")
    codes = ext_sel = 0
    for b, name in enumerate(spec.filters):
        codes |= _FILTER_CODES[name] << (2 * b)
        ext_sel |= _EXT_SEL.get(name, 0) << (2 * b)
    return {
        "R": r,
        "fit_ignored": ignored.to(device),
        "strat_cols": torch.tensor(
            [list(s) for s in strat] or [[0, 0, 0]], dtype=torch.int64
        ).to(device),
        "n_strat": len(strat),
        "most_allocated": int(strategy == MOST_ALLOCATED),
        "bal_cols": torch.tensor([c for (c,) in bal] or [0], dtype=torch.int32).to(device),
        "n_bal": len(bal),
        "score_fit": int("NodeResourcesFit" in weights),
        "fit_weight": int(weights.get("NodeResourcesFit", 0)),
        "score_bal": int("NodeResourcesBalancedAllocation" in weights),
        "bal_weight": int(weights.get("NodeResourcesBalancedAllocation", 0)),
        "filter_codes": codes,
        "ext_sel": ext_sel,
        "n_filters": len(spec.filters),
        "node_bits": any(n in (plain.NA, plain.TT) for n in spec.filters),
        "spread": plain.PTS in spec.filters,
    }


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return False


def build_dom(state, et_slot, dv: int):
    """(group_dom (G, TK, DV) f32, et_dom (ET, DV) f32): the per-domain
    aggregate tables of the state's group and term carrier counts."""
    if _on_cpu(state.group_counts):
        return plain.build_dom(state, et_slot, dv)
    dev = state.group_counts.device
    g, n = state.group_counts.shape
    et = state.et_counts.shape[0]
    tk = state.topo_vals.shape[1]
    i32 = torch.int32
    args = [
        _check("group_counts", state.group_counts, i32, (g, n), dev),
        _check("et_counts", state.et_counts, i32, (et, n), dev),
        _check("topo_vals", state.topo_vals, i32, (n, tk), dev),
        _check("et_slot", et_slot, i32, (et,), dev),
    ]
    group_dom = torch.empty((g, tk, dv), dtype=torch.float32, device=dev)
    et_dom = torch.empty((et, dv), dtype=torch.float32, device=dev)
    build.launch(
        "build_dom", *[_ptr(a) for a in args], g, et, n, tk, dv, _ptr(group_dom), _ptr(et_dom),
        _stream(dev),
    )
    build_dom.launches += 1
    return group_dom, et_dom


def eval_chunk(state, pf: dict, spec: EvalSpec, nom, ext=None):
    """Filters + weighted score of one chunk: (feasible (C, N) bool,
    total (C, N) i64, fail_mask (C,) i32).  ``nom`` is the nominated-pod
    overlay (nom_req, nom_cnt, nom_prio) or None; ``ext`` is (node_bits
    (C, N) u8, spread_ok (C, N) bool), the precomputed planes of
    NodeAffinity, TaintToleration and PodTopologySpread (either None when
    no active filter reads it)."""
    if _on_cpu(state.valid):
        return plain.eval_chunk(state, pf, spec, nom, ext)
    dev = state.valid.device
    cfg = spec.device_config(dev)
    n = state.valid.shape[0]
    r = cfg["R"]
    c = pf["req"].shape[0]
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    args = [
        _check("valid", state.valid, b, (n,), dev),
        _check("name_id", state.name_id, i32, (n,), dev),
        _check("unschedulable", state.unschedulable, b, (n,), dev),
        _check("num_pods", state.num_pods, i32, (n,), dev),
        _check("allowed_pods", state.allowed_pods, i32, (n,), dev),
        _check("alloc", state.alloc, i64, (n, r), dev),
        _check("req", state.req, i64, (n, r), dev),
        _check("nonzero_req", state.nonzero_req, i64, (n, 2), dev),
    ]
    if nom is not None:
        args += [
            _check("nom_req", nom[0], i64, (n, r), dev),
            _check("nom_cnt", nom[1], i32, (n,), dev),
            _check("nom_prio", nom[2], i32, (n,), dev),
        ]
    else:
        args += [None, None, None]
    # Pod features the kernel reads for this spec; the others may be absent
    # and go in as null pointers.
    needed = {
        "nodename_id": "NodeName" in spec.filters,
        "tolerates_unschedulable": "NodeUnschedulable" in spec.filters,
        "req": True,
        "nonzero": True,
        "priority": nom is not None,
        "nominated_row": nom is not None,
    }
    feats = []
    for key, dtype, shape in (
        ("nodename_id", i32, (c,)),
        ("tolerates_unschedulable", b, (c,)),
        ("req", i64, (c, r)),
        ("nonzero", i64, (c, 2)),
        ("priority", i32, (c,)),
        ("nominated_row", i32, (c,)),
    ):
        t = pf.get(key)
        if t is None and needed[key]:
            raise ValueError(f"eval_chunk: pod feature {key!r} missing")
        feats.append(None if t is None else _check(key, t, dtype, shape, dev))
    node_bits, spread_ok = ext if ext is not None else (None, None)
    planes = []
    for name, t, dtype, want in (("node_bits", node_bits, torch.uint8, cfg["node_bits"]),
                                 ("spread_ok", spread_ok, b, cfg["spread"])):
        if want and t is None:
            raise ValueError(f"eval_chunk: plane {name!r} missing")
        planes.append(_check(name, t, dtype, (c, n), dev) if want else None)
    feasible = torch.empty((c, n), dtype=b, device=dev)
    total = torch.empty((c, n), dtype=i64, device=dev)
    fail = torch.zeros(c, dtype=i32, device=dev)
    build.launch(
        "eval_chunk",
        *[_ptr(a) for a in args],
        *[_ptr(a) for a in feats],
        *[_ptr(a) for a in planes],
        _ptr(cfg["fit_ignored"]),
        _ptr(cfg["strat_cols"]), cfg["n_strat"], cfg["most_allocated"],
        _ptr(cfg["bal_cols"]), cfg["n_bal"],
        cfg["score_fit"], cfg["fit_weight"], cfg["score_bal"], cfg["bal_weight"],
        cfg["filter_codes"], cfg["n_filters"], cfg["ext_sel"], c, n, r,
        _ptr(feasible), _ptr(total), _ptr(fail), _stream(dev),
    )
    eval_chunk.launches += 1
    return feasible, total, fail


def ipa_eval(state, pf: dict, feasible, total, fail, ipa: IpaSpec):
    """InterPodAffinity's filter and score on top of eval_chunk's
    (feasible (C, N) bool, total (C, N) i64, fail_mask (C,) i32), IN PLACE;
    returns the three tensors.  The domain tables come from
    ``ipa.ctx.dom``."""
    if _on_cpu(feasible):
        return plain.ipa_eval(state, pf, feasible, total, fail, ipa)
    bit = plain.ipa_bit(ipa)
    dom = ipa.ctx.dom
    dev = feasible.device
    c, n = feasible.shape
    tk = state.topo_vals.shape[1]
    g = state.group_counts.shape[0]
    et = state.et_counts.shape[0]
    dv = dom.group_dom.shape[2]
    ra, rs, npf = (pf[f"ipa_{p}_valid"].shape[1] for p in ("ra", "rs", "pf"))
    smem = ipa_smem_bytes(ra, rs, npf, tk, dv)
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    node_args = [
        _check("topo_vals", state.topo_vals, i32, (n, tk), dev),
        _check("group_counts", state.group_counts, i32, (g, n), dev),
        _check("et_counts", state.et_counts, i32, (et, n), dev),
        _check("group_dom", dom.group_dom, torch.float32, (g, tk, dv), dev),
        _check("et_dom", dom.et_dom, torch.float32, (et, dv), dev),
        _check("et_slot", dom.et_slot, i32, (et,), dev),
        _check("et_host", dom.et_host, b, (et,), dev),
    ]
    pod_args = []
    for key, dtype, shape in (
        ("ipa_ra_valid", b, (c, ra)), ("ipa_ra_slot", i32, (c, ra)), ("ipa_ra_host", b, (c, ra)),
        ("ipa_ra_allmask", b, (c, g)), ("ipa_ra_self", b, (c,)),
        ("ipa_rs_valid", b, (c, rs)), ("ipa_rs_slot", i32, (c, rs)), ("ipa_rs_host", b, (c, rs)),
        ("ipa_rs_groups", b, (c, rs, g)),
        ("ipa_pf_valid", b, (c, npf)), ("ipa_pf_slot", i32, (c, npf)), ("ipa_pf_host", b, (c, npf)),
        ("ipa_pf_groups", b, (c, npf, g)), ("ipa_pf_w", i64, (c, npf)),
        ("ipa_et_match", b, (c, et)), ("ipa_et_anti", b, (c, et)), ("ipa_et_w", i64, (c, et)),
    ):
        pod_args.append(_check(key, pf[key], dtype, shape, dev))
    _check("feasible", feasible, b, (c, n), dev)
    _check("total", total, i64, (c, n), dev)
    _check("fail_mask", fail, i32, (c,), dev)
    glist = torch.empty((c, 1 + rs + npf, g), dtype=i32, device=dev)
    elist = torch.empty((c, 2, et), dtype=i32, device=dev)
    raw = torch.empty((c, n), dtype=i64, device=dev)
    build.launch(
        "ipa_eval", c, n, tk, dv, g, et, ra, rs, npf, bit, int(ipa.weight),
        *[_ptr(a) for a in node_args], *[_ptr(a) for a in pod_args],
        _ptr(feasible), _ptr(total), _ptr(fail), _ptr(glist), _ptr(elist), _ptr(raw),
        smem, _stream(dev),
    )
    ipa_eval.launches += 1
    return feasible, total, fail


def conflict_pairs(pf: dict, nchunks: int, c: int):
    """(nchunks, C, C) bool chunk-mate conflict table of a batch whose pods
    carry inter-pod-affinity or topology-spread features (or both)."""
    if _on_cpu(pf["valid"]):
        return plain.conflict_pairs(pf, nchunks, c)
    dev = pf["valid"].device
    k = nchunks * c
    ipa, spread = "ipa_ra_allmask" in pf, "tps_h_groups" in pf
    if not (ipa or spread):
        raise ValueError("conflict_pairs: the batch carries no affinity or spread features")
    g = pf["ipa_ra_allmask"].shape[1] if ipa else pf["tps_h_groups"].shape[2]
    rs = pf["ipa_rs_groups"].shape[1] if ipa else 0
    et = pf["ipa_et_match"].shape[1] if ipa else 0
    a = pf["ipa_own_terms"].shape[1] if ipa else 0
    ch = pf["tps_h_groups"].shape[1] if spread else 0
    args = [_check("group", pf["group"], torch.int32, (k,), dev)]
    for key, dtype, shape, on in (
        ("ipa_ra_allmask", torch.bool, (k, g), ipa),
        ("ipa_rs_groups", torch.bool, (k, rs, g), ipa),
        ("ipa_et_match", torch.bool, (k, et), ipa),
        ("ipa_et_anti", torch.bool, (k, et), ipa),
        ("ipa_own_terms", torch.int32, (k, a), ipa),
        ("tps_h_groups", torch.bool, (k, ch, g), spread),
    ):
        args.append(_check(key, pf[key], dtype, shape, dev) if on else None)
    pairs = torch.empty((nchunks, c, c), dtype=torch.bool, device=dev)
    build.launch(
        "conflict_pairs", *[_ptr(x) for x in args], nchunks, c, g, rs, et, a, ch, _ptr(pairs),
        _stream(dev),
    )
    conflict_pairs.launches += 1
    return pairs


def select_host(feasible, total, steps, seed_mul: int, nominated_row):
    """(pick (C,) i32, best (C,) i64, feasible count (C,) i32) per pod."""
    if _on_cpu(feasible):
        return plain.select_host(feasible, total, steps, seed_mul, nominated_row)
    dev = feasible.device
    c, n = feasible.shape
    _check("feasible", feasible, torch.bool, (c, n), dev)
    _check("total", total, torch.int64, (c, n), dev)
    _check("steps", steps, torch.int64, (c,), dev)
    if nominated_row is not None:
        _check("nominated_row", nominated_row, torch.int32, (c,), dev)
    pick = torch.empty(c, dtype=torch.int32, device=dev)
    best = torch.empty(c, dtype=torch.int64, device=dev)
    feas = torch.empty(c, dtype=torch.int32, device=dev)
    build.launch(
        "select_host",
        _ptr(feasible), _ptr(total), _ptr(steps), seed_mul & 0xFFFFFFFF,
        _ptr(nominated_row), c, n, _ptr(pick), _ptr(best), _ptr(feas), _stream(dev),
    )
    select_host.launches += 1
    return pick, best, feas


def resolve_commit(state, dom, pf: dict, picks, pairs, strict: bool):
    """Chunk deferral, cumulative fit and commit, in place on ``state`` and
    the domain tables ``dom`` (group_dom, et_dom); returns the output picks
    (C,) i32."""
    if _on_cpu(picks):
        return plain.resolve_commit(state, dom, pf, picks, pairs, strict)
    group_dom = dom.group_dom
    dev = picks.device
    c = picks.shape[0]
    if not 1 <= c <= _MAX_CHUNK:
        raise ValueError(f"resolve_commit: chunk {c} outside [1, {_MAX_CHUNK}]")
    n, r = state.alloc.shape
    g = state.group_counts.shape[0]
    tk = state.topo_vals.shape[1]
    dv = group_dom.shape[2]
    i32, i64 = torch.int32, torch.int64
    _check("picks", picks, i32, (c,), dev)
    _check("valid", pf["valid"], torch.bool, (c,), dev)
    _check("pairs", pairs, torch.bool, (c, c), dev)
    _check("req", pf["req"], i64, (c, r), dev)
    _check("nonzero", pf["nonzero"], i64, (c, 2), dev)
    _check("group", pf["group"], i32, (c,), dev)
    _check("state.req", state.req, i64, (n, r), dev)
    _check("state.nonzero_req", state.nonzero_req, i64, (n, 2), dev)
    _check("state.num_pods", state.num_pods, i32, (n,), dev)
    _check("state.allowed_pods", state.allowed_pods, i32, (n,), dev)
    _check("state.group_counts", state.group_counts, i32, (g, n), dev)
    _check("state.topo_vals", state.topo_vals, i32, (n, tk), dev)
    _check("group_dom", group_dom, torch.float32, (g, tk, dv), dev)
    et = state.et_counts.shape[0]
    _check("state.et_counts", state.et_counts, i32, (et, n), dev)
    _check("et_dom", dom.et_dom, torch.float32, (et, dv), dev)
    _check("et_slot", dom.et_slot, i32, (et,), dev)
    own = pf.get("ipa_own_terms")  # None: no pod carries terms to commit
    na = 0 if own is None else own.shape[1]
    if own is not None:
        _check("ipa_own_terms", own, i32, (c, na), dev)
    out = torch.empty(c, dtype=i32, device=dev)
    build.launch(
        "resolve_commit",
        _ptr(picks), _ptr(pf["valid"]), _ptr(pairs), int(strict),
        _ptr(pf["req"]), _ptr(pf["nonzero"]), _ptr(pf["group"]),
        _ptr(state.alloc), _ptr(state.req), _ptr(state.nonzero_req),
        _ptr(state.num_pods), _ptr(state.allowed_pods), _ptr(state.group_counts),
        _ptr(group_dom), _ptr(state.topo_vals), _ptr(own), _ptr(state.et_counts),
        _ptr(dom.et_dom), _ptr(dom.et_slot), c, n, r, tk, dv, na,
        _ptr(out), _stream(dev),
    )
    resolve_commit.launches += 1
    return out


def _program(pf: dict, prefix: str, c: int, dev, weight: bool = False) -> tuple[list, tuple]:
    """A NodeAffinity requirement program's tensors, checked: (op, key,
    vals, int, term_valid or weight) and its (T, Q, V)."""
    t_, q_, v_ = pf[f"{prefix}_vals"].shape[1:]
    last = ("weight", torch.int64) if weight else ("term_valid", torch.bool)
    out = [
        _check(f"{prefix}_op", pf[f"{prefix}_op"], torch.int32, (c, t_, q_), dev),
        _check(f"{prefix}_key", pf[f"{prefix}_key"], torch.int32, (c, t_, q_), dev),
        _check(f"{prefix}_vals", pf[f"{prefix}_vals"], torch.int32, (c, t_, q_, v_), dev),
        _check(f"{prefix}_int", pf[f"{prefix}_int"], torch.int64, (c, t_, q_), dev),
        _check(f"{prefix}_{last[0]}", pf[f"{prefix}_{last[0]}"], last[1], (c, t_), dev),
    ]
    return out, (t_, q_, v_)


def _label_args(state, dev) -> list:
    n, ls = state.label_key_ids.shape
    return [
        _check("label_key_ids", state.label_key_ids, torch.int32, (n, ls), dev),
        _check("label_pair_ids", state.label_pair_ids, torch.int32, (n, ls), dev),
        _check("label_int_vals", state.label_int_vals, torch.int64, (n, ls), dev),
        _check("name_id", state.name_id, torch.int32, (n,), dev),
        _check("taint_ids", state.taint_ids, torch.int32, (n, state.taint_ids.shape[1]), dev),
    ]


def node_filters(state, pf: dict, ctx):
    """(K, N) u8 per-batch node filter bits of a batch's K pods: bit 0
    NodeAffinity's filter (with ``ctx.profile``'s added affinity), bit 1
    TaintToleration's; a bit whose features the batch lacks is 1."""
    if _on_cpu(state.valid):
        return plain.node_filters(state, pf, ctx)
    dev = state.valid.device
    k, n = pf["valid"].shape[0], state.valid.shape[0]
    ls, ts = state.label_key_ids.shape[1], state.taint_ids.shape[1]
    do_na = "na_sel_pairs" in pf
    do_add = do_na and ctx.profile.added_affinity is not None
    do_taint = "taint_intol_hard" in pf
    none5 = [None] * 5
    sel, has_req, req, req_dims = None, None, none5, (1, 1, 1)
    has_add, add, add_dims = None, none5, (1, 1, 1)
    s = 1
    if do_na:
        s = pf["na_sel_pairs"].shape[1]
        sel = _check("na_sel_pairs", pf["na_sel_pairs"], torch.int32, (k, s), dev)
        has_req = _check("na_has_required", pf["na_has_required"], torch.bool, (k,), dev)
        req, req_dims = _program(pf, "na_req", k, dev)
    if do_add:
        has_add = _check("na_has_added", pf["na_has_added"], torch.bool, (k,), dev)
        add, add_dims = _program(pf, "na_add", k, dev)
    tv = pf["taint_intol_hard"].shape[1] if do_taint else 1
    intol = _check("taint_intol_hard", pf["taint_intol_hard"], torch.bool, (k, tv), dev) if do_taint else None
    out = torch.empty((k, n), dtype=torch.uint8, device=dev)
    build.launch(
        "node_filters",
        *[_ptr(a) for a in _label_args(state, dev)],
        _ptr(sel), _ptr(has_req), *[_ptr(a) for a in req],
        _ptr(has_add), *[_ptr(a) for a in add],
        _ptr(intol), _ptr(out),
        n, ls, ts, k, s, *req_dims, *add_dims, tv, int(do_na), int(do_add), int(do_taint),
        _stream(dev),
    )
    node_filters.launches += 1
    return out


_SPREAD_FEATURES = (
    ("valid", torch.bool), ("slot", torch.int32), ("skew", torch.int32),
    ("mindom", torch.int32), ("self", torch.bool), ("hostname", torch.bool),
    ("aff", torch.bool), ("taint", torch.bool),
)


def _spread_args(state, pf: dict, prefix: str, c: int, dev) -> tuple[list, int]:
    """A chunk's spread constraint features and the group masks, checked."""
    k = pf[f"{prefix}_valid"].shape[1]
    g = state.group_counts.shape[0]
    out = [_check(f"{prefix}_{f}", pf[f"{prefix}_{f}"], dtype, (c, k), dev) for f, dtype in _SPREAD_FEATURES]
    out.append(_check(f"{prefix}_groups", pf[f"{prefix}_groups"], torch.bool, (c, k, g), dev))
    return out, k


def spread_filter(state, pf: dict, node_bits, ctx):
    """(C, N) bool: PodTopologySpread's filter for one chunk, the inclusion
    policies read from the chunk's node_filters bits (C, N)."""
    if _on_cpu(state.valid):
        return plain.spread_filter(state, pf, node_bits, ctx)
    dev = state.valid.device
    n, tk = state.topo_vals.shape
    g = state.group_counts.shape[0]
    dv = ctx.schema.DV
    c = pf["valid"].shape[0]
    feats, ch = _spread_args(state, pf, "tps_h", c, dev)
    smem = spread_smem_bytes(ch, dv)
    node = [
        _check("topo_vals", state.topo_vals, torch.int32, (n, tk), dev),
        _check("valid", state.valid, torch.bool, (n,), dev),
        _check("group_counts", state.group_counts, torch.int32, (g, n), dev),
        _check("node_bits", node_bits, torch.uint8, (c, n), dev),
    ]
    glist = torch.empty((c, ch, g), dtype=torch.int32, device=dev)
    out = torch.empty((c, n), dtype=torch.bool, device=dev)
    build.launch(
        "spread_filter", *[_ptr(a) for a in node], *[_ptr(a) for a in feats], _ptr(glist), _ptr(out),
        c, n, tk, dv, g, ch, smem, _stream(dev),
    )
    spread_filter.launches += 1
    return out


def late_scores(state, pf: dict, feasible, total, node_bits, late: LateSpec):
    """Adds NodeAffinity's, TaintToleration's and PodTopologySpread's
    weighted scores, normalized over the final ``feasible`` (C, N), into
    ``total`` (C, N) i64 IN PLACE (0 stays on infeasible nodes); spread's
    inclusion policies read the node_filters bits.  Returns ``total``."""
    if _on_cpu(feasible):
        return plain.late_scores(state, pf, feasible, total, node_bits, late)
    dev = feasible.device
    c, n = feasible.shape
    tk = state.topo_vals.shape[1]
    g = state.group_counts.shape[0]
    ls, ts = state.label_key_ids.shape[1], state.taint_ids.shape[1]
    dv = late.ctx.schema.DV
    _check("feasible", feasible, torch.bool, (c, n), dev)
    _check("total", total, torch.int64, (c, n), dev)
    node = _label_args(state, dev) + [
        _check("topo_vals", state.topo_vals, torch.int32, (n, tk), dev),
        _check("valid", state.valid, torch.bool, (n,), dev),
        _check("group_counts", state.group_counts, torch.int32, (g, n), dev),
    ]
    pref, dims = [None] * 5, (1, 1, 1)
    if late.na_weight:
        pref, dims = _program(pf, "na_pref", c, dev, weight=True)
    tv = 1
    intol = None
    if late.taint_weight:
        tv = pf["taint_intol_pref"].shape[1]
        intol = _check("taint_intol_pref", pf["taint_intol_pref"], torch.bool, (c, tv), dev)
    soft, cs = [None] * 9, 0
    table, nb = None, None
    if late.spread_weight:
        soft, cs = _spread_args(state, pf, "tps_s", c, dev)
        table = log_table(max(n, dv), dev)
        nb = _check("node_bits", node_bits, torch.uint8, (c, n), dev)
    smem = spread_smem_bytes(cs, dv)
    glist = torch.empty((c, max(cs, 1), g), dtype=torch.int32, device=dev)
    raw = torch.empty((3, c, n), dtype=torch.int64, device=dev)
    build.launch(
        "late_scores",
        *[_ptr(a) for a in node], _ptr(nb), _ptr(feasible), _ptr(total),
        *[_ptr(a) for a in pref], _ptr(intol), *[_ptr(a) for a in soft], _ptr(table),
        _ptr(glist), _ptr(raw),
        c, n, ls, ts, tk, dv, g, *dims, tv, cs, max(n, dv) + 1,
        int(late.na_weight), int(late.taint_weight), int(late.spread_weight), smem, _stream(dev),
    )
    late_scores.launches += 1
    return total


WRAPPERS = {
    "build_dom": build_dom,
    "eval_chunk": eval_chunk,
    "ipa_eval": ipa_eval,
    "select_host": select_host,
    "resolve_commit": resolve_commit,
    "conflict_pairs": conflict_pairs,
    "node_filters": node_filters,
    "spread_filter": spread_filter,
    "late_scores": late_scores,
}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
