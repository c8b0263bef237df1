"""The hand-written CUDA kernels of the batch pass, and their wrappers.

  build_dom       csrc/build_dom.cu       per-domain tables, once per pass
  eval_chunk      csrc/eval_chunk.cu      filters + weighted score, (C, N)
  ipa_eval        csrc/ipa_eval.cu        InterPodAffinity filter + score on top
  select_host     csrc/select_host.cu     argmax with hashed tie-break
  resolve_commit  csrc/resolve_commit.cu  chunk deferral, cumulative fit, commit
  conflict_pairs  csrc/conflict_pairs.cu  chunk-mate conflict table, per batch
  node_filters    csrc/node_filters.cu    NodeAffinity, TaintToleration, VolumeBinding and VolumeZone
                                          filter bits, per batch
  spread_filter   csrc/spread_eval.cu     PodTopologySpread's filter, per chunk, before eval_chunk
  late_scores     csrc/spread_eval.cu     NodeAffinity, TaintToleration and spread scores over the
                                          final feasible set, per chunk, after ipa_eval
  vol_filter      csrc/volume_filters.cu  VolumeRestrictions + NodeVolumeLimits filter bits, per
                                          chunk, before eval_chunk
  preempt_eval    csrc/preempt.cu         preemption dry-run of a chunk's representative, per node
  preempt_pick    csrc/preempt.cu         lexicographic node rank and each mate's pick
  preempt_commit  csrc/preempt.cu         release at the picked rows, victims consumed
  unpack_victims  csrc/victims.cu         staged victim buffer → per-field arrays
  scatter_rows    csrc/rows.cu            dirty node rows of a device tensor ← host rows
  expand_rows     csrc/rows.cu            row 0 broadcast to K rows (uniform batches)

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
from typing import NamedTuple

import torch

from ..framework.config import LEAST_ALLOCATED, MOST_ALLOCATED
from ..ops.helpers import log_table
from . import build, plain

# Filter codes of eval_chunk (2 bits each, packed in fail-bit order).  Code
# 3 reads a precomputed plane, chosen by a second 3-bit field (_EXT_SEL):
# node_filters' bits 0-3 (NodeAffinity, TaintToleration, VolumeBinding,
# VolumeZone), vol_filter's bits 0-1 (VolumeRestrictions, NodeVolumeLimits)
# or spread_filter's mask (PodTopologySpread).
_PLANE_BASE = {"node_bits": 0, "vol_bits": 4, "spread_ok": 6}
_EXT_SEL = {name: _PLANE_BASE[plane] + bit for name, (plane, bit) in plain.PLANE_BITS.items()}
_FILTER_CODES = {"NodeUnschedulable": 0, "NodeName": 1, "NodeResourcesFit": 2, **dict.fromkeys(_EXT_SEL, 3)}
_SCORERS = ("NodeResourcesFit", "NodeResourcesBalancedAllocation")
_MAX_BALANCED = 8
MAX_CHUNK = 1024  # resolve_commit: one block, one thread per pod
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
        ext_sel |= _EXT_SEL.get(name, 0) << (3 * b)
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
        "node_bits": any(plain.PLANE_BITS.get(n, ("",))[0] == "node_bits" for n in spec.filters),
        "spread": plain.PTS in spec.filters,
        "vol_bits": any(plain.PLANE_BITS.get(n, ("",))[0] == "vol_bits" for n in spec.filters),
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


def eval_chunk(state, pf: dict, spec: EvalSpec, nom, ext=None, pin=None):
    """Filters + weighted score of one chunk: (feasible (C, N) bool,
    total (C, N) i64, fail_mask (C,) i32).  ``nom`` is the nominated-pod
    overlay (nom_req, nom_cnt, nom_prio) or None; ``ext`` is (node_bits
    (C, N) u8, spread_ok (C, N) bool[, vol_bits (C, N) u8]), the
    precomputed planes of the ops in plain.PLANE_BITS (any None when no
    active filter reads it).  With ``pin`` ((C,) i32 rows in [0, N)),
    pod c is evaluated on node pin[c] alone: feasible and total are
    (C, 1) and the fail bits are those of that node."""
    if _on_cpu(state.valid):
        return plain.eval_chunk(state, pf, spec, nom, ext, pin)
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
    given = plain.ext_planes(ext)
    planes = []
    for name, dtype, want in (("node_bits", torch.uint8, cfg["node_bits"]),
                              ("spread_ok", b, cfg["spread"]),
                              ("vol_bits", torch.uint8, cfg["vol_bits"])):
        t = given[name]
        if want and t is None:
            raise ValueError(f"eval_chunk: plane {name!r} missing")
        planes.append(_check(name, t, dtype, (c, n), dev) if want else None)
    width = n
    if pin is not None:
        planes.append(_check("pin", pin, i32, (c,), dev))
        width = 1
    else:
        planes.append(None)
    feasible = torch.empty((c, width), dtype=b, device=dev)
    total = torch.empty((c, width), dtype=i64, device=dev)
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
    carry inter-pod-affinity, topology-spread or volume-id features."""
    if _on_cpu(pf["valid"]):
        return plain.conflict_pairs(pf, nchunks, c)
    dev = pf["valid"].device
    k = nchunks * c
    ipa, spread = "ipa_ra_allmask" in pf, "tps_h_groups" in pf
    vdev, vcsi, vunb = "vol_dev_ids" in pf, "vol_csi_ids" in pf, "vol_unbound" in pf
    if not (ipa or spread or vdev or vcsi or vunb):
        raise ValueError("conflict_pairs: the batch carries no affinity, spread or volume features")
    g = pf["ipa_ra_allmask"].shape[1] if ipa else (pf["tps_h_groups"].shape[2] if spread else 0)
    rs = pf["ipa_rs_groups"].shape[1] if ipa else 0
    et = pf["ipa_et_match"].shape[1] if ipa else 0
    a = pf["ipa_own_terms"].shape[1] if ipa else 0
    ch = pf["tps_h_groups"].shape[1] if spread else 0
    sd = pf["vol_dev_ids"].shape[1] if vdev else 0
    sc = pf["vol_csi_ids"].shape[1] if vcsi else 0
    args = [_check("group", pf["group"], torch.int32, (k,), dev)]
    for key, dtype, shape, on in (
        ("ipa_ra_allmask", torch.bool, (k, g), ipa),
        ("ipa_rs_groups", torch.bool, (k, rs, g), ipa),
        ("ipa_et_match", torch.bool, (k, et), ipa),
        ("ipa_et_anti", torch.bool, (k, et), ipa),
        ("ipa_own_terms", torch.int32, (k, a), ipa),
        ("tps_h_groups", torch.bool, (k, ch, g), spread),
        ("vol_dev_ids", torch.int32, (k, sd), vdev),
        ("vol_csi_ids", torch.int32, (k, sc), vcsi),
        ("vol_unbound", torch.bool, (k,), vunb),
    ):
        args.append(_check(key, pf[key], dtype, shape, dev) if on else None)
    pairs = torch.empty((nchunks, c, c), dtype=torch.bool, device=dev)
    build.launch(
        "conflict_pairs", *[_ptr(x) for x in args], nchunks, c, g, rs, et, a, ch, sd, sc,
        _ptr(pairs), _stream(dev),
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
    (C,) i32.  A strict commit (no deferral, no cumulative fit) takes
    ``pairs`` None."""
    if _on_cpu(picks):
        return plain.resolve_commit(state, dom, pf, picks, pairs, strict)
    group_dom = dom.group_dom
    dev = picks.device
    c = picks.shape[0]
    if not 1 <= c <= MAX_CHUNK:
        raise ValueError(f"resolve_commit: chunk {c} outside [1, {MAX_CHUNK}]")
    n, r = state.alloc.shape
    g = state.group_counts.shape[0]
    tk = state.topo_vals.shape[1]
    dv = group_dom.shape[2]
    i32, i64 = torch.int32, torch.int64
    _check("picks", picks, i32, (c,), dev)
    _check("valid", pf["valid"], torch.bool, (c,), dev)
    if not strict:  # a strict commit reads no pairs
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
    # Volume features: each pair absent when no pod of the batch fills it.
    dev_ids, dev_rw = pf.get("vol_dev_ids"), pf.get("vol_dev_rw")
    csi_ids, csi_drv = pf.get("vol_csi_ids"), pf.get("vol_csi_drv")
    csi_lim = None if strict else pf.get("vol_csi_lim")
    sd = 0 if dev_ids is None else dev_ids.shape[1]
    sc = 0 if csi_ids is None else csi_ids.shape[1]
    if sc > 64:
        raise NotImplementedError(f"resolve_commit: {sc} CSI volume slots per pod exceed 64")
    vd, cv, dr = state.dev_counts.shape[0], state.csivol_counts.shape[0], state.csi_used.shape[0]
    if dev_ids is not None:
        _check("vol_dev_ids", dev_ids, i32, (c, sd), dev)
        _check("vol_dev_rw", dev_rw, torch.bool, (c, sd), dev)
        _check("state.dev_counts", state.dev_counts, i32, (vd, n), dev)
        _check("state.dev_rw_counts", state.dev_rw_counts, i32, (vd, n), dev)
    if csi_ids is not None:
        _check("vol_csi_ids", csi_ids, i32, (c, sc), dev)
        _check("vol_csi_drv", csi_drv, i32, (c, sc), dev)
        _check("state.csivol_counts", state.csivol_counts, i32, (cv, n), dev)
        _check("state.csi_used", state.csi_used, i32, (dr, n), dev)
    if csi_lim is not None:
        _check("vol_csi_lim", csi_lim, torch.bool, (c,), dev)
    out = torch.empty(c, dtype=i32, device=dev)
    build.launch(
        "resolve_commit",
        _ptr(picks), _ptr(pf["valid"]), _ptr(pairs), int(strict),
        _ptr(pf["req"]), _ptr(pf["nonzero"]), _ptr(pf["group"]),
        _ptr(state.alloc), _ptr(state.req), _ptr(state.nonzero_req),
        _ptr(state.num_pods), _ptr(state.allowed_pods), _ptr(state.group_counts),
        _ptr(group_dom), _ptr(state.topo_vals), _ptr(own), _ptr(state.et_counts),
        _ptr(dom.et_dom), _ptr(dom.et_slot),
        _ptr(dev_ids), _ptr(dev_rw), _ptr(state.dev_counts), _ptr(state.dev_rw_counts),
        _ptr(csi_ids), _ptr(csi_drv), _ptr(state.csivol_counts), _ptr(state.csi_used), _ptr(csi_lim),
        c, n, r, tk, dv, na, sd, sc, dr, _ptr(out), _stream(dev),
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


def _grouped(pf: dict, prefix: str, k: int, dev) -> tuple[list, tuple]:
    """A volume op's grouped program, checked: (op, key, vals, int,
    term_valid, group, ngroups, feasible) and its (T, Q, V)."""
    prog, dims = _program(pf, prefix, k, dev)
    t_ = dims[0]
    prog += [
        _check(f"{prefix}_group", pf[f"{prefix}_group"], torch.int32, (k, t_), dev),
        _check(f"{prefix}_ngroups", pf[f"{prefix}_ngroups"], torch.int32, (k,), dev),
        _check(f"{prefix}_feasible", pf[f"{prefix}_feasible"], torch.bool, (k,), dev),
    ]
    return prog, dims


def node_filters(state, pf: dict, ctx):
    """(K, N) u8 per-batch node filter bits of a batch's K pods: bit 0
    NodeAffinity's filter (with ``ctx.profile``'s added affinity), bit 1
    TaintToleration's, bit 2 VolumeBinding's, bit 3 VolumeZone's; a bit
    whose features the batch lacks is 1."""
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
    vols = []
    for prefix in ("vb", "vz"):
        if f"{prefix}_op" in pf:
            vols.append((True, *_grouped(pf, prefix, k, dev)))
        else:
            vols.append((False, [None] * 8, (1, 1, 1)))
    out = torch.empty((k, n), dtype=torch.uint8, device=dev)
    build.launch(
        "node_filters",
        *[_ptr(a) for a in _label_args(state, dev)],
        _ptr(sel), _ptr(has_req), *[_ptr(a) for a in req],
        _ptr(has_add), *[_ptr(a) for a in add],
        _ptr(intol), *[_ptr(a) for _on, prog, _d in vols for a in prog], _ptr(out),
        n, ls, ts, k, s, *req_dims, *add_dims, tv, *[d for _on, _p, dims in vols for d in dims],
        int(do_na), int(do_add), int(do_taint), *[int(on) for on, _p, _d in vols],
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


def late_scores(state, pf: dict, feasible, total, node_bits, late: LateSpec, pin=None):
    """Adds NodeAffinity's, TaintToleration's and PodTopologySpread's
    weighted scores, normalized over the final ``feasible`` (C, N), into
    ``total`` (C, N) i64 IN PLACE (0 stays on infeasible nodes); spread's
    inclusion policies read the node_filters bits.  With ``pin`` ((C,)
    i32), ``feasible`` and ``total`` are (C, 1) on each pod's pinned node
    and spread must not score.  Returns ``total``."""
    if _on_cpu(feasible):
        return plain.late_scores(state, pf, feasible, total, node_bits, late, pin)
    dev = feasible.device
    c = feasible.shape[0]
    n = state.valid.shape[0]
    width = n
    if pin is not None:
        if late.spread_weight:
            raise ValueError("late_scores: PodTopologySpread does not score on pinned nodes")
        _check("pin", pin, torch.int32, (c,), dev)
        width = 1
    tk = state.topo_vals.shape[1]
    g = state.group_counts.shape[0]
    ls, ts = state.label_key_ids.shape[1], state.taint_ids.shape[1]
    dv = late.ctx.schema.DV
    _check("feasible", feasible, torch.bool, (c, width), dev)
    _check("total", total, torch.int64, (c, width), dev)
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
    raw = torch.empty((3, c, width), dtype=torch.int64, device=dev)
    build.launch(
        "late_scores",
        *[_ptr(a) for a in node], _ptr(nb), _ptr(feasible), _ptr(total), _ptr(pin),
        *[_ptr(a) for a in pref], _ptr(intol), *[_ptr(a) for a in soft], _ptr(table),
        _ptr(glist), _ptr(raw),
        c, n, ls, ts, tk, dv, g, *dims, tv, cs, max(n, dv) + 1,
        int(late.na_weight), int(late.taint_weight), int(late.spread_weight), smem, _stream(dev),
    )
    late_scores.launches += 1
    return total


def vol_filter(state, pf: dict, ctx, do_vr: bool, do_nvl: bool):
    """(C, N) u8 per-chunk volume filter bits: bit 0 VolumeRestrictions',
    bit 1 NodeVolumeLimits' (each 1 when not asked for), from the chunk's
    device and CSI volume ids against the current counts."""
    if _on_cpu(state.valid):
        return plain.vol_filter(state, pf, ctx, do_vr, do_nvl)
    dev = state.valid.device
    c, n = pf["valid"].shape[0], state.valid.shape[0]
    vd, cv, dr = state.dev_counts.shape[0], state.csivol_counts.shape[0], state.csi_used.shape[0]
    i32 = torch.int32
    node = [
        _check("dev_counts", state.dev_counts, i32, (vd, n), dev),
        _check("dev_rw_counts", state.dev_rw_counts, i32, (vd, n), dev),
        _check("csivol_counts", state.csivol_counts, i32, (cv, n), dev),
        _check("csi_used", state.csi_used, i32, (dr, n), dev),
        _check("csi_limit", state.csi_limit, i32, (dr, n), dev),
    ]
    dev_ids, dev_rw, rwop, csi_ids, csi_drv = None, None, None, None, None
    sd = sc = 0
    if do_vr:
        rwop = _check("vr_rwop_ok", pf["vr_rwop_ok"], torch.bool, (c,), dev)
        if "vol_dev_ids" in pf:
            sd = pf["vol_dev_ids"].shape[1]
            dev_ids = _check("vol_dev_ids", pf["vol_dev_ids"], i32, (c, sd), dev)
            dev_rw = _check("vol_dev_rw", pf["vol_dev_rw"], torch.bool, (c, sd), dev)
    if do_nvl and "vol_csi_ids" in pf:
        sc = pf["vol_csi_ids"].shape[1]
        csi_ids = _check("vol_csi_ids", pf["vol_csi_ids"], i32, (c, sc), dev)
        csi_drv = _check("vol_csi_drv", pf["vol_csi_drv"], i32, (c, sc), dev)
    out = torch.empty((c, n), dtype=torch.uint8, device=dev)
    build.launch(
        "vol_filter", *[_ptr(a) for a in node], _ptr(dev_ids), _ptr(dev_rw), _ptr(rwop),
        _ptr(csi_ids), _ptr(csi_drv), _ptr(out), c, n, sd, sc, dr, int(do_vr), int(do_nvl),
        _stream(dev),
    )
    vol_filter.launches += 1
    return out


# -- preemption and data moves ---------------------------------------------------


class Victims(NamedTuple):
    """The dry-run's per-node victim slots (preemption.py:716 pack_victims):
    least important first, PDB-violating last; empty slots hold the
    sentinels (priority INT32_MAX, zero requests, start +inf, no PDB)."""

    prio: torch.Tensor  # (N, V) i32
    req: torch.Tensor  # (N, V, R) i64
    nonzero: torch.Tensor  # (N, V, 2) i64
    start: torch.Tensor  # (N, V) f64
    pdb: torch.Tensor  # (N, V, P) bool — victim matches budget p
    allowed: torch.Tensor  # (P,) i64 — disruptions allowed (INT32_MAX padding)


@dataclass(frozen=True)
class PreemptSpec:
    """The release-independent filters preempt_eval applies for one pass:
    NodeUnschedulable, NodeName, and the node_filters bits (1 NodeAffinity,
    2 TaintToleration) that must be set."""

    check_unsched: bool
    check_nodename: bool
    bits_mask: int


def _mate_ptrs(pf: dict, c: int, dev) -> list:
    """valid, elig, spec_picks pointers of a chunk (valid, or the
    speculative pair)."""
    if "valid" in pf:
        return [_check("valid", pf["valid"], torch.bool, (c,), dev), None, None]
    return [None, _check("elig", pf["elig"], torch.bool, (c,), dev),
            _check("spec_picks", pf["spec_picks"], torch.int32, (c,), dev)]


def preempt_eval(state, vic: Victims, pf: dict, spec: PreemptSpec):
    """The closed-form dry-run of the chunk's representative preemptor
    against every node: (possible (N,) bool, crit (5, N) i64, vic_mask (N, V)
    bool, n_vic (N,) i32, rel (N, R) i64, relnz (N, 2) i64)."""
    if _on_cpu(state.valid):
        return plain.preempt_eval(state, vic, pf, spec)
    dev = state.valid.device
    n, v = vic.prio.shape
    r = state.alloc.shape[1]
    p = vic.allowed.shape[0]
    c = pf["priority"].shape[0]
    if r > 16 or v > 64:
        raise NotImplementedError(f"preempt_eval: R={r} > 16 or V={v} > 64 victim slots")
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    args = [
        _check("valid", state.valid, b, (n,), dev),
        _check("name_id", state.name_id, i32, (n,), dev),
        _check("unschedulable", state.unschedulable, b, (n,), dev),
        _check("num_pods", state.num_pods, i32, (n,), dev),
        _check("allowed_pods", state.allowed_pods, i32, (n,), dev),
        _check("alloc", state.alloc, i64, (n, r), dev),
        _check("req", state.req, i64, (n, r), dev),
        _check("vic_prio", vic.prio, i32, (n, v), dev),
        _check("vic_req", vic.req, i64, (n, v, r), dev),
        _check("vic_nonzero", vic.nonzero, i64, (n, v, 2), dev),
        _check("vic_start", vic.start, torch.float64, (n, v), dev),
        _check("vic_pdb", vic.pdb, b, (n, v, p), dev),
        _check("pdb_allowed", vic.allowed, i64, (p,), dev),
        _check("priority", pf["priority"], i32, (c,), dev),
        _check("req", pf["req"], i64, (c, r), dev),
        _check("nodename_id", pf["nodename_id"], i32, (c,), dev) if spec.check_nodename else None,
        _check("tolerates_unschedulable", pf["tolerates_unschedulable"], b, (c,), dev)
        if spec.check_unsched else None,
        *_mate_ptrs(pf, c, dev),
        _check("node_bits", pf["node_bits"], torch.uint8, (c, n), dev) if spec.bits_mask else None,
    ]
    possible = torch.empty(n, dtype=b, device=dev)
    crit = torch.empty((plain.N_CRIT, n), dtype=i64, device=dev)
    vic_mask = torch.empty((n, v), dtype=b, device=dev)
    n_vic = torch.empty(n, dtype=i32, device=dev)
    rel = torch.empty((n, r), dtype=i64, device=dev)
    relnz = torch.empty((n, 2), dtype=i64, device=dev)
    build.launch(
        "preempt_eval", *[_ptr(a) for a in args], spec.bits_mask, c, n, v, r, p,
        _ptr(possible), _ptr(crit), _ptr(vic_mask), _ptr(n_vic), _ptr(rel), _ptr(relnz),
        _stream(dev),
    )
    preempt_eval.launches += 1
    return possible, crit, vic_mask, n_vic, rel, relnz


def preempt_pick(possible, crit, pf: dict, chunk_mode: bool):
    """(C,) i32 picks of a chunk's mates from preempt_eval's criteria (-2
    deferred at chunk > 1)."""
    if _on_cpu(possible):
        return plain.preempt_pick(possible, crit, pf, chunk_mode)
    dev = possible.device
    n = possible.shape[0]
    c = pf["sig"].shape[0]
    _check("possible", possible, torch.bool, (n,), dev)
    _check("crit", crit, torch.int64, (plain.N_CRIT, n), dev)
    sig = _check("sig", pf["sig"], torch.int32, (c,), dev)
    order_at = torch.empty(c, dtype=torch.int32, device=dev)
    picks = torch.empty(c, dtype=torch.int32, device=dev)
    build.launch(
        "preempt_pick", _ptr(possible), _ptr(crit), *[_ptr(a) for a in _mate_ptrs(pf, c, dev)],
        _ptr(sig), int(chunk_mode), c, n, _ptr(order_at), _ptr(picks), _stream(dev),
    )
    preempt_pick.launches += 1
    return picks


def preempt_commit(carry, vic_prio, ev, picks):
    """The step's commit, in place on the carried (req, nonzero_req,
    num_pods) and ``vic_prio``; returns the mates' (vic_mask (C, V) bool,
    n_victims (C,) i32)."""
    if _on_cpu(picks):
        return plain.preempt_commit(carry, vic_prio, ev, picks)
    dev = picks.device
    req, nonzero_req, num_pods = carry
    _possible, _crit, vic_mask, n_vic, rel, relnz = ev
    n, v = vic_prio.shape
    r = req.shape[1]
    c = picks.shape[0]
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    args = [
        _check("vic_mask", vic_mask, b, (n, v), dev),
        _check("n_vic", n_vic, i32, (n,), dev),
        _check("rel", rel, i64, (n, r), dev),
        _check("relnz", relnz, i64, (n, 2), dev),
        _check("req", req, i64, (n, r), dev),
        _check("nonzero_req", nonzero_req, i64, (n, 2), dev),
        _check("num_pods", num_pods, i32, (n,), dev),
        _check("vic_prio", vic_prio, i32, (n, v), dev),
    ]
    _check("picks", picks, i32, (c,), dev)
    mask_out = torch.empty((c, v), dtype=b, device=dev)
    nvic_out = torch.empty(c, dtype=i32, device=dev)
    build.launch(
        "preempt_commit", _ptr(picks), c, v, r, *[_ptr(a) for a in args], _ptr(mask_out),
        _ptr(nvic_out), _stream(dev),
    )
    preempt_commit.launches += 1
    return mask_out, nvic_out


def unpack_victims(buf, r: int, n_pdbs: int, pdb_words: int, v: int, inline_allowed: bool):
    """The staged (N, vu, cols) int64 victim buffer → (prio, req, nonzero,
    start, pdb, allowed or None), padded to ``v`` victim slots."""
    if _on_cpu(buf):
        return plain.unpack_victims(buf, r, n_pdbs, pdb_words, v, inline_allowed)
    dev = buf.device
    n, vu, cols = buf.shape
    if not buf.is_contiguous() or buf.dtype != torch.int64:
        raise ValueError("unpack_victims: the buffer must be contiguous int64")
    if cols < 5 + r + pdb_words or vu > v:
        raise ValueError(f"unpack_victims: buffer {tuple(buf.shape)} does not hold R={r}, v={v}")
    prio = torch.empty((n, v), dtype=torch.int32, device=dev)
    req = torch.empty((n, v, r), dtype=torch.int64, device=dev)
    nonzero = torch.empty((n, v, 2), dtype=torch.int64, device=dev)
    start = torch.empty((n, v), dtype=torch.float64, device=dev)
    pdb = torch.empty((n, v, n_pdbs), dtype=torch.bool, device=dev)
    allowed = torch.empty(n_pdbs, dtype=torch.int64, device=dev) if inline_allowed else None
    build.launch(
        "unpack_victims", _ptr(buf), n, vu, cols, r, n_pdbs, pdb_words, v, int(inline_allowed),
        _ptr(prio), _ptr(req), _ptr(nonzero), _ptr(start), _ptr(pdb), _ptr(allowed),
        _stream(dev),
    )
    unpack_victims.launches += 1
    return prio, req, nonzero, start, pdb, allowed


def scatter_rows(dst, axis: int, rows, src) -> None:
    """In place: dst's node rows (axis 0) or node columns (axis 1, a 2-D
    (X, N) field) ``rows`` (i64) ← ``src`` (the same layout with len(rows)
    in place of N)."""
    if _on_cpu(dst):
        plain.scatter_rows(dst, axis, rows, src)
        return
    dev = dst.device
    nrows = rows.shape[0]
    if axis == 0:
        outer, n = 1, dst.shape[0]
        inner = dst[0].numel() * dst.element_size() if dst.dim() > 0 and n > 0 else 0
        want = (nrows,) + tuple(dst.shape[1:])
    elif axis == 1 and dst.dim() == 2:
        outer, n = dst.shape
        inner = dst.element_size()
        want = (outer, nrows)
    else:
        raise ValueError(f"scatter_rows: axis {axis} of a {dst.dim()}-d tensor")
    if not dst.is_contiguous():
        raise ValueError("scatter_rows: destination not contiguous")
    _check("rows", rows, torch.int64, (nrows,), dev)
    _check("src", src, dst.dtype, want, dev)
    build.launch("scatter_rows", _ptr(dst), _ptr(src), _ptr(rows), nrows, outer, n, inner, _stream(dev))
    scatter_rows.launches += 1


def expand_rows(src, k: int):
    """(k, ...) copies of row 0 of ``src`` as a new contiguous tensor."""
    if _on_cpu(src):
        return plain.expand_rows(src, k)
    dev = src.device
    if not src.is_contiguous() or src.shape[0] < 1:
        raise ValueError("expand_rows: source must be contiguous with a row")
    out = torch.empty((k,) + tuple(src.shape[1:]), dtype=src.dtype, device=dev)
    inner = src[0].numel() * src.element_size()
    build.launch("expand_rows", _ptr(out), _ptr(src), k, inner, _stream(dev))
    expand_rows.launches += 1
    return out


def pinned_fit(own_ok, pin_row, valid, req, state):
    """The pinned-batch pass's same-row capacity rule (pass_.py:1003-1032):
    (picks (K,) i32: the pinned row, -2 deferred or -1; feasible (K,) i32)
    from eval_chunk's pinned feasibility ``own_ok`` (K,) bool, the pins
    ``pin_row`` (K,) i32 (-1: no live node), ``valid`` (K,) bool and the
    requests ``req`` (K, R) i64, against the state before the batch."""
    if _on_cpu(own_ok):
        return plain.pinned_fit(own_ok, pin_row, valid, req, state)
    dev = own_ok.device
    k = pin_row.shape[0]
    n, r = state.alloc.shape
    args = [
        _check("own_ok", own_ok, torch.bool, (k,), dev),
        _check("pin_row", pin_row, torch.int32, (k,), dev),
        _check("valid", valid, torch.bool, (k,), dev),
        _check("req", req, torch.int64, (k, r), dev),
        _check("alloc", state.alloc, torch.int64, (n, r), dev),
        _check("state.req", state.req, torch.int64, (n, r), dev),
        _check("num_pods", state.num_pods, torch.int32, (n,), dev),
        _check("allowed_pods", state.allowed_pods, torch.int32, (n,), dev),
    ]
    picks = torch.empty(k, dtype=torch.int32, device=dev)
    feasible = torch.empty(k, dtype=torch.int32, device=dev)
    build.launch("pinned_fit", *[_ptr(a) for a in args], k, n, r, _ptr(picks), _ptr(feasible), _stream(dev))
    pinned_fit.launches += 1
    return picks, feasible


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
    "vol_filter": vol_filter,
    "preempt_eval": preempt_eval,
    "preempt_pick": preempt_pick,
    "preempt_commit": preempt_commit,
    "unpack_victims": unpack_victims,
    "scatter_rows": scatter_rows,
    "expand_rows": expand_rows,
    "pinned_fit": pinned_fit,
}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
