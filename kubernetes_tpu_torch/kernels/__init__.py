"""The hand-written CUDA kernels of the batch pass, and their wrappers.

  build_dom       csrc/build_dom.cu       per-domain tables, once per pass: R table rows a CTA, the
                                          node axis over a thread block cluster (dom_split)
  eval_chunk      csrc/eval_chunk.cu      filters + weighted score, (C, N); a second launch runs the
                                          filters ordered after InterPodAffinity on what ipa_eval left
  ipa_eval        csrc/ipa_eval.cu        InterPodAffinity filter + score on top (truncated mode:
                                          a filter launch, then a score launch after the cut);
                                          one pod over a thread block cluster (cluster_split)
  select_host     csrc/select_host.cu     argmax with hashed tie-break (truncated mode: ties in
                                          rotated scan order); row mode: one pod over a cluster
  truncate_feasible csrc/truncate.cu      truncated mode's cut of the feasible set to the first
                                          numFeasibleNodesToFind in rotated scan order, per step
                                          (the pass's node count and limit handed in)
  resolve_commit  csrc/resolve_commit.cu  chunk deferral, cumulative fit, commit
  conflict_pairs  csrc/conflict_pairs.cu  chunk-mate conflict table, per batch
  node_filters    csrc/node_filters.cu    NodeAffinity, TaintToleration, VolumeBinding and VolumeZone
                                          filter bits, per batch: a tile of nodes by a group of pods,
                                          or each pod on its own row pinned
  spread_filter   csrc/spread_eval.cu     PodTopologySpread's filter, per chunk, before eval_chunk;
                                          one pod over a thread block cluster (spread_split)
  late_scores     csrc/spread_eval.cu     NodeAffinity, TaintToleration and spread scores over the
                                          final feasible set, per chunk, after ipa_eval; one pod
                                          over a cluster, or one CTA a pod pinned
  vol_filter      csrc/volume_filters.cu  VolumeRestrictions + NodeVolumeLimits filter bits, per
                                          chunk, before eval_chunk
  image_counts    csrc/image_locality.cu  valid nodes holding each image id, per batch
  image_scores    csrc/image_locality.cu  ImageLocality's raw score plane of the batch, per batch
  preempt_eval    csrc/preempt.cu         preemption dry-run of a chunk's representative, per node:
                                          whole, or its prologue and criteria tail around the search
  preempt_pick    csrc/preempt.cu         each mate's pick in one launch: the lexicographic argmin at
                                          chunk 1, else a top-C selection over a cluster (pick_split)
  preempt_commit  csrc/preempt.cu         release at the picked rows, victims consumed
  dom_release     csrc/preempt_search.cu  domain tables of a dry-run's released state, per search step
  search_step     csrc/preempt_search.cu  one step of the dry-run's what-if search, per search step
  unpack_victims  csrc/victims.cu         staged victim buffer → per-field arrays
  scatter_rows    csrc/rows.cu            dirty node rows of up to 32 device tensors ← their packed
                                          host rows (scatter_fields: one launch a flush)
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

import numpy as np
import torch

from ..framework.config import LEAST_ALLOCATED, MOST_ALLOCATED, REQUESTED_TO_CAPACITY_RATIO
from ..ops.helpers import log_table
from . import build, plain

# Filter codes of eval_chunk (3 bits each, packed in fail-bit order into a
# 64-bit word).  Code 3 reads a precomputed plane, chosen by a second 3-bit
# field (_EXT_SEL): node_filters' bits 0-3 (NodeAffinity, TaintToleration,
# VolumeBinding, VolumeZone), vol_filter's bits 0-1 (VolumeRestrictions,
# NodeVolumeLimits) or spread_filter's mask (PodTopologySpread).  Code 4 is
# NodePorts, against the live port counts, code 5 DynamicResources, against
# the live claim counts and pool columns.
_PLANE_BASE = {"node_bits": 0, "vol_bits": 4, "spread_ok": 6}
_EXT_SEL = {name: _PLANE_BASE[plane] + bit for name, (plane, bit) in plain.PLANE_BITS.items()}
_FILTER_CODES = {"NodeUnschedulable": 0, "NodeName": 1, "NodeResourcesFit": 2, **dict.fromkeys(_EXT_SEL, 3),
                 "NodePorts": 4, "DynamicResources": 5}
# ImageLocality's score is read from the image_scores plane.
_SCORERS = ("NodeResourcesFit", "NodeResourcesBalancedAllocation", plain.IL, plain.TP, plain.LS)
_STRATEGIES = {LEAST_ALLOCATED: 0, MOST_ALLOCATED: 1, REQUESTED_TO_CAPACITY_RATIO: 2}
# Image ids a pod image_scores stages (kMaxImages), its node tile and pod
# group (kTile, kPodGroup) and the merged lists' entries a row at most
# (kMaxSlots: a tile's lists in shared memory) in image_locality.cu.
MAX_POD_IMAGES = 16
IMAGE_TILE = 32
IMAGE_GROUP = 32
IMAGE_SLOTS_MAX = 512
_MAX_BALANCED = 8
# RequestedToCapacityRatio shape points and LearnedScorer hidden units
# eval_chunk takes (kMaxShape, kMaxHidden in eval_chunk.cu).
MAX_SHAPE_POINTS = 16
MAX_HIDDEN = 16
MAX_CHUNK = 1024  # resolve_commit: one block a chunk
# eval_chunk's node tile: nodes a block at most and at least, pods a block
# at most (kTile, kGroup in eval_chunk.cu).
EVAL_TILE = 128
EVAL_TILE_MIN = 32
EVAL_GROUP = 4
# Shared memory an ipa_eval, spread_filter or late_scores CTA may use for
# its per-pod tables (of the H100's 227 KB a block can have); each kernel's
# error names its own.
SMEM_CAP = 200 * 1024
IPA_SMEM_CAP = SPREAD_SMEM_CAP = SMEM_CAP
# Thread block clusters (select_host, ipa_eval, spread_filter, late_scores):
# at most CLUSTER_MAX CTAs a pod (16 takes the non-portable cluster size),
# and at least this many node rows a CTA, chosen from the H100 sweeps of K
# at the paths' shapes (PERF.md §6): select_host's reductions gain from a
# split only where a pod's rows are many (two a thread of 512 at least) and
# its clusters fit the card one CTA an SM; ipa_eval's per-node walk gains
# down to 128 rows a CTA.
CLUSTER_MAX = 16
SELECT_ROWS_MIN = 1024
IPA_ROWS_MIN = 128
# spread_filter's and late_scores' clusters take at least SPREAD_ROWS_MIN
# node rows a CTA (the H100 sweep of K at the spread shapes, PERF.md §6).
SPREAD_ROWS_MIN = 128
SPREAD_WARPS = 16  # spread_eval.cu's kMaxWarps (its launchers refuse a spread_smem that disagrees)
# node_filters' tiled launch: nodes a block at most (node_filters.cu's
# launch bound) and at least, pods a block at most, and the blocks an SM
# below which nf_tile halves the group, chosen from the H100 sweep at the
# batch shapes (scripts/shape_sweep.py, PERF.md §6).
NF_TILE = 128
NF_TILE_MIN = 32
NF_GROUP = 32
NF_BLOCKS_PER_SM = 12
# preempt_pick's modes (preempt.cu kArgmin, kSplit, kTiled), the node rows
# a CTA of its cluster takes before K doubles, and its widest bitonic
# network (kPickMax: threads a CTA, a slice's rows in split mode, a tile's
# in tiled mode).
PICK_ARGMIN, PICK_SPLIT, PICK_TILED = 0, 1, 2
PICK_ROWS = 512
PICK_WIDTH = 1024
# truncate_feasible: rows a thread (a register array each: truncate.cu's
# instantiations) and threads of its one block at most (1024 beat 512 and
# 256 at the parity shape: scripts/shape_sweep.py, PERF.md §6).
TRUNC_ROWS = (4, 8, 16, 32)
TRUNC_THREADS = 1024
# build_dom: threads a CTA at most (build_dom.cu kMaxThreads), the nodes a
# thread takes a step (kVec: one 16-byte load of counts), the shared memory
# a block may have on the H100 (kMaxSmem: the tables of its R rows), the
# rows whose counts a thread loads together with R > 1 (kPass: two passes
# of them in flight under kWave's bound of 64 registers), and the CTAs an SM
# with R > 1 (kWave, their launch bound: R makes the grid one wave of
# them).  K grows until the grid has DOM_CTAS_PER_SM CTAs an SM, and halves
# while a CTA would take fewer than DOM_ROWS_MIN node rows (DOM_WAVE,
# DOM_ROWS_MIN and DOM_CTAS_PER_SM chosen from the H100 sweeps,
# scripts/cluster_sweep.py --only dom, PERF.md §6).
DOM_THREADS = 256
DOM_VEC = 4
DOM_SMEM_CAP = 227 * 1024
DOM_PASS = 2
DOM_WAVE = 4
DOM_ROWS_MIN = 1024
DOM_CTAS_PER_SM = 2
# preempt_eval: threads a block at most (preempt.cu kEvalMaxThreads, the
# launch bound), the blocks an SM the grid aims for (threads halve, to a
# warp, until it has them), the lanes of a node's group at most (a warp),
# and the shared memory a block may hold (its node groups' id spans and
# counters).
EVAL_THREADS = 256
EVAL_BLOCKS_PER_SM = 2
EVAL_LANES_MAX = 32
EVAL_SMEM_CAP = 200 * 1024


@dataclass
class EvalSpec:
    """What eval_chunk evaluates for one compiled pass: the pass context
    (profile, schema, static op config), the active filters in fail-bit
    order, the active (scorer, weight) pairs and the fail bit of the first
    filter (``bit0``; a filter range after InterPodAffinity starts past
    it)."""

    ctx: object  # ops.common.PassContext
    filters: tuple[str, ...]
    scorers: tuple[tuple[str, int], ...]
    bit0: int = 0
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


def spread_smem(q: int, dv: int, k: int = 1) -> int:
    """Dynamic shared memory of one spread_filter or late_scores CTA with
    ``q`` constraints in a cluster of ``k`` (spread_eval.cu's smem_len):
    the per-constraint int64 (the filter's minima, the score's log weights)
    and eight staged flags; the partial (Q, DV) count and presence tables,
    hostname minima and counts and the scored-node count, and above one CTA
    a pod the cluster's summed copy; the list lengths and the per-warp
    hostname minima and counts."""
    part = 2 * q * dv + 2 * q + 1
    ints = 8 * q + part * (2 if k > 1 else 1) + q + 2 * SPREAD_WARPS * q
    return 8 * q + 4 * ints


def spread_smem_bytes(k: int, dv: int) -> int:
    """spread_smem of one CTA a pod with ``k`` constraints.  Raises
    NotImplementedError above
    SPREAD_SMEM_CAP: such a pass needs the tables in device memory, which
    these kernels do not do."""
    nbytes = spread_smem(k, dv)
    if nbytes > SPREAD_SMEM_CAP:
        raise NotImplementedError(
            f"spread_eval: {nbytes} bytes of per-pod domain tables exceed its shared-memory cap "
            f"SPREAD_SMEM_CAP={SPREAD_SMEM_CAP} ({k} constraints, DV={dv})"
        )
    return nbytes


def ipa_smem(ra: int, rs: int, pf: int, tk: int, dv: int, k: int = 1) -> int:
    """Dynamic shared memory of one ipa_eval CTA in a cluster of ``k``: the
    preferred terms' weights (int64) and every own term's flags (3 x
    (RA+RS+PF)), the own-term tallies ((RA+RS+PF) x DV), the forbidden and
    weighted tables (2 x TK x DV) and the list lengths (1+RS+PF group
    lists, 2 term lists) and each list's non-empty segments (1 + K ints),
    as int32; above one CTA a pod, the cluster's summed tables and the K
    CTAs' lengths besides."""
    tables, lens = (ra + rs + pf) * dv + 2 * tk * dv, (1 + rs + pf) + 2
    terms = 8 * pf + 4 * 3 * (ra + rs + pf)
    return terms + 4 * (tables + lens if k == 1 else 2 * tables + lens + k * lens) + 4 * lens * (1 + k)


def ipa_smem_bytes(ra: int, rs: int, pf: int, tk: int, dv: int) -> int:
    """ipa_smem of one block a pod.  Raises NotImplementedError above
    IPA_SMEM_CAP: such a pass needs the tables in device memory, which
    this kernel does not do."""
    nbytes = ipa_smem(ra, rs, pf, tk, dv)
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
    if len(spec.filters) > 15 or spec.bit0 + len(spec.filters) > 32:
        raise ValueError("eval_chunk packs at most 15 filters a launch, fail bits below 32")
    weights = dict(spec.scorers)
    static = spec.ctx.static
    profile = spec.ctx.profile
    strategy = profile.scoring_strategy
    shape = strategy.shape if strategy.type == REQUESTED_TO_CAPACITY_RATIO else ()
    if "NodeResourcesFit" in weights:
        if strategy.type not in _STRATEGIES:
            raise ValueError(f"eval_chunk kernel: unknown scoring strategy {strategy.type!r}")
        if shape and not 2 <= len(shape) <= MAX_SHAPE_POINTS:
            raise NotImplementedError(
                f"eval_chunk kernel: a RequestedToCapacityRatio shape of {len(shape)} points "
                f"(MAX_SHAPE_POINTS={MAX_SHAPE_POINTS}, at least 2)")
    learned = static.get("learned_weights") if plain.LS in weights else None
    hidden = len(learned[1]) if learned else 0
    if hidden > MAX_HIDDEN:
        raise NotImplementedError(
            f"eval_chunk kernel: {hidden} LearnedScorer hidden units (MAX_HIDDEN={MAX_HIDDEN})")
    lw = [0.0]
    if learned:
        w1, b1, w2, b2 = learned
        lw = [w for row in w1 for w in row] + list(b1) + list(w2) + [b2]
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
        codes |= _FILTER_CODES[name] << (3 * b)
        ext_sel |= _EXT_SEL.get(name, 0) << (3 * b)
    return {
        "R": r,
        "fit_ignored": ignored.to(device),
        "strat_cols": torch.tensor(
            [list(s) for s in strat] or [[0, 0, 0]], dtype=torch.int64
        ).to(device),
        "n_strat": len(strat),
        "strategy": _STRATEGIES.get(strategy.type, 0),
        "shape": torch.tensor([float(p[0]) for p in shape] + [float(p[1]) for p in shape] or [0.0],
                              dtype=torch.float64).to(device),
        "n_shape": len(shape),
        "bal_cols": torch.tensor([c for (c,) in bal] or [0], dtype=torch.int32).to(device),
        "n_bal": len(bal),
        "score_fit": int("NodeResourcesFit" in weights),
        "fit_weight": int(weights.get("NodeResourcesFit", 0)),
        "score_bal": int("NodeResourcesBalancedAllocation" in weights),
        "bal_weight": int(weights.get("NodeResourcesBalancedAllocation", 0)),
        "il": plain.IL in weights,
        "il_weight": int(weights.get(plain.IL, 0)),
        "tp_weight": int(weights.get(plain.TP, 0)),
        "ls_weight": int(weights.get(plain.LS, 0)) if learned else 0,
        # f32 weights, rounded from the artifact's f64 as JAX's f32(w).
        "lw": torch.tensor(lw, dtype=torch.float32).to(device),
        "H": hidden,
        "ports": "NodePorts" in spec.filters,
        "dra": "DynamicResources" in spec.filters,
        "filter_codes": codes,
        "ext_sel": ext_sel,
        "n_filters": len(spec.filters),
        "node_bits": any(plain.PLANE_BITS.get(n, ("",))[0] == "node_bits" for n in spec.filters),
        "spread": plain.PTS in spec.filters,
        "vol_bits": any(plain.PLANE_BITS.get(n, ("",))[0] == "vol_bits" for n in spec.filters),
    }


def eval_tile(c: int, n: int, sms: int) -> tuple[int, int]:
    """(nodes a block, pods a block) of eval_chunk's node-tiled launch for C
    pods and N node rows on a card with ``sms`` SMs: EVAL_TILE nodes and up
    to EVAL_GROUP pods a block, halved (the pods first, then the nodes, down
    to EVAL_TILE_MIN) until the grid has two blocks for each SM or can
    shrink no further.  More pods a block share each node's staged row; more
    blocks keep the SMs busy at small C.  A group of one pod takes the
    kernel's one-thread-a-pair launch (nodes: its block width)."""
    nodes, pods = EVAL_TILE, max(1, min(c, EVAL_GROUP))
    while -(-n // nodes) * -(-c // pods) < 2 * sms:
        if pods > 1:
            pods //= 2
        elif nodes > EVAL_TILE_MIN:
            nodes //= 2
        else:
            break
    return nodes, pods


def cluster_split(c: int, n: int, sms: int, rows_min: int, smem_per_cta=None, one_wave: bool = False) -> int:
    """K, the CTAs of the thread block cluster that takes one pod of a
    select_host, ipa_eval, spread_filter or late_scores launch of C pods
    over N node rows, on a card with ``sms`` SMs: the smallest of 1, 2, 4,
    8, 16 with C x K >= sms (1 where C >= sms), halved while a CTA would
    get fewer than ``rows_min`` rows (N // K), while, with
    ``smem_per_cta`` (K -> a CTA's shared memory in bytes), a CTA would
    need more than SMEM_CAP, and, with ``one_wave``, while the grid would
    hold more CTAs than SMs (C x K > sms).  One CTA a pod is a scheme of
    its own, picked by shape: the kernel runs it as a plain launch."""
    k = 1
    while k < CLUSTER_MAX and c * k < sms:
        k *= 2
    while k > 1 and (n // k < rows_min or (smem_per_cta is not None and smem_per_cta(k) > SMEM_CAP)
                     or (one_wave and c * k > sms)):
        k //= 2
    return k


def pick_split(c: int, n: int) -> tuple[int, int, int, int]:
    """(mode, K, S, threads) of preempt_pick's one launch for C mates over
    N node rows: K, the CTAs of its cluster, the smallest of 1, 2, 4, 8, 16
    with K x PICK_ROWS >= N (16 above that); S = ceil(N / K) rows a CTA.
    PICK_ARGMIN where only rank 0 is read (min(C, N) <= 1: chunk 1, or one
    row), its threads S rounded up to a warp, at most PICK_ROWS; else
    PICK_SPLIT where a slice fits one bitonic network (S <= PICK_WIDTH),
    its threads S rounded up to a power of two, at least a warp; else
    PICK_TILED, PICK_WIDTH threads walking the slice in tiles."""
    k = 1
    while k < CLUSTER_MAX and k * PICK_ROWS < n:
        k *= 2
    s = -(-n // k)
    if min(c, n) <= 1:
        return PICK_ARGMIN, k, s, max(32, min(PICK_ROWS, -(-s // 32) * 32))
    if s <= PICK_WIDTH:
        return PICK_SPLIT, k, s, max(32, 1 << (s - 1).bit_length())
    return PICK_TILED, k, s, PICK_WIDTH


def eval_lanes(v: int) -> int:
    """L, the lanes of preempt_eval's group a node for V victim slots: the
    power of two at least V, at most EVAL_LANES_MAX (at V > 32 each lane
    owns two slots, lane and lane + 32)."""
    lanes = 1
    while lanes < min(v, EVAL_LANES_MAX):
        lanes *= 2
    return lanes


def eval_split(n: int, v: int, sms: int, node_bytes: int = 0, warp_bytes: int = 0) -> tuple[int, int, int, int]:
    """(L, nodes a block, threads, blocks) of preempt_eval's one launch over
    N node rows of V victim slots on a card with ``sms`` SMs: L from
    eval_lanes; EVAL_THREADS threads a block, halved (down to a warp: each
    warp finds the representative) while the grid would have fewer than
    EVAL_BLOCKS_PER_SM blocks an SM or its shared memory (eval_smem:
    ``node_bytes`` a node's group, ``warp_bytes`` a warp) would pass
    EVAL_SMEM_CAP; threads / L nodes a block, and ceil(N / nodes) blocks."""
    lanes = eval_lanes(v)
    threads = EVAL_THREADS

    def smem(t):
        return t // 32 * warp_bytes + t // lanes * node_bytes

    while threads > 32 and (-(-n // (threads // lanes)) < EVAL_BLOCKS_PER_SM * sms or smem(threads) > EVAL_SMEM_CAP):
        threads //= 2
    if smem(threads) > EVAL_SMEM_CAP:
        raise NotImplementedError(f"preempt_eval: a node's {node_bytes} bytes of victim ids exceed {EVAL_SMEM_CAP}")
    nodes = threads // lanes
    return lanes, nodes, threads, -(-n // nodes)


def eval_smem(dims: dict, mode: int) -> tuple[int, int]:
    """(bytes a node's group, bytes a warp) of preempt_eval's shared memory
    (preempt.cu EvalLayout): a node's V x R int64 requests (not in TAIL);
    in FULL also its V x width id spans of the active ops (port triples and
    keys; device ids and gates; CSI ids, drivers, live counts and held
    counts; claim ids, pools, devices, first flags, live and held counts)
    and a counter a representative slot (two a port slot, three a CSI or
    claim slot), int32 each, the group's ints rounded up to even; a warp's
    copy of the representative's op slots in FULL (four ints a port slot,
    two a device or CSI slot, three a claim slot)."""
    d = dims
    node = 0 if mode == plain.TAIL else 2 * d["V"] * d["R"]
    if mode != plain.FULL:
        return 4 * node, 0
    node += d["V"] * (2 * d["PS"] + 2 * d["SD"] + 4 * d["SC"] + 6 * d["SK"]) + 2 * d["QP"] + d["QD"] \
        + 3 * d["QC"] + 3 * d["QK"]
    return 4 * (node + node % 2), 4 * (4 * d["QP"] + 2 * d["QD"] + 2 * d["QC"] + 3 * d["QK"])


def dom_columns(tk: int) -> str:
    """Where build_dom reads a node's domain values: "registers" with TK =
    4 (a node's topology row is one 16-byte load; a thread loads its nodes'
    rows at its first non-zero count of a step and keeps them for all the
    CTA's rows), else "topo_vals" (read as a count needs it)."""
    return "registers" if tk == 4 else "topo_vals"


def dom_slices(n: int, k: int) -> tuple[int, int]:
    """(S, threads) of build_dom's K slices of N node rows: S = ceil(N / K)
    rounded up to DOM_VEC (slices start on a 16-byte load), and the
    threads that give each of S's nodes one lane of DOM_VEC, whole warps, at
    most DOM_THREADS (a wider slice is walked in steps)."""
    per = -(-n // k)
    s = -(-per // DOM_VEC) * DOM_VEC
    return s, min(DOM_THREADS, max(32, -(-s // (DOM_VEC * 32)) * 32))


def dom_split(rows: int, n: int, tk: int, dv: int, sms: int) -> tuple[int, int, int, int]:
    """(R, K, S, threads) of build_dom's one launch over ``rows`` table rows
    (G group rows, then ET term rows) and N node rows, TK topology keys and
    DV domain values, on a card with ``sms`` SMs.  R is the table rows a
    CTA, K the CTAs of the thread block cluster that splits the node axis,
    S the node rows a CTA.  R = ceil(rows / (DOM_WAVE x sms)), so that the
    grid is about one wave of DOM_WAVE CTAs an SM.  With R = 1, K is the
    smallest of 1, 2, 4, 8, 16 with rows x K >= DOM_CTAS_PER_SM x sms,
    halved while ceil(N / K) would fall below DOM_ROWS_MIN; with R > 1, K =
    1.  S and threads from dom_slices.  R then shrinks (to 1 at most) while
    its tables, max(TK, 1) x DV int32 a row, pass DOM_SMEM_CAP.  Raises
    NotImplementedError where one row's table passes DOM_SMEM_CAP, all a
    block may have."""
    row_bytes = max(tk, 1) * dv * 4
    if rows and row_bytes > DOM_SMEM_CAP:
        raise NotImplementedError(f"build_dom: a table of {max(tk, 1)} x {dv} cells passes {DOM_SMEM_CAP} bytes")
    r, k = max(1, -(-rows // (DOM_WAVE * sms))), 1
    if r == 1:
        while k < CLUSTER_MAX and rows * k < DOM_CTAS_PER_SM * sms:
            k *= 2
        while k > 1 and -(-n // k) < DOM_ROWS_MIN:
            k //= 2
    return max(1, min(r, DOM_SMEM_CAP // max(row_bytes, 1))), k, *dom_slices(n, k)


def spread_split(c: int, n: int, q: int, dv: int, sms: int) -> tuple[int, int]:
    """(K, shared memory a CTA) of a spread_filter or late_scores launch of
    C pods with ``q`` constraints over N node rows (N = 1 pinned): K from
    cluster_split with SPREAD_ROWS_MIN under the cap.  Raises
    NotImplementedError where one CTA's tables pass SPREAD_SMEM_CAP."""
    spread_smem_bytes(q, dv)
    k = cluster_split(c, n, sms, SPREAD_ROWS_MIN, lambda k: spread_smem(q, dv, k))
    return k, spread_smem(q, dv, k)


def nf_tile(k: int, n: int, sms: int) -> tuple[int, int]:
    """(nodes a block, pods a block) of node_filters' tiled launch for K
    pods over N node rows on a card with ``sms`` SMs: NF_TILE nodes and up
    to NF_GROUP pods a block, halved (the pods first, then the nodes, down
    to NF_TILE_MIN) until the grid has NF_BLOCKS_PER_SM blocks for each SM
    or can shrink no further.  More pods a block share each thread's node
    row in registers; more blocks keep the SMs busy to the end of the
    launch (at the swept shapes of 4096 pods, 32 pods a block over 8192
    rows and 16 over 1024).  Raises
    NotImplementedError where the one-dimensional grid would pass 2^31 - 1
    blocks."""
    nodes, pods = NF_TILE, max(1, min(k, NF_GROUP))
    while -(-n // nodes) * -(-k // pods) < NF_BLOCKS_PER_SM * sms:
        if pods > 1:
            pods //= 2
        elif nodes > NF_TILE_MIN:
            nodes //= 2
        else:
            break
    if -(-n // nodes) * -(-k // pods) > 2**31 - 1:
        raise NotImplementedError(f"node_filters: {k} pods over {n} node rows pass 2^31 - 1 blocks")
    return nodes, pods


def trunc_shape(n: int) -> tuple[int, int]:
    """(threads, rows a thread) of truncate_feasible's one block over N
    node rows: the fewest rows of TRUNC_ROWS with which TRUNC_THREADS
    threads cover N, and the threads those rows need, in whole warps.
    Raises NotImplementedError past TRUNC_THREADS x 32 rows (each thread
    keeps its rows in registers)."""
    rows = next((r for r in TRUNC_ROWS if TRUNC_THREADS * r >= n), None)
    if rows is None:
        raise NotImplementedError(f"truncate_feasible: {n} node rows exceed {TRUNC_THREADS * TRUNC_ROWS[-1]}")
    per = -(-n // rows)
    return max(32, -(-per // 32) * 32), rows


def image_grid(n: int, k: int, im: int, sms: int) -> tuple[int, int, int]:
    """(P, slices, pods a slice) of image_scores' tiled launch for K pods
    over N node rows of IM image slots on a card with ``sms`` SMs: P, the
    merged lists' entries a row, is the power of two at least max(IM, 32)
    (image_merge's warp holds P / 32 slots a lane); the pods are cut into
    slices of whole groups (IMAGE_GROUP) so that the (ceil(N /
    IMAGE_TILE), slices) grid has about four blocks an SM, and no slice is
    empty."""
    if im > IMAGE_SLOTS_MAX:
        raise NotImplementedError(f"image_scores: {im} image slots a node exceed {IMAGE_SLOTS_MAX}")
    p = 32
    while p < im:
        p *= 2
    tiles = -(-n // IMAGE_TILE)
    groups = max(1, -(-k // IMAGE_GROUP))
    slices = max(1, min(-(-4 * sms // tiles), groups))
    per = -(-groups // slices) * IMAGE_GROUP
    return p, max(1, -(-k // per)), per


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    """The card's SM count, read once a device."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


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
    aggregate tables of the state's group and term carrier counts, in one
    launch of the geometry dom_split gives."""
    if _on_cpu(state.group_counts):
        return plain.build_dom(state, et_slot, dv)
    dev = state.group_counts.device
    g, n = state.group_counts.shape
    et = state.et_counts.shape[0]
    tk = state.topo_vals.shape[1]
    r, k, s, threads = dom_split(g + et, n, tk, dv, _sms(dev))
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
        "build_dom", *[_ptr(a) for a in args], g, et, n, tk, dv, r, k, s, threads, _ptr(group_dom),
        _ptr(et_dom), _stream(dev),
    )
    build_dom.launches += 1
    return group_dom, et_dom


def eval_chunk(state, pf: dict, spec: EvalSpec, nom, ext=None, pin=None, into=None):
    """Filters + weighted score of one chunk: (feasible (C, N) bool,
    total (C, N) i64, fail_mask (C,) i32).  ``nom`` is the nominated-pod
    overlay (nom_req, nom_cnt, nom_prio) or None; ``ext`` is (node_bits
    (C, N) u8, spread_ok (C, N) bool[, vol_bits (C, N) u8[, il_scores
    (C, N) u8]]), the precomputed planes of the ops in plain.PLANE_BITS and
    ImageLocality's score plane (any None when no active op reads it).
    With ``pin`` ((C,) i32 rows in [0, N)), pod c is evaluated on node
    pin[c] alone: feasible and total are (C, 1), the fail bits are those of
    that node and il_scores is (C, 1).  With ``into`` (an earlier launch's
    feasible, total and fail_mask) the filters run on that feasible set
    only, their fail bits from ``spec.bit0`` on, and the three tensors are
    updated IN PLACE and returned: the filter range after InterPodAffinity."""
    if _on_cpu(state.valid):
        return plain.eval_chunk(state, pf, spec, nom, ext, pin, into)
    dev = state.valid.device
    head, conf, cfg, c, width = _eval_args(state, pf, spec, nom, ext, pin)
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    if into is not None:
        feasible, total, fail = into
        _check("feasible", feasible, b, (c, width), dev)
        _check("total", total, i64, (c, width), dev)
        _check("fail_mask", fail, i32, (c,), dev)
        feas_in = feasible
    else:
        feasible = torch.empty((c, width), dtype=b, device=dev)
        total = torch.empty((c, width), dtype=i64, device=dev)
        fail = torch.zeros(c, dtype=i32, device=dev)
        feas_in = None
    tile, group = eval_tile(c, state.valid.shape[0], _sms(dev))
    build.launch("eval_chunk", *head, _ptr(feas_in), spec.bit0, *conf, tile, group, _ptr(feasible), _ptr(total),
                 _ptr(fail), _stream(dev))
    eval_chunk.launches += 1
    # Launches that ran each of the score terms and the filter range (a subset of the
    # above; chip_smoke.py reports them per path).
    terms = eval_chunk.term_launches
    terms["rtcr"] += int(cfg["score_fit"] and cfg["strategy"] == 2)
    terms["throughput"] += int(cfg["tp_weight"] != 0)
    terms["learned"] += int(cfg["ls_weight"] != 0)
    terms["after_ipa"] += int(into is not None)
    return feasible, total, fail




# The scorers of eval_chunk_cols, in the order of its col_rows fields
# (kColFit... in eval_chunk.cu).
_COL_SLOT = {"NodeResourcesFit": 0, "NodeResourcesBalancedAllocation": 1, plain.IL: 2, plain.TP: 3, plain.LS: 4}


def eval_chunk_cols(state, pf: dict, spec: EvalSpec, nom, ext=None):
    """eval_chunk's columns mode, for the attribution pass: (ok_bits (C, N)
    i32, bit b set where filter b's own verdict passes the node; feasible
    (C, N) bool, the valid nodes passing every filter; cols
    (len(spec.scorers), C, N) i64, each scorer's column before its weight;
    total (C, N) i64, Σ weight × column), every node evaluated.  ``ext`` as
    eval_chunk takes it; no pinned mode, no filter range."""
    if _on_cpu(state.valid):
        return plain.eval_chunk_cols(state, pf, spec, nom, ext)
    if spec.bit0:
        raise ValueError("eval_chunk_cols: bits from 0")
    dev = state.valid.device
    head, conf, _cfg, c, n = _eval_args(state, pf, spec, nom, ext, None)
    bits = torch.empty((c, n), dtype=torch.int32, device=dev)
    feasible = torch.empty((c, n), dtype=torch.bool, device=dev)
    total = torch.empty((c, n), dtype=torch.int64, device=dev)
    cols = torch.empty((len(spec.scorers), c, n), dtype=torch.int64, device=dev)
    # Each scorer's row in cols, 4 bits a scorer in _COL_SLOT order (15: none).
    rows = dict.fromkeys(range(len(_COL_SLOT)), 15)
    for k, (name, _w) in enumerate(spec.scorers):
        rows[_COL_SLOT[name]] = k
    col_rows = sum(r << (4 * slot) for slot, r in rows.items())
    tile, _group = eval_tile(c, n, _sms(dev))
    build.launch("eval_chunk_cols", *head, _ptr(None), 0, *conf, tile, _ptr(feasible), _ptr(total), _ptr(bits),
                 _ptr(cols), col_rows, _stream(dev))
    eval_chunk_cols.launches += 1
    return bits, feasible, cols, total


def _eval_args(state, pf: dict, spec: EvalSpec, nom, ext, pin):
    """eval_chunk's and eval_chunk_cols's launch arguments, checked: (the
    inputs up to the LearnedScorer hidden count, the static config after
    the filter range, the config, C, the output width)."""
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
    width = n if pin is None else 1  # pinned: (C, 1) planes and outputs, each pod's own node
    planes = []
    for name, dtype, want in (("node_bits", torch.uint8, cfg["node_bits"]),
                              ("spread_ok", b, cfg["spread"]),
                              ("vol_bits", torch.uint8, cfg["vol_bits"])):
        t = given[name]
        if want and t is None:
            raise ValueError(f"eval_chunk: plane {name!r} missing")
        planes.append(_check(name, t, dtype, (c, width), dev) if want else None)
    planes.append(None if pin is None else _check("pin", pin, i32, (c,), dev))
    # NodePorts reads the node counts and the chunk's wants; a batch with
    # no port feature conflicts nowhere (null pointers).
    ports = [None] * 6
    s_ports = 0
    if cfg["ports"] and "port_triples" in pf:
        s_ports = pf["port_triples"].shape[1]
        p_, pk = state.port_counts.shape[0], state.portkey_counts.shape[0]
        ports = [
            _check("port_counts", state.port_counts, i32, (p_, n), dev),
            _check("portkey_counts", state.portkey_counts, i32, (pk, n), dev),
            _check("port_triples", pf["port_triples"], i32, (c, s_ports), dev),
            _check("port_keys", pf["port_keys"], i32, (c, s_ports), dev),
            _check("port_wild_triples", pf["port_wild_triples"], i32, (c, s_ports), dev),
            _check("port_is_wild", pf["port_is_wild"], b, (c, s_ports), dev),
        ]
    dra, dra_dims = _dra_args(state, pf, c, dev) if cfg["dra"] else ([None] * 8, (0, 0, 0))
    il = given["il_scores"]
    if cfg["il"] and il is None:
        raise ValueError("eval_chunk: plane 'il_scores' missing")
    il = _check("il_scores", il, torch.uint8, (c, width), dev) if cfg["il"] else None
    # ThroughputAware and LearnedScorer read the node's class id and the
    # pod's score table; LearnedScorer also the pod's requests.
    hetero = [None] * 6
    tk = dv = 0
    if cfg["tp_weight"] or cfg["ls_weight"]:
        tk = state.topo_vals.shape[1]
        dv = pf["tp_scores"].shape[1]
        hetero[:3] = [_check("topo_vals", state.topo_vals, i32, (n, tk), dev),
                      _check("tp_scores", pf["tp_scores"], i64, (c, dv), dev),
                      _check("tp_slot", pf["tp_slot"], i32, (c,), dev)]
    if cfg["ls_weight"]:
        hetero[3:] = [_check("ls_req_cpu", pf["ls_req_cpu"], i64, (c,), dev),
                      _check("ls_req_mem", pf["ls_req_mem"], i64, (c,), dev), cfg["lw"]]
    head = [
        *[_ptr(a) for a in args],
        *[_ptr(a) for a in feats],
        *[_ptr(a) for a in planes],
        _ptr(cfg["fit_ignored"]), *[_ptr(a) for a in ports], _ptr(il),
        *[_ptr(a) for a in dra], *dra_dims, *[_ptr(a) for a in hetero], tk, dv, cfg["H"],
    ]
    conf = [
        _ptr(cfg["strat_cols"]), cfg["n_strat"], cfg["strategy"], _ptr(cfg["shape"]), cfg["n_shape"],
        _ptr(cfg["bal_cols"]), cfg["n_bal"],
        cfg["score_fit"], cfg["fit_weight"], cfg["score_bal"], cfg["bal_weight"], cfg["il_weight"],
        cfg["tp_weight"], cfg["ls_weight"],
        cfg["filter_codes"], cfg["n_filters"], cfg["ext_sel"], c, n, r, s_ports,
    ]
    return head, conf, cfg, c, width


def _dra_args(state, pf: dict, c: int, dev) -> tuple[list, tuple]:
    """DynamicResources' inputs of eval_chunk, checked: the node columns,
    the chunk's claim slots (None when the batch carries no resolved
    claim), its pins and missing flags; and (SK, PIN, DC)."""
    n = state.valid.shape[0]
    dc, clm = state.dra_cap.shape[0], state.dra_claim_counts.shape[0]
    i32 = torch.int32
    pin = pf["dra_pin_ids"].shape[1]
    args = [
        _check("dra_cap", state.dra_cap, i32, (dc, n), dev),
        _check("dra_alloc", state.dra_alloc, i32, (dc, n), dev),
        _check("dra_claim_counts", state.dra_claim_counts, i32, (clm, n), dev),
    ]
    sk = 0
    if "dra_claim_ids" in pf:
        sk = pf["dra_claim_ids"].shape[1]
        args += [_check(key, pf[key], i32, (c, sk), dev) for key in ("dra_claim_ids", "dra_claim_cls", "dra_claim_cnt")]
    else:
        args += [None] * 3
    args += [_check("dra_pin_ids", pf["dra_pin_ids"], i32, (c, pin), dev),
             _check("dra_missing", pf["dra_missing"], torch.bool, (c,), dev)]
    return args, (sk, pin, dc)


def ipa_eval(state, pf: dict, feasible, total, fail, ipa: IpaSpec, phase: int = plain.IPA_BOTH):
    """InterPodAffinity's filter and score on top of eval_chunk's
    (feasible (C, N) bool, total (C, N) i64, fail_mask (C,) i32), IN PLACE;
    returns the three tensors.  The domain tables come from
    ``ipa.ctx.dom``.  ``phase`` IPA_FILTER launches the filter alone (a
    score weight of 0), IPA_SCORE the score alone (no fail bit)."""
    if _on_cpu(feasible):
        return plain.ipa_eval(state, pf, feasible, total, fail, ipa, phase)
    bit = plain.ipa_bit(ipa) if phase & plain.IPA_FILTER else -1
    weight = ipa.weight if phase & plain.IPA_SCORE else 0
    _check("fail_mask", fail, torch.int32, (feasible.shape[0],), feasible.device)
    args, scratch, smem, k = _ipa_args(state, pf, feasible, total, ipa, bit, weight)
    build.launch("ipa_eval", *args, _ptr(fail), *_ptr_list(scratch), smem, k, _stream(feasible.device))
    ipa_eval.launches += 1
    return feasible, total, fail


def _ptr_list(scratch) -> list:
    return [_ptr(t) for t in scratch]


def _ipa_args(state, pf: dict, feasible, total, ipa: IpaSpec, bit: int, weight: int):
    """ipa_eval's and ipa_eval_cols' launch arguments up to the fail mask,
    checked; the scratch (group lists, term lists, raw scores); the shared
    memory a CTA needs; the CTAs a pod (cluster_split)."""
    dom = ipa.ctx.dom
    dev = feasible.device
    c, n = feasible.shape
    tk = state.topo_vals.shape[1]
    g = state.group_counts.shape[0]
    et = state.et_counts.shape[0]
    dv = dom.group_dom.shape[2]
    ra, rs, npf = (pf[f"ipa_{p}_valid"].shape[1] for p in ("ra", "rs", "pf"))
    ipa_smem_bytes(ra, rs, npf, tk, dv)
    k = cluster_split(c, n, _sms(dev), IPA_ROWS_MIN, lambda k: ipa_smem(ra, rs, npf, tk, dv, k))
    smem = ipa_smem(ra, rs, npf, tk, dv, k)
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
    scratch = (
        torch.empty((c, 1 + rs + npf, g), dtype=i32, device=dev),
        torch.empty((c, 2, et), dtype=i32, device=dev),
        torch.empty((c, n), dtype=i64, device=dev),
    )
    args = [c, n, tk, dv, g, et, ra, rs, npf, bit, int(weight),
            *[_ptr(a) for a in node_args], *[_ptr(a) for a in pod_args], _ptr(feasible), _ptr(total)]
    return args, scratch, smem, k


def ipa_eval_cols(state, pf: dict, feasible, total, ipa: IpaSpec, phase: int):
    """ipa_eval's columns mode, for the attribution pass.  IPA_FILTER:
    InterPodAffinity's own verdict on every node, (C, N) bool, ANDed into
    ``feasible`` IN PLACE.  IPA_SCORE: its column before its weight,
    normalized over ``feasible`` and 0 off it, (C, N) i64, weight × column
    added into ``total`` IN PLACE.  Returns the verdict or the column."""
    if _on_cpu(feasible):
        return plain.ipa_eval_cols(state, pf, feasible, total, ipa, phase)
    if phase not in (plain.IPA_FILTER, plain.IPA_SCORE):
        raise ValueError("ipa_eval_cols: one phase a launch")
    dev = feasible.device
    filt = phase == plain.IPA_FILTER
    args, scratch, smem, k = _ipa_args(state, pf, feasible, total, ipa, 0 if filt else -1,
                                       0 if filt else ipa.weight)
    if not filt and not ipa.weight:
        raise ValueError("ipa_eval_cols: the score phase needs a weight")
    ok = torch.empty(feasible.shape, dtype=torch.bool, device=dev) if filt else None
    build.launch("ipa_eval_cols", *args, _ptr(None), *_ptr_list(scratch), _ptr(ok), smem, k, _stream(dev))
    ipa_eval_cols.launches += 1
    return ok if filt else scratch[2]


def conflict_pairs(pf: dict, nchunks: int, c: int):
    """(nchunks, C, C) bool chunk-mate conflict table of a batch whose pods
    carry inter-pod-affinity, topology-spread, volume-id, host-port or DRA
    claim features."""
    if _on_cpu(pf["valid"]):
        return plain.conflict_pairs(pf, nchunks, c)
    dev = pf["valid"].device
    k = nchunks * c
    ipa, spread = "ipa_ra_allmask" in pf, "tps_h_groups" in pf
    vdev, vcsi, vunb = "vol_dev_ids" in pf, "vol_csi_ids" in pf, "vol_unbound" in pf
    vport, vdra = "port_keys" in pf, "dra_claim_ids" in pf
    if not (ipa or spread or vdev or vcsi or vunb or vport or vdra):
        raise ValueError("conflict_pairs: the batch carries no affinity, spread, volume, port or claim features")
    g = pf["ipa_ra_allmask"].shape[1] if ipa else (pf["tps_h_groups"].shape[2] if spread else 0)
    rs = pf["ipa_rs_groups"].shape[1] if ipa else 0
    et = pf["ipa_et_match"].shape[1] if ipa else 0
    a = pf["ipa_own_terms"].shape[1] if ipa else 0
    ch = pf["tps_h_groups"].shape[1] if spread else 0
    sd = pf["vol_dev_ids"].shape[1] if vdev else 0
    sc = pf["vol_csi_ids"].shape[1] if vcsi else 0
    sp = pf["port_keys"].shape[1] if vport else 0
    sk = pf["dra_claim_ids"].shape[1] if vdra else 0
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
        ("port_keys", torch.int32, (k, sp), vport),
        ("dra_claim_ids", torch.int32, (k, sk), vdra),
        ("dra_claim_unalloc", torch.bool, (k, sk), vdra),
    ):
        args.append(_check(key, pf[key], dtype, shape, dev) if on else None)
    pairs = torch.empty((nchunks, c, c), dtype=torch.bool, device=dev)
    build.launch(
        "conflict_pairs", *[_ptr(x) for x in args], nchunks, c, g, rs, et, a, ch, sd, sc, sp, sk,
        _ptr(pairs), _stream(dev),
    )
    conflict_pairs.launches += 1
    return pairs


def select_host(feasible, total, steps, seed_mul: int, nominated_row, pos=None):
    """(pick (C,) i32, best (C,) i64, feasible count (C,) i32) per pod;
    with ``pos`` ((N,) i32, truncate_feasible's) ties count in rotated
    scan order.  In row mode each pod runs on a cluster of cluster_split
    CTAs, in pos mode on one CTA."""
    if _on_cpu(feasible):
        return plain.select_host(feasible, total, steps, seed_mul, nominated_row, pos)
    dev = feasible.device
    c, n = feasible.shape
    _check("feasible", feasible, torch.bool, (c, n), dev)
    _check("total", total, torch.int64, (c, n), dev)
    _check("steps", steps, torch.int64, (c,), dev)
    if nominated_row is not None:
        _check("nominated_row", nominated_row, torch.int32, (c,), dev)
    if pos is not None:
        _check("pos", pos, torch.int32, (n,), dev)
    pick = torch.empty(c, dtype=torch.int32, device=dev)
    best = torch.empty(c, dtype=torch.int64, device=dev)
    feas = torch.empty(c, dtype=torch.int32, device=dev)
    build.launch(
        "select_host",
        _ptr(feasible), _ptr(total), _ptr(steps), seed_mul & 0xFFFFFFFF,
        _ptr(nominated_row), c, n, _ptr(pos), _ptr(pick), _ptr(best), _ptr(feas),
        1 if pos is not None else cluster_split(c, n, _sms(dev), SELECT_ROWS_MIN, one_wave=True), _stream(dev),
    )
    select_host.launches += 1
    return pick, best, feas


def truncate_feasible(feasible, valid, order_pos, start, pod_valid, nvalid: int, limit: int):
    """Truncated mode's cut (plain.truncate_feasible): ``feasible`` (1, N)
    cut IN PLACE to the first ``limit`` feasible rows in rotated scan
    order, ``start`` (1,) i64 advanced IN PLACE; ``nvalid`` and ``limit``
    are the pass's node count and numFeasibleNodesToFind
    (plain.scan_counts, host ints); returns (feasible, pos (N,) i32,
    processed (1,) i32).  One pod a launch (truncated mode runs chunk 1);
    no host sync."""
    if _on_cpu(feasible):
        return plain.truncate_feasible(feasible, valid, order_pos, start, pod_valid, nvalid, limit)
    dev = feasible.device
    c, n = feasible.shape
    if c != 1:
        raise ValueError(f"truncate_feasible: one pod a launch (truncated mode runs chunk 1), not {c}")
    _check("feasible", feasible, torch.bool, (1, n), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    _check("order_pos", order_pos, torch.int32, (n,), dev)
    _check("start", start, torch.int64, (1,), dev)
    _check("pod_valid", pod_valid, torch.bool, (1,), dev)
    threads, rows = trunc_shape(n)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    processed = torch.empty(1, dtype=torch.int32, device=dev)
    build.launch(
        "truncate_feasible", _ptr(feasible), _ptr(valid), _ptr(order_pos), _ptr(start), _ptr(pod_valid),
        n, int(nvalid), int(limit), threads, rows, _ptr(pos), _ptr(processed), _stream(dev),
    )
    truncate_feasible.launches += 1
    return feasible, pos, processed


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
    # Host ports: absent when no pod of the batch asks for one.
    triples, keys = pf.get("port_triples"), pf.get("port_keys")
    sp = 0 if triples is None else triples.shape[1]
    if triples is not None:
        _check("port_triples", triples, i32, (c, sp), dev)
        _check("port_keys", keys, i32, (c, sp), dev)
        _check("state.port_counts", state.port_counts, i32, (state.port_counts.shape[0], n), dev)
        _check("state.portkey_counts", state.portkey_counts, i32, (state.portkey_counts.shape[0], n), dev)
    # DRA claim slots: absent when no pod of the batch has a resolved claim.
    dra = [pf.get(key) for key in ("dra_claim_ids", "dra_claim_cls", "dra_claim_cnt", "dra_claim_first")]
    sk = 0 if dra[0] is None else dra[0].shape[1]
    dc, clm = state.dra_alloc.shape[0], state.dra_claim_counts.shape[0]
    if dra[0] is not None:
        if sk > 64:
            raise NotImplementedError(f"resolve_commit: {sk} DRA claim slots per pod exceed 64")
        for key, t_, dtype in zip(("dra_claim_ids", "dra_claim_cls", "dra_claim_cnt", "dra_claim_first"), dra,
                                  (i32, i32, i32, torch.bool)):
            _check(key, t_, dtype, (c, sk), dev)
        _check("state.dra_claim_counts", state.dra_claim_counts, i32, (clm, n), dev)
        _check("state.dra_alloc", state.dra_alloc, i32, (dc, n), dev)
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
        _ptr(triples), _ptr(keys), _ptr(state.port_counts), _ptr(state.portkey_counts),
        *[_ptr(x) for x in dra], _ptr(state.dra_claim_counts), _ptr(state.dra_alloc),
        c, n, r, tk, dv, na, sd, sc, dr, sp, sk, dc, _ptr(out), _stream(dev),
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


def node_filters(state, pf: dict, ctx, pin=None):
    """(K, N) u8 per-batch node filter bits of a batch's K pods: bit 0
    NodeAffinity's filter (with ``ctx.profile``'s added affinity), bit 1
    TaintToleration's, bit 2 VolumeBinding's, bit 3 VolumeZone's; a bit
    whose features the batch lacks is 1.  With ``pin`` ((K,) i32 rows in
    [0, N)), (K, 1): each pod on its own row alone (the pinned pass).
    Unpinned, a launch takes nf_tile's tiles of nodes and groups of pods
    (up to NF_TILE nodes and NF_GROUP pods a block)."""
    if _on_cpu(state.valid):
        return plain.node_filters(state, pf, ctx, pin)
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
    nt = group = 0
    if pin is None:
        nt, group = nf_tile(k, n, _sms(dev))
        out = torch.empty((k, n), dtype=torch.uint8, device=dev)
    else:
        _check("pin", pin, torch.int32, (k,), dev)
        out = torch.empty((k, 1), dtype=torch.uint8, device=dev)
    build.launch(
        "node_filters",
        *[_ptr(a) for a in _label_args(state, dev)],
        _ptr(sel), _ptr(has_req), *[_ptr(a) for a in req],
        _ptr(has_add), *[_ptr(a) for a in add],
        _ptr(intol), *[_ptr(a) for _on, prog, _d in vols for a in prog], _ptr(pin), _ptr(out),
        n, ls, ts, k, s, *req_dims, *add_dims, tv, *[d for _on, _p, dims in vols for d in dims],
        int(do_na), int(do_add), int(do_taint), *[int(on) for on, _p, _d in vols], nt, group,
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
    k, smem = spread_split(c, n, ch, dv, _sms(dev))
    node = [
        _check("topo_vals", state.topo_vals, torch.int32, (n, tk), dev),
        _check("valid", state.valid, torch.bool, (n,), dev),
        _check("group_counts", state.group_counts, torch.int32, (g, n), dev),
        _check("node_bits", node_bits, torch.uint8, (c, n), dev),
    ]
    glist = torch.empty((c * k, ch, g), dtype=torch.int32, device=dev)
    out = torch.empty((c, n), dtype=torch.bool, device=dev)
    build.launch(
        "spread_filter", *[_ptr(a) for a in node], *[_ptr(a) for a in feats], _ptr(glist), _ptr(out),
        c, n, tk, dv, g, ch, smem, k, _stream(dev),
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
    args, _raw, _glist = _late_args(state, pf, feasible, total, node_bits, late, pin, torch.empty)
    build.launch("late_scores", *args, _stream(dev))
    late_scores.launches += 1
    return total


def late_scores_cols(state, pf: dict, feasible, total, node_bits, late: LateSpec):
    """late_scores' columns mode, for the attribution pass: (3, C, N) i64,
    NodeAffinity's, TaintToleration's and PodTopologySpread's columns before
    their weights, normalized over ``feasible`` and given on every node as
    the ops give them (a column whose weight is 0 stays 0); weight × column
    is added into ``total`` IN PLACE on every node."""
    if _on_cpu(feasible):
        return plain.late_scores_cols(state, pf, feasible, total, node_bits, late)
    dev = feasible.device
    args, raw, _glist = _late_args(state, pf, feasible, total, node_bits, late, None, torch.zeros)
    build.launch("late_scores_cols", *args, _stream(dev))
    late_scores_cols.launches += 1
    return raw


def _late_args(state, pf: dict, feasible, total, node_bits, late: LateSpec, pin, alloc):
    """late_scores' and late_scores_cols' launch arguments, checked, up to
    the stream; the (3, C, width) i64 raw columns, made by ``alloc``; and
    the group lists' device scratch, which the caller holds until the
    launch."""
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
    k, smem = spread_split(c, width, cs, dv, _sms(dev))
    glist = torch.empty((c * k, cs, g), dtype=torch.int32, device=dev)
    raw = alloc((3, c, width), dtype=torch.int64, device=dev)
    args = [*[_ptr(a) for a in node], _ptr(nb), _ptr(feasible), _ptr(total), _ptr(pin),
            *[_ptr(a) for a in pref], _ptr(intol), *[_ptr(a) for a in soft], _ptr(table),
            _ptr(glist), _ptr(raw),
            c, n, ls, ts, tk, dv, g, *dims, tv, cs, max(n, dv) + 1,
            int(late.na_weight), int(late.taint_weight), int(late.spread_weight), smem, k]
    return args, raw, glist


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


def image_counts(state, vocab: int):
    """(vocab + 1,) i32: the number of valid nodes holding each image id
    below ``vocab`` (once per node), and last the number of valid nodes."""
    if _on_cpu(state.valid):
        return plain.image_counts(state, vocab)
    dev = state.valid.device
    n, im = state.image_ids.shape
    _check("image_ids", state.image_ids, torch.int32, (n, im), dev)
    _check("valid", state.valid, torch.bool, (n,), dev)
    counts = torch.zeros(vocab + 1, dtype=torch.int32, device=dev)
    build.launch("image_counts", _ptr(state.image_ids), _ptr(state.valid), n, im, vocab, _ptr(counts),
                 _stream(dev))
    image_counts.launches += 1
    return counts


def image_scores(state, pf: dict, counts, pin=None):
    """(K, N) u8 ImageLocality raw score of every pod of a batch on every
    node from image_counts' ``counts`` (0 on padding lanes); with ``pin``
    ((K,) i32 rows), (K, 1) on each pod's pinned row alone, its spread over
    that row (``counts`` may be None)."""
    if _on_cpu(pf["valid"]):
        return plain.image_scores(state, pf, counts, pin)
    dev = pf["valid"].device
    n, im = state.image_ids.shape
    k, ci = pf["il_image_ids"].shape
    if ci > MAX_POD_IMAGES:
        raise NotImplementedError(f"image_scores: {ci} image slots per pod exceed {MAX_POD_IMAGES}")
    args = [
        _check("image_ids", state.image_ids, torch.int32, (n, im), dev),
        _check("image_sizes", state.image_sizes, torch.int64, (n, im), dev),
        _check("valid", state.valid, torch.bool, (n,), dev),
    ]
    vocab = 0
    if pin is None:
        vocab = counts.shape[0] - 1
        args.append(_check("counts", counts, torch.int32, (vocab + 1,), dev))
    else:
        args.append(None)
    args += [
        _check("il_image_ids", pf["il_image_ids"], torch.int32, (k, ci), dev),
        _check("il_ncontainers", pf["il_ncontainers"], torch.int64, (k,), dev),
        _check("pod valid", pf["valid"], torch.bool, (k,), dev),
        None if pin is None else _check("pin", pin, torch.int32, (k,), dev),
    ]
    out = torch.empty((k, n if pin is None else 1), dtype=torch.uint8, device=dev)
    # Unpinned: image_merge's lists (scratch), then the tiled plane.
    p = slices = per = 0
    merged = (None, None, None)
    if pin is None:
        p, slices, per = image_grid(n, k, im, _sms(dev))
        merged = (torch.empty((n, p), dtype=torch.int32, device=dev),
                  torch.empty((n, p), dtype=torch.int64, device=dev),
                  torch.empty(n, dtype=torch.int32, device=dev))
    build.launch("image_scores", *[_ptr(a) for a in args], n, im, vocab, k, ci, *[_ptr(a) for a in merged],
                 p, slices, per, _ptr(out), _stream(dev))
    image_scores.launches += 1
    return out


# -- preemption and data moves ---------------------------------------------------


class Victims(NamedTuple):
    """The dry-run's per-node victim slots (preemption.py:716 pack_victims):
    least important first, PDB-violating last; empty slots hold the
    sentinels (priority INT32_MAX, zero requests, start +inf, no PDB, -1
    ids).  ``vfeat`` holds the what-if release features the active search
    ops read (group (N, V), terms (N, V, TS), port_triples/port_keys,
    vol_dev_ids/vol_dev_rw, csi_ids/csi_drv (N, V, S) i32); ``occupied``
    bounds the slots that can hold a victim (None: all V)."""

    prio: torch.Tensor  # (N, V) i32
    req: torch.Tensor  # (N, V, R) i64
    nonzero: torch.Tensor  # (N, V, 2) i64
    start: torch.Tensor  # (N, V) f64
    pdb: torch.Tensor  # (N, V, P) bool — victim matches budget p
    allowed: torch.Tensor  # (P,) i64 — disruptions allowed (INT32_MAX padding)
    vfeat: dict | None = None
    occupied: int | None = None


@dataclass(frozen=True)
class PreemptSpec:
    """What one dry-run evaluates: the release-independent filters
    (NodeUnschedulable, NodeName, and the node_filters bits that must be
    set: 1 NodeAffinity, 2 TaintToleration, 4 VolumeBinding, 8
    VolumeZone) and the active ops of the what-if search (node-local:
    NodePorts, VolumeRestrictions, NodeVolumeLimits, DynamicResources,
    whose hard filter also joins the release-independent ones; domain:
    InterPodAffinity, PodTopologySpread), with the pass context they read."""

    check_unsched: bool
    check_nodename: bool
    bits_mask: int
    ports: bool = False
    vr: bool = False
    nvl: bool = False
    ipa: bool = False
    pts: bool = False
    dra: bool = False
    ctx: object = None  # ops.common.PassContext

    @property
    def domain(self) -> bool:
        """A search op reads the domain tables: the dry-run is a host loop
        of dom_release and search_step between preempt_eval's PROLOGUE and
        TAIL."""
        return self.ipa or self.pts


class SearchCarry(NamedTuple):
    """The per-node state of a dry-run between its launches: the masked
    victim slots (bit j = slot j), their released requests and count, and
    the plain.F_* flags."""

    mask: torch.Tensor  # (N,) i64
    rel: torch.Tensor  # (N, R) i64
    cnt: torch.Tensor  # (N,) i32
    flags: torch.Tensor  # (N,) u8


def _mate_ptrs(pf: dict, c: int, dev) -> list:
    """valid, elig, spec_picks pointers of a chunk (valid, or the
    speculative pair)."""
    if "valid" in pf:
        return [_check("valid", pf["valid"], torch.bool, (c,), dev), None, None]
    return [None, _check("elig", pf["elig"], torch.bool, (c,), dev),
            _check("spec_picks", pf["spec_picks"], torch.int32, (c,), dev)]


def _opt(name: str, t, dtype, shape, dev):
    return None if t is None else _check(name, t, dtype, shape, dev)


# The order of search_args' pointer table and its dimensions, shared with
# kernels/csrc/preempt_search.cuh (enum Ptr, enum Dim).
_SEARCH_DIMS = ("C", "N", "V", "R", "P", "TK", "DV", "G", "ET", "TS", "PS", "SD", "SC", "QP", "QD", "QC",
                "DR", "RA", "RS", "K", "bits_mask", "flags", "step", "smem", "SK", "QK", "DC", "PIN")
N_SEARCH_PTRS = 96
# Per-victim and per-pod id slots, and the representative's terms and
# constraints, the search kernels hold in registers and static shared memory.
MAX_SEARCH_SLOTS = 16
SEARCH_SMEM_CAP = 200 * 1024
SEARCH_THREADS = 1024  # search_step: one block


def search_smem_bytes(dv: int, tk: int, ra: int, rs: int, k: int) -> int:
    """Dynamic shared memory of search_step: the own-term tallies (RA + RS
    terms), the forbidden table (TK x DV) and the spread count and presence
    tables (K x DV), int32 each.  Raises NotImplementedError above
    SEARCH_SMEM_CAP."""
    nbytes = 4 * dv * (ra + rs + tk + 2 * k)
    if nbytes > SEARCH_SMEM_CAP:
        raise NotImplementedError(f"search_step: {nbytes} bytes of domain tables exceed {SEARCH_SMEM_CAP}")
    return nbytes


def _search_args(state, vic: Victims, pf: dict, spec: PreemptSpec, carry, dom=None, outs=None,
                 scratch=None, step: int = 0, smem: int = 0):
    """(pointer table, dimensions) of preempt_eval and search_step: every
    tensor checked for device, type, shape and contiguity; None where the
    dry-run does not read it."""
    dev = state.valid.device
    n, v = vic.prio.shape
    r = state.alloc.shape[1]
    p = vic.allowed.shape[0]
    c = pf["priority"].shape[0]
    tk = state.topo_vals.shape[1]
    g, et = state.group_counts.shape[0], state.et_counts.shape[0]
    b, u8, i32, i64 = torch.bool, torch.uint8, torch.int32, torch.int64
    vf = vic.vfeat or {}
    dims = dict.fromkeys(_SEARCH_DIMS, 0)
    dims.update(C=c, N=n, V=v, R=r, P=p, TK=tk, G=g, ET=et, bits_mask=spec.bits_mask, step=step, smem=smem)
    # Bit i: NodeUnschedulable, NodeName, NodePorts, VolumeRestrictions,
    # NodeVolumeLimits, InterPodAffinity, PodTopologySpread, DynamicResources
    # (enum SpecFlag).
    dims["flags"] = sum(1 << i for i, on in enumerate(
        (spec.check_unsched, spec.check_nodename, spec.ports, spec.vr, spec.nvl, spec.ipa, spec.pts,
         spec.dra)) if on)
    if r > 16 or v > 64:
        raise NotImplementedError(f"preempt_eval: R={r} > 16 or V={v} > 64 victim slots")

    def width(key, dim):
        t = vf.get(key) if dim in ("TS", "PS", "SD", "SC", "SK") else pf.get(key)
        dims[dim] = 0 if t is None else t.shape[-1]
        if dims[dim] > MAX_SEARCH_SLOTS:
            raise NotImplementedError(f"preempt search: {dims[dim]} {key} slots exceed {MAX_SEARCH_SLOTS}")
        return dims[dim]

    ts = width("terms", "TS") if spec.domain else 0
    ps = width("port_triples", "PS") if spec.ports else 0
    sd = width("vol_dev_ids", "SD") if spec.vr else 0
    sc = width("csi_ids", "SC") if spec.nvl else 0
    qp = width("port_triples", "QP") if spec.ports else 0
    qd = width("vol_dev_ids", "QD") if spec.vr else 0
    qc = width("vol_csi_ids", "QC") if spec.nvl else 0
    sk = width("dra_kid", "SK") if spec.dra else 0
    qk = width("dra_claim_ids", "QK") if spec.dra else 0
    dims["DR"] = state.csi_used.shape[0] if spec.nvl else 0
    dc, clm = state.dra_cap.shape[0], state.dra_claim_counts.shape[0]
    pin = pf["dra_pin_ids"].shape[1] if spec.dra else 0
    dims.update(DC=dc if spec.dra else 0, PIN=pin)
    vd, cv, dr = state.dev_counts.shape[0], state.csivol_counts.shape[0], state.csi_used.shape[0]
    npc, npk = state.port_counts.shape[0], state.portkey_counts.shape[0]
    ra = pf["ipa_ra_valid"].shape[1] if spec.ipa else 0
    rs = pf["ipa_rs_valid"].shape[1] if spec.ipa else 0
    k = pf["tps_h_valid"].shape[1] if spec.pts else 0
    if max(ra, rs, k) > MAX_SEARCH_SLOTS:
        raise NotImplementedError(f"preempt search: RA={ra}, RS={rs} or K={k} exceeds {MAX_SEARCH_SLOTS}")
    dims.update(RA=ra, RS=rs, K=k, DV=spec.ctx.schema.DV if spec.domain else 0)
    dom_ptrs = [None] * 4
    if dom is not None:
        dv = dom.group_dom.shape[2]
        dom_ptrs = [_check("group_dom", dom.group_dom, torch.float32, (g, tk, dv), dev),
                    _check("et_dom", dom.et_dom, torch.float32, (et, dv), dev),
                    _check("et_slot", dom.et_slot, i32, (et,), dev), _check("et_host", dom.et_host, b, (et,), dev)]
    pod = lambda key, dtype, shape, on=True: _check(key, pf[key], dtype, shape, dev) if on else None  # noqa: E731
    vfp = lambda key, w, on: _check(key, vf[key], i32, (n, v) if w is None else (n, v, w), dev) if on and key in vf else None  # noqa: E731,E501
    ptrs = [
        _check("valid", state.valid, b, (n,), dev), _check("name_id", state.name_id, i32, (n,), dev),
        _check("unschedulable", state.unschedulable, b, (n,), dev),
        _check("num_pods", state.num_pods, i32, (n,), dev), _check("allowed_pods", state.allowed_pods, i32, (n,), dev),
        _check("alloc", state.alloc, i64, (n, r), dev), _check("req", state.req, i64, (n, r), dev),
        _check("topo_vals", state.topo_vals, i32, (n, tk), dev),
        _check("group_counts", state.group_counts, i32, (g, n), dev) if spec.domain else None,
        _check("et_counts", state.et_counts, i32, (et, n), dev) if spec.ipa else None,
        _check("port_counts", state.port_counts, i32, (npc, n), dev) if spec.ports else None,
        _check("portkey_counts", state.portkey_counts, i32, (npk, n), dev) if spec.ports else None,
        _check("dev_counts", state.dev_counts, i32, (vd, n), dev) if spec.vr else None,
        _check("dev_rw_counts", state.dev_rw_counts, i32, (vd, n), dev) if spec.vr else None,
        _check("csivol_counts", state.csivol_counts, i32, (cv, n), dev) if spec.nvl else None,
        _check("csi_used", state.csi_used, i32, (dr, n), dev) if spec.nvl else None,
        _check("csi_limit", state.csi_limit, i32, (dr, n), dev) if spec.nvl else None,
        _check("vic_prio", vic.prio, i32, (n, v), dev), _check("vic_req", vic.req, i64, (n, v, r), dev),
        _check("vic_nonzero", vic.nonzero, i64, (n, v, 2), dev),
        _check("vic_start", vic.start, torch.float64, (n, v), dev), _check("vic_pdb", vic.pdb, b, (n, v, p), dev),
        _check("pdb_allowed", vic.allowed, i64, (p,), dev),
        vfp("group", None, spec.domain), vfp("terms", ts, spec.ipa),
        vfp("port_triples", ps, spec.ports), vfp("port_keys", ps, spec.ports),
        vfp("vol_dev_ids", sd, spec.vr), vfp("vol_dev_rw", sd, spec.vr),
        vfp("csi_ids", sc, spec.nvl), vfp("csi_drv", sc, spec.nvl),
        pod("priority", i32, (c,)), pod("req", i64, (c, r)),
        pod("nodename_id", i32, (c,), spec.check_nodename),
        pod("tolerates_unschedulable", b, (c,), spec.check_unsched),
        *_mate_ptrs(pf, c, dev),
        pod("node_bits", u8, (c, n), bool(spec.bits_mask) or spec.pts),
        pod("vr_rwop_ok", b, (c,), spec.vr),
        pod("port_triples", i32, (c, qp), spec.ports and qp > 0), pod("port_keys", i32, (c, qp), spec.ports and qp > 0),
        pod("port_wild_triples", i32, (c, qp), spec.ports and qp > 0),
        pod("port_is_wild", b, (c, qp), spec.ports and qp > 0),
        pod("vol_dev_ids", i32, (c, qd), qd > 0), pod("vol_dev_rw", b, (c, qd), qd > 0),
        pod("vol_csi_ids", i32, (c, qc), qc > 0), pod("vol_csi_drv", i32, (c, qc), qc > 0),
        pod("ipa_ra_valid", b, (c, ra), spec.ipa), pod("ipa_ra_slot", i32, (c, ra), spec.ipa),
        pod("ipa_ra_host", b, (c, ra), spec.ipa), pod("ipa_ra_allmask", b, (c, g), spec.ipa),
        pod("ipa_ra_self", b, (c,), spec.ipa),
        pod("ipa_rs_valid", b, (c, rs), spec.ipa), pod("ipa_rs_slot", i32, (c, rs), spec.ipa),
        pod("ipa_rs_host", b, (c, rs), spec.ipa), pod("ipa_rs_groups", b, (c, rs, g), spec.ipa),
        pod("ipa_et_match", b, (c, et), spec.ipa), pod("ipa_et_anti", b, (c, et), spec.ipa),
        *[pod(f"tps_h_{f}", dtype, (c, k), spec.pts) for f, dtype in _SPREAD_FEATURES],
        pod("tps_h_groups", b, (c, k, g), spec.pts),
        *dom_ptrs,
        *([None] * 4 if carry is None else [
            _check("carry.mask", carry.mask, i64, (n,), dev), _check("carry.rel", carry.rel, i64, (n, r), dev),
            _check("carry.cnt", carry.cnt, i32, (n,), dev), _check("carry.flags", carry.flags, u8, (n,), dev)]),
        *([None] * 6 if outs is None else outs),
        *([None] * 2 if scratch is None else scratch),
        _check("dra_cap", state.dra_cap, i32, (dc, n), dev) if spec.dra else None,
        _check("dra_alloc", state.dra_alloc, i32, (dc, n), dev) if spec.dra else None,
        _check("dra_claim_counts", state.dra_claim_counts, i32, (clm, n), dev) if spec.dra else None,
        vfp("dra_kid", sk, spec.dra), vfp("dra_cid", sk, spec.dra), vfp("dra_cnt", sk, spec.dra),
        vfp("dra_first", sk, spec.dra),
        pod("dra_claim_ids", i32, (c, qk), qk > 0), pod("dra_claim_cls", i32, (c, qk), qk > 0),
        pod("dra_claim_cnt", i32, (c, qk), qk > 0),
        pod("dra_pin_ids", i32, (c, pin), spec.dra), pod("dra_missing", b, (c,), spec.dra),
    ]
    if len(ptrs) != N_SEARCH_PTRS:
        raise AssertionError(f"search pointer table holds {len(ptrs)} entries, want {N_SEARCH_PTRS}")
    return ptrs, [dims[d] for d in _SEARCH_DIMS]


def _launch_search(entry: str, ptrs: list, dims: list, dev, *geometry: int) -> None:
    table = (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr() for t in ptrs])
    ints = (ctypes.c_int * len(dims))(*dims)
    build.launch(entry, ctypes.cast(table, ctypes.c_void_p), len(ptrs), ctypes.cast(ints, ctypes.c_void_p),
                 len(dims), *geometry, _stream(dev))


def preempt_eval(state, vic: Victims, pf: dict, spec: PreemptSpec, mode: int = plain.FULL, carry=None):
    """One dry-run of the chunk's representative preemptor against every
    node.  FULL (no domain op in the search): (possible (N,) bool, crit
    (5, N) i64, vic_mask (N, V) bool, n_vic (N,) i32, rel (N, R) i64,
    relnz (N, 2) i64), the node-local search ops inside the reprieve loop;
    PROLOGUE: the SearchCarry that search_step advances; TAIL: FULL's
    outputs from that carry (``rel`` is the carry's).  One launch, a group
    of lanes a node in the geometry ``eval_split`` gives."""
    if _on_cpu(state.valid):
        return plain.preempt_eval(state, vic, pf, spec, mode, carry)
    dev = state.valid.device
    if mode == plain.FULL and spec.domain:
        raise ValueError("preempt_eval: a domain op of the search needs PROLOGUE, search_step and TAIL")
    n, v = vic.prio.shape
    r = state.alloc.shape[1]
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    outs = None
    if mode == plain.PROLOGUE:
        carry = SearchCarry(torch.empty(n, dtype=i64, device=dev), torch.empty((n, r), dtype=i64, device=dev),
                            torch.empty(n, dtype=i32, device=dev), torch.empty(n, dtype=torch.uint8, device=dev))
    else:
        outs = [torch.empty(n, dtype=b, device=dev), torch.empty((plain.N_CRIT, n), dtype=i64, device=dev),
                torch.empty((n, v), dtype=b, device=dev), torch.empty(n, dtype=i32, device=dev),
                carry.rel if mode == plain.TAIL else torch.empty((n, r), dtype=i64, device=dev),
                torch.empty((n, 2), dtype=i64, device=dev)]
    ptrs, dims = _search_args(state, vic, pf, spec, carry if mode == plain.TAIL or mode == plain.PROLOGUE else None,
                              outs=outs, step=mode)
    lanes, _nodes, threads, _blocks = eval_split(n, v, _sms(dev), *eval_smem(dict(zip(_SEARCH_DIMS, dims)), mode))
    _launch_search("preempt_eval", ptrs, dims, dev, lanes, threads)
    preempt_eval.launches += 1
    return carry if mode == plain.PROLOGUE else tuple(outs)


def dom_release(dom, state, vic: Victims, carry: SearchCarry, s: int):
    """(group_dom (G, TK, DV) f32, et_dom (ET, DV) f32) of the state with
    the carry's masked victims removed (slot ``s`` restored on every node
    when s >= 0): the live tables ``dom`` less each such victim's group and
    own terms at its node's domains."""
    if _on_cpu(carry.mask):
        return plain.dom_release(dom, state, vic, carry, s)
    dev = carry.mask.device
    n, v = vic.prio.shape
    g, tk, dv = dom.group_dom.shape
    et = dom.et_dom.shape[0]
    vf = vic.vfeat or {}
    group = _opt("group", vf.get("group"), torch.int32, (n, v), dev)
    terms = vf.get("terms")
    ts = 0 if terms is None else terms.shape[2]
    _opt("terms", terms, torch.int32, (n, v, ts), dev)
    args = [
        _check("group_dom", dom.group_dom, torch.float32, (g, tk, dv), dev),
        _check("et_dom", dom.et_dom, torch.float32, (et, dv), dev),
        _check("topo_vals", state.topo_vals, torch.int32, (n, tk), dev),
        _check("et_slot", dom.et_slot, torch.int32, (et,), dev),
        group, terms, _check("carry.mask", carry.mask, torch.int64, (n,), dev),
    ]
    group_dom = torch.empty_like(dom.group_dom)
    et_dom = torch.empty_like(dom.et_dom)
    build.launch("dom_release", *[_ptr(a) for a in args], g, et, tk, dv, n, v, ts, s,
                 _ptr(group_dom), _ptr(et_dom), _stream(dev))
    dom_release.launches += 1
    return group_dom, et_dom


def search_step(state, vic: Victims, pf: dict, spec: PreemptSpec, carry: SearchCarry, s: int,
                dom=None, dom_rel=None) -> None:
    """One step of the dry-run's search, IN PLACE on ``carry``
    (plain.search_step): HARD_STEP reads the live domain tables ``dom``,
    PHASE1 and the reprieve slots s >= 0 the released ones ``dom_rel``
    (dom_release of the same step)."""
    if _on_cpu(carry.mask):
        plain.search_step(state, vic, pf, spec, carry, s, dom, dom_rel)
        return
    dev = carry.mask.device
    tables = dom if s == plain.HARD_STEP else dom_rel
    if spec.ipa and tables is None:
        raise ValueError("search_step: InterPodAffinity reads the domain tables")
    k = pf["tps_h_valid"].shape[1] if spec.pts else 0
    ra = pf["ipa_ra_valid"].shape[1] if spec.ipa else 0
    rs = pf["ipa_rs_valid"].shape[1] if spec.ipa else 0
    dv = spec.ctx.schema.DV if spec.domain else 0
    smem = search_smem_bytes(dv, state.topo_vals.shape[1], ra, rs, k)
    g, et = state.group_counts.shape[0], state.et_counts.shape[0]
    scratch = [torch.empty((1 + rs + k, max(g, 1)), dtype=torch.int32, device=dev),
               torch.empty(max(et, 1), dtype=torch.int32, device=dev)]
    ptrs, dims = _search_args(state, vic, pf, spec, carry, dom=tables if spec.ipa else None,
                              scratch=scratch, step=s, smem=smem)
    _launch_search("search_step", ptrs, dims, dev)
    search_step.launches += 1


def preempt_pick(possible, crit, pf: dict, chunk_mode: bool):
    """(C,) i32 picks of a chunk's mates from preempt_eval's criteria (-2
    deferred at chunk > 1): one launch in the mode and cluster
    ``pick_split`` gives."""
    if _on_cpu(possible):
        return plain.preempt_pick(possible, crit, pf, chunk_mode)
    dev = possible.device
    n = possible.shape[0]
    c = pf["sig"].shape[0]
    _check("possible", possible, torch.bool, (n,), dev)
    _check("crit", crit, torch.int64, (plain.N_CRIT, n), dev)
    sig = _check("sig", pf["sig"], torch.int32, (c,), dev)
    mates = _mate_ptrs(pf, c, dev)
    picks = torch.empty(c, dtype=torch.int32, device=dev)
    if c == 0:
        return picks
    mode, k, s, threads = pick_split(c, n)
    cp = min(c, n)
    order_at = None if mode == PICK_ARGMIN else torch.empty(cp, dtype=torch.int32, device=dev)
    lists = torch.empty((k, 2, min(cp, s)), dtype=torch.int32, device=dev) if mode == PICK_TILED else None
    build.launch(
        "preempt_pick", _ptr(possible), _ptr(crit), *[_ptr(a) for a in mates], _ptr(sig), int(chunk_mode), c, n,
        mode, k, threads, _ptr(order_at), _ptr(lists), _ptr(picks), _stream(dev),
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


def unpack_victims(buf, r: int, n_pdbs: int, pdb_words: int, v: int, inline_allowed: bool, vf_cols=()):
    """The staged (N, vu, cols) int64 victim buffer → (prio, req, nonzero,
    start, pdb, allowed or None, vfeat), padded to ``v`` victim slots;
    ``vf_cols`` lists the victim feature columns (plain.unpack_victims)."""
    if _on_cpu(buf):
        return plain.unpack_victims(buf, r, n_pdbs, pdb_words, v, inline_allowed, vf_cols)
    dev = buf.device
    n, vu, cols = buf.shape
    if not buf.is_contiguous() or buf.dtype != torch.int64:
        raise ValueError("unpack_victims: the buffer must be contiguous int64")
    width = sum(w for _name, w, _nd in vf_cols)
    if cols < 5 + r + pdb_words + width or vu > v:
        raise ValueError(f"unpack_victims: buffer {tuple(buf.shape)} does not hold R={r}, v={v}")
    if len(vf_cols) > _MAX_VF_COLS:
        raise NotImplementedError(f"unpack_victims: {len(vf_cols)} victim feature fields exceed {_MAX_VF_COLS}")
    prio = torch.empty((n, v), dtype=torch.int32, device=dev)
    req = torch.empty((n, v, r), dtype=torch.int64, device=dev)
    nonzero = torch.empty((n, v, 2), dtype=torch.int64, device=dev)
    start = torch.empty((n, v), dtype=torch.float64, device=dev)
    pdb = torch.empty((n, v, n_pdbs), dtype=torch.bool, device=dev)
    allowed = torch.empty(n_pdbs, dtype=torch.int64, device=dev) if inline_allowed else None
    vfeat, meta, off = {}, [], 4 + r + pdb_words
    for name, w, ndim in vf_cols:
        vfeat[name] = torch.empty((n, v) if ndim == 2 else (n, v, w), dtype=torch.int32, device=dev)
        meta += [off, w, plain.VFEAT_PAD.get(name, 0)]
        off += w
    outs = (ctypes.c_void_p * max(len(vfeat), 1))(*[t.data_ptr() for t in vfeat.values()])
    ints = (ctypes.c_int * max(len(meta), 1))(*meta)
    build.launch(
        "unpack_victims", _ptr(buf), n, vu, cols, r, n_pdbs, pdb_words, v, int(inline_allowed),
        _ptr(prio), _ptr(req), _ptr(nonzero), _ptr(start), _ptr(pdb), _ptr(allowed),
        len(vfeat), ctypes.cast(outs, ctypes.c_void_p), ctypes.cast(ints, ctypes.c_void_p), _stream(dev),
    )
    unpack_victims.launches += 1
    return prio, req, nonzero, start, pdb, allowed, vfeat


_MAX_VF_COLS = 16


# scatter_rows' field table (rows.cu FieldDesc, FieldTable): up to
# MAX_SCATTER_FIELDS fields a launch.
MAX_SCATTER_FIELDS = 32


class _FieldDesc(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_uint64), ("src", ctypes.c_uint64), ("outer", ctypes.c_int64),
                ("n", ctypes.c_int64), ("inner", ctypes.c_int), ("word", ctypes.c_int)]


class _FieldTable(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_uint64), ("nrows", ctypes.c_int64), ("nfields", ctypes.c_int),
                ("pad", ctypes.c_int), ("f", _FieldDesc * MAX_SCATTER_FIELDS)]


class FlushSlot(NamedTuple):
    """One field of a packed row flush: its destination viewed as (outer,
    n, inner) bytes (axis 0: (1, N, a row's bytes); axis 1: (X, N, the
    element's bytes)) and the byte offset of its (outer, nrows, inner)
    rows in the packed buffer."""

    axis: int
    outer: int
    n: int
    inner: int
    offset: int


class FlushLayout(NamedTuple):
    """A packed row flush: the row index (nrows i64) at offset 0, then each
    field's rows at an 8-byte aligned offset; ``nbytes`` in all."""

    nrows: int
    slots: tuple[FlushSlot, ...]
    nbytes: int


def node_view(shape: tuple, itemsize: int, axis: int) -> tuple[int, int, int]:
    """(outer, n, inner bytes) of a field indexed by node on ``axis``."""
    if axis == 0 and len(shape) >= 1:
        inner = itemsize
        for d in shape[1:]:
            inner *= d
        return 1, shape[0], inner
    if axis == 1 and len(shape) == 2:
        return shape[0], shape[1], itemsize
    raise ValueError(f"scatter_rows: axis {axis} of a {len(shape)}-d field")


def flush_layout(fields, nrows: int) -> FlushLayout:
    """The packed buffer of ``nrows`` dirty rows of ``fields``, each a
    (shape, itemsize, axis) of its destination."""
    off = 8 * nrows
    slots = []
    for shape, itemsize, axis in fields:
        outer, n, inner = node_view(tuple(shape), itemsize, axis)
        slots.append(FlushSlot(axis, outer, n, inner, off))
        off += -(-outer * nrows * inner // 8) * 8
    return FlushLayout(nrows, tuple(slots), off)


def pack_rows(buf: np.ndarray, layout: FlushLayout, rows: np.ndarray, arrays) -> None:
    """Write the row index ``rows`` (i64) and each host array's rows (axis
    0) or columns (axis 1) ``rows`` into ``buf`` (u8, at least
    layout.nbytes) where ``layout`` places them."""
    m = layout.nrows
    buf[:8 * m].view(np.int64)[:] = rows
    for slot, arr in zip(layout.slots, arrays):
        view = buf[slot.offset:slot.offset + slot.outer * m * slot.inner].view(arr.dtype)
        if slot.axis == 0:
            np.take(arr, rows, axis=0, out=view.reshape((m,) + arr.shape[1:]), mode="clip")
        else:
            np.take(arr, rows, axis=1, out=view.reshape(slot.outer, m), mode="clip")


def field_descs(dsts, layout: FlushLayout, base: int) -> list[tuple[int, int, int, int, int, int]]:
    """scatter_rows' descriptor of each field: (dst address, src address =
    ``base`` + its offset, outer, n, inner, word), the word the largest of
    8, 4, 2, 1 bytes that divides inner and both addresses."""
    out = []
    for dst, slot in zip(dsts, layout.slots):
        d, s = dst.data_ptr(), base + slot.offset
        word = 8
        while word > 1 and (slot.inner % word or d % word or s % word):
            word //= 2
        out.append((d, s, slot.outer, slot.n, slot.inner, word))
    return out


def _launch_scatter(descs, rows: int, nrows: int, dev) -> None:
    table = _FieldTable(rows=rows, nrows=nrows, nfields=len(descs))
    for i, desc in enumerate(descs):
        table.f[i] = _FieldDesc(*desc)
    build.launch("scatter_rows", ctypes.c_void_p(ctypes.addressof(table)), _stream(dev))
    scatter_rows.launches += 1


def scatter_rows(dst, axis: int, rows, src) -> None:
    """In place: dst's node rows (axis 0) or node columns (axis 1, a 2-D
    (X, N) field) ``rows`` (i64) ← ``src`` (the same layout with len(rows)
    in place of N); one launch with one field."""
    if _on_cpu(dst):
        plain.scatter_rows(dst, axis, rows, src)
        return
    dev = dst.device
    nrows = rows.shape[0]
    outer, n, inner = node_view(tuple(dst.shape), dst.element_size(), axis)
    if not dst.is_contiguous():
        raise ValueError("scatter_rows: destination not contiguous")
    _check("rows", rows, torch.int64, (nrows,), dev)
    _check("src", src, dst.dtype, (nrows,) + tuple(dst.shape[1:]) if axis == 0 else (outer, nrows), dev)
    layout = FlushLayout(nrows, (FlushSlot(axis, outer, n, inner, 0),), 0)
    _launch_scatter(field_descs([dst], layout, src.data_ptr()), rows.data_ptr(), nrows, dev)


def scatter_fields(dsts, axes, buf, layout: FlushLayout) -> None:
    """In place, one launch: each of ``dsts``' node rows (axis 0) or
    columns (axis 1) ← its rows in the packed buffer ``buf`` (u8, on the
    destinations' device), placed as ``layout`` says (pack_rows; the row
    index is its first nrows i64 words)."""
    if _on_cpu(buf):
        plain.scatter_fields(dsts, axes, buf, layout)
        return
    dev = buf.device
    if len(dsts) > MAX_SCATTER_FIELDS:
        raise NotImplementedError(f"scatter_fields: {len(dsts)} fields exceed {MAX_SCATTER_FIELDS}")
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous() or buf.numel() < layout.nbytes:
        raise ValueError(f"scatter_fields: buffer {buf.dtype}{tuple(buf.shape)}, want u8 of {layout.nbytes}")
    if len(dsts) != len(layout.slots) or len(axes) != len(dsts):
        raise ValueError("scatter_fields: fields, axes and layout differ in length")
    for i, (dst, axis, slot) in enumerate(zip(dsts, axes, layout.slots)):
        if dst.device != dev or not dst.is_contiguous():
            raise ValueError(f"scatter_fields: field {i} on {dst.device} or not contiguous")
        if axis != slot.axis or node_view(tuple(dst.shape), dst.element_size(), axis) != slot[1:4]:
            raise ValueError(f"scatter_fields: field {i} {tuple(dst.shape)} does not match its slot {slot}")
    _launch_scatter(field_descs(dsts, layout, buf.data_ptr()), buf.data_ptr(), layout.nrows, dev)


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
    "image_counts": image_counts,
    "image_scores": image_scores,
    "preempt_eval": preempt_eval,
    "preempt_pick": preempt_pick,
    "preempt_commit": preempt_commit,
    "dom_release": dom_release,
    "search_step": search_step,
    "unpack_victims": unpack_victims,
    "scatter_rows": scatter_rows,
    "expand_rows": expand_rows,
    "pinned_fit": pinned_fit,
    "truncate_feasible": truncate_feasible,
    # The attribution pass's columns modes.
    "eval_chunk/cols": eval_chunk_cols,
    "ipa_eval/cols": ipa_eval_cols,
    "late_scores/cols": late_scores_cols,
}
for _fn in WRAPPERS.values():
    _fn.launches = 0


# eval_chunk's launches by score term or mode (see eval_chunk).
EVAL_TERMS = ("rtcr", "throughput", "learned", "after_ipa")
eval_chunk.term_launches = dict.fromkeys(EVAL_TERMS, 0)


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    eval_chunk.term_launches = dict.fromkeys(EVAL_TERMS, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
