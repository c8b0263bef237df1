"""Decision provenance: explain-this-binding and per-op attribution.

Counterpart of ``kubernetes_tpu/framework/provenance.py`` (the whole
module, kept line for line).  Upstream kube-scheduler's most basic
observability surface (``Diagnosis``/``NodeToStatusMap``,
schedule_one.go:196) answers "why did this pod land here, and why was
every other node rejected?"; this module is the batched-device analog.

Pieces:

- ``DecisionCapsule`` / ``ProvenanceRing``: a bounded ring of live
  decisions recorded at the commit path — the pod's picked row, total
  score, feasible count, fail mask, tie-break step, nomination, and the
  bind record's journal seq once a journal exists.  OFF by default: the
  scheduler records only when ``arm_provenance()`` has been called, so
  unarmed runs pay a single ``is not None`` test per bind and stay
  byte-identical.

- Host-side mirrors of the device tie-break (``hash_u32``,
  ``tie_rand_for``) and selectHost (``select_host_trace``) — exact
  integer replicas of the ``select_host`` kernel's row-order kth-tie
  semantics, so an explain record can reconstruct the argmax trace (best
  score, tie set, kth index, picked row) on the host and check it against
  the recorded live decision bit for bit.

- ``assemble_record``: the structured decision record — per-op per-node
  filter verdicts with the rejecting plugin named, per-op normalized
  score columns, the selectHost trace, and the recorded capsule — built
  from one attribution pass (engine/pass_.build_attribution_pass) plus a
  capsule.

- ``diff_records``: the first-divergence comparator — walks two records'
  columns in op order and names the exact first (op, node) cell that
  differs, down to the tie-break seed.

Determinism contract: no wall clocks, no entropy, no salted hashing, no
unordered set iteration — every list in a record is row-order or sorted,
so two same-seed runs emit byte-identical records.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

#: Knuth multiplicative constant — the seed mixer the device pass uses
#: (kernels/csrc/select_host.cu: seed * 2654435761 + step).
SEED_MUL = 2654435761

#: Sentinel the device's select_host uses for infeasible rows.
NEG_SCORE = -(2 ** 62)


def hash_u32(x: int) -> int:
    """Exact integer mirror of the pass's uint32 tie hash (kernels/plain.py
    hash_u32; splitmix32-style avalanche) — pure function of its argument."""
    x &= 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    x = ((x ^ (x >> 15)) * 0x846CA68B) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    return x


def tie_rand_for(seed: int, step: int) -> int:
    """The device pass's per-decision tie-break draw:
    ``_hash_u32(seed * SEED_MUL + step)`` in uint32 arithmetic."""
    return hash_u32(((seed & 0xFFFFFFFF) * SEED_MUL + (step & 0xFFFFFFFF)) & 0xFFFFFFFF)


def select_host_trace(
    feasible,
    total,
    tie_step: int | None,
    tie_break_seed: int,
    nomrow: int = -1,
    max_ties: int = 64,
) -> dict:
    """Host replica of the pass's select_host (row-order branch) with
    the full argmax trace: masked best score, the tie set, the kth index
    drawn from (seed, step), the picked row, and the nominated fast
    path.  ``tie_step`` None (no recorded capsule) degrades to kth=0 —
    flagged in the trace so a reader never mistakes it for the live
    draw."""
    feasible = np.asarray(feasible, bool)
    total = np.asarray(total, np.int64)
    masked = np.where(feasible, total, np.int64(NEG_SCORE))
    best = int(masked.max()) if masked.size else NEG_SCORE
    ties = feasible & (masked == best)
    m = int(ties.sum())
    tie_rand = None
    if tie_step is not None:
        tie_rand = tie_rand_for(tie_break_seed, tie_step)
    kth = int((tie_rand or 0) % max(m, 1))
    pick = -1
    if m > 0:
        order = np.cumsum(ties.astype(np.int32)) - 1
        pick = int(np.argmax(ties & (order == kth)))
    nominated = False
    if 0 <= nomrow < feasible.shape[0] and bool(feasible[nomrow]):
        # schedule_one.go:491 fast path: a feasible nominated node wins
        # without re-ranking — exactly what the device pass does.
        pick = int(nomrow)
        best = int(total[nomrow])
        nominated = True
    return {
        "tie_break_seed": int(tie_break_seed),
        "tie_step": None if tie_step is None else int(tie_step),
        "tie_rand": tie_rand,
        "best": best if m > 0 or nominated else None,
        "tie_count": m,
        "kth": kth,
        "tie_rows": [int(r) for r in np.nonzero(ties)[0][:max_ties]],
        "pick": pick,
        "nominated_fast_path": nominated,
    }


@dataclasses.dataclass
class DecisionCapsule:
    """One live decision, recorded at commit time: everything explain
    needs to reproduce (and assert against) the device's verdict."""

    uid: str
    node: str
    row: int
    score: int
    feasn: int
    fail_mask: int
    tie_step: int
    profile: str
    nomrow: int = -1
    seq: int | None = None  # bind record's journal seq (once durably logged)
    kind: str = "batch"  # batch | tail | pinned
    preemption: dict | None = None

    def as_dict(self) -> dict:
        return {
            "uid": self.uid,
            "node": self.node,
            "row": self.row,
            "score": self.score,
            "feasn": self.feasn,
            "fail_mask": self.fail_mask,
            "tie_step": self.tie_step,
            "profile": self.profile,
            "nomrow": self.nomrow,
            "seq": self.seq,
            "kind": self.kind,
            "preemption": self.preemption,
        }


class ProvenanceRing:
    """Bounded uid-keyed ring of DecisionCapsules (newest wins; oldest
    evicted past ``capacity``).  Insert-ordered, so iteration and
    eviction are deterministic."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._d: "OrderedDict[str, DecisionCapsule]" = OrderedDict()
        self._pending: dict[str, dict] = {}  # preemption info awaiting bind
        self.recorded = 0  # lifetime captures (exported at scrape time)

    def record(self, capsule: DecisionCapsule) -> None:
        self._d.pop(capsule.uid, None)
        self._d[capsule.uid] = capsule
        self.recorded += 1
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def note_seq(self, uid: str, seq: int | None) -> None:
        """Stamp the bind record's journal seq onto the capsule — called
        from the WAL write path, where the seq becomes known."""
        if seq is None:
            return
        cap = self._d.get(uid)
        if cap is not None and cap.seq is None:
            cap.seq = seq

    def note_preemption(self, uid: str, info: dict) -> None:
        """Attach the preemption rationale (victims, pickOneNode key) to
        the preemptor's NEXT capsule: parked until record() sees the
        uid, or merged into an existing capsule."""
        cap = self._d.get(uid)
        if cap is not None:
            cap.preemption = info
        else:
            self._pending[uid] = info

    def take_pending_preemption(self, uid: str) -> dict | None:
        return self._pending.pop(uid, None)

    def get(self, uid: str) -> DecisionCapsule | None:
        return self._d.get(uid)

    def __len__(self) -> int:
        return len(self._d)


def assemble_record(
    *,
    uid: str,
    mode: str,
    profile,
    active,
    node_names: list[str],
    filter_names: list[str],
    score_ops: list[tuple[str, int]],
    ok_cols,
    feasible,
    score_cols,
    total,
    nomrow: int,
    capsule: DecisionCapsule | None,
    truncated: bool = False,
    tie_step: int | None = None,
) -> dict:
    """The structured decision record.  All columns are snapshot row
    order over ``node_names``; JSON-clean throughout."""
    ok_cols = np.asarray(ok_cols, bool)
    feasible = np.asarray(feasible, bool)
    score_cols = np.asarray(score_cols, np.int64)
    total = np.asarray(total, np.int64)
    n = len(node_names)
    # Rejecting plugin per infeasible node: the FIRST op (bit order)
    # whose verdict is False while every earlier op still passed — the
    # reference's per-node Diagnosis entry (runtime/framework.go:861).
    first_reject: dict[str, str] = {}
    if len(filter_names):
        prefix_ok = np.ones(n, bool)
        for b, name in enumerate(filter_names):
            newly = prefix_ok & ~ok_cols[b]
            for r in np.nonzero(newly)[0]:
                first_reject[node_names[int(r)]] = name
            prefix_ok &= ok_cols[b]
    # The live step: the capsule's when the ring was armed, else the
    # caller-supplied one (journal-mode explain reads it off the bind
    # WAL record — the ring dies with the process, the WAL does not).
    if capsule is not None:
        tie_step = capsule.tie_step
    select = select_host_trace(
        feasible, total, tie_step, profile.tie_break_seed, nomrow=nomrow
    )
    picked = select["pick"]
    record = {
        "uid": uid,
        "mode": mode,
        "profile": profile.name,
        "active": sorted(active) if active is not None else None,
        "truncated": bool(truncated),
        "nodes": list(node_names),
        "filter_ops": list(filter_names),
        "score_ops": [[name, int(w)] for name, w in score_ops],
        "filter_cols": {
            name: [int(v) for v in ok_cols[b]]
            for b, name in enumerate(filter_names)
        },
        "score_cols": {
            name: [int(v) for v in score_cols[s]]
            for s, (name, _w) in enumerate(score_ops)
        },
        "feasible": [int(v) for v in feasible],
        "total": [int(v) for v in total],
        "first_reject": first_reject,
        "select": select,
        "picked_node": (
            node_names[picked] if 0 <= picked < n else None
        ),
        "nominated_row": int(nomrow),
        "decision": capsule.as_dict() if capsule is not None else None,
    }
    if capsule is not None:
        # capsule.row is a DEVICE row index; the record's columns are
        # trimmed to real nodes — compare by node name, and check the
        # recorded total on that node's trimmed column.
        try:
            crow = node_names.index(capsule.node)
        except ValueError:
            crow = -1
        record["agrees"] = bool(
            record["picked_node"] == capsule.node
            and crow >= 0
            and int(total[crow]) == capsule.score
        )
    else:
        record["agrees"] = None
    return record


# -- the first-divergence comparator ---------------------------------------


def diff_records(a: dict, b: dict) -> dict | None:
    """Compare two decision records for the same pod and localize the
    FIRST divergent cell, in evaluation order: node roster, then each
    filter op's column, then each score op's column, the total vector,
    and finally the selectHost trace (seed, step, rand, pick).  Returns
    None when identical, else a dict naming the component — the (pod,
    op, node) pinpoint the oracle harnesses print instead of a bare
    hash mismatch."""
    if a["nodes"] != b["nodes"]:
        for i, (na, nb) in enumerate(zip(a["nodes"], b["nodes"])):
            if na != nb:
                return {
                    "component": "nodes",
                    "row": i,
                    "a": na,
                    "b": nb,
                }
        return {
            "component": "nodes",
            "row": min(len(a["nodes"]), len(b["nodes"])),
            "a": len(a["nodes"]),
            "b": len(b["nodes"]),
        }
    nodes = a["nodes"]
    for kind, key in (("filter", "filter_cols"), ("score", "score_cols")):
        ops_a = list(a[key])
        ops_b = list(b[key])
        if ops_a != ops_b:
            return {"component": f"{kind}_ops", "a": ops_a, "b": ops_b}
        for op in ops_a:
            ca, cb = a[key][op], b[key][op]
            if ca != cb:
                for r, (va, vb) in enumerate(zip(ca, cb)):
                    if va != vb:
                        return {
                            "component": kind,
                            "op": op,
                            "node": nodes[r],
                            "row": r,
                            "a": va,
                            "b": vb,
                        }
    if a["total"] != b["total"]:
        for r, (va, vb) in enumerate(zip(a["total"], b["total"])):
            if va != vb:
                return {
                    "component": "total",
                    "node": nodes[r],
                    "row": r,
                    "a": va,
                    "b": vb,
                }
    for field in ("tie_break_seed", "tie_step", "tie_rand", "kth", "pick"):
        va, vb = a["select"].get(field), b["select"].get(field)
        if va != vb:
            return {"component": "select", "field": field, "a": va, "b": vb}
    pa, pb = a.get("picked_node"), b.get("picked_node")
    if pa != pb:
        return {"component": "picked_node", "a": pa, "b": pb}
    return None
