"""Batched preemption: the PostFilter dry-run as one device pass, closed form.

Counterpart of ``kubernetes_tpu/preemption.py`` (build_preempt_pass and
PreemptionEvaluator), for active filter sets whose release-dependent
filters reduce to NodeResourcesFit — the case where the JAX pass's
``search_ops`` is empty (preemption.py:211-247).  The reference's semantics
(framework/preemption/preemption.go + plugins/defaultpreemption/): every
node's pods below the preemptor's priority are released, the preemptor's
fit is checked in closed form against the released requests, victims are
reprieved most-important-first (SelectVictimsOnNode), and the node is
picked by five lexicographic criteria (pickOneNodeForPreemption: fewest
PDB violations, lowest max victim priority, smallest priority sum, fewest
victims, latest earliest start among the highest-priority victims).

The host packs every node's pods into (N, V) victim slots once per batch
(non-violating first, least important first within each class, with PDB
budgets consumed most-important-first to classify violating victims),
ships them as one int64 buffer and unpacks it on the device
(``unpack_victims``); an unchanged node's rows stay staged, and dirty rows
are written into the device buffer with ``scatter_rows``.  The JAX
``lax.scan`` over chunks of preemptors is a host loop of three kernel
launches per chunk (``preempt_eval``, ``preempt_pick``, ``preempt_commit``,
kernels/csrc/preempt.cu); chosen victims are consumed in the carried
priorities so later preemptors cannot claim them twice.  At chunk > 1 one
dry-run per chunk (its first valid pod's) is shared by the mates with the
same featurization signature, which take the 1st, 2nd, … best nodes; the
others defer (-2) and retry next batch.

The what-if search of the other release-dependent filters (NodePorts,
InterPodAffinity, PodTopologySpread, volumes, DRA; preemption.py:273-346,
:391) is a later slice: a dry-run whose active filters include one raises
NotImplementedError naming it, before any victim is touched.  So does a
filter this pass cannot evaluate, and a PodDisruptionBudget whose status
would have to be recomputed from its spec.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .api import types as t
from .engine.features import pod_sig
from .engine.pass_ import _pass_ops
from .kernels import PreemptSpec, Victims, plain
from .kernels.plain import NA, TT
from .snapshot import _bucket

I32_MAX = np.int32(2**31 - 1)

# Filters whose verdict can change when pods leave a node, and the subset
# the reference answers by a what-if search (preemption.py:223-231).
_RELEASE_DEPENDENT = frozenset({
    "NodeResourcesFit", "NodePorts", "InterPodAffinity", "PodTopologySpread",
    "VolumeRestrictions", "NodeVolumeLimits", "DynamicResources",
})
_SEARCHABLE = _RELEASE_DEPENDENT - {"NodeResourcesFit"}
# Release-independent filters preempt_eval applies on the live state.
_INVARIANT = frozenset({"NodeUnschedulable", "NodeName", NA, TT})


@dataclass
class PreemptionResult:
    node_name: str
    victims: list[t.Pod]


class PreemptStep(NamedTuple):
    picks: torch.Tensor  # (K,) i32 node row, -1 no candidate, -2 deferred
    vic_mask: torch.Tensor  # (K, V) bool — chosen victims at the picked node
    n_victims: torch.Tensor  # (K,) i32


def refusal(profile, active: frozenset[str] | None) -> str | None:
    """Why the closed-form dry-run cannot serve this active filter set, or
    None when it can."""
    names = [n for n in profile.filters if active is None or n in active]
    search = [n for n in names if n in _SEARCHABLE]
    if search:
        return (
            f"preemption's what-if search for {search} is not yet ported "
            "(closed-form NodeResourcesFit preemption only)"
        )
    other = [n for n in names if n not in _INVARIANT and n not in _RELEASE_DEPENDENT]
    if other:
        return f"preemption with the filters {other} active is not yet ported"
    return None


_KERNEL_FNS = (kernels.preempt_eval, kernels.preempt_pick, kernels.preempt_commit, kernels.node_filters)
_PLAIN_FNS = (plain.preempt_eval, plain.preempt_pick, plain.preempt_commit, plain.node_filters)


def build_preempt_pass(
    profile,
    schema,
    builder_res_col,
    active: frozenset[str] | None = None,
    chunk: int = 1,
    _impl: str = "kernel",
):
    """The dry-run for one (profile, schema, active-op-set, chunk).

    Returns run(state, batch, vic, steps=None) → (PreemptStep, final
    (req, nonzero_req, num_pods), final victim priorities).  ``batch`` holds
    (K,)-leading device tensors: the pods' features, ``sig`` (i32
    signature ids) and either ``valid`` or the speculative pair ``elig`` +
    ``spec_picks``.  ``steps`` (optional) lists the chunk indices to run;
    every other chunk must hold no valid pod, whose outputs are -1, no
    victims.  The input state and victims are not modified: the carry is
    a copy."""
    why = refusal(profile, active)
    if why is not None:
        raise NotImplementedError(why)
    if _impl not in ("kernel", "plain"):
        raise ValueError(f"_impl must be 'kernel' or 'plain', not {_impl!r}")
    ctx, filters, _scorers = _pass_ops(profile, schema, builder_res_col, active)
    spec = PreemptSpec(
        check_unsched="NodeUnschedulable" in filters,
        check_nodename="NodeName" in filters,
        bits_mask=(1 if NA in filters else 0) | (2 if TT in filters else 0),
    )
    eval_fn, pick_fn, commit_fn, nodes_fn = _PLAIN_FNS if _impl == "plain" else _KERNEL_FNS

    def run(state, batch: dict, vic: Victims, steps=None):
        k = batch["sig"].shape[0]
        if k % chunk:
            raise ValueError(f"preempt batch {k} not a multiple of {chunk}")
        carry = (state.req.clone(), state.nonzero_req.clone(), state.num_pods.clone())
        vic_prio = vic.prio.clone()
        st = dataclasses.replace(state, req=carry[0], nonzero_req=carry[1], num_pods=carry[2])
        tb = dict(batch)
        if spec.bits_mask:
            tb["node_bits"] = nodes_fn(state, tb, ctx)
        dev = state.valid.device
        nchunks = k // chunk
        picks = torch.full((k,), -1, dtype=torch.int32, device=dev)
        masks = torch.zeros((k, vic.prio.shape[1]), dtype=torch.bool, device=dev)
        nvics = torch.zeros(k, dtype=torch.int32, device=dev)
        for i in range(nchunks) if steps is None else steps:
            sl = slice(i * chunk, (i + 1) * chunk)
            pf = {key: v[sl] for key, v in tb.items()}
            ev = eval_fn(st, vic._replace(prio=vic_prio), pf, spec)
            p = pick_fn(ev[0], ev[1], pf, chunk > 1)
            m, nv = commit_fn(carry, vic_prio, ev, p)
            picks[sl], masks[sl], nvics[sl] = p, m, nv
        return PreemptStep(picks, masks, nvics), carry, vic_prio

    return run


def victims_from_numpy(buf: np.ndarray, layout: dict, device, _impl: str = "kernel") -> Victims:
    """A Victims on ``device`` from a staged victim buffer and its layout
    (``r``, ``n_pdbs``, ``pdb_words``, ``v``; ``allowed`` when the PDB
    counts do not ride the buffer's final column) — the JAX evaluator's
    staged buffer or this module's own, so tests feed both passes the same
    victims.  The buffer is copied to the device in one transfer and
    unpacked there."""
    d_buf = torch.from_numpy(np.ascontiguousarray(buf, np.int64)).to(device)
    return _unpack(d_buf, layout, _impl)


def _unpack(d_buf: torch.Tensor, layout: dict, _impl: str) -> Victims:
    inline = "allowed" not in layout
    unpack = plain.unpack_victims if _impl == "plain" else kernels.unpack_victims
    prio, req, nonzero, start, pdb, allowed = unpack(
        d_buf, layout["r"], layout["n_pdbs"], layout["pdb_words"], layout["v"], inline
    )
    if not inline:
        allowed = torch.as_tensor(np.asarray(layout["allowed"], np.int64), device=d_buf.device)
    return Victims(prio, req, nonzero, start, pdb, allowed)


class PreemptionEvaluator:
    """The host half: packs victim tensors once per failed batch, runs the
    dry-run and applies the chosen victims (prepareCandidate,
    preemption.go:342)."""

    def __init__(self, scheduler) -> None:
        self.sched = scheduler
        self._cache: dict = {}
        # Incremental victim staging: the staged arrays, the per-node victim
        # lists and the last device result, keyed by per-node pods_gen.
        self._stage: dict | None = None
        # Recent batches produced failures: the next batch prepacks victims
        # and chains a speculative dry-run on its device picks.
        self.expect_failures = False

    def worth_prepacking(self, pods) -> bool:
        """False when no pod of the batch could ever have victims."""
        cache = self.sched.cache
        if not cache.pods:
            return False
        min_prio = min(pr.pod.spec.priority for pr in cache.pods.values())
        return any(
            p.spec.priority > min_prio and p.spec.preemption_policy != t.PREEMPT_NEVER
            for p in pods
        )

    def _pass(self, profile, active, chunk: int):
        b = self.sched.builder
        key = (profile, b.schema, tuple(sorted(b.res_col.items())), active, chunk)
        fn = self._cache.get(key)
        if fn is None:
            fn = build_preempt_pass(profile, b.schema, b.res_col, active, chunk, _impl=self.sched._impl)
            self._cache[key] = fn
        return fn

    def pack_victims(self, profile, active: frozenset[str] | None) -> dict:
        """Stage (and ship to the device) every node's victim slots for one
        dry-run, from the current cache (preemption.py:716).  Incremental
        between calls while no PDB exists: only nodes whose pods_gen moved
        are repacked, and an unchanged cluster returns the previous device
        arrays."""
        sched = self.sched
        cache, builder = sched.cache, sched.builder
        schema = builder.schema
        pdbs = list(sched.pdbs.values())
        n_pdbs = _bucket(len(pdbs), 1)

        def matched_pdbs(p: t.Pod) -> list[int]:
            return [
                i
                for i, pdb in enumerate(pdbs)
                if pdb.namespace == p.namespace and t.label_selector_matches(pdb.selector, p.metadata.labels)
            ]

        names = set(profile.filters if active is None else active)
        cacheable = not pdbs and "DynamicResources" not in names
        if not cacheable:
            self._stage = None
        st = self._stage if cacheable else None
        if st is not None and not (
            st["n"] == schema.N
            and st["r"] == schema.R
            and st["names"] == names
            and st["profile"] is profile
            and st["active"] == active
        ):
            st = None
        if st is not None:
            return self._pack_incremental(st)

        # Non-violating first, least important first within each class;
        # "violating" simulates per-PDB budget consumption walking the
        # node's pods most important first (filterPodsWithPDBViolation).
        per_node: dict[int, list] = {}
        vmax = 1
        for rec in cache.nodes.values():
            viol: dict[str, bool] = {}
            if pdbs:
                remaining = [max(p.disruptions_allowed, 0) for p in pdbs]
                for p in sorted(rec.pods.values(), key=lambda p: (-p.spec.priority, p.status.start_time)):
                    v = False
                    for pi in matched_pdbs(p):
                        if remaining[pi] > 0:
                            remaining[pi] -= 1
                        else:
                            v = True
                    viol[p.uid] = v
            vics = sorted(
                rec.pods.values(),
                key=lambda p: (viol.get(p.uid, False), p.spec.priority, -p.status.start_time),
            )
            per_node[rec.row] = vics
            vmax = max(vmax, len(vics))
        v = _bucket(vmax)  # floor 8: one victim axis across the common range
        vu = _bucket(vmax, 1)  # the buffer ships only the occupied slots
        n = schema.N
        A = dict(
            vic_prio=np.full((n, vu), I32_MAX, np.int32),
            vic_req=np.zeros((n, vu, schema.R), np.int64),
            vic_nonzero=np.zeros((n, vu, 2), np.int64),
            vic_start=np.full((n, vu), np.inf, np.float64),
            vic_pdb=np.zeros((n, vu, n_pdbs), np.bool_),
            pdbs=pdbs,
            matched_pdbs=matched_pdbs,
        )
        self._fill_rows(A, per_node.items())
        st_new = (
            dict(
                n=n, r=schema.R, names=names, profile=profile, active=active,
                vmax=vmax, vu=vu, v=v, A=A, per_node=per_node,
                gens={rec.row: rec.pods_gen for rec in cache.nodes.values()},
            )
            if cacheable
            else None
        )
        result = self._assemble(A, n, v, n_pdbs, pdbs, matched_pdbs, per_node, profile, active, st=st_new)
        if st_new is not None:
            st_new["result"] = result
            st_new["buf_v"] = v
            self._stage = st_new
        return result

    def _pack_incremental(self, st: dict) -> dict:
        """Repack only the nodes whose pods_gen moved since the staged pack
        (preemption.py:939)."""
        cache = self.sched.cache
        A, per_node, gens = st["A"], st["per_node"], st["gens"]
        dirty: list = []
        live: set[int] = set()
        for rec in cache.nodes.values():
            live.add(rec.row)
            if gens.get(rec.row) != rec.pods_gen:
                dirty.append(rec)
        gone = [row for row in gens if row not in live]
        if not dirty and not gone:
            return st["result"]
        items: list[tuple[int, list]] = []
        vmax = st["vmax"]
        for rec in dirty:
            vics = sorted(rec.pods.values(), key=lambda p: (p.spec.priority, -p.status.start_time))
            items.append((rec.row, vics))
            vmax = max(vmax, len(vics))
        if vmax > st["vmax"]:
            st["vmax"] = vmax
            self._grow_victim_axis(st, vmax)
        self._clear_rows(A, [row for row, _ in items] + gone)
        for row in gone:
            per_node.pop(row, None)
            gens.pop(row, None)
        self._fill_rows(A, items)
        for rec, (row, vics) in zip(dirty, items):
            per_node[row] = vics
            gens[row] = rec.pods_gen
        rows = sorted({row for row, _ in items} | set(gone))
        buf = st.get("buf")
        layout_stable = (
            buf is not None
            and buf.shape[1] == A["vic_req"].shape[1]
            and st.get("buf_v") == st["v"]
        )
        if layout_stable and len(rows) <= 64:
            result = self._assemble_rows(st, rows)
        else:
            result = self._assemble(
                A, st["n"], st["v"], 1, A["pdbs"], A["matched_pdbs"], per_node,
                st["profile"], st["active"], st=st,
            )
            st["buf_v"] = st["v"]
        st["result"] = result
        return result

    def _scatter(self):
        return plain.scatter_rows if self.sched._impl == "plain" else kernels.scatter_rows

    def _assemble_rows(self, st: dict, rows: list) -> dict:
        """Rewrite only the dirty rows of the staged buffer and scatter them
        into the device copy (preemption.py:994)."""
        A, buf = st["A"], st["buf"]
        r = A["vic_req"].shape[2]
        idx = np.asarray(rows, np.int64)
        self._pack_buf_rows(A, buf, idx, r, 1)  # no PDBs on the incremental path
        dev = self.sched.device
        self._scatter()(
            st["d_buf"], 0, torch.from_numpy(idx).to(dev),
            torch.from_numpy(np.ascontiguousarray(buf[idx])).to(dev),
        )
        layout = {"r": r, "n_pdbs": 1, "pdb_words": 1, "v": st["v"]}
        return dict(st["result"], per_node=st["per_node"],
                    vic=_unpack(st["d_buf"], layout, self.sched._impl))

    def _grow_victim_axis(self, st: dict, vmax: int) -> None:
        vu_new = _bucket(vmax, 1)
        A = st["A"]
        if vu_new > st["vu"]:
            grow = vu_new - st["vu"]

            def pad1(arr, fill):
                w = [(0, 0)] * arr.ndim
                w[1] = (0, grow)
                return np.pad(arr, w, constant_values=fill)

            A["vic_prio"] = pad1(A["vic_prio"], I32_MAX)
            A["vic_req"] = pad1(A["vic_req"], 0)
            A["vic_nonzero"] = pad1(A["vic_nonzero"], 0)
            A["vic_start"] = pad1(A["vic_start"], np.inf)
            A["vic_pdb"] = pad1(A["vic_pdb"], False)
            st["vu"] = vu_new
        st["v"] = max(st["v"], _bucket(vmax))

    @staticmethod
    def _clear_rows(A: dict, rows: list) -> None:
        for row in rows:
            A["vic_prio"][row] = I32_MAX
            A["vic_req"][row] = 0
            A["vic_nonzero"][row] = 0
            A["vic_start"][row] = np.inf
            A["vic_pdb"][row] = False

    def _fill_rows(self, A: dict, items) -> None:
        """Write victim slots for the given (row, victims) pairs into the
        staging arrays — shared by the full pack and the incremental
        repack."""
        cache = self.sched.cache
        pdbs, matched_pdbs = A["pdbs"], A["matched_pdbs"]
        for row, vics in items:
            for j, p in enumerate(vics):
                pr = cache.pods[p.uid]
                req = pr.delta["req"]
                A["vic_prio"][row, j] = p.spec.priority
                A["vic_req"][row, j, : req.shape[0]] = req
                A["vic_nonzero"][row, j] = pr.delta["nonzero"]
                A["vic_start"][row, j] = p.status.start_time
                if pdbs:
                    for i in matched_pdbs(p):
                        A["vic_pdb"][row, j, i] = True

    @staticmethod
    def _pack_buf_rows(A: dict, buf, idx, r: int, n_pdbs: int) -> None:
        """Write the staging arrays' rows ``idx`` into the buffer — the one
        definition of its column layout (preemption.py:1146)."""
        nrows = buf.shape[0] if isinstance(idx, slice) else len(idx)
        buf[idx, :, 0] = A["vic_prio"][idx]
        buf[idx, :, 1 : 1 + r] = A["vic_req"][idx]
        buf[idx, :, 1 + r : 3 + r] = A["vic_nonzero"][idx]
        buf[idx, :, 3 + r] = A["vic_start"][idx].view(np.int64)
        pdb_words = max(1, (n_pdbs + 63) // 64)
        vic_pdb = A["vic_pdb"]
        for w_i in range(pdb_words):
            word = np.zeros((nrows, buf.shape[1]), np.int64)
            for i in range(w_i * 64, min((w_i + 1) * 64, n_pdbs)):
                word |= vic_pdb[idx, :, i].astype(np.int64) << (i % 64)
            buf[idx, :, 4 + r + w_i] = word

    def _assemble(
        self, A: dict, n: int, v: int, n_pdbs: int, pdbs, matched_pdbs, per_node: dict,
        profile, active, st: dict | None = None,
    ) -> dict:
        """Pack the staging arrays into one int64 buffer (prio, req[R],
        nonzero[2], start bits, PDB words, and pdb_allowed in a final
        column), ship it in one copy and unpack it on the device
        (preemption.py:1181)."""
        vic_req = A["vic_req"]
        vu, r = vic_req.shape[1], vic_req.shape[2]
        pdb_allowed = np.full(n_pdbs, I32_MAX, np.int64)
        for i, pdb in enumerate(pdbs):
            pdb_allowed[i] = max(pdb.disruptions_allowed, 0)
        pdb_words = max(1, (n_pdbs + 63) // 64)
        buf = np.zeros((n, vu, 4 + r + pdb_words + 1), np.int64)
        self._pack_buf_rows(A, buf, slice(None), r, n_pdbs)
        layout = {"r": r, "n_pdbs": n_pdbs, "pdb_words": pdb_words, "v": v}
        if n_pdbs <= n:
            buf[:n_pdbs, 0, -1] = pdb_allowed
        else:  # more budgets than node rows: the counts take their own copy
            layout["allowed"] = pdb_allowed
        d_buf = torch.from_numpy(buf).to(self.sched.device)
        if st is not None:
            st["buf"], st["d_buf"] = buf, d_buf
        return dict(
            profile=profile, active=active, pdbs=pdbs, n_pdbs=n_pdbs,
            matched_pdbs=matched_pdbs, per_node=per_node, buf=buf, layout=layout,
            vic=_unpack(d_buf, layout, self.sched._impl),
        )

    def _eligibility(self, pods, batch_req=None) -> list[bool]:
        """Host-side prunes (preemption.py:1343): a pod whose demand exceeds
        every node's allocatable, or whose priority does not exceed the
        lowest bound pod's, has no victims anywhere."""
        cache, builder = self.sched.cache, self.sched.builder
        max_alloc = builder.host["alloc"].max(axis=0)
        max_allowed = int(builder.host["allowed_pods"].max(initial=0))
        min_prio = min((pr.pod.spec.priority for pr in cache.pods.values()), default=None)

        def can_ever_fit(i: int, p: t.Pod) -> bool:
            if batch_req is not None:
                req = np.asarray(batch_req[i])
            else:
                pr = cache.pods.get(p.uid)
                req = (pr.delta if pr else builder.pod_delta_vectors(p))["req"]
            return bool((req <= max_alloc[: req.shape[0]]).all()) and max_allowed >= 1

        return [
            p.spec.preemption_policy != t.PREEMPT_NEVER
            and min_prio is not None
            and p.spec.priority > min_prio
            and can_ever_fit(i, p)
            for i, p in enumerate(pods)
        ]

    @staticmethod
    def _sig_ids(pods, k: int):
        """Chunk-sharing signatures (first-index representative ids) padded
        to k (preemption.py:1373)."""
        sig_first: dict = {}
        sigs = np.zeros(k, np.int32)
        for i, p in enumerate(pods):
            sigs[i] = sig_first.setdefault(pod_sig(p), i)
        return sigs, sig_first

    def _chunk_for(self, sig_first: dict, k: int) -> int:
        """Dry-run chunking (preemption.py:1426): a batch whose preemptors
        all share one signature runs as one rank-split step; otherwise the
        scheduler's chunk clamped to 64, halved until it divides k."""
        if self.sched.chunk_size > 1 and len(sig_first) == 1:
            chunk = k
        else:
            chunk = min(self.sched.chunk_size if self.sched.chunk_size > 1 else 1, 64)
        chunk = max(1, min(chunk, k))
        while k % chunk:
            chunk //= 2
        return chunk

    def preempt_batch(
        self, pods: list[t.Pod], batch_rows: dict, active=None, profile=None,
        prepacked: dict | None = None,
    ) -> list[PreemptionResult | None]:
        """Preemption for the failed pods of one batch (preemption.py:1251);
        ``batch_rows`` are each pod's feature rows.  Chunk-deferred
        preemptors return None and retry next batch."""
        sched = self.sched
        profile = profile or sched.profile
        eligible = self._eligibility(pods, batch_rows.get("req"))
        if not any(eligible):
            return [None] * len(pods)
        pack = prepacked
        if pack is None or pack["profile"] is not profile or pack["active"] != active:
            pack = self.pack_victims(profile, active)
        k = sched.batch_size
        dev = sched.device
        batch: dict = {}
        for key, rows in batch_rows.items():
            stacked = np.stack(rows)
            pad = [(0, k - len(pods))] + [(0, 0)] * (stacked.ndim - 1)
            batch[key] = torch.from_numpy(np.ascontiguousarray(np.pad(stacked, pad))).to(dev)
        valid = np.zeros(k, np.bool_)
        valid[: len(pods)] = eligible
        sigs, sig_first = self._sig_ids(pods, k)
        batch["valid"] = torch.from_numpy(valid).to(dev)
        batch["sig"] = torch.from_numpy(sigs).to(dev)
        chunk = self._chunk_for(sig_first, k)
        # Chunks without a valid preemptor pick nothing: skip their launches.
        steps = sorted({i // chunk for i in np.nonzero(valid)[0]})
        out, _carry, _prio = self._pass(profile, active, chunk)(
            sched.builder.state(), batch, pack["vic"], steps
        )
        picks, vmasks = (x.cpu().numpy() for x in (out.picks, out.vic_mask))
        return self._interpret_dryrun(pods, picks, vmasks, pack)

    def dispatch_speculative(self, ctx: dict, pack: dict):
        """The dry-run chained on the in-flight main pass's device picks
        (valid = eligible ∧ pick < 0, preemption.py:1389): it sees the
        post-scan state, before the strict tail commits.  Returns a handle
        for collect_speculative, or None when speculation does not apply."""
        sched = self.sched
        if "batch_d" not in ctx or refusal(ctx["profile"], ctx["active"]) is not None:
            return None
        pods = [qp.pod for qp in ctx["infos"]]
        eligible = self._eligibility(pods, ctx["batch"].get("req"))
        if not any(eligible):
            return None
        k = sched.batch_size
        dev = sched.device
        elig = np.zeros(k, np.bool_)
        elig[: len(pods)] = eligible
        sigs, sig_first = self._sig_ids(pods, k)
        chunk = self._chunk_for(sig_first, k)
        fn = self._pass(ctx["profile"], ctx["active"], chunk)
        b = {key: v for key, v in ctx["batch_d"].items() if key not in ("uniform_all", "valid")}
        b["elig"] = torch.from_numpy(elig).to(dev)
        b["spec_picks"] = ctx["result"].picks
        b["sig"] = torch.from_numpy(sigs).to(dev)
        out, _carry, _prio = fn(ctx["new_state"], b, pack["vic"])
        return dict(out=out, pack=pack)

    def collect_speculative(self, spec: dict, fetched, failed_pods_by_index: dict) -> dict:
        """Interpret the speculative results of the batch indices that
        finally failed; {batch index: result}."""
        picks, vmasks = fetched
        idxs = sorted(failed_pods_by_index)
        pods = [failed_pods_by_index[i] for i in idxs]
        results = self._interpret_dryrun(pods, picks[idxs], vmasks[idxs], spec["pack"])
        return dict(zip(idxs, results))

    def _interpret_dryrun(self, pods, picks, vmasks, pack) -> list[PreemptionResult | None]:
        """prepareCandidate over fetched results (preemption.py:1459):
        delete the victims (one batched POD_DELETE is the caller's), debit
        their PDBs, nominate the node; consumed victims dedup across the
        pass's preemptors."""
        sched = self.sched
        cache = sched.cache
        pdbs, matched_pdbs = pack["pdbs"], pack["matched_pdbs"]
        per_node = pack["per_node"]
        results: list[PreemptionResult | None] = []
        consumed: set[str] = set()
        for i, pod in enumerate(pods):
            pick = int(picks[i])
            if pick < 0 or pod is None:
                results.append(None)
                continue
            node_name = cache.node_name_at_row(pick)
            vics = per_node[pick]
            victims = [
                vics[j]
                for j in np.nonzero(vmasks[i])[0]
                if j < len(vics)
                and vics[j].spec.priority < pod.spec.priority
                and vics[j].uid not in consumed
            ]
            for vic in victims:
                consumed.add(vic.uid)
                sched.delete_pod(vic.uid, notify=False)
                for pi in matched_pdbs(vic):
                    pdbs[pi].disruptions_allowed -= 1
            pod.status.nominated_node_name = node_name
            results.append(PreemptionResult(node_name=node_name, victims=victims))
        return results

