"""The scheduler: the driving loop over queue → batch pass → bind → PostFilter.

Counterpart of ``kubernetes_tpu/scheduler.py`` (TPUScheduler): pop a batch
in QueueSort order, featurize it, run the batch pass on the device (filter,
score, select and commit for every pod of the batch), re-run chunk-deferred
pods through the host strict tail, bind the picks through the cache (the
device already committed them), and run PostFilter preemption for the pods
that failed: one batched dry-run (preemption.py), the victims deleted, the
preemptor committed on its freed node in the same batch (inline commit,
the default at chunk > 1) or nominated and requeued (the nominator's claims
then ride every pass as the fit overlay, and a batch of nominated pods takes
the pinned pass).

It keeps the JAX scheduler's ``_dispatch_batch``/``_complete_batch`` logic
(scheduler.py:3451-3625, 3764-4429) for the ported ops: the nominated-pod
overlay, the carried domain tables and their validity token, the ``_cycle``
tie-break seeds, conflict-aware chunk packing of affinity batches
(engine/packing.py), the uniform-batch expansion, the strict tail in two
rounds, the prefetch of the next batch before the current one completes,
and the speculative dry-run chained on the main pass's device picks when
recent batches failed.  Placed pods are assumed first, then VolumeBinding's
Reserve/PreBind runs in batch order and binds delayed claims
(framework/hostplugins.py); a pod whose reservation lost a same-batch race
is forgotten and sent to backoff (scheduler.py:3960-4150).  The
PV, PVC, StorageClass and CSINode informers feed the volume catalog.
Gangs, extenders, DRA, journaling, the PreBind wait room and the pipelined
predispatch are later slices; a pod that would need one raises
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kernels, resolve_device
from .api import types as t
from .cache import Cache
from .engine.features import build_pod_batch, pin_name, pod_sig
from .engine.packing import pack_batch
from .engine.pass_ import PINNED_SAFE_OPS, PassCache, filter_op_names
from .framework.config import DEFAULT_PROFILE, Profile
from .framework.hostplugins import VolumeReserve
from .intern import InternTable
from .kernels import plain
from .ops import common as opcommon
from .preemption import PreemptionEvaluator
from .queue import Event, EventCtx, QueuedPodInfo, SchedulingQueue
from .snapshot import SnapshotBuilder

# Hard filters whose verdict reads mutable node state a strict-tail commit
# can change (scheduler.py:116): a speculative preemption result cannot be
# re-checked host-side for them.
DYNAMIC_HARD_OPS = frozenset({
    "InterPodAffinity", "PodTopologySpread", "NodePorts", "VolumeRestrictions",
    "NodeVolumeLimits", "VolumeBinding", "VolumeZone", "DynamicResources",
})


@dataclass
class ScheduleOutcome:
    pod: t.Pod
    node_name: str | None  # None → unschedulable this round
    score: int = 0
    feasible_nodes: int = 0
    # Why the pod failed: the filter plugins that rejected nodes, from the
    # pass's per-op fail bitmask (framework/types.go Diagnosis).
    unschedulable_plugins: frozenset = frozenset()
    # PostFilter: the node a preemption nominated (or committed to) and
    # the victims it evicted.
    nominated_node: str | None = None
    victims: int = 0
    victim_uids: tuple = ()


class TorchScheduler:
    def __init__(
        self,
        profile: Profile = DEFAULT_PROFILE,
        batch_size: int = 256,
        chunk_size: int = 1,
        device: str | torch.device | None = None,
        *,
        queue: SchedulingQueue | None = None,
        _impl: str = "kernel",
    ):
        self.device = resolve_device(device)
        unknown = [
            n for n in (*profile.filters, *(s for s, _ in profile.scorers)) if not opcommon.has(n)
        ]
        if unknown:
            raise NotImplementedError(f"plugins {unknown} are not yet ported")
        if profile.percentage_of_nodes_to_score != 100:
            raise NotImplementedError("truncated (parity) mode is not yet ported")
        if batch_size % chunk_size:
            raise ValueError("batch_size must be a multiple of chunk_size")
        self.profile = profile
        self.batch_size = batch_size
        # chunk_size=1 → strictly sequential-equivalent pass; >1 → C pods per
        # step with conflict deferral + a strict tail for the deferred pods.
        self.chunk_size = chunk_size
        # Strict tail batches are padded to this size (scheduler.py:195).
        self.tail_size = min(batch_size, 64)
        self._impl = _impl
        self.interns = InternTable()
        self.builder = SnapshotBuilder(self.interns, device=self.device)
        self.builder._impl = _impl
        self.cache = Cache(self.builder)
        self.queue = queue if queue is not None else SchedulingQueue()
        self.passes = PassCache(_impl)
        # Carried domain tables: the previous pass's final (group_dom,
        # et_dom) and the (schema, mutation_epoch) token they are valid
        # under; any host mutation in between forces a rebuild.
        self._dom_carry: tuple | None = None
        self._dom_token: tuple | None = None
        # Tie-break cycle counter: the batch's seed base (scheduler.py:374).
        self._cycle = 0
        # The next batch, popped and featurized before the current one
        # completes (scheduler.py:3327).
        self._prefetched: tuple | None = None
        # Nominated pods: uid → (node name, delta, priority), the claims the
        # fit overlay protects (nominator.go).
        self.nominator: dict[str, tuple[str, dict, int]] = {}
        self.pdbs: dict[str, t.PodDisruptionBudget] = {}
        self.preemption = PreemptionEvaluator(self)
        # Inline preemptor commit (scheduler.py:269-279): at chunk > 1 a
        # successful preemptor commits on its freed node in the same batch
        # (the victims' deletion is synchronous); at chunk 1 it is
        # nominated and retried.
        self.inline_preempt_commit = chunk_size > 1
        self.deferred = 0  # chunk deferrals resolved by the strict tail
        # Batches that carried the domain tables / rebuilt them (build_dom).
        self.dom_carry_hits = 0
        self.dom_carry_rebuilds = 0
        # Conflict-aware packing (scheduler.py:3518-3557): batches reordered,
        # residual same-chunk collisions planned, the last packed width.
        self.packed_batches = 0
        self.pack_collisions = 0
        self.pack_width: int | None = None
        # PostFilter: successful preemptions, speculative dry-runs, pinned
        # batches, and the (victim, preemptor, node) of every eviction.
        self.preemptions = 0
        self.speculative_batches = 0
        self.pinned_batches = 0
        self.preempted: list[tuple[str, str, str]] = []
        # VolumeBinding's Reserve/PreBind, run on every placed pod with a claim.
        self.volume_reserve = VolumeReserve()
        # Pods whose reservation lost a same-batch race (forgotten, to backoff).
        self.reserve_failures = 0

    # -- cluster events --------------------------------------------------------

    def add_node(self, node: t.Node) -> None:
        self.cache.add_node(node)
        # Replay a CSINode that arrived before its Node (informer races).
        csinode = self.builder.volumes.csinodes.get(node.name)
        if csinode is not None:
            self.builder.set_csinode_limits(self.cache.row_of(node.name), csinode)
        self.queue.on_event(Event.NODE_ADD, self._free_ctx({self.cache.row_of(node.name)}))

    def add_pod(self, pod: t.Pod) -> None:
        """Unassigned pods enter the queue; assigned pods enter the cache
        (eventhandlers.go:126 addPodToSchedulingQueue / :203 addPodToCache)."""
        if pod.spec.pod_group:
            raise NotImplementedError("gang scheduling (Coscheduling) is not yet ported")
        if pod.spec.node_name:
            if pod.uid in self.cache.pods:
                raise NotImplementedError("pod updates are not yet ported")
            self.queue.delete(pod.uid)
            self.cache.add_pod(pod)
            self.queue.on_event(Event.POD_ADD)
            return
        if pod.spec.scheduler_name not in (self.profile.name, "default-scheduler"):
            return  # another scheduler's pod (responsibleForPod)
        if pod.uid in self.cache.pods:
            return  # re-delivery of a pod already bound here
        self.queue.add(pod)

    def delete_pod(self, uid: str, notify: bool = True) -> None:
        """A pod's deletion (scheduler.py:1591, :1622 _unwind_pod).
        ``notify=False`` batches the requeue wake-up: preemption deletes
        victims in bulk and fires one POD_DELETE for the batch."""
        if self._prefetched is not None and any(qp.pod.uid == uid for qp in self._prefetched[0]):
            # The prefetched batch would schedule the deleted pod: hand it
            # back to the queue without it.
            infos, _work = self._prefetched
            self._prefetched = None
            for qp in infos:
                if qp.pod.uid == uid:
                    self.queue._info.pop(uid, None)
                else:
                    self.queue.reactivate(qp)
        self.nominator.pop(uid, None)
        rec = self.cache.pods.get(uid)
        if rec is None:
            self.queue.delete(uid)
            return
        node_rec = self.cache.nodes.get(rec.node_name)
        self.cache.remove_pod(uid)
        if notify:
            ctx = self._free_ctx({node_rec.row}) if node_rec is not None else None
            self.queue.on_event(Event.POD_DELETE, ctx)

    def add_pdb(self, pdb: t.PodDisruptionBudget) -> None:
        """PodDisruptionBudget informer (scheduler.py:1696): preemption counts
        victims against these budgets.  A budget that carries spec fields
        would need the disruption controller to recompute its status, which
        is not ported."""
        if pdb.min_available is not None or pdb.max_unavailable is not None:
            raise NotImplementedError(
                "PodDisruptionBudget spec (minAvailable/maxUnavailable) reconciliation is not yet ported"
            )
        self.pdbs[pdb.name] = pdb

    # -- volume objects (the PV/PVC/StorageClass/CSINode informers,
    # scheduler.py:1721-1860) ------------------------------------------------

    def add_pv(self, pv: t.PersistentVolume) -> None:
        self.builder.volumes.add_pv(pv)
        self.queue.on_event(Event.PV_ADD)

    def add_pvc(self, pvc: t.PersistentVolumeClaim) -> None:
        self.builder.volumes.add_pvc(pvc)
        self.queue.on_event(Event.PVC_ADD)

    def add_storage_class(self, sc: t.StorageClass) -> None:
        self.builder.volumes.add_class(sc)
        self.queue.on_event(Event.PVC_ADD)

    def add_csinode(self, csinode: t.CSINode) -> None:
        self.builder.volumes.add_csinode(csinode)
        rec = self.cache.nodes.get(csinode.name)
        if rec is not None:
            self.builder.set_csinode_limits(rec.row, csinode)
        self.queue.on_event(Event.NODE_UPDATE)

    def remove_pv(self, name: str) -> None:
        vols = self.builder.volumes
        pv = vols.pvs.pop(name, None)
        if pv is None:
            return
        vols.unbound.get(pv.storage_class, {}).pop(name, None)
        vols.epoch += 1

    def remove_pvc(self, uid: str) -> None:
        vols = self.builder.volumes
        if vols.pvcs.pop(uid, None) is None:
            return
        vols.pvc_users.pop(uid, None)
        vols.epoch += 1

    def remove_storage_class(self, name: str) -> None:
        if self.builder.volumes.classes.pop(name, None) is not None:
            self.builder.volumes.epoch += 1

    def remove_csinode(self, name: str) -> None:
        vols = self.builder.volumes
        old = vols.csinodes.pop(name, None)
        if old is None:
            return
        vols.epoch += 1
        rec = self.cache.nodes.get(name)
        if rec is not None:
            # The removed drivers go back to the no-CSINode default
            # (unlimited, the snapshot's 2^31-1 fill).
            self.builder.set_csinode_limits(rec.row, t.CSINode(name, {d: 2**31 - 1 for d in old.driver_limits}))
        self.queue.on_event(Event.NODE_UPDATE)

    def _has_reserve_work(self, pod: t.Pod) -> bool:
        """The profile enables VolumeBinding's Reserve (profile.reserve) and
        the pod has a claim for it to bind."""
        rp = self.volume_reserve
        return rp.name in self.profile.reserve and rp.relevant(pod, self)

    def _free_ctx(self, rows) -> EventCtx:
        """EventCtx of the free capacity on ``rows`` after the current host
        change, nominated claims subtracted (scheduler.py:1542)."""
        host = self.builder.host
        nom_req: dict[int, np.ndarray] = {}
        nom_cnt: dict[int, int] = {}
        for _uid, (node_name, delta, _p) in self.nominator.items():
            rec = self.cache.nodes.get(node_name)
            if rec is None or rec.row not in rows:
                continue
            d = delta["req"]
            acc = nom_req.setdefault(rec.row, np.zeros(host["alloc"].shape[1], np.int64))
            acc[: d.shape[0]] += d
            nom_cnt[rec.row] = nom_cnt.get(rec.row, 0) + 1
        max_free = None
        max_slots = 0
        for r in rows:
            free = host["alloc"][r] - host["req"][r]
            if r in nom_req:
                free = free - nom_req[r]
            slots = int(host["allowed_pods"][r] - host["num_pods"][r]) - nom_cnt.get(r, 0)
            max_free = free if max_free is None else np.maximum(max_free, free)
            max_slots = max(max_slots, slots)
        return EventCtx(max_free=max_free, max_slots=max_slots)

    # -- the batch loop --------------------------------------------------------

    @property
    def has_inflight_work(self) -> bool:
        return self._prefetched is not None

    def schedule_batch(self) -> list[ScheduleOutcome]:
        """Pop up to batch_size pods (or take the prefetched batch) and
        schedule them in one batch pass, then PostFilter the failures."""
        pre, self._prefetched = self._prefetched, None
        if pre is not None:
            infos, work = pre
        else:
            infos, work = self.queue.pop_batch(self.batch_size), None
        if not infos:
            return []
        ctx = self._dispatch_batch(infos, work)
        # Recent batches failed: pack the victims now and chain the dry-run
        # on this pass's device picks (scheduler.py:3298-3316).
        prepacked = None
        if self.chunk_size > 1 and self.preemption.expect_failures and self.preemption.worth_prepacking(
            qp.pod for qp in infos
        ):
            prepacked = self.preemption.pack_victims(self.profile, ctx["active"])
        ctx["prepacked"] = prepacked
        if prepacked is not None:
            ctx["spec"] = self.preemption.dispatch_speculative(ctx, prepacked)
            if ctx["spec"] is not None:
                self.speculative_batches += 1
        if not ctx["active"] & {"VolumeBinding", "DynamicResources"}:
            nxt = self.queue.pop_batch(self.batch_size)
            if nxt:
                self._prefetched = (nxt, self._featurize_batch(nxt))
        return self._complete_batch(ctx)

    def schedule_all_pending(self, max_rounds: int = 10_000, wait_backoff: bool = False) -> list[ScheduleOutcome]:
        """Drain the active queue.  With ``wait_backoff`` the loop also
        sleeps through backoff expiries (on the wall clock only) until only
        unschedulable or gated pods remain (scheduler.py:4431)."""
        out: list[ScheduleOutcome] = []
        for _ in range(max_rounds):
            got = self.schedule_batch()
            if got:
                out.extend(got)
                continue
            if len(self.queue) or self.has_inflight_work:
                continue
            if wait_backoff and self.queue.sleep_until_backoff():
                continue
            break
        return out

    def _full_inv(self) -> dict:
        """Batch invariants plus the nominated-pod overlay (scheduler.py:
        3081-3104), as device tensors."""
        inv = self.builder.batch_invariants()
        s = self.builder.schema
        nom_req = np.zeros((s.N, s.R), np.int64)
        nom_cnt = np.zeros(s.N, np.int32)
        nom_prio = np.full(s.N, -(2**31), np.int32)
        for _uid, (node_name, delta, prio) in self.nominator.items():
            rec = self.cache.nodes.get(node_name)
            if rec is None:
                continue
            d = delta["req"]
            nom_req[rec.row, : d.shape[0]] += d
            nom_cnt[rec.row] += 1
            nom_prio[rec.row] = max(nom_prio[rec.row], prio)
        inv["nom_req"], inv["nom_cnt"], inv["nom_prio"] = nom_req, nom_cnt, nom_prio
        return {k: torch.from_numpy(v).to(self.device) for k, v in inv.items()}

    def _to_device(self, batch: dict) -> dict:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in batch.items()
        }

    def _expand_uniform(self, small: dict, k: int) -> dict:
        """Broadcast a uniform batch's single representative feature row to
        the full batch axis on the device (scheduler.py:44)."""
        expand = plain.expand_rows if self._impl == "plain" else kernels.expand_rows
        return {kk: expand(v, k) for kk, v in small.items()}

    def _featurize_batch(self, infos: list[QueuedPodInfo]) -> dict:
        batch, deltas, active = build_pod_batch(
            [qp.pod for qp in infos], self.builder, self.profile, self.batch_size
        )
        return {"batch": batch, "deltas": deltas, "active": active,
                "version": self.builder.feature_version()}

    def _inject_nomrows(self, work: dict, infos: list[QueuedPodInfo]) -> None:
        """Nominated node names → rows, at dispatch (scheduler.py:3432)."""
        nomrow = np.full(self.batch_size, -1, np.int32)
        if self.nominator:
            for i, qp in enumerate(infos):
                nn = qp.pod.status.nominated_node_name
                if nn:
                    rec = self.cache.nodes.get(nn)
                    if rec is not None:
                        nomrow[i] = rec.row
        work["batch"]["nominated_row"] = nomrow
        work["nomrow"] = nomrow

    def _pin_rows(self, infos: list[QueuedPodInfo]):
        """(batch,) pinned row per pod plus a nominated-pin mask, or None
        unless every pod resolves to one candidate row: its own NodeName /
        metadata.name pin, or a live nomination whose pin has not failed
        (scheduler.py:3396)."""
        rows = np.full(self.batch_size, -1, np.int32)
        nom = np.zeros(self.batch_size, np.bool_)
        for i, qp in enumerate(infos):
            name = pin_name(qp.pod)
            if name is None:
                nn = qp.pod.status.nominated_node_name
                if nn and qp.pod.uid in self.nominator and not qp.nom_pin_failed:
                    rec = self.cache.nodes.get(nn)
                    if rec is not None:
                        rows[i] = rec.row
                        nom[i] = True
                        continue
                return None
            rec = self.cache.nodes.get(name)
            rows[i] = rec.row if rec is not None else -1
        return rows, nom

    def _dispatch_batch(self, infos: list[QueuedPodInfo], work: dict | None = None) -> dict:
        profile = self.profile
        if work is not None and work["version"] != self.builder.feature_version():
            work = None  # stale prefetch
        if work is None:
            work = self._featurize_batch(infos)
        self._inject_nomrows(work, infos)
        batch, deltas, active = work["batch"], work["deltas"], work["active"]
        # Invariants may grow TK/DV: after featurization, before the flush.
        inv = self._full_inv()
        # The carry is sound only when nothing host-side mutated since it
        # was stashed and no dirty row is about to be flushed under it.
        dom_ok = (
            self._dom_carry is not None
            and self._dom_token == (self.builder.schema, self.builder.mutation_epoch)
            and not self.builder._dirty_all
            and not self.builder._dirty_rows
        )
        state = self.builder.state()
        schema = self.builder.schema
        if active <= PINNED_SAFE_OPS:
            pins = self._pin_rows(infos)
            if pins is not None:
                # Pinned fast path: every pod has one candidate row.
                batch["pin_row"], nom_pinned = pins
                run = self.passes.get_pinned(profile, schema, self.builder.res_col, active)
                host = ("pin_row", "nominated_row")  # read on the host by the pass
                batch_d = self._to_device({k: v for k, v in batch.items() if k not in host})
                new_state, result = run(state, {**batch_d, **{k: batch[k] for k in host}}, inv)
                self._cycle += len(infos)
                self._dom_carry = None  # the pinned commit does not carry the tables
                self.pinned_batches += 1
                return dict(
                    work, infos=infos, profile=profile, inv=inv, new_state=new_state,
                    result=result, schema=schema, chunk=self.chunk_size, pinned=True,
                    nom_pinned=nom_pinned,
                )
        chunk = self.chunk_size
        cycle0 = self._cycle
        batch["step_offset"] = np.arange(self.batch_size, dtype=np.int32)
        if chunk > 1 and active & {"PodTopologySpread", "InterPodAffinity", "NodePorts"}:
            # Conflict-aware chunk packing: same-class pods land in different
            # chunk slices at the widest collision-tolerant width, with
            # class-relative order kept.  Tie-break seeds ride the pod: row r
            # draws the seed of its original position.
            npods = len(infos)
            plan = pack_batch(batch, npods, chunk)
            chunk = plan.width
            if plan.perm is not None:
                infos = [infos[j] for j in plan.perm]
                deltas = [deltas[j] for j in plan.perm]
                full = np.arange(self.batch_size, dtype=np.int64)
                full[:npods] = plan.perm
                batch = {key: np.asarray(arr)[full] for key, arr in batch.items()}
                work["nomrow"] = batch["nominated_row"]
                self.packed_batches += 1
            self.pack_collisions += plan.collisions
            self.pack_width = plan.width
        run = self.passes.get(profile, schema, self.builder.res_col, active, chunk, carry_dom=True)
        uniform = False
        if chunk > 1:
            # Every pod featurization-identical (pass_.py uniform_all);
            # name-pinned pods count as distinct.
            sigs = {pod_sig(qp.pod) if pin_name(qp.pod) is None else i for i, qp in enumerate(infos)}
            uniform = len(sigs) == 1
        per_pod = ("valid", "nominated_row", "step_offset")
        if uniform:
            # Ship one representative row and broadcast it on the device.
            small = self._to_device({kk: v[:1] for kk, v in batch.items() if kk not in per_pod})
            batch_d = self._expand_uniform(small, self.batch_size)
            batch_d.update(self._to_device({kk: batch[kk] for kk in per_pod}))
        else:
            batch_d = self._to_device(batch)
        if chunk > 1:
            batch_d["uniform_all"] = uniform
        dom_in = self._dom_carry if dom_ok else (None, None)
        if dom_ok:
            self.dom_carry_hits += 1
        else:
            self.dom_carry_rebuilds += 1
        new_state, result, dom_out = run(state, batch_d, inv, cycle0, dom_in[0], dom_in[1], dom_ok)
        self._cycle += len(infos)
        return dict(
            work, infos=infos, batch=batch, deltas=deltas, profile=profile, inv=inv,
            batch_d=batch_d, new_state=new_state, result=result, dom_out=dom_out,
            schema=schema, chunk=chunk, cycle0=cycle0,
        )

    @staticmethod
    def _fetch(res) -> tuple[np.ndarray, ...]:
        """One device→host copy for the result arrays."""
        both = torch.stack(
            [res.picks.to(torch.int64), res.scores, res.feasible_counts.to(torch.int64),
             res.fail_masks.to(torch.int64)]
        ).cpu().numpy()
        return tuple(both)

    def _complete_batch(self, ctx: dict) -> list[ScheduleOutcome]:
        infos, profile = ctx["infos"], self.profile
        batch, deltas, active = ctx["batch"], ctx["deltas"], ctx["active"]
        nomrow = ctx["nomrow"]
        new_state = ctx["new_state"]
        picks, scores, feas, fails = self._fetch(ctx["result"])
        spec = ctx.get("spec")
        if spec is not None:
            ctx["spec_res"] = (spec["out"].picks.cpu().numpy(), spec["out"].vic_mask.cpu().numpy())
        deferred = [i for i in range(len(infos)) if picks[i] == -2]
        if deferred and ctx.get("pinned"):
            # Pinned same-row overflow mates retry next batch.
            for i in deferred:
                self.queue.reactivate(infos[i])
                picks[i] = -3  # handled: neither bind nor failure
            deferred = []
        # A prefetch that grew the schema while this batch was in flight:
        # deferred pods requeue instead of re-running under old shapes.
        schema_grew = ctx["schema"] != self.builder.schema
        if deferred and schema_grew:
            for i in deferred:
                self.queue.reactivate(infos[i])
                picks[i] = -3
            deferred = []
        tail_placed = False
        if deferred:
            self.deferred += len(deferred)
            all_deferred = list(deferred)

            def run_tail(idx_list: list[int], chunk_level: int, size: int) -> list[int]:
                """Re-featurize and re-run the pods against the committed
                state in original order with their original step seeds
                (scheduler.py:3831-3890); returns those that deferred again."""
                nonlocal new_state
                run2 = self.passes.get(
                    profile, self.builder.schema, self.builder.res_col, active,
                    chunk_level, carry_dom=True,
                )
                soff = batch["step_offset"]
                still: list[int] = []
                for lo in range(0, len(idx_list), size):
                    idx = idx_list[lo : lo + size]
                    sub, sub_deltas, _ = build_pod_batch(
                        [infos[i].pod for i in idx], self.builder, profile, size,
                        force_active=active,
                    )
                    sub["nominated_row"] = np.full(size, -1, np.int32)
                    sub["nominated_row"][: len(idx)] = nomrow[idx]
                    for j, i in enumerate(idx):
                        deltas[i] = sub_deltas[j]
                    sub["step_offset"] = np.zeros(size, np.int32)
                    sub["step_offset"][: len(idx)] = soff[idx]
                    dom = ctx["dom_out"]
                    new_state, res, ctx["dom_out"] = run2(
                        new_state, self._to_device(sub), ctx["inv"], ctx["cycle0"],
                        dom[0], dom[1], True,
                    )
                    p2, s2, f2, fl2 = self._fetch(res)
                    n = len(idx)
                    picks[idx], scores[idx], feas[idx], fails[idx] = p2[:n], s2[:n], f2[:n], fl2[:n]
                    still.extend(i for j, i in enumerate(idx) if p2[j] == -2)
                return still

            # Round 1: large bursts replay through the same chunked pass.
            if ctx["chunk"] > 1 and len(deferred) > self.tail_size:
                deferred = run_tail(deferred, ctx["chunk"], self.batch_size)
            # Round 2: the strict chunk=1 finisher (never defers).
            if deferred:
                run_tail(deferred, 1, self.tail_size)
            tail_placed = any(picks[i] >= 0 for i in all_deferred)
        self.builder.absorb_device_state(new_state)
        if ctx.get("pinned"):
            pass  # the carry was dropped at dispatch
        elif ctx["schema"] == self.builder.schema:
            self._dom_carry = ctx["dom_out"]
            self._dom_token = (self.builder.schema, self.builder.mutation_epoch)
        else:
            self._dom_carry = None

        # Phase 1: assume every pick (cache.go:361; the device already
        # committed the deltas).
        nom_pinned = ctx.get("nom_pinned")
        failed: list[int] = []
        placed: list[tuple[int, str]] = []
        outcomes: list[ScheduleOutcome] = []
        for i, qp in enumerate(infos):
            row = int(picks[i])
            if row < 0 and row != -3 and nom_pinned is not None and nom_pinned[i]:
                # The nominated node alone failed: the full node list next
                # batch, not PostFilter on top of a live nomination.
                qp.nom_pin_failed = True
                self.queue.reactivate(qp)
                continue
            if row == -3:
                continue
            if row < 0:
                failed.append(i)
                continue
            node_name = self.cache.node_name_at_row(row)
            if node_name is None:
                raise RuntimeError(f"pick {row} maps to no node")
            self.cache.assume_pod(qp.pod, node_name, device_already=True, delta=deltas[i])
            self.nominator.pop(qp.pod.uid, None)  # a placed pod's nomination is spent
            qp.pod.status.nominated_node_name = ""
            placed.append((i, node_name))
        # Phase 2: Reserve + PreBind + bind, in batch order.  A pod that lost
        # a same-batch race (a static PV or a ReadWriteOncePod claim) bound
        # nothing; it is forgotten — its delta comes off the host rows,
        # which flush to the device at the next state() — and retries
        # behind backoff (scheduler.py:4091-4150).
        for i, node_name in placed:
            qp = infos[i]
            if self._has_reserve_work(qp.pod) and self.volume_reserve.reserve(qp.pod, node_name, self) is None:
                self.cache.forget_pod(qp.pod.uid)
                self.reserve_failures += 1
                outcomes.append(ScheduleOutcome(qp.pod, None, 0, int(feas[i])))
                self.queue.add_backoff(qp)
                continue
            self.cache.finish_binding(qp.pod.uid)
            qp.pod.spec.node_name = node_name
            self.queue.done(qp.pod.uid)
            outcomes.append(ScheduleOutcome(qp.pod, node_name, int(scores[i]), int(feas[i])))
        bit_names = filter_op_names(profile, active)
        failed_out: dict[int, ScheduleOutcome] = {}
        for i in failed:
            mask = int(fails[i])
            plugins = frozenset(name for b, name in enumerate(bit_names) if mask & (1 << b))
            failed_out[i] = ScheduleOutcome(infos[i].pod, None, 0, int(feas[i]), plugins)
            outcomes.append(failed_out[i])

        def park(i: int) -> None:
            qp = infos[i]
            qp.delta = deltas[i]  # the fit hint reads its request vector
            self.queue.add_unschedulable(qp, set(failed_out[i].unschedulable_plugins) or set(profile.filters))

        # PostFilter: one batched preemption for every failure
        # (schedule_one.go:196 → DefaultPreemption); it sits out a batch
        # whose schema grew.
        results: list = [None] * len(failed)
        spec_applied = False
        if failed and "DefaultPreemption" in profile.post_filter and not schema_grew:
            if spec is not None:
                by_index = self.preemption.collect_speculative(
                    spec, ctx["spec_res"], {i: infos[i].pod for i in failed}
                )
                results = [by_index.get(i) for i in failed]
                spec_applied = True
            else:
                rows = {
                    key: [np.asarray(arr)[i] for i in failed]
                    for key, arr in batch.items()
                    if key not in ("valid", "pin_row", "uniform_all")
                }
                try:
                    results = self.preemption.preempt_batch(
                        [infos[i].pod for i in failed], rows, active, profile=profile,
                        prepacked=ctx.get("prepacked"),
                    )
                except NotImplementedError:
                    # Refused before any victim was touched: the failures
                    # wait as unschedulable and the batch stays consistent.
                    for i in failed:
                        park(i)
                    raise
        self.preemption.expect_failures = bool(failed)
        # A speculative result predates the strict tail: inline commit
        # re-checks capacity on host truth (scheduler.py:4321-4328).
        spec_inline_ok = not spec_applied or not tail_placed or not (active & DYNAMIC_HARD_OPS)
        any_victims = False
        for i, res in zip(failed, results):
            qp = infos[i]
            if res is not None:
                # A pod with Reserve work (a claim to bind) takes the
                # nominate-and-retry path (scheduler.py:2046).
                if self.inline_preempt_commit and not self._has_reserve_work(qp.pod) and (
                    not spec_applied or (spec_inline_ok and self._fits_now(res.node_name, deltas[i]))
                ):
                    self._commit_preempted(qp, failed_out[i], res, deltas[i])
                else:
                    self._record_preemption(qp, failed_out[i], res, deltas[i])
                any_victims = any_victims or bool(res.victims)
            elif schema_grew:
                self.queue.reactivate(qp)
            else:
                park(i)
        if any_victims:
            # One batched POD_DELETE for every victim of the pass, carrying
            # the freed nodes' capacity minus the nominated claims.
            freed_rows = {
                self.cache.nodes[res.node_name].row
                for res in results
                if res is not None and res.victims and res.node_name in self.cache.nodes
            }
            self.queue.on_event(Event.POD_DELETE, self._free_ctx(freed_rows))
        return outcomes

    # -- PostFilter bookkeeping --------------------------------------------------

    def _note_victims(self, outcome: ScheduleOutcome, preemptor: t.Pod, res) -> None:
        """The outcome's preemption fields and the Preempted record of each
        victim (preemption.go:362)."""
        outcome.nominated_node = res.node_name
        outcome.victims = len(res.victims)
        outcome.victim_uids = tuple(v.uid for v in res.victims)
        self.preemptions += 1
        self.preempted.extend((v.uid, preemptor.uid, res.node_name) for v in res.victims)

    def _record_preemption(self, qp: QueuedPodInfo, outcome, res, delta) -> None:
        """Nominate-and-retry (scheduler.py:1987): the nominator's claim on
        the freed node and an immediate retry."""
        self._note_victims(outcome, qp.pod, res)
        self.nominator[qp.pod.uid] = (res.node_name, delta, qp.pod.spec.priority)
        qp.nom_pin_failed = False
        self.queue.add(qp.pod)

    def _fits_now(self, node_name: str, delta: dict) -> bool:
        """Host-truth capacity re-check before inline-committing a
        speculative result (scheduler.py:2028)."""
        rec = self.cache.nodes.get(node_name)
        if rec is None:
            return False
        h = self.builder.host
        row = rec.row
        req = delta["req"]
        free = h["alloc"][row, : req.shape[0]] - h["req"][row, : req.shape[0]]
        if ((req > 0) & (req > free)).any():
            return False
        return h["num_pods"][row] < h["allowed_pods"][row]

    def _commit_preempted(self, qp: QueuedPodInfo, outcome, res, delta) -> None:
        """Commit the preemptor on its freed node in this batch
        (scheduler.py:2055): the host delta flushes to the device at the
        next state()."""
        self._note_victims(outcome, qp.pod, res)
        self.cache.assume_pod(qp.pod, res.node_name, device_already=False, delta=delta)
        self.nominator.pop(qp.pod.uid, None)
        qp.pod.spec.node_name = res.node_name
        qp.pod.status.nominated_node_name = ""
        self.cache.finish_binding(qp.pod.uid)
        self.queue.done(qp.pod.uid)
        outcome.node_name = res.node_name
