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
recent batches failed.  Placed pods are assumed first, then the Reserve
plugins run in batch order (framework/hostplugins.py: DynamicResources
allocates and reserves the pod's claims on named devices, VolumeBinding
binds delayed claims); a pod whose reservation lost a same-batch race has
its earlier reservations rolled back, is forgotten and is sent to backoff
(scheduler.py:3960-4150).  The PV, PVC, StorageClass and CSINode informers
feed the volume catalog, the ResourceClaim and ResourceSlice informers the
claim catalog (scheduler.py:1737-1910).  A profile with
percentage_of_nodes_to_score != 100 runs truncated (parity) mode at chunk
1 (scheduler.py:375-385): every pass scans the cache's zone-interleaved
node order from a rotating start, which the host advances by each batch's
processedNodes (:3788-3792), and the pinned-batch pass stays off.
Several profiles register by schedulerName (``profiles=``, scheduler.py:
150-183): a popped batch splits into one group a profile, in pop order,
each dispatched and completed under its own profile (:3226-3245).  With
extenders (``extenders=``, pkg/scheduler/extender.go; scheduler.py:
2295-2445) a batch schedules pod by pod through the eval-only pass: the
per-node verdicts and scores come back to the host, the extender chain
filters and prioritizes, the host picks, assumes, reserves and binds, with
no prefetch.  Decision provenance (``arm_provenance``, ``explain_pod``;
scheduler.py:2548-2797) records each live decision and explains a pod
through the attribution pass against the current state.  Gangs,
journaling, the PreBind wait room and the pipelined predispatch are later
slices; a pod that would need one raises NotImplementedError.
"""

from __future__ import annotations

import copy
import dataclasses
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
from .framework.features import DEFAULT_GATES
from .framework.hostplugins import DEFAULT_RESERVE_PLUGINS, ReservePlugin
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
        profiles: list[Profile] | None = None,
        queue: SchedulingQueue | None = None,
        inline_preempt_commit: bool | None = None,
        feature_gates=None,
        extenders: list | None = None,
        _impl: str = "kernel",
    ):
        self.device = resolve_device(device)
        self.feature_gates = feature_gates or DEFAULT_GATES
        # The profile map (profile/profile.go:47, scheduler.py:150-158):
        # schedulerName → profile; ``profile`` is the default, and a pod
        # naming no registered scheduler is not ours.
        by_name = {profile.name: profile}
        for p in profiles or ():
            by_name[p.name] = p
        # With DynamicResourceAllocation off the plugin exists at no
        # extension point of any profile (plugins/registry.go:49,
        # scheduler.py:159-183).
        self._dra_enabled = self.feature_gates.enabled("DynamicResourceAllocation")
        if not self._dra_enabled:
            by_name = {name: dataclasses.replace(p, **{
                fld: tuple(f for f in getattr(p, fld) if f != "DynamicResources")
                for fld in ("filters", "pre_enqueue", "pre_filter", "post_filter", "reserve", "pre_bind")
            }) for name, p in by_name.items()}
        for p in by_name.values():
            unknown = [n for n in (*p.filters, *(s for s, _ in p.scorers)) if not opcommon.has(n)]
            if unknown:
                raise NotImplementedError(f"plugins {unknown} are not yet ported")
        self.profiles: dict[str, Profile] = by_name
        profile = by_name[profile.name]
        # Truncated (parity) mode when any profile truncates: the
        # reference's search truncation, rotating start and zone-interleaved
        # order need the sequential scan (scheduler.py:379).
        self._truncated = any(p.percentage_of_nodes_to_score != 100 for p in by_name.values())
        if self._truncated and chunk_size != 1:
            raise ValueError("percentage_of_nodes_to_score != 100 (parity mode) requires chunk_size=1")
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
        self.builder.feature_gates = self.feature_gates
        self.cache = Cache(self.builder)
        self.queue = queue if queue is not None else SchedulingQueue()
        # Per-profile PreEnqueue: SchedulingGates holds a gated pod only when
        # its profile runs the plugin (scheduler.py:209-211).
        self.queue.gates_apply_to = lambda pod: "SchedulingGates" in (
            self._profile_for(pod) or self.profile).pre_enqueue
        self.passes = PassCache(_impl)
        # Carried domain tables: the previous pass's final (group_dom,
        # et_dom) and the (schema, mutation_epoch) token they are valid
        # under; any host mutation in between forces a rebuild.
        self._dom_carry: tuple | None = None
        self._dom_token: tuple | None = None
        # Tie-break cycle counter: the batch's seed base (scheduler.py:374).
        self._cycle = 0
        # Rotating scan start of truncated mode (schedule_one.go
        # nextStartNodeIndex, scheduler.py:498), and the cache's node order
        # on the device with the (generation, N) it was built under.
        self._next_start = 0
        self._order_dev: tuple | None = None
        # The next batch, popped and featurized before the current one
        # completes (scheduler.py:3327).
        self._prefetched: tuple | None = None
        # The hot topology keys take the first slots, so node rows carry
        # them and slots number as the reference's do (scheduler.py:501).
        for key in (InternTable.HOSTNAME_KEY, "topology.kubernetes.io/zone", "topology.kubernetes.io/region"):
            self.builder.ensure_topo_key(key)
        # Nominated pods: uid → (node name, delta, priority), the claims the
        # fit overlay protects (nominator.go).
        self.nominator: dict[str, tuple[str, dict, int]] = {}
        self.pdbs: dict[str, t.PodDisruptionBudget] = {}
        self.preemption = PreemptionEvaluator(self)
        # Inline preemptor commit (scheduler.py:269-279): by default, at
        # chunk > 1 a successful preemptor commits on its freed node in the
        # same batch (the victims' deletion is synchronous); otherwise it is
        # nominated and retried, which re-runs its filters against the
        # pods committed meanwhile.
        self.inline_preempt_commit = chunk_size > 1 if inline_preempt_commit is None else inline_preempt_commit
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
        # The Reserve plugins, in the reference's order (hostplugins.py:148).
        self.reserve_plugins: list[ReservePlugin] = list(DEFAULT_RESERVE_PLUGINS)
        # Pods whose reservation lost a same-batch race (forgotten, to backoff).
        self.reserve_failures = 0
        # Out-of-process extenders (pkg/scheduler/extender.go); a non-empty
        # chain routes scheduling through the per-pod eval-only path.
        self.extenders = list(extenders or ())
        # Decision provenance (framework/provenance.py): the ring of live
        # decisions, None until arm_provenance() (scheduler.py:387-392).
        self.provenance = None

    # -- cluster events --------------------------------------------------------

    def add_node(self, node: t.Node) -> None:
        self.cache.add_node(node)
        row = self.cache.row_of(node.name)
        # Replay a CSINode, ResourceSlices, pending external claim charges
        # and parked pool corrections that arrived before their Node
        # (informer races, scheduler.py:1348-1380).
        csinode = self.builder.volumes.csinodes.get(node.name)
        if csinode is not None:
            self.builder.set_csinode_limits(row, csinode)
        cat = self.builder.dra
        for nname, cls in cat.slices:
            if nname == node.name:
                self.builder.set_dra_cap(row, nname, cls)
        for uid, charges in list(cat.pending_external.items()):
            if charges and charges[0][0] == node.name:
                del cat.pending_external[uid]
                self.builder.apply_external_claim(row, uid, [(sig, cnt) for _n, sig, cnt in charges], +1)
                cat.row_charged[uid] = charges
        for uid in list(cat.pending_corr):
            claim = cat.claims.get(uid)
            if claim is not None and claim.allocated_node == node.name and uid in cat.row_charged:
                corr = cat.pending_corr.pop(uid)
                cat.corrections[uid] = corr
                self.builder.apply_dra_correction(row, corr, +1)
        self.queue.on_event(Event.NODE_ADD, self._free_ctx({row}))

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
        if self._profile_for(pod) is None:
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
        # DRA: drop the pod's claim reservations; claims nobody reserves
        # deallocate (the resourceclaim controller's cleanup), externally
        # charged ones discharging their phantom row reservation
        # (scheduler.py:1668-1678).
        by_claim: dict[tuple[str, str], list[tuple[str, int]]] = {}
        for cuid, node_name, sig, cnt in self.builder.dra.release_pod(uid):
            by_claim.setdefault((cuid, node_name), []).append((sig, cnt))
        for (cuid, node_name), charges in by_claim.items():
            nrec = self.cache.nodes.get(node_name)
            if nrec is not None:
                self.builder.apply_external_claim(nrec.row, cuid, charges, -1)
        self._drain_dra_corrections()
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

    # -- DRA objects (the ResourceClaim/ResourceSlice informers,
    # scheduler.py:1737-1812, 1870-1910) ---------------------------------------

    def add_resource_claim(self, claim: t.ResourceClaim) -> None:
        """ResourceClaim informer.  An externally allocated claim charges its
        node's row at once as a phantom reservation; a charge for a node not
        yet cached parks in pending_external, which add_node replays."""
        cat = self.builder.dra
        uid = claim.uid
        deltas = cat.add_claim(claim)
        neg = [(n, sig, cnt) for n, sig, cnt, sgn in deltas if sgn < 0]
        pos = [(n, sig, cnt) for n, sig, cnt, sgn in deltas if sgn > 0]
        if neg and cat.pending_external.pop(uid, None) is None:
            charged = cat.row_charged.pop(uid, None)
            if charged is not None:
                rec = self.cache.nodes.get(charged[0][0])
                if rec is not None:
                    self.builder.apply_external_claim(rec.row, uid, [(sig, cnt) for _n, sig, cnt in charged], -1)
        if pos:
            rec = self.cache.nodes.get(pos[0][0])  # one node per allocation
            if rec is None:
                cat.pending_external[uid] = pos
            else:
                self.builder.apply_external_claim(rec.row, uid, [(sig, cnt) for _n, sig, cnt in pos], +1)
                cat.row_charged[uid] = pos
        self._drain_new_pools()
        self._drain_dra_corrections()
        self.queue.on_event(Event.CLAIM_ADD)

    def _drain_new_pools(self) -> None:
        """Backfill the cap and alloc columns of selector pools registered
        since the last drain, on every cached node publishing their class."""
        cat = self.builder.dra
        if not cat.new_pools:
            return
        sigs, cat.new_pools = list(cat.new_pools), []
        for sig in sigs:
            cls, _reqs = cat.pools[sig]
            for nname, c in list(cat.slices):
                if c != cls:
                    continue
                rec = self.cache.nodes.get(nname)
                if rec is not None:
                    self.builder.set_pool_cap(rec.row, nname, sig)
                    alloc = cat.new_pool_alloc(nname, sig)
                    if alloc:
                        self.builder.set_pool_alloc(rec.row, sig, alloc)

    def _drain_dra_corrections(self) -> None:
        """Apply the queued pool-overlap corrections (ClaimCatalog.
        corr_events) to the node rows."""
        cat = self.builder.dra
        if not cat.corr_events:
            return
        events, cat.corr_events = cat.corr_events, []
        for node_name, charges, sign in events:
            rec = self.cache.nodes.get(node_name)
            if rec is not None:
                self.builder.apply_dra_correction(rec.row, charges, sign)

    def add_resource_slice(self, s: t.ResourceSlice) -> None:
        """ResourceSlice informer: a node's published devices of one class."""
        self.builder.dra.add_slice(s)
        rec = self.cache.nodes.get(s.node_name)
        if rec is not None:
            self.builder.set_dra_cap(rec.row, s.node_name, s.device_class)
        self.queue.on_event(Event.CLAIM_ADD)

    def remove_resource_claim(self, uid: str) -> None:
        """A deleted claim discharges what it held: a deallocated copy goes
        through the diffing add path (which reverses external row charges
        and corrections), then the object is dropped."""
        cat = self.builder.dra
        claim = cat.claims.get(uid)
        if claim is None:
            return
        if claim.allocated_node:
            self.add_resource_claim(
                dataclasses.replace(claim, allocated_node="", reserved_for=(), allocated_devices=()))
        cat.claims.pop(uid, None)
        self.queue.on_event(Event.CLAIM_ADD)

    def remove_resource_slice(self, uid: str) -> None:
        """``uid`` is "node/device_class"; that node's published devices of
        the class drop to none.  Allocated charges stay until their claims
        release."""
        node_name, device_class = uid.split("/", 1)
        cat = self.builder.dra
        key = (node_name, device_class)
        if cat.slices.pop(key, None) is None:
            return
        cat.devices.pop(key, None)
        cat.device_owner.pop(key, None)
        cat.epoch += 1
        rec = self.cache.nodes.get(node_name)
        if rec is not None:
            self.builder.set_dra_cap(rec.row, node_name, device_class)
        self.queue.on_event(Event.CLAIM_ADD)

    def _profile_for(self, pod: t.Pod) -> Profile | None:
        """frameworkForPod (schedule_one.go:379, scheduler.py:2284): the
        profile of the pod's schedulerName; the API default
        "default-scheduler" falls to the default profile; any other name is
        not ours."""
        p = self.profiles.get(pod.spec.scheduler_name)
        if p is not None:
            return p
        if pod.spec.scheduler_name == "default-scheduler":
            return self.profile
        return None

    def _reserve_for(self, pod: t.Pod) -> list:
        """The Reserve plugins the pod's profile enables (profile.reserve)
        that the pod needs (scheduler.py:2124)."""
        enabled = (self._profile_for(pod) or self.profile).reserve
        return [rp for rp in self.reserve_plugins if rp.name in enabled and rp.relevant(pod, self)]

    def _reserve(self, pod: t.Pod, node_name: str) -> bool:
        """Run the pod's Reserve plugins in order; on a failure unreserve the
        earlier ones in reverse (RunReservePluginsUnreserve)."""
        undos: list = []
        for rp in self._reserve_for(pod):
            undo = rp.reserve(pod, node_name, self)
            if undo is None:
                for rp2, u2 in reversed(undos):
                    rp2.unreserve(u2, self)
                return False
            undos.append((rp, undo))
        return True

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
        schedule them in one batch pass, then PostFilter the failures.  With
        several profiles the popped batch is split by profile in pop order
        and each group runs its own pass and completion, with no prefetch
        (scheduler.py:3226-3245)."""
        pre, self._prefetched = self._prefetched, None
        if pre is not None:
            infos, work = pre
        else:
            infos, work = self.queue.pop_batch(self.batch_size), None
        if not infos:
            return []
        if self.extenders:
            # Extender chain: the per-pod eval-only path (scheduler.py:3219-3224).
            return [self._schedule_one_extender(qp) for qp in infos]
        if len(self.profiles) > 1:
            groups: dict[str, list[QueuedPodInfo]] = {}
            for qp in infos:
                groups.setdefault((self._profile_for(qp.pod) or self.profile).name, []).append(qp)
            out: list[ScheduleOutcome] = []
            for name, group in groups.items():
                out.extend(self._complete_batch(self._dispatch_batch(group, self.profiles[name])))
            return out
        profile = self.profile
        ctx = self._dispatch_batch(infos, profile, work)
        # Recent batches failed: pack the victims now and chain the dry-run
        # on this pass's device picks (scheduler.py:3298-3316).
        prepacked = None
        if self.chunk_size > 1 and self.preemption.expect_failures and self.preemption.worth_prepacking(
            qp.pod for qp in infos
        ):
            prepacked = self.preemption.pack_victims(profile, ctx["active"])
        ctx["prepacked"] = prepacked
        if prepacked is not None:
            ctx["spec"] = self.preemption.dispatch_speculative(ctx, prepacked)
            if ctx["spec"] is not None:
                self.speculative_batches += 1
        if not ctx["active"] & {"VolumeBinding", "DynamicResources"}:
            nxt = self.queue.pop_batch(self.batch_size)
            if nxt:
                self._prefetched = (nxt, self._featurize_batch(nxt, profile))
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
        3081-3104), as device tensors, and the image vocabulary's size; in
        truncated mode also the scan order (uploaded again only when a node
        add or update moved the cache's generation) and the scan start, a
        (1,) i64 device tensor the pass advances."""
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
        out = {k: torch.from_numpy(v).to(self.device) for k, v in inv.items()}
        # The bound of the image ids ImageLocality's counts cover (a host int).
        out["image_vocab"] = len(self.interns.images)
        if self._truncated:
            key = (self.cache._generation, s.N)
            if self._order_dev is None or self._order_dev[0] != key:
                self._order_dev = (key, torch.from_numpy(self.cache.order_pos(s.N)).to(self.device))
            out["order_pos"] = self._order_dev[1]
            out["scan_start"] = torch.tensor([self._next_start], dtype=torch.int64, device=self.device)
            out["scan_nodes"] = self.cache.node_count()
        return out

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

    def _featurize_batch(self, infos: list[QueuedPodInfo], profile: Profile) -> dict:
        batch, deltas, active = build_pod_batch(
            [qp.pod for qp in infos], self.builder, profile, self.batch_size
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

    def _dispatch_batch(self, infos: list[QueuedPodInfo], profile: Profile, work: dict | None = None) -> dict:
        if work is not None and work["version"] != self.builder.feature_version():
            work = None  # stale prefetch
        if work is None:
            work = self._featurize_batch(infos, profile)
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
        # Truncated mode keeps the full pass for its processed counts
        # (scheduler.py:3492).
        if not self._truncated and active <= PINNED_SAFE_OPS:
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
        """One device→host copy for the result arrays: picks, scores,
        feasible counts, fail masks and processed counts."""
        both = torch.stack(
            [res.picks.to(torch.int64), res.scores, res.feasible_counts.to(torch.int64),
             res.fail_masks.to(torch.int64), res.processed.to(torch.int64)]
        ).cpu().numpy()
        return tuple(both)

    def _complete_batch(self, ctx: dict) -> list[ScheduleOutcome]:
        infos, profile = ctx["infos"], ctx["profile"]
        batch, deltas, active = ctx["batch"], ctx["deltas"], ctx["active"]
        nomrow = ctx["nomrow"]
        new_state = ctx["new_state"]
        picks, scores, feas, fails, processed = self._fetch(ctx["result"])
        if self._truncated:
            # Advance the rotating start by the batch's processedNodes sum
            # (scheduler.py:3788-3792): modular sums compose, so it equals
            # the start the pass carried on the device.
            self._next_start = (self._next_start + int(processed.sum())) % max(self.cache.node_count(), 1)
            carried = int(ctx["inv"]["scan_start"][0])
            if carried != self._next_start:
                raise RuntimeError(f"scan start: the host's {self._next_start}, the pass's {carried}")
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
                    p2, s2, f2, fl2, _pr2 = self._fetch(res)
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
            if self.provenance is not None:
                self._provenance_capture(qp.pod.uid, node_name, row, i, ctx, batch, scores, feas, fails, profile)
        # Phase 2: Reserve + PreBind + bind, in batch order.  A pod that lost
        # a same-batch race (a static PV, a ReadWriteOncePod claim, or the
        # named devices of a claim) holds nothing; it is forgotten — its
        # delta comes off the host rows,
        # which flush to the device at the next state() — and retries
        # behind backoff (scheduler.py:4091-4150).
        for i, node_name in placed:
            qp = infos[i]
            if not self._reserve(qp.pod, node_name):
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
                if self.provenance is not None:
                    # The pickOneNode rationale onto the preemptor's next
                    # capsule (scheduler.py:4331-4336); as there, the key
                    # reads the budgets after the dry-run debited them.
                    self.provenance.note_preemption(qp.pod.uid, {
                        "node": res.node_name, "victims": [v.uid for v in res.victims],
                        "key": self._preempt_key(res.victims),
                    })
                # A pod with Reserve work (a claim to bind or allocate) takes
                # the nominate-and-retry path (scheduler.py:2046).
                if self.inline_preempt_commit and not self._reserve_for(qp.pod) and (
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

    # -- the extender path (scheduler.py:2295-2499) ------------------------------

    def _resolve_nomrow(self, pod: t.Pod) -> int:
        """The pod's own nominated node as a row, -1 when unset or unknown
        (scheduler.py:2458): without it a retrying preemptor's claim in the
        fit overlay makes its freed node look full to itself."""
        nn = pod.status.nominated_node_name
        if nn:
            rec = self.cache.nodes.get(nn)
            if rec is not None:
                return rec.row
        return -1

    def _run_eval_pass(self, pod: t.Pod, profile: Profile, nomrow: int):
        """One pod through the eval-only pass (scheduler.py:2469-2499):
        featurize, run, one fetch.  Returns (batch, deltas, active,
        feasible (N,) bool, total (N,) i64) with numpy results."""
        batch, deltas, active = build_pod_batch([pod], self.builder, profile, 1)
        inv = self._full_inv()
        state = self.builder.state()
        run = self.passes.get_eval(profile, self.builder.schema, self.builder.res_col, active)
        feasible, total = run(state, dict(batch, nominated_row=np.full(1, nomrow, np.int32)), inv)
        both = torch.stack([feasible.to(torch.int64), total]).cpu().numpy()
        return batch, deltas, active, both[0].astype(np.bool_), both[1]

    def _schedule_one_extender(self, qp: QueuedPodInfo) -> ScheduleOutcome:
        """One scheduling cycle with the extender chain (scheduler.py:
        2295-2445): the eval-only pass, the extenders' filter and
        prioritize on the host (findNodesThatPassExtenders,
        schedule_one.go:704; prioritizeNodes, :799), the host selectHost
        (the highest combined score, the first such node in the
        extenders' order), assume, the Reserve plugins, the binder
        extender, bind.  A pod no node survives parks with
        {"Extender"} (any event wakes it, schedule_one.go:528) after
        PostFilter preemption, which extenders with a preempt verb may veto
        (ProcessPreemption, preemption.go:249).  As in the reference, a
        bind here leaves the pod's nomination in the nominator."""
        from .extender import run_extender_chain

        profile = self._profile_for(qp.pod) or self.profile
        nomrow = self._resolve_nomrow(qp.pod) if self.nominator else -1
        batch, deltas, active, feasible, total = self._run_eval_pass(qp.pod, profile, nomrow)
        rows = np.nonzero(feasible)[0]
        names = [self.cache.node_name_at_row(int(r)) for r in rows]
        scores = {nm: int(total[r]) for nm, r in zip(names, rows)}
        try:
            nodes, combined, _unres = run_extender_chain(self.extenders, qp.pod, names, scores)
        except Exception:
            # A non-ignorable extender failed: a cycle error, not
            # unschedulability — retry on a timer (handleSchedulingFailure).
            self.queue.add_backoff(qp)
            return ScheduleOutcome(qp.pod, None, 0, len(names))
        if not nodes:
            plugins = {"Extender"} if names else set(profile.filters)
            qp.delta = deltas[0]
            outcome = ScheduleOutcome(qp.pod, None, 0, len(names), frozenset(plugins))
            if "DefaultPreemption" in profile.post_filter:
                prow = {k: [np.asarray(v)[0]] for k, v in batch.items() if k != "valid"}
                preempt_exts = [ex for ex in self.extenders
                                if getattr(ex, "supports_preemption", False) and ex.is_interested(qp.pod)]

                def _ext_ok(pod, node_name, victims) -> bool:
                    want = {v.uid for v in victims}
                    for ex in preempt_exts:
                        try:
                            kept = ex.process_preemption(pod, {node_name: victims})
                        except Exception:
                            if ex.ignorable:
                                continue
                            return False
                        # The pass picked a minimal victim set: the node
                        # survives only if the extender keeps all of it.
                        if node_name not in kept or set(kept[node_name]) != want:
                            return False
                    return True

                res = self.preemption.preempt_batch(
                    [qp.pod], prow, active, profile=profile,
                    candidate_filter=_ext_ok if preempt_exts else None,
                )[0]
                # A zero-victim candidate is a node only the extender
                # rejected: only an eviction counts as progress here.
                if res is not None and res.victims:
                    self._record_preemption(qp, outcome, res, deltas[0])
                    if res.node_name in self.cache.nodes:
                        freed = {self.cache.nodes[res.node_name].row}
                        self.queue.on_event(Event.POD_DELETE, self._free_ctx(freed))
                    return outcome
            self.queue.add_unschedulable(qp, plugins)
            return outcome
        best = max(enumerate(nodes), key=lambda p: (combined[p[1]], -p[0]))[1]
        self.cache.assume_pod(qp.pod, best, device_already=False, delta=deltas[0])

        def _fail_bind(undos) -> ScheduleOutcome:
            for rp2, u2 in reversed(undos):
                rp2.unreserve(u2, self)
            self.cache.forget_pod(qp.pod.uid)
            self.queue.add_backoff(qp)
            return ScheduleOutcome(qp.pod, None, 0, len(nodes))

        undos: list = []
        for rp in self._reserve_for(qp.pod):
            u = rp.reserve(qp.pod, best, self)
            if u is None:
                return _fail_bind(undos)
            undos.append((rp, u))
        binder = next((ex for ex in self.extenders if getattr(ex, "bind_verb", "")), None)
        if binder is not None and not binder.bind(qp.pod, best):
            return _fail_bind(undos)
        qp.pod.spec.node_name = best
        self.cache.finish_binding(qp.pod.uid)
        self.queue.done(qp.pod.uid)
        return ScheduleOutcome(qp.pod, best, combined[best], len(nodes))

    # -- decision provenance (scheduler.py:2548-2797) -----------------------------

    def arm_provenance(self, capacity: int = 4096) -> None:
        """Start recording decision capsules (explain-this-binding).
        Idempotent; off by default: unarmed runs pay one ``is not None`` test
        a bind and bind identically."""
        if self.provenance is None:
            from .framework.provenance import ProvenanceRing

            self.provenance = ProvenanceRing(capacity)

    @staticmethod
    def _tie_step_of(i: int, ctx: dict, batch: dict) -> int:
        """The tie-break step the pass hashed for batch slot ``i``: the
        batch's cycle base plus the slot's step offset; -1 in the pinned
        pass (no per-step seed)."""
        soff = batch.get("step_offset")
        if soff is None:
            return -1
        return (int(ctx.get("cycle0", 0)) + int(np.asarray(soff)[i])) & 0xFFFFFFFF

    def _provenance_capture(self, uid, node_name, row, i, ctx, batch, scores, feas, fails, profile) -> None:
        """Record one live decision into the armed ring (scheduler.py:2568)."""
        from .framework.provenance import DecisionCapsule

        cap = DecisionCapsule(
            uid=uid, node=node_name, row=int(row), score=int(scores[i]), feasn=int(feas[i]),
            fail_mask=int(fails[i]), tie_step=self._tie_step_of(i, ctx, batch), profile=profile.name,
            nomrow=int(ctx["nomrow"][i]), kind="pinned" if ctx.get("pinned") else "batch",
        )
        cap.preemption = self.provenance.take_pending_preemption(uid)
        self.provenance.record(cap)

    def _preempt_key(self, victims) -> list[int]:
        """[PDB violations, max victim priority, priority sum, victim count,
        negated earliest start] — pickOneNodeForPreemption's ascending key
        over one candidate (scheduler.py:2923)."""
        violations = 0
        for pdb in self.pdbs.values():
            cnt = sum(1 for v in victims
                      if v.namespace == pdb.namespace and t.label_selector_matches(pdb.selector, v.metadata.labels))
            violations += max(0, cnt - pdb.disruptions_allowed)
        prios = [v.spec.priority for v in victims]
        max_prio = max(prios) if prios else -1
        starts = [v.status.start_time for v in victims
                  if v.spec.priority == max_prio and v.status.start_time is not None]
        start_key = int(-min(starts) * 1e6) if starts else -(2**61)
        return [violations, max_prio, sum(prios), len(victims), start_key]

    def _run_attribution_pass(self, pod: t.Pod, profile: Profile, nomrow: int):
        """One pod through the attribution pass (scheduler.py:2591):
        featurize, run, one fetch.  Returns (active, ok_cols (F, N),
        feasible (N,), score_cols (S, N), total (N,)) as numpy arrays."""
        batch, _deltas, active = build_pod_batch([pod], self.builder, profile, 1)
        inv = self._full_inv()
        state = self.builder.state()
        run = self.passes.get_attribution(profile, self.builder.schema, self.builder.res_col, active)
        batch["nominated_row"] = np.full(1, nomrow, np.int32)
        ok, feasible, cols, total = run(state, batch, inv)
        f = ok.shape[0]
        both = torch.cat([ok.to(torch.int64), feasible.to(torch.int64)[None], cols, total[None]]).cpu().numpy()
        return active, both[:f].astype(np.bool_), both[f].astype(np.bool_), both[f + 1 : -1], both[-1]

    def explain_pod(self, uid: str, seq: int | None = None, mode: str | None = None,
                    pod: t.Pod | None = None) -> dict:
        """The structured decision record of one pod (scheduler.py:2638-2797):
        its Filter and Score re-run through the attribution pass against
        the current state — every filter's verdict on every node with the
        rejecting plugin named, every scorer's normalized column, the
        selectHost trace — with the recorded live decision when provenance
        is armed.  A read path: nothing commits and no queue state moves.
        The port keeps no journal, so it takes the reference's journal-less
        branches: ``mode="journal"`` without ``seq`` returns the reference's
        error, and an explicit ``seq`` explains in current mode."""
        from .engine.pass_ import filter_op_names, score_op_names
        from .framework import provenance as prov

        cap = self.provenance.get(uid) if self.provenance is not None else None
        pr = self.cache.pods.get(uid)
        if pr is not None:
            pod = pr.pod
        else:
            qp = self.queue._info.get(uid)
            if qp is not None:
                pod = qp.pod
        if pod is None:
            return {"uid": uid, "error": "unknown pod (not bound, not queued)"}
        upto = None
        if seq is not None and seq > 0:
            upto = seq - 1
            # An explicit seq targets one decision; a capsule stamped with
            # another seq describes another bind of this uid.
            if cap is not None and cap.seq is not None and cap.seq != seq:
                cap = None
        if mode == "journal" and upto is None:
            return {"uid": uid,
                    "error": "journal mode needs a journaled, provenance-recorded bind (or an explicit seq)"}
        notes = []
        if pr is not None:
            # Already placed: re-filtering the live pod would pin NodeName to
            # its node.  Strip the binding on a copy; the verdicts still
            # include the pod's own resources.
            pod = copy.deepcopy(pod)
            pod.spec.node_name = ""
            notes.append("pod already placed: current-mode verdicts include its own committed usage "
                         "(use journal mode for bit-identity)")
        profile = self._profile_for(pod) or self.profile
        nomrow = self._resolve_nomrow(pod)
        if not self.cache.nodes:
            return {"uid": uid, "mode": "current", "error": "no nodes"}
        active, ok_cols, feasible, score_cols, total = self._run_attribution_pass(pod, profile, nomrow)
        # Real nodes only, in row order (padding rows are never feasible,
        # so the kth-tie count over the trimmed arrays is unchanged).
        rows = [r for r in range(total.shape[0]) if self.cache.node_name_at_row(r) is not None]
        names = [self.cache.node_name_at_row(r) for r in rows]
        idx = np.asarray(rows, np.int64)
        pos_of = {r: p for p, r in enumerate(rows)}
        rec = prov.assemble_record(
            uid=uid, mode="current", profile=profile, active=active, node_names=names,
            filter_names=filter_op_names(profile, active), score_ops=score_op_names(profile, active),
            ok_cols=ok_cols[:, idx] if ok_cols.size else np.zeros((0, len(rows)), bool),
            feasible=feasible[idx],
            score_cols=score_cols[:, idx] if score_cols.size else np.zeros((0, len(rows)), np.int64),
            total=total[idx], nomrow=pos_of.get(int(nomrow), -1), capsule=cap, truncated=self._truncated,
            tie_step=None,
        )
        rec["bound_node"] = pr.node_name if pr is not None else None
        if self.provenance is None:
            notes.append("provenance unarmed: no recorded live decision; tie-break trace degrades to kth=0")
        if notes:
            rec["note"] = "; ".join(notes)
        return rec
