"""The scheduler: the driving loop over queue → batch pass → bind.

Counterpart of ``kubernetes_tpu/scheduler.py`` (TPUScheduler): pop a batch
in QueueSort order, featurize it, run the batch pass on the device (filter,
score, select and commit for every pod of the batch), re-run chunk-deferred
pods through the host strict tail, then bind the picks through the cache
(the device already committed them) and park unschedulable pods.

It keeps the JAX scheduler's ``_dispatch_batch``/``_complete_batch`` logic
(scheduler.py:3451-3624, 3764-3930) for the ported ops: the nominated-pod
overlay (empty: preemption is not ported), the carried domain tables and
their validity token, the ``_cycle`` tie-break seeds, conflict-aware chunk
packing of affinity batches (engine/packing.py), the uniform-batch
expansion, and the strict tail in two rounds.  Preemption, gangs,
extenders, the pinned pass, journaling and the pipelined prefetch are
later slices; a pod that would need one raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import resolve_device
from .api import types as t
from .cache import Cache
from .engine.features import build_pod_batch, pin_name, pod_sig
from .engine.packing import pack_batch
from .engine.pass_ import PassCache, filter_op_names
from .framework.config import DEFAULT_PROFILE, Profile
from .intern import InternTable
from .ops import common as opcommon
from .queue import Event, QueuedPodInfo, SchedulingQueue
from .snapshot import SnapshotBuilder


@dataclass
class ScheduleOutcome:
    pod: t.Pod
    node_name: str | None  # None → unschedulable this round
    score: int = 0
    feasible_nodes: int = 0
    # Why the pod failed: the filter plugins that rejected nodes, from the
    # pass's per-op fail bitmask (framework/types.go Diagnosis).
    unschedulable_plugins: frozenset = frozenset()


def _expand_uniform(small: dict, k: int) -> dict:
    """Broadcast a uniform batch's single representative feature row to the
    full batch axis on the device (scheduler.py:44)."""
    return {kk: v[0].expand((k,) + v.shape[1:]).contiguous() for kk, v in small.items()}


class TorchScheduler:
    def __init__(
        self,
        profile: Profile = DEFAULT_PROFILE,
        batch_size: int = 256,
        chunk_size: int = 1,
        device: str | torch.device | None = None,
        *,
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
        self.interns = InternTable()
        self.builder = SnapshotBuilder(self.interns, device=self.device)
        self.cache = Cache(self.builder)
        self.queue = SchedulingQueue()
        self.passes = PassCache(_impl)
        # Carried domain tables: the previous pass's final (group_dom,
        # et_dom) and the (schema, mutation_epoch) token they are valid
        # under; any host mutation in between forces a rebuild.
        self._dom_carry: tuple | None = None
        self._dom_token: tuple | None = None
        # Tie-break cycle counter: the batch's seed base (scheduler.py:374).
        self._cycle = 0
        # Lowest priority among bound pods: a failed pod above it could
        # preempt, which this slice does not port.
        self._min_bound_priority: int | None = None
        self.deferred = 0  # chunk deferrals resolved by the strict tail
        # Batches that carried the domain tables / rebuilt them (build_dom).
        self.dom_carry_hits = 0
        self.dom_carry_rebuilds = 0
        # Conflict-aware packing (scheduler.py:3518-3557): batches reordered,
        # residual same-chunk collisions planned, the last packed width.
        self.packed_batches = 0
        self.pack_collisions = 0
        self.pack_width: int | None = None

    # -- cluster events --------------------------------------------------------

    def add_node(self, node: t.Node) -> None:
        self.cache.add_node(node)
        self.queue.on_event(Event.NODE_ADD)

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
            self._note_bound(pod)
            self.queue.on_event(Event.POD_ADD)
            return
        if pod.spec.scheduler_name not in (self.profile.name, "default-scheduler"):
            return  # another scheduler's pod (responsibleForPod)
        if pod.uid in self.cache.pods:
            return  # re-delivery of a pod already bound here
        self.queue.add(pod)

    def _note_bound(self, pod: t.Pod) -> None:
        p = pod.spec.priority
        if self._min_bound_priority is None or p < self._min_bound_priority:
            self._min_bound_priority = p

    # -- the batch loop --------------------------------------------------------

    def schedule_batch(self) -> list[ScheduleOutcome]:
        """Pop up to batch_size pods and schedule them in one batch pass."""
        infos = self.queue.pop_batch(self.batch_size)
        if not infos:
            return []
        return self._complete_batch(self._dispatch_batch(infos))

    def schedule_all_pending(self, max_rounds: int = 10_000) -> list[ScheduleOutcome]:
        """Drain the active queue."""
        out: list[ScheduleOutcome] = []
        for _ in range(max_rounds):
            got = self.schedule_batch()
            if not got:
                break
            out.extend(got)
        return out

    def _full_inv(self) -> dict:
        """Batch invariants plus the nominated-pod overlay (all zero: no pod
        is nominated without preemption), as device tensors."""
        inv = self.builder.batch_invariants()
        s = self.builder.schema
        inv["nom_req"] = np.zeros((s.N, s.R), np.int64)
        inv["nom_cnt"] = np.zeros(s.N, np.int32)
        inv["nom_prio"] = np.full(s.N, -(2**31), np.int32)
        return {k: torch.from_numpy(v).to(self.device) for k, v in inv.items()}

    def _to_device(self, batch: dict) -> dict:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in batch.items()
        }

    def _dispatch_batch(self, infos: list[QueuedPodInfo]) -> dict:
        profile = self.profile
        pods = [qp.pod for qp in infos]
        batch, deltas, active = build_pod_batch(pods, self.builder, profile, self.batch_size)
        nomrow = np.full(self.batch_size, -1, np.int32)
        batch["nominated_row"] = nomrow
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
                pods = [qp.pod for qp in infos]
                full = np.arange(self.batch_size, dtype=np.int64)
                full[:npods] = plan.perm
                batch = {key: np.asarray(arr)[full] for key, arr in batch.items()}
                nomrow = batch["nominated_row"]
                self.packed_batches += 1
            self.pack_collisions += plan.collisions
            self.pack_width = plan.width
        run = self.passes.get(
            profile, self.builder.schema, self.builder.res_col, active, chunk, carry_dom=True
        )
        uniform = False
        if chunk > 1:
            # Every pod featurization-identical (pass_.py uniform_all);
            # name-pinned pods count as distinct.
            sigs = {pod_sig(p) if pin_name(p) is None else i for i, p in enumerate(pods)}
            uniform = len(sigs) == 1
        per_pod = ("valid", "nominated_row", "step_offset")
        if uniform:
            # Ship one representative row and broadcast it on the device.
            small = self._to_device({kk: v[:1] for kk, v in batch.items() if kk not in per_pod})
            batch_d = _expand_uniform(small, self.batch_size)
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
        new_state, result, dom_out = run(
            state, batch_d, inv, cycle0, dom_in[0], dom_in[1], dom_ok
        )
        self._cycle += len(infos)
        return dict(
            infos=infos, batch=batch, deltas=deltas, active=active, nomrow=nomrow,
            inv=inv, new_state=new_state, result=result, dom_out=dom_out,
            schema=self.builder.schema, chunk=chunk, cycle0=cycle0,
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
        # Strict tail (scheduler.py:3845-3890): chunk-deferred pods re-run,
        # re-featurized, against the committed state in original order with
        # their original step seeds, until none remain.
        deferred = [i for i in range(len(infos)) if picks[i] == -2]
        if deferred:
            self.deferred += len(deferred)

            def run_tail(idx_list: list[int], chunk_level: int, size: int) -> list[int]:
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
        self.builder.absorb_device_state(new_state)
        self._dom_carry = ctx["dom_out"]
        self._dom_token = (self.builder.schema, self.builder.mutation_epoch)

        bit_names = filter_op_names(profile, active)
        failed = [i for i in range(len(infos)) if picks[i] < 0]
        outcomes: list[ScheduleOutcome] = []
        for i, qp in enumerate(infos):
            row = int(picks[i])
            if row < 0:
                continue
            node_name = self.cache.node_name_at_row(row)
            if node_name is None:
                raise RuntimeError(f"pick {row} maps to no node")
            self.cache.assume_pod(qp.pod, node_name, device_already=True, delta=deltas[i])
            self.cache.finish_binding(qp.pod.uid)
            qp.pod.spec.node_name = node_name
            self.queue.done(qp.pod.uid)
            self._note_bound(qp.pod)
            outcomes.append(ScheduleOutcome(qp.pod, node_name, int(scores[i]), int(feas[i])))
        for i in failed:
            mask = int(fails[i])
            plugins = frozenset(name for b, name in enumerate(bit_names) if mask & (1 << b))
            qp = infos[i]
            outcomes.append(ScheduleOutcome(qp.pod, None, 0, int(feas[i]), plugins))
            self.queue.add_unschedulable(qp, set(plugins) or set(profile.filters))
        # PostFilter: a failed pod above some bound pod's priority could
        # preempt (DefaultPreemption), which this slice does not port.  The
        # batch is complete and consistent when this raises.
        if "DefaultPreemption" in profile.post_filter and self._min_bound_priority is not None:
            for i in failed:
                pod = infos[i].pod
                if (
                    pod.spec.preemption_policy != t.PREEMPT_NEVER
                    and pod.spec.priority > self._min_bound_priority
                ):
                    raise NotImplementedError(
                        f"pod {pod.uid} could preempt lower-priority pods: preemption is not yet ported"
                    )
        return outcomes
