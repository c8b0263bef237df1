"""The scheduling queue: activeQ, backoffQ and the unschedulable pool.

The port's own copy of ``kubernetes_tpu/queue.py`` (the reference's
PriorityQueue, pkg/scheduler/backend/queue/scheduling_queue.go:152),
trimmed to what the ported slices drive.  ``pop_batch`` pops in QueueSort
order — priority descending, then enqueue time (queuesort/priority_sort.go;
queue.py:497-514).  Pods that fail wait in the unschedulable pool until a
cluster event that one of their rejecting plugins registered for moves them
to the backoff queue (isPodWorthRequeuing, scheduling_queue.go:406), with
NodeResourcesFit's object-aware hint (fit.go:253): a POD_DELETE wakes only
pods the freed capacity could seat (``EventCtx``).  Expired backoff pods
return to the active queue at the next pop (flushBackoffQCompleted, :777).

The clock is injectable (``clock=``), so a test can step time instead of
sleeping through a backoff; ``sleep_until_backoff`` sleeps only on the
wall clock.  ``backoff=True`` gives the reference's per-pod backoff, 1 s
doubling to 10 s (INITIAL_BACKOFF_S, MAX_BACKOFF_S).  The default is no
backoff, as in the port's first slices: a woken pod is back in the active
queue at the next pop, which their callers rely on.  Quarantine,
weighted-fair admission, gangs and the durable snapshot are left out.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from enum import IntFlag, auto

import numpy as np

from .api import types as t

# The reference's pod backoff (kubernetes_tpu/queue.py:69-70,
# podInitialBackoffSeconds and podMaxBackoffSeconds).
INITIAL_BACKOFF_S = 1.0
MAX_BACKOFF_S = 10.0

class Event(IntFlag):
    """Cluster event kinds driving requeue (framework/events.go:40)."""

    NODE_ADD = auto()
    NODE_UPDATE = auto()
    NODE_TAINT = auto()
    NODE_LABEL = auto()
    POD_ADD = auto()
    POD_UPDATE = auto()
    POD_DELETE = auto()
    PV_ADD = auto()
    PVC_ADD = auto()
    CLAIM_ADD = auto()
    ANY = (
        NODE_ADD | NODE_UPDATE | NODE_TAINT | NODE_LABEL | POD_ADD | POD_UPDATE
        | POD_DELETE | PV_ADD | PVC_ADD | CLAIM_ADD
    )


# Which events can unblock a pod rejected by a given plugin — the static core
# of each plugin's EventsToRegister (kubernetes_tpu/queue.py:48).
PLUGIN_REQUEUE_EVENTS: dict[str, Event] = {
    "NodeResourcesFit": Event.NODE_ADD | Event.NODE_UPDATE | Event.POD_DELETE | Event.POD_UPDATE,
    "NodeAffinity": Event.NODE_ADD | Event.NODE_LABEL,
    "NodeName": Event.NODE_ADD,
    "NodeUnschedulable": Event.NODE_ADD | Event.NODE_UPDATE,
    "TaintToleration": Event.NODE_ADD | Event.NODE_TAINT,
    "NodePorts": Event.NODE_ADD | Event.POD_DELETE,
    "PodTopologySpread": Event.NODE_ADD | Event.NODE_LABEL | Event.POD_ADD | Event.POD_DELETE | Event.POD_UPDATE,
    "InterPodAffinity": Event.NODE_ADD | Event.NODE_LABEL | Event.POD_ADD | Event.POD_DELETE | Event.POD_UPDATE,
    "VolumeBinding": Event.NODE_ADD | Event.PV_ADD | Event.PVC_ADD | Event.POD_DELETE,
    "VolumeZone": Event.NODE_ADD | Event.NODE_LABEL | Event.PV_ADD | Event.PVC_ADD,
    "VolumeRestrictions": Event.POD_DELETE | Event.PV_ADD | Event.PVC_ADD | Event.NODE_ADD,
    "NodeVolumeLimits": Event.NODE_ADD | Event.NODE_UPDATE | Event.POD_DELETE | Event.PVC_ADD,
    "DynamicResources": Event.CLAIM_ADD | Event.POD_DELETE | Event.NODE_ADD | Event.NODE_UPDATE,
}


@dataclass
class EventCtx:
    """The event object's payload for the object-aware hints: the free
    capacity of the affected nodes after the event, elementwise-maxed over
    them, with nominated pods' claims subtracted (queue.py:83)."""

    max_free: np.ndarray | None = None  # (R,) free allocatable upper bound
    max_slots: int = 0  # free pod slots upper bound


def _pack_reqs(reqs: list[np.ndarray]) -> np.ndarray:
    """Stack request vectors into one (K, maxR) int64 matrix (zero-padded)."""
    mx = max((q.shape[0] for q in reqs), default=0)
    reqm = np.zeros((len(reqs), max(mx, 1)), np.int64)
    for i, q in enumerate(reqs):
        reqm[i, : q.shape[0]] = q
    return reqm


def _fits_packed(reqm: np.ndarray, ctx: EventCtx) -> np.ndarray:
    """(K,) bool: which pods the event's freed capacity could seat.  A
    resource a pod does not request never blocks it; a pod needing a column
    the affected nodes do not expose never wakes."""
    k = reqm.shape[0]
    if ctx.max_slots < 1:
        return np.zeros(k, np.bool_)
    r = ctx.max_free.shape[0]
    head = reqm[:, :r]
    free = ctx.max_free[: head.shape[1]]
    fits = ((head == 0) | (head <= free[None, :])).all(axis=1)
    if reqm.shape[1] > r:
        fits &= ~(reqm[:, r:] != 0).any(axis=1)
    return fits


@dataclass
class QueuedPodInfo:
    """Mirror of framework.QueuedPodInfo (types.go:362)."""

    pod: t.Pod
    timestamp: float = 0.0  # time added to activeQ this round
    attempts: int = 0
    unschedulable_plugins: set = field(default_factory=set)
    # The pod's featurized commit delta from its last attempt; the fit hint
    # reads its request vector.
    delta: dict | None = None
    # A nominated-pin evaluation failed: the next attempt takes the full
    # pass (the scheduler's _pin_rows skips the pod).
    nom_pin_failed: bool = False
    # Verdict class this pod was filed under in the unschedulable pool.
    unsched_class: tuple | None = None


class SchedulingQueue:
    def __init__(self, backoff: bool = False, clock=time.monotonic) -> None:
        self._clock = clock
        self._seq = itertools.count()
        self._active: list = []  # heap of (-priority, timestamp, seq, uid)
        self._backoff: list = []  # heap of (expiry, seq, uid)
        self._unschedulable: dict[str, QueuedPodInfo] = {}
        # Verdict-class index over the unschedulable pool (queue.py:191):
        # pods filed under one (rejecting plugins, delta presence) class
        # share one requeue verdict per event.  Woken pods leave in class
        # order, then pool order, as in the reference's queue.
        self._unsched_classes: dict[tuple, dict[str, QueuedPodInfo]] = {}
        self._info: dict[str, QueuedPodInfo] = {}
        self._in_active: set[str] = set()
        self._gated: dict[str, QueuedPodInfo] = {}
        self.backoff = backoff

    def __len__(self) -> int:
        """Pods in the active queue."""
        return len(self._in_active)

    def add(self, pod: t.Pod) -> None:
        qp = self._info.get(pod.uid)
        if qp is None:
            qp = QueuedPodInfo(pod=pod, timestamp=self._clock())
            self._info[pod.uid] = qp
        qp.pod = pod
        # PreEnqueue: SchedulingGates holds gated pods out of every queue.
        if pod.spec.scheduling_gates:
            self._gated[pod.uid] = qp
            return
        self._push_active(qp)

    def reactivate(self, qp: QueuedPodInfo) -> None:
        """Return an in-flight pod to the active queue for a next-batch retry
        (schema-grown batches, failed nominated pins, pinned overflow)."""
        self._info[qp.pod.uid] = qp
        self._push_active(qp)

    def _push_active(self, qp: QueuedPodInfo) -> None:
        if qp.pod.uid in self._in_active:
            return
        qp.timestamp = self._clock()
        heapq.heappush(self._active, (-qp.pod.spec.priority, qp.timestamp, next(self._seq), qp.pod.uid))
        self._in_active.add(qp.pod.uid)
        self._unsched_remove(qp.pod.uid)

    def pop_batch(self, k: int) -> list[QueuedPodInfo]:
        """Pop up to k pods in QueueSort order, after moving expired backoff
        pods to the active queue."""
        self.flush_backoff()
        out: list[QueuedPodInfo] = []
        while self._active and len(out) < k:
            _, _, _, uid = heapq.heappop(self._active)
            if uid not in self._in_active:
                continue  # stale entry (deleted)
            self._in_active.discard(uid)
            qp = self._info[uid]
            qp.attempts += 1
            out.append(qp)
        return out

    def backoff_duration(self, attempts: int) -> float:
        if not self.backoff:
            return 0.0
        d = INITIAL_BACKOFF_S
        for _ in range(1, attempts):
            d *= 2
            if d >= MAX_BACKOFF_S:
                return MAX_BACKOFF_S
        return d

    def _unsched_insert(self, qp: QueuedPodInfo) -> None:
        if qp.pod.uid in self._unschedulable:
            self._unsched_remove(qp.pod.uid)
        self._unschedulable[qp.pod.uid] = qp
        ck = (
            frozenset(qp.unschedulable_plugins) if qp.unschedulable_plugins else None,
            qp.delta is None,
        )
        qp.unsched_class = ck
        self._unsched_classes.setdefault(ck, {})[qp.pod.uid] = qp

    def _unsched_remove(self, uid: str) -> QueuedPodInfo | None:
        qp = self._unschedulable.pop(uid, None)
        if qp is None:
            return None
        pool = self._unsched_classes.get(qp.unsched_class)
        if pool is not None:
            pool.pop(uid, None)
            if not pool:
                self._unsched_classes.pop(qp.unsched_class, None)
        return qp

    def add_unschedulable(self, qp: QueuedPodInfo, plugins: set[str]) -> None:
        """AddUnschedulableIfNotPresent (scheduling_queue.go:728): the pod
        waits in the pool keyed by the plugins that rejected it."""
        qp.unschedulable_plugins = plugins
        self._unsched_insert(qp)

    def unschedulable_uids(self) -> list[str]:
        return list(self._unschedulable)

    def add_backoff(self, qp: QueuedPodInfo) -> None:
        expiry = self._clock() + self.backoff_duration(qp.attempts)
        heapq.heappush(self._backoff, (expiry, next(self._seq), qp.pod.uid))

    def next_backoff_expiry(self) -> float | None:
        """Earliest backoff expiry, or None when the backoffQ is empty."""
        return self._backoff[0][0] if self._backoff else None

    def sleep_until_backoff(self) -> bool:
        """Sleep until the earliest backoff expires.  False when there is
        nothing to wait for, or under an injected clock, which sleeping
        cannot advance."""
        expiry = self.next_backoff_expiry()
        if expiry is None or self._clock is not time.monotonic:
            return False
        time.sleep(max(0.0, expiry - self._clock()) + 1e-3)
        return True

    def flush_backoff(self) -> int:
        """Move expired backoff pods to the active queue."""
        now = self._clock()
        n = 0
        while self._backoff and self._backoff[0][0] <= now:
            _, _, uid = heapq.heappop(self._backoff)
            qp = self._info.get(uid)
            if qp is not None:
                self._push_active(qp)
                n += 1
        return n

    def _requeue_verdict(self, qp: QueuedPodInfo, event: Event, ctx: EventCtx | None):
        """isPodWorthRequeuing, three-valued: True, False, or "fit" when the
        only deciding plugin is NodeResourcesFit and its object-aware hint
        (fit.go:253: does the freed capacity seat the pod?) has the event's
        payload and the pod's request; the caller batches those checks."""
        defer_fit = False
        for pl in qp.unschedulable_plugins or {"NodeResourcesFit"}:
            if not (PLUGIN_REQUEUE_EVENTS.get(pl, Event.ANY) & event):
                continue
            if pl != "NodeResourcesFit" or ctx is None or ctx.max_free is None or qp.delta is None:
                return True
            defer_fit = True
        return "fit" if defer_fit else False

    def on_event(self, event: Event, ctx: EventCtx | None = None) -> int:
        """MoveAllToActiveOrBackoffQueue (scheduling_queue.go:1029): move the
        unschedulable pods whose rejecting plugins care about ``event``
        (filtered through the fit hint when ``ctx`` is given) to the
        backoff queue; returns how many moved."""
        woken: list[str] = []
        for ck in list(self._unsched_classes):
            pool = self._unsched_classes.get(ck)
            if not pool:
                continue
            verdict = self._requeue_verdict(next(iter(pool.values())), event, ctx)
            if verdict is True:
                woken.extend(pool)
            elif verdict == "fit":
                uids = list(pool)
                fits = _fits_packed(_pack_reqs([pool[u].delta["req"] for u in uids]), ctx)
                woken.extend(u for u, ok in zip(uids, fits) if ok)
        for uid in woken:
            qp = self._unsched_remove(uid)
            if qp is not None:
                self.add_backoff(qp)
        return len(woken)

    def done(self, uid: str) -> None:
        """The pod left scheduling (bound)."""
        self._info.pop(uid, None)

    def delete(self, uid: str) -> None:
        self._in_active.discard(uid)
        self._unsched_remove(uid)
        self._gated.pop(uid, None)
        self._info.pop(uid, None)
