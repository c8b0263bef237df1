"""Host-side authoritative cluster state with the assume/bind protocol.

The port's own copy of ``kubernetes_tpu/cache.py`` (the reference's
scheduler cache, pkg/scheduler/backend/cache/cache.go), trimmed to what the
slices drive: node adds and updates, informer pod adds, the assume
(cache.go:361) / finish-binding (:376) / forget (:404) protocol of the
batch loop, and pod removal (preemption's victims).  Each node record
carries ``pods_gen``, bumped on every change to its pod set, which the
incremental victim repack reads.  Node removal and the zone-interleaved
node order of truncated mode come with the slices that need them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .api import types as t
from .snapshot import SnapshotBuilder


@dataclass
class NodeRecord:
    node: t.Node
    row: int
    pods: dict[str, t.Pod] = field(default_factory=dict)  # uid → pod
    generation: int = 0
    # Bumped on any pod-membership change (cache.go:186's generation diff,
    # read by the incremental victim repack).
    pods_gen: int = 0


@dataclass
class PodRecord:
    pod: t.Pod
    node_name: str
    delta: dict  # the precomputed row-delta vectors applied to the node row
    assumed: bool = False
    bound: bool = False
    assumed_at: float = 0.0


class Cache:
    def __init__(self, builder: SnapshotBuilder):
        self.builder = builder
        self.nodes: dict[str, NodeRecord] = {}
        self.pods: dict[str, PodRecord] = {}
        self._next_row = 0
        self._generation = 0
        self._row_to_name: dict[int, str] = {}
        self._pods_gen = 0

    def _bump_pods_gen(self, rec: NodeRecord) -> None:
        self._pods_gen += 1
        rec.pods_gen = self._pods_gen

    # -- nodes ---------------------------------------------------------------

    def node_count(self) -> int:
        return len(self.nodes)

    def row_of(self, node_name: str) -> int:
        return self.nodes[node_name].row

    def node_name_at_row(self, row: int) -> str | None:
        return self._row_to_name.get(row)

    def add_node(self, node: t.Node) -> None:
        if node.name in self.nodes:
            self.update_node(node)
            return
        row = self._next_row
        self._next_row += 1
        self._generation += 1
        rec = NodeRecord(node=node, row=row, generation=self._generation)
        self._bump_pods_gen(rec)
        self.nodes[node.name] = rec
        self.builder.set_node_row(row, node)
        self._row_to_name[row] = node.name

    def update_node(self, node: t.Node) -> None:
        rec = self.nodes[node.name]
        rec.node = node
        self._generation += 1
        rec.generation = self._generation
        # set_node_row rewrites only the node's static attributes; pod-derived
        # state (req/num_pods/counts) lives in separate arrays and is untouched.
        self.builder.set_node_row(rec.row, node)

    # -- pods ----------------------------------------------------------------

    def add_pod(self, pod: t.Pod, node_name: str | None = None) -> None:
        """Record an assigned pod (from the informer path)."""
        node_name = node_name or pod.spec.node_name
        rec = self.nodes[node_name]
        delta = self.builder.pod_delta_vectors(pod)
        self.pods[pod.uid] = PodRecord(pod=pod, node_name=node_name, delta=delta, bound=True)
        rec.pods[pod.uid] = pod
        self._bump_pods_gen(rec)
        self.builder.apply_pod_delta(rec.row, delta, +1, device_already=False)

    def assume_pod(self, pod: t.Pod, node_name: str, device_already: bool = True, delta: dict | None = None) -> None:
        """Optimistically place a pod (cache.go:361).  device_already=True
        when the batch pass already committed the delta on the device."""
        rec = self.nodes[node_name]
        if delta is None:
            delta = self.builder.pod_delta_vectors(pod)
        self.pods[pod.uid] = PodRecord(
            pod=pod, node_name=node_name, delta=delta, assumed=True, assumed_at=time.monotonic()
        )
        rec.pods[pod.uid] = pod
        self._bump_pods_gen(rec)
        self.builder.apply_pod_delta(rec.row, delta, +1, device_already=device_already)

    def finish_binding(self, uid: str) -> None:
        pr = self.pods[uid]
        pr.assumed, pr.bound = False, True

    def forget_pod(self, uid: str) -> None:
        """Undo an assume (cache.go:404)."""
        pr = self.pods.pop(uid)
        rec = self.nodes[pr.node_name]
        rec.pods.pop(uid, None)
        self._bump_pods_gen(rec)
        self.builder.apply_pod_delta(rec.row, pr.delta, -1, device_already=False)

    def remove_pod(self, uid: str) -> None:
        """A bound or assumed pod leaves its node (a deletion or an
        eviction): its delta comes off the node's row, which flushes to the
        device at the next state()."""
        pr = self.pods.pop(uid, None)
        if pr is None:
            return
        rec = self.nodes.get(pr.node_name)
        if rec is not None:
            rec.pods.pop(uid, None)
            self._bump_pods_gen(rec)
            self.builder.apply_pod_delta(rec.row, pr.delta, -1, device_already=False)
