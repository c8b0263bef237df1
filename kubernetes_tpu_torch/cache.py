"""Host-side authoritative cluster state with the assume/bind protocol.

The port's own copy of ``kubernetes_tpu/cache.py`` (the reference's
scheduler cache, pkg/scheduler/backend/cache/cache.go), trimmed to what the
slices drive: node adds and updates, informer pod adds, the assume
(cache.go:361) / finish-binding (:376) / forget (:404) protocol of the
batch loop, pod removal (preemption's victims), and the zone-interleaved
node order that truncated mode scans (``NodeTree``, ``order_pos``).  Each
node record carries ``pods_gen``, bumped on every change to its pod set,
which the incremental victim repack reads.  Node removal (``remove_node``
with its row reuse) is not ported; ``NodeTree.remove`` is, for a node that
changes zone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .api import types as t
from .snapshot import SnapshotBuilder

# Zone label keys, GA + legacy beta (utilnode.GetZoneKey).
_ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
)
# order_pos of a row that holds no node, and its rotated position
# (pass_.py:519).
NO_POS = 2**30


def _zone_of(node: t.Node) -> str:
    for key in _ZONE_LABELS:
        z = node.metadata.labels.get(key)
        if z:
            return z
    return ""


@dataclass
class NodeRecord:
    node: t.Node
    row: int
    pods: dict[str, t.Pod] = field(default_factory=dict)  # uid → pod
    generation: int = 0
    zone: str = ""
    # Bumped on any pod-membership change (cache.go:186's generation diff,
    # read by the incremental victim repack).
    pods_gen: int = 0


class NodeTree:
    """Zone → node-name lists with round-robin interleaved iteration, the
    reference's nodeTree (backend/cache/node_tree.go:119 list()): the scan
    order spreads consecutive positions across zones, so truncated search
    (percentageOfNodesToScore) samples every zone fairly."""

    def __init__(self) -> None:
        self.zones: dict[str, list[str]] = {}

    def add(self, zone: str, name: str) -> None:
        self.zones.setdefault(zone, []).append(name)

    def remove(self, zone: str, name: str) -> None:
        names = self.zones.get(zone)
        if names is not None:
            try:
                names.remove(name)
            except ValueError:
                pass
            if not names:
                self.zones.pop(zone, None)

    def list(self) -> list[str]:
        """Round-robin over zones: zone0[0], zone1[0], ..., zone0[1], ..."""
        out: list[str] = []
        idx = 0
        exhausted = 0
        zone_lists = list(self.zones.values())
        while zone_lists and exhausted < len(zone_lists):
            exhausted = 0
            for names in zone_lists:
                if idx < len(names):
                    out.append(names[idx])
                else:
                    exhausted += 1
            idx += 1
        return out


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
        self.node_tree = NodeTree()
        # (generation, order_pos) of the last order_pos call.
        self._order_cache: tuple[int, np.ndarray] | None = None

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
        zone = _zone_of(node)
        rec = NodeRecord(node=node, row=row, generation=self._generation, zone=zone)
        self._bump_pods_gen(rec)
        self.nodes[node.name] = rec
        self.builder.set_node_row(row, node)
        self._row_to_name[row] = node.name
        self.node_tree.add(zone, node.name)

    def update_node(self, node: t.Node) -> None:
        rec = self.nodes[node.name]
        rec.node = node
        self._generation += 1
        rec.generation = self._generation
        zone = _zone_of(node)
        if zone != rec.zone:
            self.node_tree.remove(rec.zone, node.name)
            self.node_tree.add(zone, node.name)
            rec.zone = zone
        # set_node_row rewrites only the node's static attributes; pod-derived
        # state (req/num_pods/counts) lives in separate arrays and is untouched.
        self.builder.set_node_row(rec.row, node)

    def order_pos(self, n: int) -> np.ndarray:
        """(n,) i32: each row's position in the zone-interleaved node order
        (node_tree.go:119); rows holding no node get NO_POS.  Cached per
        cache generation, which every node add and update bumps."""
        if self._order_cache is not None and self._order_cache[0] == self._generation:
            arr = self._order_cache[1]
            if arr.shape[0] == n:
                return arr
        arr = np.full(n, NO_POS, np.int32)
        for i, name in enumerate(self.node_tree.list()):
            arr[self.nodes[name].row] = i
        self._order_cache = (self._generation, arr)
        return arr

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
