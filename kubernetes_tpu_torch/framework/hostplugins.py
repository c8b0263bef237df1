"""Host-side Reserve/PreBind plugins: the port's own copy of
``kubernetes_tpu/framework/hostplugins.py``, trimmed to the Reserve point
(the ReservePlugin protocol, DRAReserve and VolumeReserve, :74-148).

A Reserve plugin runs after the batch pass placed a pod and the cache
assumed it: ``reserve`` returns an undo record, or None when the
reservation lost a same-batch race before changing anything.  The
scheduler runs the pod's relevant plugins in DEFAULT_RESERVE_PLUGINS order
and, on a failure, ``unreserve``s the earlier ones in reverse, forgets the
pod and sends it to backoff (kubernetes_tpu/scheduler.py:4091-4150).
"""

from __future__ import annotations

from typing import Protocol

from ..api import types as t


class ReservePlugin(Protocol):
    name: str

    def relevant(self, pod: t.Pod, sched) -> bool:
        """Does this pod need this plugin's Reserve at all?"""

    def reserve(self, pod: t.Pod, node_name: str, sched):
        """Reserve host-side state for the pod on its chosen node: an undo
        token on success, None on failure."""

    def unreserve(self, undo, sched) -> None:
        """Revert a successful reserve (runtime.RunReservePluginsUnreserve)."""


class DRAReserve:
    """DynamicResources' Reserve: allocate and reserve the pod's claims on
    the chosen node (the claim assume-cache write), with the pool-overlap
    corrections of the named devices applied to the node's row.  Gated by
    the DynamicResourceAllocation feature."""

    name = "DynamicResources"

    def relevant(self, pod: t.Pod, sched) -> bool:
        return sched._dra_enabled and bool(pod.spec.resource_claims)

    def reserve(self, pod: t.Pod, node_name: str, sched):
        undo = sched.builder.dra.allocate_pod_claims(pod, node_name)
        sched._drain_dra_corrections()
        return undo

    def unreserve(self, undo, sched) -> None:
        if undo:
            sched.builder.dra.unallocate(undo)
            sched._drain_dra_corrections()


class VolumeReserve:
    """VolumeBinding's Reserve/PreBind: bind delayed (WaitForFirstConsumer)
    claims on the chosen node with a race re-check (volume_binding.go:521)."""

    name = "VolumeBinding"

    def relevant(self, pod: t.Pod, sched) -> bool:
        return any(v.pvc for v in pod.spec.volumes)

    def reserve(self, pod: t.Pod, node_name: str, sched):
        node = sched.cache.nodes[node_name].node
        return sched.builder.volumes.bind_pod_volumes(pod, node)

    def unreserve(self, undo, sched) -> None:
        if undo:
            sched.builder.volumes.unbind_pod_volumes(undo)


DEFAULT_RESERVE_PLUGINS = (DRAReserve(), VolumeReserve())
