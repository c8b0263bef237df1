"""Host-side Reserve/PreBind plugins: the port's own copy of
``kubernetes_tpu/framework/hostplugins.py``, trimmed to VolumeBinding's
(VolumeReserve, :123-146).  DRA's claim allocation comes with its slice.

VolumeReserve runs after the batch pass placed a pod and the cache assumed
it: ``reserve`` returns an undo record, or None when the reservation lost
a same-batch race before binding anything, in which case the scheduler
forgets the pod and sends it to backoff (kubernetes_tpu/scheduler.py:
4091-4150).  It is the only Reserve plugin so far, so the scheduler calls
it directly; the plugin loop, with ``unreserve`` rolling back earlier
plugins, comes with the second one (DRA's claim allocation).
"""

from __future__ import annotations

from ..api import types as t


class VolumeReserve:
    """VolumeBinding's Reserve/PreBind: bind delayed (WaitForFirstConsumer)
    claims on the chosen node with a race re-check (volume_binding.go:521)."""

    name = "VolumeBinding"

    def relevant(self, pod: t.Pod, sched) -> bool:
        return any(v.pvc for v in pod.spec.volumes)

    def reserve(self, pod: t.Pod, node_name: str, sched):
        node = sched.cache.nodes[node_name].node
        return sched.builder.volumes.bind_pod_volumes(pod, node)
