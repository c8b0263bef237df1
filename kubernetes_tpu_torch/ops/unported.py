"""The ops of DEFAULT_PROFILE whose device halves are not yet ported.

Each is registered with a copy of its ``is_active`` predicate only, so the
engine can tell when one of them would do something for a batch.
``engine.features.build_pod_batch`` then raises NotImplementedError: a pod
with taints to tolerate, node affinity, host ports, volumes, topology
spread, claims or images must fail loudly, never be scheduled as if those
constraints were absent.  Predicates copied from kubernetes_tpu/ops:
tainttoleration.py:65, nodeaffinity.py:335, nodeports.py:66,
volumes.py:156,195,229,252, podtopologyspread.py:347, dynamicresources.py:86,
imagelocality.py:78.
"""

from __future__ import annotations

from ..api import types as t
from .common import FeaturizeContext, OpDef, register


def _taint_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    # With no taints interned anywhere, the filter passes every node and the
    # score is a uniform constant.
    return len(fctx.interns.taints) > 0


def _node_affinity_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    if fctx.profile is not None and fctx.profile.added_affinity is not None:
        return True
    aff = pod.spec.affinity
    return bool(pod.spec.node_selector) or bool(aff and aff.node_affinity)


def _node_ports_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return bool(pod.host_ports())


def _pvc_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.pvc for v in pod.spec.volumes)


def _volume_restrictions_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.device_id or v.pvc for v in pod.spec.volumes)


def _volume_limits_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.pvc for v in pod.spec.volumes) and len(fctx.interns.drivers) > 0


def _spread_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    if pod.spec.topology_spread_constraints:
        return True
    prof = fctx.profile
    return bool(prof is not None and prof.pts_default_constraints and pod.metadata.labels)


def _dra_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return bool(pod.spec.resource_claims)


def _image_locality_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    if len(fctx.interns.images) == 0:
        return False
    return any(
        c.images for c in list(pod.spec.init_containers) + list(pod.spec.containers)
    )


for _name, _pred in (
    ("TaintToleration", _taint_active),
    ("NodeAffinity", _node_affinity_active),
    ("NodePorts", _node_ports_active),
    ("VolumeBinding", _pvc_active),
    ("VolumeZone", _pvc_active),
    ("VolumeRestrictions", _volume_restrictions_active),
    ("NodeVolumeLimits", _volume_limits_active),
    ("PodTopologySpread", _spread_active),
    ("DynamicResources", _dra_active),
    ("ImageLocality", _image_locality_active),
):
    register(OpDef(name=_name, is_active=_pred, unported=True))
