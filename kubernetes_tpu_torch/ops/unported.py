"""The ops of DEFAULT_PROFILE whose device halves are not yet ported.

Each is registered with a copy of its ``is_active`` predicate only, so the
engine can tell when one of them would do something for a batch.
``engine.features.build_pod_batch`` then raises NotImplementedError: a pod
with host ports, volumes, claims or images must fail loudly, never be
scheduled as if those constraints were absent.  Predicates copied from
kubernetes_tpu/ops: nodeports.py:66, volumes.py:156,195,229,252,
dynamicresources.py:86, imagelocality.py:78.
"""

from __future__ import annotations

from ..api import types as t
from .common import FeaturizeContext, OpDef, register


def _node_ports_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return bool(pod.host_ports())


def _pvc_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.pvc for v in pod.spec.volumes)


def _volume_restrictions_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.device_id or v.pvc for v in pod.spec.volumes)


def _volume_limits_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.pvc for v in pod.spec.volumes) and len(fctx.interns.drivers) > 0


def _dra_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return bool(pod.spec.resource_claims)


def _image_locality_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    if len(fctx.interns.images) == 0:
        return False
    return any(
        c.images for c in list(pod.spec.init_containers) + list(pod.spec.containers)
    )


for _name, _pred in (
    ("NodePorts", _node_ports_active),
    ("VolumeBinding", _pvc_active),
    ("VolumeZone", _pvc_active),
    ("VolumeRestrictions", _volume_restrictions_active),
    ("NodeVolumeLimits", _volume_limits_active),
    ("DynamicResources", _dra_active),
    ("ImageLocality", _image_locality_active),
):
    register(OpDef(name=_name, is_active=_pred, unported=True))
