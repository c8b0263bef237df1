"""The op of DEFAULT_PROFILE whose device half is not yet ported.

DynamicResources is registered with a copy of its ``is_active`` predicate
only, so the engine can tell when it would do something for a batch.
``engine.features.build_pod_batch`` then raises NotImplementedError: a pod
with resource claims must fail loudly, never be scheduled as if its claims
were absent.  Predicate copied from kubernetes_tpu/ops/dynamicresources.py:86.
"""

from __future__ import annotations

from ..api import types as t
from .common import FeaturizeContext, OpDef, register


def _dra_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return bool(pod.spec.resource_claims)


register(OpDef(name="DynamicResources", is_active=_dra_active, unported=True))
