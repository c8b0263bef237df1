"""Feature gates: the port's trimmed copy of ``kubernetes_tpu/framework/features.py``.

Only the gates the ported ops read are registered, all on by default as
in the reference: DynamicResourceAllocation (off: the DynamicResources
plugin exists at no extension point, TorchScheduler drops it from its
profile and never allocates a claim), NodeInclusionPolicyInPodTopologySpread (off: spread
ignores a constraint's nodeAffinityPolicy/nodeTaintsPolicy and uses the
legacy fixed policy, honor affinity and ignore taints) and
MatchLabelKeysInPodTopologySpread (off: a constraint's matchLabelKeys are
ignored).  PodTopologySpread's featurization reads them through
``FeaturizeContext.gates``.
"""

from __future__ import annotations

from dataclasses import dataclass

# name → default.
KNOWN_GATES: dict[str, bool] = {
    "DynamicResourceAllocation": True,
    "NodeInclusionPolicyInPodTopologySpread": True,
    "MatchLabelKeysInPodTopologySpread": True,
}


@dataclass(frozen=True)
class FeatureGates:
    overrides: tuple[tuple[str, bool], ...] = ()

    def enabled(self, name: str) -> bool:
        for k, v in self.overrides:
            if k == name:
                return v
        return KNOWN_GATES[name]


DEFAULT_GATES = FeatureGates()
