"""Fluent test/workload builders, in the spirit of the reference's
pkg/scheduler/testing/wrappers.go (MakeNode / MakePod chains).

The port's own copy of ``kubernetes_tpu/api/wrappers.py`` (PV/PVC builders
left out with the volume slice)."""

from __future__ import annotations

from typing import Optional

from . import types as t


class PodWrapper:
    def __init__(self, name: str = "pod", namespace: str = "default"):
        self._pod = t.Pod(metadata=t.ObjectMeta(name=name, namespace=namespace))
        self._pod.spec.containers.append(t.Container(name="c0"))

    # -- metadata ----------------------------------------------------------
    def uid(self, uid: str) -> "PodWrapper":
        self._pod.metadata.uid = uid
        return self

    def label(self, k: str, v: str) -> "PodWrapper":
        self._pod.metadata.labels[k] = v
        return self

    def labels(self, d: dict[str, str]) -> "PodWrapper":
        self._pod.metadata.labels.update(d)
        return self

    # -- resources ---------------------------------------------------------
    def req(self, resources: dict[str, str | int]) -> "PodWrapper":
        """Add requests to the first container (canonicalizes quantities)."""
        self._pod.spec.containers[0].requests.update(
            {k: t.parse_quantity(v, k) for k, v in resources.items()}
        )
        return self

    def init_req(
        self, resources: dict[str, str | int], restart_policy: Optional[str] = None
    ) -> "PodWrapper":
        self._pod.spec.init_containers.append(
            t.Container(
                name=f"init{len(self._pod.spec.init_containers)}",
                requests={k: t.parse_quantity(v, k) for k, v in resources.items()},
                restart_policy=restart_policy,
            )
        )
        return self

    def overhead(self, resources: dict[str, str | int]) -> "PodWrapper":
        self._pod.spec.overhead.update(
            {k: t.parse_quantity(v, k) for k, v in resources.items()}
        )
        return self

    # -- placement ---------------------------------------------------------
    def node(self, name: str) -> "PodWrapper":
        self._pod.spec.node_name = name
        return self

    def priority(self, p: int) -> "PodWrapper":
        self._pod.spec.priority = p
        return self

    def preemption_policy(self, policy: str) -> "PodWrapper":
        self._pod.spec.preemption_policy = policy
        return self

    def node_selector(self, d: dict[str, str]) -> "PodWrapper":
        self._pod.spec.node_selector.update(d)
        return self

    def toleration(
        self, key: str = "", op: str = t.TOLERATION_OP_EQUAL, value: str = "",
        effect: str = "", seconds: float | None = None,
    ) -> "PodWrapper":
        self._pod.spec.tolerations += (
            t.Toleration(key, op, value, effect, toleration_seconds=seconds),
        )
        return self

    def host_port(self, port: int, protocol: str = "TCP", host_ip: str = "") -> "PodWrapper":
        c = self._pod.spec.containers[0]
        c.ports += (t.ContainerPort(host_port=port, protocol=protocol, host_ip=host_ip),)
        return self

    def container_image(self, *names: str) -> "PodWrapper":
        self._pod.spec.containers[0].images += names
        return self

    def pvc_volume(self, pvc_name: str) -> "PodWrapper":
        self._pod.spec.volumes += (t.Volume(name=f"v{len(self._pod.spec.volumes)}", pvc=pvc_name),)
        return self

    def device_volume(self, device_id: str, read_only: bool = False) -> "PodWrapper":
        self._pod.spec.volumes += (
            t.Volume(name=f"v{len(self._pod.spec.volumes)}", device_id=device_id, read_only=read_only),
        )
        return self

    def pod_group(self, name: str) -> "PodWrapper":
        self._pod.spec.pod_group = name
        return self

    def scheduling_gate(self, name: str) -> "PodWrapper":
        self._pod.spec.scheduling_gates += (t.PodSchedulingGate(name),)
        return self

    def scheduler(self, name: str) -> "PodWrapper":
        """Profile selection (pod.spec.schedulerName)."""
        self._pod.spec.scheduler_name = name
        return self

    def resource_claim(self, name: str) -> "PodWrapper":
        """Reference a ResourceClaim (spec.resourceClaims, DRA)."""
        self._pod.spec.resource_claims += (name,)
        return self

    # -- affinity ----------------------------------------------------------
    def _affinity(self) -> t.Affinity:
        if self._pod.spec.affinity is None:
            self._pod.spec.affinity = t.Affinity()
        return self._pod.spec.affinity

    def node_affinity_in(self, key: str, values: list[str]) -> "PodWrapper":
        term = t.NodeSelectorTerm(
            match_expressions=(t.NodeSelectorRequirement(key, t.OP_IN, tuple(values)),)
        )
        a = self._affinity()
        na = a.node_affinity or t.NodeAffinity()
        req = na.required or t.NodeSelector()
        na = t.NodeAffinity(
            required=t.NodeSelector(req.terms + (term,)), preferred=na.preferred
        )
        self._pod.spec.affinity = t.Affinity(na, a.pod_affinity, a.pod_anti_affinity)
        return self

    def preferred_node_affinity_in(
        self, key: str, values: list[str], weight: int = 1
    ) -> "PodWrapper":
        term = t.NodeSelectorTerm(
            match_expressions=(t.NodeSelectorRequirement(key, t.OP_IN, tuple(values)),)
        )
        a = self._affinity()
        na = a.node_affinity or t.NodeAffinity()
        na = t.NodeAffinity(
            required=na.required,
            preferred=na.preferred + (t.PreferredSchedulingTerm(weight, term),),
        )
        self._pod.spec.affinity = t.Affinity(na, a.pod_affinity, a.pod_anti_affinity)
        return self

    def node_name_affinity(self, node_name: str) -> "PodWrapper":
        """DaemonSet-style pinning: required node affinity on the
        metadata.name matchField."""
        term = t.NodeSelectorTerm(
            match_fields=(t.NodeSelectorRequirement("metadata.name", t.OP_IN, (node_name,)),)
        )
        a = self._affinity()
        na = a.node_affinity or t.NodeAffinity()
        req = na.required or t.NodeSelector()
        na = t.NodeAffinity(
            required=t.NodeSelector(req.terms + (term,)), preferred=na.preferred
        )
        self._pod.spec.affinity = t.Affinity(na, a.pod_affinity, a.pod_anti_affinity)
        return self

    def _pod_term(self, label_key: str, label_values: list[str], topo: str) -> t.PodAffinityTerm:
        return t.PodAffinityTerm(
            label_selector=t.LabelSelector(
                match_expressions=(
                    t.LabelSelectorRequirement(label_key, t.OP_IN, tuple(label_values)),
                )
            ),
            topology_key=topo,
        )

    def _attach_pod_term(
        self, term: t.PodAffinityTerm, anti: bool, weight: int | None
    ) -> "PodWrapper":
        """Attach a (weighted) pod (anti-)affinity term — the single place
        that rebuilds the immutable Affinity tuple tree."""
        a = self._affinity()
        if anti:
            pa = a.pod_anti_affinity or t.PodAntiAffinity()
            if weight is None:
                pa = t.PodAntiAffinity(pa.required + (term,), pa.preferred)
            else:
                pa = t.PodAntiAffinity(
                    pa.required,
                    pa.preferred + (t.WeightedPodAffinityTerm(weight, term),),
                )
            self._pod.spec.affinity = t.Affinity(a.node_affinity, a.pod_affinity, pa)
        else:
            pa = a.pod_affinity or t.PodAffinity()
            if weight is None:
                pa = t.PodAffinity(pa.required + (term,), pa.preferred)
            else:
                pa = t.PodAffinity(
                    pa.required,
                    pa.preferred + (t.WeightedPodAffinityTerm(weight, term),),
                )
            self._pod.spec.affinity = t.Affinity(a.node_affinity, pa, a.pod_anti_affinity)
        return self

    def pod_affinity_in(self, key: str, values: list[str], topo: str) -> "PodWrapper":
        return self._attach_pod_term(self._pod_term(key, values, topo), False, None)

    def pod_anti_affinity_in(self, key: str, values: list[str], topo: str) -> "PodWrapper":
        return self._attach_pod_term(self._pod_term(key, values, topo), True, None)

    def preferred_pod_affinity_in(
        self, key: str, values: list[str], topo: str, weight: int = 1, anti: bool = False
    ) -> "PodWrapper":
        return self._attach_pod_term(self._pod_term(key, values, topo), anti, weight)

    def ns_selector_pod_affinity_in(
        self,
        key: str,
        values: list[str],
        topo: str,
        ns_key: str,
        ns_values: list[str],
        anti: bool = False,
        preferred_weight: int | None = None,
    ) -> "PodWrapper":
        """(Anti-)affinity term selecting pods across namespaces via a
        namespaceSelector."""
        term = t.PodAffinityTerm(
            label_selector=t.LabelSelector(
                match_expressions=(
                    t.LabelSelectorRequirement(key, t.OP_IN, tuple(values)),
                )
            ),
            topology_key=topo,
            namespace_selector=t.LabelSelector(
                match_expressions=(
                    t.LabelSelectorRequirement(ns_key, t.OP_IN, tuple(ns_values)),
                )
            ),
        )
        return self._attach_pod_term(term, anti, preferred_weight)

    def spread_constraint(
        self,
        max_skew: int,
        topo: str,
        when_unsatisfiable: str,
        label_key: str,
        label_values: list[str],
        min_domains: Optional[int] = None,
        node_affinity_policy: str = t.POLICY_HONOR,
        node_taints_policy: str = t.POLICY_IGNORE,
        match_label_keys: tuple[str, ...] = (),
    ) -> "PodWrapper":
        self._pod.spec.topology_spread_constraints += (
            t.TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topo,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=t.LabelSelector(
                    match_expressions=(
                        t.LabelSelectorRequirement(label_key, t.OP_IN, tuple(label_values)),
                    )
                ),
                min_domains=min_domains,
                node_affinity_policy=node_affinity_policy,
                node_taints_policy=node_taints_policy,
                match_label_keys=tuple(match_label_keys),
            ),
        )
        return self

    def obj(self) -> t.Pod:
        return self._pod


class NodeWrapper:
    def __init__(self, name: str = "node"):
        self._node = t.Node(metadata=t.ObjectMeta(name=name, namespace=""))
        self._node.metadata.labels["kubernetes.io/hostname"] = name

    def label(self, k: str, v: str) -> "NodeWrapper":
        self._node.metadata.labels[k] = v
        return self

    def capacity(self, resources: dict[str, str | int]) -> "NodeWrapper":
        """Set capacity AND allocatable (like MakeNode().Capacity())."""
        parsed = {k: t.parse_quantity(v, k) for k, v in resources.items()}
        self._node.status.capacity.update(parsed)
        self._node.status.allocatable.update(parsed)
        return self

    def allocatable(self, resources: dict[str, str | int]) -> "NodeWrapper":
        self._node.status.allocatable.update(
            {k: t.parse_quantity(v, k) for k, v in resources.items()}
        )
        return self

    def taint(self, key: str, value: str = "", effect: str = t.EFFECT_NO_SCHEDULE) -> "NodeWrapper":
        self._node.spec.taints += (t.Taint(key, value, effect),)
        return self

    def unschedulable(self, v: bool = True) -> "NodeWrapper":
        self._node.spec.unschedulable = v
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        self._node.status.images += (t.ContainerImage(names=(name,), size_bytes=size_bytes),)
        return self

    def zone(self, z: str) -> "NodeWrapper":
        self._node.metadata.labels["topology.kubernetes.io/zone"] = z
        return self

    def region(self, r: str) -> "NodeWrapper":
        self._node.metadata.labels["topology.kubernetes.io/region"] = r
        return self

    def obj(self) -> t.Node:
        return self._node


def make_pod(name: str = "pod", namespace: str = "default") -> PodWrapper:
    return PodWrapper(name, namespace)


def make_node(name: str = "node") -> NodeWrapper:
    return NodeWrapper(name)
