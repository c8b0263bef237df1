"""The workloads the port runs: own copies of the harness's shapes.

``density_5kn_30kpods_default`` (kubernetes_tpu/benchmarks/harness.py:273-312,
469): 5000 nodes of 16 CPU, 64 GiB and 110 pods over 3 zones in one region;
2048 warm-up pods and 30000 measured pods of 900m CPU and 2 GiB, labelled
with one of 10 apps; batch 4096, chunk 64, default profile.

``interpodaffinity_1kn_10kpods`` (harness.py:431-464): 1000 such nodes over
10 zones; 1024 warm-up pods and 10000 measured pods of 100m CPU and 256 MiB.
Even pods carry one of 1000 colours and a required zone anti-affinity to
their own colour; odd pods carry one of 50 affinity colours and a required
zone affinity to their own colour (the lonely-pod rule seats the first).
Batch 4096, chunk 64, default profile.

``spread_nodeaffinity_1kn_5kpods`` (harness.py:408-430, BASELINE config
#2): 1000 such nodes over 3 zones; 1024 warm-up and 5000 measured pods of
100m CPU and 256 MiB, labelled with one of 10 apps, each with a
DoNotSchedule zone spread constraint of maxSkew 2 over its own app and a
required node affinity to zones 0-2.  Batch 4096, chunk 64, default
profile.

``node_inclusion_policy_5kn`` (harness.py:1185-1219): 5000 nodes of 16
CPU, 64 GiB and 110 pods over 10 zones, the odd ones tainted
dedicated=gpu:NoSchedule; 1024 warm-up and 5000 measured pods of 100m CPU
and 256 MiB, labelled with one of 10 apps, each with a DoNotSchedule zone
spread constraint of maxSkew 1 over its own app that honours node taints.
Batch 4096, chunk 64, default profile.
"""

from __future__ import annotations

from .api import types as t
from .api.wrappers import make_node, make_pod

DENSITY_NODES = 5000
DENSITY_WARM_PODS = 2048
DENSITY_MEASURED_PODS = 30000
DENSITY_BATCH = 4096
DENSITY_CHUNK = 64

IPA_NODES = 1000
IPA_ZONES = 10
IPA_WARM_PODS = 1024
IPA_MEASURED_PODS = 10000
IPA_BATCH = 4096
IPA_CHUNK = 64
SPREAD_NODES = 1000
SPREAD_ZONES = 3
SPREAD_WARM_PODS = 1024
SPREAD_MEASURED_PODS = 5000
SPREAD_MAX_SKEW = 2

INCLUSION_NODES = 5000
INCLUSION_ZONES = 10
INCLUSION_WARM_PODS = 1024
INCLUSION_MEASURED_PODS = 5000
INCLUSION_MAX_SKEW = 1
# Both spread workloads run at the harness's batch and chunk.
SPREAD_BATCH = 4096
SPREAD_CHUNK = 64
ZONE = "topology.kubernetes.io/zone"


def basic_nodes(n: int, zones: int = 3, cpu: str = "16", mem: str = "64Gi") -> list[t.Node]:
    return [
        make_node(f"node-{i}")
        .capacity({"cpu": cpu, "memory": mem, "pods": 110})
        .zone(f"zone-{i % zones}")
        .region("region-1")
        .obj()
        for i in range(n)
    ]


def pod_basic(i: int) -> t.Pod:
    return (
        make_pod(f"pod-{i}")
        .req({"cpu": "900m", "memory": "2Gi"})
        .label("app", f"app-{i % 10}")
        .obj()
    )


def pod_ipa_heavy(
    i: int, anti_colours: int = 1000, aff_colours: int = 50, topology: str = ZONE
) -> t.Pod:
    """harness.py:_pod_ipa_heavy.  The colour counts and the topology key
    vary for scaled-down runs (the harness's are the defaults)."""
    j = i // 2
    if i % 2:
        return (
            make_pod(f"pod-{i}")
            .req({"cpu": "100m", "memory": "256Mi"})
            .label("acolor", f"a{j % aff_colours}")
            .pod_affinity_in("acolor", [f"a{j % aff_colours}"], topology)
            .obj()
        )
    return (
        make_pod(f"pod-{i}")
        .req({"cpu": "100m", "memory": "256Mi"})
        .label("color", f"c{j % anti_colours}")
        .pod_anti_affinity_in("color", [f"c{j % anti_colours}"], topology)
        .obj()
    )


def warm_pods(count: int = DENSITY_WARM_PODS, template=pod_basic) -> list[t.Pod]:
    """The harness's warm-up pods: the measured template at offset 10**6."""
    out = []
    for i in range(count):
        p = template(10**6 + i)
        p.metadata.name = f"warm-{i}"
        out.append(p)
    return out


def pod_spread_na(i: int, zones: int = SPREAD_ZONES) -> t.Pod:
    """harness.py:_pod_spread_na (the zone list follows ``zones``)."""
    return (
        make_pod(f"pod-{i}")
        .req({"cpu": "100m", "memory": "256Mi"})
        .label("app", f"app-{i % 10}")
        .spread_constraint(SPREAD_MAX_SKEW, ZONE, t.DO_NOT_SCHEDULE, "app", [f"app-{i % 10}"])
        .node_affinity_in(ZONE, [f"zone-{z}" for z in range(zones)])
        .obj()
    )


def inclusion_nodes(n: int = INCLUSION_NODES, zones: int = INCLUSION_ZONES) -> list[t.Node]:
    """harness.py:_inclusion_nodes: the odd nodes carry an intolerable
    dedicated=gpu:NoSchedule taint."""
    out = []
    for i in range(n):
        w = make_node(f"node-{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110}).zone(
            f"zone-{i % zones}")
        if i % 2:
            w = w.taint("dedicated", "gpu", t.EFFECT_NO_SCHEDULE)
        out.append(w.obj())
    return out


def pod_inclusion(i: int) -> t.Pod:
    """harness.py:_pod_inclusion."""
    return (
        make_pod(f"pod-{i}")
        .req({"cpu": "100m", "memory": "256Mi"})
        .label("app", f"app-{i % 10}")
        .spread_constraint(
            INCLUSION_MAX_SKEW, ZONE, t.DO_NOT_SCHEDULE, "app", [f"app-{i % 10}"],
            node_taints_policy=t.POLICY_HONOR,
        )
        .obj()
    )
