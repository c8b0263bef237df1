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

``preemption_500n`` (harness.py:578-618, upstream PreemptionBasic): 500
nodes of 4 CPU, 16 GiB and 110 pods over 3 zones; 2000 background pods of
1 CPU and 2 GiB at priority 1 with start times 0..1999 fill them, drained
before a warm-up preemptor of 2 CPU and 4 GiB at priority 1000 arrives;
then 500 such preemptors, each needing two victims.  Batch 512, chunk 64,
fit-only profile, the queue's 1 s doubling backoff on the wall clock.

``preemption_async_5kn`` (harness.py:942-977, upstream PreemptionAsync):
5000 such nodes; 20000 background pods of 3900m CPU and 15 GiB at priority
1 (one fits a node, the rest wait unschedulable), drained before the
warm-up preemptor; then 1000 preemptors of 2 CPU and 4 GiB at priority
1000, each needing one victim.  Batch 1024, chunk 128, fit-only profile.

``daemonset_15kn`` (harness.py:816-850, upstream SchedulingDaemonset):
15000 nodes of 16 CPU, 64 GiB and 110 pods over 3 zones; 512 warm-up and
15000 measured pods of 100m CPU and 128 MiB, each pinned to one node by a
metadata.name matchFields node affinity (what the DaemonSet controller
emits), so every batch takes the pinned pass.  Batch 4096, chunk 64,
default profile.

``intree_pvs_5kn_2kpods`` (harness.py:664-716, upstream
SchedulingInTreePVs): 5000 such nodes over 10 zones; 512 warm-up and 2000
measured pods of 100m CPU and 256 MiB, each with its own claim pre-bound to
its own zonal PV (zone-(i mod 10)), so VolumeBinding, VolumeZone and
VolumeRestrictions filter on the bound path.  The warm-up grows the CSI
volume table to _bucket(2512) rows first, so no table grows in the
measured window.  Batch 4096, chunk 64, default profile.

``migrated_intree_pvs_5kn_5kpods`` (harness.py:718-737, upstream
SchedulingMigratedInTreePVs): the same with every PV fronted by the CSI
driver pd.csi.storage.gke.io and every node's CSINode allowing 39
attachments of it, so NodeVolumeLimits counts them; 512 warm-up and 5000
measured pods, the table grown to _bucket(5512) rows.

``csi_pvs_5kn_5kpods`` (harness.py:740-792, upstream SchedulingCSIPVs):
5000 nodes over 10 zones; one WaitForFirstConsumer StorageClass
provisioned by ebs.csi.aws.com; 512 warm-up and 5000 measured pods, each
with its own unbound claim of that class, which PreBind provisions on the
chosen node (one new PV each, bumping the volume catalog's epoch); the
table grown to _bucket(6000) rows.
"""

from __future__ import annotations

from .api import types as t
from .api.wrappers import make_node, make_pod, make_pv, make_pvc
from .snapshot import _bucket

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

PREEMPT_NODES = 500
PREEMPT_BG_PODS = 2000
PREEMPT_MEASURED_PODS = 500
PREEMPT_BATCH = 512
PREEMPT_CHUNK = 64
ASYNC_NODES = 5000
ASYNC_BG_PODS = 20000
ASYNC_MEASURED_PODS = 1000
ASYNC_BATCH = 1024
ASYNC_CHUNK = 128

DAEMONSET_NODES = 15000
DAEMONSET_WARM_PODS = 512
DAEMONSET_BATCH = 4096
DAEMONSET_CHUNK = 64

PV_NODES = 5000
PV_ZONES = 10
PV_WARM_PODS = 512
PV_BATCH = 4096
PV_CHUNK = 64
INTREE_MEASURED_PODS = 2000
MIGRATED_MEASURED_PODS = 5000
MIGRATED_DRIVER = "pd.csi.storage.gke.io"
MIGRATED_LIMIT = 39
CSI_MEASURED_PODS = 5000
CSI_DRIVER = "ebs.csi.aws.com"
CSI_CLASS = "csi-sc"
# The CSI workload's warm-up grows the CSI volume table to this many claims
# (harness.py:743).
CSI_TABLE_CLAIMS = 6000


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


def preemption_nodes(n: int = PREEMPT_NODES) -> list[t.Node]:
    """Nodes of 4 CPU and 16 GiB (harness.py:578 _preemption_nodes)."""
    return basic_nodes(n, cpu="4", mem="16Gi")


def preemption_background(count: int, cpu: str = "1", mem: str = "2Gi") -> list[t.Pod]:
    """Low-priority fill pods with distinct start times (harness.py:583,
    :943)."""
    return [
        make_pod(f"bg-{i}").req({"cpu": cpu, "memory": mem}).priority(1).start_time(float(i)).obj()
        for i in range(count)
    ]


def preemptor(name: str) -> t.Pod:
    """A preemptor of 2 CPU and 4 GiB at priority 1000 (harness.py:596)."""
    return make_pod(name).req({"cpu": "2", "memory": "4Gi"}).priority(1000).obj()


def daemon_pod(name: str, node: int) -> t.Pod:
    """A daemon pod pinned to node-<node> (harness.py:818-838)."""
    return make_pod(name).req({"cpu": "100m", "memory": "128Mi"}).node_name_affinity(f"node-{node}").obj()


# -- the persistent-volume workloads (harness.py:664-792) ---------------------------


def _pv_claim_pod(name: str, claim: str) -> t.Pod:
    return make_pod(name).req({"cpu": "100m", "memory": "256Mi"}).pvc_volume(claim).obj()


def migrated_csinodes(n: int = PV_NODES) -> list[t.CSINode]:
    """Every node's CSINode: 39 attachments of the migrated driver
    (harness.py:723-727)."""
    return [t.CSINode(name=f"node-{i}", driver_limits={MIGRATED_DRIVER: MIGRATED_LIMIT}) for i in range(n)]


def pv_warm(s, total_claims: int, zones: int = PV_ZONES, driver: str = "",
            count: int = PV_WARM_PODS) -> None:
    """harness.py:_pv_warm: grow the CSI volume table to the measured scale,
    then a volume-active wave of ``count`` pods, each with its own claim
    pre-bound to its own zonal PV."""
    s.builder._ensure(CV=_bucket(total_claims + count))
    for i in range(count):
        s.add_pv(make_pv(f"warmpv-{i}", zone=f"zone-{i % zones}", csi_driver=driver))
        s.add_pvc(make_pvc(f"warmclaim-{i}", volume_name=f"warmpv-{i}"))
        s.add_pod(_pv_claim_pod(f"warm-{i}", f"warmclaim-{i}"))


def pv_measured(s, count: int, zones: int = PV_ZONES, driver: str = "") -> int:
    """harness.py:_pv_measured: ``count`` pods, each with its own claim
    pre-bound to its own zonal PV (zone-(i mod zones))."""
    for i in range(count):
        s.add_pv(make_pv(f"pv-{i}", zone=f"zone-{i % zones}", csi_driver=driver))
        s.add_pvc(make_pvc(f"claim-{i}", volume_name=f"pv-{i}"))
        s.add_pod(_pv_claim_pod(f"pvpod-{i}", f"claim-{i}"))
    return count


def _csi_class() -> t.StorageClass:
    return t.StorageClass(name=CSI_CLASS, provisioner=CSI_DRIVER, binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER)


def csi_warm(s, count: int = PV_WARM_PODS, table_claims: int = CSI_TABLE_CLAIMS) -> None:
    """harness.py:_csi_warm: grow the CSI volume table, add the
    WaitForFirstConsumer class, then ``count`` pods with their own unbound
    claims of it."""
    s.builder._ensure(CV=_bucket(table_claims))
    s.add_storage_class(_csi_class())
    for i in range(count):
        s.add_pvc(make_pvc(f"warmcsi-{i}", storage_class=CSI_CLASS))
        s.add_pod(_pv_claim_pod(f"warm-{i}", f"warmcsi-{i}"))


def csi_measured(s, count: int) -> int:
    """harness.py:_csi_measured: ``count`` pods with their own unbound
    claims of the class (re-added, as the harness does)."""
    s.add_storage_class(_csi_class())
    for i in range(count):
        s.add_pvc(make_pvc(f"csiclaim-{i}", storage_class=CSI_CLASS))
        s.add_pod(_pv_claim_pod(f"csipod-{i}", f"csiclaim-{i}"))
    return count
