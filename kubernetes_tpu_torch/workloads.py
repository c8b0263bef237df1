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

``preemption_default_search_5kn`` has no harness counterpart either: a
high-priority service rolled out onto a cluster full of low-priority batch
pods, so preemption's what-if search decides.  5000 nodes of 4 CPU, 16 GiB
and 110 pods over 10 zones; 20000 background pods of 1 CPU and 3 GiB at
priority 1 with start times 0..19999, labelled app=batch: one in 8 holds
hostPort 8080, one in 8 of the others is labelled tier=noisy, and one in
16 carries a required anti-affinity to app=svc at the hostname.  They
arrive bound, four a node (``search_fill``: bg-i on node i // 4, so every
even node holds one port holder), as a cluster that has run for a while
reports them; then a warm-up preemptor of the measured template; then
1000 preemptors (run at half that, 500, for the smoke script's time)
of 2 CPU and 4 GiB at priority 1000, labelled app=svc, each with a
DoNotSchedule zone spread of maxSkew 1 over app=svc, a required
anti-affinity to tier=noisy at the hostname and hostPort 8080.  Batch 1024,
chunk 128, default profile, the queue's 1 s doubling backoff on the wall
clock, and nominate-and-retry in place of the inline preemptor commit
(``inline_preempt_commit=False``): the reference's inline commit places
same-signature chunk mates on the 1st, 2nd, ... best nodes of one dry-run
without re-running their spread filter, which breaks maxSkew, and mates of
another signature are deferred and parked with no event to wake them, so
every preemptor asks for the port (one signature).

``default_images_ports_5kn_10kpods`` has no harness counterpart (the
harness registers no workload whose nodes report images or whose pods ask
for host ports); it runs the default profile at density's shape on a
cluster as kubelets report it.  5000 nodes of 16 CPU, 64 GiB and 110 pods
over 3 zones, each reporting 50 images (the kubelet's default
nodeStatusMaxImages) drawn without replacement from a pool of 400 with
Zipf weights (s = 1.1), so base images sit on most nodes and the tail on
few; each image has two names (``repo:tag`` and ``repo@sha256:...``), a
few are tagged ``:latest``, sizes are uniform in 5 MiB-1.5 GiB.  2048
warm-up and 10000 measured pods of 900m CPU and 2 GiB from 40 templates of
1-2 containers, each naming a pool image by tag (one reference in 10
untagged, which normalizes to ``:latest``; a few naming an image no node
reports); one pod in 8 has an init container with an image; one pod in 32
asks for one hostPort (TCP 80, 443, 8080 or 9100, or UDP 53), a quarter of
those on the specific hostIP 10.0.0.1 and the rest on the wildcard.  The
warm-up names every port and hostIP of the measured pods, so no port or
image table grows in the measured window.  Batch 4096, chunk 64, default
profile.  Everything is drawn from ``seed`` with numpy.

``dra_claims_5kn_5kpods`` has no harness counterpart: GPU jobs that each
ask for a device through their own ResourceClaim, the shape of upstream
scheduler_perf's SchedulingWithResourceClaimTemplateStructured (one claim
a pod, one device each, devices published per node by ResourceSlices) at
half the headline's 5000 nodes (the name keeps the 5000 nodes and pods it
was written for; its depth, nodes and pods alike, was halved to keep
chip_smoke.py within its time limit: its plain run was the longest item
there).  Density's nodes, 2500 over 10 zones; one node in four (625)
publishes a ResourceSlice of class gpu.example.com with 8 named devices
(5000 in all) whose attributes are ``model`` and ``memory`` (int): h100
and 80 on even-numbered GPU nodes, a100 and 40 on odd ones.  512
claim-less density pods fill first; then 2500 pods of 1 CPU and 2 GiB at
priority 1, each with its own claim for one device (one in four under the
selector ``device.attributes["model"].string == "h100"``, a second pool
beside the bare class pool; one pod in 32 shares its claim with the next
pod, so the pair must land on one node and the claim is released once),
about 2425 claims for 2500 of the 5000 devices.  Then a shortage phase:
128 pods at priority 1000, each with its own selector-less claim for all 8
devices of a node, which no node has free, so each evicts the claim
holders of one GPU node.  The claim table is grown to 8192 rows
(dra_claim_counts: 128 MiB at N = 4096) before any claim is added.  Batch
1024, chunk 8, default profile.

``parity_basic_5kn_10kpods`` is upstream's SchedulingBasic 5000-node row
(the harness's ``basic_5kn_10kpods``, harness.py:396-405) in truncated
(parity) mode, as upstream's scheduler runs it: density's 5000 nodes of 16
CPU, 64 GiB and 110 pods over 3 zones (``_basic_nodes``, :273); 2048
warm-up and 10000 measured pods of 900m CPU and 2 GiB (``_pod_basic``,
:306), run at half its measured depth, 5000 pods (the name keeps the
10000 it was written for; the cut keeps chip_smoke.py within its time
with the heterogeneity and bin-packing paths: its plain run was the
third-longest item there);
the default profile with percentageOfNodesToScore unset, so the
adaptive formula scans for 50 − 5000/125 = 10% = 500 feasible nodes
(schedule_one.go:676-702) in the zone-interleaved node order from a
rotating start; chunk 1, which truncated mode requires (pass_.py:420-421,
scheduler.py:381-385), and batch 1024.  No node fills (at most 17 of these
pods fit one by CPU), so every pod's scan stops at 500 feasible nodes and
the start advances by about 500 a pod.

The heterogeneity workloads (harness.py:985-1110): nodes of 16 CPU, 64 GiB
and 110 pods over 10 zones in one region, labelled with an accelerator
class dealt by node index 5:3:2 over tpu-v4, tpu-v5e and gpu-a100
(``hetero_accel_for``); pods of 100m CPU and 256 MiB labelled with one of
10 apps and, in turn, with one of the four workload classes of the
throughput matrix.  Three profiles are registered, the default,
``throughput_aware_profile()`` and ``learned_scorer_profile()``; batch
4096, chunk 64.  The warm-up first pre-seeds the accelerator and workload
class vocabularies (``preseed_hetero_vocab``).
``hetero_1kn_5kpods`` (:1079) and ``hetero_5kn_10kpods`` (:1089): 1000
nodes and 1024 + 5000 pods, 5000 nodes and 2048 + 10000 pods, naming
``throughput-aware-scheduler``.  ``hetero_learned_1kn_5kpods`` (:1099):
1000 nodes and 1024 + 5000 pods naming ``learned-scorer-scheduler``.

``binpack_rtcr_5kn_10kpods`` has no harness counterpart: upstream's
documented bin-packing configuration (kubernetes.io/docs/concepts/
scheduling-eviction/resource-bin-packing: NodeResourcesFit with the
RequestedToCapacityRatio strategy, shape (0, 0), (100, 10), cpu and memory
weight 1) on density's shape: 5000 nodes of 16 CPU, 64 GiB and 110 pods
over 3 zones, 2048 warm-up and 10000 measured pods of 900m CPU and 2 GiB,
the default profile otherwise; batch 4096, chunk 64.  The most-requested
nodes win, so a chunk's pods crowd onto few nodes and defer behind their
mates.

``extender_5kn_1kpods`` has no harness counterpart: the shape of
upstream's test/integration/scheduler/extender_test.go (a filter extender
and a prioritize extender with a weight), in process, on density's shape:
5000 nodes of 16 CPU, 64 GiB and 110 pods over 10 zones, labelled tier
gold, silver or bronze (1:2:2), one in five labelled deny; 512 warm-up and
1000 measured pods of 900m CPU and 2 GiB; the default profile with three
extenders (``extender_chain``): one drops the deny nodes, not ignorable;
one scores gold 10, silver 5, bronze 0 with weight 5; one is ignorable and
raises on every 100th call.  Every pod schedules through the eval-only
pass, one at a time.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .api import types as t
from .api.wrappers import make_node, make_pod, make_pv, make_pvc
from .framework.config import DEFAULT_PROFILE, REQUESTED_TO_CAPACITY_RATIO, Profile, ScoringStrategy
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


SEARCH_NODES = 5000
SEARCH_ZONES = 10
SEARCH_BG_PODS = 20000
SEARCH_MEASURED_PODS = 500  # half of the 1000 preemptors, see above
SEARCH_BATCH = 1024
SEARCH_CHUNK = 128
SEARCH_PORT = 8080
HOSTNAME = "kubernetes.io/hostname"


def search_nodes(n: int = SEARCH_NODES, zones: int = SEARCH_ZONES) -> list[t.Node]:
    """preemption_default_search_5kn's nodes: 4 CPU, 16 GiB, 110 pods."""
    return basic_nodes(n, zones=zones, cpu="4", mem="16Gi")


def search_background(count: int = SEARCH_BG_PODS) -> list[t.Pod]:
    """The batch fill: app=batch at priority 1; one in 8 holds the service's
    host port, one in 8 of the others is tier=noisy, one in 16 keeps app=svc
    off its node.  The port holders come first, so each finds a node of
    its own and the fill leaves no pod pending (a pending one would be
    woken by every eviction and retried on the wall clock's backoff)."""
    out = []
    for i in range(count):
        w = make_pod(f"bg-{i}").req({"cpu": "1", "memory": "3Gi"}).priority(1).start_time(float(i))
        w = w.label("app", "batch")
        if i % 8 == 0:
            w = w.host_port(SEARCH_PORT)
        elif (i // 8) % 8 == 0:
            w = w.label("tier", "noisy")
        if i % 16 == 2:
            w = w.pod_anti_affinity_in("app", ["svc"], HOSTNAME)
        out.append(w.obj())
    return [p for p in out if p.host_ports()] + [p for p in out if not p.host_ports()]


def search_fill(count: int = SEARCH_BG_PODS) -> list[t.Pod]:
    """The batch fill bound to its nodes: bg-i on node-(i // 4)."""
    out = search_background(count)
    for p in out:
        p.spec.node_name = f"node-{int(p.metadata.name[3:]) // 4}"
    return out


def search_preemptor(name: str) -> t.Pod:
    """A service pod: 2 CPU and 4 GiB at priority 1000, spread over the
    zones with maxSkew 1, kept off tier=noisy nodes, on hostPort 8080."""
    return (
        make_pod(name).req({"cpu": "2", "memory": "4Gi"}).priority(1000).label("app", "svc")
        .spread_constraint(1, ZONE, t.DO_NOT_SCHEDULE, "app", ["svc"])
        .pod_anti_affinity_in("tier", ["noisy"], HOSTNAME)
        .host_port(SEARCH_PORT)
        .obj()
    )


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


# -- default_images_ports_5kn_10kpods (no harness counterpart) ----------------

IMAGES_NODES = 5000
IMAGES_ZONES = 3
IMAGES_WARM_PODS = 2048
IMAGES_MEASURED_PODS = 10000
IMAGES_BATCH = 4096
IMAGES_CHUNK = 64
IMAGE_POOL = 400
NODE_IMAGES = 50  # the kubelet's nodeStatusMaxImages default
IMAGE_ZIPF_S = 1.1
IMAGE_TEMPLATES = 40
PORT_EVERY = 32  # one pod in 32 asks for a host port
HOST_PORTS = (("TCP", 80), ("TCP", 443), ("TCP", 8080), ("TCP", 9100), ("UDP", 53))
SPECIFIC_IP = "10.0.0.1"
MIB = 1024 * 1024


@functools.lru_cache(maxsize=4)
def image_pool(seed: int = 0) -> tuple[tuple, np.ndarray]:
    """The 400 pool images as (tagged name, digest name, size in bytes),
    and their Zipf weights (rank order)."""
    rng = np.random.default_rng(seed)
    pool = []
    for i in range(IMAGE_POOL):
        repo = f"registry.example.com/team-{i % 16}/svc-{i}"
        tag = "latest" if i % 50 == 7 else f"v1.{i % 9}"
        size = int(rng.integers(5 * MIB, 1536 * MIB + 1))
        pool.append((f"{repo}:{tag}", f"{repo}@sha256:{rng.bytes(32).hex()}", size))
    weights = np.arange(1, IMAGE_POOL + 1, dtype=np.float64) ** -IMAGE_ZIPF_S
    return tuple(pool), weights / weights.sum()


@functools.lru_cache(maxsize=4)
def image_templates(seed: int = 0) -> tuple:
    """The 40 pod templates: (container image references, init container's
    image reference)."""
    pool, weights = image_pool(seed)
    rng = np.random.default_rng(seed + 1)
    latest = [i for i, (ref, _d, _s) in enumerate(pool) if ref.endswith(":latest")]
    out, refs_made = [], 0
    for j in range(IMAGE_TEMPLATES):
        refs = []
        for _ in range(1 + int(rng.integers(2))):
            refs_made += 1
            if refs_made % 10 == 0:  # untagged: normalizes to a :latest pool image
                refs.append(pool[latest[int(rng.integers(len(latest)))]][0].rsplit(":", 1)[0])
            elif refs_made % 29 == 0:  # an image no node reports
                refs.append(f"registry.example.com/scratch/tool-{j}:v0")
            else:
                refs.append(pool[int(rng.choice(IMAGE_POOL, p=weights))][0])
        out.append((tuple(refs), pool[int(rng.choice(IMAGE_POOL, p=weights))][0]))
    return tuple(out)


def node_image_picks(n: int, seed: int = 0) -> np.ndarray:
    """(n, 50) pool indices of each node's images, drawn without
    replacement with the Zipf weights (Efraimidis-Spirakis keys: the 50
    largest u ** (1 / weight) of uniform u)."""
    _pool, weights = image_pool(seed)
    keys = np.log(np.random.default_rng(seed + 2).random((n, IMAGE_POOL))) / weights
    return np.argsort(-keys, axis=1, kind="stable")[:, :NODE_IMAGES]


def images_nodes(n: int = IMAGES_NODES, zones: int = IMAGES_ZONES, seed: int = 0) -> list[t.Node]:
    """Density's nodes, each reporting its 50 images under both names."""
    pool, _w = image_pool(seed)
    images = [t.ContainerImage(names=(tag, digest), size_bytes=size) for tag, digest, size in pool]
    out = basic_nodes(n, zones)
    for node, picks in zip(out, node_image_picks(n, seed).tolist()):
        node.status.images = tuple(images[k] for k in picks)
    return out


def images_ports_pod_spec(i: int, seed: int = 0) -> dict:
    """Pod i of the workload as plain data: template index, container image
    references, the init container's reference (or None) and the host port
    (protocol, hostIP, port) it asks for (or None)."""
    j = i % IMAGE_TEMPLATES
    refs, init = image_templates(seed)[j]
    port = None
    if i % PORT_EVERY == 7:
        q = i // PORT_EVERY
        proto, number = HOST_PORTS[q % len(HOST_PORTS)]
        port = (proto, SPECIFIC_IP if q % 4 == 0 else "", number)
    return {"template": j, "refs": refs, "init": init if i % 8 == 3 else None, "port": port}


def pod_images_ports(i: int, seed: int = 0) -> t.Pod:
    spec = images_ports_pod_spec(i, seed)
    pod = (
        make_pod(f"pod-{i}")
        .req({"cpu": "900m", "memory": "2Gi"})
        .label("app", f"tmpl-{spec['template']}")
        .obj()
    )
    pod.spec.containers[0].images = spec["refs"][:1]
    pod.spec.containers += [t.Container(name=f"c{k}", images=(ref,)) for k, ref in enumerate(spec["refs"][1:], 1)]
    if spec["init"] is not None:
        pod.spec.init_containers.append(t.Container(name="init", images=(spec["init"],)))
    if spec["port"] is not None:
        proto, ip, number = spec["port"]
        pod.spec.containers[0].ports += (t.ContainerPort(host_port=number, protocol=proto, host_ip=ip),)
    return pod


# -- dra_claims_5kn_5kpods (no harness counterpart) ---------------------------

DRA_NODES = 2500
DRA_ZONES = 10
DRA_GPU_EVERY = 4  # one node in four publishes GPUs
DRA_GPUS = 8
DRA_CLASS = "gpu.example.com"
DRA_H100 = 'device.attributes["model"].string == "h100"'
DRA_FILL_PODS = 512
DRA_MEASURED_PODS = 2500
DRA_SELECTOR_EVERY = 4  # one pod in four wants an h100
DRA_SHARE_EVERY = 32  # one pod in 32 shares its claim with the next pod
DRA_PREEMPTORS = 128
DRA_CLAIM_TABLE = 8192
# Any two pods with unallocated claims conflict, so a chunk commits one of
# them whatever its width; a narrow chunk keeps preemption's dry-run chunk
# (the scheduler's, at most 64) small, so a batch of preemptors of distinct
# signatures gets one dry-run per 8 of them rather than per 64, and a batch
# of 1024 keeps the padding chunks of the preemptors' retries few.
DRA_BATCH = 1024
DRA_CHUNK = 8


# -- parity_basic_5kn_10kpods (harness.py:396-405, truncated mode) ------------

PARITY_NODES = 5000
PARITY_ZONES = 3
PARITY_WARM_PODS = 2048
PARITY_MEASURED_PODS = 5000  # half of basic_5kn_10kpods' 10000, see above
PARITY_BATCH = 1024
PARITY_CHUNK = 1
PARITY_PCT = None  # percentageOfNodesToScore unset: the adaptive formula


def dra_slices(n: int = DRA_NODES) -> list[t.ResourceSlice]:
    """The ResourceSlices of the GPU nodes: node-i for i a multiple of 4,
    the g-th of them h100 (memory 80) when g is even, else a100 (40)."""
    out = []
    for g, i in enumerate(range(0, n, DRA_GPU_EVERY)):
        model, memory = ("h100", 80) if g % 2 == 0 else ("a100", 40)
        devices = tuple(t.Device(name=f"gpu-{d}", attributes={"model": model, "memory": memory})
                        for d in range(DRA_GPUS))
        out.append(t.ResourceSlice(node_name=f"node-{i}", device_class=DRA_CLASS, devices=devices))
    return out


def dra_setup(s, n: int = DRA_NODES, table: int = DRA_CLAIM_TABLE) -> None:
    """Grow the claim table, publish the slices."""
    s.builder._ensure(CLM=_bucket(table))
    for sl in dra_slices(n):
        s.add_resource_slice(sl)


def dra_claim_of(i: int) -> str:
    """The claim measured pod i names: its own, or its predecessor's."""
    return f"gpu-claim-{i - 1 if i % DRA_SHARE_EVERY == 1 else i}"


def dra_claims(count: int = DRA_MEASURED_PODS) -> list[t.ResourceClaim]:
    """The measured pods' claims: one device each, one in four h100 only."""
    out = []
    for i in range(count):
        if i % DRA_SHARE_EVERY == 1:
            continue  # shares pod i - 1's claim
        sel = (DRA_H100,) if i % DRA_SELECTOR_EVERY == 2 else ()
        out.append(t.ResourceClaim(name=dra_claim_of(i), requests=(t.DeviceRequest("gpu", DRA_CLASS, 1, sel),)))
    return out


def dra_pod(i: int) -> t.Pod:
    return (make_pod(f"gpu-{i}").req({"cpu": "1", "memory": "2Gi"}).label("app", "gpu-job").priority(1)
            .resource_claim(dra_claim_of(i)).obj())


def dra_preemptor_claims(count: int = DRA_PREEMPTORS) -> list[t.ResourceClaim]:
    """The shortage phase's claims: every device of a node each."""
    return [t.ResourceClaim(name=f"node-claim-{i}", requests=(t.DeviceRequest("gpu", DRA_CLASS, DRA_GPUS),))
            for i in range(count)]


def dra_preemptor(i: int) -> t.Pod:
    return (make_pod(f"vip-{i}").req({"cpu": "1", "memory": "2Gi"}).label("app", "gpu-trainer").priority(1000)
            .resource_claim(f"node-claim-{i}").obj())


# -- the heterogeneity workloads (harness.py:985-1110) --------------------------

# Pool deal: 50% tpu-v4, 30% tpu-v5e, 20% gpu-a100, by node index.
HETERO_POOLS: tuple[tuple[str, int], ...] = (("tpu-v4", 5), ("tpu-v5e", 3), ("gpu-a100", 2))
HETERO_ZONES = 10
HETERO_BATCH = 4096
HETERO_CHUNK = 64
HETERO_NODES = 5000
HETERO_WARM_PODS = 2048
HETERO_MEASURED_PODS = 10000
HETERO_SMALL_NODES = 1000
HETERO_SMALL_WARM_PODS = 1024
HETERO_SMALL_MEASURED_PODS = 5000
THROUGHPUT_SCHEDULER = "throughput-aware-scheduler"
LEARNED_SCHEDULER = "learned-scorer-scheduler"


def hetero_accel_for(i: int, pools: tuple[tuple[str, int], ...] = HETERO_POOLS) -> str:
    """Accelerator class of node ``i`` under the weighted pool deal."""
    total = max(sum(w for _a, w in pools), 1)
    r = i % total
    for accel, w in pools:
        if r < w:
            return accel
        r -= w
    return pools[-1][0]


def hetero_nodes(n: int, zones: int = HETERO_ZONES) -> list[t.Node]:
    """harness.py:_hetero_nodes."""
    from .ops.throughput import ACCEL_LABEL_KEY

    return [
        make_node(f"node-{i}")
        .capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
        .zone(f"zone-{i % zones}")
        .region("region-1")
        .label(ACCEL_LABEL_KEY, hetero_accel_for(i))
        .obj()
        for i in range(n)
    ]


def pod_hetero(i: int, scheduler_name: str = THROUGHPUT_SCHEDULER) -> t.Pod:
    """harness.py:_pod_hetero: one of 10 apps, the four workload classes in
    turn."""
    from .ops.throughput import DEFAULT_THROUGHPUT_MATRIX, WORKLOAD_CLASS_LABEL_KEY

    classes = [w for w, _row in DEFAULT_THROUGHPUT_MATRIX]
    return (
        make_pod(f"pod-{i}")
        .req({"cpu": "100m", "memory": "256Mi"})
        .label("app", f"app-{i % 10}")
        .label(WORKLOAD_CLASS_LABEL_KEY, classes[i % len(classes)])
        .scheduler(scheduler_name)
        .obj()
    )


def pod_hetero_learned(i: int) -> t.Pod:
    """harness.py:_pod_hetero_learned."""
    return pod_hetero(i, scheduler_name=LEARNED_SCHEDULER)


def hetero_profiles() -> list[Profile]:
    """The two profiles registered beside the default (harness.py:_hetero_build)."""
    from .ops.learned import learned_scorer_profile
    from .ops.throughput import throughput_aware_profile

    return [throughput_aware_profile(), learned_scorer_profile()]


def hetero_warm(s) -> None:
    """The vocabulary pre-seed of harness.py:_hetero_warm, before its warm-up
    pods arrive."""
    from .ops.throughput import preseed_hetero_vocab

    preseed_hetero_vocab(s.builder)


# -- binpack_rtcr_5kn_10kpods (no harness counterpart) ---------------------------

BINPACK_NODES = 5000
BINPACK_WARM_PODS = 2048
BINPACK_MEASURED_PODS = 10000
BINPACK_BATCH = 4096
BINPACK_CHUNK = 64
# kubernetes.io/docs/concepts/scheduling-eviction/resource-bin-packing:
# utilization 0 scores 0, utilization 100 scores 10 (MaxNodeScore 100).
BINPACK_STRATEGY = ScoringStrategy(
    type=REQUESTED_TO_CAPACITY_RATIO, resources=(("cpu", 1), ("memory", 1)), shape=((0, 0), (100, 10)))


def binpack_profile(profile: Profile = DEFAULT_PROFILE) -> Profile:
    """The profile with NodeResourcesFit's bin-packing strategy."""
    return dataclasses.replace(profile, scoring_strategy=BINPACK_STRATEGY)


# -- extender_5kn_1kpods (no harness counterpart) ---------------------------------

EXTENDER_NODES = 5000
EXTENDER_ZONES = 10
EXTENDER_WARM_PODS = 512
EXTENDER_MEASURED_PODS = 1000
EXTENDER_BATCH = 256
TIERS = ("gold", "silver", "silver", "bronze", "bronze")  # dealt 1:2:2
TIER_SCORES = {"gold": 10, "silver": 5, "bronze": 0}
TIER_WEIGHT = 5
DENY_LABEL = "deny"
FLAKY_EVERY = 100


def extender_nodes(n: int = EXTENDER_NODES) -> list[t.Node]:
    """Density's nodes over 10 zones, each labelled tier=gold/silver/bronze
    (1:2:2) and one in five labelled deny."""
    out = basic_nodes(n, EXTENDER_ZONES)
    for i, node in enumerate(out):
        node.metadata.labels["tier"] = TIERS[i % 5]
        if (i // 5) % 5 == 3:
            node.metadata.labels[DENY_LABEL] = "true"
    return out


class DenyFilterExtender:
    """A filter extender that is not ignorable: it drops the nodes labelled
    deny, reporting one in 50 of them as FailedAndUnresolvable and the rest
    as FailedNodes (upstream test/integration/scheduler/extender_test.go's
    filter shape, in process)."""

    name = "deny-filter"
    weight = 1
    ignorable = False
    bind_verb = ""

    def __init__(self, nodes) -> None:
        denied = [node.name for node in nodes if DENY_LABEL in node.metadata.labels]
        self.unresolvable = set(denied[::50])
        self.denied = set(denied)
        self.calls = 0

    def is_interested(self, pod) -> bool:
        return True

    def filter(self, pod, nodes):
        from .extender import ExtenderFilterResult

        self.calls += 1
        keep = [n for n in nodes if n not in self.denied]
        failed = {n: "denied" for n in nodes if n in self.denied and n not in self.unresolvable}
        unres = {n: "denied for good" for n in nodes if n in self.unresolvable}
        return ExtenderFilterResult(node_names=keep, failed_nodes=failed, failed_and_unresolvable_nodes=unres)

    def prioritize(self, pod, nodes):
        return []

    def bind(self, pod, node) -> bool:
        return True


class TierPrioritizeExtender:
    """A prioritize extender of weight 5: gold 10, silver 5, bronze 0."""

    name = "tier-prioritize"
    weight = TIER_WEIGHT
    ignorable = False
    bind_verb = ""

    def __init__(self, nodes) -> None:
        self.tier = {node.name: node.metadata.labels["tier"] for node in nodes}
        self.calls = 0

    def is_interested(self, pod) -> bool:
        return True

    def filter(self, pod, nodes):
        from .extender import ExtenderFilterResult

        return ExtenderFilterResult(node_names=list(nodes))

    def prioritize(self, pod, nodes):
        from .extender import HostPriority

        self.calls += 1
        return [HostPriority(n, TIER_SCORES[self.tier[n]]) for n in nodes]

    def bind(self, pod, node) -> bool:
        return True


class FlakyExtender:
    """An ignorable extender that raises on every 100th call, filter and
    prioritize counted together; otherwise it passes every node and
    scores nothing."""

    name = "flaky"
    weight = 1
    ignorable = True
    bind_verb = ""

    def __init__(self) -> None:
        self.calls = 0
        self.raised = 0

    def _tick(self) -> None:
        self.calls += 1
        if self.calls % FLAKY_EVERY == 0:
            self.raised += 1
            raise ConnectionError("extender timed out")

    def is_interested(self, pod) -> bool:
        return True

    def filter(self, pod, nodes):
        from .extender import ExtenderFilterResult

        self._tick()
        return ExtenderFilterResult(node_names=list(nodes))

    def prioritize(self, pod, nodes):
        self._tick()
        return []

    def bind(self, pod, node) -> bool:
        return True


def extender_chain(nodes) -> list:
    """The path's three extenders, in chain order."""
    return [DenyFilterExtender(nodes), TierPrioritizeExtender(nodes), FlakyExtender()]


class PreemptExtender:
    """An extender with a preempt verb (ProcessPreemption) that keeps every
    candidate, or vetoes every one."""

    name = "preempt"
    weight = 1
    ignorable = False
    bind_verb = ""
    supports_preemption = True

    def __init__(self, veto: bool) -> None:
        self.veto = veto
        self.calls = 0

    def is_interested(self, pod) -> bool:
        return True

    def filter(self, pod, nodes):
        from .extender import ExtenderFilterResult

        return ExtenderFilterResult(node_names=list(nodes))

    def prioritize(self, pod, nodes):
        return []

    def bind(self, pod, node) -> bool:
        return True

    def process_preemption(self, pod, node_to_victims):
        self.calls += 1
        if self.veto:
            return {}
        return {node: [v.uid for v in victims] for node, victims in node_to_victims.items()}
