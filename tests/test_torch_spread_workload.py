"""TorchScheduler(device="cpu") against TPUScheduler on cuts of the two
spread workloads, with the harness's batch shape scaled down (batch 128,
chunk 64, the packer choosing the width):

  * spread_nodeaffinity_1kn_5kpods (kubernetes_tpu/benchmarks/harness.py:
    408-430): 30 nodes in 3 zones, 64 warm-up and 236 measured pods with a
    DoNotSchedule zone spread (maxSkew 2) and a required zone affinity;
  * node_inclusion_policy_5kn (harness.py:1185-1219): 40 nodes in 10 zones,
    the odd ones tainted, 64 warm-up and 236 measured pods with a
    DoNotSchedule zone spread (maxSkew 1) that honours taints.

Bindings must be equal pod for pod, with the packing and deferral counters
equal to the JAX scheduler's; every pod binds, and the workloads' own
gates hold: per app, zone counts within maxSkew (over untainted nodes for
the inclusion workload, where no pod lands on a tainted node).
Tolerance: none (exact)."""

from collections import Counter

import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.workloads import (
    ZONE, basic_nodes, inclusion_nodes, pod_inclusion, pod_spread_na, warm_pods,
)

WARM, MEASURED, BATCH, CHUNK = 64, 236, 128, 64
SHAPES = {"spread-na": (30, 3, 2), "inclusion": (40, 10, 1)}  # nodes, zones, maxSkew


def _jax_nodes(name, n, zones):
    for i in range(n):
        w = jnode(f"node-{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110}).zone(f"zone-{i % zones}")
        if name == "spread-na":
            w = w.region("region-1")
        elif i % 2:
            w = w.taint("dedicated", "gpu", jt.EFFECT_NO_SCHEDULE)
        yield w.obj()


def _jax_pod(name, i, zones):
    """harness.py:_pod_spread_na / _pod_inclusion."""
    w = jpod(f"pod-{i}").req({"cpu": "100m", "memory": "256Mi"}).label("app", f"app-{i % 10}")
    if name == "spread-na":
        return (w.spread_constraint(2, ZONE, jt.DO_NOT_SCHEDULE, "app", [f"app-{i % 10}"])
                .node_affinity_in(ZONE, [f"zone-{z}" for z in range(zones)]).obj())
    return w.spread_constraint(1, ZONE, jt.DO_NOT_SCHEDULE, "app", [f"app-{i % 10}"],
                               node_taints_policy=jt.POLICY_HONOR).obj()


def _run_jax(name):
    n, zones, _skew = SHAPES[name]
    s = TPUScheduler(profile=registered_subset(JDEF), batch_size=BATCH, chunk_size=CHUNK)
    for node in _jax_nodes(name, n, zones):
        s.add_node(node)
    for i in range(WARM):
        p = _jax_pod(name, 10**6 + i, zones)
        p.metadata.name = f"warm-{i}"
        s.add_pod(p)
    out = s.schedule_all_pending()
    for i in range(MEASURED):
        s.add_pod(_jax_pod(name, i, zones))
    return s, out + s.schedule_all_pending()


def _run_torch(name):
    n, zones, _skew = SHAPES[name]
    s = TorchScheduler(TDEF, batch_size=BATCH, chunk_size=CHUNK, device="cpu")
    if name == "spread-na":
        nodes, tmpl = basic_nodes(n, zones=zones), (lambda i: pod_spread_na(i, zones))
    else:
        nodes, tmpl = inclusion_nodes(n, zones), pod_inclusion
    for node in nodes:
        s.add_node(node)
    for pod in warm_pods(WARM, tmpl):
        s.add_pod(pod)
    out = s.schedule_all_pending()
    for i in range(MEASURED):
        s.add_pod(tmpl(i))
    return s, out + s.schedule_all_pending()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_scaled_spread_workload_bindings_match_jax(name):
    js, jout = _run_jax(name)
    ts, tout = _run_torch(name)
    jb = {o.pod.name: o.node_name for o in jout}
    tb = {o.pod.name: o.node_name for o in tout}
    assert len(tb) == WARM + MEASURED and all(v is not None for v in tb.values())
    assert tb == jb
    assert ts.deferred == js.metrics.deferred
    assert ts.packed_batches == js.metrics.packed_batches > 0
    assert ts.pack_collisions == js.metrics.pack_collisions
    assert ts.pack_width == js.metrics.pack_width
    assert ts.builder.host_mirror_equal()
    n, zones, skew = SHAPES[name]
    if name == "inclusion":
        assert all(int(v.split("-")[1]) % 2 == 0 for v in tb.values())  # untainted nodes only
    counts = Counter((o.pod.metadata.labels["app"], int(o.node_name.split("-")[1]) % zones) for o in tout)
    eligible = [z for z in range(zones) if name == "spread-na" or z % 2 == 0]
    for app in {a for a, _ in counts}:
        per_zone = [counts[(app, z)] for z in eligible]
        assert max(per_zone) - min(per_zone) <= skew, (app, per_zone)
