"""TorchScheduler(device="cpu") against TPUScheduler on the
inter-pod-affinity workload (interpodaffinity_1kn_10kpods,
kubernetes_tpu/benchmarks/harness.py:431-464) cut to 40 nodes in 10 zones,
64 warm-up and 536 measured pods, batch 128, chunk 16.  The colour counts
scale with it so every pod stays schedulable (anti-affinity colours repeat
at most 7 times over 10 zones); 7 affinity colours leave classes just over
the chunk count, so the packer keeps width 16 with planned collisions,
chunk-mates defer and the host tail runs.  A hostname-topology variant
(one domain per node) runs the same shapes.  Bindings must be equal pod
for pod, with the packing counters and deferrals equal to the JAX
scheduler's.  Tolerance: none (exact)."""

import pytest

from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.workloads import ZONE, basic_nodes, pod_ipa_heavy, warm_pods

HOST = "kubernetes.io/hostname"
NODES, ZONES, WARM, MEASURED, BATCH, CHUNK = 40, 10, 64, 536, 128, 16
ANTI, AFF = 50, 7


def _jax_pod(i: int, topology: str):
    """harness.py:_pod_ipa_heavy with the scaled colour counts."""
    j = i // 2
    w = jpod(f"pod-{i}").req({"cpu": "100m", "memory": "256Mi"})
    if i % 2:
        return w.label("acolor", f"a{j % AFF}").pod_affinity_in("acolor", [f"a{j % AFF}"], topology).obj()
    return w.label("color", f"c{j % ANTI}").pod_anti_affinity_in("color", [f"c{j % ANTI}"], topology).obj()


def _run_jax(topology: str):
    s = TPUScheduler(profile=registered_subset(JDEF), batch_size=BATCH, chunk_size=CHUNK)
    for i in range(NODES):
        s.add_node(jnode(f"node-{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
                   .zone(f"zone-{i % ZONES}").region("region-1").obj())
    for i in range(WARM):
        p = _jax_pod(10**6 + i, topology)
        p.metadata.name = f"warm-{i}"
        s.add_pod(p)
    out = s.schedule_all_pending()
    for i in range(MEASURED):
        s.add_pod(_jax_pod(i, topology))
    return s, out + s.schedule_all_pending()


def _run_torch(topology: str):
    s = TorchScheduler(TDEF, batch_size=BATCH, chunk_size=CHUNK, device="cpu")
    for node in basic_nodes(NODES, zones=ZONES):
        s.add_node(node)
    tmpl = lambda i: pod_ipa_heavy(i, ANTI, AFF, topology)  # noqa: E731
    for pod in warm_pods(WARM, tmpl):
        s.add_pod(pod)
    out = s.schedule_all_pending()
    for i in range(MEASURED):
        s.add_pod(tmpl(i))
    return s, out + s.schedule_all_pending()


@pytest.mark.parametrize("topology", [ZONE, HOST], ids=["zone", "hostname"])
def test_scaled_ipa_workload_bindings_match_jax(topology):
    js, jout = _run_jax(topology)
    ts, tout = _run_torch(topology)
    jb = {o.pod.name: o.node_name for o in jout}
    tb = {o.pod.name: o.node_name for o in tout}
    assert len(tb) == WARM + MEASURED and all(v is not None for v in tb.values())
    assert tb == jb
    assert ts.deferred == js.metrics.deferred > 0  # the host tail ran
    assert ts.packed_batches == js.metrics.packed_batches > 0
    assert ts.pack_collisions == js.metrics.pack_collisions > 0
    assert ts.pack_width == js.metrics.pack_width
    assert (ts.dom_carry_hits, ts.dom_carry_rebuilds) == (
        js.metrics.dom_carry_hits, js.metrics.dom_carry_rebuilds)
    assert ts.builder.host_mirror_equal()
