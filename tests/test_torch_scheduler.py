"""TorchScheduler(device="cpu") against TPUScheduler: identical bindings on
scaled-down shapes of the fit-only and density workloads, failures with
the same diagnosis, carried domain tables across batches and host
mutations, pods with host ports and affinity scheduled as the JAX
scheduler does, and the slice's loud failures (unported ops, preemption,
no CUDA).  Plus the import-isolation contract: the port imports neither
``jax`` nor ``kubernetes_tpu``."""

import subprocess
import sys

import pytest
import torch

from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.benchmarks.harness import _basic_nodes, _pod_basic
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import fit_only_profile as jfit
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.framework.config import fit_only_profile as tfit
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.workloads import basic_nodes, pod_basic, warm_pods


def _bindings(outcomes):
    return {o.pod.name: o.node_name for o in outcomes}


def _fit_cluster(s, mknode, mkpod):
    for i in range(100):
        s.add_node(mknode(f"node-{i}").capacity(
            {"cpu": "4" if i % 3 else "2", "memory": "8Gi", "pods": 110}).obj())
    for i in range(400):
        s.add_pod(mkpod(f"m-{i}").req(
            {"cpu": f"{500 + 250 * (i % 4)}m", "memory": f"{1 + i % 2}Gi"}).obj())


def test_fit_only_bindings_and_failures_match_jax():
    """basic_500n_1kpods_fitonly shapes scaled to 100 nodes / 400 pods,
    over-committed so that the tail of the queue fails."""
    js = TPUScheduler(profile=jfit(), batch_size=64, chunk_size=16)
    _fit_cluster(js, jnode, jpod)
    jout = js.schedule_all_pending()
    ts = TorchScheduler(profile=tfit(), batch_size=64, chunk_size=16, device="cpu")
    _fit_cluster(ts, tnode, tpod)
    tout = ts.schedule_all_pending()
    assert _bindings(tout) == _bindings(jout)
    failed = {o.pod.name: o for o in jout if o.node_name is None}
    assert failed, "the shape must over-commit"
    for o in tout:
        if o.node_name is None:
            j = failed[o.pod.name]
            assert o.unschedulable_plugins == frozenset(j.diagnosis.unschedulable_plugins)
            assert o.feasible_nodes == j.feasible_nodes
    assert ts.deferred == js.metrics.deferred > 0
    assert ts.builder.host_mirror_equal()


def test_scaled_density_bindings_match_jax():
    """density_5kn_30kpods_default scaled to 300 nodes, 256 warm-up + 1244
    measured pods, batch 256, chunk 16 (six batches, carried tables)."""
    js = TPUScheduler(profile=registered_subset(JDEF), batch_size=256, chunk_size=16)
    _basic_nodes(300)(js)
    for i in range(256):
        p = _pod_basic(10**6 + i)
        p.metadata.name = f"warm-{i}"
        js.add_pod(p)
    jout = js.schedule_all_pending()
    for i in range(1244):
        js.add_pod(_pod_basic(i))
    jout += js.schedule_all_pending()
    ts = TorchScheduler(TDEF, batch_size=256, chunk_size=16, device="cpu")
    for n in basic_nodes(300):
        ts.add_node(n)
    for p in warm_pods(256):
        ts.add_pod(p)
    tout = ts.schedule_all_pending()
    for i in range(1244):
        ts.add_pod(pod_basic(i))
    tout += ts.schedule_all_pending()
    tb = _bindings(tout)
    assert len(tb) == 1500 and all(v is not None for v in tb.values())
    assert tb == _bindings(jout)
    assert js.metrics.dom_carry_hits >= 3
    assert ts.builder.host_mirror_equal()


def test_dom_carry_invalidated_by_host_mutation():
    """Batches separated by a node add (a host mutation: the carried tables
    must be rebuilt) and by nothing (carried): bindings equal JAX's."""
    def drive(s, mknode, mkpod):
        out = []
        for i in range(24):
            s.add_node(mknode(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": 20}).zone(f"z{i % 3}").obj())
        for b in range(3):
            for j in range(32):
                s.add_pod(mkpod(f"p{b}-{j}").req({"cpu": f"{300 + 100 * (j % 4)}m", "memory": "1Gi"})
                          .label("app", f"a{j % 5}").obj())
            out += s.schedule_all_pending()
            if b == 1:
                s.add_node(mknode("late").capacity({"cpu": "32", "memory": "128Gi", "pods": 50}).zone("z1").obj())
        return out

    js = TPUScheduler(profile=registered_subset(JDEF), batch_size=16, chunk_size=8)
    ts = TorchScheduler(TDEF, batch_size=16, chunk_size=8, device="cpu")
    assert _bindings(drive(ts, tnode, tpod)) == _bindings(drive(js, jnode, jpod))


def test_priority_order_and_gated_pods():
    ts = TorchScheduler(tfit(), batch_size=4, chunk_size=1, device="cpu")
    ts.add_node(tnode("n0").capacity({"cpu": "2", "memory": "8Gi", "pods": 10}).obj())
    ts.add_pod(tpod("low").req({"cpu": "1"}).obj())
    ts.add_pod(tpod("gated").req({"cpu": "1"}).scheduling_gate("wait").obj())
    ts.add_pod(tpod("high").req({"cpu": "1"}).priority(10).obj())
    ts.add_pod(tpod("mid").req({"cpu": "1"}).priority(5).obj())
    out = _bindings(ts.schedule_all_pending())
    assert out == {"high": "n0", "mid": "n0", "low": None}
    assert ts.queue.unschedulable_uids() == ["default/low"]
    # A node add wakes the pod the fit filter rejected.
    ts.add_node(tnode("n1").capacity({"cpu": "2", "memory": "8Gi", "pods": 10}).obj())
    assert _bindings(ts.schedule_all_pending()) == {"low": "n1"}


def _aff_port(mkpod):
    # Pod affinity, topology spread and a host port: all ported.
    return (mkpod("aff").req({"cpu": "1"}).label("app", "a").pod_affinity_in("app", ["a"], "zone")
            .spread_constraint(1, "zone", "DoNotSchedule", "app", ["a"]).host_port(9090).obj())


def _sel_claim(mkpod):
    # A node selector and a resource claim (missing here: the pod waits).
    return mkpod("sel").req({"cpu": "1"}).node_selector({"disk": "ssd"}).resource_claim("gpu").obj()


def _port(mkpod):
    return mkpod("port").req({"cpu": "1"}).host_port(8080).obj()


@pytest.mark.parametrize("build,ported", [(_aff_port, True), (_sel_claim, True), (_port, True)],
                         ids=["pod-affinity", "node-selector", "host-port"])
def test_unported_constraints_raise(build, ported):
    """A constraint the port does not have raises by name; the cases that
    are now ported (all three) schedule as the JAX scheduler does."""
    ts = TorchScheduler(TDEF, batch_size=4, device="cpu")
    ts.add_node(tnode("n0").capacity({"cpu": "4", "memory": "8Gi"}).label("zone", "z0").obj())
    ts.add_pod(build(tpod))
    if not ported:
        with pytest.raises(NotImplementedError, match="DynamicResources"):
            ts.schedule_batch()
        return
    js = TPUScheduler(profile=registered_subset(JDEF), batch_size=4)
    js.add_node(jnode("n0").capacity({"cpu": "4", "memory": "8Gi"}).label("zone", "z0").obj())
    js.add_pod(build(jpod))
    key = lambda outs: [(o.pod.name, o.node_name, o.score, o.feasible_nodes) for o in outs]  # noqa: E731
    got = ts.schedule_all_pending()
    assert key(got) == key(js.schedule_all_pending())
    if build is _sel_claim:  # no ssd node and a missing claim: unschedulable
        assert got[0].node_name is None and got[0].unschedulable_plugins == {"NodeAffinity"}
    else:
        assert got[0].node_name == "n0" and int(ts.builder.host["port_counts"].sum()) == 1
    assert ts.builder.host_mirror_equal()


def test_possible_preemption_raises():
    """Formerly a refusal: the what-if search of InterPodAffinity (active
    through the preemptor's anti-affinity) is ported, so the default
    profile's preemption evicts the victim and nominates the node, as
    TPUScheduler does."""
    outs = []
    for s, mn, mp in ((TPUScheduler(profile=registered_subset(JDEF), batch_size=4), jnode, jpod),
                      (TorchScheduler(TDEF, batch_size=4, device="cpu"), tnode, tpod)):
        s.add_node(mn("n0").capacity({"cpu": "2", "memory": "8Gi"}).obj())
        s.add_pod(mp("victim").req({"cpu": "2"}).node("n0").obj())
        s.add_pod(mp("vip").req({"cpu": "2"}).priority(100)
                  .pod_anti_affinity_in("app", ["z"], "topology.kubernetes.io/zone").obj())
        out = s.schedule_batch()
        outs.append([(o.pod.name, o.node_name, o.nominated_node, o.victim_uids) for o in out])
        assert "default/victim" not in s.cache.pods
    assert outs[1] == outs[0] == [("vip", None, "n0", ("default/victim",))]
    assert s.builder.host_mirror_equal()


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        assert TorchScheduler(TDEF).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchScheduler(TDEF)
    assert TorchScheduler(TDEF, device="cpu").device.type == "cpu"
    # A plugin with no op in the port (the Go-side TPUBatchScore, which the
    # sidecar serves) is refused; ThroughputAware is ported.
    with pytest.raises(NotImplementedError):
        TorchScheduler(TProfile(scorers=(("TPUBatchScore", 1),)), device="cpu")
    TorchScheduler(TProfile(scorers=(("ThroughputAware", 1),)), device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, kubernetes_tpu_torch, kubernetes_tpu_torch.scheduler, "
        "kubernetes_tpu_torch.workloads, kubernetes_tpu_torch.kernels.build, "
        "kubernetes_tpu_torch.engine.packing, kubernetes_tpu_torch.ops.interpodaffinity, "
        "kubernetes_tpu_torch.ops.podtopologyspread, kubernetes_tpu_torch.ops.nodeaffinity, "
        "kubernetes_tpu_torch.ops.tainttoleration, kubernetes_tpu_torch.framework.features, "
        "kubernetes_tpu_torch.intern, kubernetes_tpu_torch.volumes, kubernetes_tpu_torch.ops.volumes, "
        "kubernetes_tpu_torch.framework.hostplugins, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kubernetes_tpu' or m.startswith('kubernetes_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
