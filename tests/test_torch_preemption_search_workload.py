"""A cut of ``preemption_default_search_5kn`` on the port against
``TPUScheduler``.

40 nodes in 4 zones, 160 background pods (host-port holders, tier=noisy
pods, pods whose anti-affinity names app=svc), a warm-up preemptor, then 32
service preemptors with a zone spread, an anti-affinity to tier=noisy and
the host port; default profile, batch 32, chunk 8, nominate-and-retry.
Both schedulers run on injected clocks stepped to each backoff expiry.
Nominations, victims and bindings in pop order must be equal, also when the
measured batch's dry-run is chained speculatively on its main pass.
Tolerance: exact."""

import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu_torch import workloads as w
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from tests.test_torch_preemption import assert_same, drive, make_pair

NODES, ZONES, BG, MEASURED = 40, 4, 160, 32


def background(mp, count):
    """workloads.search_background, built with the given package's wrappers."""
    out = []
    for i in range(count):
        p = mp(f"bg-{i}").req({"cpu": "1", "memory": "3Gi"}).priority(1).start_time(float(i)).label("app", "batch")
        if i % 8 == 0:
            p = p.host_port(w.SEARCH_PORT)
        elif (i // 8) % 8 == 0:
            p = p.label("tier", "noisy")
        if i % 16 == 2:
            p = p.pod_anti_affinity_in("app", ["svc"], w.HOSTNAME)
        out.append(p.obj())
    return [p for p in out if p.host_ports()] + [p for p in out if not p.host_ports()]


def preemptor(mp, T, name):
    """workloads.search_preemptor, built with the given package's wrappers."""
    return (mp(name).req({"cpu": "2", "memory": "4Gi"}).priority(1000).label("app", "svc")
            .spread_constraint(1, w.ZONE, T.DO_NOT_SCHEDULE, "app", ["svc"])
            .pod_anti_affinity_in("tier", ["noisy"], w.HOSTNAME).host_port(w.SEARCH_PORT).obj())


def test_cut_pods_are_the_paths():
    """The cut's pods and nodes are the path's (workloads.py) at cut size."""
    assert [repr(p) for p in background(tpod, 64)] == [repr(p) for p in w.search_background(64)]
    assert repr(preemptor(tpod, tt, "vip-0")) == repr(w.search_preemptor("vip-0"))
    nodes = w.search_nodes(NODES, ZONES)
    assert [n.metadata.labels[w.ZONE] for n in nodes[:5]] == ["zone-0", "zone-1", "zone-2", "zone-3", "zone-0"]


def run_cut(speculative: bool, inline: bool):
    (j, jc), (t, tc) = make_pair(batch_size=32, chunk_size=8, profile="default", inline_preempt_commit=inline)
    outs = []
    for s, c, mn, mp, T in ((j, jc, jnode, jpod, jt), (t, tc, tnode, tpod, tt)):
        for i in range(NODES):
            s.add_node(mn(f"node-{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 110})
                       .zone(f"zone-{i % ZONES}").region("region-1").obj())
        for p in background(mp, BG):
            s.add_pod(p)
        got = drive(s, c)
        s.add_pod(preemptor(mp, T, "warm-vip"))
        got += drive(s, c)
        for i in range(MEASURED):
            s.add_pod(preemptor(mp, T, f"vip-{i}"))
        if speculative:
            s.preemption.expect_failures = True
            got += s.schedule_batch()
        outs.append(got + drive(s, c))
    assert_same(j, t, *outs)
    return j, t, outs


def zone_counts(s) -> dict:
    zones: dict = {}
    for pr in s.cache.pods.values():
        if pr.pod.metadata.labels.get("app") == "svc":
            zone = s.cache.nodes[pr.node_name].node.metadata.labels[w.ZONE]
            zones[zone] = zones.get(zone, 0) + 1
    return zones


@pytest.mark.parametrize("speculative", [False, True])
def test_search_workload_cut_matches_tpu_scheduler(speculative):
    j, t, outs = run_cut(speculative, inline=False)
    tout = outs[1]
    bound = {o.pod.name: o.node_name for o in tout if o.node_name}
    assert sum(1 for name in bound if name.startswith("vip-")) >= MEASURED // 2
    assert t.preemptions == j.metrics.preemptions > MEASURED // 2
    if speculative:
        assert t.speculative_batches >= 1
    # Every eviction took a priority-1 background pod; the zone spread
    # holds, since every preemptor re-ran its filters on its retry.
    assert all(v.startswith("default/bg-") for v, _p, _n in t.preempted)
    zones = zone_counts(t)
    assert zones == zone_counts(j) and max(zones.values()) - min(zones.values()) <= 1


def test_inline_commit_breaks_the_zone_spread_as_the_reference_does():
    """With the inline preemptor commit (the default at chunk > 1), one
    dry-run's same-signature mates commit on its 1st, 2nd, ... best nodes
    without re-running their spread filter, so the service's zone counts
    drift past maxSkew 1 on TPUScheduler and identically on the port
    (ROADMAP §3); every preemptor binds."""
    j, t, outs = run_cut(False, inline=True)
    zones = zone_counts(t)
    assert zones == zone_counts(j)
    assert max(zones.values()) - min(zones.values()) > 1
    bound = {o.pod.name for o in outs[1] if o.node_name}
    assert {f"vip-{i}" for i in range(MEASURED)} <= bound
