"""Cuts of the two preemption workloads on ``TorchScheduler(device="cpu")``
against ``TPUScheduler``: ``preemption_500n`` (harness.py:578-618) at 24
nodes, 96 background pods and 24 preemptors, batch 32, chunk 8; and
``preemption_async_5kn`` (harness.py:942-977) at 40 nodes, 160 background
pods and 32 preemptors, batch 64, chunk 16.  Driven as the harness drives
them (drain the background, then a warm-up preemptor, then the measured
wave), on injected queue clocks stepped through each backoff.  The
outcomes in pop order, the victims, the nominations and the final host
mirror must be equal; every preemptor binds on a node within its
allocatable, and every victim has priority 1."""

import numpy as np
import pytest

from kubernetes_tpu.benchmarks import harness
from kubernetes_tpu.framework.config import fit_only_profile as jfit
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch import workloads as tw
from kubernetes_tpu_torch.framework.config import fit_only_profile as tfit
from kubernetes_tpu_torch.queue import SchedulingQueue as TQueue
from kubernetes_tpu_torch.scheduler import TorchScheduler
from tests.test_torch_preemption import FakeClock, drive, summary

CUTS = {
    # name: (nodes, background pods, background cpu, memory, preemptors, batch, chunk)
    "preemption_500n": (24, 96, "1", "2Gi", 24, 32, 8),
    "preemption_async_5kn": (40, 160, "3900m", "15Gi", 32, 64, 16),
}


def _run_jax(nodes, bg, cpu, mem, vips, batch, chunk):
    clock = FakeClock()
    s = TPUScheduler(profile=jfit(), batch_size=batch, chunk_size=chunk)
    s.queue._clock = clock
    harness._basic_nodes(nodes, cpu="4", mem="16Gi")(s)
    for i in range(bg):
        s.add_pod(harness.make_pod(f"bg-{i}").req({"cpu": cpu, "memory": mem}).priority(1)
                  .start_time(float(i)).obj())
    out = drive(s, clock)
    s.add_pod(harness.make_pod("warm-vip").req({"cpu": "2", "memory": "4Gi"}).priority(1000).obj())
    out += drive(s, clock)
    for i in range(vips):
        s.add_pod(harness.make_pod(f"vip-{i}").req({"cpu": "2", "memory": "4Gi"}).priority(1000).obj())
    return s, out, drive(s, clock)


def _run_torch(nodes, bg, cpu, mem, vips, batch, chunk):
    clock = FakeClock()
    queue = TQueue(backoff=True, clock=clock)
    s = TorchScheduler(tfit(), batch_size=batch, chunk_size=chunk, device="cpu", queue=queue)
    for n in tw.preemption_nodes(nodes):
        s.add_node(n)
    for p in tw.preemption_background(bg, cpu, mem):
        s.add_pod(p)
    out = drive(s, clock)
    s.add_pod(tw.preemptor("warm-vip"))
    out += drive(s, clock)
    for i in range(vips):
        s.add_pod(tw.preemptor(f"vip-{i}"))
    return s, out, drive(s, clock)


@pytest.mark.parametrize("name", sorted(CUTS))
def test_preemption_workload_cut_matches_jax(name):
    j, jwarm, jmeas = _run_jax(*CUTS[name])
    t, twarm, tmeas = _run_torch(*CUTS[name])
    assert summary(twarm) == summary(jwarm)
    assert summary(tmeas) == summary(jmeas)
    assert sorted(t.cache.pods) == sorted(j.cache.pods)
    assert {u: n for u, (n, _d, _p) in t.nominator.items()} == {u: n for u, (n, _d, _p) in j.nominator.items()}
    for key, arr in j.builder.host.items():
        if key == "topo_vals":
            # The JAX builder interns the well-known topology keys up front;
            # the port interns only the keys its pods' terms name.
            continue
        np.testing.assert_array_equal(t.builder.host[key], arr, err_msg=key)
    assert t.builder.host_mirror_equal()
    # The workload's own gates.
    vips = CUTS[name][4]
    bound = {o.pod.name: o.node_name for o in tmeas if o.node_name}
    assert all(bound.get(f"vip-{i}") for i in range(vips))
    victims = [uid for o in tmeas + twarm for uid in o.victim_uids]
    assert victims and all(uid.startswith("default/bg-") for uid in victims)
    h = t.builder.host
    assert (h["req"] <= h["alloc"]).all() and (h["num_pods"] <= h["allowed_pods"]).all()
    assert t.preemptions == j.metrics.preemptions


def _mixed_waves(s, mn, mp, T, clock, seed):
    """A random cluster filled by the scheduler, an optional PDB, then
    three waves of preemptors of mixed or uniform signatures."""
    rng = np.random.default_rng(seed)
    for i in range(10):
        s.add_node(mn(f"n{i}").capacity({"cpu": str(int(rng.choice([2, 4, 8]))), "memory": "16Gi",
                                         "pods": int(rng.choice([4, 110]))}).obj())
    for j in range(40):
        s.add_pod(mp(f"b{j}").req({"cpu": f"{int(rng.choice([500, 1000, 2000]))}m", "memory": "1Gi"})
                  .priority(int(rng.integers(0, 20))).label("app", "db" if j % 4 == 0 else "x")
                  .start_time(float(rng.integers(0, 9))).obj())
    out = drive(s, clock)
    if seed % 2:
        s.add_pdb(T.PodDisruptionBudget(name="db", selector=T.LabelSelector(match_labels=(("app", "db"),)),
                                        disruptions_allowed=int(rng.integers(0, 3))))
    for wave in range(3):
        uniform = rng.integers(0, 2)
        for j in range(int(rng.integers(3, 20))):
            cpu = 2000 if uniform else int(rng.choice([1000, 2000, 3000]))
            prio = 100 if uniform else int(rng.choice([5, 50, 100]))
            s.add_pod(mp(f"w{wave}-{j}").req({"cpu": f"{cpu}m", "memory": "2Gi"}).priority(prio).obj())
        if rng.integers(0, 2):
            s.preemption.expect_failures = True  # speculate on the next batch
        out += drive(s, clock)
    return out


@pytest.mark.parametrize("seed,batch,chunk", [(13, 8, 1), (13, 8, 4), (16, 16, 2), (16, 16, 16)])
def test_randomized_preemption_waves_match_jax(seed, batch, chunk):
    """Randomized clusters and preemptor waves: chunk 1 (nominate and
    retry, pinned batches), chunk 4 and 2 (speculative dry-runs, inline
    commits, nominations after a failed re-check), chunk 16 (rank splits
    over whole batches)."""
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.wrappers import make_node as jnode
    from kubernetes_tpu.api.wrappers import make_pod as jpod
    from kubernetes_tpu_torch.api import types as tt
    from kubernetes_tpu_torch.api.wrappers import make_node as tnode
    from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
    from tests.test_torch_preemption import assert_same, make_pair

    (j, jc), (t, tc) = make_pair(batch_size=batch, chunk_size=chunk)
    jout = _mixed_waves(j, jnode, jpod, jt, jc, seed)
    tout = _mixed_waves(t, tnode, tpod, tt, tc, seed)
    assert_same(j, t, jout, tout)
    assert t.preemptions == j.metrics.preemptions > 0
    assert t.pinned_batches == j.metrics.pinned_batches
