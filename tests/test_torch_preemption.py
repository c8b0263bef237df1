"""Closed-form batched preemption in the port against the JAX package.

The dry-run pass (plain versions on the CPU) against JAX
``build_preempt_pass(...).run`` from the same seeded cluster and victim
pack, at chunk 1, in the rank split at chunk = K and in a mixed-signature
chunk that defers; the victim pack, ``unpack_victims``, ``scatter_rows`` and
``expand_rows`` against their JAX counterparts; the closed-form scenarios of
tests/test_preemption.py on ``TorchScheduler(device="cpu")`` and
``TPUScheduler`` side by side (same outcomes, victims, nominations and
surviving pods), and its what-if search scenarios (a host-port holder, a
device holder beside a bystander, a CSI attach slot, an anti-affinity
victim) the same way.  Both
queues run on an injected clock that the drive steps to the next backoff
expiry, so no test sleeps.  Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu import preemption as jpre
from kubernetes_tpu import scheduler as jsched
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.framework.config import fit_only_profile as jfit
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import _scatter_rows as jax_scatter_rows
from kubernetes_tpu_torch import preemption as tpre
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.framework.config import fit_only_profile as tfit
from kubernetes_tpu_torch.kernels import Victims, plain
from kubernetes_tpu_torch.queue import SchedulingQueue as TQueue
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import state_from_numpy

JPROF = registered_subset(JDEF)


class FakeClock:
    """An injected queue clock: time moves only when the drive steps it."""

    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def make_pair(batch_size=8, chunk_size=1, profile="fit", **kw):
    """A (TPUScheduler, TorchScheduler) pair on their own fake clocks with
    the reference's 1 s doubling backoff."""
    jp, tp = {"fit": (jfit(), tfit()), "default": (JPROF, TDEF)}.get(profile, profile)
    jc, tc = FakeClock(), FakeClock()
    js = TPUScheduler(profile=jp, batch_size=batch_size, chunk_size=chunk_size, **kw)
    js.queue._clock = jc  # TPUScheduler(queue=q) keeps q only when q is non-empty
    ts = TorchScheduler(tp, batch_size=batch_size, chunk_size=chunk_size, device="cpu",
                        queue=TQueue(backoff=True, clock=tc), **kw)
    return (js, jc), (ts, tc)


def drive(s, clock, max_steps=50):
    """schedule_all_pending, stepping the clock to each backoff expiry."""
    out = []
    for _ in range(max_steps):
        out += s.schedule_all_pending()
        expiry = s.queue.next_backoff_expiry()
        if expiry is None:
            break
        clock.now = max(clock.now, expiry)
    return out


def summary(out):
    return [
        (o.pod.name, o.node_name, getattr(o, "nominated_node", None), o.victims,
         tuple(getattr(o, "victim_uids", ())))
        for o in out
    ]


def assert_same(j, t, jout, tout):
    assert summary(tout) == summary(jout)
    assert sorted(t.cache.pods) == sorted(j.cache.pods)
    assert {u: n for u, (n, _d, _p) in t.nominator.items()} == {u: n for u, (n, _d, _p) in j.nominator.items()}
    assert {k: p.disruptions_allowed for k, p in t.pdbs.items()} == {
        k: p.disruptions_allowed for k, p in j.pdbs.items()
    }
    assert t.builder.host_mirror_equal()


# -- the scenarios of tests/test_preemption.py (closed form) --------------------


def sc_preempts_lower(s, mn, mp, T):  # :15
    s.add_node(mn("n1").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_pod(mp("victim").req({"cpu": "2"}).priority(1).node("n1").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_equal_priority(s, mn, mp, T):  # :28
    s.add_node(mn("n1").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_pod(mp("incumbent").req({"cpu": "2"}).priority(100).node("n1").obj())
    s.add_pod(mp("peer").req({"cpu": "2"}).priority(100).obj())


def sc_policy_never(s, mn, mp, T):  # :38
    s.add_node(mn("n1").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_pod(mp("victim").req({"cpu": "2"}).priority(1).node("n1").obj())
    s.add_pod(mp("meek").req({"cpu": "2"}).priority(100).preemption_policy(T.PREEMPT_NEVER).obj())


def sc_minimal_victims(s, mn, mp, T):  # :51
    s.add_node(mn("n1").capacity({"cpu": "4", "pods": 110}).obj())
    s.add_pod(mp("v-lo").req({"cpu": "2"}).priority(1).node("n1").obj())
    s.add_pod(mp("v-hi").req({"cpu": "2"}).priority(50).node("n1").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_lowest_max_priority(s, mn, mp, T):  # :64
    s.add_node(mn("cheap").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_node(mn("dear").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_pod(mp("low").req({"cpu": "2"}).priority(5).node("cheap").obj())
    s.add_pod(mp("high").req({"cpu": "2"}).priority(50).node("dear").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_fewest_victims(s, mn, mp, T):  # :77
    s.add_node(mn("many").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_node(mn("one").capacity({"cpu": "2", "pods": 110}).obj())
    for i in range(2):
        s.add_pod(mp(f"m{i}").req({"cpu": "1"}).priority(5).node("many").obj())
    s.add_pod(mp("solo").req({"cpu": "2"}).priority(5).node("one").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_unresolvable_node_affinity(s, mn, mp, T):  # :91 (NodeAffinity as an invariant filter)
    s.add_node(mn("wrong").capacity({"cpu": "4", "pods": 110}).obj())
    s.add_node(mn("right").capacity({"cpu": "2", "pods": 110}).label("disk", "ssd").obj())
    s.add_pod(mp("v1").req({"cpu": "2"}).priority(1).node("right").obj())
    s.add_pod(mp("v2").req({"cpu": "4"}).priority(1).node("wrong").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).node_affinity_in("disk", ["ssd"]).obj())


def sc_randomized(s, mn, mp, T):  # :114
    rng = np.random.default_rng(31)
    for i in range(10):
        cpu = int(rng.integers(2, 8))
        s.add_node(mn(f"n{i}").capacity({"cpu": cpu, "pods": 110}).obj())
        free = cpu * 1000
        uid = i * 100
        while free >= 1000 and rng.integers(0, 4):
            c = int(rng.integers(1, max(free // 1000, 2))) * 1000
            s.add_pod(mp(f"bg{uid}").req({"cpu": f"{c}m"}).priority(int(rng.integers(1, 50)))
                      .start_time(float(uid)).node(f"n{i}").obj())
            free -= c
            uid += 1
    s.add_pod(mp("vip").req({"cpu": "2000m"}).priority(100).obj())


def sc_latest_start(s, mn, mp, T):  # :176
    s.add_node(mn("a").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_node(mn("b").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_pod(mp("a5").req({"cpu": "1"}).priority(5).start_time(10.0).node("a").obj())
    s.add_pod(mp("a1").req({"cpu": "1"}).priority(1).start_time(1.0).node("a").obj())
    s.add_pod(mp("b5").req({"cpu": "1"}).priority(5).start_time(5.0).node("b").obj())
    s.add_pod(mp("b1").req({"cpu": "1"}).priority(1).start_time(2.0).node("b").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_pdb_decides(s, mn, mp, T):  # :196
    s.add_node(mn("n1").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_node(mn("n2").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_pod(mp("protected").req({"cpu": "2"}).priority(5).label("app", "db").start_time(10.0).node("n1").obj())
    s.add_pod(mp("plain").req({"cpu": "2"}).priority(5).start_time(10.0).node("n2").obj())
    s.add_pdb(T.PodDisruptionBudget(
        name="db-pdb", selector=T.LabelSelector(match_labels=(("app", "db"),)), disruptions_allowed=0))
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_pdb_consumed(s, mn, mp, T):  # :226
    for i in (1, 2):
        s.add_node(mn(f"n{i}").capacity({"cpu": "2", "pods": 110}).obj())
        s.add_pod(mp(f"db-{i}").req({"cpu": "2"}).priority(5).label("app", "db").node(f"n{i}").obj())
    s.add_pdb(T.PodDisruptionBudget(
        name="db-pdb", selector=T.LabelSelector(match_labels=(("app", "db"),)), disruptions_allowed=1))
    s.add_pod(mp("vip-1").req({"cpu": "2"}).priority(100).obj())


def sc_nominated_not_stolen(s, mn, mp, T):  # :274 (the sneak arrives after the first batch)
    s.add_node(mn("n1").capacity({"cpu": "2", "pods": 110}).obj())
    s.add_pod(mp("victim").req({"cpu": "2"}).priority(1).node("n1").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_greedy_reprieve(s, mn, mp, T):  # :294
    s.add_node(mn("n1").capacity({"cpu": "4", "memory": "16Gi", "pods": 110}).obj())
    s.add_pod(mp("a").req({"cpu": "2"}).priority(1).node("n1").obj())
    s.add_pod(mp("b").req({"memory": "8Gi"}).priority(2).node("n1").obj())
    s.add_pod(mp("c").req({"cpu": "2"}).priority(3).node("n1").obj())
    s.add_pod(mp("vip").req({"cpu": "4"}).priority(100).obj())


def sc_reprieve_pdb_first(s, mn, mp, T):  # :320
    s.add_node(mn("n1").capacity({"cpu": "4", "pods": 110}).obj())
    s.add_pdb(T.PodDisruptionBudget(
        name="guard", namespace="default",
        selector=T.LabelSelector(match_labels=(("app", "guarded"),)), disruptions_allowed=0))
    s.add_pod(mp("covered").req({"cpu": "2"}).priority(1).label("app", "guarded").start_time(1.0).node("n1").obj())
    s.add_pod(mp("plain").req({"cpu": "2"}).priority(1).start_time(2.0).node("n1").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


def sc_pdb_simulation(s, mn, mp, T):  # :351
    s.add_node(mn("n1").capacity({"cpu": "4", "pods": 110}).obj())
    s.add_pdb(T.PodDisruptionBudget(
        name="one-left", namespace="default",
        selector=T.LabelSelector(match_labels=(("app", "db"),)), disruptions_allowed=1))
    s.add_pod(mp("x").req({"cpu": "2"}).priority(1).label("app", "db").start_time(1.0).node("n1").obj())
    s.add_pod(mp("y").req({"cpu": "2"}).priority(1).label("app", "db").start_time(2.0).node("n1").obj())
    s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())


SCENARIOS = {
    "preempts_lower_priority_pod": sc_preempts_lower,
    "no_preemption_of_equal_priority": sc_equal_priority,
    "preemption_policy_never": sc_policy_never,
    "minimal_victim_set": sc_minimal_victims,
    "lowest_max_victim_priority": sc_lowest_max_priority,
    "fewest_victims_tiebreak": sc_fewest_victims,
    "unresolvable_nodes_excluded": sc_unresolvable_node_affinity,
    "randomized_resource_only": sc_randomized,
    "latest_start_tiebreak": sc_latest_start,
    "pdb_violations_decide_winner": sc_pdb_decides,
    "pdb_budget_consumed": sc_pdb_consumed,
    "greedy_reprieve_keeps_mid_priority": sc_greedy_reprieve,
    "reprieve_prefers_pdb_covered": sc_reprieve_pdb_first,
    "pdb_budget_simulation": sc_pdb_simulation,
}


def _profiles(name):
    if name == "unresolvable_nodes_excluded":
        kw = dict(filters=("NodeResourcesFit", "NodeAffinity"), scorers=(("NodeResourcesFit", 1),))
        return JProfile(name="na-fit", **kw), TProfile(name="na-fit", **kw)
    return "fit"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    (j, jc), (t, tc) = make_pair(batch_size=16 if name == "randomized_resource_only" else 8,
                                 profile=_profiles(name))
    SCENARIOS[name](j, jnode, jpod, jt)
    SCENARIOS[name](t, tnode, tpod, tt)
    jout, tout = drive(j, jc), drive(t, tc)
    assert_same(j, t, jout, tout)


def test_nominated_node_not_stolen_by_next_batch():  # :274
    (j, jc), (t, tc) = make_pair(batch_size=4)
    outs = []
    for s, c, mn, mp, T in ((j, jc, jnode, jpod, jt), (t, tc, tnode, tpod, tt)):
        sc_nominated_not_stolen(s, mn, mp, T)
        first = s.schedule_batch()
        assert first[0].nominated_node == "n1" and "default/vip" in s.nominator
        s.add_pod(mp("sneak").req({"cpu": "2"}).priority(1).obj())
        outs.append(first + drive(s, c))
    assert_same(j, t, outs[0], outs[1])
    landed = {o.pod.name: o.node_name for o in outs[1] if o.node_name}
    assert landed.get("vip") == "n1" and "sneak" not in landed


def test_inline_commit_spends_stale_nomination():  # :385
    (j, jc), (t, tc) = make_pair(batch_size=4, chunk_size=2, profile="default")
    outs = []
    for s, c, mn, mp in ((j, jc, jnode, jpod), (t, tc, tnode, tpod)):
        assert s.inline_preempt_commit
        s.add_node(mn("n0").capacity({"cpu": "4", "pods": 110}).obj())
        s.add_pod(mp("bg").req({"cpu": "4"}).priority(1).obj())
        got = drive(s, c)
        vip = mp("vip").req({"cpu": "2"}).priority(100).obj()
        s.nominator[vip.uid] = ("n0", {"req": np.zeros(4, "int64")}, 100)
        s.add_pod(vip)
        outs.append(got + drive(s, c))
        assert vip.uid not in s.nominator and vip.spec.node_name == "n0"
    assert_same(j, t, *outs)


def test_preemption_with_more_pdbs_than_nodes():  # :403
    (j, jc), (t, tc) = make_pair(batch_size=4, profile="default")
    outs = []
    for s, c, mn, mp, T in ((j, jc, jnode, jpod, jt), (t, tc, tnode, tpod, tt)):
        s.add_node(mn("n1").capacity({"cpu": "2", "memory": "4Gi", "pods": 10}).obj())
        for i in range(20):
            s.add_pdb(T.PodDisruptionBudget(
                name=f"pdb-{i}", namespace="default",
                selector=T.LabelSelector(match_labels=(("app", f"a{i}"),)), disruptions_allowed=1))
        s.add_pod(mp("low").req({"cpu": "2"}).priority(1).label("app", "a0").obj())
        got = drive(s, c)
        vip = mp("vip").req({"cpu": "2"}).priority(100).obj()
        s.add_pod(vip)
        outs.append(got + drive(s, c))
        assert vip.spec.node_name == "n1"
    assert t.preemptions == j.metrics.preemptions == 1
    assert_same(j, t, *outs)


def test_speculative_chained_preemption_mixed_batch():  # :430
    (j, jc), (t, tc) = make_pair(batch_size=8, chunk_size=4)
    outs = []
    for s, c, mn, mp in ((j, jc, jnode, jpod), (t, tc, tnode, tpod)):
        for i in range(3):
            s.add_node(mn(f"n{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 20}).obj())
        for i in range(2):
            s.add_pod(mp(f"bg-{i}").req({"cpu": "3900m"}).priority(1).obj())
        got = drive(s, c)
        s.preemption.expect_failures = True  # speculate on the next batch
        s.add_pod(mp("fits").req({"cpu": "1"}).priority(100).obj())
        for i in range(2):
            s.add_pod(mp(f"vip-{i}").req({"cpu": "3"}).priority(100).obj())
        got += s.schedule_batch()
        outs.append(got + drive(s, c))
    assert t.speculative_batches >= 1
    assert t.preemptions == j.metrics.preemptions >= 1
    assert_same(j, t, *outs)


# -- the what-if search, side by side (formerly refused by name) ---------------


def _search_pair(filters, batch_size=8):
    kw = dict(filters=filters, scorers=(("NodeResourcesFit", 1),))
    return make_pair(batch_size=batch_size, profile=(JProfile(name="search", **kw), TProfile(name="search", **kw)))


def test_port_conflict_preemption_refused():  # :250, now ported: the port holder is evicted
    (j, jc), (t, tc) = _search_pair(("NodeUnschedulable", "NodeName", "NodePorts", "NodeResourcesFit"))
    for s, mn, mp in ((j, jnode, jpod), (t, tnode, tpod)):
        s.add_node(mn("n1").capacity({"cpu": "8", "pods": 110}).obj())
        s.add_pod(mp("holder").req({"cpu": "1"}).priority(1).host_port(8080).node("n1").obj())
        s.add_pod(mp("vip").req({"cpu": "1"}).priority(100).host_port(8080).obj())
    jout, tout = drive(j, jc), drive(t, tc)
    assert_same(j, t, jout, tout)
    assert [o.node_name for o in tout if o.pod.name == "vip"][-1] == "n1"
    assert "default/holder" not in t.cache.pods


def test_device_conflict_preemption_refused():  # :481, now ported: only the device holder goes
    (j, jc), (t, tc) = _search_pair(("NodeResourcesFit", "VolumeRestrictions"))
    for s, mn, mp in ((j, jnode, jpod), (t, tnode, tpod)):
        s.add_node(mn("n1").capacity({"cpu": "64", "pods": 110}).obj())
        s.add_pod(mp("holder").req({"cpu": "1"}).priority(1).device_volume("disk-1").node("n1").obj())
        s.add_pod(mp("bystander").req({"cpu": "1"}).priority(1).node("n1").obj())
        s.add_pod(mp("vip").req({"cpu": "1"}).priority(100).device_volume("disk-1").obj())
    jout, tout = drive(j, jc), drive(t, tc)
    assert_same(j, t, jout, tout)
    vip = [o for o in tout if o.pod.name == "vip" and (o.victims or o.node_name)]
    assert vip[0].victim_uids == ("default/holder",)
    assert "default/bystander" in t.cache.pods and "default/holder" not in t.cache.pods


def test_csi_attach_victim_minimal_set():  # :520: the single attach slot's holder goes, the bystander stays
    from kubernetes_tpu.api.wrappers import make_pvc as jpvc
    from kubernetes_tpu_torch.api.wrappers import make_pvc as tpvc

    (j, jc), (t, tc) = _search_pair(("NodeResourcesFit", "VolumeBinding", "NodeVolumeLimits"))
    outs = []
    for s, c, mn, mp, mpvc, T in ((j, jc, jnode, jpod, jpvc, jt), (t, tc, tnode, tpod, tpvc, tt)):
        s.add_node(mn("n1").capacity({"cpu": "64", "pods": 110}).obj())
        s.add_csinode(T.CSINode(name="n1", driver_limits={"ebs.csi.aws.com": 1}))
        s.add_storage_class(T.StorageClass(name="ebs", provisioner="ebs.csi.aws.com",
                                           binding_mode=T.BINDING_WAIT_FOR_FIRST_CONSUMER))
        for name in ("c-held", "c-new"):
            s.add_pvc(mpvc(name, storage_class="ebs"))
        s.add_pod(mp("holder").req({"cpu": "1"}).priority(1).pvc_volume("c-held").obj())
        got = drive(s, c)
        s.add_pod(mp("bystander").req({"cpu": "1"}).priority(1).node("n1").obj())
        s.add_pod(mp("vip").req({"cpu": "1"}).priority(100).pvc_volume("c-new").obj())
        outs.append(got + drive(s, c))
    assert_same(j, t, *outs)
    vip = [o for o in outs[1] if o.pod.name == "vip" and (o.victims or o.node_name)]
    assert vip[0].victim_uids == ("default/holder",)
    assert "default/bystander" in t.cache.pods


def test_closed_form_preemption_no_longer_raises():
    """The default profile's closed-form preemption, which the port refused
    before this slice: the victim goes, the preemptor is nominated and
    binds on the retry, as on TPUScheduler."""
    (j, jc), (t, tc) = make_pair(batch_size=4, profile="default")

    def scenario(s, mn, mp):
        s.add_node(mn("n0").capacity({"cpu": "2", "memory": "8Gi"}).obj())
        s.add_pod(mp("victim").req({"cpu": "2"}).node("n0").obj())
        s.add_pod(mp("vip").req({"cpu": "2"}).priority(100).obj())

    scenario(j, jnode, jpod)
    scenario(t, tnode, tpod)
    jout, tout = drive(j, jc), drive(t, tc)
    assert_same(j, t, jout, tout)
    assert [(o.pod.name, o.node_name) for o in tout] == [("vip", None), ("vip", "n0")]
    assert tout[0].nominated_node == "n0" and tout[0].victim_uids == ("default/victim",)
    assert "default/victim" not in t.cache.pods


def test_search_preemption_refused_before_any_victim():
    """Formerly refused by name; now the default profile's what-if search
    evicts the pod the preemptor's zone anti-affinity rejects, as
    TPUScheduler does, and leaves the other node, whose guard's
    anti-affinity names the preemptor and whose filler cannot go, alone;
    the nominated preemptor binds on the retry."""
    (j, jc), (t, tc) = make_pair(batch_size=4, profile="default")
    for s, mn, mp in ((j, jnode, jpod), (t, tnode, tpod)):
        s.add_node(mn("n0").capacity({"cpu": "4", "memory": "8Gi"}).zone("z0").obj())
        s.add_node(mn("n1").capacity({"cpu": "4", "memory": "8Gi"}).zone("z1").obj())
        s.add_pod(mp("victim").req({"cpu": "1"}).label("app", "x").node("n0").obj())
        s.add_pod(mp("guard").req({"cpu": "1"}).label("app", "w").pod_anti_affinity_in(
            "app", ["y"], "kubernetes.io/hostname").node("n1").obj())
        s.add_pod(mp("filler").req({"cpu": "3"}).priority(200).node("n1").obj())
        vip = mp("vip").req({"cpu": "2"}).priority(100).label("app", "y")
        s.add_pod(vip.pod_anti_affinity_in("app", ["x"], "topology.kubernetes.io/zone").obj())
    jout, tout = drive(j, jc), drive(t, tc)
    assert_same(j, t, jout, tout)
    assert [o.node_name for o in tout if o.pod.name == "vip"][-1] == "n0"
    assert "default/victim" not in t.cache.pods and "default/guard" in t.cache.pods


# -- the dry-run pass, kernel by kernel ----------------------------------------


def _cluster(s, mn, mp, T, seed, pdbs):
    """16 nodes with 0-7 bound pods each over random priorities, start
    times and an extended resource (R=4); two PDBs, one at budget 0."""
    rng = np.random.default_rng(seed)
    for i in range(16):
        s.add_node(mn(f"n{i}").capacity({"cpu": str(int(rng.choice([4, 8]))), "memory": "32Gi",
                                        "example.com/gpu": 4, "pods": 110}).obj())
    for i in range(16):
        for j in range(int(rng.integers(0, 8))):
            w = mp(f"b{i}-{j}").req({"cpu": f"{int(rng.choice([250, 500, 1000]))}m", "memory": "1Gi",
                                     "example.com/gpu": int(rng.integers(0, 2))})
            w = w.priority(int(rng.integers(1, 40))).start_time(float(rng.integers(0, 5)) + 0.25 * j)
            if rng.integers(0, 3) == 0:
                w = w.label("app", "db" if rng.integers(0, 2) else "web")
            s.add_pod(w.node(f"n{i}").obj())
    if pdbs:
        for name, allowed in (("db", 0), ("web", 2)):
            s.add_pdb(T.PodDisruptionBudget(
                name=name, selector=T.LabelSelector(match_labels=(("app", name),)),
                disruptions_allowed=allowed))


def _preemptors(mp, case, k):
    pods = []
    for i in range(k if case != "chunk1" else 6):
        if case == "mixed" and i % 3 == 1:
            w = mp(f"p{i}").req({"cpu": "3", "memory": "2Gi"}).priority(25)
        else:
            w = mp(f"p{i}").req({"cpu": "2", "memory": "4Gi", "example.com/gpu": 1}).priority(30)
        if case == "chunk1":
            w = mp(f"p{i}").req({"cpu": f"{1 + i % 3}", "memory": "2Gi"}).priority(10 + 7 * i)
        pods.append(w.obj())
    return pods


@pytest.mark.parametrize("case,chunk", [("chunk1", 1), ("ranksplit", 16), ("mixed", 8)])
def test_preempt_pass_matches_jax(case, chunk):
    (j, _jc), (t, _tc) = make_pair(batch_size=16)
    _cluster(j, jnode, jpod, jt, 7, pdbs=True)
    _cluster(t, tnode, tpod, tt, 7, pdbs=True)
    k = 16
    jpods, tpods = _preemptors(jpod, case, k), _preemptors(tpod, case, k)
    jb, _, jactive = jax_batch(jpods, j.builder, j.profile, k)
    tb, _, tactive = torch_batch(tpods, t.builder, t.profile, k)
    assert jactive == tactive
    jpack = j.preemption.pack_victims(j.profile, jactive)
    tpack = t.preemption.pack_victims(t.profile, tactive)
    for jk, tv in zip(("d_prio", "d_vic_req", "d_vic_nonzero", "d_vic_start", "d_pdb", "d_allowed"),
                      tpack["vic"]):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jpack[jk]), err_msg=jk)
    assert {r: [p.uid for p in v] for r, v in tpack["per_node"].items()} == {
        r: [p.uid for p in v] for r, v in jpack["per_node"].items()}
    sigs, _ = j.preemption._sig_ids(jpods, j.profile, k)
    valid = np.zeros(k, np.bool_)
    valid[: len(jpods)] = True
    jb["valid"], jb["sig"] = valid, sigs
    fn = jpre.build_preempt_pass(j.profile, j.builder.schema, j.builder.res_col, jactive, jpack["n_pdbs"], chunk)
    jstate = j.builder.state()
    jout, jfinal, jprio = fn(jstate, jb, j.builder.batch_invariants(), jpack["d_prio"], jpack["d_vic_req"],
                             jpack["d_vic_nonzero"], jpack["d_vic_start"], jpack["d_vfeat"], jpack["d_pdb"],
                             jpack["d_allowed"])
    tbatch = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tb.items()}
    tbatch["valid"], tbatch["sig"] = torch.from_numpy(valid), torch.from_numpy(sigs)
    state = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate.__dataclass_fields__}, "cpu")
    run = tpre.build_preempt_pass(t.profile, t.builder.schema, t.builder.res_col, tactive, chunk, _impl="plain")
    vic = Victims(*(torch.from_numpy(np.array(jpack[key])) for key in
                    ("d_prio", "d_vic_req", "d_vic_nonzero", "d_vic_start", "d_pdb", "d_allowed")))
    tout, carry, tprio = run(state, tbatch, vic)
    np.testing.assert_array_equal(tout.picks.numpy(), np.asarray(jout.picks))
    np.testing.assert_array_equal(tout.vic_mask.numpy(), np.asarray(jout.vic_mask))
    np.testing.assert_array_equal(tout.n_victims.numpy(), np.asarray(jout.n_victims))
    for tv, f in zip(carry, ("req", "nonzero_req", "num_pods")):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(getattr(jfinal, f)), err_msg=f)
    np.testing.assert_array_equal(tprio.numpy(), np.asarray(jprio))
    picks = np.asarray(jout.picks)
    assert (picks >= 0).any()
    if case == "mixed":
        assert (picks == -2).any()


@pytest.mark.parametrize("chunk", [1, 4])
def test_speculative_steps_skip_only_empty_chunks(chunk):
    """The speculative dry-run runs only the chunks holding an eligible pod
    (``steps``); its picks, victim masks, counts and carries equal the run
    over every chunk."""
    t = TorchScheduler(tfit(), batch_size=16, chunk_size=chunk, device="cpu")
    _cluster(t, tnode, tpod, tt, 7, pdbs=True)
    k = 16
    pods = _preemptors(tpod, "mixed", k)
    tb, _, active = torch_batch(pods, t.builder, t.profile, k)
    sigs, _ = t.preemption._sig_ids(pods, k)
    elig = np.zeros(k, np.bool_)
    elig[4:8] = True
    elig[13] = True
    spec_picks = np.where(np.arange(k) % 3 == 0, 2, -1).astype(np.int32)
    batch = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tb.items() if key != "valid"}
    batch.update(sig=torch.from_numpy(sigs), elig=torch.from_numpy(elig), spec_picks=torch.from_numpy(spec_picks))
    pack = t.preemption.pack_victims(t.profile, active)
    run = tpre.build_preempt_pass(t.profile, t.builder.schema, t.builder.res_col, active, chunk, _impl="plain")
    state = t.builder.state()
    steps = sorted({i // chunk for i in np.nonzero(elig)[0]})
    assert len(steps) < k // chunk
    every, carry_all, prio_all = run(state, batch, pack["vic"])
    some, carry_some, prio_some = run(state, batch, pack["vic"], steps)
    for a, b in zip((*every, *carry_all, prio_all), (*some, *carry_some, prio_some)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (every.picks.numpy() >= 0).any() and every.vic_mask.numpy().any()


def test_victims_from_numpy_carries_the_jax_stage():
    """The JAX evaluator's staged buffer (incremental path, no PDBs)
    unpacked by the port equals the JAX device arrays."""
    (j, _jc), _ = make_pair(batch_size=16)
    _cluster(j, jnode, jpod, jt, 11, pdbs=False)
    pods = _preemptors(jpod, "ranksplit", 16)
    _, _, active = jax_batch(pods, j.builder, j.profile, 16)
    pack = j.preemption.pack_victims(j.profile, active)
    st = j.preemption._stage
    layout = {"r": j.builder.schema.R, "n_pdbs": 1, "pdb_words": 1, "v": st["v"]}
    vic = tpre.victims_from_numpy(st["buf"], layout, "cpu")
    for tv, key in zip(vic, ("d_prio", "d_vic_req", "d_vic_nonzero", "d_vic_start", "d_pdb", "d_allowed")):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(pack[key]), err_msg=key)


@pytest.mark.parametrize("n_pdbs", [2, 70])
def test_unpack_victims_matches_jax(n_pdbs):
    rng = np.random.default_rng(n_pdbs)
    n, vu, v, r = 16, 4, 8, 4
    words = max(1, (n_pdbs + 63) // 64)
    buf = rng.integers(0, 1 << 40, size=(n, vu, 5 + r + words), dtype=np.int64)
    buf[..., 0] = rng.integers(-5, 100, size=(n, vu))
    buf[..., 3 + r] = rng.uniform(0, 1e4, size=(n, vu)).view(np.int64)
    buf[..., 4 + r : 4 + r + words] = rng.integers(-(2**63), 2**63 - 1, size=(n, vu, words), dtype=np.int64)
    inline = n_pdbs <= n
    want = jpre._unpack_victims(jnp.asarray(buf), (r, n_pdbs, words, (), v))
    got = plain.unpack_victims(torch.from_numpy(buf), r, n_pdbs, words, v, inline)
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if inline:
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))


def test_scatter_and_expand_rows_match_jax():
    rng = np.random.default_rng(3)
    buf = rng.integers(-99, 99, size=(16, 4, 9), dtype=np.int64)
    rows = np.array([3, 0, 11], np.int64)
    sub = rng.integers(-99, 99, size=(3, 4, 9), dtype=np.int64)
    want = jpre._scatter_buf_rows(jnp.asarray(buf), jnp.asarray(rows, jnp.int32), jnp.asarray(sub))
    got = torch.from_numpy(buf.copy())
    plain.scatter_rows(got, 0, torch.from_numpy(rows), torch.from_numpy(sub))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Both axes of the ClusterState flush.
    (j, _jc), (t, _tc) = make_pair()
    _cluster(j, jnode, jpod, jt, 5, pdbs=False)
    jstate = j.builder.state()
    fields = {f: np.asarray(getattr(jstate, f)) for f in jstate.__dataclass_fields__}
    tstate = state_from_numpy(fields, "cpu")
    from kubernetes_tpu.snapshot import _NODE_AXIS

    idx = np.array([2, 7], np.int64)
    up0 = {f: rng.integers(0, 3, size=a[idx].shape).astype(a.dtype) for f, a in fields.items() if _NODE_AXIS[f] == 0}
    up1 = {f: rng.integers(0, 3, size=a[:, idx].shape).astype(a.dtype) for f, a in fields.items() if _NODE_AXIS[f] == 1}
    jnew = jax_scatter_rows(jstate, jnp.asarray(idx), up0, up1)
    for f, ax in _NODE_AXIS.items():
        src = up0[f] if ax == 0 else up1[f]
        plain.scatter_rows(getattr(tstate, f), ax, torch.from_numpy(idx), torch.from_numpy(src))
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jnew, f)), err_msg=f)
    small = {"req": rng.integers(0, 9, size=(1, 4)), "group": np.array([5], np.int32)}
    want = jsched._expand_uniform(small, np.ones(8, bool), np.full(8, -1, np.int32), 8)
    for key, a in small.items():
        np.testing.assert_array_equal(plain.expand_rows(torch.from_numpy(a), 8).numpy(), np.asarray(want[key]))
