"""The port's InterPodAffinity (kubernetes_tpu_torch.ops.interpodaffinity)
against the JAX op, exactly.

Op level: the same seeded cluster and pods go through the JAX builder and
the port's; featurization must agree on every ``ipa_*`` feature, and the
port's plain ``filter_fn``/``score_fn`` over a chunk must equal the JAX op
vmapped over the same pods, on zone and hostname topology, nodes missing
the zone key, namespaces lists and namespaceSelectors, ± preferred
weights, existing pods' required (anti-)affinity and preferred terms, and
the lonely-pod rule.  Scheduler level: the scenarios of
tests/test_ops_interpodaffinity.py, each run by TorchScheduler on the CPU
and by TPUScheduler; bindings, feasible counts and scores must be equal.
Tolerance: none (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_dom as jax_build_dom
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import build_dom
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.ops import interpodaffinity as top
from kubernetes_tpu_torch.ops.common import PassContext
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import SnapshotBuilder, state_to_numpy

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
JPROF = registered_subset(JDEF)
APPS = ["web", "db", "cache"]
NAMESPACES = ["default", "team-a", "team-b"]


def _term(t, key, values, topo, namespaces=()):
    return t.PodAffinityTerm(
        label_selector=t.LabelSelector(
            match_expressions=(t.LabelSelectorRequirement(key, t.OP_IN, tuple(values)),)
        ),
        topology_key=topo,
        namespaces=tuple(namespaces),
    )


def _random_pod(w, t, rng, host_share: float):
    """A pod with 0-3 random (anti-)affinity terms of every kind."""
    for _ in range(int(rng.integers(0, 4))):
        kind = int(rng.integers(0, 7))
        target = APPS[int(rng.integers(3))]
        topo = HOST if rng.random() < host_share else ZONE
        weight = int(rng.integers(1, 101))
        if kind == 0:
            w = w.pod_affinity_in("app", [target], topo)
        elif kind == 1:
            w = w.pod_anti_affinity_in("app", [target], topo)
        elif kind == 2:
            w = w.preferred_pod_affinity_in("app", [target], topo, weight=weight)
        elif kind == 3:
            w = w.preferred_pod_affinity_in("app", [target], topo, weight=weight, anti=True)
        elif kind == 4:
            w = w.ns_selector_pod_affinity_in(
                "app", [target], topo, "team", ["a"], anti=bool(rng.integers(2)),
                preferred_weight=None if rng.integers(2) else weight,
            )
        elif kind == 5:
            ns = [NAMESPACES[int(i)] for i in rng.choice(3, 2, replace=False)]
            w = w._attach_pod_term(_term(t, "app", [target], topo, ns), bool(rng.integers(2)), None)
        else:
            app = w.obj().metadata.labels.get("app", target)
            w = w.pod_affinity_in("app", [app], topo)  # self-matching: the lonely-pod rule
    return w


def _cluster(mknode, mkpod, t, builder, cache, seed, host_share):
    rng = np.random.default_rng(seed)
    builder.set_namespace_labels("team-a", {"team": "a"})
    builder.set_namespace_labels("team-b", {"team": "b"})
    for i in range(24):
        w = mknode(f"n{i}").capacity({"cpu": "64", "memory": "64Gi", "pods": 110})
        if i % 11 != 5:  # two nodes lack the zone key
            w = w.zone(f"z{i % 4}")
        cache.add_node(w.obj())
    for j in range(60):
        w = mkpod(f"b{j}", NAMESPACES[int(rng.integers(3))]).req({"cpu": "100m"}).label(
            "app", APPS[int(rng.integers(3))])
        w = _random_pod(w, t, rng, host_share)
        cache.add_pod(w.node(f"n{int(rng.integers(24))}").obj())
    pods = []
    for k in range(24):
        w = mkpod(f"p{k}", NAMESPACES[int(rng.integers(3))]).req({"cpu": "100m"})
        if rng.random() < 0.8:
            w = w.label("app", APPS[int(rng.integers(3))])
        pods.append(_random_pod(w, t, rng, host_share).obj())
    return pods


def _featurized(seed, host_share, k=None):
    """Both builders over the same cluster, the pods featurized into a
    batch of ``k`` rows (default: the pod count); features, invariants,
    schema and state checked equal."""
    jb = JaxBuilder()
    jpods = _cluster(jnode, jpod, jt, jb, JaxCache(jb), seed, host_share)
    tb = SnapshotBuilder(device="cpu")
    tpods = _cluster(tnode, tpod, tt, tb, TorchCache(tb), seed, host_share)
    k = k or len(jpods)
    jbatch, _, jactive = jax_batch(jpods, jb, JPROF, k)
    tbatch, _, tactive = torch_batch(tpods, tb, TDEF, k)
    assert "InterPodAffinity" in jactive and jactive == tactive
    ipa_keys = sorted(key for key in tbatch if key.startswith("ipa_"))
    for key in ipa_keys:
        n = len(jpods)  # padding rows differ: JAX pads a uniform batch with its template
        np.testing.assert_array_equal(np.asarray(jbatch[key])[:n], tbatch[key][:n], err_msg=key)
    jinv = jb.batch_invariants()
    tinv = tb.batch_invariants()
    for key in ("et_slot", "et_host"):
        np.testing.assert_array_equal(jinv[key], tinv[key])
    assert dataclasses.asdict(jb.schema) == dataclasses.asdict(tb.schema)
    jstate = jb.state()
    tstate = tb.state()
    got = state_to_numpy(tstate)
    for name, want in got.items():
        np.testing.assert_array_equal(want, np.asarray(getattr(jstate, name)), err_msg=name)
    return jb, tb, jstate, jbatch, jinv, tstate, tbatch, ipa_keys


def _both(seed, host_share):
    jb, tb, jstate, jbatch, inv, tstate, tbatch, keys = _featurized(seed, host_share)
    dv = jb.schema.DV
    jdom = jax_build_dom(jstate, jnp.asarray(inv["et_slot"]), jnp.asarray(inv["et_host"]), dv)
    tdom = build_dom(tstate, torch.from_numpy(inv["et_slot"]), torch.from_numpy(inv["et_host"]), dv)
    jctx = jcommon.PassContext(profile=JPROF, schema=jb.schema, static={}, dom=jdom)
    tctx = PassContext(profile=TDEF, schema=tb.schema, static={}, dom=tdom)
    jpf = {key: jnp.asarray(jbatch[key]) for key in keys}
    tpf = {key: torch.from_numpy(np.ascontiguousarray(tbatch[key])) for key in keys}
    return jstate, jctx, jpf, tstate, tctx, tpf


@pytest.mark.parametrize("seed,host_share", [(1, 0.0), (2, 1.0), (3, 0.5), (4, 0.3)],
                         ids=["zone", "hostname", "mixed", "mixed-2"])
def test_plain_filter_and_score_match_jax(seed, host_share):
    jstate, jctx, jpf, tstate, tctx, tpf = _both(seed, host_share)
    jop = jcommon.get("InterPodAffinity")
    jok = jax.vmap(lambda p: jop.filter(jstate, p, jctx))(jpf)
    tok = top.filter_fn(tstate, tpf, tctx)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # Scores over the filter's feasible set and over a random one (the
    # normalization is over whatever set the pass hands the op).
    rng = np.random.default_rng(seed)
    valid = np.asarray(jstate.valid)
    for feas in (np.asarray(jok) & valid, (rng.random(np.asarray(jok).shape) < 0.6) & valid):
        js = jax.vmap(lambda p, f: jop.score(jstate, p, jctx, f))(jpf, jnp.asarray(feas))
        ts = top.score_fn(tstate, tpf, tctx, torch.from_numpy(feas))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rejected = (~np.asarray(jok) & valid).sum()
    assert 0 < rejected < np.asarray(jok).size  # the cases exercise the filter both ways


def test_lonely_pod_and_missing_keys():
    """The lonely-pod rule counts only key-bearing nodes, and a node
    without the term's key fails required affinity."""
    jstate, jctx, jpf, tstate, tctx, tpf = _both(5, 0.0)
    jok = np.asarray(jax.vmap(lambda p: jcommon.get("InterPodAffinity").filter(jstate, p, jctx))(jpf))
    tok = top.filter_fn(tstate, tpf, tctx).numpy()
    np.testing.assert_array_equal(tok, jok)
    ra = tpf["ipa_ra_valid"].any(dim=1).numpy()
    assert ra.any()
    no_zone = np.asarray(jstate.topo_vals)[:, int(jnp.asarray(tpf["ipa_ra_slot"])[ra][0, 0])] < 0
    assert no_zone.any()
    assert not tok[ra][:, no_zone & np.asarray(jstate.valid)].any()


@pytest.mark.parametrize("seed,host_share", [(1, 0.0), (2, 1.0), (3, 0.5)],
                         ids=["zone", "hostname", "mixed"])
def test_plain_build_dom_matches_jax(seed, host_share):
    """The plain domain-table build (the build_dom kernel's reference on the
    card) equals the JAX build_dom's group_dom and et_dom exactly."""
    _jstate, jctx, _jpf, _tstate, tctx, _tpf = _both(seed, host_share)
    for name in ("group_dom", "et_dom"):
        want = np.asarray(getattr(jctx.dom, name))
        np.testing.assert_array_equal(getattr(tctx.dom, name).numpy(), want, err_msg=name)
    assert float(tctx.dom.group_dom.sum()) > 0


def test_ipa_eval_shared_memory_cap_raises():
    """ipa_eval keeps its per-pod tables in shared memory; a schema whose
    tables would not fit is refused by name, not launched."""
    assert kernels.ipa_smem_bytes(2, 1, 2, 4, 16) < kernels.IPA_SMEM_CAP
    with pytest.raises(NotImplementedError, match="IPA_SMEM_CAP"):
        kernels.ipa_smem_bytes(8, 8, 8, 16, 2048)


# -- scheduler-level scenarios (tests/test_ops_interpodaffinity.py) ----------


def _ipa_profile(profile_cls, with_score=True):
    return profile_cls(
        name="ipa",
        filters=("NodeResourcesFit", "InterPodAffinity"),
        scorers=(("InterPodAffinity", 2),) if with_score else (),
    )


def _zones(s, mknode, per_zone=2, names=("a", "b", "c")):
    for z in names:
        for i in range(per_zone):
            s.add_node(mknode(f"n-{z}{i}").capacity({"cpu": "64", "pods": 110}).zone(z).obj())


def _required_affinity(s, mknode, mkpod, t):
    _zones(s, mknode)
    s.add_pod(mkpod("existing").req({"cpu": "1"}).label("app", "db").node("n-b0").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).pod_affinity_in("app", ["db"], ZONE).obj())


def _lonely_self_match(s, mknode, mkpod, t):
    _zones(s, mknode)
    s.add_pod(mkpod("p").req({"cpu": "1"}).label("app", "web").pod_affinity_in("app", ["web"], ZONE).obj())


def _lonely_without_self_match(s, mknode, mkpod, t):
    _zones(s, mknode)
    s.add_pod(mkpod("p").req({"cpu": "1"}).pod_affinity_in("app", ["db"], ZONE).obj())


def _required_anti(s, mknode, mkpod, t):
    _zones(s, mknode)
    s.add_pod(mkpod("existing").req({"cpu": "1"}).label("app", "db").node("n-a0").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).pod_anti_affinity_in("app", ["db"], ZONE).obj())


def _existing_anti_repels(s, mknode, mkpod, t):
    _zones(s, mknode)
    s.add_pod(mkpod("guard").req({"cpu": "1"}).pod_anti_affinity_in("app", ["web"], ZONE).node("n-c0").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).label("app", "web").obj())


def _within_batch_anti(s, mknode, mkpod, t):
    _zones(s, mknode, per_zone=1)
    for i in range(4):
        s.add_pod(mkpod(f"p{i}").req({"cpu": "1"}).label("app", "web")
                  .pod_anti_affinity_in("app", ["web"], ZONE).obj())


def _preferred_attracts(s, mknode, mkpod, t):
    _zones(s, mknode, per_zone=1)
    s.add_pod(mkpod("buddy").req({"cpu": "1"}).label("app", "db").node("n-b0").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).preferred_pod_affinity_in("app", ["db"], ZONE, weight=50).obj())


def _preferred_anti_repels(s, mknode, mkpod, t):
    _zones(s, mknode, per_zone=1, names=("a", "b"))
    s.add_pod(mkpod("noisy").req({"cpu": "1"}).label("app", "db").node("n-b0").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"})
              .preferred_pod_affinity_in("app", ["db"], ZONE, weight=50, anti=True).obj())


def _existing_preferred_scores(s, mknode, mkpod, t):
    _zones(s, mknode, per_zone=1, names=("a", "b"))
    s.add_pod(mkpod("magnet").req({"cpu": "1"})
              .preferred_pod_affinity_in("app", ["web"], ZONE, weight=80).node("n-a0").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).label("app", "web").obj())


def _randomized(s, mknode, mkpod, t):
    rng = np.random.default_rng(23)
    for i in range(12):
        s.add_node(mknode(f"n{i}").capacity({"cpu": "640", "pods": 200}).zone(f"z{i % 3}").obj())
    for i in range(40):
        w = mkpod(f"p{i}").req({"cpu": "100m"}).label("app", APPS[int(rng.integers(0, 3))])
        r = int(rng.integers(0, 5))
        target = APPS[int(rng.integers(0, 3))]
        topo = ZONE if rng.integers(0, 2) else HOST
        if r == 0:
            w = w.pod_affinity_in("app", [target], topo)
        elif r == 1:
            w = w.pod_anti_affinity_in("app", [target], topo)
        elif r == 2:
            w = w.preferred_pod_affinity_in("app", [target], topo, weight=int(rng.integers(1, 100)))
        elif r == 3:
            w = w.preferred_pod_affinity_in("app", [target], topo, weight=int(rng.integers(1, 100)), anti=True)
        s.add_pod(w.obj())


def _mirror_with_affinity(s, mknode, mkpod, t):
    _zones(s, mknode, per_zone=1)
    for i in range(9):
        w = mkpod(f"p{i}").req({"cpu": "100m"}).label("app", "web")
        if i % 3 == 0:
            w = w.pod_anti_affinity_in("app", ["web"], ZONE)
        s.add_pod(w.obj())


def _namespace_selector(s, mknode, mkpod, t):
    _zones(s, mknode)
    s.builder.set_namespace_labels("team-a", {"team": "a"})
    s.add_pod(mkpod("ea", "team-a").req({"cpu": "1"}).label("app", "db").node("n-a0").obj())
    s.add_pod(mkpod("eb", "team-b").req({"cpu": "1"}).label("app", "db").node("n-c1").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"})
              .ns_selector_pod_affinity_in("app", ["db"], ZONE, "team", ["a"]).obj())
    s.add_pod(mkpod("q").req({"cpu": "1"})
              .ns_selector_pod_affinity_in("app", ["db"], HOST, "team", ["a"], anti=True).obj())


SCENARIOS = {
    "required-affinity": (_required_affinity, False, 8),
    "lonely-self-match": (_lonely_self_match, False, 8),
    "lonely-without-self-match": (_lonely_without_self_match, False, 8),
    "required-anti-affinity": (_required_anti, False, 8),
    "existing-anti-repels": (_existing_anti_repels, False, 8),
    "within-batch-anti": (_within_batch_anti, False, 8),
    "preferred-attracts": (_preferred_attracts, True, 8),
    "preferred-anti-repels": (_preferred_anti_repels, True, 8),
    "existing-preferred-scores": (_existing_preferred_scores, True, 8),
    "randomized": (_randomized, True, 64),
    "mirror-with-affinity": (_mirror_with_affinity, True, 16),
    "namespace-selector": (_namespace_selector, True, 8),
}


def _outcomes(outcomes):
    return {o.pod.name: (o.node_name, o.feasible_nodes, o.score) for o in outcomes}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    build, score, batch = SCENARIOS[name]
    js = TPUScheduler(profile=_ipa_profile(JProfile, score), batch_size=batch)
    build(js, jnode, jpod, jt)
    jout = js.schedule_all_pending()
    ts = TorchScheduler(_ipa_profile(TProfile, score), batch_size=batch, device="cpu")
    build(ts, tnode, tpod, tt)
    tout = ts.schedule_all_pending()
    assert _outcomes(tout) == _outcomes(jout)
    assert ts.builder.host_mirror_equal()


def test_filter_after_interpodaffinity_is_refused():
    """A profile that orders one of eval_chunk's filters after
    InterPodAffinity is no longer refused: the filters after it run in a
    second eval_chunk launch on the nodes its filter left, so fail bits
    come out in the profile's order.  Here NodeResourcesFit follows
    InterPodAffinity; the outcomes (bindings, the rejecting plugins of the
    pods that fail) equal JAX TPUScheduler's with the same profile."""
    kw = dict(name="ipa-first", filters=("InterPodAffinity", "NodeResourcesFit"), scorers=())
    outs = []
    for sched, mknode, mkpod in ((TorchScheduler(TProfile(**kw), batch_size=4, device="cpu"), tnode, tpod),
                                 (TPUScheduler(profile=JProfile(**kw), batch_size=4), jnode, jpod)):
        _zones(sched, mknode)
        sched.add_pod(mkpod("big").req({"cpu": "60"}).label("app", "a").node("n-a0").obj())
        sched.add_pod(mkpod("p").req({"cpu": "1"}).label("app", "a").pod_anti_affinity_in("app", ["a"], ZONE).obj())
        # Zone a is excluded by the anti-affinity (bit 0); the remaining
        # nodes' cpu (bit 1) rejects the second pod everywhere else.
        sched.add_pod(mkpod("q").req({"cpu": "70"}).obj())
        sched.add_pod(mkpod("r").req({"cpu": "70"}).label("app", "a").pod_anti_affinity_in(
            "app", ["a"], ZONE).obj())
        plugins = (lambda o: o.unschedulable_plugins) if isinstance(sched, TorchScheduler) else (
            lambda o: o.diagnosis.unschedulable_plugins if o.diagnosis else ())
        outs.append({o.pod.name: (o.node_name, sorted(plugins(o))) for o in sched.schedule_all_pending()})
    assert outs[0] == outs[1]
    assert outs[0]["q"] == (None, ["NodeResourcesFit"])
    assert outs[0]["r"] == (None, ["InterPodAffinity", "NodeResourcesFit"])
    assert outs[0]["p"][0] is not None and not outs[0]["p"][0].startswith("n-a")


def test_namespace_relabel_refeaturizes():
    """Namespace labels feed namespaceSelector matching: relabelling a
    namespace between batches must re-featurize a pod whose cached twin
    saw the old labels (the ns_epoch in the feature version)."""
    def drive(s, mknode, mkpod):
        _zones(s, mknode)
        s.builder.set_namespace_labels("team-a", {"team": "a"})
        s.builder.set_namespace_labels("team-b", {"team": "b"})
        s.add_pod(mkpod("ea", "team-a").req({"cpu": "1"}).label("app", "db").node("n-a0").obj())
        s.add_pod(mkpod("eb", "team-b").req({"cpu": "1"}).label("app", "db").node("n-c0").obj())
        mk = lambda name: (mkpod(name).req({"cpu": "1"})  # noqa: E731
                           .ns_selector_pod_affinity_in("app", ["db"], ZONE, "team", ["a"]).obj())
        s.add_pod(mk("p1"))
        s.add_pod(mk("p1b"))  # featurized after p1 grew the group vocabulary: cached
        out = s.schedule_all_pending()
        s.builder.set_namespace_labels("team-a", {"team": "b"})
        s.builder.set_namespace_labels("team-b", {"team": "a"})
        s.add_pod(mk("p2"))
        return {o.pod.name: o.node_name for o in out + s.schedule_all_pending()}

    js = TPUScheduler(profile=_ipa_profile(JProfile, False), batch_size=4)
    ts = TorchScheduler(_ipa_profile(TProfile, False), batch_size=4, device="cpu")
    got = drive(ts, tnode, tpod)
    assert got == drive(js, jnode, jpod)
    assert got["p1"].startswith("n-a") and got["p1b"].startswith("n-a")
    assert got["p2"].startswith("n-c")
