"""The port's NodeAffinity against the JAX op through both schedulers: the
scenarios of tests/test_ops_nodeaffinity.py (nodeSelector, In, ORed terms,
Gt/Lt with a non-integer label, matchFields names, empty required terms,
unknown keys, preferred weights, the randomized reference check), a
profile with addedAffinity and the daemonset name pin, each run by
TorchScheduler on the CPU and by TPUScheduler; bindings, feasible counts
and scores must be equal.  The randomized case is also held against the
scalar oracle (tests/reference_impl.py node_affinity_filter,
node_affinity_score_raw).  The op-level checks (features, plain filter and
score against the JAX op) are in tests/test_torch_topologyspread.py.
Tolerance: none (exact)."""

import dataclasses

import numpy as np
import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.scheduler import TorchScheduler

from reference_impl import node_affinity_filter, node_affinity_score_raw


def _profile(cls, t, added=False):
    prof = cls(name="na", filters=("NodeAffinity",), scorers=(("NodeAffinity", 2),))
    if added:
        prof = dataclasses.replace(prof, added_affinity=t.NodeAffinity(
            required=t.NodeSelector(terms=(t.NodeSelectorTerm(match_expressions=(
                t.NodeSelectorRequirement("disk", t.OP_EXISTS),)),)),
            preferred=(t.PreferredSchedulingTerm(4, t.NodeSelectorTerm(match_expressions=(
                t.NodeSelectorRequirement("tier", t.OP_IN, ("gold",)),))),)))
    return prof


def _required(t, pod, *terms):
    pod.spec.affinity = t.Affinity(node_affinity=t.NodeAffinity(required=t.NodeSelector(terms=tuple(terms))))
    return pod


def _cap(w):
    return w.capacity({"cpu": "4", "pods": 110})


def _node_selector(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("gpu")).label("accel", "tpu").obj())
    s.add_node(_cap(mknode("plain")).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).node_selector({"accel": "tpu"}).obj())


def _required_in(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("a")).label("disk", "ssd").obj())
    s.add_node(_cap(mknode("b")).label("disk", "hdd").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).node_affinity_in("disk", ["ssd"]).obj())


def _terms_ored(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("a")).label("disk", "hdd").obj())
    terms = [t.NodeSelectorTerm(match_expressions=(t.NodeSelectorRequirement("disk", t.OP_IN, (v,)),))
             for v in ("ssd", "hdd")]
    s.add_pod(_required(t, mkpod("p").req({"cpu": "1"}).obj(), *terms))


def _gt_lt(s, mknode, mkpod, t):
    for name, cores in (("big", "64"), ("small", "8"), ("weird", "banana")):
        s.add_node(_cap(mknode(name)).label("cores", cores).obj())
    for i, (op, v) in enumerate(((t.OP_GT, "16"), (t.OP_LT, "16"), (t.OP_GT, "x"))):
        term = t.NodeSelectorTerm(match_expressions=(t.NodeSelectorRequirement("cores", op, (v,)),))
        s.add_pod(_required(t, mkpod(f"p{i}").req({"cpu": "1"}).obj(), term))


def _match_fields(s, mknode, mkpod, t):
    for i in range(3):
        s.add_node(_cap(mknode(f"n{i}")).obj())
    term = t.NodeSelectorTerm(match_fields=(t.NodeSelectorRequirement("metadata.name", t.OP_IN, ("n1",)),))
    s.add_pod(_required(t, mkpod("p").req({"cpu": "1"}).obj(), term))
    not_in = t.NodeSelectorTerm(match_fields=(t.NodeSelectorRequirement("metadata.name", t.OP_NOT_IN, ("n0", "n2")),))
    s.add_pod(_required(t, mkpod("q").req({"cpu": "1"}).obj(), not_in))
    s.add_pod(mkpod("pinned").req({"cpu": "1"}).node_name_affinity("n2").obj())


def _empty_terms(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("n0")).obj())
    pod = mkpod("p").req({"cpu": "1"}).obj()
    pod.spec.affinity = t.Affinity(node_affinity=t.NodeAffinity(required=t.NodeSelector(terms=())))
    s.add_pod(pod)


def _unknown_key(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("n0")).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).node_selector({"never-seen": "x"}).obj())


def _preferred_weights(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("a")).label("tier", "gold").obj())
    s.add_node(_cap(mknode("b")).label("tier", "silver").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).preferred_node_affinity_in("tier", ["gold"], weight=10)
              .preferred_node_affinity_in("tier", ["silver"], weight=3).obj())


def _added_affinity(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("a")).label("tier", "gold").obj())
    s.add_node(_cap(mknode("b")).label("tier", "gold").label("disk", "hdd").obj())
    s.add_node(_cap(mknode("c")).label("disk", "ssd").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).obj())
    s.add_pod(mkpod("q").req({"cpu": "1"}).node_name_affinity("c").obj())


def _random_requirement(t, rng):
    keys = [f"k{i}" for i in range(4)] + ["num"]
    ops = [t.OP_IN, t.OP_NOT_IN, t.OP_EXISTS, t.OP_DOES_NOT_EXIST, t.OP_GT, t.OP_LT]
    op = ops[int(rng.integers(0, len(ops)))]
    key = keys[int(rng.integers(0, len(keys)))]
    if op in (t.OP_GT, t.OP_LT):
        return t.NodeSelectorRequirement("num", op, (str(int(rng.integers(0, 100))),))
    vals = tuple(f"v{int(rng.integers(0, 4))}" for _ in range(int(rng.integers(1, 3))))
    return t.NodeSelectorRequirement(key, op, vals if op in (t.OP_IN, t.OP_NOT_IN) else ())


def _randomized_objects(mknode, mkpod, t):
    """tests/test_ops_nodeaffinity.py::test_matches_reference_randomized."""
    rng = np.random.default_rng(3)
    nodes = []
    for i in range(30):
        w = mknode(f"n{i}").capacity({"cpu": "64", "pods": 110})
        for k in range(4):
            if rng.integers(0, 2):
                w = w.label(f"k{k}", f"v{int(rng.integers(0, 4))}")
        if rng.integers(0, 2):
            w = w.label("num", str(int(rng.integers(0, 100))))
        nodes.append(w.obj())
    pods = []
    for i in range(40):
        pod = mkpod(f"p{i}").req({"cpu": "1m"}).obj()
        terms = [t.NodeSelectorTerm(match_expressions=tuple(
            _random_requirement(t, rng) for _ in range(int(rng.integers(1, 3)))))
            for _ in range(int(rng.integers(0, 3)))]
        preferred = [t.PreferredSchedulingTerm(
            weight=int(rng.integers(1, 20)),
            preference=t.NodeSelectorTerm(match_expressions=tuple(
                _random_requirement(t, rng) for _ in range(int(rng.integers(1, 3))))))
            for _ in range(int(rng.integers(0, 3)))]
        if terms or preferred:
            pod.spec.affinity = t.Affinity(node_affinity=t.NodeAffinity(
                required=t.NodeSelector(terms=tuple(terms)) if terms else None,
                preferred=tuple(preferred)))
        pods.append(pod)
    return nodes, pods


def _randomized(s, mknode, mkpod, t):
    nodes, pods = _randomized_objects(mknode, mkpod, t)
    for n in nodes:
        s.add_node(n)
    for p in pods:
        s.add_pod(p)


SCENARIOS = {
    "node-selector": (_node_selector, False, 16),
    "required-in": (_required_in, False, 16),
    "terms-ored": (_terms_ored, False, 16),
    "gt-lt": (_gt_lt, False, 16),
    "match-fields": (_match_fields, False, 16),
    "empty-required-terms": (_empty_terms, False, 16),
    "unknown-key": (_unknown_key, False, 16),
    "preferred-weights": (_preferred_weights, False, 16),
    "added-affinity": (_added_affinity, True, 16),
    "randomized": (_randomized, False, 64),
}


def _outcomes(outcomes):
    return {o.pod.name: (o.node_name, o.feasible_nodes, o.score) for o in outcomes}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    build, added, batch = SCENARIOS[name]
    js = TPUScheduler(profile=_profile(JProfile, jt, added), batch_size=batch)
    build(js, jnode, jpod, jt)
    jout = js.schedule_all_pending()
    ts = TorchScheduler(_profile(TProfile, tt, added), batch_size=batch, device="cpu")
    build(ts, tnode, tpod, tt)
    tout = ts.schedule_all_pending()
    assert _outcomes(tout) == _outcomes(jout)
    assert ts.builder.host_mirror_equal()


def test_randomized_matches_reference_oracle():
    nodes, pods = _randomized_objects(tnode, tpod, tt)
    ts = TorchScheduler(_profile(TProfile, tt), batch_size=64, device="cpu")
    for n in nodes:
        ts.add_node(n)
    for p in pods:
        ts.add_pod(p)
    out = {o.pod.name: o for o in ts.schedule_all_pending()}
    for p in pods:
        feas = [n for n in nodes if node_affinity_filter(p, n)]
        o = out[p.name]
        assert o.feasible_nodes == len(feas), p.name
        if feas:
            raws = {n.name: node_affinity_score_raw(p, n) for n in feas}
            assert raws[o.node_name] == max(raws.values()), p.name
        else:
            assert o.node_name is None
