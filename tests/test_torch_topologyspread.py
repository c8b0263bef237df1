"""The port's PodTopologySpread, NodeAffinity and TaintToleration
featurization and plain filters and scores against the JAX ops, exactly;
and PodTopologySpread's scenarios (tests/test_ops_topologyspread.py)
through TorchScheduler and TPUScheduler.

Op level: one seeded cluster goes through both builders (zone and hostname
keys, nodes missing the zone key, integer and non-integer labels,
NoSchedule, NoExecute and PreferNoSchedule taints, bound pods in two
namespaces), and pods with every kind of constraint (DoNotSchedule and
ScheduleAnyway, zone and hostname, minDomains, self-match, matchLabelKeys,
Honor and Ignore inclusion policies), node affinity (nodeSelector, ORed
required terms, In/NotIn/Exists/DoesNotExist/Gt/Lt, matchFields names,
preferred weights) and tolerations are featurized by both.  Every
``tps_*``, ``na_*`` and ``taint_*`` feature must be equal, and the port's
plain filter and score over the chunk must equal the JAX op vmapped over
the same pods, also under a profile with addedAffinity and with the spread
gates off.  Tolerance: none (exact)."""

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
from kubernetes_tpu.framework.features import FeatureGates as JGates
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
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.framework.features import FeatureGates as TGates
from kubernetes_tpu_torch.ops import helpers
from kubernetes_tpu_torch.ops import nodeaffinity as na_op
from kubernetes_tpu_torch.ops import podtopologyspread as spread_op
from kubernetes_tpu_torch.ops import tainttoleration as taint_op
from kubernetes_tpu_torch.ops.common import PassContext
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import SnapshotBuilder, state_to_numpy

from reference_impl import spread_filter, spread_score

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
JPROF = registered_subset(JDEF)
APPS = ["web", "db", "cache", "queue"]
OPS = {"PodTopologySpread": spread_op, "NodeAffinity": na_op, "TaintToleration": taint_op}
PREFIXES = ("tps_", "na_", "taint_")


def _req(t, rng):
    """One random node-selector requirement over disk, num and zone."""
    kind = int(rng.integers(0, 7))
    if kind == 0:
        return t.NodeSelectorRequirement("disk", t.OP_IN, ("ssd",))
    if kind == 1:
        return t.NodeSelectorRequirement(ZONE, t.OP_NOT_IN, (f"z{int(rng.integers(3))}",))
    if kind == 2:
        return t.NodeSelectorRequirement(ZONE, t.OP_EXISTS)
    if kind == 3:
        return t.NodeSelectorRequirement("disk", t.OP_DOES_NOT_EXIST)
    if kind == 4:
        return t.NodeSelectorRequirement("num", t.OP_GT, (str(int(rng.integers(0, 50))),))
    if kind == 5:
        return t.NodeSelectorRequirement("num", t.OP_LT, (str(int(rng.integers(0, 50))),))
    return t.NodeSelectorRequirement("num", t.OP_GT, ("not-a-number",))


def _node_affinity(w, t, rng):
    r = int(rng.integers(0, 6))
    if r == 0:
        return w.node_selector({"disk": "ssd"})
    pod = w.obj()
    terms, preferred = [], []
    if r in (1, 2, 3):
        for _ in range(int(rng.integers(1, 3))):
            terms.append(t.NodeSelectorTerm(
                match_expressions=tuple(_req(t, rng) for _ in range(int(rng.integers(1, 3))))))
    if r == 3:
        terms.append(t.NodeSelectorTerm(match_fields=(
            t.NodeSelectorRequirement("metadata.name", t.OP_IN, (f"n{int(rng.integers(24))}", "ghost")),)))
    if r in (2, 4):
        for _ in range(int(rng.integers(1, 3))):
            preferred.append(t.PreferredSchedulingTerm(
                weight=int(rng.integers(1, 100)),
                preference=t.NodeSelectorTerm(match_expressions=(_req(t, rng),))))
    if r == 5:
        return w.node_name_affinity(f"n{int(rng.integers(24))}")
    if terms or preferred:
        pod.spec.affinity = t.Affinity(node_affinity=t.NodeAffinity(
            required=t.NodeSelector(terms=tuple(terms)) if terms else None,
            preferred=tuple(preferred)))
    return w


def _spread(w, t, rng, app):
    for _ in range(int(rng.integers(0, 3))):
        when = t.DO_NOT_SCHEDULE if rng.integers(2) else t.SCHEDULE_ANYWAY
        topo = HOST if rng.random() < 0.3 else ZONE
        target = app if rng.random() < 0.7 else APPS[int(rng.integers(4))]
        w = w.spread_constraint(
            int(rng.integers(1, 3)), topo, when, "app", [target],
            min_domains=int(rng.choice([0, 4])) or None,
            node_affinity_policy=t.POLICY_HONOR if rng.integers(2) else t.POLICY_IGNORE,
            node_taints_policy=t.POLICY_HONOR if rng.integers(2) else t.POLICY_IGNORE,
            match_label_keys=("ver",) if rng.random() < 0.2 else (),
        )
    return w


def mixed_cluster(mknode, mkpod, t, builder, cache, seed):
    """24 nodes and 40 bound pods; returns 24 pods to schedule."""
    rng = np.random.default_rng(seed)
    for i in range(24):
        w = mknode(f"n{i}").capacity({"cpu": "32", "memory": "64Gi", "pods": 110})
        if i % 11 != 5:  # two nodes lack the zone key
            w = w.zone(f"z{i % 3}")
        if i % 3:
            w = w.label("disk", "ssd" if i % 2 else "hdd")
        w = w.label("num", str(i * 7 % 50) if i % 6 else "x")
        if i % 4 == 1:
            w = w.taint("dedicated", "gpu", t.EFFECT_NO_SCHEDULE)
        if i % 5 == 2:
            w = w.taint("soft", "x", t.EFFECT_PREFER_NO_SCHEDULE)
        if i % 7 == 3:
            w = w.taint("evict", "y", t.EFFECT_NO_EXECUTE)
        cache.add_node(w.obj())
    for j in range(40):
        ns = "default" if j % 5 else "other"
        w = mkpod(f"b{j}", ns).req({"cpu": "100m"}).label("app", APPS[j % 4]).label("ver", f"v{j % 2}")
        cache.add_pod(w.node(f"n{int(rng.integers(24))}").obj())
    pods = []
    for k in range(24):
        app = APPS[int(rng.integers(4))]
        w = mkpod(f"p{k}").req({"cpu": "100m"}).label("app", app).label("ver", f"v{k % 2}")
        w = _spread(w, t, rng, app)
        if rng.random() < 0.6:
            w = _node_affinity(w, t, rng)
        for _ in range(int(rng.integers(0, 3))):
            key = ["dedicated", "soft", "evict", ""][int(rng.integers(4))]
            op = t.TOLERATION_OP_EXISTS if rng.integers(2) or not key else t.TOLERATION_OP_EQUAL
            eff = ["", t.EFFECT_NO_SCHEDULE, t.EFFECT_PREFER_NO_SCHEDULE, t.EFFECT_NO_EXECUTE][int(rng.integers(4))]
            w = w.toleration(key=key, op=op, value=["gpu", "x", "y"][int(rng.integers(3))], effect=eff)
        pods.append(w.obj())
    return pods


def _added(t):
    """A profile addedAffinity: zone z0 or z1 required, ssd preferred."""
    return t.NodeAffinity(
        required=t.NodeSelector(terms=(t.NodeSelectorTerm(match_expressions=(
            t.NodeSelectorRequirement(ZONE, t.OP_IN, ("z0", "z1")),)),)),
        preferred=(t.PreferredSchedulingTerm(5, t.NodeSelectorTerm(match_expressions=(
            t.NodeSelectorRequirement("disk", t.OP_IN, ("ssd",)),))),),
    )


def profiles(variant: str):
    """(JAX profile, port profile, JAX gates, port gates) of a variant."""
    jp, tp, jg, tg = JPROF, TDEF, None, None
    if variant == "added-affinity":
        jp = dataclasses.replace(jp, added_affinity=_added(jt))
        tp = dataclasses.replace(tp, added_affinity=_added(tt))
    if variant == "gates-off":
        off = (("MatchLabelKeysInPodTopologySpread", False),
               ("NodeInclusionPolicyInPodTopologySpread", False))
        jg, tg = JGates(off), TGates(off)
    return jp, tp, jg, tg


def featurized(seed, variant="default", k=None):
    """Both builders over the mixed cluster, its pods featurized into a
    batch of ``k`` rows (default: the pod count); the spread, affinity and
    taint features, the schema and the state checked equal."""
    jp, tp, jg, tg = profiles(variant)
    jb = JaxBuilder()
    jb.feature_gates = jg
    jpods = mixed_cluster(jnode, jpod, jt, jb, JaxCache(jb), seed)
    tb = SnapshotBuilder(device="cpu")
    tb.feature_gates = tg
    tpods = mixed_cluster(tnode, tpod, tt, tb, TorchCache(tb), seed)
    k = k or len(jpods)
    jbatch, _, jactive = jax_batch(jpods, jb, jp, k)
    tbatch, _, tactive = torch_batch(tpods, tb, tp, k)
    assert {"PodTopologySpread", "NodeAffinity", "TaintToleration"} <= tactive
    assert jactive == tactive
    keys = sorted(key for key in tbatch if key.startswith(PREFIXES))
    assert sorted(key for key in jbatch if key.startswith(PREFIXES)) == keys
    n = len(jpods)
    for key in keys:
        np.testing.assert_array_equal(np.asarray(jbatch[key])[:n], tbatch[key][:n], err_msg=key)
    assert dataclasses.asdict(jb.schema) == dataclasses.asdict(tb.schema)
    jstate, tstate = jb.state(), tb.state()
    for name, got in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(got, np.asarray(getattr(jstate, name)), err_msg=name)
    return dict(jb=jb, tb=tb, jp=jp, tp=tp, jstate=jstate, tstate=tstate, jbatch=jbatch,
                tbatch=tbatch, keys=keys, active=tactive)


def op_inputs(x):
    jb, tb = x["jb"], x["tb"]
    inv = jb.batch_invariants()
    jdom = jax_build_dom(x["jstate"], jnp.asarray(inv["et_slot"]), jnp.asarray(inv["et_host"]), jb.schema.DV)
    jctx = jcommon.PassContext(profile=x["jp"], schema=jb.schema, static={}, dom=jdom)
    tctx = PassContext(profile=x["tp"], schema=tb.schema, static={})
    jpf = {key: jnp.asarray(x["jbatch"][key]) for key in x["keys"]}
    tpf = {key: torch.from_numpy(np.ascontiguousarray(x["tbatch"][key])) for key in x["keys"]}
    return jctx, jpf, tctx, tpf


@pytest.mark.parametrize("seed,variant", [(1, "default"), (2, "default"), (3, "added-affinity"),
                                          (4, "gates-off")])
def test_plain_filters_and_scores_match_jax(seed, variant):
    x = featurized(seed, variant)
    jstate, tstate = x["jstate"], x["tstate"]
    jctx, jpf, tctx, tpf = op_inputs(x)
    valid = np.asarray(jstate.valid)
    rng = np.random.default_rng(seed)
    for name, top in OPS.items():
        jop = jcommon.get(name)
        jok = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, jctx))(jpf))
        tok = top.filter_fn(tstate, tpf, tctx).numpy()
        np.testing.assert_array_equal(tok, jok, err_msg=name)
        assert (~jok & valid).any(), name  # the filter rejects somewhere
        # Scores over the op's feasible set and over a random one.
        for feas in (jok & valid, (rng.random(jok.shape) < 0.6) & valid):
            js = jax.vmap(lambda p, f: jop.score(jstate, p, jctx, f))(jpf, jnp.asarray(feas))
            ts = top.score_fn(tstate, tpf, tctx, torch.from_numpy(feas))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=name)


def test_group_index_matches_scalar_groups_matching():
    """The vectorized selector match featurization uses
    (GroupIndex.match_selector) equals the scalar groups_matching on every
    spread selector of the mixed pods, with and without a namespace set."""
    x = featurized(5)
    b = x["tb"]
    it = b.interns
    pods = mixed_cluster(tnode, tpod, tt, SnapshotBuilder(device="cpu"),
                         TorchCache(SnapshotBuilder(device="cpu")), 5)
    sels = [tt.spread_effective_selector(c, p.metadata.labels)
            for p in pods for c in p.spec.topology_spread_constraints]
    assert sels
    for sel in sels:
        for ns in (None, {it.namespaces.id("default")}):
            want = spread_op.groups_matching(it, b.schema.G, ns, sel)
            got = b.group_index.match_selector(sel, ns)
            np.testing.assert_array_equal(got, want[: got.shape[0]])
            assert not want[got.shape[0]:].any()


def test_log_table_matches_xla():
    """The spread score's log(topoSize + 2) table equals XLA's f64 log on
    every size up to 70000 (torch.log on the CPU does not, for some)."""
    n = 70000
    want = np.asarray(jax.jit(lambda v: jnp.log(v + 2.0))(jnp.arange(n + 1, dtype=jnp.float64)))
    np.testing.assert_array_equal(helpers.log_table(n, "cpu").numpy(), want)


def test_spread_shared_memory_cap_raises():
    assert kernels.spread_smem_bytes(4, 16) < kernels.SPREAD_SMEM_CAP
    with pytest.raises(NotImplementedError, match="SPREAD_SMEM_CAP"):
        kernels.spread_smem_bytes(8, 4096)


# -- scheduler-level scenarios (tests/test_ops_topologyspread.py) -----------


def _tps_profile(profile_cls, with_score=True):
    return profile_cls(
        name="tps",
        filters=("NodeResourcesFit", "PodTopologySpread"),
        scorers=(("PodTopologySpread", 2),) if with_score else (),
    )


def _zones(s, mknode, n_per_zone=2, zones=("a", "b", "c")):
    for z in zones:
        for i in range(n_per_zone):
            s.add_node(mknode(f"n-{z}{i}").capacity({"cpu": "64", "pods": 110}).zone(z).obj())


def _spread_pod(mkpod, t, name, max_skew=1, when=None, topo=ZONE, **kw):
    return (mkpod(name).req({"cpu": "100m"}).label("app", "web")
            .spread_constraint(max_skew, topo, when or t.DO_NOT_SCHEDULE, "app", ["web"], **kw).obj())


def _balances(s, mknode, mkpod, t):
    _zones(s, mknode)
    for i in range(6):
        s.add_pod(_spread_pod(mkpod, t, f"p{i}"))


def _blocks_over_skew(s, mknode, mkpod, t):
    s.add_node(mknode("n-a0").capacity({"cpu": "64", "pods": 110}).zone("a").obj())
    s.add_node(mknode("n-b0").capacity({"cpu": "64", "pods": 110}).zone("b").unschedulable().obj())
    for i in range(3):
        s.add_pod(_spread_pod(mkpod, t, f"p{i}"))


def _min_domains(s, mknode, mkpod, t):
    _zones(s, mknode, n_per_zone=1, zones=("a", "b"))
    for i in range(2):
        s.add_pod(_spread_pod(mkpod, t, f"p{i}", min_domains=3))


def _soft_emptier(s, mknode, mkpod, t):
    _zones(s, mknode, n_per_zone=1, zones=("a", "b"))
    s.add_pod(mkpod("existing").req({"cpu": "100m"}).label("app", "web").node("n-a0").obj())
    s.add_pod(_spread_pod(mkpod, t, "p0", when=t.SCHEDULE_ANYWAY))


def _hostname_soft(s, mknode, mkpod, t):
    for i in range(3):
        s.add_node(mknode(f"n{i}").capacity({"cpu": "64", "pods": 110}).obj())
    for name, node in (("e1", "n0"), ("e2", "n0"), ("e3", "n1")):
        s.add_pod(mkpod(name).req({"cpu": "100m"}).label("app", "web").node(node).obj())
    s.add_pod(_spread_pod(mkpod, t, "p0", when=t.SCHEDULE_ANYWAY, topo=HOST))


def _missing_key(s, mknode, mkpod, t):
    s.add_node(mknode("zoned").capacity({"cpu": "64", "pods": 110}).zone("a").obj())
    s.add_node(mknode("bare").capacity({"cpu": "64", "pods": 110}).obj())
    s.add_pod(_spread_pod(mkpod, t, "p0"))


def _rounding_boundary(s, mknode, mkpod, t):
    """Hostname ScheduleAnyway over 17 scored nodes: a node with 9 matching
    pods scores 9·log(19) = 26.49995..., 5e-5 below the rounding point."""
    for i in range(17):
        s.add_node(mknode(f"n{i}").capacity({"cpu": "64", "pods": 110}).obj())
    for i in range(9):
        s.add_pod(mkpod(f"e{i}").req({"cpu": "100m"}).label("app", "web").node("n0").obj())
    for i in range(4):
        s.add_pod(mkpod(f"f{i}").req({"cpu": "100m"}).label("app", "web").node(f"n{1 + i % 2}").obj())
    for i in range(3):
        s.add_pod(_spread_pod(mkpod, t, f"p{i}", when=t.SCHEDULE_ANYWAY, topo=HOST))


def _randomized_objects(mknode, mkpod, t):
    """tests/test_ops_topologyspread.py::test_matches_reference_randomized:
    (nodes, pods)."""
    rng = np.random.default_rng(17)
    zones = ["za", "zb", "zc"]
    nodes = []
    for i in range(18):
        w = mknode(f"n{i}").capacity({"cpu": "640", "pods": 200})
        if rng.integers(0, 5):
            w = w.zone(zones[int(rng.integers(0, 3))])
        nodes.append(w.obj())
    apps = ["web", "db", "cache"]
    pods = []
    for i in range(50):
        app = apps[int(rng.integers(0, 3))]
        w = mkpod(f"p{i}").req({"cpu": "100m"}).label("app", app)
        r = int(rng.integers(0, 4))
        if r == 0:
            w = w.spread_constraint(int(rng.integers(1, 3)), ZONE, t.DO_NOT_SCHEDULE, "app", [app])
        elif r == 1:
            w = w.spread_constraint(int(rng.integers(1, 3)), ZONE, t.SCHEDULE_ANYWAY, "app", [app])
        elif r == 2:
            w = w.spread_constraint(1, HOST, t.SCHEDULE_ANYWAY, "app", [app])
        pods.append(w.obj())
    return nodes, pods


def _randomized(s, mknode, mkpod, t):
    nodes, pods = _randomized_objects(mknode, mkpod, t)
    for n in nodes:
        s.add_node(n)
    for p in pods:
        s.add_pod(p)


SCENARIOS = {
    "hard-zone-balances": (_balances, False, 16),
    "hard-blocks-over-skew": (_blocks_over_skew, False, 16),
    "min-domains": (_min_domains, False, 16),
    "soft-prefers-emptier-zone": (_soft_emptier, True, 16),
    "hostname-soft": (_hostname_soft, True, 16),
    "missing-topology-key": (_missing_key, False, 16),
    "rounding-boundary": (_rounding_boundary, True, 16),
    "randomized": (_randomized, True, 64),
}


def _outcomes(outcomes):
    return {o.pod.name: (o.node_name, o.feasible_nodes, o.score) for o in outcomes}


def _profile_for(name, profile_cls, score):
    prof = _tps_profile(profile_cls, score)
    if name == "hard-blocks-over-skew":
        prof = profile_cls(name="tps-u", filters=("NodeUnschedulable", "NodeResourcesFit",
                                                   "PodTopologySpread"), scorers=())
    return prof


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    build, score, batch = SCENARIOS[name]
    js = TPUScheduler(profile=_profile_for(name, JProfile, score), batch_size=batch)
    build(js, jnode, jpod, jt)
    jout = js.schedule_all_pending()
    ts = TorchScheduler(_profile_for(name, TProfile, score), batch_size=batch, device="cpu")
    build(ts, tnode, tpod, tt)
    tout = ts.schedule_all_pending()
    assert _outcomes(tout) == _outcomes(jout)
    assert ts.builder.host_mirror_equal()
    if name == "rounding-boundary":
        assert not {o.node_name for o in tout} & {"n0", "n1", "n2"}  # the loaded nodes lose


def test_randomized_matches_reference_oracle():
    """The port's picks replayed through the scalar oracle
    (tests/reference_impl.py spread_filter, spread_score): every feasible
    count equal, every pick feasible and best-scored."""
    ts = TorchScheduler(_tps_profile(TProfile, True), batch_size=64, device="cpu")
    nodes, pods = _randomized_objects(tnode, tpod, tt)
    for n in nodes:
        ts.add_node(n)
    for p in pods:
        ts.add_pod(p)
    out = {o.pod.name: o for o in ts.schedule_all_pending()}
    pods_on: dict[str, list] = {n.name: [] for n in nodes}
    for p in pods:
        o = out[p.name]
        feas = spread_filter(p, nodes, pods_on)
        assert o.feasible_nodes == sum(feas.values()), p.name
        if o.node_name is None:
            continue
        assert feas[o.node_name], p.name
        scores = spread_score(p, nodes, pods_on, feas)
        assert scores[o.node_name] == max(v for name, v in scores.items() if feas[name]), p.name
        pods_on[o.node_name].append(p)
