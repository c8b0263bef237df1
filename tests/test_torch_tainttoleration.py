"""The port's TaintToleration against the JAX op through both schedulers:
the taint scenarios of tests/test_ops_taints_ports.py (an intolerable
NoSchedule taint, a tolerating pod, an Exists toleration of any effect,
PreferNoSchedule scoring, the randomized reference check) and NoExecute
taints with matching and non-matching tolerations, each run by
TorchScheduler on the CPU and by TPUScheduler; bindings, feasible counts
and scores must be equal.  The randomized case is also held against the
scalar oracle (tests/reference_impl.py taint_toleration_filter,
taint_toleration_score_raw).  Tolerance: none (exact)."""

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

from reference_impl import taint_toleration_filter, taint_toleration_score_raw


def _profile(cls):
    return cls(name="taints", filters=("TaintToleration",), scorers=(("TaintToleration", 3),))


def _cap(w):
    return w.capacity({"cpu": "4", "pods": 110})


def _untolerated(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("tainted")).taint("dedicated", "gpu").obj())
    s.add_node(_cap(mknode("clean")).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).obj())


def _tolerated(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("tainted")).taint("dedicated", "gpu").obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).toleration(key="dedicated", value="gpu",
                                                      effect=t.EFFECT_NO_SCHEDULE).obj())


def _exists_any_effect(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("t1")).taint("k1", "v1", t.EFFECT_NO_EXECUTE).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).toleration(key="k1", op=t.TOLERATION_OP_EXISTS).obj())


def _prefer_no_schedule(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("soft-tainted")).taint("soft", "x", t.EFFECT_PREFER_NO_SCHEDULE).obj())
    s.add_node(_cap(mknode("clean")).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).obj())
    # A NoSchedule-only toleration does not count for scoring.
    s.add_pod(mkpod("q").req({"cpu": "1"}).toleration(key="soft", op=t.TOLERATION_OP_EXISTS,
                                                      effect=t.EFFECT_NO_SCHEDULE).obj())


def _no_execute(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("evicting")).taint("maint", "now", t.EFFECT_NO_EXECUTE).obj())
    s.add_node(_cap(mknode("both")).taint("maint", "now", t.EFFECT_NO_EXECUTE)
               .taint("soft", "x", t.EFFECT_PREFER_NO_SCHEDULE).obj())
    s.add_pod(mkpod("wrong-value").req({"cpu": "1"}).toleration(key="maint", value="later").obj())
    s.add_pod(mkpod("wrong-effect").req({"cpu": "1"}).toleration(
        key="maint", value="now", effect=t.EFFECT_NO_SCHEDULE).obj())
    s.add_pod(mkpod("right").req({"cpu": "1"}).toleration(
        key="maint", value="now", effect=t.EFFECT_NO_EXECUTE, seconds=30).obj())


def _randomized_objects(mknode, mkpod, t):
    """tests/test_ops_taints_ports.py::test_taint_filter_matches_reference_randomized."""
    rng = np.random.default_rng(7)
    effects = [t.EFFECT_NO_SCHEDULE, t.EFFECT_NO_EXECUTE, t.EFFECT_PREFER_NO_SCHEDULE]
    nodes = []
    for i in range(24):
        w = mknode(f"n{i}").capacity({"cpu": "64", "pods": 110})
        for _ in range(int(rng.integers(0, 4))):
            w = w.taint(f"k{rng.integers(0, 5)}", f"v{rng.integers(0, 3)}", effects[int(rng.integers(0, 3))])
        nodes.append(w.obj())
    pods = []
    for i in range(30):
        w = mkpod(f"p{i}").req({"cpu": "1m"})
        for _ in range(int(rng.integers(0, 4))):
            op = t.TOLERATION_OP_EXISTS if rng.integers(0, 2) else t.TOLERATION_OP_EQUAL
            eff = "" if rng.integers(0, 3) == 0 else effects[int(rng.integers(0, 3))]
            w = w.toleration(key=f"k{rng.integers(0, 5)}", op=op, value=f"v{rng.integers(0, 3)}", effect=eff)
        pods.append(w.obj())
    return nodes, pods


def _randomized(s, mknode, mkpod, t):
    nodes, pods = _randomized_objects(mknode, mkpod, t)
    for n in nodes:
        s.add_node(n)
    for p in pods:
        s.add_pod(p)


SCENARIOS = {
    "untolerated-noschedule": (_untolerated, 8),
    "toleration-admits": (_tolerated, 8),
    "exists-any-effect": (_exists_any_effect, 8),
    "prefer-no-schedule-scores-lower": (_prefer_no_schedule, 8),
    "no-execute": (_no_execute, 8),
    "randomized": (_randomized, 32),
}


def _outcomes(outcomes):
    return {o.pod.name: (o.node_name, o.feasible_nodes, o.score) for o in outcomes}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    build, batch = SCENARIOS[name]
    js = TPUScheduler(profile=_profile(JProfile), batch_size=batch)
    build(js, jnode, jpod, jt)
    jout = js.schedule_all_pending()
    ts = TorchScheduler(_profile(TProfile), batch_size=batch, device="cpu")
    build(ts, tnode, tpod, tt)
    tout = ts.schedule_all_pending()
    assert _outcomes(tout) == _outcomes(jout)
    assert ts.builder.host_mirror_equal()


def test_randomized_matches_reference_oracle():
    nodes, pods = _randomized_objects(tnode, tpod, tt)
    ts = TorchScheduler(_profile(TProfile), batch_size=32, device="cpu")
    for n in nodes:
        ts.add_node(n)
    for p in pods:
        ts.add_pod(p)
    out = {o.pod.name: o for o in ts.schedule_all_pending()}
    for p in pods:
        feas = [n for n in nodes if taint_toleration_filter(p, n)]
        o = out[p.name]
        assert (o.node_name is not None) == bool(feas), p.name
        assert o.feasible_nodes == len(feas), p.name
        if feas:
            counts = {n.name: taint_toleration_score_raw(p, n) for n in feas}
            assert counts[o.node_name] == min(counts.values()), p.name
