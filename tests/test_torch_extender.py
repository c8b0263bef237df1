"""The extender path (kubernetes_tpu_torch/extender.py, TorchScheduler's
extender cycle) side by side with the JAX package's: the four scenarios of
tests/test_extender_profiles.py through TPUScheduler and
TorchScheduler(device="cpu") with the same fake extenders (the shape of
upstream's testing/fake_extender.go), which must bind identically, call
the extenders identically and park the same pods with the same plugins;
and HTTPExtender's request JSON and response parsing, with ``_post``
replaced (no sockets).  Tolerance: none (exact)."""

import json

import pytest

from kubernetes_tpu import extender as jext
from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.framework.config import fit_only_profile as j_fit_only
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch import extender as text
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.framework.config import fit_only_profile as t_fit_only
from kubernetes_tpu_torch.queue import Event
from kubernetes_tpu_torch.scheduler import TorchScheduler

SIDES = {
    "jax": (jext, jw, JProfile, j_fit_only, lambda **kw: TPUScheduler(**kw)),
    "torch": (text, tw, TProfile, t_fit_only, lambda **kw: TorchScheduler(device="cpu", **kw)),
}


def nodes(s, w, n=4, cpu="8"):
    for i in range(n):
        s.add_node(
            w.make_node(f"n{i}").capacity({"cpu": cpu, "memory": "16Gi", "pods": 110})
            .label("tier", "gold" if i % 2 else "bronze").obj()
        )


def fake_extender(ext):
    class FakeExtender:
        """In-process fake of the Extender surface."""

        name = "fake"
        weight = 1
        ignorable = False
        bind_verb = ""

        def __init__(self, allow=None, scores=None):
            self.allow = allow  # set of node names, or None = all
            self.scores = scores or {}
            self.calls = []

        def is_interested(self, pod):
            return True

        def filter(self, pod, nodes):
            self.calls.append(("filter", pod.name, tuple(nodes)))
            keep = [n for n in nodes if self.allow is None or n in self.allow]
            return ext.ExtenderFilterResult(node_names=keep)

        def prioritize(self, pod, nodes):
            self.calls.append(("prioritize", pod.name, tuple(nodes)))
            return [ext.HostPriority(n, self.scores.get(n, 0)) for n in nodes]

        def bind(self, pod, node):
            return True

    return FakeExtender


def preempting_extender(ext):
    class PreemptingExtender(fake_extender(ext)):
        supports_preemption = True

        def __init__(self, veto=False, **kw):
            super().__init__(**kw)
            self.veto = veto
            self.preempt_calls = []

        def process_preemption(self, pod, node_to_victims):
            self.preempt_calls.append((pod.name, {n: sorted(v.uid for v in vs) for n, vs in node_to_victims.items()}))
            if self.veto:
                return {}
            return {node: [v.uid for v in victims] for node, victims in node_to_victims.items()}

    return PreemptingExtender


def _binds(s) -> dict:
    return {uid: rec.node_name for uid, rec in sorted(s.cache.pods.items())}


def filters_and_scores(side):
    ext, w, _P, fit_only, make = SIDES[side]
    ex = fake_extender(ext)(allow={"n1", "n3"}, scores={"n3": 10})
    s = make(profile=fit_only(), batch_size=4, extenders=[ex])
    nodes(s, w)
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).obj())
    out = s.schedule_all_pending()
    return [o.node_name for o in out], ex.calls, _binds(s), s.builder.host_mirror_equal()


def rejection_requeues(side):
    ext, w, _P, fit_only, make = SIDES[side]
    ex = fake_extender(ext)(allow=set())  # rejects everything
    s = make(profile=fit_only(), batch_size=4, extenders=[ex])
    nodes(s, w)
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).obj())
    out = s.schedule_all_pending()
    first = out[0].node_name
    plugins = out[0].diagnosis.unschedulable_plugins if side == "jax" else out[0].unschedulable_plugins
    parked = sorted(s.queue._unschedulable) if side == "jax" else sorted(s.queue.unschedulable_uids())
    ex.allow = None
    s.add_node(w.make_node("n9").capacity({"cpu": "8", "pods": 110}).obj())
    out2 = s.schedule_all_pending(wait_backoff=True)
    return first, set(plugins), parked, [o.node_name for o in out2], ex.calls, _binds(s)


def two_profiles(side):
    ext, w, P, fit_only, make = SIDES[side]
    strict = P(
        name="gold-only",
        filters=("NodeUnschedulable", "NodeName", "NodeAffinity", "NodeResourcesFit"),
        scorers=(("NodeResourcesFit", 1),),
    )
    s = make(profile=fit_only(), batch_size=8, profiles=[strict])
    nodes(s, w)
    s.add_pod(w.make_pod("default-pod").req({"cpu": "1"}).scheduler("fit-only").obj())
    s.add_pod(w.make_pod("gold-pod").req({"cpu": "1"}).scheduler("gold-only").node_affinity_in("tier", ["gold"]).obj())
    s.add_pod(w.make_pod("alien").req({"cpu": "1"}).scheduler("other-scheduler").obj())
    out = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
    return out, _binds(s), s.builder.host_mirror_equal()


def preemption(side, veto):
    ext, w, _P, _fit_only, make = SIDES[side]
    ex = preempting_extender(ext)(veto=veto)
    s = make(batch_size=4, extenders=[ex])
    s.add_node(w.make_node("n0").capacity({"cpu": "4", "memory": "16Gi", "pods": 10}).obj())
    s.add_pod(w.make_pod("low").req({"cpu": "4"}).priority(1).obj())
    first = [o.node_name for o in s.schedule_all_pending()]
    s.add_pod(w.make_pod("high").req({"cpu": "4"}).priority(100).obj())
    out = s.schedule_all_pending(wait_backoff=not veto)
    parked = sorted(s.queue._unschedulable) if side == "jax" else sorted(s.queue.unschedulable_uids())
    return (first, [(o.pod.name, o.node_name) for o in out], ex.preempt_calls, ex.calls, _binds(s), parked,
            s.builder.host_mirror_equal())


def test_extender_filters_and_scores_bind_identically():
    got, want = filters_and_scores("torch"), filters_and_scores("jax")
    assert got == want
    assert got[0] == ["n3"] and got[3]  # n3 survives the filter and gets +10×weight


def test_extender_rejection_requeues_identically():
    got, want = rejection_requeues("torch"), rejection_requeues("jax")
    assert got == want
    assert got[0] is None and got[1] == {"Extender"} and got[2] == ["default/p"]
    assert [n for n in got[3] if n]  # the node add woke the pod and it bound


def test_two_profiles_bind_identically():
    got, want = two_profiles("torch"), two_profiles("jax")
    assert got == want
    assert got[0]["gold-pod"] in ("n1", "n3") and "alien" not in got[0]


@pytest.mark.parametrize("veto", [False, True])
def test_extender_preemption_identically(veto):
    got, want = preemption("torch", veto), preemption("jax", veto)
    assert got == want
    binds = dict(got[4])
    if veto:
        assert "default/low" in binds and got[5] == ["default/high"]
    else:
        assert binds.get("default/high") == "n0" and "default/low" not in binds
    assert got[2] and got[6]


def test_extender_parked_pod_wakes_on_every_event():
    """A pod parked with {"Extender"} wakes on any cluster event, as the
    reference's queue wakes it (no plugin registers for the extender)."""
    for event in Event:
        if event is Event.ANY or event.name is None:
            continue
        s = TorchScheduler(profile=t_fit_only(), batch_size=4, device="cpu",
                           extenders=[fake_extender(text)(allow=set())])
        nodes(s, tw)
        s.add_pod(tw.make_pod("p").req({"cpu": "1"}).obj())
        s.schedule_all_pending()
        assert s.queue.unschedulable_uids() == ["default/p"]
        assert s.queue.on_event(event) == 1, event


def test_no_prefetch_on_the_extender_path():
    ex = fake_extender(text)(scores={"n2": 3})
    s = TorchScheduler(profile=t_fit_only(), batch_size=2, device="cpu", extenders=[ex])
    nodes(s, tw)
    for k in range(5):
        s.add_pod(tw.make_pod(f"p{k}").req({"cpu": "1"}).obj())
    out = s.schedule_batch()
    assert len(out) == 2 and s._prefetched is None and len(s.queue) == 3


def _http_record(side, monkeypatch):
    """One HTTPExtender's requests and parsed responses on one side."""
    ext, w, *_ = SIDES[side]
    out = {
        "filter": {"NodeNames": ["n1", "n2"], "FailedNodes": {"n0": "full"},
                   "FailedAndUnresolvableNodes": {"n3": "gone"}, "Error": ""},
        "prioritize": [{"Host": "n1", "Score": 7}, {"Host": "n2", "Score": 3}],
        "bind": {"Error": "conflict"},
        "preempt": {"NodeNameToMetaVictims": {"n1": {"Pods": [{"UID": "default/v1"}]}}},
    }
    posted = []

    def fake_post(self, verb, payload):
        posted.append((verb, json.loads(json.dumps(payload))))
        return out[verb]

    monkeypatch.setattr(ext.HTTPExtender, "_post", fake_post)
    ex = ext.HTTPExtender("http://extender.example:8888/", filter_verb="filter", prioritize_verb="prioritize",
                          bind_verb="bind", preempt_verb="preempt", weight=2,
                          managed_resources=("example.com/gpu",))
    pod = w.make_pod("p").label("app", "web").priority(5).req({"cpu": "1", "example.com/gpu": 1}).obj()
    res = ex.filter(pod, ["n0", "n1", "n2", "n3"])
    prios = ex.prioritize(pod, ["n1", "n2"])
    bound = ex.bind(pod, "n1")
    kept = ex.process_preemption(pod, {"n1": [w.make_pod("v1").obj()]})
    interested = (ex.is_interested(pod), ex.is_interested(w.make_pod("q").req({"cpu": "1"}).obj()))
    parsed = (res.node_names, res.failed_nodes, res.failed_and_unresolvable_nodes, res.error,
              [(h.host, h.score) for h in prios], bound, kept, interested, ex.name, ex.supports_preemption)
    nodes_, combined, unres = ext.run_extender_chain([ex], pod, ["n0", "n1", "n2", "n3"], {"n1": 10, "n2": 20})
    return posted, parsed, nodes_, combined, sorted(unres)


@pytest.mark.parametrize("chain", [False, True])
def test_http_extender_request_and_response(chain, monkeypatch):
    """The port's HTTPExtender posts the reference's JSON and parses its
    responses identically (``chain``: through run_extender_chain)."""
    got, want = _http_record("torch", monkeypatch), _http_record("jax", monkeypatch)
    if chain:
        assert got[2:] == want[2:]
        assert got[3] == {"n1": 24, "n2": 26} and got[4] == ["n3"]
        return
    assert got[:2] == want[:2]
    assert got[0][0] == ("filter", {"Pod": {"metadata": {"name": "p", "namespace": "default", "labels": {"app": "web"}},
                                            "spec": {"priority": 5}}, "NodeNames": ["n0", "n1", "n2", "n3"]})
    assert got[0][3] == ("preempt", {"Pod": got[0][0][1]["Pod"],
                                     "NodeNameToMetaVictims": {"n1": {"Pods": [{"UID": "default/v1"}]}}})
    assert got[1][5] is False and got[1][7] == (True, False)
