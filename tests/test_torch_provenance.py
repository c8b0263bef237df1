"""Decision provenance in the port (kubernetes_tpu_torch/framework/
provenance.py, TorchScheduler.arm_provenance and explain_pod, the
attribution pass's plain versions) side by side with the JAX package's,
on the golden scenario of scripts/gen_golden_transcripts.py
(``scenario_objects``: 4 nodes, 4 bound pods, easy, picky, vip which
preempts and huge which fits nowhere), its objects converted field for
field (``to_torch``), under both golden session profiles: every pod's
explain record equals TPUScheduler's as JSON, armed and unarmed; every
recorded capsule equals the reference's; vip's preemption rationale rides
its record; huge's rejecting plugin is NodeResourcesFit on every node;
unarmed runs bind as armed ones and build no attribution pass; journal
mode without a journal returns the reference's error.  Both schedulers
run without a journal, so explain_pod explains in current mode on both
sides.  Tolerance: none (exact)."""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from gen_golden_transcripts import scenario_objects, session_schedulers  # noqa: E402

from kubernetes_tpu.api import serialize  # noqa: E402
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch  # noqa: E402
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch  # noqa: E402
from kubernetes_tpu_torch.framework import provenance as tprov  # noqa: E402
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF  # noqa: E402
from kubernetes_tpu_torch.framework.config import fit_only_profile  # noqa: E402
from kubernetes_tpu_torch.queue import SchedulingQueue  # noqa: E402
from kubernetes_tpu_torch.scheduler import TorchScheduler  # noqa: E402
from test_torch_eval_pass import attribution_passes  # noqa: E402
from test_torch_parity_default import to_torch  # noqa: E402

STEMS = ("basic_session", "default_session")
PENDING = ("default/easy", "default/picky", "default/vip", "default/huge")
ALL_UIDS = tuple(f"default/bound-{i}" for i in range(4)) + (
    "default/easy", "default/picky", "default/vip", "default/huge")


class FakeClock:
    """A queue clock that moves only when the drive steps it."""

    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def torch_session(stem: str, clock) -> TorchScheduler:
    """The port's twin of session_schedulers()[stem], with the reference's
    1 s doubling backoff on ``clock``."""
    profile, batch = (fit_only_profile(), 8) if stem == "basic_session" else (TDEF, 32)
    return TorchScheduler(profile=profile, batch_size=batch, chunk_size=1, device="cpu",
                          queue=SchedulingQueue(backoff=True, clock=clock))


def run(stem: str, side: str, arm: bool):
    """The golden scenario through one scheduler, both queues on a fake
    clock stepped to each backoff expiry once nothing else is pending, so
    both sides pop the same batches (the wall clock would let a retry land
    in whichever drain a run's speed put it)."""
    clock = FakeClock()
    if side == "jax":
        sched = session_schedulers()[stem]()
        sched.queue._clock = clock
    else:
        sched = torch_session(stem, clock)
    nodes, bound, pending = scenario_objects()
    conv = (lambda x: x) if side == "jax" else to_torch
    for n in nodes:
        sched.add_node(conv(n))
    for p in bound:
        sched.add_pod(conv(p))
    if arm:
        sched.arm_provenance()
    for p in pending:
        sched.add_pod(conv(p))
    for _ in range(50):
        sched.schedule_all_pending()
        expiry = sched.queue.next_backoff_expiry()
        if expiry is None:
            break
        clock.now = max(clock.now, expiry)
    return sched


def bindings_of(sched) -> dict:
    return {uid: pr.node_name for uid, pr in sorted(sched.cache.pods.items()) if pr.bound}


@pytest.fixture(scope="module")
def sessions():
    return {(stem, side, arm): run(stem, side, arm) for stem in STEMS for side in ("jax", "torch")
            for arm in (False, True)}


@pytest.mark.parametrize("arm", [False, True])
@pytest.mark.parametrize("stem", STEMS)
def test_explain_records_equal_the_reference(sessions, stem, arm):
    j, t = sessions[(stem, "jax", arm)], sessions[(stem, "torch", arm)]
    assert bindings_of(t) == bindings_of(j)
    explained = 0
    for uid in ALL_UIDS:
        want, got = j.explain_pod(uid), t.explain_pod(uid)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), uid
        if uid not in t.cache.pods and uid not in t.queue._info:
            assert got["error"].startswith("unknown pod"), uid  # evicted by vip's preemption
            continue
        explained += 1
        assert tprov.diff_records(got, want) is None
        # Armed, a placed pod's record carries its live decision.
        assert (got["decision"] is not None) == (arm and uid in bindings_of(t) and uid in PENDING), uid
    assert explained >= 7
    assert t.explain_pod("default/nobody") == j.explain_pod("default/nobody")


@pytest.mark.parametrize("stem", STEMS)
def test_capsules_equal_the_reference(sessions, stem):
    j, t = sessions[(stem, "jax", True)], sessions[(stem, "torch", True)]
    assert len(t.provenance) == len(j.provenance) >= 2
    assert t.provenance.recorded == j.provenance.recorded
    for uid in ALL_UIDS:
        jc, tc = j.provenance.get(uid), t.provenance.get(uid)
        assert (jc is None) == (tc is None), uid
        if jc is not None:
            assert tc.as_dict() == jc.as_dict(), uid


def test_preemption_rationale_rides_the_record(sessions):
    t = sessions[("default_session", "torch", True)]
    rec = t.explain_pod("default/vip")
    pre = rec["decision"]["preemption"]
    assert pre and pre["victims"] and pre["node"] == rec["bound_node"]
    assert pre == sessions[("default_session", "jax", True)].explain_pod("default/vip")["decision"]["preemption"]


@pytest.mark.parametrize("stem", STEMS)
def test_unschedulable_pod_names_the_rejecting_plugin(sessions, stem):
    rec = sessions[(stem, "torch", False)].explain_pod("default/huge")
    assert not any(rec["feasible"]) and rec["picked_node"] is None
    assert set(rec["first_reject"]) == set(rec["nodes"])
    assert set(rec["first_reject"].values()) == {"NodeResourcesFit"}
    assert "unarmed" in rec.get("note", "")


@pytest.mark.parametrize("stem", STEMS)
def test_unarmed_runs_bind_identically_and_build_no_attribution_pass(stem):
    a, b = run(stem, "torch", False), run(stem, "torch", True)
    assert bindings_of(a) == bindings_of(b)
    assert a.provenance is None and len(b.provenance) >= 2
    assert attribution_passes(a.passes) == 0 and attribution_passes(b.passes) == 0
    a.explain_pod("default/easy")
    assert attribution_passes(a.passes) == 1


def test_journal_mode_returns_the_reference_error(sessions):
    j, t = sessions[("basic_session", "jax", True)], sessions[("basic_session", "torch", True)]
    assert t.explain_pod("default/easy", mode="journal") == j.explain_pod("default/easy", mode="journal")
    assert "error" in t.explain_pod("default/easy", mode="journal")
    # An explicit seq falls back to current mode without a journal.
    got, want = t.explain_pod("default/easy", seq=5), j.explain_pod("default/easy", seq=5)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["mode"] == "current"


@pytest.mark.parametrize("stem", STEMS)
def test_stripped_copy_featurizes_like_the_reference_round_trip(sessions, stem):
    """explain_pod strips a placed pod's binding on a deep copy where the
    reference round-trips it through api/serialize: both featurize alike."""
    j, t = sessions[(stem, "jax", False)], sessions[(stem, "torch", False)]
    for uid in ALL_UIDS:
        if uid not in j.cache.pods:
            continue
        jp = serialize.pod_from_data(serialize.to_dict(j.cache.pods[uid].pod))
        jp.spec.node_name = ""
        tp = copy.deepcopy(t.cache.pods[uid].pod)
        tp.spec.node_name = ""
        assert dataclasses.asdict(tp) == dataclasses.asdict(to_torch(jp)), uid
        jbatch, _jd, jactive = jax_batch([jp], j.builder, j._profile_for(jp) or j.profile, 1)
        tbatch, _td, tactive = torch_batch([tp], t.builder, t._profile_for(tp) or t.profile, 1)
        assert jactive == tactive
        for key in tbatch:
            np.testing.assert_array_equal(np.asarray(tbatch[key]), np.asarray(jbatch[key]), err_msg=key)
