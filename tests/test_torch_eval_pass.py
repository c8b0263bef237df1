"""The port's eval-only pass and attribution pass (engine/pass_.py
build_eval_pass, build_attribution_pass; plain versions on the CPU) against
the JAX package's (kubernetes_tpu/engine/pass_.py:747-886), from
``state_from_numpy`` of the JAX builder's state and the same one-pod
batches.  The cluster is tests/test_torch_volumes.py's mixed cluster (PVs,
claims, classes, CSI limits, device users) with eight more nodes carrying
labels, taints, images, an unschedulable flag and GPU slices, bound pods
with colours, host ports, (anti-)affinity and a claim; the pods to explain
carry every feature the default profile reads, so every filter and scorer
of the default profile is active for the first of them.  A second profile
adds the learned term.

The eval pass equals JAX on ``feasible`` everywhere and on ``total`` on
the feasible nodes (the port's ``total`` is 0 elsewhere, a designed
divergence: ROADMAP §3).  The attribution pass equals JAX on ``ok_cols``,
``feasible``, ``score_cols`` and ``total`` on every node, infeasible and
padding rows included.  Tolerance: none (exact)."""

import dataclasses

import numpy as np
import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_attribution_pass as jax_attribution
from kubernetes_tpu.engine.pass_ import build_eval_pass as jax_eval
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.ops.learned import learned_scorer_profile as jax_learned_profile
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import (
    PassCache,
    build_attribution_pass,
    build_eval_pass,
    filter_op_names,
    score_op_names,
)
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.ops.learned import learned_scorer_profile as torch_learned_profile
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import state_from_numpy
from test_torch_volumes import mixed_cluster

GPU = "gpu.example.com"
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def cluster(s, t, w, seed):
    """The mixed volume cluster plus eight labelled, tainted nodes with
    images and GPUs and bound pods; returns the pods to explain."""
    rng = np.random.default_rng(seed)
    vol_pods = mixed_cluster(t, w, s.builder, s.cache, seed, crowd=True)
    for i in range(8):
        nw = w.make_node(f"x{i}").capacity({"cpu": str(4 + 4 * (i % 3)), "memory": "32Gi", "pods": 20})
        nw = nw.zone("abc"[i % 3]).label("tier", ("gold", "silver", "bronze")[i % 3])
        nw = nw.image("img-a:v1", 500_000_000 + 10_000_000 * i)
        if i % 2:
            nw = nw.image("img-b:v2", 900_000_000)
        if i % 4 == 1:
            nw = nw.taint("dedicated", "infra")
        if i % 4 == 2:
            nw = nw.taint("spot", "yes", t.EFFECT_PREFER_NO_SCHEDULE)
        if i == 7:
            nw = nw.unschedulable()
        s.add_node(nw.obj())
        if i % 2 == 0:
            devs = tuple(t.Device(name=f"gpu-{j}", attributes={"model": "h100"}) for j in range(2))
            s.add_resource_slice(t.ResourceSlice(node_name=f"x{i}", device_class=GPU, devices=devs))
    s.add_resource_claim(t.ResourceClaim(name="held", requests=(t.DeviceRequest("r0", GPU, 2),)))
    for j in range(10):
        p = w.make_pod(f"bx{j}").req({"cpu": "500m", "memory": "1Gi"}).label("color", f"c{j % 3}")
        if j % 3 == 0:
            p = p.pod_anti_affinity_in("color", [f"c{(j + 1) % 3}"], ZONE)
        if j % 4 == 1:
            p = p.host_port(8080)
        if j == 0:
            p = p.resource_claim("held")
            node = "x0"
        else:
            node = f"x{int(rng.integers(8))}" if j % 2 else f"n{int(rng.integers(18))}"
        s.add_pod(p.node(node).obj())
    for k in range(6):
        s.add_resource_claim(t.ResourceClaim(name=f"want-{k}", requests=(t.DeviceRequest("r0", GPU, 1),)))
    full = (
        w.make_pod("full").req({"cpu": "1", "memory": "2Gi"}).label("color", "c0").label("app", "web")
        .node_affinity_in(ZONE, ["a", "b"]).preferred_node_affinity_in("tier", ["gold"], 5)
        .preferred_node_affinity_in("tier", ["silver"], 2)
        .toleration("dedicated", t.TOLERATION_OP_EQUAL, "infra", t.EFFECT_NO_SCHEDULE)
        .host_port(8080).container_image("img-a:v1")
        .spread_constraint(1, ZONE, t.DO_NOT_SCHEDULE, "app", ["web"])
        .spread_constraint(2, HOST, t.SCHEDULE_ANYWAY, "color", ["c0", "c1"])
        .pod_anti_affinity_in("color", ["c2"], HOST).preferred_pod_affinity_in("color", ["c1"], ZONE, 7)
        .preferred_pod_affinity_in("color", ["c0"], ZONE, 3, anti=True)
        .resource_claim("want-0").pvc_volume("c-za").obj()
    )
    pods = [full]
    for k in range(1, 6):
        p = w.make_pod(f"q{k}").req({"cpu": str(int(rng.choice([1, 3, 6]))), "memory": "1Gi"})
        p = p.label("color", f"c{k % 3}").label("app", "web" if k % 2 else "db")
        if k % 2:
            p = p.preferred_node_affinity_in("tier", ["bronze", "gold"], k)
        if k % 3 == 1:
            p = p.pod_affinity_in("color", [f"c{(k + 1) % 3}"], ZONE)
        if k % 3 == 2:
            p = p.spread_constraint(1, ZONE, t.SCHEDULE_ANYWAY, "app", ["web"])
        if k in (2, 5):
            p = p.toleration("spot", t.TOLERATION_OP_EXISTS, "", "").container_image("img-b:v2")
        if k == 3:
            p = p.resource_claim(f"want-{k}").host_port(8080)
        if k == 4:
            p = p.pvc_volume("c-aff")
        pods.append(p.obj())
    pods.append(w.make_pod("huge").req({"cpu": "999"}).obj())
    return pods + vol_pods[:2]


def _setup(seed, learned=False):
    if learned:
        jp, tp = jax_learned_profile(), torch_learned_profile()
        j = TPUScheduler(profile=registered_subset(JDEF), batch_size=8, profiles=[jp])
        t = TorchScheduler(TDEF, batch_size=8, profiles=[tp], device="cpu")
    else:
        jp, tp = registered_subset(JDEF), TDEF
        j = TPUScheduler(profile=jp, batch_size=8)
        t = TorchScheduler(tp, batch_size=8, device="cpu")
    jpods, tpods = cluster(j, jt, jw, seed), cluster(t, tt, tw, seed)
    return j, t, jp, tp, jpods, tpods


def _one(j, t, jp, tp, jpod, tpod):
    jbatch, _jd, active = jax_batch([jpod], j.builder, jp, 1)
    tbatch, _td, tactive = torch_batch([tpod], t.builder, tp, 1)
    assert active == tactive
    jb = j.builder
    jpf = {k: np.asarray(v)[0] for k, v in jbatch.items() if k != "valid"}
    jpf["nominated_row"] = np.int32(-1)
    tbatch["nominated_row"] = np.full(1, -1, np.int32)
    jstate = jb.state()
    tstate = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)},
                              "cpu")
    inv = j._full_inv()
    tinv = {k: np.asarray(v) for k, v in inv.items()}
    tinv["image_vocab"] = len(jb.interns.images)
    return active, jstate, jpf, tstate, tbatch, inv, tinv


@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("seed", [5, 6])
def test_eval_and_attribution_passes_match_jax(seed, learned):
    j, t, jp, tp, jpods, tpods = _setup(seed, learned)
    jb = j.builder
    s = jb.schema
    if learned:
        # Every pod under the learned profile (the same pods).
        jpods = [dataclasses.replace(p, spec=dataclasses.replace(p.spec, scheduler_name=jp.name)) for p in jpods]
        tpods = [dataclasses.replace(p, spec=dataclasses.replace(p.spec, scheduler_name=tp.name)) for p in tpods]
    checked = set()
    for idx, (jpod, tpod) in enumerate(zip(jpods, tpods)):
        active, jstate, jpf, tstate, tbatch, inv, tinv = _one(j, t, jp, tp, jpod, tpod)
        if idx == 0:
            want_ops = set(tp.filters) | {n for n, _ in tp.scorers}
            assert want_ops <= active, sorted(want_ops - active)  # every op of the profile active
        jfeas, jtotal = (np.asarray(x) for x in jax_eval(jp, s, jb.res_col, active)(jstate, jpf, inv))
        tfeas, ttotal = (x.numpy() for x in build_eval_pass(tp, s, jb.res_col, active, _impl="plain")(
            tstate, tbatch, tinv))
        np.testing.assert_array_equal(tfeas, jfeas, err_msg=f"{tpod.name}: eval feasible")
        np.testing.assert_array_equal(ttotal[jfeas], jtotal[jfeas], err_msg=f"{tpod.name}: eval total")
        assert (ttotal[~jfeas] == 0).all()
        jout = [np.asarray(x) for x in jax_attribution(jp, s, jb.res_col, active)(jstate, jpf, inv)]
        tout = [x.numpy() for x in build_attribution_pass(tp, s, jb.res_col, active, _impl="plain")(
            tstate, tbatch, tinv)]
        for name, got, want in zip(("ok_cols", "feasible", "score_cols", "total"), tout, jout):
            assert got.shape == want.shape, (tpod.name, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{tpod.name}: {name}")
        assert len(jout[0]) == len(filter_op_names(tp, active))
        assert [n for n, _ in score_op_names(tp, active)] == [
            n for n, w in tp.scorers if n in active]
        np.testing.assert_array_equal(tout[1], tfeas)
        checked.add(tpod.name)
        if tpod.name == "full":
            # The columns on infeasible rows are not all zero: they are
            # the ops' own values, not the commit pass's masked ones.
            assert (~jout[1]).any() and jout[1].any()
            assert (jout[2][:, ~jout[1]] != 0).any()
            assert (~jout[0]).any(axis=1).sum() >= 5  # several filters reject somewhere
    assert "huge" in checked and len(checked) == len(jpods)


def attribution_passes(cache) -> int:
    """Attribution passes a PassCache has built."""
    return sum(1 for key in cache._cache if key[-1] == "attribution")


def test_pass_cache_builds_attribution_lazily():
    cache = PassCache("plain")
    j, t, jp, tp, jpods, tpods = _setup(5)
    s = t.builder.schema
    active, *_ = _one(j, t, jp, tp, jpods[0], tpods[0])
    cache.get(tp, s, t.builder.res_col, active, 1)
    cache.get_eval(tp, s, t.builder.res_col, active)
    assert attribution_passes(cache) == 0
    run = cache.get_attribution(tp, s, t.builder.res_col, active)
    assert cache.get_attribution(tp, s, t.builder.res_col, active) is run
    assert attribution_passes(cache) == 1
