"""The port's pinned-batch pass (plain versions on the CPU: node_filters,
eval_chunk and late_scores in pinned mode, pinned_fit and a strict
resolve_commit) against the JAX ``build_pinned_pass`` on the same state,
batch and invariants: picks (same-row deferrals included), feasible
counts, fail masks, the scores of the feasible pods and the post-commit
state field by field must be equal.  The batch mixes pods pinned to rows their own node affinity
rejects, pins that name no node, padding lanes, nominated pins with the
nominated-pod overlay, NoSchedule and PreferNoSchedule taints, preferred
node-affinity weights and several pods pinned to one row that overflow
its CPU or its pod slots.  ``pinned_fit``'s plain version is also held
against a sequential walk of the rule.  Tolerance: none (exact)."""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_pinned_pass as jax_pinned_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import PINNED_SAFE_OPS, build_pinned_pass
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.snapshot import SnapshotBuilder, state_to_numpy

from test_torch_topologyspread import _node_affinity

K = 32  # 24 pods and 8 padding lanes
NODES = 12


def _cluster(mknode, mkpod, t, cache, seed):
    """12 nodes of 4 CPU and 6 pod slots with labels and taints, 20 bound
    pods; returns 24 pods to schedule."""
    rng = np.random.default_rng(seed)
    for i in range(NODES):
        w = mknode(f"n{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 6}).zone(f"z{i % 3}")
        w = w.label("disk", "ssd" if i % 2 else "hdd").label("num", str(i * 7 % 50))
        if i % 4 == 1:
            w = w.taint("dedicated", "gpu", t.EFFECT_NO_SCHEDULE)
        if i % 5 == 2:
            w = w.taint("soft", "x", t.EFFECT_PREFER_NO_SCHEDULE)
        if i == 7:
            w = w.unschedulable()
        cache.add_node(w.obj())
    for j in range(20):
        cache.add_pod(mkpod(f"b{j}").req({"cpu": "500m"}).node(f"n{int(rng.integers(NODES))}").obj())
    pods = []
    for k in range(24):
        w = mkpod(f"p{k}").req({"cpu": f"{int(rng.choice([250, 1000, 1500]))}m", "memory": "1Gi"})
        w = w.priority(int(rng.integers(0, 3)) * 50)
        if rng.random() < 0.5:
            w = _node_affinity(w, t, rng)
        if rng.random() < 0.4:
            key = ["dedicated", "soft"][int(rng.integers(2))]
            w = w.toleration(key=key, op=t.TOLERATION_OP_EXISTS)
        pods.append(w.obj())
    return pods


def _inputs(seed):
    """Both builders over the cluster, the batch featurized by each, the
    pins and nominations, and the invariants with a nominated-pod overlay."""
    jb, tb = JaxBuilder(), SnapshotBuilder(device="cpu")
    jpods = _cluster(jnode, jpod, jt, JaxCache(jb), seed)
    tpods = _cluster(tnode, tpod, tt, TorchCache(tb), seed)
    jprof, tprof = registered_subset(JDEF), TDEF
    jbatch, _, jactive = jax_batch(jpods, jb, jprof, K)
    tbatch, _, tactive = torch_batch(tpods, tb, tprof, K)
    assert jactive == tactive and tactive <= PINNED_SAFE_OPS
    assert {"NodeAffinity", "TaintToleration"} <= tactive
    rng = np.random.default_rng(seed + 100)
    # Pins: a few rows shared by many pods (same-row overflow), one pin
    # that names no node; a third of the pods nominated to their pin.
    pin = rng.choice([0, 2, 2, 3, 3, 3, 5, 7, 9, 9, 10, -1], size=K).astype(np.int32)
    nom = np.where(rng.random(K) < 0.35, pin, -1).astype(np.int32)
    nom[5] = 4  # a nomination that is not the pin
    pin[24:] = -1
    for batch in (jbatch, tbatch):
        batch["pin_row"] = pin.copy()
        batch["nominated_row"] = nom.copy()
    inv = jb.batch_invariants()
    s = jb.schema
    inv["nom_req"] = np.zeros((s.N, s.R), np.int64)
    inv["nom_cnt"] = np.zeros(s.N, np.int32)
    inv["nom_prio"] = np.full(s.N, -(2**31), np.int32)
    for row in (3, 9):
        inv["nom_req"][row, 0] = 1000
        inv["nom_cnt"][row] = 1
        inv["nom_prio"][row] = 50
    assert dataclasses.asdict(jb.schema) == dataclasses.asdict(tb.schema)
    return dict(jb=jb, tb=tb, jprof=jprof, tprof=tprof, jbatch=jbatch, tbatch=tbatch,
                active=tactive, inv=inv)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_pinned_pass_matches_jax(seed):
    x = _inputs(seed)
    jb, tb, inv = x["jb"], x["tb"], x["inv"]
    jrun = jax_pinned_pass(x["jprof"], jb.schema, jb.res_col, x["active"])
    jst, jout = jrun(jb.state(), x["jbatch"], inv)
    trun = build_pinned_pass(x["tprof"], tb.schema, tb.res_col, x["active"], _impl="plain")
    tst, tout = trun(tb.state(), x["tbatch"], {k: torch.from_numpy(v) for k, v in inv.items()})
    for f in ("picks", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64),
            err_msg=f)
    # Scores of the feasible pods; an infeasible pod's score, which no
    # caller reads, is 0 in the port and the raw sum in the JAX pass.
    feas = np.asarray(jout.feasible_counts) > 0
    np.testing.assert_array_equal(tout.scores.numpy()[feas], np.asarray(jout.scores)[feas])
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)
    picks = np.asarray(jout.picks)
    assert (picks >= 0).any() and (picks == -2).any() and (picks[:24] == -1).any()
    assert np.asarray(jout.fail_masks)[:24].any()


def _walk(own_ok, pin, valid, req, alloc, used, num_pods, allowed):
    """The same-row rule one pod at a time, in batch order."""
    picks, feas = [], []
    for i in range(len(pin)):
        f = bool(valid[i] and pin[i] >= 0 and own_ok[i])
        feas.append(int(f))
        if not f:
            picks.append(-1)
            continue
        mates = [j for j in range(i + 1) if pin[j] == pin[i] and valid[j] and own_ok[j]]
        within = req[mates].sum(axis=0)
        free = alloc[pin[i]] - used[pin[i]]
        fits = all(req[i, r] == 0 or within[r] <= free[r] for r in range(req.shape[1]))
        fits = fits and num_pods[pin[i]] + len(mates) <= allowed[pin[i]]
        picks.append(pin[i] if fits else -2)
    return np.array(picks), np.array(feas)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_pinned_fit_matches_a_sequential_walk(seed):
    x = _inputs(3)
    state = x["tb"].state()
    rng = np.random.default_rng(seed)
    pin = rng.integers(-1, 6, size=K).astype(np.int32)
    own_ok = rng.random(K) < 0.8
    valid = rng.random(K) < 0.9
    req = rng.choice([0, 500, 1500], size=(K, state.alloc.shape[1])).astype(np.int64)
    got = plain.pinned_fit(torch.from_numpy(own_ok), torch.from_numpy(pin), torch.from_numpy(valid),
                           torch.from_numpy(req), state)
    want = _walk(own_ok, pin, valid, req, state.alloc.numpy(), state.req.numpy(),
                 state.num_pods.numpy(), state.allowed_pods.numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert (want[0] == -2).any() and (want[0] >= 0).any()


def test_daemonset_cut_matches_jax():
    """daemonset_15kn (harness.py:816-850) cut to 40 nodes, 16 warm-up and
    40 measured daemon pods, plus two pinned to a node that does not
    exist, batch 32, chunk 8: every batch takes the pinned pass on both
    schedulers and the bindings are equal."""
    from kubernetes_tpu.benchmarks import harness
    from kubernetes_tpu.scheduler import TPUScheduler
    from kubernetes_tpu_torch import workloads as tw
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    j = TPUScheduler(profile=registered_subset(JDEF), batch_size=32, chunk_size=8)
    harness._basic_nodes(40)(j)
    t = TorchScheduler(TDEF, batch_size=32, chunk_size=8, device="cpu")
    for n in tw.basic_nodes(40):
        t.add_node(n)
    out = {}
    for s, mk in ((j, lambda name, i: harness.make_pod(name).req({"cpu": "100m", "memory": "128Mi"})
                   .node_name_affinity(f"node-{i}").obj()), (t, tw.daemon_pod)):
        for i in range(16):
            s.add_pod(mk(f"warm-{i}", i))
        got = s.schedule_all_pending()
        for i in range(40):
            s.add_pod(mk(f"ds-{i}", i))
        s.add_pod(mk("ds-ghost-a", 999))
        s.add_pod(mk("ds-ghost-b", 999))
        got += s.schedule_all_pending()
        out[s is t] = [(o.pod.name, o.node_name, o.feasible_nodes) for o in got]
    assert out[True] == out[False]
    assert t.pinned_batches == j.metrics.pinned_batches == 3
    assert ("ds-ghost-a", None, 0) in out[True] and ("ds-7", "node-7", 1) in out[True]
    assert t.builder.host_mirror_equal()
