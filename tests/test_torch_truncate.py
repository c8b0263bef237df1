"""Truncated (parity) mode in the port's batch pass (plain versions on the
CPU: truncate_feasible, select_host in pos mode, ipa_eval's filter and
score phases, late_scores over the truncated set) against the JAX
truncated build_pass at chunk 1 on the same state, batch, invariants, scan
order and start: picks, scores, feasible counts, fail masks, processed
counts, the post-commit state field by field, and the start the port
carries on the device against the JAX scheduler's rule (start plus the
batch's processed sum, modulo the node count).

Cases: node rows padded above the node count (N a power of two), 60, 100
and 304 nodes; a fixed percentage of 40 and the adaptive formula; the
start at 0, at nvalid − 1 and in the middle, so scans wrap; 0 feasible
nodes, 1, exactly numFeasibleNodesToFind, and all; empty identical nodes,
so every total ties and the rotated order decides; two batches with nodes
added between them, so the start carries across a change of nvalid; and
InterPodAffinity and PodTopologySpread active (a required anti-affinity,
preferred hostname affinity, DoNotSchedule and ScheduleAnyway spread,
and one node holding many pods past the cut), so the two-launch ipa_eval
and late_scores run on a truncated set whose normalization differs from
the whole feasible set's.  Also the
cache's NodeTree and order_pos against kubernetes_tpu/cache.py's after
adds and zone updates, and numFeasibleNodesToFind's edge rules.
Tolerance: none (exact)."""

import dataclasses
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import NO_POS
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import build_pass
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.snapshot import SnapshotBuilder, state_to_numpy
from test_parity import num_feasible_nodes_to_find

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
K = 8  # pods a batch: 6 real, 2 padding lanes
REAL = 6


def _nodes(mknode, n, fit, zones=4, seed=0):
    """``n`` nodes over ``zones`` zones; the rows in ``fit`` take a 3-CPU
    pod (4 CPU, or 8 on every third, for a score spread unless
    ``seed`` is None), the others (2 CPU) take none."""
    out = []
    for i in range(n):
        cpu = "2"
        if i in fit:
            cpu = "8" if seed is not None and (i + seed) % 3 == 0 else "4"
        out.append(mknode(f"n{i:03d}").capacity({"cpu": cpu, "memory": "16Gi", "pods": 20})
                   .zone(f"z{i % zones}").obj())
    return out


def _pods(mkpod, k=REAL, spread=False):
    out = []
    for j in range(k):
        w = mkpod(f"p{j}").req({"cpu": "3", "memory": "1Gi"}).label("app", f"a{j % 2}")
        if spread:
            if j % 3 == 0:
                w = w.pod_anti_affinity_in("app", [f"a{j % 2}"], HOST)
            elif j % 3 == 1:
                w = w.preferred_pod_affinity_in("app", [f"a{(j + 1) % 2}"], HOST, weight=40)
            if j % 2:
                w = w.spread_constraint(2, ZONE, tt.DO_NOT_SCHEDULE, "app", [f"a{j % 2}"])
            else:
                w = w.spread_constraint(1, HOST, tt.SCHEDULE_ANYWAY, "app", [f"a{j % 2}"])
        out.append(w.obj())
    return out


class Side:
    """One builder, cache and featurized batch of either package."""

    def __init__(self, jax_side: bool, nodes, pods, bound=()):
        self.b = JaxBuilder() if jax_side else SnapshotBuilder(device="cpu")
        self.cache = (JaxCache if jax_side else TorchCache)(self.b)
        for key in (HOST, ZONE, "topology.kubernetes.io/region"):
            self.b.ensure_topo_key(key)
        for n in nodes:
            self.cache.add_node(n)
        for p in bound:
            self.cache.add_pod(p)
        prof = registered_subset(JDEF) if jax_side else TDEF
        fn = jax_batch if jax_side else torch_batch
        self.batch, _deltas, self.active = fn(pods, self.b, prof, K)
        self.batch = dict(self.batch, nominated_row=np.full(K, -1, np.int32))


HOT = 301  # a node holding many pods: inside the scan's cut for some starts only


def _sides(n, fit, seed=0, spread=False, bound_every=0):
    """Both sides' clusters; with ``bound_every``, one bound pod on every
    such node and six on node HOT, so a score normalized over the
    truncated set differs from one over every feasible node."""
    bound = [(f"b{i}", f"n{i:03d}") for i in range(0, n, bound_every)] if bound_every else []
    if bound_every and n > HOT:
        bound += [(f"hot{i}", f"n{HOT:03d}") for i in range(6)]
    mk = lambda mkp: [mkp(name).req({"cpu": "100m"}).label("app", f"a{i % 2}").node(node).obj()  # noqa: E731
                      for i, (name, node) in enumerate(bound)]
    j = Side(True, _nodes(jnode, n, fit, seed=seed), _pods(jpod, spread=spread), mk(jpod))
    t = Side(False, _nodes(tnode, n, fit, seed=seed), _pods(tpod, spread=spread), mk(tpod))
    assert j.active == t.active
    np.testing.assert_array_equal(t.cache.order_pos(t.b.schema.N), j.cache.order_pos(j.b.schema.N))
    return j, t


def _run(j, t, pct, start, jrun=None, trun=None, seed_base=3):
    """One batch through both passes from equal states; returns the two
    compiled runs (to reuse) and the port's carried start."""
    jprof = replace(registered_subset(JDEF), percentage_of_nodes_to_score=pct)
    tprof = replace(TDEF, percentage_of_nodes_to_score=pct)
    s = j.b.schema
    if jrun is None:
        jrun = jax_build_pass(jprof, s, j.b.res_col, j.active, 1, carry_dom=True)
        trun = build_pass(tprof, t.b.schema, t.b.res_col, t.active, 1, carry_dom=True, _impl="plain")
    jinv = dict(j.b.batch_invariants(), order_pos=j.cache.order_pos(s.N), scan_start=np.uint32(start))
    jstate = j.b.state()
    tstate = t.b.state()
    got = state_to_numpy(tstate)
    for f in dataclasses.fields(jstate):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jstate, f.name)), err_msg=f.name)
    jst, jout, _ = jrun(jstate, j.batch, jinv, np.uint32(seed_base),
                        jnp.zeros((s.G, s.TK, s.DV), jnp.float32), jnp.zeros((s.ET, s.DV), jnp.float32),
                        np.bool_(False))
    scan_start = torch.tensor([start], dtype=torch.int64)
    tinv = dict(t.b.batch_invariants(), order_pos=t.cache.order_pos(s.N), scan_start=scan_start,
                scan_nodes=t.cache.node_count())
    tst, tout, _ = trun(tstate, t.batch, tinv, seed_base, None, None, False)
    for f in ("picks", "scores", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(getattr(tout, f).numpy().astype(np.int64),
                                      np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f)
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)
    j.b.absorb_device_state(jst)  # the port's pass committed in place
    nvalid = int(np.asarray(jstate.valid).sum())
    want_start = (start + int(np.asarray(jout.processed).astype(np.int64).sum())) % max(nvalid, 1)
    assert int(scan_start[0]) == want_start
    return jrun, trun, jout


def _limit(nvalid, pct):
    return num_feasible_nodes_to_find(pct, nvalid)


@pytest.mark.parametrize("n,pct", [(60, None), (100, 40), (304, None), (304, 40)])
def test_truncated_pass_matches_jax(n, pct):
    """Every density and start case on one compiled pass per shape."""
    rng = np.random.default_rng(n + (pct or 0))
    limit = _limit(n, pct)
    runs = None
    densities = {"none": 0, "one": 1, "limit": limit, "all": n}
    for dname, count in densities.items():
        fit = set(rng.choice(n, count, replace=False).tolist())
        for start in (0, n - 1, n // 2 + 7):
            for ties in (True, False):
                j, t = _sides(n, fit, seed=None if ties else 1)
                runs = _run(j, t, pct, start, *(runs[:2] if runs else ()))
                out = runs[2]
                feas = np.asarray(out.feasible_counts)[:REAL]
                assert feas.max() <= limit
                if count == 0:
                    assert (np.asarray(out.picks)[:REAL] == -1).all()
                if dname == "all" and limit < n:
                    assert feas[0] == limit  # the cut really happened
                assert (np.asarray(out.processed)[REAL:] == 0).all()  # padding lanes


def test_start_carries_across_batches_as_nvalid_changes():
    """Two batches with 40 nodes added between them: the start the pass
    carried in the first batch feeds the second under the new count."""
    n = 150
    fit = set(range(0, n, 2))
    j, t = _sides(n, fit)
    _jr, _tr, jout = _run(j, t, None, n - 5)
    start = (n - 5 + int(np.asarray(jout.processed).sum())) % n
    for side, mk in ((j, jnode), (t, tnode)):
        for i in range(n, n + 40):
            side.cache.add_node(mk(f"n{i:03d}").capacity({"cpu": "4", "memory": "16Gi", "pods": 20})
                                .zone(f"z{i % 5}").obj())
    np.testing.assert_array_equal(t.cache.order_pos(t.b.schema.N), j.cache.order_pos(j.b.schema.N))
    _run(j, t, None, start)


def test_truncated_pass_with_affinity_and_spread_matches_jax():
    """InterPodAffinity (required anti-affinity, preferred hostname
    affinity) and PodTopologySpread (DoNotSchedule by zone, ScheduleAnyway
    by hostname) active: the IPA filter runs before the cut and its score
    after it, beside late_scores, over the truncated set; node HOT lies
    past the cut from start 0 and inside it from start 250."""
    n = 304
    fit = set(range(n)) - set(range(0, n, 9))
    runs = None
    for pct, start in ((None, 0), (None, 250), (None, n - 1)):
        j, t = _sides(n, fit, seed=2, spread=True, bound_every=5)
        assert {"InterPodAffinity", "PodTopologySpread"} <= t.active
        runs = _run(j, t, pct, start, *(runs[:2] if runs else ()))
        assert (np.asarray(runs[2].feasible_counts)[:REAL] <= _limit(n, pct)).all()
    _run(*_sides(n, fit, seed=2, spread=True, bound_every=5), 40, 17)


def test_plain_truncate_and_pos_select_edges():
    """truncate_feasible and select_host(pos) alone on hand-made rows:
    the floor modulo, a start at nvalid − 1, rows off the node set, and
    the k-th tie in rotated order rather than row order."""
    n = 16
    valid = torch.zeros(n, dtype=torch.bool)
    valid[:10] = True
    order_pos = torch.full((n,), NO_POS, dtype=torch.int32)
    order_pos[:10] = torch.tensor([3, 7, 0, 9, 1, 5, 2, 8, 4, 6], dtype=torch.int32)
    feasible = valid[None, :].clone()
    start = torch.tensor([9], dtype=torch.int64)
    f, pos, processed = plain.truncate_feasible(feasible, valid, order_pos, start, torch.tensor([True]),
                                                *plain.scan_counts(10, 0))
    # Below 100 nodes every node is scanned and kept.
    assert f.sum() == 10 and processed.tolist() == [10] and int(start[0]) == (9 + 10) % 10
    assert pos[:10].tolist() == [(p - 9) % 10 for p in order_pos[:10].tolist()]
    assert (pos[10:] == NO_POS).all()
    total = torch.zeros((1, n), dtype=torch.int64)
    steps = torch.tensor([5], dtype=torch.int64)
    pick, best, cnt = plain.select_host(f, total, steps, 0, None, pos)
    kth = int(plain.hash_u32(steps)[0]) % 10
    assert int(pos[pick[0]]) == kth and int(cnt[0]) == 10 and int(best[0]) == 0
    row_pick, _b, _c = plain.select_host(f, total, steps, 0, None)
    assert int(row_pick[0]) == kth  # row order: the kth row


@pytest.mark.parametrize("nvalid", [0, 1, 99, 100, 101, 304, 1000, 5000, 6000, 20000])
@pytest.mark.parametrize("pct", [None, 0, 5, 40, 100])
def test_num_to_find_matches_the_reference_formula(nvalid, pct):
    got = int(plain.num_to_find(torch.tensor(nvalid, dtype=torch.int32), pct or 0))
    assert got == num_feasible_nodes_to_find(pct, nvalid)


def test_node_tree_and_order_pos_match_jax_cache():
    """Zone-interleaved lists and positions after adds, a zone change and
    a label-only update; the order is cached per cache generation."""
    jb, tb = JaxBuilder(), SnapshotBuilder(device="cpu")
    jc, tc = JaxCache(jb), TorchCache(tb)
    for i in range(23):
        zone = f"z{(i * 7) % 4}" if i % 5 else ""
        for c, mk in ((jc, jnode), (tc, tnode)):
            w = mk(f"m{i}").capacity({"cpu": "4", "memory": "8Gi"})
            c.add_node((w.zone(zone) if zone else w).obj())
    assert tc.node_tree.list() == jc.node_tree.list()
    first = tc.order_pos(32)
    assert tc.order_pos(32) is first  # cached
    np.testing.assert_array_equal(first, jc.order_pos(32))
    for c, mk in ((jc, jnode), (tc, tnode)):
        c.update_node(mk("m3").capacity({"cpu": "4", "memory": "8Gi"}).zone("z9").obj())
        c.update_node(mk("m4").capacity({"cpu": "4", "memory": "8Gi"}).zone("z1").label("a", "b").obj())
        c.add_node(mk("late").capacity({"cpu": "4", "memory": "8Gi"}).zone("z0").obj())
    assert tc.node_tree.list() == jc.node_tree.list()
    np.testing.assert_array_equal(tc.order_pos(32), jc.order_pos(32))
    assert sorted(tc.order_pos(32)[:24].tolist()) == list(range(24))
    tc.node_tree.remove("z9", "m3")
    jc.node_tree.remove("z9", "m3")
    tc.node_tree.remove("z9", "absent")
    assert tc.node_tree.list() == jc.node_tree.list() and "z9" not in tc.node_tree.zones


def test_chunk_above_one_refused():
    prof = replace(TDEF, percentage_of_nodes_to_score=None)
    tb = SnapshotBuilder(device="cpu")
    with pytest.raises(ValueError, match="chunk_size=1"):
        build_pass(prof, tb.schema, tb.res_col, None, 8)
