"""spread_filter's and late_scores' split of one pod's node axis over a
thread block cluster (kubernetes_tpu_torch/kernels/csrc/spread_eval.cu),
emulated here in plain torch step for step: K CTAs a pod; each CTA builds
the constraints' compact group lists (ascending) and walks its node slice
(ceil(N/K) rows rounded up to 32) into partial (Q, DV) count and presence
tables, hostname minima and counts and a scored-node count; the K partials
are summed (hostname minima by minimum); from the sums each CTA takes the
per-constraint minimum and domain count (the filter) or topoSize and its
log weight (the score), then walks its slice again for the filter's
verdict or the raw spread score in the constraints' order; the four
reductions of the score (max NodeAffinity, max taint, min and max spread
over the scored nodes) are taken per slice and exchanged over the cluster,
then each slice normalizes.  It is held exactly against the JAX ops,
vmapped over the pods as tests/test_torch_topologyspread.py runs them:
PodTopologySpread's filter and score (kubernetes_tpu/ops/
podtopologyspread.py:219, :261), NodeAffinity's score (ops/nodeaffinity.py:
307) and TaintToleration's (ops/tainttoleration.py:56), for K in 1, 2, 4,
8, 16 on a 300-node cluster (N=512) in four zones, where the nodes on
either side of every slice boundary lack the zone key, a second key has a
domain on one slice's rows only, one hostname constraint has its minimum
on the last slice that holds nodes and a zone constraint asks for more
domains than there are; over the filter's feasible set, a random one, one
slice, every other slice, nodes that all lack a key (no scored node), one
node (max = min) and none; and at the 9·log(19) rounding boundary.
cluster_split's contract at the spread shapes and under SPREAD_SMEM_CAP
closes the file.  Tolerance: none (exact)."""

import functools

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
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import eval_spec, late_spec
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.ops import nodeaffinity as na_op
from kubernetes_tpu_torch.ops import tainttoleration as taint_op
from kubernetes_tpu_torch.ops.helpers import log_table
from kubernetes_tpu_torch.snapshot import SnapshotBuilder

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
RACK = "rack"
APPS = ["web", "db", "cache", "queue"]
SPLITS = (1, 2, 4, 8, 16)
NODES = 300
LONE = (96, 128)  # the rows of rack "lone": inside one slice for every K
NINE = 5  # the node holding the nine "nine" pods (the rounding boundary)
MAX_INT32 = 2**31 - 1
BIG = 2**62
PREFIXES = ("tps_", "na_", "taint_")


def _cluster(t, mknode, mkpod, cache):
    """300 nodes in four zones, the nodes on either side of every multiple
    of 32 without the zone key, rack "lone" on rows 96-127 and racks r0-r2
    elsewhere, disk labels and PreferNoSchedule and NoSchedule taints; 400
    bound pods of four apps, one "every" pod on each node but the last,
    nine "nine" pods on node 5.  Returns the pods to schedule."""
    rng = np.random.default_rng(11)
    for i in range(NODES):
        w = mknode(f"n{i}").capacity({"cpu": "64", "memory": "64Gi", "pods": 200})
        if i % 32 not in (0, 31):
            w = w.zone(f"z{i % 4}")
        w = w.label(RACK, "lone" if LONE[0] <= i < LONE[1] else f"r{i % 3}")
        if i % 3:
            w = w.label("disk", "ssd" if i % 3 == 1 else "hdd")
        if i % 5 == 2:
            w = w.taint("soft", "x", t.EFFECT_PREFER_NO_SCHEDULE)
        if i % 7 == 3:
            w = w.taint("soft2", "y", t.EFFECT_PREFER_NO_SCHEDULE)
        if i % 11 == 4 or i == NODES - 1:
            w = w.taint("dedicated", "gpu", t.EFFECT_NO_SCHEDULE)
        cache.add_node(w.obj())
    for j in range(400):
        w = mkpod(f"b{j}").req({"cpu": "10m"}).label("app", APPS[int(rng.integers(len(APPS)))])
        cache.add_pod(w.node(f"n{int(rng.integers(NODES))}").obj())
    for i in range(NODES - 1):
        cache.add_pod(mkpod(f"e{i}").req({"cpu": "10m"}).label("app", "every").node(f"n{i}").obj())
    for j in range(9):
        cache.add_pod(mkpod(f"nine{j}").req({"cpu": "10m"}).label("app", "nine").node(f"n{NINE}").obj())
    pods = []
    for k in range(16):
        app = APPS[k % len(APPS)]
        w = mkpod(f"p{k}").req({"cpu": "10m"}).label("app", app)
        for _ in range(int(rng.integers(1, 4))):
            topo = [ZONE, HOST, RACK][int(rng.integers(3))]
            when = t.DO_NOT_SCHEDULE if rng.integers(2) else t.SCHEDULE_ANYWAY
            w = w.spread_constraint(
                int(rng.integers(1, 3)), topo, when, "app", [APPS[int(rng.integers(len(APPS)))]],
                node_affinity_policy=t.POLICY_HONOR if rng.integers(2) else t.POLICY_IGNORE,
                node_taints_policy=t.POLICY_HONOR if rng.integers(2) else t.POLICY_IGNORE)
        if rng.random() < 0.7:
            w = w.preferred_node_affinity_in("disk", ["ssd"], weight=int(rng.integers(1, 100)))
        if rng.random() < 0.5:
            w = w.preferred_node_affinity_in(RACK, ["lone", "r1"], weight=int(rng.integers(1, 100)))
        if rng.random() < 0.5:
            w = w.toleration(key="soft", op=t.TOLERATION_OP_EXISTS, effect=t.EFFECT_PREFER_NO_SCHEDULE)
        pods.append(w.obj())
    # The rack domain on one slice's rows, both constraint kinds.
    pods.append(mkpod("rack").label("app", "web").spread_constraint(1, RACK, t.DO_NOT_SCHEDULE, "app", ["web"])
                .spread_constraint(1, RACK, t.SCHEDULE_ANYWAY, "app", ["web"]).obj())
    # A hostname minimum (0) on the last node, in the last slice that holds nodes.
    pods.append(mkpod("every").label("app", "every").spread_constraint(1, HOST, t.DO_NOT_SCHEDULE, "app", ["every"])
                .spread_constraint(2, HOST, t.SCHEDULE_ANYWAY, "app", ["every"]).obj())
    # The same with the last node's taint honoured: it is not eligible, the
    # minimum is 1.
    pods.append(mkpod("every-honor").label("app", "every").spread_constraint(
        1, HOST, t.DO_NOT_SCHEDULE, "app", ["every"], node_taints_policy=t.POLICY_HONOR).obj())
    # minDomains above the domain count, and a zone constraint on the nodes
    # missing the key at the slice boundaries.
    pods.append(mkpod("mindom").label("app", "db").spread_constraint(
        1, ZONE, t.DO_NOT_SCHEDULE, "app", ["db"], min_domains=6)
        .spread_constraint(1, ZONE, t.SCHEDULE_ANYWAY, "app", ["db"]).obj())
    # The rounding boundary: 9·log(19) = 26.49995... over 17 scored nodes.
    pods.append(mkpod("nine").label("app", "nine").spread_constraint(1, HOST, t.SCHEDULE_ANYWAY, "app", ["nine"]).obj())
    return pods


@functools.lru_cache(maxsize=None)
def _inputs():
    jb = JaxBuilder()
    jpods = _cluster(jt, jnode, jpod, JaxCache(jb))
    tb = SnapshotBuilder(device="cpu")
    tpods = _cluster(tt, tnode, tpod, TorchCache(tb))
    jprof = registered_subset(JDEF)
    jbatch, _, jactive = jax_batch(jpods, jb, jprof, len(jpods))
    tbatch, _, tactive = torch_batch(tpods, tb, TDEF, len(tpods))
    assert {"PodTopologySpread", "NodeAffinity", "TaintToleration"} <= tactive and jactive == tactive
    keys = sorted(key for key in tbatch if key.startswith(PREFIXES))
    for key in keys:
        np.testing.assert_array_equal(np.asarray(jbatch[key]), tbatch[key], err_msg=key)
    jstate, tstate = jb.state(), tb.state()
    assert tstate.valid.shape[0] == 512
    names = tstate.name_id.numpy()
    assert all(names[i] == tb.interns.node_names.get(f"n{i}") for i in range(NODES))  # node i on row i
    inv = jb.batch_invariants()
    dv = jb.schema.DV
    jdom = jax_build_dom(jstate, jnp.asarray(inv["et_slot"]), jnp.asarray(inv["et_host"]), dv)
    jctx = jcommon.PassContext(profile=jprof, schema=jb.schema, static={}, dom=jdom)
    jpf = {key: jnp.asarray(jbatch[key]) for key in keys}
    tpf = {key: torch.from_numpy(np.ascontiguousarray(tbatch[key])) for key in keys}
    tpf["valid"] = torch.ones(len(tpods), dtype=torch.bool)
    spec = eval_spec(TDEF, tb.schema, tb.res_col, tactive)
    late = late_spec(TDEF, tb.schema, tb.res_col, tactive)
    assert late.na_weight and late.taint_weight and late.spread_weight
    bits = plain.node_filters(tstate, tpf, spec.ctx)
    ops = {name: jcommon.get(name) for name in ("PodTopologySpread", "NodeAffinity", "TaintToleration")}
    jok = np.asarray(jax.vmap(lambda p: ops["PodTopologySpread"].filter(jstate, p, jctx))(jpf))
    scorers = {name: jax.vmap(lambda p, f, op=op: op.score(jstate, p, jctx, f)) for name, op in ops.items()}

    @functools.lru_cache(maxsize=None)
    def scores_of(key: bytes):
        f = jnp.asarray(np.frombuffer(key, dtype=bool).reshape(jok.shape))
        return {name: np.asarray(fn(jpf, f)) for name, fn in scorers.items()}

    def jscores(feas):
        return scores_of(np.ascontiguousarray(feas).tobytes())

    return dict(state=tstate, pf=tpf, bits=bits, late=late, jok=jok, jscores=jscores, dv=dv,
                pods=[p.metadata.name for p in tpods], valid=tstate.valid.numpy())


def slices(n: int, k: int) -> list[tuple[int, int]]:
    size = ((n + k - 1) // k + 31) // 32 * 32
    out = []
    for r in range(k):
        lo = min(n, r * size)
        out.append((lo, min(n, lo + size)))
    return out


def _pod(state, pf, bits, prefix: str, c: int):
    """One pod's constraints (the staged flags), each valid one's group
    list and per-node count, the key-presence of every node and the
    counting eligibility of each constraint (the kernel's first lines)."""
    tv = state.topo_vals.long()
    gc = state.group_counts.long()
    q_all = pf[f"{prefix}_valid"].shape[1]
    cons = []
    for q in range(q_all):
        if not pf[f"{prefix}_valid"][c, q]:
            cons.append(None)
            continue
        glist = torch.nonzero(pf[f"{prefix}_groups"][c, q]).flatten()  # the block scan's ascending list
        cons.append(dict(slot=int(pf[f"{prefix}_slot"][c, q]), skew=int(pf[f"{prefix}_skew"][c, q]),
                         mindom=int(pf[f"{prefix}_mindom"][c, q]), self=bool(pf[f"{prefix}_self"][c, q]),
                         host=bool(pf[f"{prefix}_hostname"][c, q]), aff=bool(pf[f"{prefix}_aff"][c, q]),
                         taint=bool(pf[f"{prefix}_taint"][c, q]), count=gc[glist].sum(dim=0)))
    keys = torch.ones(tv.shape[0], dtype=torch.bool)
    for k in cons:
        if k is not None:
            keys &= tv[:, k["slot"]] >= 0
    b = bits[c].long()
    for k in cons:
        if k is not None:
            k["elig"] = (state.valid & keys & ((b & 1) != 0 if k["aff"] else True)
                         & ((b & 2) != 0 if k["taint"] else True))
    return tv, cons, keys


def _max(t: torch.Tensor, empty: int) -> int:
    return int(t.max()) if t.numel() else empty


def _min(t: torch.Tensor, empty: int) -> int:
    return int(t.min()) if t.numel() else empty


def _zone_slot(state) -> int:
    """The zone key's slot: missing on row 0 (a boundary row), present on row 1."""
    tv = state.topo_vals
    return next(s for s in range(tv.shape[1]) if int(tv[0, s]) < 0 <= int(tv[1, s]))


def _partial(tv, cons, lo: int, hi: int, dv: int, counted: str, scored=None):
    """One CTA's partial tables over rows [lo, hi): per valid non-hostname
    constraint the eligible counts summed per domain and the presence of
    the ``counted`` nodes ("elig", or "scored" given) per domain; per
    hostname constraint the eligible minimum and count."""
    q_all = len(cons)
    tbl = torch.zeros((q_all, dv), dtype=torch.int64)
    pres = torch.zeros((q_all, dv), dtype=torch.bool)
    minh = torch.full((q_all,), MAX_INT32, dtype=torch.int64)
    domh = torch.zeros((q_all,), dtype=torch.int64)
    for q, k in enumerate(cons):
        if k is None:
            continue
        el = k["elig"][lo:hi]
        cnt = k["count"][lo:hi]
        if k["host"]:
            if counted == "elig" and bool(el.any()):
                minh[q] = int(cnt[el].min())
                domh[q] = int(el.sum())
            continue
        v = tv[lo:hi, k["slot"]]
        dom = (v >= 0) & (v < dv)
        add = el & dom
        tbl[q].index_add_(0, v[add], cnt[add])
        mark = add if counted == "elig" else scored[lo:hi] & dom
        pres[q, v[mark]] = True
    return tbl, pres, minh, domh


def _cluster_sum(parts):
    tbl = sum(p[0] for p in parts)
    pres = functools.reduce(torch.logical_or, (p[1] for p in parts))
    minh = functools.reduce(torch.minimum, (p[2] for p in parts))
    domh = sum(p[3] for p in parts)
    return tbl, pres, minh, domh


def emulate_filter(state, pf, bits, dv: int, k: int) -> torch.Tensor:
    """(C, N) bool: spread_filter with ``k`` CTAs a pod."""
    n = state.valid.shape[0]
    out = torch.zeros((pf["tps_h_valid"].shape[0], n), dtype=torch.bool)
    for c in range(out.shape[0]):
        tv, cons, keys = _pod(state, pf, bits, "tps_h", c)
        parts = [_partial(tv, cons, lo, hi, dv, "elig") for lo, hi in slices(n, k)]
        tbl, pres, minh, domh = _cluster_sum(parts)
        min_match = {}
        for q, kq in enumerate(cons):
            if kq is None:
                continue
            if kq["host"]:
                mn, domains = int(minh[q]), int(domh[q])
            else:
                mn = int(tbl[q][pres[q]].min()) if bool(pres[q].any()) else MAX_INT32
                domains = int(pres[q].sum())
            min_match[q] = 0 if domains < kq["mindom"] else mn
        for lo, hi in slices(n, k):  # the second walk, a slice a CTA
            ok = torch.ones(hi - lo, dtype=torch.bool)
            for q, kq in enumerate(cons):
                if kq is None:
                    continue
                v = tv[lo:hi, kq["slot"]]
                if kq["host"]:
                    match = torch.where(kq["elig"][lo:hi], kq["count"][lo:hi], 0)
                else:
                    match = torch.where((v >= 0) & (v < dv), tbl[q][v.clamp(0, dv - 1)], 0)
                ok &= (v >= 0) & (match + int(kq["self"]) - min_match[q] <= kq["skew"])
            out[c, lo:hi] = ok
    return out


def emulate_scores(state, pf, bits, feasible, dv: int, k: int):
    """late_scores' columns mode with ``k`` CTAs a pod: ((3, C, N) i64,
    NodeAffinity's, TaintToleration's and PodTopologySpread's columns as
    the ops give them; (C, N) i64 raw spread scores)."""
    n = state.valid.shape[0]
    c_all = feasible.shape[0]
    na_raw, tt_raw = na_op.raw_score(state, pf), taint_op.raw_score(state, pf)
    table = log_table(max(n, dv), "cpu")
    cols = torch.zeros((3, c_all, n), dtype=torch.int64)
    raws = torch.zeros((c_all, n), dtype=torch.int64)
    parts_of = slices(n, k)
    for c in range(c_all):
        tv, cons, keys = _pod(state, pf, bits, "tps_s", c)
        feas = feasible[c]
        scored = feas & keys
        # First walk: per CTA its partial tables, scored-node count and the
        # maxima of NodeAffinity's and the taint count over its feasible rows.
        parts = [_partial(tv, cons, lo, hi, dv, "scored", scored) for lo, hi in parts_of]
        nsc = sum(int(scored[lo:hi].sum()) for lo, hi in parts_of)
        tbl, pres, _minh, _domh = _cluster_sum(parts)
        w = {}
        for q, kq in enumerate(cons):
            if kq is not None:
                size = nsc if kq["host"] else int(pres[q].sum())
                w[q] = float(table[min(size, table.shape[0] - 1)])
        # Second walk: the raw spread score in the constraints' order, and
        # each slice's four reductions.
        red = []
        for lo, hi in parts_of:
            acc = torch.zeros(hi - lo, dtype=torch.float64)
            for q, kq in enumerate(cons):
                if kq is None:
                    continue
                v = tv[lo:hi, kq["slot"]]
                if kq["host"]:
                    cnt = kq["count"][lo:hi].double()
                else:
                    cnt = torch.where((v >= 0) & (v < dv), tbl[q][v.clamp(0, dv - 1)], 0).double()
                term = cnt * w[q] + (float(kq["skew"]) - 1.0)
                acc = acc + torch.where(v >= 0, term, 0.0)
            raw = torch.floor(acc + 0.5).long()
            raws[c, lo:hi] = raw
            f, s = feas[lo:hi], scored[lo:hi]
            red.append((max(_max(torch.where(f, na_raw[c, lo:hi], 0), 0), 0),
                        max(_max(torch.where(f, tt_raw[c, lo:hi], 0), 0), 0),
                        _min(torch.where(s, raw, BIG), BIG), max(_max(torch.where(s, raw, 0), 0), 0)))
        # One exchange over the cluster, then each slice normalizes.
        mx_na = max(r[0] for r in red)
        mx_tt = max(r[1] for r in red)
        sp_min = min(r[2] for r in red) if nsc > 0 else 0
        sp_max = max(r[3] for r in red)
        any_soft = any(kq is not None for kq in cons)
        for lo, hi in parts_of:
            na = na_raw[c, lo:hi]
            cols[0, c, lo:hi] = 0 if mx_na == 0 else torch.div(na * 100, max(mx_na, 1), rounding_mode="floor")
            ta = tt_raw[c, lo:hi]
            cols[1, c, lo:hi] = 100 if mx_tt == 0 else 100 - torch.div(ta * 100, max(mx_tt, 1),
                                                                          rounding_mode="floor")
            if any_soft:
                v = (torch.full((hi - lo,), 100, dtype=torch.int64) if sp_max == 0 else
                     torch.div(100 * (sp_max + sp_min - raws[c, lo:hi]), max(sp_max, 1), rounding_mode="floor"))
                cols[2, c, lo:hi] = torch.where(scored[lo:hi], v, 0)
    return cols, raws


@pytest.mark.parametrize("k", SPLITS)
def test_split_filter_matches_jax(k):
    x = _inputs()
    got = emulate_filter(x["state"], x["pf"], x["bits"], x["dv"], k).numpy()
    np.testing.assert_array_equal(got, x["jok"])
    valid = x["valid"]
    assert 0 < (~x["jok"][:, valid]).sum() < x["jok"][:, valid].size
    pods, jok = x["pods"], x["jok"][:, :NODES]
    # The hostname minimum (0) on the last node: every other node holds one
    # "every" pod, one above the minimum with the pod itself, so only the
    # last node passes; with its taint honoured it does not count, the
    # minimum is 1 and every node passes.
    np.testing.assert_array_equal(jok[pods.index("every")], np.arange(NODES) == NODES - 1)
    assert jok[pods.index("every-honor")].all()
    # minDomains above the four zones: the minimum is taken as 0, and every
    # zone holds "db" pods.
    assert not jok[pods.index("mindom")].any()
    # The rack constraint: "lone" (one slice's rows) is a domain of its own.
    assert jok[pods.index("rack")].any()


def _feasible(case: str, k: int, x) -> np.ndarray:
    valid = x["valid"]
    c, n = x["jok"].shape
    rng = np.random.default_rng(k)
    held = [(lo, hi) for lo, hi in slices(n, k) if valid[lo:hi].any()]
    rows = np.zeros(n, bool)
    if case == "the filter's":
        return x["jok"] & valid
    if case == "random":
        return (rng.random((c, n)) < 0.6) & valid
    if case == "one slice":
        lo, hi = held[len(held) // 2]
        rows[lo:hi] = True
    elif case == "every other slice":
        for lo, hi in held[::2]:
            rows[lo:hi] = True
    elif case == "no key (no scored node)":
        rows[[i for i in range(NODES) if i % 32 in (0, 31)]] = True
    elif case == "one node (max = min)":
        rows[int(rng.integers(NODES))] = True
    elif case == "seventeen nodes":
        rows[[NINE] + [int(r) for r in np.linspace(20, NODES - 1, 16)]] = True
    return np.broadcast_to(rows & valid, (c, n)).copy()


CASES = ["the filter's", "random", "one slice", "every other slice", "no key (no scored node)",
         "one node (max = min)", "none", "seventeen nodes"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", SPLITS)
def test_split_scores_match_jax(k, case):
    x = _inputs()
    feas = _feasible(case, k, x)
    want = x["jscores"](feas)
    cols, raws = emulate_scores(x["state"], x["pf"], x["bits"], torch.from_numpy(feas), x["dv"], k)
    for i, name in enumerate(("NodeAffinity", "TaintToleration", "PodTopologySpread")):
        np.testing.assert_array_equal(cols[i].numpy(), want[name], err_msg=name)
    # The weighted total as late_scores adds it, against the plain version.
    late = x["late"]
    base = torch.from_numpy(np.where(feas, 7, 0).astype(np.int64))
    got = torch.where(torch.from_numpy(feas), base + cols[0] * late.na_weight + cols[1] * late.taint_weight
                      + cols[2] * late.spread_weight, 0)
    f = torch.from_numpy(feas)
    np.testing.assert_array_equal(got.numpy(), plain.late_scores(x["state"], x["pf"], f, base.clone(), x["bits"],
                                                                 late).numpy())
    if case == "seventeen nodes":
        nine = x["pods"].index("nine")
        assert int(raws[nine, NINE]) == 26  # 9·log(19) = 26.49995... rounds down
    if case == "no key (no scored node)":
        pf = x["pf"]
        zone = pf["tps_s_valid"] & (pf["tps_s_slot"] == _zone_slot(x["state"]))
        pods = torch.nonzero(zone.any(dim=1)).flatten()
        assert pods.numel() and (cols[2, pods] == 0).all()


def test_split_cases_are_what_they_say():
    """The cluster puts rack "lone" on one slice's rows at every K, the
    boundary rows without the zone key, and the "every" pods everywhere
    but the last node (which is in the last slice that holds nodes)."""
    x = _inputs()
    state = x["state"]
    n = state.valid.shape[0]
    for k in SPLITS:
        inside = [r for r, (lo, hi) in enumerate(slices(n, k)) if lo <= LONE[0] and LONE[1] <= hi]
        assert len(inside) == 1
        held = [r for r, (lo, hi) in enumerate(slices(n, k)) if x["valid"][lo:hi].any()]
        lo, hi = slices(n, k)[held[-1]]
        assert lo <= NODES - 1 < hi
        for lo, hi in slices(n, k)[1:]:
            if 0 < lo < NODES:
                assert lo % 32 == 0  # rows lo - 1 and lo lack the zone key
    zone = _zone_slot(state)
    missing = torch.nonzero(state.topo_vals[:NODES, zone] < 0).flatten().tolist()
    assert missing == [i for i in range(NODES) if i % 32 in (0, 31)]


def test_cluster_split_at_the_spread_shapes():
    """K a pod at the paths' shapes on a 132-SM card: 16 at the chunk-1
    steps over 8192 rows ("spread_c1", explain, search), 8 at spread_na
    (C=8, N=1024), 16 at inclusion (C=8, N=8192), 1 pinned (one row) and
    at the daemonset batch; halved while a CTA's shared memory would pass
    SPREAD_SMEM_CAP; the shared memory a CTA is spread_smem at that K."""
    sms = 132
    assert kernels.spread_split(1, 8192, 3, 16, sms)[0] == 16
    assert kernels.spread_split(8, 1024, 3, 8, sms)[0] == 8
    assert kernels.spread_split(8, 8192, 3, 16, sms)[0] == 16
    assert kernels.spread_split(4096, 1, 0, 16, sms)[0] == 1
    assert kernels.spread_split(1, 1, 0, 16, sms)[0] == 1
    assert kernels.spread_split(256, 8192, 3, 16, sms)[0] == 1
    k, smem = kernels.spread_split(1, 8192, 3, 16, sms)
    assert smem == kernels.spread_smem(3, 16, 16) <= kernels.SPREAD_SMEM_CAP
    # Tables that fit one CTA a pod but not with the cluster's summed copy.
    q, dv = 2, 7000
    assert kernels.spread_smem(q, dv) <= kernels.SPREAD_SMEM_CAP < kernels.spread_smem(q, dv, 2)
    assert kernels.spread_split(1, 8192, q, dv, sms) == (1, kernels.spread_smem(q, dv))
    with pytest.raises(NotImplementedError, match="SPREAD_SMEM_CAP"):
        kernels.spread_split(1, 8192, 8, 4096, sms)
    for c, n in ((1, 8192), (8, 1024), (8, 8192), (64, 512), (1, 64)):
        k = kernels.spread_split(c, n, 2, 16, sms)[0]
        assert k in (1, 2, 4, 8, 16) and (k == 1 or n // k >= kernels.SPREAD_ROWS_MIN)
