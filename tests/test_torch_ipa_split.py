"""ipa_eval's split of one pod's node axis over a thread block cluster
(kubernetes_tpu_torch/kernels/csrc/ipa_eval.cu), emulated here in plain
torch step for step: K CTAs a pod; CTA r scans groups [r*G/K, (r+1)*G/K)
of each own-term mask and existing terms [r*ET/K, (r+1)*ET/K) into partial
tables and its segment of each compact list, the K partial tables summed;
the lonely-pod rule's hostname count summed over each CTA's node slice
(ceil(N/K) rows rounded up to 32) and then over the cluster; the filter
and raw score per node from the summed tables and the segmented lists; the
normalisation's (min, max) taken per slice and exchanged over the cluster,
then the int64 floor division on each slice.  It is held against the JAX
op's filter and score (kubernetes_tpu/ops/interpodaffinity.py:283, :304)
vmapped over the pods, as tests/test_torch_interpodaffinity.py runs them,
for K in 1, 2, 4, 8, 16 on a 300-node cluster in four zones (N=512, some
nodes without the zone key) with zone and hostname terms of every kind:
on the filter's feasible set, a random one, a feasible set inside one
slice only, every other slice empty, none feasible, and one feasible node
(min = max); and the lonely-pod rule with the matching pods in one slice
or in none.  Tolerance: none (exact)."""

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
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import build_dom
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.snapshot import SnapshotBuilder

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
APPS = ["web", "db", "cache", "batch"]
SPLITS = (1, 2, 4, 8, 16)
NODES = 300
BIG = 2**62


def _pod_terms(w, rng, host_share: float):
    for _ in range(int(rng.integers(0, 4))):
        kind = int(rng.integers(0, 5))
        target = APPS[int(rng.integers(len(APPS)))]
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
        else:
            app = w.obj().metadata.labels.get("app", target)
            w = w.pod_affinity_in("app", [app], topo)  # self-matching: the lonely-pod rule
    return w


def _cluster(mknode, mkpod, cache):
    """300 nodes in 4 zones (every 13th without the zone key), 500 bound
    pods with random terms, the "solo" pods on the last slice's nodes only;
    returns the incoming pods: random ones and the lonely-rule cases."""
    rng = np.random.default_rng(3)
    for i in range(NODES):
        w = mknode(f"n{i}").capacity({"cpu": "64", "memory": "64Gi", "pods": 200})
        if i % 13 != 5:
            w = w.zone(f"z{i % 4}")
        cache.add_node(w.obj())
    for j in range(500):
        w = mkpod(f"b{j}").req({"cpu": "10m"}).label("app", APPS[int(rng.integers(len(APPS)))])
        w = _pod_terms(w, rng, 0.5)
        cache.add_pod(w.node(f"n{int(rng.integers(NODES))}").obj())
    for j in range(6):  # matching pods on nodes of the last rows only
        cache.add_pod(mkpod(f"s{j}").req({"cpu": "10m"}).label("app", "solo").node(f"n{NODES - 1 - j}").obj())
    pods = []
    for k in range(24):
        w = mkpod(f"p{k}").req({"cpu": "10m"}).label("app", APPS[k % len(APPS)])
        pods.append(_pod_terms(w, rng, 0.5).obj())
    pods.append(mkpod("solo").label("app", "solo").pod_affinity_in("app", ["solo"], HOST).obj())
    pods.append(mkpod("lonely").label("app", "alone").pod_affinity_in("app", ["alone"], HOST).obj())
    pods.append(mkpod("lonely-zone").label("app", "alone").pod_affinity_in("app", ["alone"], ZONE)
                .preferred_pod_affinity_in("app", ["solo"], HOST, weight=5).obj())
    pods.append(mkpod("not-self").pod_affinity_in("app", ["alone"], HOST).obj())
    return pods


@functools.lru_cache(maxsize=None)
def _inputs():
    jb = JaxBuilder()
    jpods = _cluster(jnode, jpod, JaxCache(jb))
    tb = SnapshotBuilder(device="cpu")
    tpods = _cluster(tnode, tpod, TorchCache(tb))
    jbatch, _, jactive = jax_batch(jpods, jb, registered_subset(JDEF), len(jpods))
    tbatch, _, tactive = torch_batch(tpods, tb, TDEF, len(tpods))
    assert "InterPodAffinity" in jactive and jactive == tactive
    keys = sorted(key for key in tbatch if key.startswith("ipa_"))
    for key in keys:
        np.testing.assert_array_equal(np.asarray(jbatch[key]), tbatch[key], err_msg=key)
    inv = tb.batch_invariants()
    jstate, tstate = jb.state(), tb.state()
    dv = tb.schema.DV
    jdom = jax_build_dom(jstate, jnp.asarray(inv["et_slot"]), jnp.asarray(inv["et_host"]), dv)
    tdom = build_dom(tstate, torch.from_numpy(inv["et_slot"]), torch.from_numpy(inv["et_host"]), dv)
    jctx = jcommon.PassContext(profile=registered_subset(JDEF), schema=jb.schema, static={}, dom=jdom)
    jpf = {key: jnp.asarray(jbatch[key]) for key in keys}
    tpf = {key: torch.from_numpy(np.ascontiguousarray(tbatch[key])) for key in keys}
    jop = jcommon.get("InterPodAffinity")
    jok = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, jctx))(jpf))
    score = jax.jit(jax.vmap(lambda p, f: jop.score(jstate, p, jctx, f)))
    return tstate, tdom, tpf, jok, lambda feas: np.asarray(score(jpf, jnp.asarray(feas))), np.asarray(jstate.valid)


def slices(n: int, k: int) -> list[tuple[int, int]]:
    size = ((n + k - 1) // k + 31) // 32 * 32
    out = []
    for r in range(k):
        lo = min(n, r * size)
        out.append((lo, min(n, lo + size)))
    return out


def segments(length: int, k: int) -> list[tuple[int, int]]:
    seg = -(-length // k)
    return [(min(length, r * seg), min(length, r * seg + seg)) for r in range(k)]


def emulate(state, dom, pf, k: int):
    """Per pod: (ok (N,) bool: the filter's own verdict on every node, raw
    (N,) i64, the lonely-pod total) as the kernel computes them with ``k``
    CTAs a pod."""
    gc, ec = state.group_counts.long(), state.et_counts.long()
    tv = state.topo_vals.long()
    n, tk = tv.shape
    g, et = gc.shape[0], ec.shape[0]
    gd, ed = dom.group_dom, dom.et_dom
    dv = gd.shape[2]
    et_slot, et_host = dom.et_slot.long(), dom.et_host
    gsegs, esegs, nslices = segments(g, k), segments(et, k), slices(n, k)
    rows = torch.arange(n)

    def at_slot(table, slot):  # table (DV,) read at every node's value of the slot, 0 off [0, DV)
        v = tv[:, slot]
        ok = (v >= 0) & (v < dv)
        return torch.where(ok, table[v.clamp(0, dv - 1)], 0)

    def own(mask, slot):
        """The segmented compact list and the summed partial tallies of
        one own-term mask: (per-node count over the K segments, (DV,) table)."""
        lists = [torch.nonzero(mask[g0:g1]).flatten() + g0 for g0, g1 in gsegs]
        parts = [gd[lst, slot].sum(dim=0).long() for lst in lists]  # each CTA's partial tally
        count = sum(gc[lst].sum(dim=0) for lst in lists)
        return count, sum(parts)

    out = []
    for c in range(pf["ipa_ra_valid"].shape[0]):
        p = {key: v[c] for key, v in pf.items()}
        # Existing terms: each CTA's segment into partial (TK, DV) tables and list segments.
        forb = torch.zeros((tk, dv), dtype=torch.int64)
        wsum = torch.zeros((tk, dv), dtype=torch.int64)
        anti_host, w_host = [], []
        for e0, e1 in esegs:
            for e in range(e0, e1):
                if not p["ipa_et_match"][e]:
                    continue
                slot = int(et_slot[e])
                if p["ipa_et_anti"][e]:
                    if et_host[e]:
                        anti_host.append(e)
                    else:
                        forb[slot] += (ed[e] > 0.5).long()
                w = int(p["ipa_et_w"][e])
                if w:
                    if et_host[e]:
                        w_host.append(e)
                    else:
                        wsum[slot] += w * ed[e].long()
        ok = torch.ones(n, dtype=torch.bool)
        for kk in range(tk):
            ok &= at_slot(forb[kk], kk) == 0
        for e in anti_host:
            ok &= ~((ec[e] > 0) & (tv[:, et_slot[e]] >= 0))
        # (2) Required affinity, with the lonely-pod total summed over the node slices.
        ra = [t for t in range(p["ipa_ra_valid"].shape[0]) if p["ipa_ra_valid"][t]]
        tot = 0
        if ra:
            keys_ok = torch.ones(n, dtype=torch.bool)
            exist = torch.ones(n, dtype=torch.bool)
            host_total = torch.zeros(n, dtype=torch.int64)
            for t in ra:
                slot = int(p["ipa_ra_slot"][t])
                count, tbl = own(p["ipa_ra_allmask"], slot)
                key = tv[:, slot] >= 0
                keys_ok &= key
                if p["ipa_ra_host"][t]:
                    at = torch.where(key, count, 0)
                    host_total += at
                else:
                    at = at_slot(tbl, slot)
                    tot += int(tbl.sum())
                exist &= at > 0
            tot += sum(int(host_total[lo:hi].sum()) for lo, hi in nslices)  # each CTA's slice, then the cluster
            lonely = tot == 0 and bool(p["ipa_ra_self"])
            ok &= keys_ok & (exist | lonely)
        # (3) Required anti-affinity.
        for t in range(p["ipa_rs_valid"].shape[0]):
            if not p["ipa_rs_valid"][t]:
                continue
            slot = int(p["ipa_rs_slot"][t])
            count, tbl = own(p["ipa_rs_groups"][t], slot)
            at = count if p["ipa_rs_host"][t] else at_slot(tbl, slot)
            ok &= ~((tv[:, slot] >= 0) & (at > 0))
        # Raw score.
        raw = torch.zeros(n, dtype=torch.int64)
        for t in range(p["ipa_pf_valid"].shape[0]):
            if not p["ipa_pf_valid"][t]:
                continue
            slot = int(p["ipa_pf_slot"][t])
            count, tbl = own(p["ipa_pf_groups"][t], slot)
            at = count if p["ipa_pf_host"][t] else at_slot(tbl, slot)
            raw += torch.where(tv[:, slot] >= 0, at, 0) * int(p["ipa_pf_w"][t])
        for kk in range(tk):
            raw += at_slot(wsum[kk], kk)
        for e in w_host:
            raw += torch.where(tv[:, et_slot[e]] >= 0, int(p["ipa_et_w"][e]) * ec[e], 0)
        out.append((ok & (rows >= 0), raw, tot))
    return out


def split_normalize(raw: torch.Tensor, feasible: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's normalisation of one pod: (min, max) over the feasible
    nodes of each CTA's slice, exchanged over the cluster, then the int64
    floor division on each slice; 0 off the feasible set."""
    n = raw.shape[0]
    parts = slices(n, k)
    mins = [int(torch.where(feasible[lo:hi], raw[lo:hi], BIG).min()) if hi > lo else BIG for lo, hi in parts]
    maxs = [int(torch.where(feasible[lo:hi], raw[lo:hi], -BIG).max()) if hi > lo else -BIG for lo, hi in parts]
    mn, mx = min(mins), max(maxs)
    diff = mx - mn
    norm = torch.zeros(n, dtype=torch.int64)
    for lo, hi in parts:
        if diff > 0:
            norm[lo:hi] = torch.where(feasible[lo:hi], torch.div(100 * (raw[lo:hi] - mn), diff,
                                                                 rounding_mode="floor"), 0)
    return norm


@pytest.mark.parametrize("k", SPLITS)
def test_split_filter_matches_jax(k):
    state, dom, pf, jok, _score, valid = _inputs()
    got = np.stack([ok.numpy() for ok, _raw, _tot in emulate(state, dom, pf, k)])
    np.testing.assert_array_equal(got[:, valid], jok[:, valid])
    assert 0 < (~jok[:, valid]).sum() < jok[:, valid].size  # the filter rejects, and not everywhere


def _feasible_set(case: str, k: int, jok: np.ndarray, valid: np.ndarray) -> np.ndarray:
    c, n = jok.shape
    rng = np.random.default_rng(k)
    parts = [(lo, hi) for lo, hi in slices(n, k) if valid[lo:hi].any()]
    if case == "the filter's":
        return jok & valid
    if case == "random":
        return (rng.random((c, n)) < 0.6) & valid
    inside = np.zeros(n, bool)
    if case == "one slice only":
        lo, hi = parts[-1]
        inside[lo:hi] = True
    elif case == "every other slice empty":
        for lo, hi in parts[::2]:
            inside[lo:hi] = True
    elif case == "one node (min = max)":
        inside[int(rng.integers(NODES))] = True
    return np.broadcast_to(inside & valid, (c, n)).copy()


@pytest.mark.parametrize("case", ["the filter's", "random", "one slice only", "every other slice empty",
                                  "none feasible", "one node (min = max)"])
@pytest.mark.parametrize("k", SPLITS)
def test_split_normalisation_matches_jax(k, case):
    state, dom, pf, jok, score, valid = _inputs()
    feas = _feasible_set(case, k, jok, valid)
    want = score(feas)
    for c, (_ok, raw, _tot) in enumerate(emulate(state, dom, pf, k)):
        got = split_normalize(raw, torch.from_numpy(feas[c]), k)
        np.testing.assert_array_equal(got.numpy(), want[c], err_msg=f"pod {c}")
    if case == "the filter's":
        assert (want > 0).any()


@pytest.mark.parametrize("k", SPLITS)
def test_lonely_pod_sum_over_slices(k):
    """The hostname count of the required-affinity terms summed per slice,
    then over the cluster: the "solo" pod's matching pods sit on the last
    rows (one slice), so it is not lonely and lands only there; the
    "lonely" pods match nothing and self-match, so they pass on every node
    with the key; "not-self" matches nothing and does not self-match."""
    state, dom, pf, jok, _score, valid = _inputs()
    res = emulate(state, dom, pf, k)
    solo, lonely, lonely_zone, not_self = range(len(res) - 4, len(res))
    assert res[solo][2] == 6 and res[lonely][2] == 0 and res[lonely_zone][2] == 0
    nodes = np.nonzero(valid)[0]
    assert set(np.nonzero(res[solo][0].numpy() & valid)[0]) == set(range(NODES - 6, NODES)) == \
        set(np.nonzero(jok[solo] & valid)[0])
    assert res[lonely][0].numpy()[nodes].all() and jok[lonely][nodes].all()
    assert not res[not_self][0].numpy()[nodes].any() and not jok[not_self][nodes].any()
    for c in (solo, lonely, lonely_zone, not_self):
        np.testing.assert_array_equal(res[c][0].numpy()[nodes], jok[c][nodes])
