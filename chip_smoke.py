#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases; any failure fails the run (nothing is caught):
  1. the card's name and power limit, the torch and CUDA versions;
  2. build the CUDA kernels from kubernetes_tpu_torch/kernels/csrc (one
     nvcc per source, started together);
  3. hold each kernel against its plain PyTorch version on the card, on
     seeded inputs; exact equality is required, and both are timed with
     CUDA events (median of 50):
     - at the density shapes (C=64 pods, N=8192 node rows, R=4 resources),
       with score ties, zero allocatable, unschedulable nodes, pods
       feasible nowhere, a nominated-pod overlay and duplicate picks:
       build_dom, eval_chunk, select_host, resolve_commit;
     - at the inter-pod-affinity shapes (C=64, N=1024, G=ET=2048, TK=4,
       DV=16) with zone and hostname terms, required, preferred and
       existing terms, namespace selectors and a selector matching a
       thousand groups: build_dom, eval_chunk, ipa_eval, select_host,
       conflict_pairs (a whole 4096-pod batch) and resolve_commit with the
       affinity-term commit;
     - at the two spread shapes (spread_na: C=8, N=1024; inclusion: C=8,
       N=8192), on mixed chunks (zone and hostname constraints, nodes
       missing a key, minDomains, self-match, Honor and Ignore policies,
       ScheduleAnyway, feasible sets with holes, nodeSelector, ORed
       required terms with Gt/Lt/DoesNotExist, matchFields names, a
       profile with addedAffinity, NoSchedule/NoExecute/PreferNoSchedule
       taints with matching and non-matching tolerations) and on the
       workload's pods: node_filters and conflict_pairs (a 4096-pod batch),
       spread_filter, eval_chunk with the precomputed planes, late_scores,
       select_host and resolve_commit;
  4. drive each main path through TorchScheduler, with the launch counts
     set to 0 just before and read just after; every pod must bind, the
     host mirror must equal the device state, no node may exceed its
     allocatable, the path's kernels must launch and no other; a traced run
     gives the device idle share; then the plain versions on the card must
     bind identically:
     - density (5000 nodes, 2048 warm-up + 30000 pods, batch 4096, chunk 64);
     - inter-pod affinity (1000 nodes in 10 zones, 1024 + 10000 pods): no
       two pods of one anti-affinity colour share a zone;
     - spread + node affinity (1000 nodes in 3 zones, 1024 + 5000 pods):
       per app, the zone counts differ by at most maxSkew 2;
     - node inclusion policy (5000 nodes in 10 zones, the odd ones tainted,
       1024 + 5000 pods): no pod on a tainted node, and per app the counts
       over the untainted zones differ by at most maxSkew 1;
     pods/s, the idle share, deferrals, the pack width, the host-to-device
     feature bytes and the data moves outside the hand kernels (dirty-row
     index_copy_ flushes, uniform-batch expand copies) are printed;
  5. print the per-kernel JSON line (launches per path, and the numbers of
     every shape a kernel was measured at), the card line, and last the
     device line.

Exits non-zero, printing no result, when CUDA is unavailable or the
package is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

# H100 SXM memory bandwidth and float32 rate outside the tensor cores
# (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Timed calls per kernel and per plain version (the median is kept).
REPS = 50


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, setup=None) -> tuple[float, float]:
    """(device ms, call ms): medians over ``reps`` single calls.  Device
    time: the two CUDA events are queued behind a spin kernel that keeps
    the GPU busy while the host enqueues the call, so they bracket only the
    call's own device work.  Call time: the same events with the GPU idle,
    so they also include the host's launch overhead (what a call costs the
    main path when the host cannot run ahead)."""
    import torch

    dev_times, call_times = [], []
    for r in range(reps + 3):
        for busy, times in ((True, dev_times), (False, call_times)):
            arg = setup() if setup is not None else None
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if busy:
                torch.cuda._sleep(20_000_000)  # ~10 ms of spinning
            start.record()
            fn(arg)
            end.record()
            torch.cuda.synchronize()
            if r >= 3:  # warm-up calls
                times.append(start.elapsed_time(end))
    dev_times.sort()
    call_times.sort()
    return dev_times[len(dev_times) // 2], call_times[len(call_times) // 2]


def kernel_inputs(seed: int, dev):
    """A 5000-node cluster (8192 rows) with seeded load, plus one 64-pod
    chunk of features, the nominated overlay and tie-break steps."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    rng = np.random.default_rng(seed)
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    cpus = ["0", "4", "8", "16", "16", "16"]  # ties: few distinct node shapes
    mems = ["0", "16Gi", "64Gi", "64Gi"]
    for i in range(5000):
        cap = {"cpu": cpus[rng.integers(len(cpus))], "memory": mems[rng.integers(len(mems))],
               "pods": int(rng.choice([110, 110, 3]))}
        if rng.random() < 0.3:
            cap["example.com/gpu"] = int(rng.choice([0, 4, 8]))
        node = make_node(f"n{i}").capacity(cap).zone(f"zone-{i % 3}")
        if rng.random() < 0.03:
            node = node.unschedulable()
        cache.add_node(node.obj())
    for j in range(12000):
        name = f"n{rng.integers(5000)}"
        pod = make_pod(f"bound-{j}").req(
            {"cpu": f"{int(rng.choice([100, 500, 900]))}m", "memory": f"{int(rng.choice([1, 2]))}Gi"}
        ).label("app", f"app-{j % 7}").node(name).obj()
        cache.add_pod(pod)
    pods = []
    for k in range(64):
        if k % 16 == 5:  # feasible nowhere
            req = {"cpu": "1000", "memory": "1Gi"}
        else:
            req = {"cpu": f"{int(rng.choice([100, 900, 2000]))}m",
                   "memory": f"{int(rng.choice([1, 2, 8]))}Gi"}
            if k % 5 == 0:
                req["example.com/gpu"] = int(rng.choice([1, 2]))
        pods.append(make_pod(f"p{k}").req(req).label("app", f"app-{k % 7}")
                    .priority(int(rng.integers(-5, 5))).obj())
    batch, _, _ = build_pod_batch(pods, builder, DEFAULT_PROFILE, 64)
    n = builder.schema.N
    batch["nodename_id"][3] = builder.interns.node_names.get("n17")
    batch["nodename_id"][9] = -2  # names no node
    batch["tolerates_unschedulable"][::4] = True
    nomrow = np.full(64, -1, np.int32)
    nomrow[rng.choice(64, 8, replace=False)] = rng.integers(5000, size=8)
    batch["nominated_row"] = nomrow
    nom_req = np.zeros((n, builder.schema.R), np.int64)
    nom_cnt = np.zeros(n, np.int32)
    nom_prio = np.full(n, -(2**31), np.int32)
    hot = rng.choice(5000, 200, replace=False)
    nom_req[hot, 0] = rng.integers(0, 8000, size=200)
    nom_req[hot, 1] = rng.integers(0, 8, size=200) << 30
    nom_cnt[hot] = rng.integers(1, 3, size=200)
    nom_prio[hot] = rng.integers(-5, 5, size=200)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {k: to(v) for k, v in batch.items()}
    nom = (to(nom_req), to(nom_cnt), to(nom_prio))
    steps = to(rng.integers(0, 2**32, size=64, dtype=np.int64))
    return builder, pf, nom, steps, rng


def exact(errs: dict, name: str, what: str, a, b) -> None:
    """Record the largest |a - b| of one kernel output against its plain
    version under ``name`` in ``errs``; any difference fails the run."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{name} {what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    wide = torch.float64 if a.is_floating_point() else torch.int64
    diff = (a.to(wide) - b.to(wide)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if err != 0:
        raise AssertionError(f"{name} {what}: {int((diff != 0).sum())} entries differ, max |err| {err}")


def clone_dom(dom):
    """A copy of the domain tables the commit updates in place."""
    return dom._replace(group_dom=dom.group_dom.clone(), et_dom=dom.et_dom.clone())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def eval_bytes(state, pf: dict, nom) -> int:
    """eval_chunk: the node state and the pod features it reads, once;
    feasible, total and the fail mask written once."""
    c, n = pf["req"].shape[0], state.valid.shape[0]
    node = nbytes(state.valid, state.name_id, state.unschedulable, state.num_pods,
                  state.allowed_pods, state.alloc, state.req, state.nonzero_req, *(nom or ()))
    keys = ["nodename_id", "tolerates_unschedulable", "req", "nonzero"]
    if nom is not None:
        keys += ["priority", "nominated_row"]
    return node + nbytes(*(pf[k] for k in keys)) + c * n * (1 + 8) + c * 4


def select_bytes(c: int, n: int) -> int:
    """select_host: feasible and total read once, steps and nominated rows
    read, pick, best and feasible count written."""
    return c * n * (1 + 8) + c * (8 + 4) + c * (4 + 8 + 4)


def dom_cost(state, et_slot, group_dom, et_dom) -> tuple[int, int]:
    """build_dom: (bytes, int32 adds).  Both count tables are read once
    (a zero count must be seen to be skipped), topo_vals and et_slot once,
    both tables written once; one add per non-zero count and key."""
    tk = state.topo_vals.shape[1]
    b = nbytes(state.group_counts, state.et_counts, state.topo_vals, et_slot, group_dom, et_dom)
    adds = int((state.group_counts != 0).sum()) * tk + int((state.et_counts != 0).sum())
    return b, adds


def set_bound(entry: dict, nbytes_: int, ops: int = 0) -> None:
    """The least time for the work: the larger of the bytes over HBM
    bandwidth and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes_ / HBM_BYTES_PER_S, ops / F32_FLOPS
    entry.update(bytes=nbytes_, ops=ops, bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_dom(errs: dict, label: str, state, et_slot, dv: int, reps: int) -> dict:
    """build_dom against its plain version, exactly, and timed."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    kg, ke = kernels.build_dom(state, et_slot, dv)
    pg, pe = plain.build_dom(state, et_slot, dv)
    torch.cuda.synchronize()
    exact(errs, "build_dom", f"[{label}] group_dom", kg, pg)
    exact(errs, "build_dom", f"[{label}] et_dom", ke, pe)
    print(f"build_dom [{label}]: exact; {int(pg.sum())} group and {int(pe.sum())} term "
          f"carriers in domains")
    out = timed(lambda _: kernels.build_dom(state, et_slot, dv),
                lambda _: plain.build_dom(state, et_slot, dv), reps)
    set_bound(out, *dom_cost(state, et_slot, kg, ke))
    return out


def timed(kernel_fn, plain_fn, reps: int, setup=None) -> dict:
    ms, call_ms = median_ms(kernel_fn, reps, setup)
    plain_ms, plain_call_ms = median_ms(plain_fn, reps, setup)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms)


def check_kernels(dev, reps: int) -> dict:
    """Phase 3: every kernel against its plain version; returns, per
    kernel, its timings, bytes bound and largest error over every output."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec
    from kubernetes_tpu_torch.framework.config import (
        DEFAULT_PROFILE, MOST_ALLOCATED, ScoringStrategy, fit_only_profile,
    )
    from kubernetes_tpu_torch.kernels import plain

    builder, pf, nom, steps, rng = kernel_inputs(1234, dev)
    state = builder.state()
    schema, res_col = builder.schema, builder.res_col
    result = {}
    errs: dict[str, float] = {}
    et_slot0 = torch.zeros(schema.ET, dtype=torch.int32, device=dev)
    result["build_dom"] = check_dom(errs, "density", state, et_slot0, schema.DV, reps)
    ported = {"NodeUnschedulable", "NodeName", "NodeResourcesFit", "NodeResourcesBalancedAllocation"}
    most = dataclasses.replace(
        DEFAULT_PROFILE,
        scoring_strategy=ScoringStrategy(
            type=MOST_ALLOCATED,
            resources=(("cpu", 1), ("memory", 2), ("example.com/gpu", 3)),
        ),
        fit_ignored_resources=("example.com/gpu",),
        tie_break_seed=12345,
    )
    variants = {"default": DEFAULT_PROFILE, "most_allocated": most, "fit_only": fit_only_profile()}
    for label, prof in variants.items():
        active = frozenset(ported & (set(prof.filters) | {s for s, _ in prof.scorers}))
        spec = eval_spec(prof, schema, res_col, active)
        seed_mul = ((prof.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
        for nom_in in (nom, None):
            kf, kt, km = kernels.eval_chunk(state, pf, spec, nom_in)
            pfe, pt, pm = plain.eval_chunk(state, pf, spec, nom_in)
            torch.cuda.synchronize()
            for what, a, b in (("feasible", kf, pfe), ("total", kt, pt), ("fail_mask", km, pm)):
                exact(errs, "eval_chunk", f"[{label}] {what}", a, b)
            nomr = pf["nominated_row"] if nom_in is not None else None
            ks = kernels.select_host(kf, kt, steps, seed_mul, nomr)
            ps = plain.select_host(pfe, pt, steps, seed_mul, nomr)
            torch.cuda.synchronize()
            for what, a, b in zip(("pick", "best", "feasible_count"), ks, ps):
                exact(errs, "select_host", f"[{label}] {what}", a, b)
        infeasible = int((ps[2] == 0).sum())
        ties = int(((pt == pt.max(dim=1, keepdim=True).values) & pfe).sum(dim=1).gt(1).sum())
        print(f"eval_chunk/select_host [{label}]: exact; {infeasible} pods feasible nowhere, "
              f"{ties} pods with tied best scores")
        if label == "default":
            result["eval_chunk"] = timed(
                lambda _: kernels.eval_chunk(state, pf, spec, nom),
                lambda _: plain.eval_chunk(state, pf, spec, nom), reps)
            result["select_host"] = timed(
                lambda _: kernels.select_host(kf, kt, steps, 0, pf["nominated_row"]),
                lambda _: plain.select_host(pfe, pt, steps, 0, pf["nominated_row"]), reps)
    # resolve_commit: duplicate picks on nearly full rows, invalid rows,
    # unschedulable pods and a random conflict table.
    dom0 = build_dom(state, et_slot0, torch.zeros(schema.ET, dtype=torch.bool, device=dev), schema.DV)
    free_cpu = (state.alloc[:, 0] - state.req[:, 0]).cpu().numpy()
    tight = np.nonzero((free_cpu > 0) & (free_cpu < 2500))[0][:6]
    picks = torch.from_numpy(rng.choice(tight, 64).astype(np.int32)).to(dev)
    picks[::9] = -1
    valid = pf["valid"].clone()
    valid[60:] = False
    pairs = torch.from_numpy(rng.random((64, 64)) < 0.01).to(dev)
    pfk = dict(pf, valid=valid)
    for strict in (False, True):
        sk, dk = state.clone(), clone_dom(dom0)
        sp, dp = state.clone(), clone_dom(dom0)
        ok_ = kernels.resolve_commit(sk, dk, pfk, picks, pairs, strict)
        op_ = plain.resolve_commit(sp, dp, pfk, picks, pairs, strict)
        torch.cuda.synchronize()
        exact(errs, "resolve_commit", f"(strict={strict}) picks", ok_, op_)
        exact(errs, "resolve_commit", f"(strict={strict}) group_dom", dk.group_dom, dp.group_dom)
        for f in ("req", "nonzero_req", "num_pods", "group_counts"):
            exact(errs, "resolve_commit", f"(strict={strict}) state.{f}", getattr(sk, f), getattr(sp, f))
        print(f"resolve_commit(strict={strict}): exact; "
              f"{int((op_ == -2).sum())} deferred, {int((op_ >= 0).sum())} committed")
    clones = lambda: (state.clone(), clone_dom(dom0))  # noqa: E731
    result["resolve_commit"] = timed(
        lambda a: kernels.resolve_commit(a[0], a[1], pfk, picks, pairs, False),
        lambda a: plain.resolve_commit(a[0], a[1], pfk, picks, pairs, False), reps, clones)
    # Least time for the same work: the bytes each function must move
    # (inputs read once, outputs written once) over HBM bandwidth.
    c, n = pf["req"].shape[0], state.valid.shape[0]
    # resolve_commit touches only the picked rows: their alloc, req,
    # nonzero_req, num_pods, allowed_pods and topo_vals, and one
    # group_counts cell and TK group_dom cells per distinct (group, row).
    rows = int(torch.unique(picks[picks >= 0]).numel())
    cells = int(torch.unique((pf["group"].long() * n + picks.long())[picks >= 0]).numel())
    row_bytes = rows * (schema.R * 8 * 3 + 2 * 8 * 2 + 4 * 3 + schema.TK * 4)
    cell_bytes = cells * (4 + schema.TK * 4) * 2
    pod_side = c * (4 + 1 + schema.R * 8 + 2 * 8 + 4) + c * c + c * 4
    commit_bytes = row_bytes + cell_bytes + pod_side
    for name, nb in (("eval_chunk", eval_bytes(state, pf, nom)), ("select_host", select_bytes(c, n)),
                     ("resolve_commit", commit_bytes)):
        set_bound(result[name], nb)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    return result


HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


def ipa_cluster(seed: int, dev):
    """1000 nodes in 10 zones (1024 rows) and 3000 bound pods whose labels
    and terms intern about 1100 label groups and 1100 affinity terms (G =
    ET = 2048): zone anti-affinity to their own colour (1000 colours), zone
    affinity (50 colours), hostname anti-affinity, preferred zone and
    hostname terms, and pods in two labelled namespaces."""
    import numpy as np

    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    rng = np.random.default_rng(seed)
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    builder.set_namespace_labels("team-a", {"team": "a"})
    builder.set_namespace_labels("team-b", {"team": "b"})
    for i in range(1000):
        cache.add_node(make_node(f"n{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
                       .zone(f"zone-{i % 10}").obj())
    for j in range(3000):
        node = f"n{rng.integers(1000)}"
        kind = j % 6
        if kind in (0, 1):
            w = make_pod(f"b{j}").label("color", f"c{j % 1000}").pod_anti_affinity_in(
                "color", [f"c{j % 1000}"], ZONE)
        elif kind == 2:
            w = make_pod(f"b{j}").label("acolor", f"a{j % 50}").pod_affinity_in(
                "acolor", [f"a{j % 50}"], ZONE)
        elif kind == 3:
            w = make_pod(f"b{j}", namespace="team-a" if j % 2 else "team-b").label(
                "app", f"web{j % 4}").pod_anti_affinity_in("app", [f"web{j % 4}"], HOST)
        elif kind == 4:
            w = make_pod(f"b{j}").label("app", f"db{j % 3}").preferred_pod_affinity_in(
                "app", [f"web{j % 4}"], ZONE, weight=30).preferred_pod_affinity_in(
                "app", [f"db{j % 3}"], HOST, weight=20, anti=True)
        else:
            w = make_pod(f"b{j}").label("color", f"c{j % 1000}").label("tier", "x")
        cache.add_pod(w.req({"cpu": "100m", "memory": "128Mi"}).node(node).obj())
    return builder, cache, rng


def ipa_chunk_pods(rng) -> list:
    """64 pods covering every branch of the op: required zone and hostname
    affinity (present, absent and lonely self-matching), required zone and
    hostname anti-affinity, ± preferred zone and hostname terms, a
    namespaceSelector term, a selector matching a thousand groups (Exists
    on "color"), and plain pods that existing pods' terms match."""
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod

    exists = t.PodAffinityTerm(
        label_selector=t.LabelSelector(match_expressions=(
            t.LabelSelectorRequirement("color", t.OP_EXISTS),)),
        topology_key=ZONE)
    pods = []
    for k in range(64):
        w = make_pod(f"q{k}").req({"cpu": "100m", "memory": "128Mi"})
        x = int(rng.integers(1000))
        kind = k % 10
        if kind == 0:
            w = w.label("acolor", f"a{x % 50}").pod_affinity_in("acolor", [f"a{x % 50}"], ZONE)
        elif kind == 1:
            w = w.label("app", "solo").pod_affinity_in("app", ["solo"], HOST)  # lonely, self-matching
        elif kind == 2:
            w = w.pod_affinity_in("app", [f"web{x % 4}"], HOST).pod_affinity_in("color", [f"c{x}"], ZONE)
        elif kind == 3:
            w = w.label("color", f"c{x}").pod_anti_affinity_in("color", [f"c{x}"], ZONE)
        elif kind == 4:
            w = w.label("app", f"web{x % 4}").pod_anti_affinity_in("app", [f"db{x % 3}"], HOST)
        elif kind == 5:
            w = w.label("app", f"db{x % 3}").preferred_pod_affinity_in(
                "color", [f"c{x}"], ZONE, weight=int(rng.integers(1, 101))).preferred_pod_affinity_in(
                "app", [f"web{x % 4}"], HOST, weight=int(rng.integers(1, 101)), anti=True)
        elif kind == 6:
            w = w.label("app", f"web{x % 4}").ns_selector_pod_affinity_in(
                "app", [f"web{x % 4}"], HOST, "team", ["a"], anti=True)
        elif kind == 7:
            w._attach_pod_term(exists, True, None)
            w = w.label("tier", "y")
        elif kind == 8:
            w = w.label("color", f"c{x}")  # existing anti terms repel it
        else:
            w = w.label("app", f"web{x % 4}").preferred_pod_affinity_in(
                "app", [f"db{x % 3}"], ZONE, weight=50)
        pods.append(w.obj())
    return pods


def ipa_inputs(seed: int, dev):
    """The IPA cluster, its domain tables, one featurized 64-pod chunk with
    eval_chunk's result, and one featurized 4096-pod batch of the
    workload's pods (for conflict_pairs)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec, ipa_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.workloads import pod_ipa_heavy

    builder, _cache, rng = ipa_cluster(seed, dev)
    # The workload's pods in a shuffled order, so chunks hold same-colour pods.
    order = rng.permutation(4096)
    big, _, big_active = build_pod_batch([pod_ipa_heavy(int(i)) for i in order], builder,
                                         DEFAULT_PROFILE, 4096)
    batch, _, active = build_pod_batch(ipa_chunk_pods(rng), builder, DEFAULT_PROFILE, 64)
    if "InterPodAffinity" not in active or "InterPodAffinity" not in big_active:
        raise AssertionError("the IPA inputs leave InterPodAffinity inactive")
    inv = builder.batch_invariants()
    state = builder.state()
    schema = builder.schema
    if (schema.G, schema.ET, schema.N, schema.DV) != (2048, 2048, 1024, 16):
        raise AssertionError(f"IPA shapes: {schema}")
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {k: to(v) for k, v in batch.items()}
    pf["nominated_row"] = torch.full((64,), -1, dtype=torch.int32, device=dev)
    big_pf = {k: to(v) for k, v in big.items()}
    dom = build_dom(state, to(inv["et_slot"]), to(inv["et_host"]), schema.DV)
    spec = eval_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    ipa = ipa_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    ipa = dataclasses.replace(ipa, ctx=dataclasses.replace(ipa.ctx, dom=dom))
    base = plain.eval_chunk(state, pf, spec, None)
    return dict(builder=builder, state=state, dom=dom, pf=pf, big_pf=big_pf, spec=spec,
                ipa=ipa, base=base, rng=rng)


def check_ipa_kernels(dev, reps: int) -> dict:
    """Phase 3, the inter-pod-affinity shapes: build_dom, eval_chunk,
    ipa_eval, select_host, conflict_pairs and resolve_commit (with the
    affinity-term commit) against their plain versions, exactly; returns
    each one's timings, bound and largest error."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    x = ipa_inputs(4321, dev)
    state, dom, pf, big_pf, ipa, spec = x["state"], x["dom"], x["pf"], x["big_pf"], x["ipa"], x["spec"]
    schema = x["builder"].schema
    errs: dict[str, float] = {}
    result = {"build_dom": check_dom(errs, "ipa", state, dom.et_slot, schema.DV, reps)}
    c, n = pf["valid"].shape[0], state.valid.shape[0]
    base = x["base"]
    kb = kernels.eval_chunk(state, pf, spec, None)
    torch.cuda.synchronize()
    for what, a, b in zip(("feasible", "total", "fail_mask"), kb, base):
        exact(errs, "eval_chunk", f"[ipa] {what}", a, b)
    result["eval_chunk"] = timed(lambda _: kernels.eval_chunk(state, pf, spec, None),
                                 lambda _: plain.eval_chunk(state, pf, spec, None), reps)
    fresh = lambda: tuple(t.clone() for t in base)  # noqa: E731
    score_only = dataclasses.replace(
        ipa, filters=tuple(f for f in ipa.filters if f != "InterPodAffinity"))
    for label, spec_ in (("score only", score_only), ("filter+score", ipa)):
        kf, kt, km = kernels.ipa_eval(state, pf, *fresh(), spec_)
        pfe, pt, pm = plain.ipa_eval(state, pf, *fresh(), spec_)
        torch.cuda.synchronize()
        for what, a, b in (("feasible", kf, pfe), ("total", kt, pt), ("fail_mask", km, pm)):
            exact(errs, "ipa_eval", f"[{label}] {what}", a, b)
    rejected = int((base[0] & ~pfe).sum())
    print(f"ipa_eval: exact; {rejected} of {int(base[0].sum())} feasible (pod, node) pairs "
          f"rejected by InterPodAffinity, {int((pfe.sum(dim=1) == 0).sum())} pods feasible nowhere")
    result["ipa_eval"] = timed(
        lambda a: kernels.ipa_eval(state, pf, *a, ipa),
        lambda a: plain.ipa_eval(state, pf, *a, ipa), reps, fresh)
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    steps = torch.from_numpy(x["rng"].integers(0, 2**32, size=c, dtype=np.int64)).to(dev)
    nomr = pf["nominated_row"]
    ks = kernels.select_host(pfe, pt, steps, seed_mul, nomr)
    ps = plain.select_host(pfe, pt, steps, seed_mul, nomr)
    torch.cuda.synchronize()
    for what, a, b in zip(("pick", "best", "feasible_count"), ks, ps):
        exact(errs, "select_host", f"[ipa] {what}", a, b)
    print(f"eval_chunk/select_host [ipa]: exact; {int((ps[0] >= 0).sum())} pods placed")
    result["select_host"] = timed(lambda _: kernels.select_host(pfe, pt, steps, seed_mul, nomr),
                                  lambda _: plain.select_host(pfe, pt, steps, seed_mul, nomr), reps)
    # conflict_pairs: the workload's 4096-pod batch as 64 chunks, and the
    # mixed chunk.
    for label, src, nch in (("workload batch", big_pf, 64), ("mixed chunk", pf, 1)):
        kp = kernels.conflict_pairs(src, nch, 64)
        pp = plain.conflict_pairs(src, nch, 64)
        torch.cuda.synchronize()
        exact(errs, "conflict_pairs", f"[{label}]", kp, pp)
        print(f"conflict_pairs [{label}]: exact; {int(pp.sum())} pairs")
    result["conflict_pairs"] = timed(
        lambda _: kernels.conflict_pairs(big_pf, 64, 64),
        lambda _: plain.conflict_pairs(big_pf, 64, 64), reps)
    # resolve_commit with own-term commits: each pod's pick is a node its
    # evaluation left feasible (or none), the pairs are the chunk's own.
    picks = torch.where(pfe.any(dim=1), pfe.to(torch.int32).argmax(dim=1), -1).to(torch.int32)
    pairs = pp[0]
    for strict in (False, True):
        sk, dk = state.clone(), clone_dom(dom)
        sp, dp = state.clone(), clone_dom(dom)
        ok_ = kernels.resolve_commit(sk, dk, pf, picks, pairs, strict)
        op_ = plain.resolve_commit(sp, dp, pf, picks, pairs, strict)
        torch.cuda.synchronize()
        exact(errs, "resolve_commit", f"[ipa] (strict={strict}) picks", ok_, op_)
        exact(errs, "resolve_commit", f"[ipa] (strict={strict}) group_dom", dk.group_dom, dp.group_dom)
        exact(errs, "resolve_commit", f"[ipa] (strict={strict}) et_dom", dk.et_dom, dp.et_dom)
        for f in ("req", "nonzero_req", "num_pods", "group_counts", "et_counts"):
            exact(errs, "resolve_commit", f"[ipa] (strict={strict}) state.{f}", getattr(sk, f), getattr(sp, f))
        moved = int((sp.et_counts - state.et_counts).sum())
        print(f"resolve_commit[ipa](strict={strict}): exact; {int((op_ == -2).sum())} deferred, "
              f"{int((op_ >= 0).sum())} committed, {moved} own-term commits")
    result["resolve_commit"] = timed(
        lambda a: kernels.resolve_commit(a[0], a[1], pf, picks, pairs, False),
        lambda a: plain.resolve_commit(a[0], a[1], pf, picks, pairs, False), reps,
        lambda: (state.clone(), clone_dom(dom)))
    tk = schema.TK
    k = big_pf["valid"].shape[0]
    bg = big_pf["group"].view(64, 64)
    bo = big_pf["ipa_own_terms"].view(64, 64, -1)
    brs = big_pf["ipa_rs_groups"].shape[1]
    pair_bytes = nbytes(big_pf["group"], big_pf["ipa_own_terms"]) + 64 * 64 * 64
    for b in range(64):
        ug = int(torch.unique(bg[b]).numel())
        ue = int(torch.unique(bo[b][bo[b] >= 0]).numel())
        pair_bytes += 64 * ug * (1 + brs) + 64 * ue * 2
    att = picks >= 0
    rows = int(torch.unique(picks[att]).numel())
    cells = int(torch.unique((pf["group"].long() * n + picks.long())[att]).numel())
    own = pf["ipa_own_terms"].long()
    own_ok = (own >= 0) & att[:, None]
    own_cells = int(torch.unique((own * n + picks.long()[:, None])[own_ok]).numel())
    commit_bytes = (rows * (schema.R * 8 * 3 + 2 * 8 * 2 + 4 * 3 + tk * 4)
                    + cells * (4 + tk * 4) * 2 + own_cells * (4 + 4 + 4) * 2
                    + c * (4 + 1 + schema.R * 8 + 2 * 8 + 4 + own.shape[1] * 4) + c * c + c * 4)
    for name, nb in (("eval_chunk", eval_bytes(state, pf, None)), ("ipa_eval", ipa_bytes(state, dom, pf)),
                     ("select_host", select_bytes(c, n)), ("conflict_pairs", pair_bytes),
                     ("resolve_commit", commit_bytes)):
        set_bound(result[name], nb)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    ra, rs, npf = (pf[f"ipa_{p}_valid"].shape[1] for p in ("ra", "rs", "pf"))
    print(f"IPA shapes: C={c}, N={n}, G={schema.G}, ET={schema.ET}, TK={tk}, DV={schema.DV}, "
          f"K={k}; own terms per pod {ra}+{rs}+{npf}")
    return result


def sectors(rows, cols, width: int, per: int) -> int:
    """Bytes of the distinct 32-byte sectors that entries (rows, cols) of a
    row-major (*, width) array of ``per`` entries per sector fall in."""
    import torch

    if rows.numel() == 0:
        return 0
    stride = width // per + 1
    return int(torch.unique(rows.long() * stride + cols.long() // per).numel()) * 32


def ipa_bytes(state, dom, pf: dict) -> int:
    """ipa_eval: the bytes it must move for this chunk's data.  Read in
    full: topo_vals, the small per-term features, et_match, and the group
    masks of the pods' valid terms (the all-terms mask of pods with
    required affinity, the rs and pf mask of each valid term).  Read only
    where the pod matched a term: et_anti, et_w, et_slot and et_host, in
    32-byte sectors.  Domain tables: one group_dom (DV) row per distinct
    (group, slot) of a valid domain term, one et_dom row per distinct used
    existing domain term; hostname terms read one group_counts or
    et_counts row per distinct group or term instead.  feasible and total
    are read and written once, the fail mask too."""
    import torch

    c, n = pf["valid"].shape[0], state.valid.shape[0]
    tk, dv = state.topo_vals.shape[1], dom.group_dom.shape[2]
    g, et = pf["ipa_ra_allmask"].shape[1], pf["ipa_et_match"].shape[1]
    small = nbytes(pf["ipa_ra_self"], pf["ipa_pf_w"], *(
        pf[f"ipa_{p}_{f}"] for p in ("ra", "rs", "pf") for f in ("valid", "slot", "host")))
    ra_valid = pf["ipa_ra_valid"]
    masks = g * (int(ra_valid.any(dim=1).sum()) + int(pf["ipa_rs_valid"].sum())
                 + int(pf["ipa_pf_valid"].sum()))
    # Per own term (c, t): its group mask and slot; required affinity uses
    # the all-terms mask for every term.
    own = [(pf["ipa_ra_allmask"][:, None, :].expand(-1, ra_valid.shape[1], -1), "ra")]
    own += [(pf[f"ipa_{p}_groups"], p) for p in ("rs", "pf")]
    dom_keys, host_groups = [], []
    for mask, p in own:
        valid, host, slot = pf[f"ipa_{p}_valid"], pf[f"ipa_{p}_host"], pf[f"ipa_{p}_slot"]
        ci, ti, gi = torch.nonzero(mask & (valid & ~host)[:, :, None], as_tuple=True)
        dom_keys.append(gi.long() * tk + slot[ci, ti].long())
        host_groups.append(torch.nonzero(mask & (valid & host)[:, :, None], as_tuple=True)[2])
    n_dom = int(torch.unique(torch.cat(dom_keys)).numel())
    n_host = int(torch.unique(torch.cat(host_groups)).numel())
    match = pf["ipa_et_match"]
    mr, mc = torch.nonzero(match, as_tuple=True)
    terms = torch.unique(mc)  # et_slot and et_host are one row
    zero = torch.zeros_like(terms)
    per_term = (sectors(mr, mc, et, 32) + sectors(mr, mc, et, 4)  # et_anti, et_w
                + sectors(zero, terms, et, 8) + sectors(zero, terms, et, 32))  # et_slot, et_host
    used = (match & (pf["ipa_et_anti"] | (pf["ipa_et_w"] != 0))).any(dim=0)
    tables = (n_dom * dv * 4 + n_host * n * 4 + int((used & ~dom.et_host).sum()) * dv * 4
              + int((used & dom.et_host).sum()) * n * 4)
    return (nbytes(state.topo_vals) + small + masks + nbytes(match) + per_term + tables
            + 2 * c * n * (1 + 8) + 2 * c * 4)


def ipa_anti_ok(outcomes) -> None:
    """No two pods of one anti-affinity colour in one zone."""
    seen: dict[tuple, str] = {}
    for o in outcomes:
        aff = o.pod.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            continue
        zone = int(o.node_name.rsplit("-", 1)[1]) % 10
        key = (o.pod.metadata.labels["color"], zone)
        if key in seen:
            raise AssertionError(f"{o.pod.name} and {seen[key]} share colour and zone {key}")
        seen[key] = o.pod.name


# -- the spread shapes: PodTopologySpread, NodeAffinity, TaintToleration ----

SPREAD_SHAPES = {
    # label: (nodes, zones, bound pods, workload pod template name)
    "spread_na": (1000, 3, 3000, "pod_spread_na"),
    "inclusion": (5000, 10, 6000, "pod_inclusion"),
}


def spread_cluster(shape: str, seed: int, dev):
    """The workload's nodes (spread_na: 1000 in 3 zones; inclusion: 5000 in
    10 zones, the odd ones tainted dedicated=gpu:NoSchedule) with extra
    labels and taints for the mixed pods: every 97th node lacks the zone
    key, disk and num labels (num non-integer on some), PreferNoSchedule,
    NoExecute and NoSchedule taints on a few; and bound pods of the 10
    apps (two versions, two namespaces) on untainted nodes."""
    import numpy as np

    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    n_nodes, zones, bound, _tmpl = SPREAD_SHAPES[shape]
    rng = np.random.default_rng(seed)
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    clean = []
    for i in range(n_nodes):
        w = make_node(f"node-{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
        if i % 97 != 13:
            w = w.zone(f"zone-{i % zones}")
        if i % 3:
            w = w.label("disk", "ssd" if i % 3 == 1 else "hdd")
        w = w.label("num", str(i % 50) if i % 31 else "x")
        tainted = (shape == "inclusion" and i % 2) or i % 11 == 4
        if tainted:
            w = w.taint("dedicated", "gpu", t.EFFECT_NO_SCHEDULE)
        if i % 7 == 2:
            w = w.taint("soft", "x", t.EFFECT_PREFER_NO_SCHEDULE)
        if i % 13 == 5:
            w = w.taint("evict", "y", t.EFFECT_NO_EXECUTE)
        if not tainted and i % 13 != 5:
            clean.append(i)
        cache.add_node(w.obj())
    for j in range(bound):
        ns = "default" if j % 9 else "other"
        pod = (make_pod(f"b{j}", ns).req({"cpu": "100m", "memory": "256Mi"})
               .label("app", f"app-{j % 10}").label("ver", f"v{j % 2}")
               .node(f"node-{clean[int(rng.integers(len(clean)))]}").obj())
        cache.add_pod(pod)
    return builder, rng


def spread_mixed_pods(rng, zones: int, n_nodes: int) -> list:
    """32 pods covering every branch of the three ops: zone and hostname
    constraints, DoNotSchedule and ScheduleAnyway, minDomains above the zone
    count, self-matching and foreign selectors, matchLabelKeys, Honor and
    Ignore policies; nodeSelector, ORed required terms with Gt/Lt/Exists/
    DoesNotExist/NotIn, matchFields names, preferred weights; matching and
    non-matching NoSchedule, NoExecute and PreferNoSchedule tolerations."""
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod

    R = t.NodeSelectorRequirement
    pods = []
    for k in range(32):
        app = f"app-{int(rng.integers(10))}"
        w = make_pod(f"m{k}").req({"cpu": "100m", "memory": "256Mi"}).label("app", app).label(
            "ver", f"v{k % 2}")
        kind = k % 8
        honor = t.POLICY_HONOR if rng.integers(2) else t.POLICY_IGNORE
        if kind == 0:
            w = (w.spread_constraint(1, ZONE, t.DO_NOT_SCHEDULE, "app", [app])
                 .spread_constraint(1, HOST, t.DO_NOT_SCHEDULE, "app", [app], node_taints_policy=honor)
                 .toleration(key="dedicated", op=t.TOLERATION_OP_EXISTS))
        elif kind == 1:
            w = (w.spread_constraint(2, ZONE, t.SCHEDULE_ANYWAY, "app", [app])
                 .spread_constraint(1, HOST, t.SCHEDULE_ANYWAY, "app", [app], match_label_keys=("ver",))
                 .preferred_node_affinity_in("disk", ["ssd"], weight=int(rng.integers(1, 100)))
                 .preferred_node_affinity_in(ZONE, ["zone-1"], weight=int(rng.integers(1, 100))))
        elif kind == 2:
            w = (w.spread_constraint(1, ZONE, t.DO_NOT_SCHEDULE, "app", [app], min_domains=zones + 2,
                                     node_taints_policy=t.POLICY_HONOR)
                 .node_selector({"disk": "ssd"}))
        elif kind == 3:
            pod = w.spread_constraint(1, ZONE, t.SCHEDULE_ANYWAY, "app", [app],
                                      node_affinity_policy=t.POLICY_IGNORE).obj()
            pod.spec.affinity = t.Affinity(node_affinity=t.NodeAffinity(required=t.NodeSelector(terms=(
                t.NodeSelectorTerm(match_expressions=(R("num", t.OP_GT, ("20",)), R("disk", t.OP_DOES_NOT_EXIST))),
                t.NodeSelectorTerm(match_expressions=(R(ZONE, t.OP_IN, ("zone-1",)), R("num", t.OP_LT, ("30",)))),
                t.NodeSelectorTerm(match_expressions=(R(ZONE, t.OP_NOT_IN, ("zone-0",)), R("disk", t.OP_EXISTS))),
            ))))
            pods.append(pod)
            continue
        elif kind == 4:
            pod = (w.spread_constraint(2, ZONE, t.DO_NOT_SCHEDULE, "app", [app])
                   .toleration(key="evict", value="y", effect=t.EFFECT_NO_EXECUTE).obj())
            names = tuple(f"node-{int(x)}" for x in rng.choice(n_nodes, 40, replace=False))
            pod.spec.affinity = t.Affinity(node_affinity=t.NodeAffinity(required=t.NodeSelector(terms=(
                t.NodeSelectorTerm(match_fields=(R("metadata.name", t.OP_IN, names),)),))))
            pods.append(pod)
            continue
        elif kind == 5:
            other = f"app-{(int(app.split('-')[1]) + 1) % 10}"
            w = (w.spread_constraint(1, ZONE, t.DO_NOT_SCHEDULE, "app", [other])  # no self-match
                 .node_affinity_in("num", ["7", "8", "9"])
                 .toleration(key="dedicated", value="cpu"))  # wrong value: not tolerated
        elif kind == 6:
            w = (w.spread_constraint(1, HOST, t.DO_NOT_SCHEDULE, "app", [app], node_taints_policy=t.POLICY_HONOR)
                 .spread_constraint(1, ZONE, t.SCHEDULE_ANYWAY, "app", [app], node_taints_policy=t.POLICY_HONOR)
                 .toleration(key="soft", op=t.TOLERATION_OP_EXISTS, effect=t.EFFECT_PREFER_NO_SCHEDULE))
        else:
            w = w.node_selector({"never-seen": "x"})  # feasible nowhere
        pods.append(w.obj())
    return pods


def _added_affinity():
    from kubernetes_tpu_torch.api import types as t

    return t.NodeAffinity(
        required=t.NodeSelector(terms=(t.NodeSelectorTerm(match_expressions=(
            t.NodeSelectorRequirement("num", t.OP_EXISTS),)),)),
        preferred=(t.PreferredSchedulingTerm(5, t.NodeSelectorTerm(match_expressions=(
            t.NodeSelectorRequirement("disk", t.OP_IN, ("hdd",)),))),),
    )


def spread_inputs(shape: str, seed: int, dev):
    """The cluster of one spread shape, a featurized 4096-pod batch of the
    workload's pods, and the 32 mixed pods featurized under the default
    profile and under one with addedAffinity."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE

    n_nodes, zones, _bound, tmpl = SPREAD_SHAPES[shape]
    builder, rng = spread_cluster(shape, seed, dev)
    make = getattr(workloads, tmpl)
    mixed = spread_mixed_pods(rng, zones, n_nodes)
    added = dataclasses.replace(DEFAULT_PROFILE, added_affinity=_added_affinity())
    # Twice: the first round interns every group and label, so the second
    # round's features all have the final schema's widths.
    for _round in range(2):
        big, _, big_active = build_pod_batch([make(i) for i in range(4096)], builder, DEFAULT_PROFILE, 4096)
        batches = {}
        for label, prof in (("default", DEFAULT_PROFILE), ("added_affinity", added)):
            batch, _, active = build_pod_batch(mixed, builder, prof, 32)
            batches[label] = (prof, batch, active)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {"builder": builder, "state": builder.state(), "rng": rng, "big_active": big_active,
           "big_pf": {k: to(v) for k, v in big.items()}, "mixed": {}}
    for label, (prof, batch, active) in batches.items():
        pf = {k: to(v) for k, v in batch.items()}
        pf["nominated_row"] = torch.full((32,), -1, dtype=torch.int32, device=dev)
        out["mixed"][label] = (prof, pf, active)
    out["big_pf"]["nominated_row"] = torch.full((4096,), -1, dtype=torch.int32, device=dev)
    want = {"PodTopologySpread", "NodeAffinity", "TaintToleration"}
    for label, (_p, _pf, active) in out["mixed"].items():
        if not want <= active:
            raise AssertionError(f"the mixed pods leave {want - active} inactive ({label})")
    return out


def rounding_case(dev, errs: dict) -> None:
    """late_scores at a rounding boundary: a hostname ScheduleAnyway
    constraint over 17 scored nodes, one holding 9 matching pods, scores
    9·log(19) = 26.49995..., 5e-5 below the rounding point; the kernel
    must equal the plain version and round it to 26."""
    import torch

    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.engine.pass_ import eval_spec, late_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.ops import podtopologyspread as spread_op
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    for i in range(17):
        cache.add_node(make_node(f"r{i}").capacity({"cpu": "64", "memory": "64Gi", "pods": 110}).obj())
    for i in range(9):
        cache.add_pod(make_pod(f"e{i}").req({"cpu": "100m"}).label("app", "web").node("r0").obj())
    pods = [make_pod(f"q{k}").req({"cpu": "100m"}).label("app", "web").spread_constraint(
        1, HOST, t.SCHEDULE_ANYWAY, "app", ["web"]).obj() for k in range(8)]
    for _round in range(2):
        batch, _, active = build_pod_batch(pods, builder, DEFAULT_PROFILE, 8)
    state = builder.state()
    pf = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    spec = eval_spec(DEFAULT_PROFILE, builder.schema, builder.res_col, active)
    late = late_spec(DEFAULT_PROFILE, builder.schema, builder.res_col, active)
    bits = plain.node_filters(state, pf, spec.ctx)
    feas = state.valid[None, :].expand(8, -1).contiguous()
    zero = torch.zeros(feas.shape, dtype=torch.int64, device=dev)
    kt = kernels.late_scores(state, pf, feas, zero.clone(), bits, late)
    pt = plain.late_scores(state, pf, feas, zero.clone(), bits, late)
    torch.cuda.synchronize()
    exact(errs, "late_scores", "[rounding boundary]", kt, pt)
    _scored, raw = spread_op.raw_score(state, pf, spec.ctx, feas, (bits & 1) != 0, (bits & 2) != 0)
    row = builder.interns.node_names.get("r0")
    row = int(torch.nonzero(state.name_id == row)[0, 0])
    if int(raw[0, row]) != 26:
        raise AssertionError(f"rounding boundary: raw score {int(raw[0, row])}, want 26")
    print("late_scores [rounding boundary]: exact; 9·log(19) rounds to 26")


def _chunk(pf: dict, i: int, c: int) -> dict:
    return {k: v[i * c:(i + 1) * c].contiguous() for k, v in pf.items()}


def check_spread_kernels(dev, shape: str, reps: int) -> dict:
    """Phase 3, one spread shape (spread_na: C=8, N=1024; inclusion: C=8,
    N=8192): node_filters, spread_filter, eval_chunk with their planes,
    late_scores, select_host, resolve_commit and conflict_pairs against
    their plain versions, exactly, on the 32 mixed pods (four chunks of 8,
    default profile and addedAffinity, the final feasible set and a random
    one) and on the workload's pods; returns each one's timings (on the
    workload's first chunk, and node_filters and conflict_pairs on its
    4096-pod batch), bound and largest error."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec, late_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    x = spread_inputs(shape, 2468, dev)
    builder, state, rng = x["builder"], x["state"], x["rng"]
    schema, res_col = builder.schema, builder.res_col
    errs: dict[str, float] = {}
    c, n = 8, state.valid.shape[0]
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    stats = {"rejected_by_spread": 0, "rejected_by_na": 0, "rejected_by_taint": 0, "pods_nowhere": 0}

    def run_chunk(label, prof, pf, active, bits, timing=False):
        spec = eval_spec(prof, schema, res_col, active)
        late = late_spec(prof, schema, res_col, active)
        ks = kernels.spread_filter(state, pf, bits, spec.ctx)
        ps = plain.spread_filter(state, pf, bits, spec.ctx)
        torch.cuda.synchronize()
        exact(errs, "spread_filter", f"[{label}]", ks, ps)
        ke = kernels.eval_chunk(state, pf, spec, None, (bits, ps))
        pe = plain.eval_chunk(state, pf, spec, None, (bits, ps))
        torch.cuda.synchronize()
        for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
            exact(errs, "eval_chunk", f"[{label}] {what}", a, b)
        stats["rejected_by_spread"] += int((state.valid & ~ps).sum())
        stats["rejected_by_na"] += int((state.valid & ((bits & 1) == 0)).sum())
        stats["rejected_by_taint"] += int((state.valid & ((bits & 2) == 0)).sum())
        holes = pe[0] & torch.from_numpy(rng.random((c, n)) < 0.7).to(dev)
        for what, feas in (("final feasible", pe[0]), ("feasible with holes", holes)):
            base = torch.where(feas, pe[1], 0)
            kt = kernels.late_scores(state, pf, feas, base.clone(), bits, late)
            pt = plain.late_scores(state, pf, feas, base.clone(), bits, late)
            torch.cuda.synchronize()
            exact(errs, "late_scores", f"[{label}] {what}", kt, pt)
        pl = plain.late_scores(state, pf, pe[0], pe[1].clone(), bits, late)
        steps = torch.from_numpy(rng.integers(0, 2**32, size=c, dtype=np.int64)).to(dev)
        ksel = kernels.select_host(pe[0], pl, steps, seed_mul, pf["nominated_row"])
        psel = plain.select_host(pe[0], pl, steps, seed_mul, pf["nominated_row"])
        torch.cuda.synchronize()
        for what, a, b in zip(("pick", "best", "feasible_count"), ksel, psel):
            exact(errs, "select_host", f"[{label}] {what}", a, b)
        stats["pods_nowhere"] += int((psel[2] == 0).sum())
        if not timing:
            return None
        out = {
            "spread_filter": timed(lambda _: kernels.spread_filter(state, pf, bits, spec.ctx),
                                   lambda _: plain.spread_filter(state, pf, bits, spec.ctx), reps),
            "eval_chunk": timed(lambda _: kernels.eval_chunk(state, pf, spec, None, (bits, ps)),
                                lambda _: plain.eval_chunk(state, pf, spec, None, (bits, ps)), reps),
            "late_scores": timed(lambda a: kernels.late_scores(state, pf, pe[0], a, bits, late),
                                 lambda a: plain.late_scores(state, pf, pe[0], a, bits, late), reps,
                                 lambda: pe[1].clone()),
            "select_host": timed(lambda _: kernels.select_host(pe[0], pl, steps, seed_mul, pf["nominated_row"]),
                                 lambda _: plain.select_host(pe[0], pl, steps, seed_mul, pf["nominated_row"]),
                                 reps),
        }
        return out, spec, late, pe, pl, psel[0], ps

    if shape == "spread_na":
        rounding_case(dev, errs)
    # The mixed pods: node_filters over the 32-pod batch, then four chunks.
    for label, (prof, pf, active) in x["mixed"].items():
        ctx = eval_spec(prof, schema, res_col, active).ctx
        kb = kernels.node_filters(state, pf, ctx)
        pb = plain.node_filters(state, pf, ctx)
        torch.cuda.synchronize()
        exact(errs, "node_filters", f"[{label}]", kb, pb)
        for i in range(4):
            run_chunk(f"{label} chunk {i}", prof, _chunk(pf, i, c), active, pb[i * c:(i + 1) * c].contiguous())
        kp = kernels.conflict_pairs(pf, 4, c)
        pp = plain.conflict_pairs(pf, 4, c)
        torch.cuda.synchronize()
        exact(errs, "conflict_pairs", f"[{label}]", kp, pp)
    # The workload's pods: node_filters and conflict_pairs over the batch,
    # the other kernels on its first chunk (timed there).
    big, active = x["big_pf"], x["big_active"]
    ctx = eval_spec(DEFAULT_PROFILE, schema, res_col, active).ctx
    kb = kernels.node_filters(state, big, ctx)
    pb = plain.node_filters(state, big, ctx)
    kp = kernels.conflict_pairs(big, 512, c)
    pp = plain.conflict_pairs(big, 512, c)
    torch.cuda.synchronize()
    exact(errs, "node_filters", "[workload batch]", kb, pb)
    exact(errs, "conflict_pairs", "[workload batch]", kp, pp)
    pf0, bits0 = _chunk(big, 0, c), pb[:c].contiguous()
    result, spec0, late0, pe0, pl0, picks0, ps0 = run_chunk("workload chunk", DEFAULT_PROFILE, pf0, active,
                                                              bits0, timing=True)
    result["node_filters"] = timed(lambda _: kernels.node_filters(state, big, ctx),
                                   lambda _: plain.node_filters(state, big, ctx), reps)
    result["conflict_pairs"] = timed(lambda _: kernels.conflict_pairs(big, 512, c),
                                     lambda _: plain.conflict_pairs(big, 512, c), reps)
    # resolve_commit on the workload chunk: its picks, the chunk's pairs.
    et_slot = torch.zeros(schema.ET, dtype=torch.int32, device=dev)
    dom = build_dom(state, et_slot, torch.zeros(schema.ET, dtype=torch.bool, device=dev), schema.DV)
    for strict in (False, True):
        sk, dk = state.clone(), clone_dom(dom)
        sp, dp = state.clone(), clone_dom(dom)
        ok_ = kernels.resolve_commit(sk, dk, pf0, picks0, pp[0], strict)
        op_ = plain.resolve_commit(sp, dp, pf0, picks0, pp[0], strict)
        torch.cuda.synchronize()
        exact(errs, "resolve_commit", f"[{shape}] (strict={strict}) picks", ok_, op_)
        for f in ("req", "nonzero_req", "num_pods", "group_counts"):
            exact(errs, "resolve_commit", f"[{shape}] (strict={strict}) state.{f}", getattr(sk, f), getattr(sp, f))
    result["resolve_commit"] = timed(
        lambda a: kernels.resolve_commit(a[0], a[1], pf0, picks0, pp[0], False),
        lambda a: plain.resolve_commit(a[0], a[1], pf0, picks0, pp[0], False), reps,
        lambda: (state.clone(), clone_dom(dom)))
    # Bounds: the bytes each must move for this run's inputs.
    k = big["valid"].shape[0]
    att = picks0 >= 0
    rows = int(torch.unique(picks0[att]).numel())
    commit_bytes = (rows * (schema.R * 8 * 3 + 2 * 8 * 2 + 4 * 3 + schema.TK * 4) * 2
                    + c * (4 + 1 + schema.R * 8 + 2 * 8 + 4) + c * c + c * 4)
    for name, nb in (("node_filters", nf_bytes(state, big, ctx)),
                     ("spread_filter", spread_bytes(state, pf0, "tps_h") + c * n),
                     ("eval_chunk", eval_bytes(state, pf0, None) + 2 * c * n),
                     ("late_scores", late_bytes(state, pf0, late0, c)),
                     ("select_host", select_bytes(c, n)), ("conflict_pairs", spread_pair_bytes(big, c)),
                     ("resolve_commit", commit_bytes)):
        set_bound(result[name], nb)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    print(f"{shape} shapes: C={c}, N={n}, K={k}, G={schema.G}, TK={schema.TK}, DV={schema.DV}, "
          f"LS={schema.LS}, TS={schema.TS}, TV={schema.TV}; mixed chunks: {stats}; workload chunk: "
          f"{int(pe0[0].sum())} feasible (pod, node) pairs, spread rejects {int((state.valid & ~ps0).sum())}")
    return result


def spread_bytes(state, pf: dict, prefix: str) -> int:
    """spread_filter's (and the spread part of late_scores') reads for this
    chunk's data: the constraints' valid flags; and only where a constraint
    is valid, its features and group mask, the 32-byte sectors of the
    topology values in its key's column, node validity, the node_filters
    bits row of each pod with an inclusion policy, and one group_counts row
    per distinct group the valid constraints select."""
    import torch

    n = state.valid.shape[0]
    valid = pf[f"{prefix}_valid"]
    b = nbytes(valid)
    if not bool(valid.any()):
        return b
    nv = int(valid.sum())
    b += nv * sum(pf[f"{prefix}_{f}"].element_size()
                  for f in ("slot", "skew", "mindom", "self", "hostname", "aff", "taint"))
    groups = pf[f"{prefix}_groups"] & valid[:, :, None]
    b += nv * groups.shape[2]
    slots = torch.unique(pf[f"{prefix}_slot"][valid]).long()
    offsets = torch.arange(n, device=slots.device)[:, None] * state.topo_vals.shape[1] + slots[None, :]
    b += int(torch.unique(offsets * 4 // 32).numel()) * 32
    b += nbytes(state.valid)
    policy = valid & (pf[f"{prefix}_aff"] | pf[f"{prefix}_taint"])
    b += int(policy.any(dim=1).sum()) * n
    used = int(torch.unique(torch.nonzero(groups, as_tuple=True)[2]).numel())
    return b + used * n * 4


def label_bytes(state) -> int:
    """The nodes' label slots and names, which a requirement program reads."""
    return nbytes(state.label_key_ids, state.label_pair_ids, state.label_int_vals, state.name_id)


def program_bytes(pf: dict, prefix: str, rows, fields) -> int:
    """The requirement programs (``prefix``_op/key/vals/int...) of the pods in ``rows``."""
    return nbytes(*(pf[f"{prefix}_{f}"][rows] for f in fields))


def nf_bytes(state, pf: dict, ctx) -> int:
    """node_filters for this batch's data: the bits written; the selector
    pairs and flags; all label slots and the programs of the pods with
    required (or added) terms where there are any, else the label pair
    slots where some pod has a selector pair; the hard intolerance masks,
    and the taint slots only where some pod has an intolerable taint."""
    k, n = pf["valid"].shape[0], state.valid.shape[0]
    b = k * n
    if "na_sel_pairs" in pf:
        sel, has_req = pf["na_sel_pairs"], pf["na_has_required"]
        fields = ("op", "key", "vals", "int", "term_valid")
        b += nbytes(sel, has_req)
        prog, evaluates = program_bytes(pf, "na_req", has_req, fields), has_req
        if ctx.profile.added_affinity is not None:
            has_add = pf["na_has_added"]
            b += nbytes(has_add)
            prog += program_bytes(pf, "na_add", has_add, fields)
            evaluates = has_req | has_add
        if bool(evaluates.any()):
            b += prog + label_bytes(state)
        elif bool((sel >= 0).any()):
            b += nbytes(state.label_pair_ids)
    if "taint_intol_hard" in pf:
        intol = pf["taint_intol_hard"]
        b += nbytes(intol)
        if bool(intol.any()):
            b += nbytes(state.taint_ids)
    return b


def late_bytes(state, pf: dict, late, c: int) -> int:
    """late_scores for this chunk's data: the feasible set read, `total`
    read and written, and what each scoring op must read: NodeAffinity the
    term weights, and the label slots and preferred programs only where a
    pod has a term of non-zero weight; TaintToleration the soft
    intolerance masks, and the taint slots only where some pod has an
    intolerable PreferNoSchedule taint; spread as spread_bytes for the
    ScheduleAnyway constraints."""
    n = state.valid.shape[0]
    b = c * n + 2 * c * n * 8
    if late.na_weight:
        w = pf["na_pref_weight"]
        b += nbytes(w)
        rows = (w != 0).any(dim=1)
        if bool(rows.any()):
            b += label_bytes(state) + program_bytes(pf, "na_pref", rows, ("op", "key", "vals", "int"))
    if late.taint_weight:
        intol = pf["taint_intol_pref"]
        b += nbytes(intol)
        if bool(intol.any()):
            b += nbytes(state.taint_ids)
    if late.spread_weight:
        b += spread_bytes(state, pf, "tps_s")
    return b


def spread_pair_bytes(pf: dict, c: int) -> int:
    """conflict_pairs on a spread batch: the group ids once, per chunk and
    reader j one DoNotSchedule mask byte per constraint at each distinct
    group of the chunk, the table written once."""
    import torch

    k = pf["valid"].shape[0]
    ch = pf["tps_h_groups"].shape[1]
    g = pf["group"].view(k // c, c)
    distinct = sum(int(torch.unique(g[b]).numel()) for b in range(k // c))
    return nbytes(pf["group"]) + distinct * c * ch + k * c


def spread_gates(outcomes, n_nodes: int, zones: int, max_skew: int, tainted) -> None:
    """Per app, the pod counts per zone differ by at most maxSkew (over the
    zones that hold untainted nodes); no pod on a tainted node."""
    from collections import Counter

    counts = Counter()
    for o in outcomes:
        i = int(o.node_name.rsplit("-", 1)[1])
        if tainted(i):
            raise AssertionError(f"{o.pod.name} bound to the tainted node {o.node_name}")
        counts[(o.pod.metadata.labels["app"], i % zones)] += 1
    eligible = sorted({i % zones for i in range(n_nodes) if not tainted(i)})
    for app in sorted({a for a, _ in counts}):
        per_zone = [counts[(app, z)] for z in eligible]
        if max(per_zone) - min(per_zone) > max_skew:
            raise AssertionError(f"{app}: zone counts {per_zone} differ by more than {max_skew}")


def run_workload(impl: str, nodes, warm, measured, batch: int, chunk: int, trace: bool = False):
    """One burst through TorchScheduler: the nodes, the warm-up pods
    (scheduled first), then the measured pods, timed.  With ``trace``, the
    measured window also records host spans (featurize, the host-to-device
    copies of the batch features, the rest of dispatch, the result fetch
    that waits for the device, the rest of completion) and a
    torch.profiler trace of the card's kernels."""
    import torch

    from kubernetes_tpu_torch import scheduler as sched_mod
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE

    from kubernetes_tpu_torch.snapshot import _NODE_AXIS

    s = sched_mod.TorchScheduler(DEFAULT_PROFILE, batch_size=batch, chunk_size=chunk, _impl=impl)
    # Data movement outside the hand kernels, counted over the whole run:
    # the dirty-row flush (one index_copy_ per node-axis field) and the
    # uniform batch's broadcast (one expand copy per feature).
    moves = {"index_copy_": 0, "expand": 0}
    orig_state, orig_expand = s.builder.state, sched_mod._expand_uniform

    def state():
        b = s.builder
        if not (b._dirty_all or b._device is None) and b._dirty_rows:
            moves["index_copy_"] += len(_NODE_AXIS)
        return orig_state()

    def expand(small, k):
        moves["expand"] += len(small)
        return orig_expand(small, k)

    s.builder.state, sched_mod._expand_uniform = state, expand
    for node in nodes:
        s.add_node(node)
    for pod in warm:
        s.add_pod(pod)
    out = s.schedule_all_pending()
    torch.cuda.synchronize()
    for pod in measured:
        s.add_pod(pod)
    spans = {"featurize": 0.0, "h2d": 0.0, "dispatch": 0.0, "fetch": 0.0, "complete": 0.0}
    h2d_bytes = [0]
    prof = None
    orig_featurize = sched_mod.build_pod_batch
    if trace:
        def span(name, fn):
            def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spans[name] += time.perf_counter() - t
            return wrapped

        def to_device(batch_np):
            h2d_bytes[0] += sum(getattr(v, "nbytes", 0) for v in batch_np.values())
            return orig_to_device(batch_np)

        orig_to_device = s._to_device
        sched_mod.build_pod_batch = span("featurize", orig_featurize)
        s._to_device = span("h2d", to_device)
        s._dispatch_batch = span("dispatch", s._dispatch_batch)
        s._fetch = span("fetch", s._fetch)
        s._complete_batch = span("complete", s._complete_batch)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    measured_out = s.schedule_all_pending()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    s.builder.state, sched_mod._expand_uniform = orig_state, orig_expand
    s.data_moves = moves
    if trace:
        prof.__exit__(None, None, None)
        sched_mod.build_pod_batch = orig_featurize
        device = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                device[ev.key] = getattr(ev, "device_time_total", 0.0) / 1e3
        # featurize and the copies run inside dispatch (and the host tail
        # inside complete); fetch (the wait for the device's results)
        # inside complete.
        other = (spans["dispatch"] + spans["complete"] - spans["featurize"] - spans["h2d"]
                 - spans["fetch"])
        spans = {"featurize_s": spans["featurize"], "h2d_s": spans["h2d"],
                 "h2d_bytes": h2d_bytes[0], "fetch_wait_s": spans["fetch"],
                 "other_host_s": other, "device_ms_by_kernel": device}
    return s, out + measured_out, len(measured_out), dt, spans


def run_density(impl: str, trace: bool = False):
    """The density burst (harness.py:469)."""
    from kubernetes_tpu_torch.workloads import (
        DENSITY_BATCH, DENSITY_CHUNK, DENSITY_MEASURED_PODS, DENSITY_NODES,
        basic_nodes, pod_basic, warm_pods,
    )

    return run_workload(impl, basic_nodes(DENSITY_NODES), warm_pods(),
                        [pod_basic(i) for i in range(DENSITY_MEASURED_PODS)],
                        DENSITY_BATCH, DENSITY_CHUNK, trace)


def run_ipa(impl: str, trace: bool = False):
    """The inter-pod-affinity burst (harness.py:431-464)."""
    from kubernetes_tpu_torch.workloads import (
        IPA_BATCH, IPA_CHUNK, IPA_MEASURED_PODS, IPA_NODES, IPA_WARM_PODS, IPA_ZONES,
        basic_nodes, pod_ipa_heavy, warm_pods,
    )

    return run_workload(impl, basic_nodes(IPA_NODES, zones=IPA_ZONES),
                        warm_pods(IPA_WARM_PODS, pod_ipa_heavy),
                        [pod_ipa_heavy(i) for i in range(IPA_MEASURED_PODS)],
                        IPA_BATCH, IPA_CHUNK, trace)


def run_spread_na(impl: str, trace: bool = False):
    """The spread + node-affinity burst (harness.py:408-430)."""
    from kubernetes_tpu_torch.workloads import (
        SPREAD_BATCH, SPREAD_CHUNK, SPREAD_MEASURED_PODS, SPREAD_NODES, SPREAD_WARM_PODS,
        SPREAD_ZONES, basic_nodes, pod_spread_na, warm_pods,
    )

    return run_workload(impl, basic_nodes(SPREAD_NODES, zones=SPREAD_ZONES),
                        warm_pods(SPREAD_WARM_PODS, pod_spread_na),
                        [pod_spread_na(i) for i in range(SPREAD_MEASURED_PODS)],
                        SPREAD_BATCH, SPREAD_CHUNK, trace)


def run_inclusion(impl: str, trace: bool = False):
    """The node-inclusion-policy burst (harness.py:1185-1219)."""
    from kubernetes_tpu_torch.workloads import (
        INCLUSION_MEASURED_PODS, INCLUSION_WARM_PODS, SPREAD_BATCH, SPREAD_CHUNK,
        inclusion_nodes, pod_inclusion, warm_pods,
    )

    return run_workload(impl, inclusion_nodes(), warm_pods(INCLUSION_WARM_PODS, pod_inclusion),
                        [pod_inclusion(i) for i in range(INCLUSION_MEASURED_PODS)],
                        SPREAD_BATCH, SPREAD_CHUNK, trace)


def check_density(s, outcomes, expected: int, label: str) -> dict:
    import numpy as np

    bind = {o.pod.name: o.node_name for o in outcomes}
    unbound = [k for k, v in bind.items() if v is None]
    if len(bind) != expected or unbound:
        raise AssertionError(f"{label}: {len(bind)} outcomes, {len(unbound)} unbound, want {expected} bound")
    if not s.builder.host_mirror_equal():
        raise AssertionError(f"{label}: host mirror differs from the device state")
    h = s.builder.host
    v = h["valid"]
    if (h["req"][v] > h["alloc"][v]).any() or (h["num_pods"][v] > h["allowed_pods"][v]).any():
        raise AssertionError(f"{label}: a node exceeds its allocatable")
    if int(h["num_pods"].sum()) != expected:
        raise AssertionError(f"{label}: {int(h['num_pods'].sum())} pods on nodes, want {expected}")
    return bind


# The main paths: (runner, pods bound, kernels that must launch, gate).
def _paths():
    from kubernetes_tpu_torch import workloads as w

    base = ("build_dom", "eval_chunk", "select_host", "resolve_commit")
    spread = base + ("conflict_pairs", "node_filters", "spread_filter", "late_scores")
    return {
        "density": (run_density, w.DENSITY_WARM_PODS + w.DENSITY_MEASURED_PODS, base, None),
        "ipa": (run_ipa, w.IPA_WARM_PODS + w.IPA_MEASURED_PODS, base + ("ipa_eval", "conflict_pairs"),
                ipa_anti_ok),
        "spread_na": (run_spread_na, w.SPREAD_WARM_PODS + w.SPREAD_MEASURED_PODS, spread,
                      lambda out: spread_gates(out, w.SPREAD_NODES, w.SPREAD_ZONES, w.SPREAD_MAX_SKEW,
                                               lambda i: False)),
        "inclusion": (run_inclusion, w.INCLUSION_WARM_PODS + w.INCLUSION_MEASURED_PODS, spread,
                      lambda out: spread_gates(out, w.INCLUSION_NODES, w.INCLUSION_ZONES,
                                               w.INCLUSION_MAX_SKEW, lambda i: i % 2 == 1)),
    }


def drive(path: str, card: str) -> tuple[dict, dict]:
    """Phases 4-7: one main path through the kernels (launch counts set to
    0 just before and read just after), traced, and through the plain
    versions; gates, launch counts and identical bindings required.
    Returns (launch counts, data moves)."""
    from kubernetes_tpu_torch import kernels

    runner, expected, must, gate = _paths()[path]
    kernels.reset_launches()
    s, out, measured, dt, _ = runner("kernel")
    launches = kernels.launch_counts()
    bind_k = check_density(s, out, expected, f"{path} kernel path")
    if gate is not None:
        gate(out)
    print(f"{path} (kernels): {len(out)} pods bound; measured {measured} pods in {dt:.3f}s = "
          f"{measured / dt:.1f} pods/s; deferred {s.deferred}; packed batches {s.packed_batches}, "
          f"planned collisions {s.pack_collisions}, last pack width {s.pack_width}; domain tables "
          f"rebuilt {s.dom_carry_rebuilds}, carried {s.dom_carry_hits}; schema N={s.builder.schema.N} "
          f"G={s.builder.schema.G} ET={s.builder.schema.ET} DV={s.builder.schema.DV}; launches {launches}; "
          f"data moves {s.data_moves}  [{card}]")
    for name, count in launches.items():
        if (count == 0) == (name in must):
            raise AssertionError(f"{path} path: {name} launched {count} times")
    s3, out3, _m3, dt3, spans = runner("kernel", trace=True)
    if check_density(s3, out3, expected, f"traced {path} kernel path") != bind_k:
        raise AssertionError(f"the traced {path} run bound differently")
    print_trace(path, dt3, spans, card)
    s2, out2, measured2, dt2, _ = runner("plain")
    compare_bindings(bind_k, check_density(s2, out2, expected, f"{path} plain path"))
    print(f"{path} (plain versions on the card): identical bindings; measured {measured2} pods in "
          f"{dt2:.3f}s = {measured2 / dt2:.1f} pods/s  [{card}]")
    return launches, s.data_moves


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true", help="stop after the kernel checks")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import kubernetes_tpu_torch  # noqa: F401  (fails outside the repository)
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import build

    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    shapes = {"density": check_kernels(dev, REPS), "ipa": check_ipa_kernels(dev, REPS),
              "spread_na": check_spread_kernels(dev, "spread_na", REPS),
              "inclusion": check_spread_kernels(dev, "inclusion", REPS)}
    for shape, table in shapes.items():
        for name, tm in table.items():
            print(f"{name} [{shape} shapes]: device ms: kernel {tm['ms']:.4f}, plain {tm['plain_ms']:.4f}, "
                  f"bound {tm['bound_ms']:.5f} ({tm['bound_by']}: {tm['bytes']} bytes, {tm['ops']} "
                  f"operations); call ms with the host's launch overhead: kernel {tm['call_ms']:.4f}, "
                  f"plain {tm['plain_call_ms']:.4f}  [{card}]")

    by_path: dict[str, dict] = {}  # empty: the main paths did not run
    moves: dict[str, dict] = {}
    if not args.kernels_only:
        for path in _paths():
            by_path[path], moves[path] = drive(path, card)
        print(f"data moves outside the hand kernels, launches per path: {moves}  [{card}]")

    csrc = "kubernetes_tpu_torch/kernels/csrc/"
    replaces = {
        "build_dom": "kubernetes_tpu/engine/pass_.py:96",
        "eval_chunk": "kubernetes_tpu/engine/pass_.py:494",
        "ipa_eval": "kubernetes_tpu/ops/interpodaffinity.py:283",
        "select_host": "kubernetes_tpu/engine/pass_.py:136",
        "resolve_commit": "kubernetes_tpu/engine/pass_.py:570",
        "conflict_pairs": "kubernetes_tpu/engine/pass_.py:266",
        "node_filters": "kubernetes_tpu/ops/nodeaffinity.py:285",
        "spread_filter": "kubernetes_tpu/ops/podtopologyspread.py:219",
        "late_scores": "kubernetes_tpu/ops/podtopologyspread.py:261",
    }
    # The top-level numbers of a kernel come from the shapes of the path it
    # was first ported for (density: eval_chunk, select_host,
    # resolve_commit; IPA: build_dom, ipa_eval, conflict_pairs; spread_na:
    # node_filters, spread_filter, late_scores); "by_shape" holds every
    # shape it was measured at.  "launches" sums the main paths' runs,
    # "launches_by_path" splits them.
    first = {name: "ipa" for name in kernels.WRAPPERS}
    first.update(eval_chunk="density", select_host="density", resolve_commit="density",
                 node_filters="spread_na", spread_filter="spread_na", late_scores="spread_na")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    line = {"kernels": [], "data_moves_by_path": moves}
    for name in kernels.WRAPPERS:
        top = shapes[first[name]][name]
        counts = {path: c[name] for path, c in by_path.items()}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": f"{csrc}{build.ENTRIES[name]}.cu",
            "replaces": replaces[name],
            "launches": sum(counts.values()) if counts else None, "launches_by_path": counts,
            "max_abs_err": max(t[name]["max_abs_err"] for t in shapes.values() if name in t),
            **{k: top[k] for k in keys}, "library_ms": None,
            "by_shape": {shape: {k: t[name][k] for k in keys} for shape, t in shapes.items() if name in t},
        })
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def print_trace(label: str, dt: float, spans: dict, card: str) -> None:
    busy = sum(spans["device_ms_by_kernel"].values()) / 1e3
    top = sorted(spans["device_ms_by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} traced window {dt:.3f}s: featurize {spans['featurize_s']:.3f}s, host-to-device "
          f"features {spans['h2d_s']:.3f}s ({spans['h2d_bytes']} bytes), waiting on device results "
          f"{spans['fetch_wait_s']:.3f}s, other host {spans['other_host_s']:.3f}s; device busy "
          f"{busy:.3f}s ({'not measured' if busy == 0 else f'{1 - busy / dt:.3f} idle share'})  [{card}]")
    for key, ms in top:
        print(f"  device {ms:9.3f} ms  {key[:90]}")


def compare_bindings(bind_k: dict, bind_p: dict) -> None:
    if bind_k != bind_p:
        diff = [k for k in bind_k if bind_k[k] != bind_p.get(k)]
        raise AssertionError(f"kernel and plain bindings differ for {len(diff)} pods, e.g. {diff[:5]}")


if __name__ == "__main__":
    sys.exit(main())
