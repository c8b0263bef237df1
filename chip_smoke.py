#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --compare DIR --paths density,daemonset_15kn
        # only: these paths' windows in another tree of the port (DIR, e.g.
        # the parent commit unpacked) and in this one, back to back on one
        # card, three times in the order DIR, this, this, DIR

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
     - at the two preemption shapes (preemption_500n: N=512, 2000 bound
       background pods under two PDBs, one with no disruption left, batch
       512; preemption_async_5kn: N=8192, 5000 bound pods, batch 1024): the
       victim pack through unpack_victims, then preempt_eval, preempt_pick
       and preempt_commit on a chunk-1 dry-run, the uniform batch's rank
       split, a mixed 64-pod chunk whose other-signature mates defer, and
       the speculative mode; scatter_rows into fields of both node axes and
       into the victim buffer, expand_rows of every feature (their library
       yardsticks index_copy_ and repeat timed beside them); and the main
       pass's eval_chunk, select_host and resolve_commit at the path's own
       chunk (64 and 128), with a nominated-pod overlay and duplicate picks
       on full and emptied rows;
     - at the daemonset shapes (K=4096 pinned pods, N=16384): node_filters,
       eval_chunk and late_scores in pinned mode (each pod on its own node,
       pins that name no node, nominated pins, a preferred zone term),
       pinned_fit with same-row overflow, and the strict resolve_commit;
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
     - preemption_500n (500 nodes of 4 CPU, 2000 priority-1 pods, a
       warm-up preemptor, then 500 preemptors of 2 CPU at priority 1000)
       and preemption_async_5kn (5000 nodes, 20000 background pods of which
       15000 stay unschedulable, then 1000 preemptors), fit-only profile,
       the reference's 1 s backoff waited on the wall clock, each run
       three times through the kernels: every preemptor binds, every
       victim is a priority-1 background pod, and the plain run evicts the
       same victims;
     - daemonset_15kn (15000 nodes, 512 + 15000 pods each pinned to its
       node by matchFields): every batch takes the pinned pass and every
       pod lands on its node;
     - intree_pvs_5kn_2kpods, migrated_intree_pvs_5kn_5kpods and
       csi_pvs_5kn_5kpods (5000 nodes in 10 zones; 512 warm-up pods, then
       2000, 5000 and 5000 pods with claims on zonal PVs, on CSI-fronted
       PVs under attach limits, and on WaitForFirstConsumer claims
       provisioned at PreBind): every pod with a zonal PV sits in its
       zone, csi_used equals the distinct attached volumes and stays
       within csi_limit, every CSI claim is bound to a provisioned PV that
       names it, and no whole-state upload happens in the window;
     every run of a path must give the same outcome count and send the
     same number of pods to backoff; pods/s, the idle share, deferrals,
     preemptions, the backoff waited and the garbage collector's pauses in
     each window, the pack width, the host-to-device feature bytes and the
     data moves (scatter_rows and expand_rows launches; torch index_copy_
     and expand calls, which must be 0) are printed;
  5. print the per-kernel JSON line (launches per path, and the numbers of
     every shape a kernel was measured at), the card line, and last the
     device line.

Exits non-zero, printing no result, when CUDA is unavailable or the
package is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
    # Equal entries (infinite start times included) differ by 0.
    diff = torch.where(a == b, 0, (a.to(wide) - b.to(wide)).abs())
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


def timed(kernel_fn, plain_fn, reps: int, setup=None, plain_reps: int | None = None) -> dict:
    """Medians of ``reps`` calls of the kernel and of ``plain_reps``
    (default ``reps``) of its plain version."""
    ms, call_ms = median_ms(kernel_fn, reps, setup)
    plain_ms, plain_call_ms = median_ms(plain_fn, plain_reps or reps, setup)
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


# The preemption shapes: (nodes, background pods per node, background cpu,
# memory, batch, PDBs, the main pass's chunk), from preemption_500n and
# preemption_async_5kn.
PREEMPT_SHAPES = {
    "preemption_500n": (500, 4, "1", "2Gi", 512, True, 64),
    "preemption_async_5kn": (5000, 1, "3900m", "15Gi", 1024, False, 128),
}


def preempt_inputs(shape: str, dev):
    """A saturated cluster of the shape's nodes with bound priority-1
    background pods (start times 0, 1, …; at the 500-node shape an eighth
    labelled app=db under a PDB with no disruptions left and an eighth
    app=web under one with three), its victim pack, and a batch of
    preemptors: uniform 2 CPU / 4 GiB at priority 1000, then the same with
    every third pod asking 3 CPU at priority 500 (two signatures)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import fit_only_profile
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    n_nodes, per, cpu, mem, k, pdbs, _chunk = PREEMPT_SHAPES[shape]
    s = TorchScheduler(fit_only_profile(), batch_size=k, chunk_size=64, device=dev)
    for node in w.preemption_nodes(n_nodes):
        s.add_node(node)
    for i in range(n_nodes * per):
        p = make_pod(f"bg-{i}").req({"cpu": cpu, "memory": mem}).priority(1).start_time(float(i))
        if pdbs and i % 8 in (0, 1):
            p = p.label("app", "db" if i % 8 == 0 else "web")
        s.add_pod(p.node(f"node-{i // per}").obj())
    if pdbs:
        for name, allowed in (("db", 0), ("web", 3)):
            s.add_pdb(t.PodDisruptionBudget(
                name=name, selector=t.LabelSelector(match_labels=(("app", name),)), disruptions_allowed=allowed))
    uniform = [w.preemptor(f"u{i}") for i in range(k)]
    mixed = [
        make_pod(f"m{i}").req({"cpu": "3", "memory": "4Gi"}).priority(500).obj() if i % 3 == 1
        else w.preemptor(f"m{i}")
        for i in range(k)
    ]
    batches = {}
    for label, pods in (("uniform", uniform), ("mixed", mixed)):
        batch, _deltas, active = build_pod_batch(pods, s.builder, s.profile, k)
        sigs, _ = s.preemption._sig_ids(pods, k)
        tb = {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for key, v in batch.items()}
        tb["sig"] = torch.from_numpy(sigs).to(dev)
        batches[label] = (tb, active)
    pack = s.preemption.pack_victims(s.profile, batches["uniform"][1])
    return s, pack, batches


def commit_bytes(schema, picks, c: int, pairs: bool = True) -> int:
    """resolve_commit: the picked rows' alloc, req, nonzero_req, num_pods,
    allowed_pods and topo_vals read and their req, nonzero_req and
    num_pods written, one group_counts cell and TK group_dom cells per
    distinct row read and written; the pods' picks, valid flags, requests
    and groups (and the C x C pairs unless strict) read, the picks written."""
    import torch

    rows = int(torch.unique(picks[picks >= 0]).numel())
    row_bytes = rows * (schema.R * 8 * 3 + 2 * 8 * 2 + 4 * 3 + schema.TK * 4)
    cell_bytes = rows * (4 + schema.TK * 4) * 2
    return row_bytes + cell_bytes + c * (4 + 1 + schema.R * 8 + 2 * 8 + 4) + (c * c if pairs else 0) + c * 4


def check_main_at(dev, label: str, builder, state, pf_full: dict, active, profile, c: int,
                  errs: dict, reps: int) -> dict:
    """eval_chunk, select_host and resolve_commit against their plain
    versions at a path's own chunk C and node count: the first C pods of
    ``pf_full`` on ``state`` with every seventh node emptied (feasible
    nodes with tied scores beside full ones), with and without a
    nominated-pod overlay on a third of the emptied nodes (priority 700:
    it binds the priority-500 pods and not the others) and nominated rows
    on every fifth pod; resolve_commit strict and not, with duplicate picks
    on full and emptied rows, pods picking nothing, invalid lanes and a
    random conflict table.  Returns the three timings with their bounds."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec
    from kubernetes_tpu_torch.kernels import plain

    rng = np.random.default_rng(4321)
    schema = builder.schema
    n = state.valid.shape[0]
    st = state.clone()
    emptied = torch.arange(0, n, 7, device=dev)
    st.req[emptied] = 0
    st.nonzero_req[emptied] = 0
    st.num_pods[emptied] = 0
    pf = {key: v[:c].contiguous() for key, v in pf_full.items() if key != "sig"}
    nomrow = torch.full((c,), -1, dtype=torch.int32, device=dev)
    nomrow[::5] = emptied[: len(nomrow[::5])].to(torch.int32)
    pf["nominated_row"] = nomrow
    pf["valid"] = pf["valid"].clone()
    pf["valid"][-3:] = False
    claimed = emptied[::3]
    nom_req = torch.zeros_like(st.req)
    nom_req[claimed, 0] = 2000
    nom_cnt = torch.zeros_like(st.num_pods)
    nom_cnt[claimed] = 1
    nom_prio = torch.full_like(st.num_pods, -(2**31))
    nom_prio[claimed] = 700
    nom = (nom_req, nom_cnt, nom_prio)
    spec = eval_spec(profile, schema, builder.res_col, active)
    seed_mul = ((profile.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    steps = torch.arange(c, dtype=torch.int64, device=dev) + 12345
    for nom_in in (nom, None):
        ke = kernels.eval_chunk(st, pf, spec, nom_in)
        pe = plain.eval_chunk(st, pf, spec, nom_in)
        torch.cuda.synchronize()
        for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
            exact(errs, "eval_chunk", f"[{label} C={c}] {what}", a, b)
        nomr = nomrow if nom_in is not None else None
        ks = kernels.select_host(ke[0], ke[1], steps, seed_mul, nomr)
        ps = plain.select_host(pe[0], pe[1], steps, seed_mul, nomr)
        torch.cuda.synchronize()
        for what, a, b in zip(("pick", "best", "feasible_count"), ks, ps):
            exact(errs, "select_host", f"[{label} C={c}] {what}", a, b)
        print(f"eval_chunk/select_host [{label} C={c}, nominated overlay {nom_in is not None}]: exact; "
              f"{int(pe[0].sum())} feasible (pod, node) pairs, {int((ps[2] == 0).sum())} pods feasible "
              f"nowhere, {int((ps[0] == nomr).sum()) if nomr is not None else 0} on their nominated rows")
    out = {
        "eval_chunk": timed(lambda _: kernels.eval_chunk(st, pf, spec, nom),
                            lambda _: plain.eval_chunk(st, pf, spec, nom), reps),
        "select_host": timed(lambda _: kernels.select_host(ke[0], ke[1], steps, seed_mul, None),
                             lambda _: plain.select_host(pe[0], pe[1], steps, seed_mul, None), reps),
    }
    set_bound(out["eval_chunk"], eval_bytes(st, pf, nom))
    set_bound(out["select_host"], select_bytes(c, n))
    full = torch.nonzero((st.alloc[:, 0] - st.req[:, 0] < 2000) & st.valid)[:4, 0]
    rows = torch.cat([full, emptied[:4]]).cpu().numpy()
    picks = torch.from_numpy(rng.choice(rows, c).astype(np.int32)).to(dev)
    picks[::11] = -1
    pairs = torch.from_numpy(rng.random((c, c)) < 0.02).to(dev)
    et_slot0 = torch.zeros(schema.ET, dtype=torch.int32, device=dev)
    dom0 = build_dom(st, et_slot0, torch.zeros(schema.ET, dtype=torch.bool, device=dev), schema.DV)
    for strict in (False, True):
        sk, dk = st.clone(), clone_dom(dom0)
        sp, dp = st.clone(), clone_dom(dom0)
        ok_ = kernels.resolve_commit(sk, dk, pf, picks, pairs, strict)
        op_ = plain.resolve_commit(sp, dp, pf, picks, pairs, strict)
        torch.cuda.synchronize()
        exact(errs, "resolve_commit", f"[{label} C={c}] (strict={strict}) picks", ok_, op_)
        exact(errs, "resolve_commit", f"[{label} C={c}] (strict={strict}) group_dom", dk.group_dom, dp.group_dom)
        for f in ("req", "nonzero_req", "num_pods", "group_counts"):
            exact(errs, "resolve_commit", f"[{label} C={c}] (strict={strict}) state.{f}",
                  getattr(sk, f), getattr(sp, f))
        print(f"resolve_commit [{label} C={c}] (strict={strict}): exact; {int((op_ == -2).sum())} deferred, "
              f"{int((op_ >= 0).sum())} committed")
    out["resolve_commit"] = timed(
        lambda a: kernels.resolve_commit(a[0], a[1], pf, picks, pairs, False),
        lambda a: plain.resolve_commit(a[0], a[1], pf, picks, pairs, False), reps,
        lambda: (st.clone(), clone_dom(dom0)))
    set_bound(out["resolve_commit"], commit_bytes(schema, picks, c))
    return out


def preempt_eval_bytes(state, vic, pf: dict, possible_mask) -> int:
    """preempt_eval for one representative: each node's state row and its
    victims' priorities read once; the requests, start times and PDB bits
    of the slots below the preemptor's priority; the outputs written."""
    import torch

    n, v = vic.prio.shape
    r, p = vic.req.shape[2], vic.pdb.shape[2]
    i0 = int(torch.argmax(pf["valid"].to(torch.int32)))
    lower = int((vic.prio < pf["priority"][i0]).sum())
    node = n * (1 + 4 + 1 + 4 + 4 + 2 * r * 8) + n * v * 4
    slots = lower * (r * 8 + 2 * 8 + 8 + p)
    out = n * (1 + 5 * 8 + v + 4 + r * 8 + 2 * 8)
    return node + slots + out + vic.allowed.numel() * 8


def check_preempt_kernels(dev, shape: str, reps: int) -> dict:
    """preempt_eval, preempt_pick, preempt_commit, unpack_victims,
    scatter_rows and expand_rows against their plain versions at one
    preemption shape: the chunk-1 dry-run of one preemptor, the rank split
    of the uniform batch (the workloads' mode), a mixed chunk of 64 that
    defers its other-signature mates, and the speculative mode (valid =
    eligible and the main pass's pick < 0)."""
    import math

    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import PreemptSpec, plain

    s, pack, batches = preempt_inputs(shape, dev)
    state = s.builder.state()
    vic = pack["vic"]
    spec = PreemptSpec(check_unsched=True, check_nodename=True, bits_mask=0)
    errs: dict[str, float] = {}
    result = {}
    k = s.batch_size
    tb, _active = batches["uniform"]
    valid = torch.ones(k, dtype=torch.bool, device=dev)
    spec_picks = torch.where(torch.arange(k, device=dev) % 5 == 0, 7, -1).to(torch.int32)
    modes = {
        "chunk1": ({**{key: v[:1] for key, v in tb.items()}, "valid": valid[:1]}, False),
        "rank split": ({**tb, "valid": valid}, True),
        "mixed chunk": ({**{key: v[:64] for key, v in batches["mixed"][0].items()},
                         "valid": valid[:64]}, True),
        "speculative": ({**tb, "elig": valid, "spec_picks": spec_picks}, True),
    }
    timed_in = None
    for label, (pf, chunk_mode) in modes.items():
        ek = kernels.preempt_eval(state, vic, pf, spec)
        ep = plain.preempt_eval(state, vic, pf, spec)
        torch.cuda.synchronize()
        for what, a, b in zip(("possible", "crit", "vic_mask", "n_vic", "rel", "relnz"), ek, ep):
            exact(errs, "preempt_eval", f"[{shape} {label}] {what}", a, b)
        pk = kernels.preempt_pick(ek[0], ek[1], pf, chunk_mode)
        pp = plain.preempt_pick(ep[0], ep[1], pf, chunk_mode)
        torch.cuda.synchronize()
        exact(errs, "preempt_pick", f"[{shape} {label}] picks", pk, pp)
        carry_k = (state.req.clone(), state.nonzero_req.clone(), state.num_pods.clone())
        carry_p = tuple(x.clone() for x in carry_k)
        prio_k, prio_p = vic.prio.clone(), vic.prio.clone()
        mk = kernels.preempt_commit(carry_k, prio_k, ek, pk)
        mp = plain.preempt_commit(carry_p, prio_p, ep, pp)
        torch.cuda.synchronize()
        for what, a, b in (("vic_mask", mk[0], mp[0]), ("n_victims", mk[1], mp[1]), ("req", carry_k[0], carry_p[0]),
                           ("nonzero_req", carry_k[1], carry_p[1]), ("num_pods", carry_k[2], carry_p[2]),
                           ("vic_prio", prio_k, prio_p)):
            exact(errs, "preempt_commit", f"[{shape} {label}] {what}", a, b)
        print(f"preempt [{shape} {label}]: exact; {int(ep[0].sum())} possible nodes, "
              f"{int((pp >= 0).sum())} picks, {int((pp == -2).sum())} deferred, "
              f"{int(mp[1].sum())} victims")
        if label == "rank split":
            timed_in = (pf, ek, ep, pk, pp)
    # The main pass's kernels at the path's own chunk and node count.
    _nodes, _per, _cpu, _mem, _k, _pdbs, chunk = PREEMPT_SHAPES[shape]
    result.update(check_main_at(dev, shape, s.builder, state, batches["mixed"][0], batches["mixed"][1],
                                s.profile, chunk, errs, reps))
    pf, ek, ep, pk, pp = timed_in
    result["preempt_eval"] = timed(lambda _: kernels.preempt_eval(state, vic, pf, spec),
                                   lambda _: plain.preempt_eval(state, vic, pf, spec), reps)
    set_bound(result["preempt_eval"], preempt_eval_bytes(state, vic, pf, ep[0]))
    result["preempt_pick"] = timed(lambda _: kernels.preempt_pick(ek[0], ek[1], pf, True),
                                   lambda _: plain.preempt_pick(ep[0], ep[1], pf, True), reps)
    n = state.valid.shape[0]
    n_pos = int(ep[0].sum())
    # The least work of a rank: one comparison sort of the possible nodes'
    # five keys, n log2 n key comparisons.
    set_bound(result["preempt_pick"], n * (1 + 5 * 8) + k * (1 + 4 + 4),
              5 * n_pos * max(1, math.ceil(math.log2(max(n_pos, 2)))))
    carries = lambda: ((state.req.clone(), state.nonzero_req.clone(), state.num_pods.clone()),  # noqa: E731
                       vic.prio.clone())
    result["preempt_commit"] = timed(lambda a: kernels.preempt_commit(a[0], a[1], ek, pk),
                                     lambda a: plain.preempt_commit(a[0], a[1], ep, pp), reps, carries)
    rows = int((pp >= 0).sum())
    r, v = state.req.shape[1], vic.prio.shape[1]
    set_bound(result["preempt_commit"], k * (4 + v + 4) + rows * (2 * (r + 2) * 8 + r * 8 + 2 * 8 + 4 + 2 * 4 + v * (1 + 4)))
    # unpack_victims on the staged buffer of the pack.
    layout = pack["layout"]
    d_buf = torch.from_numpy(pack["buf"]).to(dev)
    inline = "allowed" not in layout
    args = (layout["r"], layout["n_pdbs"], layout["pdb_words"], layout["v"], inline)
    uk = kernels.unpack_victims(d_buf, *args)
    up = plain.unpack_victims(d_buf, *args)
    torch.cuda.synchronize()
    for what, a, b in zip(("prio", "req", "nonzero", "start", "pdb", "allowed"), uk, up):
        if a is not None:
            exact(errs, "unpack_victims", f"[{shape}] {what}", a, b)
    result["unpack_victims"] = timed(lambda _: kernels.unpack_victims(d_buf, *args),
                                     lambda _: plain.unpack_victims(d_buf, *args), reps)
    set_bound(result["unpack_victims"], nbytes(d_buf) + nbytes(*(x for x in up if x is not None)))
    # scatter_rows: a handful of dirty node rows into state fields of both
    # node axes and into the device victim buffer.
    g = torch.Generator(device="cpu").manual_seed(7)
    idx = torch.randperm(n, generator=g)[:24].to(dev)
    cases = {
        "req": (state.req, 0), "num_pods": (state.num_pods, 0),
        "group_counts": (state.group_counts, 1), "victim buffer": (d_buf, 0),
    }
    for what, (dst, axis) in cases.items():
        src = dst[idx].clone() + 1 if axis == 0 else dst[:, idx].clone() + 1
        a, b = dst.clone(), dst.clone()
        kernels.scatter_rows(a, axis, idx, src)
        plain.scatter_rows(b, axis, idx, src)
        torch.cuda.synchronize()
        exact(errs, "scatter_rows", f"[{shape}] {what}", a, b)
    sub = d_buf[idx].clone()
    result["scatter_rows"] = timed(lambda _: kernels.scatter_rows(d_buf, 0, idx, sub),
                                   lambda _: plain.scatter_rows(d_buf, 0, idx, sub), reps)
    result["scatter_rows"]["library_ms"] = median_ms(lambda _: d_buf.index_copy_(0, idx, sub), reps)[0]
    set_bound(result["scatter_rows"], 2 * nbytes(sub) + nbytes(idx))
    # expand_rows: the uniform batch's feature rows.
    for key, feat in tb.items():
        if key in ("valid", "sig"):
            continue
        row = feat[:1].contiguous()
        exact(errs, "expand_rows", f"[{shape}] {key}", kernels.expand_rows(row, k), plain.expand_rows(row, k))
    row = tb["req"][:1].contiguous()
    result["expand_rows"] = timed(lambda _: kernels.expand_rows(row, k), lambda _: plain.expand_rows(row, k), reps)
    result["expand_rows"]["library_ms"] = median_ms(lambda _: row.repeat(k, 1), reps)[0]
    set_bound(result["expand_rows"], nbytes(row) * (k + 1))
    torch.cuda.synchronize()
    for name in result:
        result[name]["max_abs_err"] = errs[name]
        result[name].setdefault("library_ms", None)
    return result


def pinned_inputs(dev):
    """The daemonset_15kn shapes: 15000 nodes (16384 rows) with the 512
    warm-up daemon pods bound, and a 4096-pod batch pinned by matchFields
    node affinity — mostly one pod per node, every 64th pod asking 9 CPU on
    node-3 (the second and later of them overflow it), every 97th pinned to
    a node that does not exist, every 50th with a preferred zone term —
    with its pins, nominations (every 9th pod nominated to its pin, under
    a nominated-pod overlay on those rows) and features on the card."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    k = w.DAEMONSET_BATCH
    s = TorchScheduler(DEFAULT_PROFILE, batch_size=k, chunk_size=w.DAEMONSET_CHUNK, device=dev)
    for node in w.basic_nodes(w.DAEMONSET_NODES):
        s.add_node(node)
    for i in range(w.DAEMONSET_WARM_PODS):
        s.add_pod(make_pod(f"warm-{i}").req({"cpu": "100m", "memory": "128Mi"}).node(f"node-{i}").obj())
    pods, names = [], []
    for i in range(k):
        node = (i * 7) % w.DAEMONSET_NODES
        if i % 97 == 5:
            node = 10**6
        if i % 64 == 3:
            pod = make_pod(f"heavy-{i}").req({"cpu": "9", "memory": "1Gi"}).node_name_affinity("node-3").obj()
            node = 3
        elif i % 50 == 7:
            pod = (make_pod(f"pref-{i}").req({"cpu": "100m", "memory": "128Mi"}).node_name_affinity(f"node-{node}")
                   .preferred_node_affinity_in(ZONE, ["zone-1"], 40).obj())
        else:
            pod = w.daemon_pod(f"ds-{i}", node)
        pods.append(pod)
        names.append(f"node-{node}")
    batch, _deltas, active = build_pod_batch(pods, s.builder, s.profile, k)
    rows = np.array([s.cache.nodes[nm].row if nm in s.cache.nodes else -1 for nm in names], np.int32)
    nomrow = np.where(np.arange(k) % 9 == 4, rows, -1).astype(np.int32)
    tb = {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for key, v in batch.items()}
    tb["nominated_row"] = torch.from_numpy(np.where(nomrow == rows, np.maximum(rows, 0), -1).astype(np.int32)).to(dev)
    state = s.builder.state()
    schema = s.builder.schema
    nom_req = torch.zeros((schema.N, schema.R), dtype=torch.int64, device=dev)
    nom_cnt = torch.zeros(schema.N, dtype=torch.int32, device=dev)
    nom_prio = torch.full((schema.N,), -(2**31), dtype=torch.int32, device=dev)
    claimed = torch.from_numpy(np.maximum(rows[nomrow >= 0], 0).astype(np.int64)).to(dev)
    nom_req[claimed, 0] = 100
    nom_cnt[claimed] = 1
    nom_prio[claimed] = 0
    pin = torch.from_numpy(np.maximum(rows, 0)).to(dev)
    return s, state, tb, active, (nom_req, nom_cnt, nom_prio), pin, torch.from_numpy(rows).to(dev)


def check_pinned_kernels(dev, reps: int) -> dict:
    """The pinned-batch pass's kernels against their plain versions at the
    daemonset_15kn shapes (K=4096, N=16384): node_filters over the batch,
    eval_chunk and late_scores in pinned mode (also on a feasible set with
    holes), pinned_fit, and the strict resolve_commit of the pinned picks
    over each 1024-lane slice; returns their timings and bounds."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import DomTables, eval_spec, late_spec
    from kubernetes_tpu_torch.kernels import plain

    s, state, tb, active, nom, pin, rows = pinned_inputs(dev)
    schema = s.builder.schema
    spec = eval_spec(s.profile, schema, s.builder.res_col, active)
    late = late_spec(s.profile, schema, s.builder.res_col, active)
    errs: dict[str, float] = {}
    k, n = pin.shape[0], state.valid.shape[0]
    kb = kernels.node_filters(state, tb, spec.ctx)
    pb = plain.node_filters(state, tb, spec.ctx)
    torch.cuda.synchronize()
    exact(errs, "node_filters", "[daemonset]", kb, pb)
    ke = kernels.eval_chunk(state, tb, spec, nom, (pb, None), pin)
    pe = plain.eval_chunk(state, tb, spec, nom, (pb, None), pin)
    torch.cuda.synchronize()
    for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
        exact(errs, "eval_chunk", f"[daemonset pinned] {what}", a, b)
    rng = np.random.default_rng(5)
    holes = pe[0] & torch.from_numpy(rng.random((k, 1)) < 0.7).to(dev)
    for what, feas in (("pinned", pe[0]), ("pinned with holes", holes)):
        base = torch.where(feas, pe[1], 0)
        kt = kernels.late_scores(state, tb, feas, base.clone(), pb, late, pin)
        pt = plain.late_scores(state, tb, feas, base.clone(), pb, late, pin)
        torch.cuda.synchronize()
        exact(errs, "late_scores", f"[daemonset {what}]", kt, pt)
    own = pe[0][:, 0].contiguous()
    kf = kernels.pinned_fit(own, rows, tb["valid"], tb["req"], state)
    pf_ = plain.pinned_fit(own, rows, tb["valid"], tb["req"], state)
    torch.cuda.synchronize()
    for what, a, b in zip(("picks", "feasible"), kf, pf_):
        exact(errs, "pinned_fit", f"[daemonset] {what}", a, b)
    picks = pf_[0]
    tk = state.topo_vals.shape[1]
    dom0 = DomTables(torch.zeros((schema.G, tk, schema.DV), dtype=torch.float32, device=dev),
                     torch.zeros((schema.ET, schema.DV), dtype=torch.float32, device=dev),
                     torch.zeros(schema.ET, dtype=torch.int32, device=dev),
                     torch.zeros(schema.ET, dtype=torch.bool, device=dev))
    c = kernels.MAX_CHUNK
    sk, dk, sp, dp = state.clone(), clone_dom(dom0), state.clone(), clone_dom(dom0)
    for lo in range(0, k, c):
        sub = {key: v[lo:lo + c] for key, v in tb.items()}
        ok_ = kernels.resolve_commit(sk, dk, sub, picks[lo:lo + c], None, True)
        op_ = plain.resolve_commit(sp, dp, sub, picks[lo:lo + c], None, True)
        torch.cuda.synchronize()
        exact(errs, "resolve_commit", f"[daemonset lanes {lo}+] (strict) picks", ok_, op_)
    for f in ("req", "nonzero_req", "num_pods", "group_counts"):
        exact(errs, "resolve_commit", f"[daemonset] (strict) state.{f}", getattr(sk, f), getattr(sp, f))
    print(f"pinned [daemonset K={k} N={n}]: exact; {int(own.sum())} pods feasible on their pins, "
          f"{int((picks >= 0).sum())} placed, {int((picks == -2).sum())} deferred, "
          f"{int((rows < 0).sum())} pinned to no node, fail masks {sorted(set(pe[2].tolist()))}, "
          f"NodeAffinity weight {late.na_weight if late else 0}, taint weight {late.taint_weight if late else 0}")
    sub0 = {key: v[:c] for key, v in tb.items()}
    result = {
        "node_filters": timed(lambda _: kernels.node_filters(state, tb, spec.ctx),
                              lambda _: plain.node_filters(state, tb, spec.ctx), reps),
        "eval_chunk": timed(lambda _: kernels.eval_chunk(state, tb, spec, nom, (pb, None), pin),
                            lambda _: plain.eval_chunk(state, tb, spec, nom, (pb, None), pin), reps),
        "late_scores": timed(lambda a: kernels.late_scores(state, tb, pe[0], a, pb, late, pin),
                             lambda a: plain.late_scores(state, tb, pe[0], a, pb, late, pin), reps,
                             lambda: pe[1].clone()),
        "pinned_fit": timed(lambda _: kernels.pinned_fit(own, rows, tb["valid"], tb["req"], state),
                            lambda _: plain.pinned_fit(own, rows, tb["valid"], tb["req"], state), reps),
        "resolve_commit": timed(lambda a: kernels.resolve_commit(a[0], a[1], sub0, picks[:c], None, True),
                                lambda a: plain.resolve_commit(a[0], a[1], sub0, picks[:c], None, True), reps,
                                lambda: (state.clone(), clone_dom(dom0))),
    }
    # Bounds: each pod's own node row, not the whole node axis.
    r = schema.R
    node_row = 1 + 4 + 1 + 4 + 4 + 3 * r * 8 + 2 * 8 + (r * 8 + 4 + 4) + 1  # state, overlay, bits
    pod_feats = nbytes(*(tb[key] for key in ("nodename_id", "tolerates_unschedulable", "req", "nonzero",
                                             "priority", "nominated_row"))) + k * 4
    set_bound(result["node_filters"], nf_bytes(state, tb, spec.ctx))
    set_bound(result["eval_chunk"], k * node_row + pod_feats + k * (1 + 8 + 4))
    # late_scores: the feasible flag and total of each pod; NodeAffinity's
    # weights, and the label slots of its own node and its program only
    # for a pod with a preferred term of non-zero weight; taint slots of
    # its own node only for a pod with an intolerable PreferNoSchedule taint.
    late_b = k * (1 + 2 * 8)
    if late.na_weight:
        prefd = (tb["na_pref_weight"] != 0).any(dim=1)
        late_b += nbytes(tb["na_pref_weight"]) + int(prefd.sum()) * (state.label_key_ids.shape[1] * 16 + 4)
        if bool(prefd.any()):
            late_b += program_bytes(tb, "na_pref", prefd, ("op", "key", "vals", "int"))
    if late.taint_weight:
        intol = tb["taint_intol_pref"]
        late_b += nbytes(intol) + int(intol.any(dim=1).sum()) * state.taint_ids.shape[1] * 4
    set_bound(result["late_scores"], late_b)
    placed_rows = int(torch.unique(rows[rows >= 0]).numel())
    set_bound(result["pinned_fit"], k * (1 + 4 + 1 + r * 8) + placed_rows * (2 * r * 8 + 2 * 4) + k * 8, k * r)
    set_bound(result["resolve_commit"], commit_bytes(schema, picks[:c], c, pairs=False))
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    return result


PV_ZONE_KEY = "topology.kubernetes.io/zone"


def pv_inputs(dev):
    """The "pv" shape: a 5000-node cluster (8192 rows) in 10 zones and two
    regions whose every third node's CSINode allows 2 attachments of the
    ebs driver and 3 of pd (no limit for nfs); four WaitForFirstConsumer
    classes (static local PVs, some with ORed zone terms and some with no
    affinity; provisioners ebs with allowedTopologies zones 0-4, pd and nfs
    without) and an Immediate one; 3000 bound PVs (zone labels, ``a__b``
    zone sets with a region, ORed node affinity, none, CSI volumes of each
    driver shared across pods) and a ReadWriteOncePod PV; 6000 bound pods
    using device volumes (read-only and read-write), the RWOP claim and CSI
    claims, filling some limited nodes' ebs budget exactly; then a
    4096-pod batch mixing bound, delayed, provisioned, device, RWOP,
    Immediate, lost and missing claims, featurized under the default
    profile (twice: the second pass sees the final vocabularies)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod, make_pv, make_pvc
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    rng = np.random.default_rng(97)
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    cat = builder.volumes
    nodes, zones = 5000, 10

    def zone_terms(*sets):
        return t.NodeSelector(terms=tuple(t.NodeSelectorTerm(match_expressions=(
            t.NodeSelectorRequirement(PV_ZONE_KEY, t.OP_IN, tuple(f"zone-{z}" for z in zs)),)) for zs in sets))

    for i in range(nodes):
        cache.add_node(make_node(f"n{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
                       .zone(f"zone-{i % zones}").region(f"region-{i % 2}").obj())
        if i % 3 == 0:
            builder.set_csinode_limits(i, t.CSINode(f"n{i}", {"ebs": 2, "pd": 3}))
    wffc = t.BINDING_WAIT_FOR_FIRST_CONSUMER
    cat.add_class(t.StorageClass("local", binding_mode=wffc))
    cat.add_class(t.StorageClass("dyn", provisioner="ebs", binding_mode=wffc,
                                 allowed_topologies=zone_terms(range(5))))
    cat.add_class(t.StorageClass("dyn2", provisioner="pd", binding_mode=wffc))
    cat.add_class(t.StorageClass("dyn3", provisioner="nfs", binding_mode=wffc))
    cat.add_class(t.StorageClass("slow"))
    for j in range(8):
        pv = make_pv(f"lpv{j}", storage_class="local", capacity=f"{4 + j}Gi")
        if j % 4:
            pv.node_affinity = zone_terms([j], [j + 1]) if j % 2 else zone_terms([j])
        cat.add_pv(pv)
    drivers = ("ebs", "pd", "nfs")
    for j in range(3000):
        kind = j % 6
        pv = make_pv(f"bpv{j}", access_modes=(t.RWX,))
        if kind == 0:
            pv.labels[PV_ZONE_KEY] = f"zone-{j % zones}"
        elif kind == 1:
            pv.labels[PV_ZONE_KEY] = f"zone-{j % zones}__zone-{(j + 3) % zones}"
            pv.labels["topology.kubernetes.io/region"] = f"region-{j % 2}"
        elif kind == 2:
            pv.node_affinity = zone_terms([j % zones], [(j + 5) % zones])
        elif kind == 4:
            pv.csi_driver = drivers[(j // 6) % 3]
        pv.claim_ref = f"default/b{j}"
        cat.add_pv(pv)
        cat.add_pvc(make_pvc(f"b{j}", volume_name=pv.name, access_modes=(t.RWX,)))
    cat.add_pv(make_pv("rwop", access_modes=(t.RWOP,)))
    cat.add_pvc(make_pvc("rwop", volume_name="rwop", access_modes=(t.RWOP,)))
    for j in range(300):
        for kind in ("local", "dyn", "dyn2", "dyn3"):
            cat.add_pvc(make_pvc(f"{kind}-{j}", storage_class=kind, request="2Gi"))
    cat.add_pvc(make_pvc("imm", storage_class="slow"))
    cat.add_pvc(make_pvc("lost", volume_name="gone"))
    csi_claims = [f"b{j}" for j in range(4, 3000, 6)]  # kind 4: one CSI driver each, by (j // 6) % 3
    ebs_claims = csi_claims[::3]
    # Bound pods.  Limited nodes 0, 3, ..., 897 get exactly 2 distinct ebs
    # volumes (their budget); others carry devices and shared CSI claims.
    for q in range(300):
        w = make_pod(f"full-{q}").req({"cpu": "100m"}).pvc_volume(ebs_claims[(2 * q) % len(ebs_claims)])
        w = w.pvc_volume(ebs_claims[(2 * q + 1) % len(ebs_claims)])
        cache.add_pod(w.node(f"n{3 * q}").obj())
    for q in range(6000):
        w = make_pod(f"bound-{q}").req({"cpu": "100m"})
        if q % 2:
            w = w.device_volume(f"disk-{q % 200}", read_only=bool(q % 3 == 0))
        if q % 5 == 1:
            w = w.pvc_volume(csi_claims[q % len(csi_claims)])
        cache.add_pod(w.node(f"n{int(rng.integers(900, nodes))}").obj())
    cache.add_pod(make_pod("rwop-holder").req({"cpu": "100m"}).pvc_volume("rwop").node("n1").obj())
    other = ["imm", "lost", "missing", "rwop"]
    pods = []
    for k in range(4096):
        w = make_pod(f"p{k}").req({"cpu": "100m", "memory": "256Mi"})
        r = k % 16
        if r < 5:
            w = w.pvc_volume(f"b{int(rng.integers(3000))}")
        elif r < 9:
            w = w.pvc_volume(f"{('local', 'dyn', 'dyn2', 'dyn3')[r - 5]}-{int(rng.integers(300))}")
        elif r < 11:
            w = w.pvc_volume(csi_claims[int(rng.integers(len(csi_claims)))])
        elif r < 13:
            w = w.device_volume(f"disk-{int(rng.integers(220))}", read_only=bool(rng.integers(2)))
        elif r == 13:
            w = w.pvc_volume(f"b{int(rng.integers(3000))}").pvc_volume(f"dyn-{int(rng.integers(300))}")
        elif r == 14:
            w = w.pvc_volume(other[k % 4])
        else:
            w = w.pvc_volume(f"local-{k % 300}").device_volume(f"disk-{k % 7}")
        pods.append(w.obj())
    for _ in range(2):
        batch, _, active = build_pod_batch(pods, builder, DEFAULT_PROFILE, 4096)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {key: to(v) for key, v in batch.items()}
    pf["nominated_row"] = to(np.full(4096, -1, np.int32))
    return builder, builder.state(), pf, active, rng


def vol_filter_bytes(state, pf: dict, do_vr: bool, do_nvl: bool) -> int:
    """vol_filter for this chunk's data: the flags and ids read; one node
    row of counts per distinct device use (dev_counts for a writer,
    dev_rw_counts for a read-only use) and per distinct CSI volume
    (csivol_counts); the csi_used and csi_limit cells of each (driver, node)
    where some pod of the chunk attaches a new volume of that driver; the
    bits written."""
    import torch

    c, n = pf["valid"].shape[0], state.valid.shape[0]
    b = c * n
    if do_vr:
        b += nbytes(pf["vr_rwop_ok"])
        if "vol_dev_ids" in pf:
            ids, rw = pf["vol_dev_ids"], pf["vol_dev_rw"]
            use = ids >= 0
            rows = int(torch.unique(ids[use].long() * 2 + rw[use].long()).numel())
            b += nbytes(ids, rw) + rows * n * 4
    if do_nvl and "vol_csi_ids" in pf:
        ids, drv = pf["vol_csi_ids"], pf["vol_csi_drv"]
        use = ids >= 0
        b += nbytes(ids, drv) + int(torch.unique(ids[use]).numel()) * n * 4
        fresh = (state.csivol_counts[ids.clamp(min=0).long()] == 0) & use[..., None]  # (C, S, N)
        for d in torch.unique(drv[use]).tolist():
            b += int((fresh & (drv == d)[..., None]).any(dim=1).any(dim=0).sum()) * 4 * 2
    return b


def vol_commit_bytes(state, pf: dict, placed) -> int:
    """The volume part of resolve_commit for this chunk: the ids and flags
    read, and for each distinct cell that a placed pod (``placed``, the
    commit's output picks) touches, one read and one write: dev_counts per
    device use, dev_rw_counts per writer, csivol_counts per CSI volume, and
    csi_used per (driver, node) that a volume absent there before the chunk
    newly attaches to."""
    import torch

    n = state.valid.shape[0]
    att = (placed >= 0)[:, None]
    rows = placed.clamp(min=0).long()[:, None]
    b = 0
    if "vol_dev_ids" in pf:
        ids, rw = pf["vol_dev_ids"], pf["vol_dev_rw"]
        use = (ids >= 0) & att
        cell = ids.long() * n + rows
        b += nbytes(ids, rw) + int(torch.unique(cell[use]).numel()) * 8
        b += int(torch.unique(cell[use & rw]).numel()) * 8
    if "vol_csi_ids" in pf:
        ids, drv = pf["vol_csi_ids"], pf["vol_csi_drv"]
        use = (ids >= 0) & att
        cell = ids.clamp(min=0).long() * n + rows
        fresh = use & (state.csivol_counts.view(-1)[cell] == 0)
        b += nbytes(ids, drv) + int(torch.unique(cell[use]).numel()) * 8
        b += int(torch.unique((drv.long() * n + rows)[fresh]).numel()) * 8
    if "vol_csi_lim" in pf:
        b += nbytes(pf["vol_csi_lim"])
    return b


def vol_pair_bytes(pf: dict, c: int) -> int:
    """conflict_pairs on a volume batch: the device and CSI ids and the
    PreBind-race flags read once, the table written once."""
    k = pf["valid"].shape[0]
    keys = [key for key in ("vol_dev_ids", "vol_csi_ids", "vol_unbound") if key in pf]
    return nbytes(*(pf[key] for key in keys)) + k * c


def check_pv_kernels(dev, reps: int) -> dict:
    """Phase 3, the "pv" shape (C=64, N=8192, a 4096-pod batch; pv_inputs):
    node_filters with VolumeBinding's and VolumeZone's bits over the batch,
    conflict_pairs over its 64 chunks, and per chunk (every eighth) vol_filter,
    eval_chunk reading the node_filters and vol_filter planes, and
    select_host; resolve_commit strict and not on chunks whose picks put
    limited pods, unlimited pods with distinct volumes of one driver, device
    users and chunk-mates sharing a volume on a few rows (one at its ebs
    budget, one with the volume attached); all against their plain versions,
    exactly.  Returns the timings (the batch kernels on the batch, the rest
    on chunk 0) with their bounds."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    builder, state, big, active, rng = pv_inputs(dev)
    schema = builder.schema
    errs: dict[str, float] = {}
    c, n, k = 64, state.valid.shape[0], big["valid"].shape[0]
    spec = eval_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    ctx = spec.ctx
    need = {"VolumeBinding", "VolumeZone", "VolumeRestrictions", "NodeVolumeLimits"}
    if not need <= set(spec.filters):
        raise AssertionError(f"pv shape: active filters {spec.filters} lack {need - set(spec.filters)}")
    kb = kernels.node_filters(state, big, ctx)
    pb = plain.node_filters(state, big, ctx)
    kp = kernels.conflict_pairs(big, k // c, c)
    pp = plain.conflict_pairs(big, k // c, c)
    torch.cuda.synchronize()
    exact(errs, "node_filters", "[pv batch]", kb, pb)
    exact(errs, "conflict_pairs", "[pv batch]", kp, pp)
    valid = state.valid[None, :]
    stats = {"vb_rejects": int((valid & ((pb & 4) == 0)).sum()), "vz_rejects": int((valid & ((pb & 8) == 0)).sum()),
             "pairs": int(pp.sum()), "vr_rejects": 0, "nvl_rejects": 0, "deferred": 0, "committed": 0}
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    first = None
    for i in range(0, k // c, 8):
        pf = _chunk(big, i, c)
        bits = pb[i * c:(i + 1) * c].contiguous()
        kv = kernels.vol_filter(state, pf, ctx, True, True)
        pv = plain.vol_filter(state, pf, ctx, True, True)
        torch.cuda.synchronize()
        exact(errs, "vol_filter", f"[pv chunk {i}]", kv, pv)
        stats["vr_rejects"] += int((valid & ((pv & 1) == 0)).sum())
        stats["nvl_rejects"] += int((valid & ((pv & 2) == 0)).sum())
        ke = kernels.eval_chunk(state, pf, spec, None, (bits, None, pv))
        pe = plain.eval_chunk(state, pf, spec, None, (bits, None, pv))
        torch.cuda.synchronize()
        for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
            exact(errs, "eval_chunk", f"[pv chunk {i}] {what}", a, b)
        steps = torch.from_numpy(rng.integers(0, 2**32, size=c, dtype=np.int64)).to(dev)
        ks = kernels.select_host(pe[0], pe[1], steps, seed_mul, pf["nominated_row"])
        ps = plain.select_host(pe[0], pe[1], steps, seed_mul, pf["nominated_row"])
        torch.cuda.synchronize()
        for what, a, b in zip(("pick", "best", "feasible_count"), ks, ps):
            exact(errs, "select_host", f"[pv chunk {i}] {what}", a, b)
        if first is None:
            first = (pf, bits, pv, ps[0])
    # resolve_commit: the chunk's picks, then a few rows for everyone.
    et_slot = torch.zeros(schema.ET, dtype=torch.int32, device=dev)
    dom = build_dom(state, et_slot, torch.zeros(schema.ET, dtype=torch.bool, device=dev), schema.DV)
    fields = ("req", "nonzero_req", "num_pods", "group_counts", "dev_counts", "dev_rw_counts",
              "csivol_counts", "csi_used")
    at_budget = 0  # node n0 carries exactly its two ebs volumes
    # A node past the limited ones that already carries a CSI volume.
    attached = 900 + int(torch.nonzero(state.csivol_counts[:, 900:].sum(dim=0) > 0)[0, 0])
    crowd = torch.tensor([at_budget, attached, 7, 11], dtype=torch.int32, device=dev)
    commit_cases = []
    for i in range(0, k // c, 8):
        pf = _chunk(big, i, c)
        crowded = crowd[torch.from_numpy(rng.integers(0, 4, size=c)).to(dev)]
        picks = crowded.clone()
        picks[::13] = -1
        commit_cases.append((f"chunk {i}", pf, picks, kp[i]))
    pf0, _bits0, pv0, picks0 = first
    commit_cases.append(("chunk 0 picks", pf0, picks0, kp[0]))
    placed = None  # the first case's committed picks (not strict): its bound reads them
    for label, pf, picks, pairs in commit_cases:
        for strict in (False, True):
            sk, dk = state.clone(), clone_dom(dom)
            sp, dp = state.clone(), clone_dom(dom)
            ok_ = kernels.resolve_commit(sk, dk, pf, picks, pairs, strict)
            op_ = plain.resolve_commit(sp, dp, pf, picks, pairs, strict)
            torch.cuda.synchronize()
            exact(errs, "resolve_commit", f"[pv {label}] (strict={strict}) picks", ok_, op_)
            for f in fields:
                exact(errs, "resolve_commit", f"[pv {label}] (strict={strict}) state.{f}",
                      getattr(sk, f), getattr(sp, f))
            if not strict:
                stats["deferred"] += int((op_ == -2).sum())
                if placed is None:
                    placed = op_
            stats["committed"] += int((op_ >= 0).sum())
    _l, pfc, pickc, pairc = commit_cases[0]
    result = {
        # The plain version takes about a second a call here: 5 calls.
        "node_filters": timed(lambda _: kernels.node_filters(state, big, ctx),
                              lambda _: plain.node_filters(state, big, ctx), reps, plain_reps=5),
        "conflict_pairs": timed(lambda _: kernels.conflict_pairs(big, k // c, c),
                                lambda _: plain.conflict_pairs(big, k // c, c), reps),
        "vol_filter": timed(lambda _: kernels.vol_filter(state, pf0, ctx, True, True),
                            lambda _: plain.vol_filter(state, pf0, ctx, True, True), reps),
        "eval_chunk": timed(lambda _: kernels.eval_chunk(state, pf0, spec, None, (_bits0, None, pv0)),
                            lambda _: plain.eval_chunk(state, pf0, spec, None, (_bits0, None, pv0)), reps),
        "resolve_commit": timed(
            lambda a: kernels.resolve_commit(a[0], a[1], pfc, pickc, pairc, False),
            lambda a: plain.resolve_commit(a[0], a[1], pfc, pickc, pairc, False), reps,
            lambda: (state.clone(), clone_dom(dom))),
    }
    set_bound(result["node_filters"], nf_bytes(state, big, ctx))
    set_bound(result["conflict_pairs"], vol_pair_bytes(big, c))
    set_bound(result["vol_filter"], vol_filter_bytes(state, pf0, True, True))
    set_bound(result["eval_chunk"], eval_bytes(state, pf0, None) + 2 * c * n)
    set_bound(result["resolve_commit"], commit_bytes(schema, pickc, c) + vol_commit_bytes(state, pfc, placed))
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    keys = {key: tuple(big[key].shape) for key in big if key.startswith(("vb_", "vz_", "vol_"))}
    print(f"pv shapes: C={c}, N={n}, K={k}, CV={schema.CV}, DR={schema.DR}, VD={schema.VD}; features {keys}; "
          f"{stats}")
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
    labels = False
    for prefix in ("vb", "vz"):
        if f"{prefix}_op" in pf:
            # The flags and group counts of every pod; the programs (and so
            # the label slots) only of feasible pods with a group.
            feas, ngroups = pf[f"{prefix}_feasible"], pf[f"{prefix}_ngroups"]
            b += nbytes(feas, ngroups)
            rows = feas & (ngroups > 0)
            if bool(rows.any()):
                b += program_bytes(pf, prefix, rows, ("op", "key", "vals", "int", "term_valid", "group"))
                labels = True
    if labels and not ("na_sel_pairs" in pf and bool(pf["na_has_required"].any())):
        b += label_bytes(state)
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


def run_workload(impl: str, nodes, warm, measured, batch: int, chunk: int, trace: bool = False,
                 profile=None, stages=(), preempt: bool = False, setup=None, feed=None):
    """One burst through TorchScheduler: the nodes, ``setup(s)`` (objects
    and pods of a warm-up that needs more than pods), the warm-up pods
    (scheduled first, then each of ``stages`` in turn), then the measured
    pods (or what ``feed(s)`` adds), timed.  ``preempt`` runs the fit-only profile with the
    reference's 1 s doubling backoff on the wall clock and waits through
    it (``wait_backoff``).  With ``trace``, the measured window also
    records host spans (featurize, the host-to-device copies of the batch
    features, the result fetch that waits for the device, and the rest of
    each schedule_batch call) and a torch.profiler trace of the card's
    kernels.  Data moves are counted over the whole run: torch's
    index_copy_ and expand calls (there should be none) beside the
    scatter_rows and expand_rows launches that replace them; whole-state
    uploads are counted inside the measured window."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import scheduler as sched_mod
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE, fit_only_profile
    from kubernetes_tpu_torch.queue import SchedulingQueue

    kw = {}
    if preempt:
        profile = fit_only_profile()
        kw["queue"] = SchedulingQueue(backoff=True)
    s = sched_mod.TorchScheduler(profile or DEFAULT_PROFILE, batch_size=batch, chunk_size=chunk,
                                 _impl=impl, **kw)
    moves = {"index_copy_": 0, "expand": 0}
    orig_ic, orig_ex = torch.Tensor.index_copy_, torch.Tensor.expand

    def index_copy_(self, *a, **k):
        moves["index_copy_"] += 1
        return orig_ic(self, *a, **k)

    def expand(self, *a, **k):
        moves["expand"] += 1
        return orig_ex(self, *a, **k)

    launches0 = kernels.launch_counts()
    torch.Tensor.index_copy_, torch.Tensor.expand = index_copy_, expand
    try:
        for node in nodes:
            s.add_node(node)
        if setup is not None:
            setup(s)
        for pod in warm:
            s.add_pod(pod)
        out = s.schedule_all_pending(wait_backoff=preempt)
        for stage in stages:
            for pod in stage:
                s.add_pod(pod)
            out += s.schedule_all_pending(wait_backoff=preempt)
        torch.cuda.synchronize()
        if feed is not None:
            feed(s)
        for pod in measured:
            s.add_pod(pod)
        spans = {"featurize": 0.0, "h2d": 0.0, "batch": 0.0, "fetch": 0.0}
        h2d_bytes = [0]
        # The window's wall-clock waits: backoff slept through, pods sent
        # to the backoff queue, and the garbage collector's pauses.
        window = {"backoff_s": 0.0, "sleeps": 0, "to_backoff": 0, "gc_s": 0.0, "gc_runs": 0, "gc_full": 0,
                  "gc_before_s": 0.0}
        orig_sleep, orig_add_backoff = s.queue.sleep_until_backoff, s.queue.add_backoff

        def sleep_until_backoff():
            t = time.perf_counter()
            try:
                slept = orig_sleep()
                window["sleeps"] += int(slept)
                return slept
            finally:
                window["backoff_s"] += time.perf_counter() - t

        def add_backoff(qp):
            window["to_backoff"] += 1
            return orig_add_backoff(qp)

        gc_t0 = [0.0]

        def gc_pause(phase, info):
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            else:
                window["gc_s"] += time.perf_counter() - gc_t0[0]
                window["gc_runs"] += 1
                window["gc_full"] += int(info["generation"] == 2)

        s.queue.sleep_until_backoff = sleep_until_backoff
        s.queue.add_backoff = add_backoff
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
            s.schedule_batch = span("batch", s.schedule_batch)
            s._fetch = span("fetch", s._fetch)
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        # A full collection now, timed: what one inside the window would cost.
        t_gc = time.perf_counter()
        gc.collect()
        window["gc_before_s"] = time.perf_counter() - t_gc
        gc.callbacks.append(gc_pause)
        uploads0 = s.builder.full_uploads
        t0 = time.perf_counter()
        measured_out = s.schedule_all_pending(wait_backoff=preempt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        window["full_uploads"] = s.builder.full_uploads - uploads0
    finally:
        if gc_pause in gc.callbacks:
            gc.callbacks.remove(gc_pause)
        torch.Tensor.index_copy_, torch.Tensor.expand = orig_ic, orig_ex
    launches1 = kernels.launch_counts()
    for name in ("scatter_rows", "expand_rows"):
        moves[name] = launches1[name] - launches0[name]
    s.data_moves = moves
    s.window = window
    if trace:
        prof.__exit__(None, None, None)
        sched_mod.build_pod_batch = orig_featurize
        device = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                device[ev.key] = getattr(ev, "device_time_total", 0.0) / 1e3
        # Featurization (of the batch, its prefetched successor and the
        # host tail), the copies and the fetch (the wait for the device's
        # results) all run inside schedule_batch.
        other = spans["batch"] - spans["featurize"] - spans["h2d"] - spans["fetch"]
        spans = {"featurize_s": spans["featurize"], "h2d_s": spans["h2d"],
                 "h2d_bytes": h2d_bytes[0], "fetch_wait_s": spans["fetch"],
                 "other_host_s": other, "backoff_s": window["backoff_s"], "device_ms_by_kernel": device}
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


def run_preemption(impl: str, trace: bool = False):
    """preemption_500n (harness.py:578-618): the background fill drained,
    the warm-up preemptor, then 500 preemptors of two victims each."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.preemption_nodes(w.PREEMPT_NODES),
                        w.preemption_background(w.PREEMPT_BG_PODS),
                        [w.preemptor(f"vip-{i}") for i in range(w.PREEMPT_MEASURED_PODS)],
                        w.PREEMPT_BATCH, w.PREEMPT_CHUNK, trace,
                        stages=([w.preemptor("warm-vip")],), preempt=True)


def run_preempt_async(impl: str, trace: bool = False):
    """preemption_async_5kn (harness.py:942-977): 5000 saturated nodes,
    15000 background pods left unschedulable, then 1000 preemptors."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.preemption_nodes(w.ASYNC_NODES),
                        w.preemption_background(w.ASYNC_BG_PODS, cpu="3900m", mem="15Gi"),
                        [w.preemptor(f"vip-{i}") for i in range(w.ASYNC_MEASURED_PODS)],
                        w.ASYNC_BATCH, w.ASYNC_CHUNK, trace,
                        stages=([w.preemptor("warm-vip")],), preempt=True)


def run_daemonset(impl: str, trace: bool = False):
    """daemonset_15kn (harness.py:816-850): 15000 nodes, 512 warm-up and
    15000 measured daemon pods, each pinned to one node."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.basic_nodes(w.DAEMONSET_NODES),
                        [w.daemon_pod(f"warm-{i}", i) for i in range(w.DAEMONSET_WARM_PODS)],
                        [w.daemon_pod(f"ds-{i}", i) for i in range(w.DAEMONSET_NODES)],
                        w.DAEMONSET_BATCH, w.DAEMONSET_CHUNK, trace)


def _pv_run(impl: str, trace: bool, setup, feed):
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.basic_nodes(w.PV_NODES, zones=w.PV_ZONES), [], [], w.PV_BATCH, w.PV_CHUNK,
                        trace, setup=setup, feed=feed)


def run_intree(impl: str, trace: bool = False):
    """intree_pvs_5kn_2kpods (harness.py:664-716): 5000 nodes in 10 zones,
    512 warm-up and 2000 measured pods, each claim pre-bound to its own
    zonal PV."""
    from kubernetes_tpu_torch import workloads as w

    return _pv_run(impl, trace, lambda s: w.pv_warm(s, w.INTREE_MEASURED_PODS),
                   lambda s: w.pv_measured(s, w.INTREE_MEASURED_PODS))


def run_migrated(impl: str, trace: bool = False):
    """migrated_intree_pvs_5kn_5kpods (harness.py:718-737): the same with
    CSI-fronted PVs and 39 attachments per node; 5000 measured pods."""
    from kubernetes_tpu_torch import workloads as w

    def setup(s):
        for cs in w.migrated_csinodes():
            s.add_csinode(cs)
        w.pv_warm(s, w.MIGRATED_MEASURED_PODS, driver=w.MIGRATED_DRIVER)

    return _pv_run(impl, trace, setup,
                   lambda s: w.pv_measured(s, w.MIGRATED_MEASURED_PODS, driver=w.MIGRATED_DRIVER))


def run_csi(impl: str, trace: bool = False):
    """csi_pvs_5kn_5kpods (harness.py:740-792): WaitForFirstConsumer claims
    provisioned at PreBind; 512 warm-up and 5000 measured pods."""
    from kubernetes_tpu_torch import workloads as w

    return _pv_run(impl, trace, w.csi_warm, lambda s: w.csi_measured(s, w.CSI_MEASURED_PODS))


def check_pv(s, outcomes, expected: int, label: str) -> dict:
    """The PV paths' gates on top of check_density's: each pod with a
    zonal PV sits in its PV's zone; csi_used equals the distinct CSI
    volumes per (driver, node) of the host mirror's pods and stays within
    csi_limit; every CSI claim is bound to a provisioned PV that names it;
    no whole-state upload inside the measured window."""
    import numpy as np

    bind = check_density(s, outcomes, expected, label)
    cat = s.builder.volumes
    used: dict = {}
    zonal = provisioned = 0
    for pr in s.cache.pods.values():
        node = s.cache.nodes[pr.node_name].node
        for pvc in cat.pod_pvcs(pr.pod):
            pv = cat.pvs.get(pvc.volume_name) if pvc is not None else None
            if pv is None:
                raise AssertionError(f"{label}: pod {pr.pod.name} has an unbound or lost claim")
            zone = pv.labels.get(PV_ZONE_KEY)
            if zone is not None:
                zonal += 1
                if node.metadata.labels.get(PV_ZONE_KEY) not in zone.split("__"):
                    raise AssertionError(f"{label}: pod {pr.pod.name} outside its PV's zone {zone}")
            driver = cat.pvc_driver(pvc)
            if driver:
                used.setdefault((driver, pr.node_name), set()).add(pvc.uid)
    for pvc in cat.pvcs.values():
        if pvc.storage_class:
            pv = cat.pvs.get(pvc.volume_name)
            if pv is None or pv.claim_ref != pvc.uid or not pv.name.startswith("provisioned-"):
                raise AssertionError(f"{label}: claim {pvc.uid} is not bound to a provisioned PV naming it")
            provisioned += 1
    h = s.builder.host
    want = np.zeros_like(h["csi_used"])
    for (driver, node), claims in used.items():
        want[s.interns.drivers.id(driver), s.cache.row_of(node)] = len(claims)
    if not np.array_equal(h["csi_used"], want) or (h["csi_used"] > h["csi_limit"]).any():
        raise AssertionError(f"{label}: csi_used differs from the distinct attached volumes or exceeds csi_limit")
    if s.window["full_uploads"]:
        raise AssertionError(f"{label}: {s.window['full_uploads']} whole-state uploads in the measured window")
    print(f"{label}: {zonal} zonal claims in their zones, {provisioned} claims provisioned and bound, "
          f"{int(h['csi_used'].sum())} CSI attachments (max {int(h['csi_used'].max(initial=0))} per driver "
          f"and node), {s.reserve_failures} lost reservations, CV={s.builder.schema.CV}")
    return bind


def daemon_gate(outcomes) -> None:
    """Every daemon pod on the node its name pins (warm-i and ds-i on
    node-i)."""
    off = [o.pod.name for o in outcomes if o.node_name != f"node-{o.pod.name.split('-')[1]}"]
    if off:
        raise AssertionError(f"daemonset: {len(off)} pods off their pinned node, e.g. {off[:5]}")


def check_preemption(s, outcomes, expected: int, label: str) -> dict:
    """The preemption paths' gates: every preemptor binds, every victim is
    a priority-1 background pod, no node exceeds its allocatable, the host
    mirror equals the device state.  Returns the bindings (the last
    outcome of each pod) with the victim set of every preemption."""
    bind = {}
    for o in outcomes:
        bind[o.pod.name] = (o.node_name, tuple(sorted(o.victim_uids)))
    vips = [k for k in bind if k.startswith("vip-") or k == "warm-vip"]
    unbound = [k for k in vips if bind[k][0] is None]
    if len(vips) != expected or unbound:
        raise AssertionError(f"{label}: {len(vips)} preemptors, {len(unbound)} unbound, want {expected} bound")
    bad = [v for v, _p, _n in s.preempted if not v.startswith("default/bg-")]
    if bad or len(s.preempted) == 0:
        raise AssertionError(f"{label}: victims {bad[:5]} are not priority-1 background pods "
                             f"({len(s.preempted)} victims)")
    if not s.builder.host_mirror_equal():
        raise AssertionError(f"{label}: host mirror differs from the device state")
    h = s.builder.host
    v = h["valid"]
    if (h["req"][v] > h["alloc"][v]).any() or (h["num_pods"][v] > h["allowed_pods"][v]).any():
        raise AssertionError(f"{label}: a node exceeds its allocatable")
    return bind


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


# The main paths: (runner, pods bound, kernels that must launch, gate,
# check, runs through the kernels).  The preemption paths' windows are a
# few tens of milliseconds, so they run three times through the kernels.
def _paths():
    from kubernetes_tpu_torch import workloads as w

    base = ("build_dom", "eval_chunk", "select_host", "resolve_commit")
    spread = base + ("conflict_pairs", "node_filters", "spread_filter", "late_scores")
    preempt = base + ("preempt_eval", "preempt_pick", "preempt_commit", "unpack_victims",
                      "scatter_rows", "expand_rows")
    pinned = ("node_filters", "eval_chunk", "late_scores", "pinned_fit", "resolve_commit")
    # intree: no device, CSI or racing ids, so no conflict table.
    pv = base + ("node_filters", "vol_filter")
    return {
        "density": (run_density, w.DENSITY_WARM_PODS + w.DENSITY_MEASURED_PODS, base, None,
                    check_density, 1),
        "ipa": (run_ipa, w.IPA_WARM_PODS + w.IPA_MEASURED_PODS, base + ("ipa_eval", "conflict_pairs"),
                ipa_anti_ok, check_density, 1),
        "spread_na": (run_spread_na, w.SPREAD_WARM_PODS + w.SPREAD_MEASURED_PODS, spread,
                      lambda out: spread_gates(out, w.SPREAD_NODES, w.SPREAD_ZONES, w.SPREAD_MAX_SKEW,
                                               lambda i: False), check_density, 1),
        "inclusion": (run_inclusion, w.INCLUSION_WARM_PODS + w.INCLUSION_MEASURED_PODS, spread,
                      lambda out: spread_gates(out, w.INCLUSION_NODES, w.INCLUSION_ZONES,
                                               w.INCLUSION_MAX_SKEW, lambda i: i % 2 == 1), check_density, 1),
        "preemption_500n": (run_preemption, w.PREEMPT_MEASURED_PODS + 1, preempt, None, check_preemption, 3),
        "preemption_async_5kn": (run_preempt_async, w.ASYNC_MEASURED_PODS + 1, preempt, None,
                                 check_preemption, 3),
        "daemonset_15kn": (run_daemonset, w.DAEMONSET_WARM_PODS + w.DAEMONSET_NODES, pinned, daemon_gate,
                           check_density, 1),
        "intree_pvs_5kn_2kpods": (run_intree, w.PV_WARM_PODS + w.INTREE_MEASURED_PODS, pv, None, check_pv, 1),
        "migrated_intree_pvs_5kn_5kpods": (run_migrated, w.PV_WARM_PODS + w.MIGRATED_MEASURED_PODS,
                                           pv + ("conflict_pairs",), None, check_pv, 1),
        "csi_pvs_5kn_5kpods": (run_csi, w.PV_WARM_PODS + w.CSI_MEASURED_PODS, pv + ("conflict_pairs",), None,
                               check_pv, 1),
    }


def window_line(s, measured: int, dt: float) -> str:
    """The measured window: pods/s and what the wall clock waited on."""
    win = s.window
    return (f"measured {measured} pods in {dt:.4f}s = {measured / dt:.1f} pods/s; backoff waited "
            f"{win['backoff_s']:.4f}s over {win['sleeps']} sleeps, {win['to_backoff']} pods sent to backoff, "
            f"garbage collector {win['gc_s']:.4f}s over {win['gc_runs']} runs ({win['gc_full']} full; a full "
            f"collection just before the window took {win['gc_before_s']:.4f}s), {win['full_uploads']} "
            f"whole-state uploads")


def drive(path: str, card: str) -> tuple[dict, dict]:
    """Phase 4: one main path through the kernels (launch counts set to 0
    just before and read just after), again through the kernels where the
    path asks for more runs, traced, and through the plain versions;
    gates, launch counts, and identical bindings (and victims), outcome
    counts and backoff requeues in every run required.  Returns (launch
    counts, data moves)."""
    from kubernetes_tpu_torch import kernels

    runner, expected, must, gate, check, runs = _paths()[path]
    kernels.reset_launches()
    s, out, measured, dt, _ = runner("kernel")
    launches = kernels.launch_counts()
    bind_k = check(s, out, expected, f"{path} kernel path")
    if gate is not None:
        gate(out)
    history = (len(out), s.window["to_backoff"])
    print(f"{path} (kernels): {len(out)} outcomes; {window_line(s, measured, dt)}; deferred {s.deferred}; "
          f"packed batches {s.packed_batches}, planned collisions {s.pack_collisions}, last pack width "
          f"{s.pack_width}; domain tables rebuilt {s.dom_carry_rebuilds}, carried {s.dom_carry_hits}; "
          f"preemptions {s.preemptions} ({len(s.preempted)} victims, {s.speculative_batches} speculative "
          f"dry-runs), {s.pinned_batches} pinned batches; schema N={s.builder.schema.N} G={s.builder.schema.G} "
          f"ET={s.builder.schema.ET} DV={s.builder.schema.DV}; launches {launches}; data moves "
          f"{s.data_moves}  [{card}]")
    for name, count in launches.items():
        if (count == 0) == (name in must):
            raise AssertionError(f"{path} path: {name} launched {count} times")
    if s.data_moves["index_copy_"] or s.data_moves["expand"]:
        raise AssertionError(f"{path} path: data moved outside the hand kernels: {s.data_moves}")

    def same(label, s_, out_):
        compare_bindings(bind_k, check(s_, out_, expected, f"{path} {label}"))
        if (len(out_), s_.window["to_backoff"]) != history:
            raise AssertionError(f"{path} {label}: {len(out_)} outcomes and {s_.window['to_backoff']} "
                                 f"backoff requeues, the first kernel run {history}")

    for rep in range(2, runs + 1):
        s4, out4, m4, dt4, _ = runner("kernel")
        same(f"kernel run {rep}", s4, out4)
        print(f"{path} (kernels, run {rep}): {window_line(s4, m4, dt4)}  [{card}]")
    s3, out3, m3, dt3, spans = runner("kernel", trace=True)
    same("traced kernel run", s3, out3)
    print_trace(path, dt3, spans, card)
    print(f"{path} traced run: {window_line(s3, m3, dt3)}  [{card}]")
    s2, out2, measured2, dt2, _ = runner("plain")
    same("plain run", s2, out2)
    print(f"{path} (plain versions on the card): identical bindings, victims and requeues; "
          f"{window_line(s2, measured2, dt2)}  [{card}]")
    return launches, s.data_moves


# One window of a path in the tree given as argv[1] (its own chip_smoke.py
# and package): untraced, then traced for the featurize span.
_COMPARE_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
from kubernetes_tpu_torch.kernels import build
build.build()
runner = c._paths()[sys.argv[2]][0]
_s, _o, n, dt, _ = runner("kernel")
_s, _o, n2, dt2, spans = runner("kernel", trace=True)
print(json.dumps({"pods_s": n / dt, "traced_pods_s": n2 / dt2, "featurize_s": spans["featurize_s"]}))
"""


def compare(other: str, paths: list[str], card: str) -> None:
    """Each path's measured window through the kernels, in ``other`` and
    in this tree, each run a fresh process, three times in the order
    other, this, this, other; pods/s untraced and traced, and the traced
    featurize span."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"other": os.path.abspath(other), "this": here}
    for tree in trees.values():  # build each tree's kernels before any window
        subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                        "from kubernetes_tpu_torch.kernels import build; build.build()", tree],
                       cwd=tree, check=True)
    for path in paths:
        for which in ("other", "this", "this", "other") * 3:
            res = subprocess.run([sys.executable, "-c", _COMPARE_CHILD, trees[which], path], cwd=trees[which],
                                 capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"compare {path} in {trees[which]}: exit {res.returncode}\n{res.stderr[-4000:]}")
            print(f"compare {path} [{which}: {trees[which]}]: {res.stdout.strip().splitlines()[-1]}  [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true", help="stop after the kernel checks")
    ap.add_argument("--compare", metavar="DIR", help="only compare --paths with the port's tree in DIR")
    ap.add_argument("--paths", default="density,daemonset_15kn", help="the paths --compare runs")
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
    if args.compare:
        compare(args.compare, args.paths.split(","), card)
        return 0

    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    shapes = {"density": check_kernels(dev, REPS), "ipa": check_ipa_kernels(dev, REPS),
              "spread_na": check_spread_kernels(dev, "spread_na", REPS),
              "inclusion": check_spread_kernels(dev, "inclusion", REPS),
              **{shape: check_preempt_kernels(dev, shape, REPS) for shape in PREEMPT_SHAPES},
              "daemonset": check_pinned_kernels(dev, REPS), "pv": check_pv_kernels(dev, REPS)}
    for shape, table in shapes.items():
        for name, tm in table.items():
            lib = "" if tm.get("library_ms") is None else f", library {tm['library_ms']:.4f}"
            print(f"{name} [{shape} shapes]: device ms: kernel {tm['ms']:.4f}, plain {tm['plain_ms']:.4f}{lib}, "
                  f"bound {tm['bound_ms']:.5f} ({tm['bound_by']}: {tm['bytes']} bytes, {tm['ops']} "
                  f"operations); call ms with the host's launch overhead: kernel {tm['call_ms']:.4f}, "
                  f"plain {tm['plain_call_ms']:.4f}  [{card}]")

    print(f"kernel phase done at {time.perf_counter() - t0:.1f}s")
    by_path: dict[str, dict] = {}  # empty: the main paths did not run
    moves: dict[str, dict] = {}
    if not args.kernels_only:
        for path in _paths():
            by_path[path], moves[path] = drive(path, card)
            print(f"{path} done at {time.perf_counter() - t0:.1f}s")
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
        "preempt_eval": "kubernetes_tpu/preemption.py:257",
        "preempt_pick": "kubernetes_tpu/preemption.py:538",
        "preempt_commit": "kubernetes_tpu/preemption.py:601",
        "unpack_victims": "kubernetes_tpu/preemption.py:94",
        "scatter_rows": "kubernetes_tpu/snapshot.py:796",
        "expand_rows": "kubernetes_tpu/scheduler.py:44",
        "pinned_fit": "kubernetes_tpu/engine/pass_.py:941",
        "vol_filter": "kubernetes_tpu/ops/volumes.py:217",
    }
    # The top-level numbers of a kernel come from the shapes of the path it
    # was first ported for (density: eval_chunk, select_host,
    # resolve_commit; IPA: build_dom, ipa_eval, conflict_pairs; spread_na:
    # node_filters, spread_filter, late_scores; preemption_async_5kn: the
    # preemption kernels and data moves; daemonset: pinned_fit; pv:
    # vol_filter); "by_shape"
    # holds every shape it was measured at.  "launches" sums the main
    # paths' first kernel runs, "launches_by_path" splits them.
    first = {name: "ipa" for name in kernels.WRAPPERS}
    first.update(eval_chunk="density", select_host="density", resolve_commit="density",
                 node_filters="spread_na", spread_filter="spread_na", late_scores="spread_na",
                 **dict.fromkeys(("preempt_eval", "preempt_pick", "preempt_commit", "unpack_victims",
                                  "scatter_rows", "expand_rows"), "preemption_async_5kn"),
                 pinned_fit="daemonset", vol_filter="pv")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [], "data_moves_by_path": moves}
    for name in kernels.WRAPPERS:
        top = shapes[first[name]][name]
        counts = {path: c[name] for path, c in by_path.items()}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": f"{csrc}{build.ENTRIES[name]}.cu",
            "replaces": replaces[name],
            "launches": sum(counts.values()) if counts else None, "launches_by_path": counts,
            "max_abs_err": max(t[name]["max_abs_err"] for t in shapes.values() if name in t),
            **{k: top.get(k) for k in keys},
            "by_shape": {shape: {k: t[name].get(k) for k in keys} for shape, t in shapes.items() if name in t},
        })
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def print_trace(label: str, dt: float, spans: dict, card: str) -> None:
    busy = sum(spans["device_ms_by_kernel"].values()) / 1e3
    top = sorted(spans["device_ms_by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} traced window {dt:.3f}s (backoff waited {spans['backoff_s']:.3f}s): featurize "
          f"{spans['featurize_s']:.3f}s, host-to-device "
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
