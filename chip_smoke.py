#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --compare DIR --paths density,daemonset_15kn
        # only: these paths' windows in another tree of the port (DIR, e.g.
        # the parent commit unpacked) and in this one, back to back on one
        # card, three times in the order DIR, this, this, DIR
    python3 chip_smoke.py --kernels-only --kernels-of DIR
        # this script's kernel phase (its inputs, shapes and cases) on the
        # package in DIR: its kernels and wrappers, built from DIR's sources
    python3 chip_smoke.py --kernels-only --shapes ports_images,flush
        # only these groups of the kernel phase (with or without
        # --kernels-of), no exactness cases and no kernels line

Phases; any failure fails the run (nothing is caught):
  1. the card's name and power limit, the torch and CUDA versions;
  2. build the CUDA kernels from kubernetes_tpu_torch/kernels/csrc (one
     nvcc per source, started together);
  3. time an empty kernel the same way as the kernels (the launch floor),
     then hold each kernel against its plain PyTorch version on the card,
     on seeded inputs; exact equality is required, and both are timed with
     CUDA events (median of 20 kernel calls and of 10 plain calls or
     fewer); each group of shapes prints when it is done:
     - at the density shapes (C=64 pods, N=8192 node rows, R=4 resources),
       with score ties, zero allocatable, unschedulable nodes, pods
       feasible nowhere, a nominated-pod overlay and duplicate picks:
       build_dom, eval_chunk, select_host, resolve_commit; and select_host
       on cases that cross the node-axis slices of a thread block cluster
       (select_cases: ties straddling every slice start, kth at a slice's
       first and last tie, the only feasible row in the last slice, ties
       only below row 5000 of 8192, every row tied, none feasible, totals
       at ±2^62), 64 pods a launch with nominated rows;
     - at the chunk-1 paths' shape ("c1": one pod of that chunk, N=8192,
       no nominated overlay): eval_chunk, select_host in row mode and the
       strict resolve_commit, and select_host on the slice-crossing cases
       one pod a launch;
     - at "ipa_c1" (the explain and search paths' ipa_eval launches: C=1,
       N=8192, the "cols" cluster with 200 more bound pods whose terms
       match the pod, a pod with zone and hostname required affinity,
       anti-affinity and preferred terms): ipa_eval in one launch and in
       its two truncated-mode launches, on eval_chunk's feasible set, on
       that set cut to the last slice, on one node and on none;
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
       select_host and resolve_commit; and at "spread_c1" (the explain and
       search paths' launches: the inclusion cluster, C=1, N=8192, one pod
       a launch): spread_filter, late_scores and late_scores/cols on the
       workload's first 16 pods and the 32 mixed pods under both profiles;
     - at the two preemption shapes (preemption_500n: N=512, 2000 bound
       background pods under two PDBs, one with no disruption left, batch
       512; preemption_async_5kn: N=8192, 5000 bound pods, batch 1024): the
       victim pack through unpack_victims, then preempt_eval, preempt_pick
       and preempt_commit on a chunk-1 dry-run, the uniform batch's rank
       split, a mixed 64-pod chunk whose other-signature mates defer, and
       the speculative mode (preempt_pick also timed on the 500-node
       chunk-1 dry-run, "preemption_500n_c1": the PostFilter phase's
       launches); scatter_rows into fields of both node axes and
       into the victim buffer, expand_rows of every feature (their library
       yardsticks index_copy_ and repeat timed beside them); and the main
       pass's eval_chunk, select_host and resolve_commit at the path's own
       chunk (64 and 128), with a nominated-pod overlay and duplicate picks
       on full and emptied rows;
     - at the daemonset shapes (K=4096 pinned pods, N=16384, the nodes
       reporting images): node_filters, image_scores, eval_chunk and
       late_scores in pinned mode (each pod on its own node, pins that name
       no node, nominated pins, a preferred zone term, pods naming
       images), pinned_fit with same-row overflow, the strict
       resolve_commit, and the pinned pass end to end;
     - at the "pv" shape (C=64, N=8192, a 4096-pod batch of mixed claims):
       node_filters with the volume bits, vol_filter, eval_chunk with the
       volume planes, select_host, resolve_commit with the device and CSI
       commit and the attach-limit clash, conflict_pairs with volume ids,
       build_dom;
     - node_filters' cases (nf_cases) on the pv, spread_na and inclusion
       clusters, tiled and pinned: programs drawn from the cluster's own
       labels, every op on every pod (selectors, required terms of every
       operator, added affinity, taints, VolumeBinding and VolumeZone),
       VolumeBinding's ngroups at 63, 64, 65, 128, 129 and 130 (across the
       kernel's 64-group mask windows), groups without terms, ngroups 0,
       infeasible pods; on the pv cluster also with its labels scattered
       over 32 and 64 slots and through unaligned views (label_layouts:
       every instantiation of the tiled kernel);
     - at the "flush" shapes (the extender path's schema: 5000 nodes,
       N=8192, 512 bound pods): 1, 8 and 64 dirty rows of random values in
       all 27 fields flushed by SnapshotBuilder.state() in one
       scatter_rows launch and one copy, against the per-field plain
       scatter;
     - at the "ports/images" shape (C=64, N=8192 with IM=128 image slots
       from a 400-image pool, a 4096-pod batch one pod in 8 of which asks
       for 1-3 host ports over P=16 triples, prefilled counts):
       image_counts, image_scores, eval_chunk with NodePorts and the image
       plane, select_host, resolve_commit with the port commit,
       conflict_pairs with port keys; and ImageLocality's rounding cases
       (a size x spread product on the 1000 MiB threshold and an ulp below
       it, sums at 23 MiB - 1, 23 MiB, 1000 MiB x n and + 1, an image
       named twice); and at "explain_il", the explain phase's batch
       (1025 pods in 4096 lanes) on that cluster: image_counts and
       image_scores;
     - at the two search shapes (preempt_search; "search": the
       preemption_default_search_5kn cluster, N=8192, its 20000 background
       pods bound four to a node, 300 app=svc pods skewed over the zones,
       the 1024-pod batch of the path's preemptor and a mixed 64-pod chunk;
       "search_pv": N=8192, two bound pods per node with device volumes and
       a node-shared CSI claim, the CSI volume table at 8192 rows): the
       victim pack through unpack_victims with its feature columns, then
       preempt_eval's prologue, search_step on the live state (the hard
       filters), dom_release and search_step for phase 1 and every occupied
       slot, and preempt_eval's tail, the carry and the released domain
       tables compared after every step, for chunk 1 (a zone affinity, a
       hostname spread), the rank split, a mixed chunk and the speculative
       mode, and preempt_pick on every tail (timed on the mixed chunk, and
       on the chunk-1 tail at N=8192 as "search_c1");
       and preempt_eval in one launch with the node-local ops alone (and,
       at "search", its prologue and its tail on the rank split's carry
       timed as "search_prologue" and "search_tail");
       the third search shape, "search_dra" (N=8192, V=8, four claim
       holders a node on half the nodes, one claim shared by two of them,
       externally allocated claims a victim alone reserves, external
       phantom charges, the claim table at 8192 rows), runs the same steps
       with DynamicResources' release and hard filter, and so does
       "search_dra_path", dra_claims_5kn_5kpods's own cluster half full
       of claim pods with its 128 whole-node preemptors at the path's
       dry-run chunk of 8;
     - at the "dra" shape (C=64, N=8192, a 4096-pod batch with 1-2 claim
       slots a pod over three pools, CLM=8192; shared claims inside a
       chunk, a claim named twice, claims already reserved, pins, missing
       claims): conflict_pairs with claim ids and racing claims, eval_chunk
       with DynamicResources (filter code 5), select_host (timed: the
       claims path's C=8 launches), and resolve_commit strict and not with
       the claim commit; the same at "dra_path", the path's own C=8 over
       the DRA_BATCH pods it has pending on that cluster;
     - truncated mode: at the "truncate" shape (parity_basic_5kn_10kpods'
       5000 nodes, N=8192, limit 500) truncate_feasible and select_host in
       pos mode with 0, 1, 500, 501, 2500 and 5000 feasible nodes, starts
       at 0, 4999 and 2777, a padding lane, ties on few totals, and 501
       feasible rows at the scan's wrap from start 4999 (also through
       unaligned views: the kernel's scalar loads), build_dom; then
       select_host's pos mode with kth on both sides of the word ranges of
       its positions' bitmap (pos_cases); truncated chunk-1 steps, the two
       outputs and the carried start
       compared at every step: at the IPA shape ("truncate_ipa": eval_chunk,
       ipa_eval's filter launch, truncate_feasible, its score launch,
       select_host in pos mode) and the spread_na shape ("truncate_spread":
       spread_filter, eval_chunk, truncate_feasible, late_scores over the
       truncated set, select_host in pos mode);
     - every kernel a path launches at that path's own shape (PATH_SHAPE):
       build_dom at every shape's state; eval_chunk, select_host and
       resolve_commit (check_main_at) at "search" (C=128), "hetero",
       "hetero_learned" and "rtcr"; select_host at "pv" and
       "ports_images"; node_filters and conflict_pairs on the search
       path's preemptor batch, node_filters of the explained pod at "cols";
       preempt_commit and expand_rows at every search shape;
     - eval_chunk's RequestedToCapacityRatio, throughput and learned terms,
       each an entry of its own in the kernels line: RequestedToCapacityRatio at the density shape ("rtcr": the
       bin-packing shape, a five-point decreasing shape and a
       three-resource strategy, utilizations on the shape points, zero
       allocatable, requests over allocatable; a 17-point shape refused
       before launch); the throughput term, and the throughput and learned
       terms, at "hetero" (5000 nodes dealt over three accelerator
       classes, unlabelled nodes and a class the matrix lacks, N=8192) and
       "hetero_learned" (1000 nodes, N=1024), C=64, 0-110 pods a node and
       loads up to 120% of allocatable, the learned term in XLA's
       arithmetic in both (ops/learned.py); and the filters after
       InterPodAffinity at "split" (1000 nodes, C=64, affinity and claim
       pods in one chunk): eval_chunk, ipa_eval's filter, eval_chunk's
       second launch with DynamicResources on the nodes left, ipa_eval's
       score, every output after every launch;
     - the attribution pass's columns modes, each an entry of its own in
       the kernels line, at C=1 for a pod with NodeAffinity, tolerations,
       zone spread, (anti-)affinity, a host port and images under the
       default profile, on 5000 nodes ("cols", N=8192) and 1000 ("cols_1k",
       N=1024) in 10 zones with tiers, taints, images and bound pods:
       eval_chunk/cols, ipa_eval/cols (its filter and score phases) and
       late_scores/cols, and the whole attribution pass's four outputs;
     - untimed exactness cases (check_exact_cases): eval_chunk's int64
       divisions at multiples of the allocatable and one either side,
       al = 1, rq = al, rq > al and both sides of 2^53, under both fit
       strategies; resolve_commit with every optional commit branch under
       a sparse and a dense conflict table, and with C=33 and C=1024 pods
       crowding one nearly full row, strict and not; spread_filter,
       late_scores and late_scores/cols on cases that cross the node-axis
       slices of a thread block cluster (spread_cases: 5000 nodes, N=8192,
       one pod a launch at K=16, all pods in one launch and again at K=1):
       a domain on one slice's rows only, a hostname minimum in the last
       slice that holds nodes, the zone key missing on the rows where slices meet,
       minDomains above the domain count, feasible sets on one slice only,
       on no scored node, on one node and on none, and the 9·log(19) → 26
       rounding boundary; preempt_pick in every mode and cluster size
       pick_split chooses (pick_cases: N from 1 to 20000, C from 1 to 1024;
       no node possible, every node tied, ties across slice boundaries,
       keys differing only in the start key, keys at ±2^62 and -2^61 with
       violations at the sentinel, a few possible nodes under many mates,
       two signatures; the mates valid and in the speculative view);
     - build_dom in every (R, K) class kernels.dom_split gives (dom_cases,
       the "dom" group, untimed: R = 1 at K = 1, 2, 4, 8, 16, R > 1 at K =
       1; the domain values in registers and from topo_vals; slices
       ending short, N = 1 and 5, G = 0, ET = 0, R shrunk by its tables,
       slots outside [0, TK), hostname ids inside and past DV, a warp's
       lanes on one cell, sums near 2^24, unaligned views), exact against
       its plain version;
     - preempt_eval at every lane count kernels.eval_lanes gives (eval_cases,
       the "eval" group, untimed: V = 1, 2, 3, 8, 16, 33, 64 over 333 node
       rows, R = 1 and 4, 0-3 PDBs; the closed-form fit alone, NodePorts,
       VolumeRestrictions, NodeVolumeLimits, DynamicResources and all four,
       with ids shared between victims, crossing volumes and claims,
       count-only claim slots, phantom charges, pins elsewhere; ties at the
       top priority with infinite starts, no victim below, a
       ReadWriteOncePod-blocked, late (C = 1024) or missing representative,
       the speculative view), exact against its plain version in FULL,
       PROLOGUE and TAIL;
  4. drive each main path through TorchScheduler, with the launch counts
     set to 0 just before and read just after; every pod must bind, the
     host mirror must equal the device state, no node may exceed its
     allocatable, the path's kernels must launch and no other; a traced run
     gives the device idle share; then the plain versions on the card must
     bind identically (every path's plain run after the last kernel run,
     PLAIN_WORKERS processes at a time, longest first):
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
     - default_images_ports_5kn_10kpods (5000 nodes each reporting 50
       images, 2048 + 10000 pods naming images, one in 32 with a host
       port; no harness counterpart): no node holds two pods whose host
       ports conflict, and no whole-state upload happens in the window;
     - preemption_default_search_5kn (5000 nodes in 10 zones, 20000 batch
       pods bound as they arrive, four a node, a warm-up preemptor, then
       500 service preemptors (half its 1000) with a zone
       spread, an anti-affinity to tier=noisy and host port 8080; default
       profile, backoff waited, nominate-and-retry; no harness
       counterpart): every preemptor binds, every victim is a priority-1
       batch pod, no node holds two port-8080 pods, no service pod shares a
       node with a tier=noisy pod or with a pod keeping app=svc off, the
       service's zone counts differ by at most 1, no whole-state upload;
     - dra_claims_5kn_5kpods at half its depth (2500 nodes in 10 zones,
       one in four publishing 8 GPUs; 512 fill pods, 2500 pods with their
       own claims, one in four h100 only, one in 32 sharing a claim; then
       128 preemptors each wanting a whole GPU node; default profile, backoff
       on a virtual clock; no harness counterpart): every claim pod binds
       or was evicted, every preemptor binds, claims sit on their pods'
       nodes on published devices (h100 ones for h100 claims), shared pairs
       share a node, dra_alloc stays within dra_cap and equals the claim
       catalog's owned devices per pool, victims are priority-1 claim pods
       whose claims were released, no whole-state upload;
     - parity_basic_5kn_10kpods (basic_5kn_10kpods, harness.py:396-405, in
       truncated mode: density's 5000 nodes in 3 zones, 2048 + 5000 pods,
       half its measured depth,
       the default profile with the adaptive percentage of nodes to score,
       batch 1024, chunk 1): truncate_feasible launches, every pod binds,
       no node fills and every pod's scan keeps exactly 500 feasible nodes,
       the scan start moves and every run ends on the same one, no
       whole-state upload;
     - hetero_5kn_10kpods and hetero_learned_1kn_5kpods (harness.py:
       1089, 1099: 5000 / 1000 nodes in 10 zones dealt 5:3:2 over tpu-v4,
       tpu-v5e and gpu-a100; 2048 + 10000 / 1024 + 5000 pods of the four
       workload classes naming throughput-aware-scheduler /
       learned-scorer-scheduler; three profiles registered, batch 4096,
       chunk 64) and binpack_rtcr_5kn_10kpods (density's nodes and 2048 +
       10000 pods under upstream's RequestedToCapacityRatio bin-packing
       strategy; no harness counterpart): eval_chunk's throughput, learned
       and RequestedToCapacityRatio terms launch on their paths and on no
       other; the share of each workload class's pods on its best
       accelerator class and the nodes the bin-packing used are printed;
     - extender_5kn_1kpods (density's 5000 nodes in 10 zones, tiered
       1:2:2 and one in five denied; 512 + 1000 density pods, each through
       the eval-only pass and three in-process extenders: a filter that
       drops the denied nodes, a prioritizer of weight 5 by tier, an
       ignorable one that raises on every 100th call; no harness
       counterpart): no pod on a denied node, and 32 sampled picks equal
       the host's argmax of plugin total + 5 x tier score; then its
       PostFilter phase (500 full nodes, 32 preemptors, an extender that
       keeps or vetoes every candidate): the victims equal the plain run's
       and the veto evicts nothing;
     - after default_images_ports_5kn_10kpods' window, its explain phase:
       provenance armed, one more batch of 1024 mixed pods and an unfit
       one, then explain_pod of 32 bound, 32 pending and the unfit pod:
       every record equals the plain run's (diff_records None), every
       capsule too, and the unfit pod's rejecting plugin is
       NodeResourcesFit on every node;
     every run of a path must give the same outcome count and send the
     same number of pods to backoff; pods/s, the idle share, deferrals,
     preemptions, the backoff waited and the garbage collector's pauses in
     each window, the pack width, the host-to-device feature bytes and the
     data moves (scatter_rows and expand_rows launches; torch index_copy_
     and expand calls, which must be 0; row flushes, their host-to-device
     copies and victim-buffer scatters: every scatter_rows launch must be
     one flush or one victim-buffer scatter, and a flush makes at most one
     copy) are printed;
  5. print the redesign queue (launches x (ms - bound_ms) per kernel over
     every path, at the shapes PATH_SHAPE lists for the path, and the
     paths whose figure fell back to another shape), the per-kernel JSON
     line (launches per path, the numbers of every shape a kernel was
     measured at, and for eval_chunk and resolve_commit the launch floor),
     the card line, and last the device line.

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
# Timed calls per kernel and (at most) per plain version (the median is
# kept).
REPS = 20
PLAIN_REPS = 10


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
    main path when the host cannot run ahead).  The spin lasts about 10 ms
    until a call time is known, then twice the last call time (at least
    0.5 ms), which still covers the host's enqueue."""
    import torch

    dev_times, call_times = [], []
    spin = 20_000_000  # cycles, ~10 ms
    for r in range(reps + 3):
        for busy, times in ((True, dev_times), (False, call_times)):
            arg = setup() if setup is not None else None
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if busy:
                torch.cuda._sleep(spin)
            start.record()
            fn(arg)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            if not busy:  # ~2e6 cycles a ms
                spin = int(min(20_000_000, max(1_000_000, 4e6 * ms)))
            if r >= 3:  # warm-up calls
                times.append(ms)
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
    (g, n), et, tk = state.group_counts.shape, state.et_counts.shape[0], state.topo_vals.shape[1]
    split = getattr(kernels, "dom_split", None)  # (a tree from before dom_split: one block a row)
    geometry = "" if split is None else f", (R, K, S, threads) {split(g + et, n, tk, dv, kernels._sms(kg.device))}"
    print(f"build_dom [{label}]: exact; {int(pg.sum())} group and {int(pe.sum())} term "
          f"carriers in domains; G={g} ET={et} N={n} TK={tk} DV={dv}{geometry}")
    out = timed(lambda _: kernels.build_dom(state, et_slot, dv),
                lambda _: plain.build_dom(state, et_slot, dv), reps)
    set_bound(out, *dom_cost(state, et_slot, kg, ke))
    return out


def dom_at(errs: dict, label: str, builder, state, reps: int) -> dict:
    """build_dom at a path's own shape: its state and its builder's term
    slots (check_dom)."""
    import torch

    et_slot = torch.from_numpy(builder.batch_invariants()["et_slot"]).to(state.valid.device)
    return check_dom(errs, label, state, et_slot, builder.schema.DV, reps)


# dom_cases: (label, G, ET, N, TK, DV) of each shape, chosen so that
# kernels.dom_split gives every K with R = 1 and K = 1 with R > 1 on the
# H100 (132 SMs), slices ending short, the largest tables, R shrunk by
# them, and both sources of a node's domain values (kernels.dom_columns:
# registers at TK = 4, topo_vals else), each with R = 1 and R > 1; and the
# kinds of input each shape gets.
DOM_CASE_SHAPES = (
    ("K=16", 3, 2, 16384 + 37, 4, 8), ("K=8 c1", 8, 8, 8192, 4, 8), ("K=8", 20, 6, 8192 + 5, 4, 16),
    ("K=4", 3, 2, 4096 + 3, 4, 8), ("K=2", 3, 2, 2048 + 1, 4, 8), ("K=1", 3, 2, 301, 4, 8),
    ("K=1 N=1", 2, 3, 1, 4, 8), ("K=1 N=5", 2, 3, 5, 4, 8), ("G=0", 0, 5, 8192 + 2, 4, 8),
    ("ET=0", 5, 0, 4099, 4, 8), ("R>1", 400, 300, 1030, 4, 16), ("R>1 ipa", 2048, 2048, 1024, 4, 16),
    ("R>1 odd", 901, 300, 777, 4, 8), ("R>1 large DV", 600, 200, 600, 4, 3000),
    ("R>1 TK=3", 400, 300, 1030, 3, 16), ("R shrunk to 1", 600, 200, 64, 4, 13000),
    ("DV 13000", 3, 2, 8192 + 11, 4, 13000),
    ("DV at the cap", 2, 2, 4096 + 3, 4, 14528), ("TK=3", 3, 2, 8192 + 11, 3, 15000),
    ("TK=3 DV at the cap", 3, 2, 8192 + 11, 3, 19370), ("TK=8", 3, 2, 4099, 8, 16),
)
DOM_CASE_KINDS = ("drawn", "one domain", "near 2^24", "unaligned")


def dom_case(rng, g: int, et: int, n: int, tk: int, dv: int, kind: str):
    """(group_counts, et_counts, topo_vals, et_slot) of one build_dom case,
    numpy: topology values over [-1, DV + 3) (missing keys and ids past
    DV), key 0 the hostname (the node's row: inside [0, DV) on the first
    rows), slots over [-1, TK + 1), most counts 0; or as ``kind`` says:
    every count on one domain (every lane of a warp on one cell), or each
    key's domain 0 summing to 2^24 - 7 over the nodes."""
    import numpy as np

    topo = rng.integers(-1, dv + 3, (n, tk)).astype(np.int32)
    topo[:, 0] = np.arange(n)
    gc = np.where(rng.random((g, n)) < 0.3, rng.integers(1, 9, (g, n)), 0).astype(np.int32)
    ec = np.where(rng.random((et, n)) < 0.3, rng.integers(1, 9, (et, n)), 0).astype(np.int32)
    slot = rng.integers(-1, tk + 2, et).astype(np.int32)
    if kind == "one domain":
        topo[:] = 1
        gc[:] = rng.integers(1, 4, (g, n))
        ec[:] = rng.integers(1, 4, (et, n))
        slot[:] = tk - 1
    elif kind == "near 2^24":
        topo[:] = 0
        per = (2**24 - 7) // n
        gc[:] = per
        ec[:] = per
        gc[:, -1] = ec[:, -1] = 2**24 - 7 - per * (n - 1)
        slot[:] = 0
    return gc, ec, topo, slot


def dom_cases(errs: dict, dev) -> None:
    """build_dom against its plain version, exactly, on dom_case's inputs
    at every shape of DOM_CASE_SHAPES and kind of DOM_CASE_KINDS
    ("unaligned": the drawn counts and topology through views 4 bytes past
    16-byte alignment, the kernel's scalar loads); the (R, K) classes these
    launch must be every class dom_split can give (R = 1 at K = 1, 2, 4, 8,
    16 and R > 1 at K = 1), with the domain values from both sources
    (kernels.dom_columns)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    def unaligned(t):
        return torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)

    rng = np.random.default_rng(1901)
    seen: dict = {}
    sms = kernels._sms(dev)
    for label, g, et, n, tk, dv in DOM_CASE_SHAPES:
        r, k, s, threads = kernels.dom_split(g + et, n, tk, dv, sms)
        source = kernels.dom_columns(tk)
        for kind in DOM_CASE_KINDS:
            gc, ec, topo, slot = (torch.from_numpy(a).to(dev) for a in
                                  dom_case(rng, g, et, n, tk, dv, "drawn" if kind == "unaligned" else kind))
            if kind == "unaligned":
                gc, ec, topo = unaligned(gc), unaligned(ec), unaligned(topo)
            state = SimpleNamespace(group_counts=gc, et_counts=ec, topo_vals=topo)
            kg, ke = kernels.build_dom(state, slot, dv)
            pg, pe = plain.build_dom(state, slot, dv)
            torch.cuda.synchronize()
            where = f"[dom_cases {label} R={r} K={k} {kind}]"
            exact(errs, "build_dom", f"{where} group_dom", kg, pg)
            exact(errs, "build_dom", f"{where} et_dom", ke, pe)
        cls = ("R=1" if r == 1 else "R>1", k)
        entry = seen.setdefault(cls, {"shapes": [], "columns": set()})
        entry["shapes"].append(f"{label} (R={r}, S={s}, {threads} threads)")
        entry["columns"].add(source)
    every = {("R=1", k) for k in (1, 2, 4, 8, 16)} | {("R>1", 1)}
    sources = set().union(*(e["columns"] for e in seen.values()))
    if set(seen) != every or sources != {"registers", "topo_vals"}:
        raise AssertionError(f"dom_cases: launched {sorted(seen)} with domain values from {sorted(sources)}, "
                             f"dom_split gives {sorted(every)} with registers and topo_vals")
    for (rc, k), e in sorted(seen.items()):
        print(f"build_dom [dom_cases {rc} K={k}]: exact on {len(DOM_CASE_KINDS)} kinds at {e['shapes']}, "
              f"domain values from {sorted(e['columns'])}")


# nf_cases: pods a case batch, VolumeBinding terms a pod, and the group
# counts drawn (the kernel's mask holds 64 groups a window).
NF_CASE_PODS = 40
NF_CASE_TERMS = 130
NF_CASE_GROUPS = (63, 64, 65, 128, 129, 130, 0, 7)


def label_layouts(state, rng) -> list:
    """(name, state) of each label slot layout node_filters' tiled launch
    has a path for: the state's own (LS slots, node_tile_kernel<LS>), its
    labels scattered over 32 slots (node_tile_kernel<32>) and over 64 (the
    walk in global memory), and its own through views 4 bytes past 16-byte
    alignment (the walk: no int4 loads)."""
    import dataclasses

    import numpy as np
    import torch

    from kubernetes_tpu_torch.snapshot import INT_SENTINEL

    fields = (("label_key_ids", -1), ("label_pair_ids", -1), ("label_int_vals", INT_SENTINEL))
    n, ls = state.label_key_ids.shape
    out = [(f"LS={ls}", state)]
    for width in (w for w in (32, 64) if w > ls):
        slot = torch.from_numpy(np.argsort(rng.random((n, width)), axis=1)[:, :ls]).to(state.valid.device)
        wide = {f: torch.full((n, width), fill, dtype=getattr(state, f).dtype, device=state.valid.device)
                .scatter_(1, slot, getattr(state, f)) for f, fill in fields}
        out.append((f"LS={width}", dataclasses.replace(state, **wide)))
    shifted = {f: torch.cat([getattr(state, f).new_zeros(1), getattr(state, f).flatten()])[1:].view(n, ls)
               for f, _fill in fields}
    out.append((f"LS={ls}, unaligned", dataclasses.replace(state, **shifted)))
    return out


# pick_cases: node rows (one case a mode and cluster size pick_split picks,
# 20000 past what 16 slices of one network hold) and chunk sizes.
PICK_CASE_N = (1, 31, 500, 1000, 2000, 4096, 5000, 8192, 12000, 20000)
PICK_CASE_C = (1, 8, 64, 512, 1024)
PICK_CASE_KINDS = ("drawn", "none possible", "all tied", "ties across slices", "start key only", "extremes",
                   "few possible", "mixed signatures")


def pick_case(rng, n: int, c: int, kind: str):
    """(possible, crit, valid, sig) of one synthetic preempt_pick case over
    ``n`` node rows and ``c`` mates, numpy: criteria drawn from few values
    (ties), or as ``kind`` says: no node possible; every node tied; equal
    keys on the rows either side of every boundary of 512, 313 and 750
    rows; keys differing only in the start key (drawn over ±2^61); keys at
    ±2^62, 2^62 - 1, 0 and -2^61 (violations 2^62 on some possible nodes:
    the rank split's sentinel); a handful of possible nodes under many
    eligible mates; two signatures with the representative's mates
    deferring the rest."""
    import numpy as np

    crit = np.stack([rng.integers(0, 2, n), rng.integers(0, 3, n), rng.integers(0, 4, n),
                     rng.integers(0, 3, n), rng.integers(-3, 0, n)]).astype(np.int64)
    possible = rng.random(n) < 0.8
    if kind == "none possible":
        possible[:] = False
    elif kind == "all tied":
        crit[:] = 7
        possible[:] = True
    elif kind == "ties across slices":
        for step in (512, 313, 750):
            edge = np.arange(step, n, step)
            for e in edge:
                crit[:, max(0, e - 2):e + 2] = crit[:, e - 1:e]
    elif kind == "start key only":
        crit[:4] = 1
        crit[4] = rng.integers(-(2**61), 2**61, n)
    elif kind == "extremes":
        crit = rng.choice(np.array([-(2**62), 2**62, 2**62 - 1, 0, -(2**61)]), (5, n)).astype(np.int64)
    elif kind == "few possible":
        possible[:] = False
        possible[rng.choice(n, min(n, 3), replace=False)] = True
    valid = rng.random(c) < 0.9
    sig = (rng.integers(0, 2, c) if kind == "mixed signatures" else np.zeros(c)).astype(np.int32)
    return possible, crit, valid, sig


def pick_cases(errs: dict, dev) -> None:
    """preempt_pick against its plain version on synthetic cases
    (pick_case) at every N of PICK_CASE_N and C of PICK_CASE_C, each with
    the mates valid and in the speculative view (elig, spec_picks), chunk
    mode as the dry-run sets it (C > 1); the (mode, K) pairs these launch
    must be every pair pick_split can give."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    names = {kernels.PICK_ARGMIN: "argmin", kernels.PICK_SPLIT: "split", kernels.PICK_TILED: "tiled"}
    rng = np.random.default_rng(1801)
    seen: dict = {}
    for n in PICK_CASE_N:
        for c in PICK_CASE_C:
            mode, k, _s, threads = kernels.pick_split(c, n)
            for kind in PICK_CASE_KINDS:
                possible, crit, valid, sig = pick_case(rng, n, c, kind)
                base = {"sig": torch.from_numpy(sig).to(dev)}
                views = {"valid": {**base, "valid": torch.from_numpy(valid).to(dev)},
                         "speculative": {**base, "elig": torch.from_numpy(valid).to(dev),
                                         "spec_picks": torch.from_numpy(
                                             np.where(rng.random(c) < 0.3, 5, -1).astype(np.int32)).to(dev)}}
                p_d, c_d = torch.from_numpy(possible).to(dev), torch.from_numpy(crit).to(dev)
                for view, pf in views.items():
                    got = kernels.preempt_pick(p_d, c_d, pf, c > 1)
                    want = plain.preempt_pick(p_d, c_d, pf, c > 1)
                    torch.cuda.synchronize()
                    exact(errs, "preempt_pick", f"[pick_cases {names[mode]} K={k} N={n} C={c} {kind}, {view}]",
                          got, want)
                entry = seen.setdefault((names[mode], k), {"n": set(), "threads": set(), "cases": 0})
                entry["n"].add(n)
                entry["threads"].add(threads)
                entry["cases"] += 2
    every = {(names[m], k) for m in names for k in (1, 2, 4, 8, 16)
             if m != kernels.PICK_TILED or k == kernels.CLUSTER_MAX}
    if set(seen) != every:
        raise AssertionError(f"pick_cases: launched {sorted(seen)}, pick_split gives {sorted(every)}")
    for (mode, k), e in sorted(seen.items()):
        print(f"preempt_pick [pick_cases {mode} K={k}]: exact on {e['cases']} cases at N "
              f"{sorted(e['n'])}, {sorted(e['threads'])} threads a CTA")


# eval_cases: victim slots (V 1, 2, 3, 8, 16, 33, 64: every lane count
# kernels.eval_lanes gives), the op families of the node-local search, and
# the kinds of case; the tables' id ranges are small, so victims of a node
# share ports, devices, volumes and claims.
EVAL_CASE_V = (1, 2, 3, 8, 16, 33, 64)
EVAL_CASE_OPS = ("fit", "ports", "vr", "nvl", "dra", "all")
EVAL_CASE_KINDS = ("drawn", "ties", "none below", "rwop", "late", "none valid", "speculative")
EVAL_IDS = {"P": 8, "PK": 4, "VD": 4, "DR": 2, "CV": 6, "DC": 3, "CLM": 6}


def eval_case(rng, n: int, v: int, r: int, p: int, ops: str, kind: str, dev):
    """(state, vic, pf, spec) of one synthetic preempt_eval case over ``n``
    node rows and ``v`` victim slots (a node's first 0..V occupied, the
    rest the pack's empty-slot sentinels), ``r`` resources and ``p`` PDBs,
    on ``dev``.  The representative (priority 6) meets victims of priority
    0-9 on nodes whose requests are their victims' plus a little, a pod
    count near its limit, unschedulable and invalid rows, a NodeName and
    node_filters bits.  ``ops``: the closed-form fit alone, one op family
    of the search or all four: NodePorts (specific and wildcard slots,
    victims sharing triples), VolumeRestrictions (read-write and read-only
    devices), NodeVolumeLimits (volumes shared by victims, the driver's
    attachments crossing, volumes no victim holds) and DynamicResources
    (shared claims, a count-only slot, phantom charges, pins elsewhere, a
    missing claim); every live count is the victims' holdings plus an
    outside share on one cell in ten.  ``kind``: "ties" (priorities 2-3,
    nine starts in ten infinite), "none below" (no victim below the
    priority), "rwop" (a ReadWriteOncePod-blocked representative), "late"
    (C = 1024, the first valid mate at 1000), "none valid" (C = 1024, no
    valid mate), "speculative" (elig and spec_picks), else drawn."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kernels import PreemptSpec, Victims
    from kubernetes_tpu_torch.snapshot import Schema, _host_arrays, state_from_numpy

    on = {op: ops in (op, "all") for op in ("ports", "vr", "nvl", "dra")}
    ids = EVAL_IDS
    c = 1024 if kind in ("late", "none valid") else 8
    occ = rng.integers(0, v + 1, n)
    used = np.arange(v)[None, :] < occ[:, None]  # (n, v)
    lo, hi = (2, 4) if kind == "ties" else (0, 10)
    prio = np.where(used, rng.integers(lo, hi, (n, v)), 2**31 - 1).astype(np.int32)
    req = np.where(used[:, :, None], rng.integers(0, 4, (n, v, r)), 0).astype(np.int64)
    nonzero = np.where(used[:, :, None], rng.integers(0, 5, (n, v, 2)), 0).astype(np.int64)
    start = rng.integers(0, 12, (n, v)) * 0.5
    start = np.where(rng.random((n, v)) < (0.9 if kind == "ties" else 0.2), np.inf, start)
    start = np.where(used, start, np.inf)
    pdb = used[:, :, None] & (rng.random((n, v, p)) < 0.4)
    allowed = rng.integers(0, 3, p).astype(np.int64)

    def slots(width: int, lo_: int, hi_: int, pad: int):
        return np.where(used[:, :, None], rng.integers(lo_, hi_, (n, v, width)), pad).astype(np.int32)

    def held(col, rows: int, gate=None) -> np.ndarray:
        """(rows, n): the node's slots holding each id (gated), plus an
        outside share on one cell in ten."""
        out = np.zeros((rows, n), np.int64)
        node = np.broadcast_to(np.arange(n)[:, None, None], col.shape)
        keep = (col >= 0) if gate is None else (col >= 0) & gate
        np.add.at(out, (col[keep], node[keep]), 1)
        return (out + (rng.random((rows, n)) < 0.1)).astype(np.int32)

    f = _host_arrays(Schema(N=n, R=r, LS=1, TS=1, TK=1, G=1, ET=1, IM=1, **ids))
    f["valid"] = rng.random(n) < 0.95
    f["name_id"] = np.arange(n, dtype=np.int32)
    f["unschedulable"] = rng.random(n) < 0.1
    f["num_pods"] = (occ + rng.integers(0, 3, n)).astype(np.int32)
    f["allowed_pods"] = (f["num_pods"] + rng.integers(-1, 3, n)).astype(np.int32)
    f["req"] = req.sum(axis=1) + rng.integers(0, 3, (n, r))
    f["alloc"] = f["req"] + rng.integers(-2, 3, (n, r))
    vf = {}
    if on["ports"]:
        vf["port_triples"] = slots(2, -1, ids["P"], -1)
        keys = rng.integers(-1, ids["PK"], (n, v, 2))
        vf["port_keys"] = np.where(vf["port_triples"] >= 0, keys, -1).astype(np.int32)
        f["port_counts"] = held(vf["port_triples"], ids["P"])
        keys = np.where(vf["port_triples"] >= 0, np.maximum(vf["port_keys"], 0), -1)
        f["portkey_counts"] = held(keys, ids["PK"])
    if on["vr"]:
        vf["vol_dev_ids"] = slots(2, -1, ids["VD"], -1)
        vf["vol_dev_rw"] = np.where(vf["vol_dev_ids"] >= 0, rng.integers(0, 2, (n, v, 2)), 0).astype(np.int32)
        f["dev_counts"] = held(vf["vol_dev_ids"], ids["VD"])
        f["dev_rw_counts"] = held(vf["vol_dev_ids"], ids["VD"], vf["vol_dev_rw"] > 0)
    if on["nvl"]:
        vf["csi_ids"] = slots(2, -1, ids["CV"], -1)
        drv = (vf["csi_ids"] + (rng.random((n, v, 2)) < 0.1)) % ids["DR"]  # a volume's driver, now and then not
        vf["csi_drv"] = np.where(vf["csi_ids"] >= 0, drv, 0).astype(np.int32)
        f["csivol_counts"] = held(vf["csi_ids"], ids["CV"])
        f["csi_used"] = held(np.where(vf["csi_ids"] >= 0, vf["csi_drv"], -1), ids["DR"]) // 2
        f["csi_limit"] = (f["csi_used"] + rng.integers(0, 3, (ids["DR"], n))).astype(np.int32)
    if on["dra"]:
        vf["dra_kid"] = slots(2, -1, ids["CLM"], -1)
        vf["dra_cid"] = np.where(vf["dra_kid"] >= 0, rng.integers(-1, ids["DC"], (n, v, 2)), 0).astype(np.int32)
        vf["dra_cnt"] = np.where(vf["dra_kid"] >= 0, rng.integers(0, 3, (n, v, 2)), 0).astype(np.int32)
        vf["dra_first"] = np.where(vf["dra_kid"] >= 0, rng.random((n, v, 2)) < 0.8, 0).astype(np.int32)
        f["dra_claim_counts"] = held(vf["dra_kid"], ids["CLM"], vf["dra_first"] > 0)
        pool = np.zeros((ids["DC"], n), np.int64)
        node = np.broadcast_to(np.arange(n)[:, None, None], vf["dra_kid"].shape)
        keep = vf["dra_kid"] >= 0
        np.add.at(pool, (np.maximum(vf["dra_cid"], 0)[keep], node[keep]), vf["dra_cnt"][keep])
        f["dra_alloc"] = (pool + rng.integers(0, 2, (ids["DC"], n))).astype(np.int32)
        f["dra_cap"] = (f["dra_alloc"] + rng.integers(0, 4, (ids["DC"], n))).astype(np.int32)
    state = state_from_numpy(f, dev)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    vic = Victims(to(prio), to(req), to(nonzero), to(start), to(pdb), to(allowed), {k: to(a) for k, a in vf.items()})
    first = {"late": 1000, "none valid": c}.get(kind, int(rng.integers(0, 3)))
    valid = np.zeros(c, np.bool_)
    valid[first:first + 1] = True
    valid[first + 1:] = rng.random(max(0, c - first - 1)) < 0.7
    pf = {
        "priority": np.full(c, 0 if kind == "none below" else 6, np.int32),
        "req": rng.integers(0, 4, (c, r)) * (rng.random((c, r)) < 0.7),
        "nodename_id": np.where(rng.random(c) < 0.2, rng.integers(0, n, c), -1).astype(np.int32),
        "tolerates_unschedulable": rng.random(c) < 0.5,
        "node_bits": np.where(rng.random((c, n)) < 0.8, 15, rng.integers(0, 16, (c, n))).astype(np.uint8),
        "vr_rwop_ok": np.full(c, kind != "rwop"),
        "port_triples": rng.integers(-1, ids["P"], (c, 2)).astype(np.int32),
        "port_keys": rng.integers(-1, ids["PK"], (c, 2)).astype(np.int32),
        "port_wild_triples": rng.integers(-1, ids["P"], (c, 2)).astype(np.int32),
        "port_is_wild": rng.random((c, 2)) < 0.4,
        "vol_dev_ids": rng.integers(-1, ids["VD"], (c, 2)).astype(np.int32),
        "vol_dev_rw": rng.random((c, 2)) < 0.5,
        "vol_csi_ids": rng.integers(-1, ids["CV"], (c, 2)).astype(np.int32),
        "vol_csi_drv": rng.integers(-1, ids["DR"] + 1, (c, 2)).astype(np.int32),
        "dra_claim_ids": rng.integers(-1, ids["CLM"], (c, 2)).astype(np.int32),
        "dra_claim_cls": rng.integers(-1, ids["DC"] + 1, (c, 2)).astype(np.int32),
        "dra_claim_cnt": rng.integers(1, 4, (c, 2)).astype(np.int32),
        "dra_pin_ids": np.where(rng.random((c, 2)) < 0.1, rng.integers(0, n, (c, 2)), -1).astype(np.int32),
        "dra_missing": rng.random(c) < 0.05,
    }
    pf["req"] = pf["req"].astype(np.int64)
    if kind == "speculative":
        pf["elig"] = valid
        pf["spec_picks"] = np.where(rng.random(c) < 0.4, 3, -1).astype(np.int32)
    else:
        pf["valid"] = valid
    keep = {"ports": ("port_triples", "port_keys", "port_wild_triples", "port_is_wild"),
            "vr": ("vol_dev_ids", "vol_dev_rw"), "nvl": ("vol_csi_ids", "vol_csi_drv"),
            "dra": ("dra_claim_ids", "dra_claim_cls", "dra_claim_cnt", "dra_pin_ids", "dra_missing")}
    for op, keys in keep.items():
        for key in keys if not on[op] else ():
            del pf[key]
    if not on["vr"]:
        del pf["vr_rwop_ok"]
    spec = PreemptSpec(check_unsched=True, check_nodename=True, bits_mask=int(rng.choice([0, 1, 5, 15])),
                       ports=on["ports"], vr=on["vr"], nvl=on["nvl"], dra=on["dra"])
    return state, vic, {k: to(a) for k, a in pf.items()}, spec


def eval_carry(rng, carry, v: int):
    """A drawn TAIL carry from a PROLOGUE carry: each masked slot kept with
    probability 0.7, the release and count as they were, random flags."""
    import torch

    keep = torch.from_numpy(rng.random((carry.mask.shape[0], v)) < 0.7).to(carry.mask.device)
    bits = (keep.to(torch.int64) << torch.arange(v, device=keep.device)).sum(dim=1)
    flags = torch.from_numpy(rng.integers(0, 16, carry.mask.shape[0]).astype("uint8")).to(carry.mask.device)
    return carry._replace(mask=carry.mask & bits, flags=flags)


def eval_cases(errs: dict, dev) -> None:
    """preempt_eval against its plain version on eval_case's inputs (333
    node rows, not a multiple of any block's nodes) in FULL, PROLOGUE and
    TAIL (on the prologue's carry and on a drawn one), at every V of
    EVAL_CASE_V with R = 1 and 4 and 0-3 PDBs, every op family of
    EVAL_CASE_OPS and every kind of EVAL_CASE_KINDS; the lane counts these
    launch must be every one eval_lanes gives (1, 2, 4, 8, 16, 32)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    rng = np.random.default_rng(2001)
    names = ("possible", "crit", "vic_mask", "n_vic", "rel", "relnz")
    seen: dict = {}
    for v in EVAL_CASE_V:
        for i, ops in enumerate(EVAL_CASE_OPS):
            for kind in EVAL_CASE_KINDS:
                r, p = (1, 4)[i % 2], int(rng.integers(0, 4))
                state, vic, pf, spec = eval_case(rng, 333, v, r, p, ops, kind, dev)
                where = f"[eval_cases V={v} R={r} P={p} {ops} {kind}]"
                got, want = kernels.preempt_eval(state, vic, pf, spec), plain.preempt_eval(state, vic, pf, spec)
                for what, a, b in zip(names, got, want):
                    exact(errs, "preempt_eval", f"{where} {what}", a, b)
                kc = kernels.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)
                pc = plain.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)
                for what, a, b in zip(("mask", "rel", "cnt", "flags"), kc, pc):
                    exact(errs, "preempt_eval", f"{where} carry.{what}", a, b)
                for label, carry in (("prologue", pc), ("drawn", eval_carry(rng, pc, v))):
                    kt = kernels.preempt_eval(state, vic, pf, spec, plain.TAIL,
                                              carry._replace(rel=carry.rel.clone()))
                    pt = plain.preempt_eval(state, vic, pf, spec, plain.TAIL, carry)
                    for what, a, b in zip(names, kt, pt):
                        exact(errs, "preempt_eval", f"{where} tail ({label} carry) {what}", a, b)
                torch.cuda.synchronize()
                lanes = kernels.eval_lanes(v)
                entry = seen.setdefault(lanes, {"v": set(), "cases": 0, "possible": 0})
                entry["v"].add(v)
                entry["cases"] += 1
                entry["possible"] += int(want[0].sum())
    every = {kernels.eval_lanes(v) for v in range(1, 65)}
    if set(seen) != every:
        raise AssertionError(f"eval_cases: launched L {sorted(seen)}, eval_lanes gives {sorted(every)}")
    for lanes, e in sorted(seen.items()):
        print(f"preempt_eval [eval_cases L={lanes}]: exact in FULL, PROLOGUE and TAIL on {e['cases']} cases at V "
              f"{sorted(e['v'])}, {e['possible']} possible nodes")


def nf_cases(errs: dict, dev, label: str, state, layouts: bool = False) -> None:
    """node_filters, tiled and pinned, against its plain version on
    programs drawn from the state's own label keys, pairs, integers, names
    and taint ids: every pod carries every op (node selector pairs, ORed
    required terms of every operator with up to 5 values, the profile's
    added affinity, intolerable taints, VolumeBinding and VolumeZone
    groups); VolumeBinding's ngroups at 63, 64, 65, 128, 129 and 130
    (groups at and across the kernel's 64-group mask windows, one to three
    terms a group), a group whose terms are all -1, invalid terms, ngroups
    0 and infeasible pods; pins repeated and on rows past the node count.
    With ``layouts``, on each of label_layouts' states too."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.snapshot import INT_SENTINEL

    rng = np.random.default_rng(1601)
    k, n = NF_CASE_PODS, state.valid.shape[0]
    valid = state.valid.cpu().numpy()
    lk = state.label_key_ids.cpu().numpy()[valid]
    lp = state.label_pair_ids.cpu().numpy()[valid]
    li = state.label_int_vals.cpu().numpy()[valid]
    keys = np.unique(lk[lk >= 0])
    pairs = np.unique(lp[lp >= 0])
    names = state.name_id.cpu().numpy()[valid]
    ints = np.unique(li[(lk >= 0) & (li != INT_SENTINEL)])
    tv = max(int(state.taint_ids.max()) + 1, 4)

    def pick(pool, shape, pad=0.1):
        pool = pool if len(pool) else np.array([-1])
        return np.where(rng.random(shape) < pad, -1, rng.choice(pool, shape)).astype(np.int32)

    def program(prefix, t, q, v, real=1.0):
        op = rng.integers(0, 9, (k, t, q)).astype(np.int32)  # In .. metadata.name NotIn, False
        op = np.where(rng.random((k, t, q)) < 1.0 - real, -1, op).astype(np.int32)
        name_op = (op == 6) | (op == 7)
        vals = np.where(name_op[..., None], pick(names, (k, t, q, v), 0.3), pick(pairs, (k, t, q, v), 0.3))
        return {f"{prefix}_op": op, f"{prefix}_key": pick(keys, (k, t, q)), f"{prefix}_vals": vals,
                f"{prefix}_int": (rng.choice(ints if len(ints) else np.array([0]), (k, t, q))
                                  + rng.integers(-1, 2, (k, t, q))).astype(np.int64),
                f"{prefix}_term_valid": rng.random((k, t)) < 0.85}

    pf = {"valid": np.arange(k) < k - 2, "na_sel_pairs": pick(pairs, (k, 2), 0.7),
          "na_has_required": rng.random(k) < 0.8, "na_has_added": rng.random(k) < 0.5,
          "taint_intol_hard": rng.random((k, tv)) < 0.1}
    pf.update(program("na_req", 3, 2, 5))
    pf.update(program("na_add", 2, 1, 2))
    for prefix, t, q, real in (("vb", NF_CASE_TERMS, 1, 0.03), ("vz", 2, 2, 1.0)):
        pf.update(program(prefix, t, q, 2, real))
        ngroups = (rng.choice(NF_CASE_GROUPS, k) if prefix == "vb" else rng.integers(0, t + 1, k)).astype(np.int32)
        group = np.where(ngroups[:, None] > 0, np.arange(t)[None, :] % np.maximum(ngroups, 1)[:, None], -1)
        group = np.where(rng.random((k, t)) < 0.05, -1, group).astype(np.int32)
        if prefix == "vb":
            group[0] = np.where(group[0] == 1, -1, group[0])  # group 1 has no term
        pf[f"{prefix}_group"], pf[f"{prefix}_ngroups"] = group, ngroups
        pf[f"{prefix}_feasible"] = rng.random(k) < 0.9
    pf = {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for key, v in pf.items()}
    ctx = SimpleNamespace(profile=SimpleNamespace(added_affinity=object()))
    pin = torch.from_numpy(rng.choice(np.concatenate([np.flatnonzero(valid)[:8], [n - 1]]), k)
                           .astype(np.int32)).to(dev)
    pb = plain.node_filters(state, pf, ctx)
    names = []
    for name, st in (label_layouts(state, rng) if layouts else [("", state)]):
        kb, kp = kernels.node_filters(st, pf, ctx), kernels.node_filters(st, pf, ctx, pin)
        pp = plain.node_filters(st, pf, ctx, pin)
        pl = pb if st is state else plain.node_filters(st, pf, ctx)
        torch.cuda.synchronize()
        exact(errs, "node_filters", f"[{label} cases{name and ', ' + name}]", kb, pl)
        exact(errs, "node_filters", f"[{label} cases{name and ', ' + name}, pinned]", kp, pp)
        exact(errs, "node_filters", f"[{label} cases{name and ', ' + name}, plain]", pl, pb)
        names.append(name)
    on = pb[:, torch.from_numpy(valid).to(dev)]
    print(f"node_filters [{label} cases]: exact, tiled and pinned{' at ' + '; '.join(names) if layouts else ''}; "
          f"K={k}, VolumeBinding ngroups {sorted(set(pf['vb_ngroups'].tolist()))}; pairs passing bits 0-3: "
          f"{[int(((on >> b) & 1).sum()) for b in range(4)]} of {on.numel()}")


def timed(kernel_fn, plain_fn, reps: int, setup=None, plain_reps: int | None = None) -> dict:
    """Medians of ``reps`` calls of the kernel and of ``plain_reps``
    (default the smaller of ``reps`` and PLAIN_REPS) of its plain
    version."""
    ms, call_ms = median_ms(kernel_fn, reps, setup)
    plain_ms, plain_call_ms = median_ms(plain_fn, plain_reps or min(reps, PLAIN_REPS), setup)
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
    # select_host on the slice-crossing cases, 64 pods a launch.
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    crng = np.random.default_rng(1357)
    cases = select_cases(state.valid.shape[0], int(state.valid.sum()), seed_mul, crng)
    stacked_select_cases(errs, "density", dev, cases, 64, seed_mul, crng)
    print(f"select_host [density]: exact; {len(cases)} slice-crossing cases, 64 pods a launch")
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


def launch_floor(reps: int) -> dict:
    """The launch floor: an empty kernel (torch's spin kernel asked for 0
    cycles) timed as the kernels are (median_ms)."""
    import torch

    ms, call_ms = median_ms(lambda _: torch.cuda._sleep(0), reps)
    return dict(ms=ms, call_ms=call_ms)


def check_c1_kernels(dev, reps: int) -> dict:
    """The chunk-1 paths' shapes ("c1"): eval_chunk for one pod of the
    density chunk against N=8192 rows without a nominated overlay (as the
    parity path's steps), select_host in row mode on its result, and
    resolve_commit's strict commit of that pod at its pick, each against
    its plain version, exactly, and timed; then select_host on the
    slice-crossing cases (select_cases), one pod a launch."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    builder, pf, _nom, steps, _rng = kernel_inputs(1234, dev)
    state, schema = builder.state(), builder.schema
    ported = {"NodeUnschedulable", "NodeName", "NodeResourcesFit", "NodeResourcesBalancedAllocation"}
    active = frozenset(ported & (set(DEFAULT_PROFILE.filters) | {s for s, _ in DEFAULT_PROFILE.scorers}))
    spec = eval_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    pf1 = _chunk(pf, 0, 1)
    errs: dict[str, float] = {}
    kf, kt, km = kernels.eval_chunk(state, pf1, spec, None)
    pfe, pt, pm = plain.eval_chunk(state, pf1, spec, None)
    torch.cuda.synchronize()
    for what, a, b in (("feasible", kf, pfe), ("total", kt, pt), ("fail_mask", km, pm)):
        exact(errs, "eval_chunk", f"[c1] {what}", a, b)
    picks = plain.select_host(pfe, pt, steps[:1], 0, None)[0]
    et_slot0 = torch.zeros(schema.ET, dtype=torch.int32, device=dev)
    dom0 = build_dom(state, et_slot0, torch.zeros(schema.ET, dtype=torch.bool, device=dev), schema.DV)
    sk, dk = state.clone(), clone_dom(dom0)
    sp, dp = state.clone(), clone_dom(dom0)
    ok_ = kernels.resolve_commit(sk, dk, pf1, picks, None, True)
    op_ = plain.resolve_commit(sp, dp, pf1, picks, None, True)
    torch.cuda.synchronize()
    exact(errs, "resolve_commit", "[c1] picks", ok_, op_)
    exact(errs, "resolve_commit", "[c1] group_dom", dk.group_dom, dp.group_dom)
    for f in ("req", "nonzero_req", "num_pods", "group_counts"):
        exact(errs, "resolve_commit", f"[c1] state.{f}", getattr(sk, f), getattr(sp, f))
    print(f"eval_chunk/resolve_commit [c1]: exact; {int(pfe.sum())} feasible nodes, pick {int(op_[0])}")
    # select_host in row mode on that pod's evaluation, then the cases that
    # cross the node-axis slices, one pod a launch.
    ks = kernels.select_host(kf, kt, steps[:1], 0, None)
    torch.cuda.synchronize()
    for what, a, b in zip(("pick", "best", "feasible_count"), ks, plain.select_host(pfe, pt, steps[:1], 0, None)):
        exact(errs, "select_host", f"[c1] {what}", a, b)
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    cases = select_cases(state.valid.shape[0], int(state.valid.sum()), seed_mul, _rng)
    for name, feas, total, step in cases:
        select_case(errs, f"c1, {name}", dev, feas[None], total[None], [step], seed_mul, None)
    print(f"select_host [c1]: exact; {len(cases)} slice-crossing cases")
    clones = lambda: (state.clone(), clone_dom(dom0))  # noqa: E731
    result = {
        "eval_chunk": timed(lambda _: kernels.eval_chunk(state, pf1, spec, None),
                            lambda _: plain.eval_chunk(state, pf1, spec, None), reps),
        "select_host": timed(lambda _: kernels.select_host(kf, kt, steps[:1], 0, None),
                             lambda _: plain.select_host(pfe, pt, steps[:1], 0, None), reps),
        "resolve_commit": timed(lambda a: kernels.resolve_commit(a[0], a[1], pf1, picks, None, True),
                                lambda a: plain.resolve_commit(a[0], a[1], pf1, picks, None, True), reps, clones),
    }
    set_bound(result["eval_chunk"], eval_bytes(state, pf1, None))
    set_bound(result["select_host"], select_bytes(1, state.valid.shape[0]))
    set_bound(result["resolve_commit"], commit_bytes(schema, picks, 1, pairs=False))
    result["build_dom"] = dom_at(errs, "c1", builder, state, reps)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    return result


# The cluster sizes K whose node-axis slices (ceil(N / K) rows rounded up
# to 32 a CTA: select_host.cu, ipa_eval.cu) the kernel cases cross.
SPLITS = (2, 4, 8, 16)


def slice_starts(n: int) -> list[int]:
    """The first rows of the node-axis slices of every cluster size in
    SPLITS, ascending, without row 0."""
    out = set()
    for k in SPLITS:
        size = -(-(-(-n // k)) // 32) * 32
        out.update(range(size, n, size))
    return sorted(out)


def tie_step(seed_mul: int, m: int, k: int) -> int:
    """A tie-break step whose hashed draw picks the (k+1)-th of m ties
    (pass_.py _hash_u32, in uint32)."""
    import numpy as np

    if m <= 1:
        return 0
    x = (np.arange(1 << 20, dtype=np.uint64) + seed_mul) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    x = ((x ^ (x >> 15)) * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return int(np.nonzero(x % m == k)[0][0])


def select_cases(n: int, nvalid: int, seed_mul: int, rng) -> list:
    """select_host inputs that cross the node-axis slices, as (name,
    feasible (N,) bool, total (N,) i64, step) numpy cases: ties straddling
    every slice start of every split with kth at a slice's first and last
    tie, the only feasible row in the last slice (the last row, the last
    node row, a slice's first row), ties only below ``nvalid`` (padding
    above), every row tied, none feasible, and totals at ±2^62."""
    import numpy as np

    cases = []

    def add(name, feas, total, k=None):
        m = int((feas & (total == total[feas].max())).sum()) if feas.any() else 0
        k = int(rng.integers(max(m, 1))) if k is None else k
        cases.append((name, feas, total.astype(np.int64), tie_step(seed_mul, m, k)))

    starts = slice_starts(n)
    ties = sorted({r for b in starts for r in (b - 1, b)})
    feas = rng.random(n) < 0.125
    feas[ties] = True
    total = rng.integers(0, 7, n)
    total[ties] = 7
    ranks = {0, len(ties) - 1}
    for i, r in enumerate(ties):
        if r in starts:
            ranks |= {i - 1, i}
    for k in sorted(ranks):
        add(f"ties straddling the slices, kth {k}", feas, total, k)
    for row in sorted({n - 1, nvalid - 1, starts[-1], starts[0]}):
        one = np.zeros(n, bool)
        one[row] = True
        add(f"only row {row} feasible", one, rng.integers(-5, 5, n))
    pad = (rng.random(n) < 0.4) & (np.arange(n) < nvalid)
    few = rng.integers(0, 3, n)
    m = int((pad & (few == few[pad].max())).sum())
    for k in (0, m - 1, None):
        add(f"ties below row {nvalid}", pad, few, k)
    for k in (0, n - 1, None):
        add("every row tied", np.ones(n, bool), np.full(n, 5), k)
    add("none feasible", np.zeros(n, bool), rng.integers(0, 9, n))
    big = 2**62
    add("totals at ±2^62", rng.random(n) < 0.5, rng.choice(np.array([big - 1, big - 2, -big, -big + 1]), n))
    add("every feasible total -2^62", rng.random(n) < 0.3, np.full(n, -big))
    return cases


def select_case(errs: dict, label: str, dev, feas, total, steps, seed_mul: int, nominated, pos=None) -> None:
    """select_host on (C, N) numpy inputs against its plain version,
    exactly; ``nominated`` a (C,) int32 array or None."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f, t = to(feas), to(total.astype(np.int64))
    st = to(np.asarray(steps, np.int64))
    nom = None if nominated is None else to(np.asarray(nominated, np.int32))
    ks = kernels.select_host(f, t, st, seed_mul, nom, pos)
    ps = plain.select_host(f, t, st, seed_mul, nom, pos)
    torch.cuda.synchronize()
    for what, a, b in zip(("pick", "best", "feasible_count"), ks, ps):
        exact(errs, "select_host", f"[{label}] {what}", a, b)


def stacked_select_cases(errs: dict, label: str, dev, cases, c: int, seed_mul: int, rng) -> None:
    """The cases as the rows of (C, N) launches, each pod its own case and
    step; one pod in four nominates a row, feasible or not."""
    import numpy as np

    for lo in range(0, len(cases), c):
        part = [cases[(lo + i) % len(cases)] for i in range(c)]
        feas = np.stack([p[1] for p in part])
        total = np.stack([p[2] for p in part])
        nom = np.full(c, -1, np.int32)
        for i in range(0, c, 4):
            rows = np.nonzero(feas[i])[0] if i % 8 == 0 else np.nonzero(~feas[i])[0]
            if rows.size:
                nom[i] = rows[int(rng.integers(rows.size))]
        select_case(errs, f"{label}, cases {lo}-{lo + c - 1}", dev, feas, total, [p[3] for p in part], seed_mul,
                    nom)


# Allocatable values of the division cases: multiples and neighbours of
# 100, 1, and both sides of 2^53 for the numerator ((al - rq) * 100 or
# rq * 100) and for the divisor al itself; 0 skips the column's weight.
DIVISION_ALLOCS = (0, 1, 2, 3, 7, 50, 99, 100, 101, 1000, 2**53 // 100, 2**53 // 100 + 1, 2**53 - 1, 2**53,
                   2**53 + 1, 2**56 - 3)


def division_inputs(dev, c: int):
    """The density cluster with its first rows rewritten so that, for the
    chunk's pods, the fit scores' numerators land on multiples of the
    allocatable, one either side of them, at rq = al and rq > al, and on
    both sides of the 2^53 switch of floordiv_f64, in every requested
    column; the pods' requests are 0-3 and 99, and their non-zero requests
    the same (so NonZeroRequested reads them too)."""
    import numpy as np
    import torch

    builder, pf, nom, steps, rng = kernel_inputs(1234, dev)
    state = builder.state().clone()
    r = builder.schema.R
    rows = []
    for al in DIVISION_ALLOCS:
        for base in sorted({max(al - 3, 0), max(al - 2, 0), max(al - 1, 0), al, al + 1, 0}):
            rows.append((al, base))
    k = len(rows)
    alloc, req = state.alloc.cpu().numpy(), state.req.cpu().numpy()
    for i, (al, base) in enumerate(rows):
        for col in range(r):  # each column a different (al, base) of the list
            al_c, base_c = rows[(i * (2 * col + 1) + 5 * col) % k]
            alloc[i, col], req[i, col] = al_c, base_c
    state.alloc.copy_(torch.from_numpy(alloc))
    state.req.copy_(torch.from_numpy(req))
    state.nonzero_req[:k] = state.req[:k, :2]
    state.valid[:k] = True
    state.unschedulable[:k] = False
    state.num_pods[:k] = 0
    state.allowed_pods[:k] = 1000
    parts = np.resize(np.array([0, 1, 2, 3, 99, 1, 0, 2], np.int64), c)
    pf = _chunk(pf, 0, c)
    preq = np.zeros((c, r), np.int64)
    for col in range(r):
        preq[:, col] = np.roll(parts, col)
    pf["req"] = torch.from_numpy(preq).to(dev)
    pf["nonzero"] = pf["req"][:, :2].contiguous()
    nom = tuple(t.clone() for t in nom)
    return builder, state, pf, nom, k


EXACT_CASES = ("division", "branches", "crowd", "spread", "pick")


def check_exact_cases(dev, parts=EXACT_CASES) -> dict:
    """Exactness cases of eval_chunk and resolve_commit against their plain
    versions (max_abs_err 0), untimed: "division", the division boundaries
    under LeastAllocated and MostAllocated, with and without the nominated
    overlay; "branches", every optional branch of the commit (own terms,
    devices with rw, CSI with and without vol_csi_lim, ports, claims with
    first slots and fresh counts) under a sparse and a dense conflict
    table; "crowd", the cumulative fit with C=33 and C=1024 pods crowding
    one nearly full row; the commit cases strict and not; "spread",
    spread_filter, late_scores and late_scores/cols on the cases that
    cross a thread block cluster's node slices (spread_cases); "pick",
    preempt_pick in every mode and cluster size pick_split chooses
    (pick_cases)."""
    errs: dict[str, float] = {}
    if "division" in parts:
        division_case(dev, errs)
    if "branches" in parts or "crowd" in parts:
        commit_cases(dev, errs, parts)
    if "spread" in parts:
        spread_cases(dev, errs)
    if "pick" in parts:
        pick_cases(errs, dev)
    return {name: {"max_abs_err": err} for name, err in errs.items()}


def division_case(dev, errs: dict) -> None:
    """eval_chunk on division_inputs, both strategies, with and without
    the nominated overlay, at C=8 (one thread a pair) and C=64 (the node
    tile)."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import eval_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE, MOST_ALLOCATED, ScoringStrategy
    from kubernetes_tpu_torch.kernels import plain

    most = dataclasses.replace(DEFAULT_PROFILE, scoring_strategy=ScoringStrategy(
        type=MOST_ALLOCATED, resources=(("cpu", 1), ("memory", 2), ("example.com/gpu", 3))))
    ported = {"NodeUnschedulable", "NodeName", "NodeResourcesFit", "NodeResourcesBalancedAllocation"}
    for c in (8, 64):
        builder, state, pf, nom, k = division_inputs(dev, c)
        scored = 0
        for label, prof in (("least", DEFAULT_PROFILE), ("most", most)):
            active = frozenset(ported & (set(prof.filters) | {s for s, _ in prof.scorers}))
            spec = eval_spec(prof, builder.schema, builder.res_col, active)
            for nom_in in (nom, None):
                got = kernels.eval_chunk(state, pf, spec, nom_in)
                want = plain.eval_chunk(state, pf, spec, nom_in)
                torch.cuda.synchronize()
                for what, a, b in zip(("feasible", "total", "fail_mask"), got, want):
                    exact(errs, "eval_chunk", f"[division C={c}, {label}] {what}", a, b)
                scored += int(want[0][:, :k].sum())
        print(f"eval_chunk [division C={c}]: exact; {k} rewritten rows, {scored} scored (pod, row) pairs on them")


def commit_cases(dev, errs: dict, parts) -> None:
    """resolve_commit's "branches" and "crowd" cases (check_exact_cases)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import build_dom
    from kubernetes_tpu_torch.kernels import plain

    rng = np.random.default_rng(77)
    builder, pf64, _nom, _steps, _ = kernel_inputs(1234, dev)
    base = builder.state()
    schema, n, r = builder.schema, base.valid.shape[0], builder.schema.R
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    et, dv, tk = 64, schema.DV, schema.TK
    sizes = dict(dev_counts=16, dev_rw_counts=16, csivol_counts=32, csi_used=4, port_counts=8, portkey_counts=4,
                 dra_claim_counts=32, dra_alloc=4, et_counts=et)
    state = dataclasses.replace(base.clone(), **{
        f: to(rng.integers(0, 2, size=(rows, n)).astype(np.int32) * rng.integers(0, 3, size=(rows, n)).astype(np.int32))
        for f, rows in sizes.items()})
    et_slot = to(rng.integers(0, tk, size=et).astype(np.int32))
    dom0 = build_dom(state, et_slot, torch.zeros(et, dtype=torch.bool, device=dev), dv)
    hot = rng.choice(np.nonzero(base.valid.cpu().numpy())[0], 6, replace=False)

    def branch_pf(c: int):
        """c pods with every optional commit feature; picks on six rows."""
        p = {key: v[:c] if c <= 64 else v.repeat((c + 63) // 64, *([1] * (v.dim() - 1)))[:c].contiguous()
             for key, v in pf64.items() if key in ("valid", "req", "nonzero", "group")}
        p.update(
            ipa_own_terms=to(rng.integers(-1, et, size=(c, 3)).astype(np.int32)),
            vol_dev_ids=to(rng.integers(-1, 16, size=(c, 2)).astype(np.int32)),
            vol_dev_rw=to(rng.random((c, 2)) < 0.5),
            vol_csi_ids=to(rng.integers(-1, 32, size=(c, 3)).astype(np.int32)),
            vol_csi_drv=to(rng.integers(-1, 5, size=(c, 3)).astype(np.int32)),
            vol_csi_lim=to(rng.random(c) < 0.3),
            port_triples=to(rng.integers(-1, 8, size=(c, 2)).astype(np.int32)),
            port_keys=to(rng.integers(-1, 4, size=(c, 2)).astype(np.int32)),
            dra_claim_ids=to(rng.integers(-1, 32, size=(c, 3)).astype(np.int32)),
            dra_claim_cls=to(rng.integers(-1, 5, size=(c, 3)).astype(np.int32)),
            dra_claim_cnt=to(rng.integers(1, 4, size=(c, 3)).astype(np.int32)),
            dra_claim_first=to(rng.random((c, 3)) < 0.7),
        )
        return p

    def commit_case(label: str, st, p: dict, picks, pairs, strict: bool) -> tuple[int, int]:
        sk, dk = st.clone(), clone_dom(dom0)
        sp, dp = st.clone(), clone_dom(dom0)
        got = kernels.resolve_commit(sk, dk, p, picks, pairs, strict)
        want = plain.resolve_commit(sp, dp, p, picks, pairs, strict)
        torch.cuda.synchronize()
        exact(errs, "resolve_commit", f"[{label}, strict={strict}] picks", got, want)
        exact(errs, "resolve_commit", f"[{label}] group_dom", dk.group_dom, dp.group_dom)
        exact(errs, "resolve_commit", f"[{label}] et_dom", dk.et_dom, dp.et_dom)
        for f in dataclasses.fields(sk):
            exact(errs, "resolve_commit", f"[{label}] state.{f.name}", getattr(sk, f.name), getattr(sp, f.name))
        return int((want == -2).sum()), int((want >= 0).sum())

    # Every optional branch, and a dense conflict table, at C=64.
    p = branch_pf(64)
    picks = to(rng.choice(hot, 64).astype(np.int32))
    picks[::11] = -1
    for density in (0.02, 0.5) if "branches" in parts else ():
        pairs = to(rng.random((64, 64)) < density)
        for strict in (False, True):
            d, m = commit_case(f"branches, pairs {density}", state, p, picks, None if strict else pairs, strict)
            print(f"resolve_commit [branches, pairs {density}, strict={strict}]: exact; {d} deferred, {m} committed")
    # C=33 and C=1024 pods crowding one nearly full row (room for a few by
    # cpu and by pod count), a few elsewhere, some invalid.
    row = int(hot[0])
    st = state.clone()
    st.alloc[row, 0] = 64000
    st.req[row, 0] = 64000 - 9000
    st.num_pods[row] = 100
    st.allowed_pods[row] = 120
    # The same at C=33 with two more resource columns (R > 4: the cumulative
    # fit stages its columns four at a time), the last one tight on the row.
    wide = dataclasses.replace(st.clone(), alloc=torch.cat([st.alloc, st.alloc[:, :2] * 0 + 10**9], 1),
                               req=torch.cat([st.req, st.req[:, :2] * 0], 1))
    wide.alloc[row, r + 1] = 1600
    for c, st_c in ((33, st), (1024, st), (33, wide)) if "crowd" in parts else ():
        p = branch_pf(c)
        cpu = rng.choice([0, 500, 1000, 3000], size=c)
        req = p["req"].clone()
        req[:, 0] = to(cpu)
        if st_c is wide:
            extra = to(rng.choice([0, 700, 1500], size=(c, 2)))
            req = torch.cat([req, extra], 1).contiguous()
        p["req"] = req
        valid = p["valid"].clone()
        valid[::17] = False
        p["valid"] = valid
        pk = np.full(c, row, np.int32)
        pk[::13] = rng.choice(hot, len(pk[::13]))
        pk[::29] = -1
        pairs = to(rng.random((c, c)) < 0.01)
        label = f"crowd C={c}" + (f", R={r + 2}" if st_c is wide else "")
        for strict in (False, True):
            d, m = commit_case(label, st_c, p, to(pk), None if strict else pairs, strict)
            print(f"resolve_commit [{label}, strict={strict}]: exact; {d} deferred, {m} committed")


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

    builder, cache, rng = ipa_cluster(seed, dev)
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
    return dict(builder=builder, cache=cache, state=state, dom=dom, pf=pf, big_pf=big_pf, spec=spec,
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
    return builder, cache, rng


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
    builder, cache, rng = spread_cluster(shape, seed, dev)
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
    out = {"builder": builder, "cache": cache, "state": builder.state(), "rng": rng, "big_active": big_active,
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


# The slice-crossing spread cases (spread_cases): 5000 nodes, N=8192, so a
# chunk-1 launch splits a pod over K=16 CTAs of 512 rows each.
SLICE_NODES = 5000
SLICE_ROWS = 512
LONE_RACK = (3 * SLICE_ROWS, 4 * SLICE_ROWS)  # rack "lone": one slice's rows at every K
NINE_ROW = 5  # the node holding the nine "nine" pods


def spread_slice_inputs(dev):
    """The cluster of spread_cases: SLICE_NODES nodes in four zones, the
    nodes on either side of every multiple of 512 without the zone key, rack
    "lone" on LONE_RACK's rows and racks r0-r2 elsewhere, disk labels,
    PreferNoSchedule taints, NoSchedule taints (on the last node too);
    3000 bound pods of four apps, one "every" pod on each node but the
    last, nine "nine" pods on node 5.  Pods: 12 seeded ones with zone,
    hostname and rack constraints of both kinds, preferred terms and
    tolerations; "rack" (a rack domain on one slice), "every" (a hostname
    minimum of 0 on the last node), "every-honor" (the same with the last
    node's taint honoured: minimum 1), "mindom" (minDomains 6 over four
    zones) and "nine" (hostname ScheduleAnyway over the nine pods).
    Returns (state, the pods' batch on the device, the active ops, the
    pods' names, the builder)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    apps = ["web", "db", "cache", "queue"]
    rng = np.random.default_rng(19)
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    last = SLICE_NODES - 1
    for i in range(SLICE_NODES):
        w = make_node(f"s{i}").capacity({"cpu": "64", "memory": "64Gi", "pods": 200})
        if i % SLICE_ROWS not in (0, SLICE_ROWS - 1):
            w = w.zone(f"z{i % 4}")
        w = w.label("rack", "lone" if LONE_RACK[0] <= i < LONE_RACK[1] else f"r{i % 3}")
        if i % 3:
            w = w.label("disk", "ssd" if i % 3 == 1 else "hdd")
        if i % 5 == 2:
            w = w.taint("soft", "x", t.EFFECT_PREFER_NO_SCHEDULE)
        if i % 11 == 4 or i == last:
            w = w.taint("dedicated", "gpu", t.EFFECT_NO_SCHEDULE)
        cache.add_node(w.obj())
    for j in range(3000):
        cache.add_pod(make_pod(f"b{j}").req({"cpu": "10m"}).label("app", apps[int(rng.integers(4))])
                      .node(f"s{int(rng.integers(SLICE_NODES))}").obj())
    for i in range(last):
        cache.add_pod(make_pod(f"e{i}").req({"cpu": "10m"}).label("app", "every").node(f"s{i}").obj())
    for j in range(9):
        cache.add_pod(make_pod(f"nine{j}").req({"cpu": "10m"}).label("app", "nine").node(f"s{NINE_ROW}").obj())
    pods = []
    for k in range(12):
        w = make_pod(f"p{k}").req({"cpu": "10m"}).label("app", apps[k % 4])
        for _ in range(int(rng.integers(1, 4))):
            w = w.spread_constraint(
                int(rng.integers(1, 3)), [ZONE, HOST, "rack"][int(rng.integers(3))],
                t.DO_NOT_SCHEDULE if rng.integers(2) else t.SCHEDULE_ANYWAY, "app", [apps[int(rng.integers(4))]],
                node_affinity_policy=t.POLICY_HONOR if rng.integers(2) else t.POLICY_IGNORE,
                node_taints_policy=t.POLICY_HONOR if rng.integers(2) else t.POLICY_IGNORE)
        if rng.random() < 0.7:
            w = w.preferred_node_affinity_in("disk", ["ssd"], weight=int(rng.integers(1, 100)))
        if rng.random() < 0.5:
            w = w.preferred_node_affinity_in("rack", ["lone", "r1"], weight=int(rng.integers(1, 100)))
        if rng.random() < 0.5:
            w = w.toleration(key="soft", op=t.TOLERATION_OP_EXISTS, effect=t.EFFECT_PREFER_NO_SCHEDULE)
        pods.append(w.obj())
    pods.append(make_pod("rack").label("app", "web").spread_constraint(1, "rack", t.DO_NOT_SCHEDULE, "app", ["web"])
                .spread_constraint(1, "rack", t.SCHEDULE_ANYWAY, "app", ["web"]).obj())
    pods.append(make_pod("every").label("app", "every")
                .spread_constraint(1, HOST, t.DO_NOT_SCHEDULE, "app", ["every"])
                .spread_constraint(2, HOST, t.SCHEDULE_ANYWAY, "app", ["every"]).obj())
    pods.append(make_pod("every-honor").label("app", "every").spread_constraint(
        1, HOST, t.DO_NOT_SCHEDULE, "app", ["every"], node_taints_policy=t.POLICY_HONOR).obj())
    pods.append(make_pod("mindom").label("app", "db").spread_constraint(
        1, ZONE, t.DO_NOT_SCHEDULE, "app", ["db"], min_domains=6)
        .spread_constraint(1, ZONE, t.SCHEDULE_ANYWAY, "app", ["db"]).obj())
    pods.append(make_pod("nine").label("app", "nine").spread_constraint(1, HOST, t.SCHEDULE_ANYWAY, "app", ["nine"])
                .obj())
    for _round in range(2):  # the second under the final vocabularies
        batch, _, active = build_pod_batch(pods, builder, DEFAULT_PROFILE, len(pods))
    pf = {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for key, v in batch.items()}
    state = builder.state()
    names = state.name_id.cpu().numpy()
    if not all(names[i] == builder.interns.node_names.get(f"s{i}") for i in (0, NINE_ROW, last)):
        raise AssertionError("spread_slice_inputs: node i is not on row i")
    return state, pf, active, [p.metadata.name for p in pods], builder


def spread_cases(dev, errs: dict) -> None:
    """spread_filter, late_scores and late_scores/cols against their plain
    versions, exactly, on spread_slice_inputs: each pod alone (C=1: K=16
    slices of 512 rows) and all in one launch, also with one CTA a pod
    (K=1 forced: the plain launch's scheme), the filter on the cluster
    and the scores over the spread filter's feasible set, a random one,
    one slice's rows only (every other slice without a scored node), the
    rows missing the zone key (no scored node for a zone constraint), one
    node (max = min), none, and 17 nodes across the slices (the 9·log(19)
    rounding boundary: node 5's raw spread score must be 26).  Also
    checks what the cases claim: only the last node passes "every"'s
    filter (its hostname minimum, 0, lies in the last slice that holds
    nodes), every node passes "every-honor"'s, none passes "mindom"'s."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import eval_spec, late_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.ops import podtopologyspread as spread_op

    state, pf, active, names, builder = spread_slice_inputs(dev)
    schema = builder.schema
    spec = eval_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    late = late_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    if not (late.na_weight and late.taint_weight and late.spread_weight):
        raise AssertionError(f"spread cases: scores not all active {late}")
    bits = plain.node_filters(state, pf, spec.ctx)
    n, c_all = state.valid.shape[0], len(names)
    k1 = spread_ctas(state, _chunk(pf, 0, 1), 1, schema)
    if n != 8192 or k1 != {"tps_h": 16, "tps_s": 16}:
        raise AssertionError(f"spread cases: N={n}, CTAs a pod {k1}, want 8192 rows and 16")
    rng = np.random.default_rng(23)
    valid = state.valid.cpu().numpy()
    rows = np.arange(n)
    seventeen = np.zeros(n, bool)
    seventeen[[NINE_ROW] + [int(r) for r in np.linspace(600, SLICE_NODES - 1, 16)]] = True
    sets = {
        "one slice only": (rows >= 5 * SLICE_ROWS) & (rows < 6 * SLICE_ROWS),
        "no key (no scored node)": np.isin(rows % SLICE_ROWS, (0, SLICE_ROWS - 1)),
        "one node (max = min)": rows == int(rng.integers(SLICE_NODES)),
        "none": np.zeros(n, bool),
        "seventeen nodes": seventeen,
    }
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    launches = [(f"pod {names[i]}", i, 1, False) for i in range(c_all)] + [("all pods", 0, c_all, False),
                                                                           ("all pods, K=1", 0, c_all, True)]
    split = kernels.cluster_split
    for label, i, c, one_cta in launches:
        kernels.cluster_split = (lambda *_a, **_kw: 1) if one_cta else split
        try:
            p, b = _chunk(pf, i, c), bits[i:i + c].contiguous()
            ks = kernels.spread_filter(state, p, b, spec.ctx)
            ps = plain.spread_filter(state, p, b, spec.ctx)
            torch.cuda.synchronize()
            exact(errs, "spread_filter", f"[spread cases, {label}]", ks, ps)
            feas_sets = {"the spread filter's": ps & state.valid[None],
                         "random": to((rng.random((c, n)) < 0.6) & valid[None]),
                         **{what: to(np.broadcast_to(r & valid, (c, n)).copy()) for what, r in sets.items()}}
            for what, feas in feas_sets.items():
                base = torch.where(feas, 7, 0).to(torch.int64)
                kt = kernels.late_scores(state, p, feas, base.clone(), b, late)
                pt = plain.late_scores(state, p, feas, base.clone(), b, late)
                tk, tp = base.clone(), base.clone()
                kc = kernels.late_scores_cols(state, p, feas, tk, b, late)
                pc = plain.late_scores_cols(state, p, feas, tp, b, late)
                torch.cuda.synchronize()
                exact(errs, "late_scores", f"[spread cases, {label}, {what}]", kt, pt)
                exact(errs, "late_scores/cols", f"[spread cases, {label}, {what}] cols", kc, pc)
                exact(errs, "late_scores/cols", f"[spread cases, {label}, {what}] total", tk, tp)
        finally:
            kernels.cluster_split = split
    ok = plain.spread_filter(state, pf, bits, spec.ctx)[:, :SLICE_NODES].cpu().numpy()
    if not ((ok[names.index("every")] == (np.arange(SLICE_NODES) == SLICE_NODES - 1)).all()
            and ok[names.index("every-honor")].all() and not ok[names.index("mindom")].any()):
        raise AssertionError("spread cases: the hostname-minimum or minDomains case is not what it says")
    nine = names.index("nine")
    p = _chunk(pf, nine, 1)
    _scored, raw = spread_op.raw_score(state, p, spec.ctx, to(seventeen[None]), (bits[nine:nine + 1] & 1) != 0,
                                       (bits[nine:nine + 1] & 2) != 0)
    if int(raw[0, NINE_ROW]) != 26:
        raise AssertionError(f"spread cases: raw score {int(raw[0, NINE_ROW])} at the rounding boundary, want 26")
    print(f"spread cases: exact; {c_all} pods one a launch (CTAs a pod {k1}) and all in one launch "
          f"({spread_ctas(state, pf, c_all, schema)}, then 1), {len(sets) + 2} feasible sets each; "
          f"9·log(19) rounds to 26")


def _chunk(pf: dict, i: int, c: int) -> dict:
    return {k: v[i * c:(i + 1) * c].contiguous() for k, v in pf.items()}


def check_spread_kernels(dev, shape: str, reps: int, c1: dict | None = None) -> dict:
    """Phase 3, one spread shape (spread_na: C=8, N=1024; inclusion: C=8,
    N=8192): node_filters, spread_filter, eval_chunk with their planes,
    late_scores, select_host, resolve_commit and conflict_pairs against
    their plain versions, exactly, on the 32 mixed pods (four chunks of 8,
    default profile and addedAffinity, the final feasible set and a random
    one) and on the workload's pods; returns each one's timings (on the
    workload's first chunk, and node_filters and conflict_pairs on its
    4096-pod batch), bound and largest error.  With ``c1``, fills
    c1["spread_c1"] from the same inputs (check_spread_c1_kernels)."""
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
    nf_cases(errs, dev, shape, state)
    result["node_filters"] = timed(lambda _: kernels.node_filters(state, big, ctx),
                                   lambda _: plain.node_filters(state, big, ctx), reps)
    result["conflict_pairs"] = timed(lambda _: kernels.conflict_pairs(big, 512, c),
                                     lambda _: plain.conflict_pairs(big, 512, c), reps)
    result["build_dom"] = dom_at(errs, shape, builder, state, reps)
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
          f"{int(pe0[0].sum())} feasible (pod, node) pairs, spread rejects {int((state.valid & ~ps0).sum())}, "
          f"CTAs a pod {spread_ctas(state, pf0, c, schema)}")
    if c1 is not None:
        c1["spread_c1"] = check_spread_c1_kernels(dev, x, reps)
    return result


def spread_ctas(state, pf: dict, c: int, schema) -> dict:
    """The thread block cluster size K a pod of spread_filter and of
    late_scores at this chunk (kernels.spread_split; None in a tree of the
    port without it, as --kernels-of may give)."""
    from kubernetes_tpu_torch import kernels

    if not hasattr(kernels, "spread_split"):
        return None
    n, sms = state.valid.shape[0], kernels._sms(state.valid.device)
    return {prefix: kernels.spread_split(c, n, pf[f"{prefix}_valid"].shape[1], schema.DV, sms)[0]
            for prefix in ("tps_h", "tps_s")}


def check_spread_c1_kernels(dev, x: dict, reps: int) -> dict:
    """The "spread_c1" shape: the chunk-1 paths' launches of spread_filter,
    late_scores and late_scores/cols (the explain phase, the search path:
    C=1 over N=8192) on the inclusion shape's cluster (5000 nodes in 10
    zones, spread_inputs ``x``), one pod a launch: each against its plain
    version, exactly, on eval_chunk's feasible set for the workload's
    first 16 pods and for the 32 mixed pods under both profiles; timed on
    the workload's first pod (and late_scores on a mixed pod with zone and
    hostname ScheduleAnyway constraints, printed)."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import eval_spec, late_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    builder, state = x["builder"], x["state"]
    schema, res_col = builder.schema, builder.res_col
    n = state.valid.shape[0]
    errs: dict[str, float] = {}

    def one(label, prof, pf, active, bits):
        spec = eval_spec(prof, schema, res_col, active)
        late = late_spec(prof, schema, res_col, active)
        ks = kernels.spread_filter(state, pf, bits, spec.ctx)
        ps = plain.spread_filter(state, pf, bits, spec.ctx)
        torch.cuda.synchronize()
        exact(errs, "spread_filter", f"[spread_c1, {label}]", ks, ps)
        pe = plain.eval_chunk(state, pf, spec, None, (bits, ps))
        kt = kernels.late_scores(state, pf, pe[0], pe[1].clone(), bits, late)
        pt = plain.late_scores(state, pf, pe[0], pe[1].clone(), bits, late)
        tk, tp = pe[1].clone(), pe[1].clone()
        kc = kernels.late_scores_cols(state, pf, pe[0], tk, bits, late)
        pc = plain.late_scores_cols(state, pf, pe[0], tp, bits, late)
        torch.cuda.synchronize()
        exact(errs, "late_scores", f"[spread_c1, {label}]", kt, pt)
        exact(errs, "late_scores/cols", f"[spread_c1, {label}] cols", kc, pc)
        exact(errs, "late_scores/cols", f"[spread_c1, {label}] total", tk, tp)
        return late, pe

    big, active = x["big_pf"], x["big_active"]
    ctx = eval_spec(DEFAULT_PROFILE, schema, res_col, active).ctx
    bits = plain.node_filters(state, _chunk(big, 0, 16), ctx)
    runs = [one(f"workload pod {i}", DEFAULT_PROFILE, _chunk(big, i, 1), active, bits[i:i + 1].contiguous())
            for i in range(16)]
    for label, (prof, pf, act) in x["mixed"].items():
        b = plain.node_filters(state, pf, eval_spec(prof, schema, res_col, act).ctx)
        for i in range(32):
            got = one(f"{label} pod {i}", prof, _chunk(pf, i, 1), act, b[i:i + 1].contiguous())
            if label == "default" and i == 1:  # zone and hostname ScheduleAnyway, preferred terms
                soft = (_chunk(pf, 1, 1), b[1:2].contiguous(), *got)
    late, pe = runs[0]
    pf0, bits0 = _chunk(big, 0, 1), bits[:1].contiguous()
    spec0 = eval_spec(DEFAULT_PROFILE, schema, res_col, active)
    clone = lambda: pe[1].clone()  # noqa: E731
    result = {
        "spread_filter": timed(lambda _: kernels.spread_filter(state, pf0, bits0, spec0.ctx),
                               lambda _: plain.spread_filter(state, pf0, bits0, spec0.ctx), reps),
        "late_scores": timed(lambda a: kernels.late_scores(state, pf0, pe[0], a, bits0, late),
                             lambda a: plain.late_scores(state, pf0, pe[0], a, bits0, late), reps, clone),
        "late_scores/cols": timed(lambda a: kernels.late_scores_cols(state, pf0, pe[0], a, bits0, late),
                                  lambda a: plain.late_scores_cols(state, pf0, pe[0], a, bits0, late), reps, clone),
    }
    set_bound(result["spread_filter"], spread_bytes(state, pf0, "tps_h") + n)
    set_bound(result["late_scores"], late_bytes(state, pf0, late, 1))
    set_bound(result["late_scores/cols"], late_bytes(state, pf0, late, 1) + 3 * n * 8)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
        result[name].setdefault("library_ms", None)
    pf1, bits1, late1, pe1 = soft
    ms1, _ = median_ms(lambda a: kernels.late_scores(state, pf1, pe1[0], a, bits1, late1), reps,
                       lambda: pe1[1].clone())
    print(f"spread_c1: exact on 16 workload pods and 64 mixed pods, one a launch; CTAs a pod "
          f"{spread_ctas(state, pf0, 1, schema)}; late_scores on mixed pod 1 (zone and hostname "
          f"ScheduleAnyway): device ms {ms1:.4f}")
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
    """eval_chunk (with the planes its filters and scores read:
    main_planes), select_host and resolve_commit against their plain
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
    ext = main_planes(builder, st, pf, spec)
    seed_mul = ((profile.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    steps = torch.arange(c, dtype=torch.int64, device=dev) + 12345
    for nom_in in (nom, None):
        ke = kernels.eval_chunk(st, pf, spec, nom_in, ext)
        pe = plain.eval_chunk(st, pf, spec, nom_in, ext)
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
        "eval_chunk": timed(lambda _: kernels.eval_chunk(st, pf, spec, nom, ext),
                            lambda _: plain.eval_chunk(st, pf, spec, nom, ext), reps),
        "select_host": timed(lambda _: kernels.select_host(ke[0], ke[1], steps, seed_mul, None),
                             lambda _: plain.select_host(pe[0], pe[1], steps, seed_mul, None), reps),
    }
    set_bound(out["eval_chunk"], eval_bytes(st, pf, nom) + nbytes(*(x for x in ext if x is not None)))
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


def main_planes(builder, state, pf: dict, spec) -> tuple:
    """The precomputed planes eval_chunk reads for ``spec`` on this chunk
    (plain versions; None where no filter or score reads one): node_filters'
    bits, spread_filter's mask, vol_filter's bits, image_scores' plane."""
    from kubernetes_tpu_torch.kernels import plain

    cfg = spec.device_config(state.valid.device)
    bits = plain.node_filters(state, pf, spec.ctx) if cfg["node_bits"] or cfg["spread"] else None
    spread_ok = plain.spread_filter(state, pf, bits, spec.ctx) if cfg["spread"] else None
    vol = None
    if cfg["vol_bits"]:
        vol = plain.vol_filter(state, pf, spec.ctx, "VolumeRestrictions" in spec.filters,
                               "NodeVolumeLimits" in spec.filters)
    il = None
    if cfg["il"]:
        il = plain.image_scores(state, pf, plain.image_counts(state, len(builder.interns.images)))
    return bits, spread_ok, vol, il


def pick_cost(possible, pf: dict) -> tuple[int, int]:
    """preempt_pick: (bytes, operations).  A byte of ``possible`` a node
    row, the five int64 criteria of the possible nodes only, the mates'
    fields (valid, or elig and spec_picks; sig) and the picks written.  No
    operations term: the least work is a top-C selection, which the bytes
    bound."""
    c = pf["sig"].shape[0]
    mates = c * (1 + 4) if "elig" in pf else c
    return possible.shape[0] + int(possible.sum()) * 5 * 8 + mates + c * 4 + c * 4, 0


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


def prologue_bytes(state, vic, pf: dict) -> int:
    """preempt_eval's PROLOGUE: each node's valid, unschedulable, name and
    node_filters bytes and its victims' priorities read once, the lower
    slots' requests, the carry written."""
    import torch

    n, v = vic.prio.shape
    r = vic.req.shape[2]
    lower = int((vic.prio < pf["priority"][int(torch.argmax(pf["valid"].to(torch.int32)))]).sum())
    return n * (1 + 1 + 4 + 1) + n * v * 4 + lower * r * 8 + n * (8 + r * 8 + 4 + 1)


def tail_bytes(vic, carry) -> int:
    """preempt_eval's TAIL: the carry's mask and flags read, the masked
    slots' priorities, start times, non-zero requests and PDB bits, the
    criteria, victim mask, count and non-zero release written (the release
    is the carry's own rows)."""
    import torch

    n, v = vic.prio.shape
    p = vic.pdb.shape[2]
    masked = int(torch.stack([((carry.mask >> j) & 1) for j in range(v)]).sum())
    return n * (8 + 1) + masked * (4 + 8 + 2 * 8 + p) + n * (1 + 5 * 8 + v + 4 + 2 * 8)


def pick_c1(c1_in, reps: int, errs: dict) -> dict:
    """preempt_pick timed on a chunk-1 dry-run's (pf, kernel criteria,
    plain criteria), beside its bound."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    pf, ek, ep = c1_in
    out = timed(lambda _: kernels.preempt_pick(ek[0], ek[1], pf, False),
                lambda _: plain.preempt_pick(ep[0], ep[1], pf, False), reps)
    set_bound(out, *pick_cost(ep[0], pf))
    out["max_abs_err"] = errs["preempt_pick"]
    return out


def check_preempt_kernels(dev, shape: str, reps: int, extra: dict | None = None) -> dict:
    """preempt_eval, preempt_pick, preempt_commit, unpack_victims,
    scatter_rows and expand_rows against their plain versions at one
    preemption shape: the chunk-1 dry-run of one preemptor, the rank split
    of the uniform batch (the workloads' mode), a mixed chunk of 64 that
    defers its other-signature mates, and the speculative mode (valid =
    eligible and the main pass's pick < 0).  With ``extra``, preempt_pick
    timed on the chunk-1 dry-run too, as ``extra[shape + "_c1"]``."""
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
        if label == "chunk1":
            c1_in = (pf, ek, ep)
    # The main pass's kernels at the path's own chunk and node count.
    _nodes, _per, _cpu, _mem, _k, _pdbs, chunk = PREEMPT_SHAPES[shape]
    result.update(check_main_at(dev, shape, s.builder, state, batches["mixed"][0], batches["mixed"][1],
                                s.profile, chunk, errs, reps))
    result["build_dom"] = dom_at(errs, shape, s.builder, state, reps)
    pf, ek, ep, pk, pp = timed_in
    result["preempt_eval"] = timed(lambda _: kernels.preempt_eval(state, vic, pf, spec),
                                   lambda _: plain.preempt_eval(state, vic, pf, spec), reps)
    set_bound(result["preempt_eval"], preempt_eval_bytes(state, vic, pf, ep[0]))
    result["preempt_pick"] = timed(lambda _: kernels.preempt_pick(ek[0], ek[1], pf, True),
                                   lambda _: plain.preempt_pick(ep[0], ep[1], pf, True), reps)
    n = state.valid.shape[0]
    set_bound(result["preempt_pick"], *pick_cost(ep[0], pf))
    if extra is not None:
        extra[f"{shape}_c1"] = {"preempt_pick": pick_c1(c1_in, reps, errs)}
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
    set_bound(result["unpack_victims"], nbytes(d_buf) + nbytes(*(x for x in up[:6] if x is not None)))
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


FLUSH_ROWS = {"flush": 1, "flush_8": 8, "flush_64": 64}


def check_flush_kernels(dev, reps: int) -> dict:
    """The dirty-row flush at the extender path's schema (its 5000 nodes,
    N=8192, and 512 bound pods): 1, 8 and 64 dirty rows of random values in
    all 27 fields, flushed by SnapshotBuilder.state(), every field exact
    against the per-field plain scatter of the host rows into the state
    before, and the host mirror equal.  Timed: the flush's device work from
    sources already on the card (one scatter_fields launch from the packed
    buffer; in a tree without it, the 27 scatter_rows launches of its
    flush, summed), the plain per-field loop, and the whole state() flush
    with its host packing and copies ("state_ms", "state_call_ms").
    Returns {"flush": ..., "flush_8": ..., "flush_64": ...}, each with the
    scatter_rows entry."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.snapshot import _NODE_AXIS, SnapshotBuilder

    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    nodes = w.extender_nodes()
    for node in nodes:
        cache.add_node(node)
    for j, pod in enumerate(w.warm_pods(w.EXTENDER_WARM_PODS)):
        pod.spec.node_name = nodes[j % len(nodes)].metadata.name
        cache.add_pod(pod)
    state = builder.state()
    rng = np.random.default_rng(83)
    one_launch = hasattr(kernels, "scatter_fields")
    names, axes = list(_NODE_AXIS), list(_NODE_AXIS.values())
    out = {}
    for shape, m in FLUSH_ROWS.items():
        errs: dict[str, float] = {}
        rows = np.sort(rng.choice(len(nodes), m, replace=False)).astype(np.int64)
        for name, axis in _NODE_AXIS.items():
            a = builder.host[name]
            size = (m,) + a.shape[1:] if axis == 0 else (a.shape[0], m)
            vals = rng.random(size) < 0.5 if a.dtype == np.bool_ else rng.integers(-(2**20), 2**20, size=size)
            if axis == 0:
                a[rows] = vals
            else:
                a[:, rows] = vals
        before = [getattr(state, k).clone() for k in names]
        idx = torch.from_numpy(rows).to(dev)
        srcs = [torch.from_numpy(np.ascontiguousarray(builder.host[k][rows] if ax == 0 else builder.host[k][:, rows]))
                .to(dev) for k, ax in zip(names, axes)]
        launches0 = kernels.scatter_rows.launches
        copies0 = getattr(builder, "flush_copies", None)
        for r in rows:
            builder._dirty_rows.add(int(r))
        state = builder.state()
        torch.cuda.synchronize()
        launches = kernels.scatter_rows.launches - launches0
        copies = None if copies0 is None else builder.flush_copies - copies0
        for k, ax, b, src in zip(names, axes, before, srcs):
            plain.scatter_rows(b, ax, idx, src)
            exact(errs, "scatter_rows", f"[{shape}] {k}", getattr(state, k), b)
        if not builder.host_mirror_equal():
            raise AssertionError(f"flush [{shape}]: the host mirror differs from the device state")
        if one_launch and (launches, copies) != (1, 1):
            raise AssertionError(f"flush [{shape}]: {launches} launches and {copies} copies, want one each")
        dsts = [getattr(state, k) for k in names]
        if one_launch:
            layout = kernels.flush_layout([(d.shape, d.element_size(), ax) for d, ax in zip(dsts, axes)], m)
            host = np.zeros(layout.nbytes, np.uint8)
            kernels.pack_rows(host, layout, rows, [builder.host[k] for k in names])
            dbuf = torch.from_numpy(host).to(dev)

            def device_part(_):
                kernels.scatter_fields(dsts, axes, dbuf, layout)
        else:
            def device_part(_):
                for d, ax, src in zip(dsts, axes, srcs):
                    kernels.scatter_rows(d, ax, idx, src)

        def plain_part(_):
            for d, ax, src in zip(dsts, axes, srcs):
                plain.scatter_rows(d, ax, idx, src)

        entry = timed(device_part, plain_part, reps)
        entry["state_ms"], entry["state_call_ms"] = median_ms(
            lambda _: builder.state(), reps, lambda: [builder._dirty_rows.add(int(r)) for r in rows])
        entry["library_ms"] = None  # no one PyTorch call scatters 27 tensors
        entry["max_abs_err"] = errs["scatter_rows"]
        set_bound(entry, nbytes(idx) + 2 * nbytes(*srcs))
        print(f"flush [{shape}]: exact over {len(names)} fields, {m} dirty rows; {launches} scatter_rows launches "
              f"and {'not counted' if copies is None else copies} host-to-device copies a flush; whole "
              f"state() flush: device ms {entry['state_ms']:.4f}, call ms {entry['state_call_ms']:.4f}")
        out[shape] = {"scatter_rows": entry}
    return out


# -- preemption's what-if search (preempt_eval's modes, dom_release, search_step) --------


def search_inputs(shape: str, dev, nodes: int = 5000):
    """A search shape's scheduler, victim pack and preemptor batches.

    "search" is preemption_default_search_5kn's cluster: 5000 nodes in 10
    zones (8192 rows), its 20000 background pods bound four to a node in
    start order (host-port holders, tier=noisy pods, pods keeping app=svc
    off their node), and 300 app=svc pods at priority 1000 bound unevenly
    over the zones; the batches are 1024 of the path's preemptor and a
    mixed 64 (the template, without the port, with a zone affinity to
    app=batch, with a zone anti-affinity to tier=noisy, with a hostname
    spread).  "search_pv" is a volume cluster: 5000 nodes whose CSINodes
    allow two attachments of the ebs driver, two bound pods per node, each
    with a device volume (read-write and read-only) and CSI claims, the
    node's shared claim held by both and every third node's first pod
    holding a claim of its own (6667 claims: the CSI volume table grows to
    8192 rows, 256 MiB); the batches want a device and a new claim, and one
    in three also keeps tier=noisy off its node.  "search_dra" is a DRA
    cluster: 5000 nodes each publishing 8 GPUs (h100 and a100 alternating)
    and holding four bound pods; on half the nodes these hold claims (one a
    claim of its own, two one shared claim, one a claim that on h100 nodes
    is h100-only and charges two pools), the first holder's claim allocated
    externally with that holder alone reserving it on every fifth node (the
    victim's count-only slot), and an external phantom charge nobody local
    reserves on every seventh (the claim table grows to 8192 rows, 256 MiB);
    the batches want all 8 devices of a node, two h100 devices, a missing
    claim or a claim allocated on node 5, and one in three also keeps
    tier=noisy off its node.  "search_dra_path" is dra_claims_5kn_5kpods's
    own cluster (dra_path_scheduler) with its 128 whole-node preemptors as
    the uniform batch and the first DRA_CHUNK of them as the mixed chunk:
    the path's dry-run chunk."""
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod, make_pvc
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    if shape == "search_dra_path":
        s, _pending = dra_path_scheduler(dev)
        for claim in w.dra_preemptor_claims():
            s.add_resource_claim(claim)
        preemptors = [w.dra_preemptor(i) for i in range(w.DRA_PREEMPTORS)]
        return _search_batches(s, preemptors, preemptors[:w.DRA_CHUNK], dev)
    k = 1024
    s = TorchScheduler(DEFAULT_PROFILE, batch_size=k, chunk_size=64, device=dev)
    for node in w.search_nodes(nodes):
        s.add_node(node)
    if shape == "search":
        for p in w.search_fill(4 * nodes):
            s.add_pod(p)
        for i in range(nodes * 3 // 50):
            zone = i % 10 if i < nodes * 3 // 50 - 10 else 0
            s.add_pod(make_pod(f"svc-bound-{i}").req({"memory": "1Gi"}).priority(1000).label("app", "svc")
                      .node(f"node-{(i * 17 + zone) % nodes // 10 * 10 + zone}").obj())
        uniform = [w.search_preemptor(f"u{i}") for i in range(k)]

        def mixed_pod(i):
            if i % 4 == 0:
                return w.search_preemptor(f"m{i}")
            p = (make_pod(f"m{i}").req({"cpu": "2", "memory": "4Gi"}).priority(1000 - i % 3).label("app", "svc")
                 .spread_constraint(1, w.ZONE, t.DO_NOT_SCHEDULE, "app", ["svc"]))
            if i % 4 == 1:
                p = p.pod_affinity_in("app", ["batch"], w.ZONE)
            elif i % 4 == 2:
                p = p.pod_anti_affinity_in("tier", ["noisy"], w.HOSTNAME).host_port(9090, host_ip="10.0.0.1")
            else:
                p = p.spread_constraint(2, w.HOSTNAME, t.DO_NOT_SCHEDULE, "app", ["svc"])
            return p.obj()
    elif shape == "search_pv":
        driver = "ebs.csi.aws.com"
        s.add_storage_class(t.StorageClass(name="ebs", provisioner=driver,
                                           binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
        for i in range(nodes):
            s.add_csinode(t.CSINode(name=f"node-{i}", driver_limits={driver: 2}))
        for c in ("want-a", "want-b"):
            s.add_pvc(make_pvc(c, storage_class="ebs"))
        for i in range(nodes):
            s.add_pvc(make_pvc(f"shared-{i}", storage_class="ebs"))
            for j in range(2):
                p = (make_pod(f"v-{i}-{j}").req({"cpu": "1", "memory": "3Gi"}).priority(1 + (i + j) % 3)
                     .start_time(float(2 * i + j)).device_volume(f"disk-{(i + j) % 64}", read_only=bool(j))
                     .pvc_volume(f"shared-{i}"))
                if (i + j) % 5 == 0:
                    p = p.label("tier", "noisy")
                if j == 0 and i % 3 == 0:
                    s.add_pvc(make_pvc(f"own-{i}", storage_class="ebs"))
                    p = p.pvc_volume(f"own-{i}")
                s.add_pod(p.node(f"node-{i}").obj())

        def vol_pod(i, name):
            p = make_pod(name).req({"cpu": "3", "memory": "4Gi"}).priority(100).label("app", "svc")
            p = p.device_volume(f"disk-{i % 64}", read_only=bool(i % 2)).pvc_volume("want-a")
            if i % 3 == 0:
                p = p.pod_anti_affinity_in("tier", ["noisy"], w.HOSTNAME)
            if i % 5 == 0:
                p = p.pvc_volume("want-b")
            return p.obj()

        uniform = [vol_pod(1, f"u{i}") for i in range(k)]

        def mixed_pod(i):
            return vol_pod(i, f"m{i}")
    else:
        gpu, h100 = w.DRA_CLASS, (w.DRA_H100,)
        s.builder._ensure(CLM=8192)
        for i in range(nodes):
            model = "h100" if i % 2 == 0 else "a100"
            s.add_resource_slice(t.ResourceSlice(node_name=f"node-{i}", device_class=gpu, devices=tuple(
                t.Device(name=f"gpu-{d}", attributes={"model": model}) for d in range(8))))
        for i in range(nodes):
            names = [None] * 4
            if i % 4 < 2:  # half the nodes hold claims (the claim table stays at 8192 rows)
                names = [f"own-{i}", f"pair-{i}", f"pair-{i}", f"sel-{i}"]
                own = dict(allocated_node=f"node-{i}", allocated_devices=(("r0", "gpu-7"),),
                           reserved_for=(f"default/v-{i}-0",)) if i % 5 == 0 else {}
                s.add_resource_claim(t.ResourceClaim(name=f"own-{i}", device_class=gpu, **own))
                s.add_resource_claim(t.ResourceClaim(name=f"pair-{i}", device_class=gpu))
                s.add_resource_claim(t.ResourceClaim(name=f"sel-{i}", requests=(
                    t.DeviceRequest("r0", gpu, 1, h100 if i % 2 == 0 else ()),)))
                if i % 7 == 3:
                    s.add_resource_claim(t.ResourceClaim(name=f"ext-{i}", device_class=gpu, count=2,
                                                         allocated_node=f"node-{i}", reserved_for=("elsewhere/pod",)))
            for j, claim in enumerate(names):
                p = (make_pod(f"v-{i}-{j}").req({"cpu": "1", "memory": "3Gi"}).priority(1 + (i + j) % 3)
                     .start_time(float(4 * i + j)))
                if claim is not None:
                    p = p.resource_claim(claim)
                if (i + j) % 5 == 0:
                    p = p.label("tier", "noisy")
                s.add_pod(p.node(f"node-{i}").obj())
        for name, count, sel in (("whole", 8, ()), ("two-h100", 2, h100)):
            s.add_resource_claim(t.ResourceClaim(name=name, requests=(t.DeviceRequest("r0", gpu, count, sel),)))

        def dra_pod(i, name):
            p = make_pod(name).req({"cpu": "1", "memory": "4Gi"}).priority(100).label("app", "svc")
            p = p.resource_claim(("whole", "two-h100", "ghost", "own-5")[i % 4])  # own-5: pinned to node-5
            if i % 3 == 1:
                p = p.pod_anti_affinity_in("tier", ["noisy"], w.HOSTNAME)
            return p.obj()

        uniform = [dra_pod(0, f"u{i}") for i in range(k)]

        def mixed_pod(i):
            return dra_pod(i, f"m{i}")

    return _search_batches(s, uniform, [mixed_pod(i) for i in range(64)], dev)


def _search_batches(s, uniform, mixed, dev):
    """The featurized uniform and mixed batches, their active ops and the
    victim pack."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.engine.features import build_pod_batch

    batches = {}
    for _ in range(2):  # the second pass sees the final vocabularies
        for label, pods in (("uniform", uniform), ("mixed", mixed)):
            batch, _deltas, active = build_pod_batch(pods, s.builder, s.profile, len(pods))
            sigs, _ = s.preemption._sig_ids(pods, len(pods))
            tb = {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for key, v in batch.items()}
            tb["sig"] = torch.from_numpy(sigs).to(dev)
            batches[label] = (tb, active)
    active = batches["uniform"][1] | batches["mixed"][1]
    pack = s.preemption.pack_victims(s.profile, active)
    return s, pack, batches, active


def search_step_bytes(state, vic, pf: dict, spec, carry) -> int:
    """search_step at one step: each node's state row (valid, counts,
    allocatable, requests, topology values), carry and node_bits read once
    and the carry written once; its masked victims' requests, groups and
    terms; the rows of the representative's groups and matching host terms
    in group_counts and et_counts; the port, device and CSI count rows of
    its ids; the domain tables read once."""
    import torch

    n, v = vic.prio.shape
    r = state.alloc.shape[1]
    masked = int(torch.stack([((carry.mask >> j) & 1) for j in range(v)]).sum())
    node = n * (1 + 4 + 4 + 2 * r * 8 + state.topo_vals.shape[1] * 4 + 1) + 2 * nbytes(*carry)
    vf = vic.vfeat or {}
    slot = masked * (r * 8 + sum(x[0, 0].numel() * 4 for x in vf.values()))
    i0 = int(torch.argmax(pf["valid"].to(torch.int32)))
    rows = 0
    if spec.domain:
        groups = pf["tps_h_groups"][i0].any(0) if spec.pts else torch.zeros_like(pf["ipa_ra_allmask"][i0])
        if spec.ipa:
            groups = groups | pf["ipa_ra_allmask"][i0] | pf["ipa_rs_groups"][i0].any(0)
            rows += int((pf["ipa_et_match"][i0] & pf["ipa_et_anti"][i0]).sum())
        rows += int(groups.sum())
    for key in ("port_triples", "vol_dev_ids", "vol_csi_ids"):
        if key in pf:
            rows += 2 * int((pf[key][i0] >= 0).sum())
    if spec.dra:  # the claims' count rows and the pools' cap and alloc rows
        rows += 2 * state.dra_cap.shape[0] + (int((pf["dra_claim_ids"][i0] >= 0).sum()) if "dra_claim_ids" in pf else 0)
    return node + slot + rows * n * 4


def dom_release_bytes(dom, state, vic, carry) -> int:
    """dom_release: both live tables read and both results written once,
    the carry's masks, and the masked victims' groups and terms with their
    nodes' topology values."""
    import torch

    v = vic.prio.shape[1]
    masked = int(torch.stack([((carry.mask >> j) & 1) for j in range(v)]).sum())
    ts = vic.vfeat["terms"].shape[2] if "terms" in (vic.vfeat or {}) else 0
    return (2 * nbytes(dom.group_dom, dom.et_dom) + nbytes(carry.mask)
            + masked * (4 + ts * 4 + state.topo_vals.shape[1] * 4))


def check_search_kernels(dev, shape: str, reps: int, nodes: int = 5000, extra: dict | None = None) -> dict:
    """unpack_victims (with the victim features), preempt_eval in its three
    modes, dom_release and search_step against their plain versions at one
    search shape, step by step (the carry and the released domain tables
    after every step equal), for the chunk-1 dry-run, the uniform batch's
    rank split, the mixed chunk and the speculative mode, with the default
    profile's filters (the domain ops) and with the node-local ops alone
    (FULL); then each timed with CUDA events beside its bound.  With
    ``extra``, preempt_pick timed on the chunk-1 tail too, as
    ``extra[shape + "_c1"]``."""
    import dataclasses

    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import preemption as tpre
    from kubernetes_tpu_torch.engine.pass_ import DomTables, build_dom, eval_spec
    from kubernetes_tpu_torch.kernels import plain

    s, pack, batches, active = search_inputs(shape, dev, nodes)
    state = s.builder.state()
    vic = pack["vic"]
    errs: dict[str, float] = {}
    result = {}
    spec = tpre.preempt_spec(s.profile, s.builder.schema, s.builder.res_col, active)
    local = dataclasses.replace(spec, ipa=False, pts=False)
    inv = s.builder.batch_invariants()
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    dom = build_dom(state, to(inv["et_slot"]), to(inv["et_host"]), s.builder.schema.DV)
    # unpack_victims of the staged buffer with its feature columns.
    lay = pack["layout"]
    d_buf = torch.from_numpy(pack["buf"]).to(dev)
    args = (lay["r"], lay["n_pdbs"], lay["pdb_words"], lay["v"], "allowed" not in lay, lay["vf_cols"])
    uk = kernels.unpack_victims(d_buf, *args)
    up = plain.unpack_victims(d_buf, *args)
    torch.cuda.synchronize()
    for what, a, b in zip(("prio", "req", "nonzero", "start", "pdb", "allowed"), uk, up):
        if a is not None:
            exact(errs, "unpack_victims", f"[{shape}] {what}", a, b)
    for key in up[6]:
        exact(errs, "unpack_victims", f"[{shape}] vfeat {key}", uk[6][key], up[6][key])
    result["unpack_victims"] = timed(lambda _: kernels.unpack_victims(d_buf, *args),
                                     lambda _: plain.unpack_victims(d_buf, *args), reps)
    set_bound(result["unpack_victims"], nbytes(d_buf) + nbytes(*(x for x in up[:6] if x is not None))
              + nbytes(*up[6].values()))
    tb, _ = batches["uniform"]
    mixed, _ = batches["mixed"]
    k, c = tb["valid"].shape[0], mixed["valid"].shape[0]
    valid = torch.ones(k, dtype=torch.bool, device=dev)
    spec_picks = torch.where(torch.arange(k, device=dev) % 5 == 0, 7, -1).to(torch.int32)
    late = valid[:c].clone()
    late[:2] = False  # the representative is the third pod
    modes = {
        "chunk1": {**{key: v[1:2] for key, v in mixed.items()}, "valid": valid[:1]},
        "chunk1 (hostname spread)": {**{key: v[3:4] for key, v in mixed.items()}, "valid": valid[:1]},
        "rank split": {**tb, "valid": valid},
        "mixed chunk": {**mixed, "valid": late},
        "speculative": {**{key: v[:c] for key, v in tb.items()}, "elig": valid[:c], "spec_picks": spec_picks[:c]},
    }
    timed_in = None
    steps = 0
    for label, pf in modes.items():
        pf = dict(pf)
        pf["node_bits"] = kernels.node_filters(state, {"valid": pf.get("valid", pf.get("elig")), **pf}, spec.ctx)
        where = f"[{shape} {label}]"
        kc = kernels.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)
        pc = plain.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)

        def same_carry(what):
            torch.cuda.synchronize()
            for name, a, b in zip(("mask", "rel", "cnt", "flags"), kc, pc):
                exact(errs, what, f"{where} carry.{name}", a, b)

        same_carry("preempt_eval")
        first = (kc.mask.clone(), kc.rel.clone(), kc.cnt.clone(), kc.flags.clone())
        kernels.search_step(state, vic, pf, spec, kc, plain.HARD_STEP, dom)
        plain.search_step(state, vic, pf, spec, pc, plain.HARD_STEP, dom)
        same_carry("search_step")
        for step in [plain.PHASE1, *range(vic.occupied - 1, -1, -1)]:
            kd = kernels.dom_release(dom, state, vic, kc, step)
            pd = plain.dom_release(dom, state, vic, pc, step)
            torch.cuda.synchronize()
            exact(errs, "dom_release", f"{where} step {step} group_dom", kd[0], pd[0])
            exact(errs, "dom_release", f"{where} step {step} et_dom", kd[1], pd[1])
            if timed_in is None and label == "rank split" and step == 0:
                timed_in = (pf, kernels.SearchCarry(*(x.clone() for x in kc)), kd)
            kernels.search_step(state, vic, pf, spec, kc, step, dom, DomTables(*kd, dom.et_slot, dom.et_host))
            plain.search_step(state, vic, pf, spec, pc, step, dom, DomTables(*pd, dom.et_slot, dom.et_host))
            same_carry("search_step")
            steps += 1
        if label == "rank split":
            clone = lambda c: kernels.SearchCarry(*(x.clone() for x in c))  # noqa: E731
            tail_in = (pf, clone(kc), clone(pc))
        kt = kernels.preempt_eval(state, vic, pf, spec, plain.TAIL, kc)
        pt = plain.preempt_eval(state, vic, pf, spec, plain.TAIL, pc)
        torch.cuda.synchronize()
        for what, a, b in zip(("possible", "crit", "vic_mask", "n_vic", "rel", "relnz"), kt, pt):
            exact(errs, "preempt_eval", f"{where} tail {what}", a, b)
        chunk_mode = pf["sig"].shape[0] > 1
        pk = kernels.preempt_pick(kt[0], kt[1], pf, chunk_mode)
        pp = plain.preempt_pick(pt[0], pt[1], pf, chunk_mode)
        torch.cuda.synchronize()
        exact(errs, "preempt_pick", f"{where} picks", pk, pp)
        if label == "mixed chunk":
            pick_in = (pf, kt, pt, chunk_mode, pk, pp)
        if label == "chunk1":
            c1_in = (pf, kt, pt)
        kf = kernels.preempt_eval(state, vic, pf, local)
        pfull = plain.preempt_eval(state, vic, pf, local)
        torch.cuda.synchronize()
        for what, a, b in zip(("possible", "crit", "vic_mask", "n_vic", "rel", "relnz"), kf, pfull):
            exact(errs, "preempt_eval", f"{where} node-local full {what}", a, b)
        hard = int(((pc.flags & plain.F_HARD) == 0).sum())
        moved = int((first[0] != pc.mask).sum())
        print(f"search [{shape} {label}]: exact; {hard} nodes fail the hard filters, {int(pt[0].sum())} possible "
              f"(node-local ops alone: {int(pfull[0].sum())}), {moved} nodes reprieved a victim, "
              f"{int(pt[3][pt[0]].sum())} victims on the possible nodes")
        if label == "rank split":
            full_in = pf
    pf, c0, kd = timed_in
    fresh = lambda: kernels.SearchCarry(*(x.clone() for x in c0))  # noqa: E731
    rel_dom = DomTables(*kd, dom.et_slot, dom.et_host)
    result["search_step"] = timed(lambda c: kernels.search_step(state, vic, pf, spec, c, 0, dom, rel_dom),
                                  lambda c: plain.search_step(state, vic, pf, spec, c, 0, dom, rel_dom), reps,
                                  fresh, plain_reps=max(3, reps // 10))
    set_bound(result["search_step"], search_step_bytes(state, vic, pf, spec, c0))
    result["dom_release"] = timed(lambda _: kernels.dom_release(dom, state, vic, c0, 0),
                                  lambda _: plain.dom_release(dom, state, vic, c0, 0), reps)
    set_bound(result["dom_release"], dom_release_bytes(dom, state, vic, c0))
    result["preempt_eval"] = timed(lambda _: kernels.preempt_eval(state, vic, full_in, local),
                                   lambda _: plain.preempt_eval(state, vic, full_in, local), reps,
                                   plain_reps=max(3, reps // 10))
    set_bound(result["preempt_eval"], preempt_eval_bytes(state, vic, full_in, None)
              + search_step_bytes(state, vic, full_in, local, c0) - nbytes(*c0) * 2)
    # preempt_pick on the mixed chunk's tail (the paths' dry-run chunk).
    pf, kt, pt, chunk_mode, pk, pp = pick_in
    result["preempt_pick"] = timed(lambda _: kernels.preempt_pick(kt[0], kt[1], pf, chunk_mode),
                                   lambda _: plain.preempt_pick(pt[0], pt[1], pf, chunk_mode), reps)
    set_bound(result["preempt_pick"], *pick_cost(pt[0], pf))
    if extra is not None:
        extra[f"{shape}_c1"] = {"preempt_pick": pick_c1(c1_in, reps, errs)}
        # preempt_eval's two launches around a search (the rank split's
        # prologue and its tail on the carry the search left).
        pf, kcarry, pcarry = tail_in
        pro = timed(lambda _: kernels.preempt_eval(state, vic, pf, spec, plain.PROLOGUE),
                    lambda _: plain.preempt_eval(state, vic, pf, spec, plain.PROLOGUE), reps)
        set_bound(pro, prologue_bytes(state, vic, pf))
        tail = timed(lambda _: kernels.preempt_eval(state, vic, pf, spec, plain.TAIL, kcarry),
                     lambda _: plain.preempt_eval(state, vic, pf, spec, plain.TAIL, pcarry), reps)
        set_bound(tail, tail_bytes(vic, pcarry))
        for key, entry in ((f"{shape}_prologue", pro), (f"{shape}_tail", tail)):
            extra[key] = {"preempt_eval": {**entry, "max_abs_err": errs["preempt_eval"], "library_ms": None}}
    # preempt_commit of the mixed chunk's picks, and expand_rows of the
    # uniform batch, at this shape (the search and claims paths' own).
    carries = lambda: ((state.req.clone(), state.nonzero_req.clone(), state.num_pods.clone()),  # noqa: E731
                       vic.prio.clone())
    ck, cp = carries(), carries()
    mk = kernels.preempt_commit(ck[0], ck[1], kt, pk)
    mp = plain.preempt_commit(cp[0], cp[1], pt, pp)
    torch.cuda.synchronize()
    for what, a, b in (("vic_mask", mk[0], mp[0]), ("n_victims", mk[1], mp[1]), ("req", ck[0][0], cp[0][0]),
                       ("nonzero_req", ck[0][1], cp[0][1]), ("num_pods", ck[0][2], cp[0][2]),
                       ("vic_prio", ck[1], cp[1])):
        exact(errs, "preempt_commit", f"[{shape} mixed chunk] {what}", a, b)
    result["preempt_commit"] = timed(lambda a: kernels.preempt_commit(a[0], a[1], kt, pk),
                                     lambda a: plain.preempt_commit(a[0], a[1], pt, pp), reps, carries)
    rows = int((pp >= 0).sum())
    r, v = state.req.shape[1], vic.prio.shape[1]
    set_bound(result["preempt_commit"], c * (4 + v + 4) + rows * (2 * (r + 2) * 8 + r * 8 + 2 * 8 + 4 + 2 * 4
                                                                  + v * (1 + 4)))
    row = tb["req"][:1].contiguous()
    exact(errs, "expand_rows", f"[{shape}] req", kernels.expand_rows(row, k), plain.expand_rows(row, k))
    result["expand_rows"] = timed(lambda _: kernels.expand_rows(row, k), lambda _: plain.expand_rows(row, k), reps)
    result["expand_rows"]["library_ms"] = median_ms(lambda _: row.repeat(k, 1), reps)[0]
    set_bound(result["expand_rows"], nbytes(row) * (k + 1))
    if shape == "search":
        # The search path's main pass at its own chunk (128) and its batch
        # kernels on the preemptor batch.
        c_main = 128
        result.update(check_main_at(dev, shape, s.builder, state, tb, batches["uniform"][1], s.profile, c_main,
                                    errs, reps))
        ctx = eval_spec(s.profile, s.builder.schema, s.builder.res_col, batches["uniform"][1]).ctx
        kb = kernels.node_filters(state, tb, ctx)
        pb = plain.node_filters(state, tb, ctx)
        kcp = kernels.conflict_pairs(tb, k // c_main, c_main)
        pcp = plain.conflict_pairs(tb, k // c_main, c_main)
        torch.cuda.synchronize()
        exact(errs, "node_filters", f"[{shape} batch]", kb, pb)
        exact(errs, "conflict_pairs", f"[{shape} batch]", kcp, pcp)
        result["node_filters"] = timed(lambda _: kernels.node_filters(state, tb, ctx),
                                       lambda _: plain.node_filters(state, tb, ctx), reps)
        set_bound(result["node_filters"], nf_bytes(state, tb, ctx))
        result["conflict_pairs"] = timed(lambda _: kernels.conflict_pairs(tb, k // c_main, c_main),
                                         lambda _: plain.conflict_pairs(tb, k // c_main, c_main), reps)
        set_bound(result["conflict_pairs"], search_pair_bytes(tb, c_main))
        result["build_dom"] = dom_at(errs, shape, s.builder, state, reps)
    print(f"search [{shape}]: {steps} search steps checked; K={k} C={c} N={state.valid.shape[0]} V={vic.prio.shape[1]} "
          f"(occupied {vic.occupied}) G={s.builder.schema.G} ET={s.builder.schema.ET} DV={s.builder.schema.DV} "
          f"CV={s.builder.schema.CV} features {sorted(vic.vfeat)}")
    for name in result:
        result[name]["max_abs_err"] = errs[name]
        result[name].setdefault("library_ms", None)
    return result


def pinned_inputs(dev):
    """The daemonset_15kn shapes: 15000 nodes (16384 rows), each reporting
    50 images of the default_images_ports pool (IM = 128 slots), with the
    512 warm-up daemon pods bound, and a 4096-pod batch pinned by
    matchFields node affinity — mostly one pod per node, every 64th pod
    asking 9 CPU on node-3 (the second and later of them overflow it),
    every 97th pinned to a node that does not exist, every 50th with a
    preferred zone term, every third naming one or two pool images — with
    its pins, nominations (every 9th pod nominated to its pin, under a
    nominated-pod overlay on those rows) and features on the card."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    k = w.DAEMONSET_BATCH
    s = TorchScheduler(DEFAULT_PROFILE, batch_size=k, chunk_size=w.DAEMONSET_CHUNK, device=dev)
    for node in w.images_nodes(w.DAEMONSET_NODES):
        s.add_node(node)
    pool, _weights = w.image_pool()
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
        if i % 3 == 1:
            pod.spec.containers[0].images = tuple(pool[(i * q) % 120][0] for q in range(1, 2 + i % 2))
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
    daemonset_15kn shapes (K=4096, N=16384): node_filters and image_scores
    in pinned mode (each pod on its pinned row), eval_chunk (reading those
    (K, 1) planes) and late_scores in pinned mode (also on a feasible set
    with holes), pinned_fit, the strict resolve_commit of the pinned picks
    over each 1024-lane slice, and the pinned pass end to end (picks,
    scores, counts, fail masks and the committed state); returns their
    timings and bounds."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import DomTables, build_pinned_pass, eval_spec, late_spec
    from kubernetes_tpu_torch.kernels import plain

    s, state, tb, active, nom, pin, rows = pinned_inputs(dev)
    schema = s.builder.schema
    spec = eval_spec(s.profile, schema, s.builder.res_col, active)
    late = late_spec(s.profile, schema, s.builder.res_col, active)
    errs: dict[str, float] = {}
    k, n = pin.shape[0], state.valid.shape[0]
    if plain.IL not in dict(spec.scorers):
        raise AssertionError(f"daemonset shape: ImageLocality does not score ({spec.scorers})")
    kb = kernels.node_filters(state, tb, spec.ctx, pin)
    pb = plain.node_filters(state, tb, spec.ctx, pin)
    kil = kernels.image_scores(state, tb, None, pin)
    pil = plain.image_scores(state, tb, None, pin)
    torch.cuda.synchronize()
    exact(errs, "node_filters", "[daemonset pinned]", kb, pb)
    exact(errs, "image_scores", "[daemonset pinned]", kil, pil)
    ext = (pb, None, None, pil)
    ke = kernels.eval_chunk(state, tb, spec, nom, ext, pin)
    pe = plain.eval_chunk(state, tb, spec, nom, ext, pin)
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
    # The pinned pass end to end, through the kernels and their plain versions.
    batch = {key: v for key, v in tb.items() if key != "nominated_row"}
    batch["pin_row"] = rows.cpu().numpy()
    batch["nominated_row"] = torch.where(tb["nominated_row"] >= 0, rows, -1).cpu().numpy()
    inv = {**s.builder.batch_invariants(), "nom_req": nom[0], "nom_cnt": nom[1], "nom_prio": nom[2]}
    runs = {impl: build_pinned_pass(s.profile, schema, s.builder.res_col, active, _impl=impl)(
        state.clone(), batch, inv) for impl in ("kernel", "plain")}
    torch.cuda.synchronize()
    (kst, kout), (pst, pout) = runs["kernel"], runs["plain"]
    for f in kout._fields:
        exact(errs, "node_filters", f"[daemonset pinned pass] {f}", getattr(kout, f), getattr(pout, f))
    for f in ("req", "nonzero_req", "num_pods", "group_counts"):
        exact(errs, "node_filters", f"[daemonset pinned pass] state.{f}", getattr(kst, f), getattr(pst, f))
    print(f"pinned [daemonset K={k} N={n}]: exact; {int(own.sum())} pods feasible on their pins, "
          f"{int((picks >= 0).sum())} placed, {int((picks == -2).sum())} deferred, "
          f"{int((rows < 0).sum())} pinned to no node, fail masks {sorted(set(pe[2].tolist()))}, "
          f"image scores {sorted(set(pil[:, 0].tolist()))[:12]}, "
          f"NodeAffinity weight {late.na_weight if late else 0}, taint weight {late.taint_weight if late else 0}")
    sub0 = {key: v[:c] for key, v in tb.items()}
    result = {
        "node_filters": timed(lambda _: kernels.node_filters(state, tb, spec.ctx, pin),
                              lambda _: plain.node_filters(state, tb, spec.ctx, pin), reps),
        "image_scores": timed(lambda _: kernels.image_scores(state, tb, None, pin),
                              lambda _: plain.image_scores(state, tb, None, pin), reps),
        "eval_chunk": timed(lambda _: kernels.eval_chunk(state, tb, spec, nom, ext, pin),
                            lambda _: plain.eval_chunk(state, tb, spec, nom, ext, pin), reps),
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
    set_bound(result["node_filters"], nf_bytes(state, tb, spec.ctx, pin))
    set_bound(result["image_scores"], image_scores_bytes(state, tb, None, pin))
    set_bound(result["eval_chunk"], k * node_row + pod_feats + k * (1 + 8 + 4) + k)
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
            first = (pf, bits, pv, ps[0], pe, steps)
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
    pf0, _bits0, pv0, picks0, pe0, steps0 = first
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
        "select_host": timed(lambda _: kernels.select_host(pe0[0], pe0[1], steps0, seed_mul, pf0["nominated_row"]),
                             lambda _: plain.select_host(pe0[0], pe0[1], steps0, seed_mul, pf0["nominated_row"]),
                             reps),
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
    set_bound(result["select_host"], select_bytes(c, n))
    result["build_dom"] = dom_at(errs, "pv", builder, state, reps)
    nf_cases(errs, dev, "pv", state, layouts=True)
    set_bound(result["eval_chunk"], eval_bytes(state, pf0, None) + 2 * c * n)
    set_bound(result["resolve_commit"], commit_bytes(schema, pickc, c) + vol_commit_bytes(state, pfc, placed))
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    keys = {key: tuple(big[key].shape) for key in big if key.startswith(("vb_", "vz_", "vol_"))}
    print(f"pv shapes: C={c}, N={n}, K={k}, CV={schema.CV}, DR={schema.DR}, VD={schema.VD}; features {keys}; "
          f"{stats}")
    return result


def dra_inputs(dev, nodes: int = 5000):
    """The "dra" shape: a 5000-node cluster (8192 rows) whose even nodes
    publish 8 GPUs (h100 with 80 of memory and a100 with 40, alternating);
    2000 pods bound on GPU nodes with a claim each (the claim's count on
    that node is 1), the first ten GPU nodes full (one 8-device claim
    each), 50 claims allocated externally on GPU nodes; then a 4096-pod
    batch with 1-2 claim slots a pod: its own claim for a device (bare, h100
    only, or two devices of at least 80 of memory: three pools), a claim
    shared with the next pod (inside one chunk), its own claim named twice,
    two claims, a claim a bound pod reserves, an externally allocated claim
    (pinned), a missing claim, or none; featurized under the default
    profile (twice: the second pass sees the final vocabularies).  The
    claim table is 8192 rows (256 MiB)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    rng = np.random.default_rng(131)
    s = TorchScheduler(DEFAULT_PROFILE, batch_size=4096, chunk_size=64, device=dev)
    gpu = w.DRA_CLASS
    for node in w.basic_nodes(nodes, zones=10):
        s.add_node(node)
    s.builder._ensure(CLM=8192)
    for i in range(0, nodes, 2):
        model, mem = ("h100", 80) if (i // 2) % 2 == 0 else ("a100", 40)
        s.add_resource_slice(t.ResourceSlice(node_name=f"node-{i}", device_class=gpu, devices=tuple(
            t.Device(name=f"gpu-{d}", attributes={"model": model, "memory": mem}) for d in range(8))))
    pools = {"bare": (), "h100": (w.DRA_H100,), "big": ('device.attributes["memory"].int >= 80',)}

    def claim(name, pool="bare", count=1, **kw):
        s.add_resource_claim(t.ResourceClaim(name=name, requests=(t.DeviceRequest("r0", gpu, count, pools[pool]),),
                                             **kw))

    for j in range(10):
        claim(f"full-{j}", count=8)
        s.add_pod(make_pod(f"full-{j}").req({"cpu": "1"}).resource_claim(f"full-{j}").node(f"node-{2 * j}").obj())
    for j in range(2000):
        claim(f"bound-{j}", ("bare", "h100")[j % 2])
        s.add_pod(make_pod(f"bound-{j}").req({"cpu": "100m"}).resource_claim(f"bound-{j}")
                  .node(f"node-{2 * int(rng.integers(50, nodes // 2))}").obj())
    for j in range(50):
        claim(f"pin-{j}", allocated_node=f"node-{40 + 2 * j}", allocated_devices=(("r0", "gpu-7"),),
              reserved_for=("elsewhere/pod",))
    pods = []
    for k in range(4096):
        p = make_pod(f"p{k}").req({"cpu": f"{int(rng.choice([100, 900]))}m", "memory": "1Gi"})
        r = k % 16
        if r < 6:
            claim(f"c{k}")
            p = p.resource_claim(f"c{k}")
        elif r < 8:
            claim(f"c{k}", "h100")
            p = p.resource_claim(f"c{k}")
        elif r == 8:
            claim(f"c{k}", "big", count=2)
            p = p.resource_claim(f"c{k}")
        elif r == 9:
            p = p.resource_claim(f"c{k - 1}")  # shared with the previous pod
        elif r == 10:
            claim(f"c{k}")
            p = p.resource_claim(f"c{k}").resource_claim(f"c{k}")
        elif r == 11:
            claim(f"c{k}")
            claim(f"d{k}", "h100")
            p = p.resource_claim(f"c{k}").resource_claim(f"d{k}")
        elif r == 12:
            p = p.resource_claim(f"bound-{int(rng.integers(2000))}")
        elif r == 13:
            p = p.resource_claim(f"pin-{int(rng.integers(50))}")
        elif r == 14:
            p = p.resource_claim("ghost")
        pods.append(p.obj())
    for _ in range(2):
        batch, _, active = build_pod_batch(pods, s.builder, s.profile, 4096)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {key: to(v) for key, v in batch.items()}
    pf["nominated_row"] = to(np.full(4096, -1, np.int32))
    return s.builder, s.builder.state(), pf, active, rng


def dra_path_scheduler(dev):
    """dra_claims_5kn_5kpods's own cluster in the middle of its burst, at
    its batch and chunk: its 2500 nodes and slices, the 512 fill pods
    bound over all nodes, the measured pods' claims, and the first
    ``DRA_MEASURED_PODS - DRA_BATCH`` measured pods reserved and bound as
    Reserve leaves them (claims allocated to named devices, the selector
    pool's corrections applied), two or four a GPU node (h100-only claims
    on h100 nodes, a shared claim's pods together), so no GPU node but the
    last, when their count is odd, has all its devices free.  Returns the
    scheduler and the pending measured pods."""
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    s = TorchScheduler(DEFAULT_PROFILE, batch_size=w.DRA_BATCH, chunk_size=w.DRA_CHUNK, device=dev)
    for node in w.basic_nodes(w.DRA_NODES, zones=w.DRA_ZONES):
        s.add_node(node)
    w.dra_setup(s)
    for j, p in enumerate(w.warm_pods(w.DRA_FILL_PODS)):
        p.spec.node_name = f"node-{j * 5 % w.DRA_NODES}"
        s.add_pod(p)
    for claim in w.dra_claims():
        s.add_resource_claim(claim)
    gpu_nodes = w.DRA_NODES // w.DRA_GPU_EVERY
    gpu_nodes -= gpu_nodes % 2  # an even modulus keeps the index's parity
    bound = w.DRA_MEASURED_PODS - w.DRA_BATCH
    for i in range(bound):
        # i // 2 + 1 is even for the h100 pods (i % 4 == 2), and the GPU
        # nodes of even index publish h100s; a shared pair (i, i + 1 with
        # i % 32 == 0) lands together.
        node = f"node-{(i // 2 + 1) % gpu_nodes * w.DRA_GPU_EVERY}"
        pod = w.dra_pod(i)
        if s.builder.dra.allocate_pod_claims(pod, node) is None:
            raise AssertionError(f"dra path cluster: {pod.name}'s claim does not fit on {node}")
        s._drain_dra_corrections()
        pod.spec.node_name = node
        s.add_pod(pod)
    return s, [w.dra_pod(i) for i in range(bound, w.DRA_MEASURED_PODS)]


def dra_path_inputs(dev):
    """The "dra_path" shape: dra_path_scheduler's cluster (N=4096,
    CLM=8192) and its pending DRA_BATCH measured pods as one featurized
    batch, as the path's kernels see them."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.engine.features import build_pod_batch

    s, pods = dra_path_scheduler(dev)
    k = len(pods)
    for _ in range(2):  # the second pass sees the final vocabularies
        batch, _, active = build_pod_batch(pods, s.builder, s.profile, k)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {key: to(v) for key, v in batch.items()}
    pf["nominated_row"] = to(np.full(k, -1, np.int32))
    return s.builder, s.builder.state(), pf, active, np.random.default_rng(137)


def dra_eval_bytes(state, pf: dict) -> int:
    """DynamicResources' part of eval_chunk for this chunk: its claim slots,
    pins and missing flags read, the count row of each distinct claim id
    and the cap and alloc rows of each pool the chunk demands."""
    import torch

    n = state.valid.shape[0]
    b = nbytes(pf["dra_pin_ids"], pf["dra_missing"])
    if "dra_claim_ids" in pf:
        ids, cls = pf["dra_claim_ids"], pf["dra_claim_cls"]
        b += nbytes(ids, cls, pf["dra_claim_cnt"])
        b += int(torch.unique(ids[ids >= 0]).numel()) * n * 4 + int(torch.unique(cls[ids >= 0]).numel()) * n * 8
    return b


def dra_commit_bytes(state, pf: dict, placed) -> int:
    """The DRA part of resolve_commit: the slots read, and one read and one
    write of each distinct claim-count cell a placed pod touches and of
    each pool cell a newly reserved claim charges."""
    import torch

    if "dra_claim_ids" not in pf:
        return 0
    n = state.valid.shape[0]
    ids, cls = pf["dra_claim_ids"], pf["dra_claim_cls"]
    rows = placed.clamp(min=0).long()[:, None]
    use = (ids >= 0) & (placed >= 0)[:, None]
    cell = ids.clamp(min=0).long() * n + rows
    fresh = use & (state.dra_claim_counts.view(-1)[cell] == 0)
    b = nbytes(ids, cls, pf["dra_claim_cnt"], pf["dra_claim_first"])
    return b + int(torch.unique(cell[use]).numel()) * 8 + int(torch.unique((cls.long() * n + rows)[fresh]).numel()) * 8


def check_dra_kernels(dev, reps: int, shape: str = "dra", nodes: int = 5000) -> dict:
    """Phase 3 at one DRA shape: "dra" (C=64, N=8192, a 4096-pod batch,
    CLM=8192; dra_inputs) or "dra_path" (the path's own C=DRA_CHUNK over
    its DRA_BATCH pending pods; dra_path_inputs).  conflict_pairs over the
    batch's chunks, eval_chunk with DynamicResources (filter code 5) and
    select_host per sampled chunk, resolve_commit strict and not with the
    claim commit on chunks whose picks put pods on a few GPU rows (claims
    shared inside the chunk, claims already reserved there, a pod naming
    its claim twice); all against their plain versions, exactly.  Returns
    the timings (the pairs on the batch, the rest on chunk 0) with their
    bounds."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    if shape == "dra":
        builder, state, big, active, rng = dra_inputs(dev, nodes)
        # Every eighth of the 64 chunks.
        c, sample = 64, 8
    else:
        builder, state, big, active, rng = dra_path_inputs(dev)
        nodes = w.DRA_NODES
        # Every fifth of the 128 chunks: the path's shared pairs (batch
        # lanes 32m + 24, 32m + 25) fall in chunks 3 mod 4, so 15, 35, ...
        c, sample = w.DRA_CHUNK, 5
    schema = builder.schema
    errs: dict[str, float] = {}
    n, k = state.valid.shape[0], big["valid"].shape[0]
    spec = eval_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    if "DynamicResources" not in spec.filters or schema.DC > 4:
        raise AssertionError(f"dra shape: filters {spec.filters}, CLM={schema.CLM}, DC={schema.DC}")
    kp = kernels.conflict_pairs(big, k // c, c)
    pp = plain.conflict_pairs(big, k // c, c)
    torch.cuda.synchronize()
    exact(errs, "conflict_pairs", f"[{shape} batch]", kp, pp)
    stats = {"pairs": int(pp.sum()), "dra_rejects": 0, "deferred": 0, "committed": 0}
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    bit = 1 << spec.filters.index("DynamicResources")
    first = None
    for i in range(0, k // c, sample):
        pf = _chunk(big, i, c)
        ke = kernels.eval_chunk(state, pf, spec, None, None)
        pe = plain.eval_chunk(state, pf, spec, None, None)
        torch.cuda.synchronize()
        for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
            exact(errs, "eval_chunk", f"[{shape} chunk {i}] {what}", a, b)
        stats["dra_rejects"] += int(((pe[2] & bit) != 0).sum())
        steps = torch.from_numpy(rng.integers(0, 2**32, size=c, dtype=np.int64)).to(dev)
        ks = kernels.select_host(pe[0], pe[1], steps, seed_mul, pf["nominated_row"])
        ps = plain.select_host(pe[0], pe[1], steps, seed_mul, pf["nominated_row"])
        torch.cuda.synchronize()
        for what, a, b in zip(("pick", "best", "feasible_count"), ks, ps):
            exact(errs, "select_host", f"[{shape} chunk {i}] {what}", a, b)
        if first is None:
            first = (pf, ps[0])
            sel = (pe[0], pe[1], steps, seed_mul, pf["nominated_row"])
    et_slot = torch.zeros(schema.ET, dtype=torch.int32, device=dev)
    dom = build_dom(state, et_slot, torch.zeros(schema.ET, dtype=torch.bool, device=dev), schema.DV)
    fields = ("req", "nonzero_req", "num_pods", "group_counts", "dra_claim_counts", "dra_alloc")
    # GPU rows where bound pods already reserve claims, and an empty one.
    held = torch.nonzero(state.dra_claim_counts.sum(dim=0) > 0).flatten()
    crowd = torch.cat([held[20:23], torch.tensor([nodes - 2], device=dev)]).to(torch.int32)
    commit_cases = []
    for i in range(0, k // c, sample):
        pf = _chunk(big, i, c)
        picks = crowd[torch.from_numpy(rng.integers(0, 4, size=c)).to(dev)]
        ids0 = pf["dra_claim_ids"][:, 0]
        pair = torch.nonzero((ids0[1:] == ids0[:-1]) & (ids0[1:] >= 0)).flatten()
        picks[pair + 1] = picks[pair]  # a claim-sharing pair on one row
        picks[::13] = -1
        commit_cases.append((f"chunk {i}", pf, picks, kp[i]))
    pf0, picks0 = first
    commit_cases.append(("chunk 0 picks", pf0, picks0, kp[0]))
    placed = None
    for label, pf, picks, pairs in commit_cases:
        for strict in (False, True):
            sk, dk = state.clone(), clone_dom(dom)
            sp, dp = state.clone(), clone_dom(dom)
            ok_ = kernels.resolve_commit(sk, dk, pf, picks, pairs, strict)
            op_ = plain.resolve_commit(sp, dp, pf, picks, pairs, strict)
            torch.cuda.synchronize()
            exact(errs, "resolve_commit", f"[{shape} {label}] (strict={strict}) picks", ok_, op_)
            for f in fields:
                exact(errs, "resolve_commit", f"[{shape} {label}] (strict={strict}) state.{f}",
                      getattr(sk, f), getattr(sp, f))
            if not strict:
                stats["deferred"] += int((op_ == -2).sum())
                if placed is None:
                    placed = op_
            stats["committed"] += int((op_ >= 0).sum())
    _l, pfc, pickc, pairc = commit_cases[0]
    result = {
        "conflict_pairs": timed(lambda _: kernels.conflict_pairs(big, k // c, c),
                                lambda _: plain.conflict_pairs(big, k // c, c), reps),
        "eval_chunk": timed(lambda _: kernels.eval_chunk(state, pf0, spec, None, None),
                            lambda _: plain.eval_chunk(state, pf0, spec, None, None), reps),
        "select_host": timed(lambda _: kernels.select_host(*sel), lambda _: plain.select_host(*sel), reps),
        "resolve_commit": timed(
            lambda a: kernels.resolve_commit(a[0], a[1], pfc, pickc, pairc, False),
            lambda a: plain.resolve_commit(a[0], a[1], pfc, pickc, pairc, False), reps,
            lambda: (state.clone(), clone_dom(dom))),
    }
    set_bound(result["conflict_pairs"], nbytes(big["dra_claim_ids"], big["dra_claim_unalloc"]) + k * c)
    set_bound(result["eval_chunk"], eval_bytes(state, pf0, None) + dra_eval_bytes(state, pf0))
    set_bound(result["select_host"], select_bytes(c, n))
    set_bound(result["resolve_commit"], commit_bytes(schema, pickc, c) + dra_commit_bytes(state, pfc, placed))
    result["build_dom"] = dom_at(errs, shape, builder, state, reps)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
        result[name].setdefault("library_ms", None)
    keys = {key: tuple(big[key].shape) for key in big if key.startswith("dra_")}
    print(f"{shape} shapes: C={c}, N={n}, K={k}, CLM={schema.CLM}, DC={schema.DC}; features {keys}; {stats}")
    return result


# -- truncated (parity) mode: parity_basic_5kn_10kpods ---------------------------


def truncate_bytes(n: int) -> int:
    """truncate_feasible: feasible read and written, valid and order_pos
    read, pos written, the start read and written, the pod's valid flag
    read and its processed count written: about 11 bytes a row."""
    return n * (1 + 1 + 1 + 4 + 4) + 8 * 2 + 1 + 4


def scan_order(cache, n: int, dev):
    import torch

    return torch.from_numpy(cache.order_pos(n)).to(dev)


def truncated_steps(errs: dict, label: str, state, pods, order, steps, seed_mul: int, start0: int,
                    filt, score, score_kernel: str) -> tuple:
    """Truncated chunk-1 steps, one pod each, through the kernels and
    through their plain versions from the same inputs: ``filt(mod, i)``
    gives pod i's (feasible, total, fail) after every filter, then
    truncate_feasible (adaptive percentage), ``score(mod, i, feasible,
    total, fail)`` adds the scores over the truncated set (the
    ``score_kernel``), and select_host picks in pos mode; every output and
    the carried start compared exactly.  Returns the last pod's plain
    (feasible, total) and the feasible counts kept."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    mods = {"kernel": kernels, "plain": plain}
    starts = {impl: torch.tensor([start0], dtype=torch.int64, device=state.valid.device) for impl in mods}
    counts = plain.scan_counts(int(state.valid.sum()), 0)
    owner = {"feasible": "truncate_feasible", "pos": "truncate_feasible", "processed": "truncate_feasible",
             "start": "truncate_feasible", "total": score_kernel, "fail_mask": score_kernel,
             "pick": "select_host", "best": "select_host", "feasible_count": "select_host"}
    kept = []
    for i, pf in enumerate(pods):
        outs = {}
        for impl, mod in mods.items():
            feasible, total, fail = filt(mod, i)
            feasible, pos, processed = mod.truncate_feasible(feasible, state.valid, order, starts[impl],
                                                             pf["valid"], *counts)
            score(mod, i, feasible, total, fail)
            sel = mod.select_host(feasible, total, steps[i:i + 1], seed_mul, pf["nominated_row"], pos)
            outs[impl] = dict(zip(owner, (feasible, pos, processed, starts[impl].clone(), total, fail, *sel)))
        torch.cuda.synchronize()
        for what, kernel in owner.items():
            exact(errs, kernel, f"[truncated step, {label} pod {i}] {what}", outs["kernel"][what],
                  outs["plain"][what])
        kept.append(int(outs["plain"]["feasible_count"][0]))
    return (outs["plain"]["feasible"], outs["plain"]["total"]), kept


def pos_cases(errs: dict, dev, state, order, seed_mul: int, rng) -> int:
    """select_host's pos mode on truncated feasible sets, at the starts 0,
    nvalid - 1 and 2777, sparse and dense: kth at the first and last tie
    and on both sides of the positions' bitmap cut in 2 to 16 equal word
    ranges, and the only feasible row being the last node row or the row
    last in scan order.  Returns the number of cases."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kernels import plain

    n = state.valid.shape[0]
    valid = state.valid.cpu().numpy()
    nvalid = int(valid.sum())
    counts = plain.scan_counts(nvalid, 0)
    words = -(-n // 32)
    bounds = sorted({r * -(-words // k) * 32 for k in SPLITS for r in range(1, k)})
    real = torch.tensor([True], device=dev)
    count = 0
    for start in (0, nvalid - 1, 2777):
        st = torch.tensor([start], dtype=torch.int64, device=dev)
        sets = [valid & (rng.random(n) < d) for d in (0.1, 0.4)]
        for row in (nvalid - 1, int(np.argmax(np.where(valid, (order.cpu().numpy() - start) % nvalid, -1)))):
            one = np.zeros(n, bool)
            one[row] = True
            sets.append(one)
        for feas in sets:
            cut, pos, _ = plain.truncate_feasible(torch.from_numpy(feas[None]).to(dev), state.valid, order,
                                                  st.clone(), real, *counts)
            cut_np, pos_np = cut.cpu().numpy(), pos.cpu().numpy()
            total = rng.integers(0, 2, (1, n))
            ties = cut_np[0] & (total[0] == total[0][cut_np[0]].max()) if cut_np.any() else cut_np[0]
            tpos = np.sort(pos_np[ties])
            m = tpos.size
            ranks = {0, max(m - 1, 0)}
            for b in bounds:
                i = int(np.searchsorted(tpos, b))
                ranks |= {k for k in (i - 1, i) if 0 <= k < m}
            for k in sorted(ranks):
                select_case(errs, f"pos mode, start {start}, {int(feas.sum())} feasible, kth {k}", dev, cut_np,
                            total, [tie_step(seed_mul, m, k)], seed_mul, None, pos)
                count += 1
    return count


def check_truncate_kernels(dev, reps: int) -> dict:
    """Phase 3, truncated mode.  At the path's shape (parity_basic_5kn_10kpods'
    5000 nodes in 3 zones, N=8192, limit 500) truncate_feasible and
    select_host in pos mode against their plain versions, exactly, with 0,
    1, 500, 501, 2500 and 5000 feasible nodes, the start at 0, at 4999 and
    at 2777, on a real pod and a padding lane, and ties on few distinct
    totals; then truncated chunk-1 steps (every filter, the cut, the
    scores over the truncated set, the pick in scan order) at the IPA
    shape (N=1024, eval_chunk → ipa_eval's filter launch → truncate →
    ipa_eval's score launch) and the spread_na shape (N=1024,
    node_filters and spread_filter planes → eval_chunk → truncate →
    late_scores).  Returns {shape: {kernel: timings, bound, error}}."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.pass_ import eval_spec, late_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    errs: dict[str, float] = {}
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    for node in w.basic_nodes(w.PARITY_NODES, zones=w.PARITY_ZONES):
        cache.add_node(node)
    state = builder.state()
    n = state.valid.shape[0]
    order = scan_order(cache, n, dev)
    nvalid, limit = plain.scan_counts(int(state.valid.sum()), 0)
    if (n, nvalid, limit) != (8192, 5000, 500):
        raise AssertionError(f"truncate shape: N={n}, {nvalid} nodes, limit {limit}")
    rng = np.random.default_rng(97)
    rows = torch.nonzero(state.valid).flatten().cpu().numpy()
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    real, pad = (torch.tensor([v], device=dev) for v in (True, False))
    cut = 0
    for count in (0, 1, limit, limit + 1, nvalid // 2, nvalid):
        feasible = torch.zeros((1, n), dtype=torch.bool, device=dev)
        feasible[0, torch.from_numpy(rng.choice(rows, count, replace=False)).to(dev)] = True
        for start in (0, nvalid - 1, 2777):
            for pod_valid in ((real, pad) if count == nvalid else (real,)):
                ks = torch.tensor([start], dtype=torch.int64, device=dev)
                ps = ks.clone()
                kf, kpos, kproc = kernels.truncate_feasible(feasible.clone(), state.valid, order, ks, pod_valid,
                                                            nvalid, limit)
                pf_, ppos, pproc = plain.truncate_feasible(feasible.clone(), state.valid, order, ps, pod_valid,
                                                           nvalid, limit)
                torch.cuda.synchronize()
                what = f"[{count} feasible, start {start}, valid {bool(pod_valid[0])}]"
                for name, a, b in (("feasible", kf, pf_), ("pos", kpos, ppos), ("processed", kproc, pproc),
                                   ("start", ks, ps)):
                    exact(errs, "truncate_feasible", f"{what} {name}", a, b)
                cut += int(feasible.sum()) - int(pf_.sum())
                # Few distinct totals: many ties, the k-th in scan order.
                total = torch.from_numpy(rng.integers(0, 3, (1, n))).to(dev)
                steps = torch.from_numpy(rng.integers(0, 2**32, size=1, dtype=np.int64)).to(dev)
                ksel = kernels.select_host(pf_, total, steps, seed_mul, None, ppos)
                psel = plain.select_host(pf_, total, steps, seed_mul, None, ppos)
                torch.cuda.synchronize()
                for name, a, b in zip(("pick", "best", "feasible_count"), ksel, psel):
                    exact(errs, "select_host", f"[pos mode, {what}] {name}", a, b)
    # The start at nvalid - 1 with limit + 1 feasible rows at the wrap of
    # the scan (positions nvalid - 1, 0, .., limit - 1): the cutoff and
    # processedNodes straddle it; and the rows through unaligned views
    # (the kernel's scalar loads).
    wrap = state.valid & (((order.to(torch.int64) - (nvalid - 1)) % nvalid) <= limit)
    for label, unaligned in (("wrap", False), ("wrap, unaligned views", True)):
        feasible = wrap[None, :].clone()
        if int(feasible.sum()) != limit + 1:
            raise AssertionError(f"truncate wrap case: {int(feasible.sum())} feasible rows")
        outs = []
        for mod in (kernels, plain):
            st = torch.tensor([nvalid - 1], dtype=torch.int64, device=dev)
            f, v, o = feasible.clone(), state.valid, order
            if unaligned:
                f = torch.cat([torch.zeros((1, 1), dtype=torch.bool, device=dev), f], dim=1)[:, 1:]
                v = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), v])[1:]
                o = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), o])[1:]
            outs.append((*mod.truncate_feasible(f, v, o, st, real, nvalid, limit), st))
        torch.cuda.synchronize()
        for name, a, b in zip(("feasible", "pos", "processed", "start"), *outs):
            exact(errs, "truncate_feasible", f"[{label}, start {nvalid - 1}, {limit + 1} feasible] {name}", a, b)
        cut += int(feasible.sum()) - int(outs[1][0].sum())
    print(f"truncate_feasible/select_host (pos mode) [truncate]: exact; limit {limit} of {nvalid} nodes, "
          f"{cut} feasible (case, node) pairs cut")
    ncases = pos_cases(errs, dev, state, order, seed_mul, np.random.default_rng(2024))
    print(f"select_host (pos mode) [truncate]: exact; {ncases} cases across the slices and word ranges")
    # Timed on every node feasible, the start mid-list.
    feasible_all = state.valid[None, :].clone()
    result = {}
    result["truncate_feasible"] = timed(
        lambda a: kernels.truncate_feasible(a[0], state.valid, order, a[1], real, nvalid, limit),
        lambda a: plain.truncate_feasible(a[0], state.valid, order, a[1], real, nvalid, limit), reps,
        lambda: (feasible_all.clone(), torch.tensor([2777], dtype=torch.int64, device=dev)))
    tf, tpos, _ = plain.truncate_feasible(feasible_all.clone(), state.valid, order,
                                          torch.tensor([2777], dtype=torch.int64, device=dev), real, nvalid, limit)
    total = torch.from_numpy(rng.integers(0, 3, (1, n))).to(dev)
    steps = torch.from_numpy(rng.integers(0, 2**32, size=1, dtype=np.int64)).to(dev)
    result["select_host"] = timed(lambda _: kernels.select_host(tf, total, steps, seed_mul, None, tpos),
                                  lambda _: plain.select_host(tf, total, steps, seed_mul, None, tpos), reps)
    rows_mode = timed(lambda _: kernels.select_host(tf, total, steps, seed_mul, None),
                      lambda _: plain.select_host(tf, total, steps, seed_mul, None), reps)
    print(f"select_host [truncate]: pos mode {result['select_host']['ms']:.4f} ms, row mode "
          f"{rows_mode['ms']:.4f} ms on the same inputs")
    set_bound(result["truncate_feasible"], truncate_bytes(n))
    set_bound(result["select_host"], select_bytes(1, n) + 4 * n)
    result["build_dom"] = dom_at(errs, "truncate", builder, state, reps)
    shapes = {"truncate": result}

    # IPA shape: the filter launch, the cut, the score launch.
    x = ipa_inputs(4321, dev)
    istate, ipa, spec = x["state"], x["ipa"], x["spec"]
    iorder = scan_order(x["cache"], istate.valid.shape[0], dev)
    ipods = [_chunk(x["pf"], i, 1) for i in range(16)]
    isteps = torch.from_numpy(x["rng"].integers(0, 2**32, size=16, dtype=np.int64)).to(dev)

    def ipa_filt(mod, i):
        feasible, total, fail = mod.eval_chunk(istate, ipods[i], spec, None)
        return mod.ipa_eval(istate, ipods[i], feasible, total, fail, ipa, plain.IPA_FILTER)

    def ipa_score(mod, i, feasible, total, fail):
        mod.ipa_eval(istate, ipods[i], feasible, total, fail, ipa, plain.IPA_SCORE)

    _last, kept = truncated_steps(errs, "ipa", istate, ipods, iorder, isteps, seed_mul, 1234,
                                  ipa_filt, ipa_score, "ipa_eval")
    print(f"truncated steps [ipa]: exact; feasible nodes kept per pod {kept}")
    pf1 = ipods[-1]
    base = plain.eval_chunk(istate, pf1, spec, None)

    def two_launches(mod):
        def run(a):
            mod.ipa_eval(istate, pf1, *a, ipa, plain.IPA_FILTER)
            mod.ipa_eval(istate, pf1, *a, ipa, plain.IPA_SCORE)
        return run

    # Both launches of one step, timed together (the cut between them is
    # truncate_feasible's time).
    res_ipa = {"ipa_eval": timed(two_launches(kernels), two_launches(plain), reps,
                                 lambda: tuple(t.clone() for t in base))}
    # Beside them, the one launch of both phases that full evaluation makes.
    one = "ipa_eval (one launch, both phases)"
    res_ipa[one] = timed(lambda a: kernels.ipa_eval(istate, pf1, *a, ipa),
                         lambda a: plain.ipa_eval(istate, pf1, *a, ipa), reps,
                         lambda: tuple(t.clone() for t in base))
    for entry in res_ipa.values():
        set_bound(entry, ipa_bytes(istate, x["dom"], pf1))
    shapes["truncate_ipa"] = res_ipa

    # spread_na shape: the planes, eval_chunk, the cut, late_scores.
    y = spread_inputs("spread_na", 2468, dev)
    sstate = y["state"]
    prof, mpf, active = y["mixed"]["default"]
    sspec = eval_spec(prof, y["builder"].schema, y["builder"].res_col, active)
    late = late_spec(prof, y["builder"].schema, y["builder"].res_col, active)
    bits = plain.node_filters(sstate, mpf, sspec.ctx)
    sorder = scan_order(y["cache"], sstate.valid.shape[0], dev)
    spods = [_chunk(mpf, i, 1) for i in range(32)]
    sbits = [bits[i:i + 1].contiguous() for i in range(32)]
    ssteps = torch.from_numpy(y["rng"].integers(0, 2**32, size=32, dtype=np.int64)).to(dev)

    def spread_filt(mod, i):
        ok = mod.spread_filter(sstate, spods[i], sbits[i], sspec.ctx)
        return mod.eval_chunk(sstate, spods[i], sspec, None, (sbits[i], ok))

    def spread_score(mod, i, feasible, total, fail):
        mod.late_scores(sstate, spods[i], feasible, total, sbits[i], late)

    (f2, t2), kept = truncated_steps(errs, "spread_na", sstate, spods, sorder, ssteps, seed_mul, 500,
                                     spread_filt, spread_score, "late_scores")
    print(f"truncated steps [spread_na]: exact; feasible nodes kept per pod {kept}")
    pf2, b2 = spods[-1], sbits[-1]
    res_spread = {"late_scores": timed(lambda a: kernels.late_scores(sstate, pf2, f2, a, b2, late),
                                       lambda a: plain.late_scores(sstate, pf2, f2, a, b2, late), reps,
                                       lambda: t2.clone())}
    set_bound(res_spread["late_scores"], late_bytes(sstate, pf2, late, 1))
    shapes["truncate_spread"] = res_spread
    for table in shapes.values():
        for name, entry in table.items():
            entry["max_abs_err"] = errs[name.split(" ")[0]]
    return shapes


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


def term_reads(pf: dict, prefix: str, rows, grouped: bool = False):
    """What the valid terms of the programs ``prefix`` of the pods in
    ``rows`` read of a node, per pod: (keys, pairs, name) flags (K,) and
    the distinct (pod, key) pairs of its Gt/Lt requirements (K', 2).
    In/NotIn read the label pair slots, Exists/DoesNotExist the key slots,
    Gt/Lt the key slots and the integer of the slot holding the key, the
    metadata.name operators the node's name id; a pad or False reads
    nothing.  A grouped program's terms count only in a group below
    ngroups."""
    import torch

    op = pf[f"{prefix}_op"]
    live = pf[f"{prefix}_term_valid"] & rows[:, None]
    if grouped:
        group = pf[f"{prefix}_group"]
        live = live & (group >= 0) & (group < pf[f"{prefix}_ngroups"][:, None])
    op = torch.where(live[..., None], op, -1)
    ints = (op == 4) | (op == 5)
    keys = ((op >= 2) & (op <= 5)).flatten(1).any(dim=1)
    pairs = ((op >= 0) & (op <= 1)).flatten(1).any(dim=1)
    name = ((op == 6) | (op == 7)).flatten(1).any(dim=1)
    pod = torch.arange(op.shape[0], device=op.device)[:, None, None].expand_as(op)
    int_keys = torch.unique(torch.stack([pod[ints], pf[f"{prefix}_key"][ints]], dim=1), dim=0)
    return keys, pairs, name, int_keys


def nf_bytes(state, pf: dict, ctx, pin=None) -> int:
    """node_filters for this batch's data: the bits written (K x N, or K
    pinned); the selector pairs and flags, the intolerance masks and the
    volume flags and group counts; the programs of the pods with terms to
    evaluate (required or added terms; feasible volume programs with
    groups); and of the nodes (every node, or each pod's own row pinned)
    only what term_reads says their valid terms read, the label pair slots
    where a pod has a selector pair, and the taint slots where a pod has an
    intolerable taint.  A pod pinned to no row reads no program and no
    node."""
    import torch

    k, n = pf["valid"].shape[0], state.valid.shape[0]
    ls, ts = state.label_key_ids.shape[1], state.taint_ids.shape[1]
    fields = ("op", "key", "vals", "int", "term_valid")
    b = k if pin is not None else k * n
    none = torch.zeros(k, dtype=torch.bool, device=state.valid.device)
    on = ~none if pin is None else (pin >= 0) & (pin < n)
    keys, pairs, name, taints = none, none, none, none
    int_keys = []
    programs = []
    if "na_sel_pairs" in pf:
        sel, has_req = pf["na_sel_pairs"], pf["na_has_required"]
        b += nbytes(sel, has_req)
        pairs = pairs | ((sel >= 0).any(dim=1) & on)
        programs.append(("na_req", has_req & on, False))
        if ctx.profile.added_affinity is not None:
            b += nbytes(pf["na_has_added"])
            programs.append(("na_add", pf["na_has_added"] & on, False))
    if "taint_intol_hard" in pf:
        intol = pf["taint_intol_hard"]
        b += nbytes(intol)
        taints = intol.any(dim=1) & on
    for prefix in ("vb", "vz"):
        if f"{prefix}_op" in pf:
            feas, ngroups = pf[f"{prefix}_feasible"], pf[f"{prefix}_ngroups"]
            rows = feas & (ngroups > 0) & on
            b += nbytes(feas, ngroups, pf[f"{prefix}_group"][rows])
            programs.append((prefix, rows, True))
    for prefix, rows, grouped in programs:
        b += program_bytes(pf, prefix, rows, fields)
        rk, rp, rn, ri = term_reads(pf, prefix, rows, grouped)
        keys, pairs, name = keys | rk, pairs | rp, name | rn
        int_keys.append(ri)
    int_keys = torch.unique(torch.cat(int_keys), dim=0) if int_keys else torch.zeros((0, 2))
    if pin is not None:
        # Each pod's own row: its slots, name and taints as it needs them,
        # and one integer a (pod, Gt/Lt key).
        slots = int(keys.sum()) + int(pairs.sum())
        return (b + slots * ls * 4 + int(name.sum()) * 4 + int(taints.sum()) * ts * 4
                + int_keys.shape[0] * 8)
    # Every node: the key and pair slots, names and taint slots where some
    # pod needs them, and one integer a node for each distinct Gt/Lt key.
    slots = int(bool(keys.any())) + int(bool(pairs.any()))
    distinct = int(torch.unique(int_keys[:, 1]).numel()) if int_keys.shape[0] else 0
    return (b + slots * n * ls * 4 + int(bool(name.any())) * n * 4 + int(bool(taints.any())) * n * ts * 4
            + min(distinct, ls) * n * 8)


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


def search_pair_bytes(pf: dict, c: int) -> int:
    """conflict_pairs on a batch of any features: every feature array the
    kernel takes, read once, and the table written once."""
    keys = ("group", "ipa_ra_allmask", "ipa_rs_groups", "ipa_et_match", "ipa_et_anti", "ipa_own_terms",
            "tps_h_groups", "vol_dev_ids", "vol_csi_ids", "vol_unbound", "port_keys", "dra_claim_ids",
            "dra_claim_unalloc")
    return nbytes(*(pf[key] for key in keys if key in pf)) + pf["valid"].shape[0] * c


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


class VirtualClock:
    """A queue clock that moves only when the drive steps it to the next
    backoff expiry: a pod's retry then follows the pods ahead of it, not
    the wall time a run happens to take."""

    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def run_workload(impl: str, nodes, warm, measured, batch: int, chunk: int, trace: bool = False,
                 profile=None, stages=(), preempt: bool = False, setup=None, feed=None, wait: bool = False,
                 sched_kw=None, virtual: bool = False, then=None):
    """One burst through TorchScheduler: the nodes, ``setup(s)`` (objects
    and pods of a warm-up that needs more than pods), the warm-up pods
    (scheduled first, then each of ``stages`` in turn), then the measured
    pods (or what ``feed(s)`` adds), timed, and inside the same window what
    ``then(s)`` adds once they are drained.  ``preempt`` runs the fit-only profile with the
    reference's 1 s doubling backoff on the wall clock and waits through
    it (``wait_backoff``); ``wait`` does the latter for any profile, and
    ``virtual`` waits on a VirtualClock instead (each backoff expiry
    stepped to once nothing else is pending, so two runs pop the same
    batches); ``sched_kw`` holds more TorchScheduler options.  With ``trace``, the measured window also
    records host spans (featurize, the host-to-device copies of the batch
    features, the result fetch that waits for the device, the victim packs
    of preemption, and the rest of each schedule_batch call) and a
    torch.profiler trace of the card's kernels.  Data moves are counted over the whole run: torch's
    index_copy_ and expand calls (there should be none) beside the
    scatter_rows and expand_rows launches that replace them; whole-state
    uploads are counted inside the measured window."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import scheduler as sched_mod
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE, fit_only_profile
    from kubernetes_tpu_torch.queue import SchedulingQueue

    kw = dict(sched_kw or {})
    if preempt:
        profile = fit_only_profile()
    wait = wait or preempt
    clock = VirtualClock() if virtual else None
    if wait or virtual:
        kw["queue"] = SchedulingQueue(backoff=True, **({"clock": clock} if virtual else {}))
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

    def drain():
        if clock is None:
            return s.schedule_all_pending(wait_backoff=wait)
        got = []
        while True:
            got += s.schedule_all_pending()
            expiry = s.queue.next_backoff_expiry()
            if expiry is None:
                return got
            window["virtual_s"] += max(0.0, expiry - clock.now)
            window["virtual_steps"] += 1
            clock.now = max(clock.now, expiry)

    window = {"virtual_s": 0.0, "virtual_steps": 0}
    launches0 = kernels.launch_counts()
    torch.Tensor.index_copy_, torch.Tensor.expand = index_copy_, expand
    try:
        for node in nodes:
            s.add_node(node)
        if setup is not None:
            setup(s)
        for pod in warm:
            s.add_pod(pod)
        out = drain()
        for stage in stages:
            for pod in stage:
                s.add_pod(pod)
            out += drain()
        torch.cuda.synchronize()
        if feed is not None:
            feed(s)
        for pod in measured:
            s.add_pod(pod)
        spans = {"featurize": 0.0, "h2d": 0.0, "batch": 0.0, "fetch": 0.0, "pack": 0.0}
        h2d_bytes = [0]
        # The window's wall-clock waits: backoff slept through, pods sent
        # to the backoff queue, and the garbage collector's pauses.
        window = {"backoff_s": 0.0, "sleeps": 0, "to_backoff": 0, "gc_s": 0.0, "gc_runs": 0, "gc_full": 0,
                  "gc_before_s": 0.0, "virtual_s": 0.0, "virtual_steps": 0}
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
            s.preemption.pack_victims = span("pack", s.preemption.pack_victims)
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
        measured_out = drain()
        if then is not None:
            then(s)
            measured_out += drain()
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
    # Row flushes of the device mirror and their host-to-device copies,
    # and the victim buffer's row scatters: with the kernels, every
    # scatter_rows launch is one of the two.
    moves["flushes"], moves["flush_copies"] = s.builder.flushes, s.builder.flush_copies
    moves["victim_scatters"] = s.preemption.victim_scatters
    flushes = max(moves["flushes"], 1)
    moves["copies_per_flush"] = moves["flush_copies"] / flushes
    moves["launches_per_flush"] = (moves["scatter_rows"] - moves["victim_scatters"]) / flushes
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
                 "other_host_s": other, "pack_s": spans["pack"], "backoff_s": window["backoff_s"],
                 "device_ms_by_kernel": device}
    # Pods bound in the window (a nominated preemptor's retry is one pod).
    bound = len({o.pod.uid for o in measured_out if o.node_name})
    return s, out + measured_out, bound, dt, spans


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


def run_search(impl: str, trace: bool = False):
    """preemption_default_search_5kn (no harness counterpart): 5000 nodes
    in 10 zones holding 20000 batch pods, bound four a node as they arrive
    (search_fill), the warm-up preemptor, then 500 service preemptors
    (half the workload's 1000, for the script's time);
    default profile, nominate-and-retry, the backoff waited on a virtual
    clock: preemptors a dry-run left without a node are
    parked, woken by a later eviction and retried behind backoff, and on
    the wall clock their retries would land in whichever batch a run's
    speed put them."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.search_nodes(), w.search_fill(),
                        [w.search_preemptor(f"vip-{i}") for i in range(w.SEARCH_MEASURED_PODS)],
                        w.SEARCH_BATCH, w.SEARCH_CHUNK, trace, stages=([w.search_preemptor("warm-vip")],),
                        virtual=True, sched_kw={"inline_preempt_commit": False})


def check_search(s, outcomes, expected: int, label: str) -> dict:
    """preemption_default_search_5kn's gates on top of check_preemption's
    (every preemptor binds, every victim a priority-1 background pod, no
    node over its allocatable, the host mirror equal to the device state):
    no two pods on a node hold port 8080, no app=svc pod shares a node with
    a tier=noisy pod or with a pod whose anti-affinity names app=svc, the
    app=svc zone counts differ by at most 1, and no whole-state upload in
    the window."""
    from kubernetes_tpu_torch import workloads as w

    bind = check_preemption(s, outcomes, expected, label)
    bad = port_conflicts(s)
    if bad:
        raise AssertionError(f"{label}: {len(bad)} host-port conflicts on one node, e.g. {bad[:3]}")
    by_node: dict = {}
    for pr in s.cache.pods.values():
        by_node.setdefault(pr.node_name, []).append(pr.pod)
    zones: dict = {}
    for node, pods in by_node.items():
        if not any(p.metadata.labels.get("app") == "svc" for p in pods):
            continue
        zone = s.cache.nodes[node].node.metadata.labels[w.ZONE]
        zones[zone] = zones.get(zone, 0) + sum(p.metadata.labels.get("app") == "svc" for p in pods)
        for p in pods:
            aff = p.spec.affinity
            keeps_off = aff is not None and aff.pod_anti_affinity is not None and any(
                r.values == ("svc",) for term in aff.pod_anti_affinity.required
                for r in term.label_selector.match_expressions)
            if p.metadata.labels.get("tier") == "noisy" or keeps_off:
                raise AssertionError(f"{label}: app=svc shares {node} with {p.name}")
    skew = max(zones.values()) - min(zones.values()) if len(zones) == w.SEARCH_ZONES else None
    if skew is None or skew > 1:
        raise AssertionError(f"{label}: app=svc zone counts {sorted(zones.items())}")
    if s.window["full_uploads"]:
        raise AssertionError(f"{label}: {s.window['full_uploads']} whole-state uploads in the measured window")
    print(f"{label}: app=svc zone counts {sorted(zones.values())} (skew {skew}), no port or anti-affinity "
          f"clash; {s.preemptions} preemptions")
    return bind


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


def run_parity(impl: str, trace: bool = False):
    """parity_basic_5kn_10kpods (harness.py:396-405 in truncated mode): the
    density cluster and pods, batch 1024, chunk 1, the default profile with
    the adaptive percentage of nodes to score."""
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE

    profile = dataclasses.replace(DEFAULT_PROFILE, percentage_of_nodes_to_score=w.PARITY_PCT)
    return run_workload(impl, w.basic_nodes(w.PARITY_NODES, zones=w.PARITY_ZONES), w.warm_pods(w.PARITY_WARM_PODS),
                        [w.pod_basic(i) for i in range(w.PARITY_MEASURED_PODS)], w.PARITY_BATCH, w.PARITY_CHUNK,
                        trace, profile=profile)


def check_parity(s, outcomes, expected: int, label: str) -> dict:
    """parity_basic_5kn_10kpods' gates on top of check_density's: no node
    ever filled (fewer than 17 pods of 900m on each 16-CPU node at the end,
    so all 5000 stayed feasible), so every pod's scan kept exactly
    min(500, 5000) = 500 feasible nodes (the pass's feasible count); the
    scan start moved; no whole-state upload in the window.  The bindings
    returned carry the final scan start, so every run must end on the same
    one."""
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.kernels import plain

    bind = check_density(s, outcomes, expected, label)
    h = s.builder.host
    limit = int(plain.num_to_find(torch.tensor(w.PARITY_NODES, dtype=torch.int32), 0))
    fullest = int(h["num_pods"][h["valid"]].max())
    kept = {o.feasible_nodes for o in outcomes}
    if fullest >= 17 or kept != {min(limit, w.PARITY_NODES)}:
        raise AssertionError(f"{label}: feasible counts {sorted(kept)} (want {limit}), fullest node {fullest} pods")
    if s._next_start == 0:
        raise AssertionError(f"{label}: the scan start never moved")
    if s.window["full_uploads"]:
        raise AssertionError(f"{label}: {s.window['full_uploads']} whole-state uploads in the measured window")
    print(f"{label}: every pod kept {limit} feasible nodes of its scan, fullest node {fullest} pods, final scan "
          f"start {s._next_start}")
    return {**bind, "(final scan start)": s._next_start}


def run_dra(impl: str, trace: bool = False):
    """dra_claims_5kn_5kpods (no harness counterpart) at half the depth it
    was written for: 2500 nodes in 10 zones, one in four publishing 8 GPUs;
    512 claim-less fill pods, then 2500 pods with their own claims, then
    128 preemptors each wanting a
    whole GPU node; default profile, the backoff waited on a virtual clock
    (a pod whose same-batch reservation lost, such as the second pod of a
    claim-sharing pair placed away from the claim, retries behind it)."""
    from kubernetes_tpu_torch import workloads as w

    def feed(s):
        for claim in w.dra_claims():
            s.add_resource_claim(claim)

    def then(s):
        for claim in w.dra_preemptor_claims():
            s.add_resource_claim(claim)
        for i in range(w.DRA_PREEMPTORS):
            s.add_pod(w.dra_preemptor(i))

    return run_workload(impl, w.basic_nodes(w.DRA_NODES, zones=w.DRA_ZONES), w.warm_pods(w.DRA_FILL_PODS),
                        [w.dra_pod(i) for i in range(w.DRA_MEASURED_PODS)], w.DRA_BATCH, w.DRA_CHUNK, trace,
                        setup=w.dra_setup, feed=feed, then=then, virtual=True)


def check_dra(s, outcomes, expected: int, label: str) -> dict:
    """dra_claims_5kn_5kpods's gates: every claim pod binds or was evicted
    by a preemptor, every preemptor binds, every evicted pod is a priority-1
    claim pod whose claim no longer names it; every claim of a bound pod is
    allocated on the pod's node to devices that node publishes and owns
    them (h100 ones for an h100 claim); the pods of a shared claim share a
    node; per node and pool dra_alloc stays within dra_cap and equals the
    catalog's count of owned devices matching the pool; no node exceeds
    its allocatable; the host mirror equals the device state; no
    whole-state upload in the window.  Returns the bindings with the victims
    of every preemption."""
    from kubernetes_tpu_torch import dra_cel
    from kubernetes_tpu_torch import workloads as w

    bind = {}
    for o in outcomes:
        bind[o.pod.name] = (o.node_name, tuple(sorted(o.victim_uids)))
    bound = {pr.pod.name: pr.node_name for pr in s.cache.pods.values()}
    evicted = {v for v, _p, _n in s.preempted}
    lost = [f"gpu-{i}" for i in range(w.DRA_MEASURED_PODS)
            if f"gpu-{i}" not in bound and f"default/gpu-{i}" not in evicted]
    vips = [f"vip-{i}" for i in range(w.DRA_PREEMPTORS) if f"vip-{i}" not in bound]
    if lost or vips or w.DRA_MEASURED_PODS + w.DRA_PREEMPTORS != expected:
        raise AssertionError(f"{label}: unbound claim pods {lost[:5]}, unbound preemptors {vips[:5]}")
    cat = s.builder.dra
    h100 = 0
    for pr in s.cache.pods.values():
        for claim in cat.pod_claims(pr.pod):
            owners = cat.device_owner.get((pr.node_name, w.DRA_CLASS), {})
            devs = cat.devices.get((pr.node_name, w.DRA_CLASS), {})
            req = claim.device_requests()[0]
            ok = claim.allocated_node == pr.node_name and len(claim.allocated_devices) == req.count and all(
                d in devs and owners.get(d) == claim.uid for _r, d in claim.allocated_devices)
            if req.selectors:
                ok = ok and all(devs[d]["model"] == "h100" for _r, d in claim.allocated_devices)
                h100 += 1
            if not ok:
                raise AssertionError(f"{label}: claim {claim.uid} of {pr.pod.name} on {pr.node_name}: "
                                     f"{claim.allocated_node} {claim.allocated_devices}")
    pairs = 0
    for i in range(1, w.DRA_MEASURED_PODS, w.DRA_SHARE_EVERY):
        a, b = f"gpu-{i - 1}", f"gpu-{i}"
        if a in bound and b in bound:
            pairs += 1
            if bound[a] != bound[b]:
                raise AssertionError(f"{label}: {a} on {bound[a]} and {b} on {bound[b]} share a claim")
    for vic in evicted:
        name = vic.split("/", 1)[1]
        claim = cat.claims.get(f"default/{w.dra_claim_of(int(name.split('-')[1]))}") if name.startswith("gpu-") else None
        if claim is None or vic in claim.reserved_for:
            raise AssertionError(f"{label}: victim {vic} is not a released priority-1 claim pod")
    h = s.builder.host
    if (h["dra_alloc"] > h["dra_cap"]).any():
        raise AssertionError(f"{label}: a pool's dra_alloc exceeds its dra_cap")
    it = s.interns.device_classes
    for sig, (cls, reqs) in cat.pools.items():
        want = {}
        for (node, c), owners in cat.device_owner.items():
            if c == cls:
                want[s.cache.row_of(node)] = sum(dra_cel.matches(reqs, cat.devices[(node, c)][d]) for d in owners)
        got = h["dra_alloc"][it.id(sig)]
        if any(int(got[row]) != cnt for row, cnt in want.items()) or int(got.sum()) != sum(want.values()):
            raise AssertionError(f"{label}: dra_alloc of pool {sig} differs from the catalog's owned devices")
    if not s.builder.host_mirror_equal():
        raise AssertionError(f"{label}: host mirror differs from the device state")
    v = h["valid"]
    if (h["req"][v] > h["alloc"][v]).any() or (h["num_pods"][v] > h["allowed_pods"][v]).any():
        raise AssertionError(f"{label}: a node exceeds its allocatable")
    if s.window["full_uploads"]:
        raise AssertionError(f"{label}: {s.window['full_uploads']} whole-state uploads in the measured window")
    print(f"{label}: {len(bound)} pods bound, {h100} h100 claims on h100 devices, {pairs} shared pairs "
          f"co-located, {len(evicted)} victims released, {s.preemptions} preemptions, {s.reserve_failures} lost "
          f"reservations, {int(h['dra_alloc'][it.id(w.DRA_CLASS)].sum())} devices allocated, CLM={s.builder.schema.CLM} "
          f"DC={s.builder.schema.DC}")
    return bind


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


# -- the "ports/images" shape (default_images_ports_5kn_10kpods) ----------------


def ports_images_inputs(dev, nodes: int = 5000, k: int = 4096, bound: int = 6000):
    """The "ports/images" shape: the workload's 5000 nodes (8192 rows), each
    reporting 50 of the 400 pool images under two names (IM = 128 slots);
    6000 bound pods, one in three holding one host port out of the ten
    (protocol, hostIP, port) triples (P = PK = 16), so some nodes hold a
    port twice; then a 4096-pod batch, one pod in 8 with 1-3 host ports,
    each pod with 1-3 containers naming pool images by tag (every tenth
    untagged, every 29th an image no node reports, every seventh the same
    image twice) and every eighth an init container, featurized under the
    default profile (twice: the second pass sees the final vocabularies)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    rng = np.random.default_rng(61)
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    for node in w.images_nodes(nodes):
        cache.add_node(node)
    pool, weights = w.image_pool()
    triples = [(proto, ip, port) for proto, port in w.HOST_PORTS for ip in ("", w.SPECIFIC_IP)]

    def with_ports(pw, count):
        for q in rng.choice(len(triples), count, replace=False):
            proto, ip, port = triples[q]
            pw = pw.host_port(port, protocol=proto, host_ip=ip)
        return pw

    for j in range(bound):
        pw = make_pod(f"bound-{j}").req({"cpu": "100m", "memory": "256Mi"})
        pw = with_ports(pw, 1 if j % 3 == 0 else 0)
        cache.add_pod(pw.node(f"node-{int(rng.integers(nodes))}").obj())
    latest = [pool[i][0].rsplit(":", 1)[0] for i in range(len(pool)) if pool[i][0].endswith(":latest")]
    pods, refs_made = [], 0
    for i in range(k):
        pw = make_pod(f"p{i}").req({"cpu": f"{int(rng.choice([100, 900, 2000]))}m", "memory": "1Gi"})
        if i % 8 == 3:
            pw = with_ports(pw, 1 + int(rng.integers(3)))
        pod = pw.label("app", f"a{i % 11}").obj()
        refs = []
        for _ in range(1 + int(rng.integers(3))):
            refs_made += 1
            if refs_made % 10 == 0:
                refs.append(latest[int(rng.integers(len(latest)))])
            elif refs_made % 29 == 0:
                refs.append(f"registry.example.com/scratch/tool-{i}:v0")
            else:
                refs.append(pool[int(rng.choice(len(pool), p=weights))][0])
        if i % 7 == 2:
            refs.append(refs[0])
        pod.spec.containers[0].images = tuple(refs[:1])
        pod.spec.containers += [t.Container(name=f"c{q}", images=(r,)) for q, r in enumerate(refs[1:], 1)]
        if i % 8 == 5:
            pod.spec.init_containers.append(t.Container(name="init", images=(pool[int(rng.integers(40))][0],)))
        pods.append(pod)
    for _ in range(2):
        batch, _, active = build_pod_batch(pods, builder, DEFAULT_PROFILE, k)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {key: to(v) for key, v in batch.items()}
    pf["nominated_row"] = to(np.full(k, -1, np.int32))
    return builder, builder.state(), pf, active, rng


def image_counts_bytes(state, vocab: int) -> int:
    """image_counts: the id table and validity read once, the counts written."""
    return nbytes(state.image_ids, state.valid) + (vocab + 1) * 4


def image_scores_bytes(state, pf: dict, counts, pin=None) -> int:
    """image_scores: the pods' ids, container counts and validity read, the
    counts of their ids (unpinned), the id rows of the nodes scored (all,
    or each pod's pinned row), and the size of each slot that holds a
    wanted id of a valid pod read; the plane written (one byte a pair)."""
    import torch

    ids, valid = pf["il_image_ids"], pf["valid"]
    k = ids.shape[0]
    n, im = state.image_ids.shape
    b = nbytes(ids, pf["il_ncontainers"], valid)
    if pin is None:
        want = torch.unique(ids[(ids >= 0) & valid[:, None]])
        hits = int(torch.isin(state.image_ids, want).sum())  # slots whose size some pod reads
        return b + int(want.numel()) * 4 + 4 + nbytes(state.image_ids) + hits * 8 + k * n
    rows = pin.long()
    own = state.image_ids[rows]  # (K, IM)
    hits = int(((own[:, :, None] == ids[:, None, :]) & (ids >= 0)[:, None, :] & valid[:, None, None]).any(2).sum())
    return b + pin.numel() * 4 + int(torch.unique(rows).numel()) * (im * 4 + 1) + hits * 8 + k


def port_eval_bytes(state, pf: dict) -> int:
    """NodePorts inside eval_chunk: the chunk's wants read once, and one
    node row of counts per distinct count row a want reads (port_counts at
    each specific want's triple and wildcard triple, portkey_counts at each
    wildcard want's key)."""
    import torch

    if "port_triples" not in pf:
        return 0
    tr, keys, wild, is_w = (pf[k] for k in ("port_triples", "port_keys", "port_wild_triples", "port_is_wild"))
    act = tr >= 0
    n = state.valid.shape[0]
    exact_rows = torch.unique(torch.cat([tr[act & ~is_w], wild[act & ~is_w]]))
    key_rows = torch.unique(keys[act & is_w])
    return nbytes(tr, keys, wild, is_w) + (int(exact_rows.numel()) + int(key_rows.numel())) * n * 4


def port_commit_bytes(pf: dict, placed) -> int:
    """The port part of resolve_commit: the triples and keys read, and one
    read and one write of each distinct port_counts and portkey_counts cell
    a placed pod's wants touch."""
    import torch

    if "port_triples" not in pf:
        return 0
    tr, keys = pf["port_triples"], pf["port_keys"]
    use = (tr >= 0) & (placed >= 0)[:, None]
    rows = placed.clamp(min=0).long()[:, None]
    cells = int(torch.unique((tr.long() * 2**20 + rows)[use]).numel())
    cells += int(torch.unique((keys.long() * 2**20 + rows)[use]).numel())
    return nbytes(tr, keys) + cells * 8


def port_pair_bytes(pf: dict, c: int) -> int:
    """conflict_pairs on a port batch: the groups and keys read once, the
    table written once."""
    k = pf["valid"].shape[0]
    return nbytes(pf["group"], pf["port_keys"]) + k * c


def threshold_cases():
    """(valid nodes T, nodes holding the image c, size S) with S * c / T
    exactly 1000 MiB as rationals: one whose f64 product lands on it and
    one whose product falls an ulp below it (int64 truncation then loses 1
    and the score drops from 100 to 99)."""
    import numpy as np

    from kubernetes_tpu_torch.ops.imagelocality import MAX_CONTAINER_THRESHOLD as x

    on = below = None
    for total in range(3, 40):
        for cnt in range(1, total):
            if (x * total) % cnt:
                continue
            size = x * total // cnt
            got = np.float64(size) * (np.float64(cnt) / np.float64(total))
            if got == x and on is None:
                on = (total, cnt, size)
            elif got < x and below is None:
                below = (total, cnt, size)
    return on, below


def image_rounding(dev, errs: dict) -> None:
    """ImageLocality's rounding cases through image_counts and image_scores
    on the card, against their plain versions and the expected scores: a
    size x spread product exactly on the 1000 MiB threshold and one an ulp
    below it, sums at 23 MiB - 1, 23 MiB, 1000 MiB x n and + 1, and a pod
    naming the same image twice."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import Profile
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.ops.imagelocality import MAX_CONTAINER_THRESHOLD as mx
    from kubernetes_tpu_torch.ops.imagelocality import MB, MIN_THRESHOLD as mn
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    on, below = threshold_cases()
    if on is None or below is None:
        raise AssertionError(f"rounding: no threshold case found ({on}, {below})")
    twice = 100 * (2 * 400 * MB - mn) // (2 * mx - mn)
    cases = [("product on 1000 MiB", *on, 1, False, 100), ("product an ulp below", *below, 1, False, 99),
             ("23 MiB - 1", 4, 4, mn - 1, 1, False, 0), ("23 MiB", 4, 4, mn, 1, False, 0),
             ("1000 MiB x 2", 4, 4, 2 * mx, 2, False, 100), ("1000 MiB x 2 + 1", 4, 4, 2 * mx + 1, 2, False, 100),
             ("1000 MiB x 2 - 1", 4, 4, 2 * mx - 1, 2, False, 99), ("same image twice", 4, 4, 400 * MB, 2, True, twice)]
    profile = Profile(name="il", filters=("NodeResourcesFit",), scorers=(("ImageLocality", 1),))
    for label, total, cnt, size, ncont, dup, want in cases:
        builder = SnapshotBuilder(device=dev)
        cache = Cache(builder)
        for i in range(total):
            nw = make_node(f"n{i}").capacity({"cpu": "4", "pods": 110})
            cache.add_node((nw.image("img:v1", size) if i < cnt else nw).obj())
        pod = make_pod("p").req({"cpu": "1"}).container_image("img:v1").obj()
        pod.spec.containers += [t.Container(name=f"c{q}", images=("img:v1",) if dup else ()) for q in range(1, ncont)]
        batch, _, _ = build_pod_batch([pod], builder, profile, 8)
        pf = {key: torch.from_numpy(v).to(dev) for key, v in batch.items()}
        state = builder.state()
        vocab = len(builder.interns.images)
        kc, pc = kernels.image_counts(state, vocab), plain.image_counts(state, vocab)
        ks, ps = kernels.image_scores(state, pf, pc), plain.image_scores(state, pf, pc)
        torch.cuda.synchronize()
        exact(errs, "image_counts", f"[rounding: {label}]", kc, pc)
        exact(errs, "image_scores", f"[rounding: {label}]", ks, ps)
        if int(ps[0, 0]) != want:
            raise AssertionError(f"rounding {label}: score {int(ps[0, 0])}, want {want}")
    print(f"image_counts/image_scores [rounding]: exact; {len(cases)} cases (threshold products {on} on, "
          f"{below} an ulp below)")


def check_ports_images_kernels(dev, reps: int, explain: dict | None = None, **sizes) -> dict:
    """Phase 3, the "ports/images" shape (C=64, N=8192, a 4096-pod batch;
    ports_images_inputs): image_counts and image_scores over the batch,
    conflict_pairs with the port keys over its 64 chunks, and per chunk
    (every eighth) eval_chunk with NodePorts and the image plane and
    select_host; resolve_commit strict and not with the port commit on
    chunks whose picks crowd a few rows (port pods on one row among them);
    then the rounding cases; all against their plain versions, exactly.
    Returns the timings (the batch kernels on the batch, the rest on chunk
    0) with their bounds.  With ``explain`` (a dict), also the "explain_il"
    shape into it (check_explain_il)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import build_dom, eval_spec, filter_op_names
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    builder, state, big, active, rng = ports_images_inputs(dev, **sizes)
    schema = builder.schema
    errs: dict[str, float] = {}
    c, n, k = 64, state.valid.shape[0], big["valid"].shape[0]
    spec = eval_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    if "NodePorts" not in spec.filters or plain.IL not in dict(spec.scorers):
        raise AssertionError(f"ports/images shape: filters {spec.filters}, scorers {spec.scorers}")
    vocab = len(builder.interns.images)
    kc, pc = kernels.image_counts(state, vocab), plain.image_counts(state, vocab)
    ks, ps = kernels.image_scores(state, big, pc), plain.image_scores(state, big, pc)
    kp, pp = kernels.conflict_pairs(big, k // c, c), plain.conflict_pairs(big, k // c, c)
    torch.cuda.synchronize()
    exact(errs, "image_counts", "[ports/images]", kc, pc)
    exact(errs, "image_scores", "[ports/images batch]", ks, ps)
    exact(errs, "conflict_pairs", "[ports/images batch]", kp, pp)
    bit = 1 << filter_op_names(DEFAULT_PROFILE, active).index("NodePorts")
    stats = {"pairs": int(pp.sum()), "plane_nonzero": int((ps > 0).sum()), "ports_rejects": 0,
             "deferred": 0, "committed": 0}
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    first = None
    for i in range(0, k // c, 8):
        pf = _chunk(big, i, c)
        il = ps[i * c:(i + 1) * c].contiguous()
        ke = kernels.eval_chunk(state, pf, spec, None, (None, None, None, il))
        pe = plain.eval_chunk(state, pf, spec, None, (None, None, None, il))
        torch.cuda.synchronize()
        for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
            exact(errs, "eval_chunk", f"[ports/images chunk {i}] {what}", a, b)
        stats["ports_rejects"] += int(((pe[2] & bit) != 0).sum())
        steps = torch.from_numpy(rng.integers(0, 2**32, size=c, dtype=np.int64)).to(dev)
        ksel = kernels.select_host(pe[0], pe[1], steps, seed_mul, pf["nominated_row"])
        psel = plain.select_host(pe[0], pe[1], steps, seed_mul, pf["nominated_row"])
        torch.cuda.synchronize()
        for what, a, b in zip(("pick", "best", "feasible_count"), ksel, psel):
            exact(errs, "select_host", f"[ports/images chunk {i}] {what}", a, b)
        if first is None:
            first = (pf, il, psel[0], pe, steps)
    et_slot = torch.zeros(schema.ET, dtype=torch.int32, device=dev)
    dom = build_dom(state, et_slot, torch.zeros(schema.ET, dtype=torch.bool, device=dev), schema.DV)
    fields = ("req", "nonzero_req", "num_pods", "group_counts", "port_counts", "portkey_counts")
    crowd = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)
    commit_cases = []
    for i in range(0, k // c, 8):
        pf = _chunk(big, i, c)
        picks = crowd[torch.from_numpy(rng.integers(0, 4, size=c)).to(dev)]
        picks[::13] = -1
        commit_cases.append((f"chunk {i}", pf, picks, kp[i]))
    pf0, il0, picks0, pe0, steps0 = first
    commit_cases.append(("chunk 0 picks", pf0, picks0, kp[0]))
    placed = None
    for label, pf, picks, pairs in commit_cases:
        for strict in (False, True):
            sk, dk = state.clone(), clone_dom(dom)
            sp, dp = state.clone(), clone_dom(dom)
            ok_ = kernels.resolve_commit(sk, dk, pf, picks, pairs, strict)
            op_ = plain.resolve_commit(sp, dp, pf, picks, pairs, strict)
            torch.cuda.synchronize()
            exact(errs, "resolve_commit", f"[ports/images {label}] (strict={strict}) picks", ok_, op_)
            for f in fields:
                exact(errs, "resolve_commit", f"[ports/images {label}] (strict={strict}) state.{f}",
                      getattr(sk, f), getattr(sp, f))
            if not strict:
                stats["deferred"] += int((op_ == -2).sum())
                if placed is None:
                    placed = op_
            stats["committed"] += int((op_ >= 0).sum())
    image_rounding(dev, errs)
    _l, pfc, pickc, pairc = commit_cases[0]
    result = {
        "image_counts": timed(lambda _: kernels.image_counts(state, vocab),
                              lambda _: plain.image_counts(state, vocab), reps),
        # The plain plane takes most of a second a call here: 3 calls.
        "image_scores": timed(lambda _: kernels.image_scores(state, big, pc),
                              lambda _: plain.image_scores(state, big, pc), reps, plain_reps=3),
        "conflict_pairs": timed(lambda _: kernels.conflict_pairs(big, k // c, c),
                                lambda _: plain.conflict_pairs(big, k // c, c), reps),
        "eval_chunk": timed(lambda _: kernels.eval_chunk(state, pf0, spec, None, (None, None, None, il0)),
                            lambda _: plain.eval_chunk(state, pf0, spec, None, (None, None, None, il0)), reps),
        "select_host": timed(lambda _: kernels.select_host(pe0[0], pe0[1], steps0, seed_mul, pf0["nominated_row"]),
                             lambda _: plain.select_host(pe0[0], pe0[1], steps0, seed_mul, pf0["nominated_row"]),
                             reps),
        "resolve_commit": timed(
            lambda a: kernels.resolve_commit(a[0], a[1], pfc, pickc, pairc, False),
            lambda a: plain.resolve_commit(a[0], a[1], pfc, pickc, pairc, False), reps,
            lambda: (state.clone(), clone_dom(dom))),
    }
    set_bound(result["image_counts"], image_counts_bytes(state, vocab))
    set_bound(result["image_scores"], image_scores_bytes(state, big, pc))
    set_bound(result["conflict_pairs"], port_pair_bytes(big, c))
    set_bound(result["eval_chunk"], eval_bytes(state, pf0, None) + port_eval_bytes(state, pf0) + c * n)
    set_bound(result["resolve_commit"], commit_bytes(schema, pickc, c) + port_commit_bytes(pfc, placed))
    set_bound(result["select_host"], select_bytes(c, n))
    result["build_dom"] = dom_at(errs, "ports/images", builder, state, reps)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    keys = {key: tuple(big[key].shape) for key in big if key.startswith(("port_", "il_"))}
    print(f"ports/images shapes: C={c}, N={n}, K={k}, P={schema.P}, PK={schema.PK}, IM={schema.IM}, "
          f"image vocabulary {vocab}; features {keys}; {stats}")
    if explain is not None:
        explain.update(check_explain_il(dev, builder, reps))
    return result


def check_explain_il(dev, builder, reps: int) -> dict:
    """The "explain_il" shape: image_counts and image_scores of the explain
    phase's batch (explain_mixed_pods: 1025 pods, one in eight naming two
    pool images, in a 4096-lane batch, as the images path's batch size
    pads it) on the "ports/images" cluster, exactly against their plain
    versions, and timed."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    pods = explain_mixed_pods(np.random.default_rng(23))
    for _ in range(2):  # the second pass sees the final vocabularies
        batch, _, _ = build_pod_batch(pods, builder, DEFAULT_PROFILE, w.IMAGES_BATCH)
    pf = {key: torch.from_numpy(np.ascontiguousarray(batch[key])).to(dev)
          for key in ("il_image_ids", "il_ncontainers", "valid")}
    state = builder.state()
    vocab = len(builder.interns.images)
    errs: dict[str, float] = {}
    kc, pc = kernels.image_counts(state, vocab), plain.image_counts(state, vocab)
    ks, ps = kernels.image_scores(state, pf, pc), plain.image_scores(state, pf, pc)
    torch.cuda.synchronize()
    exact(errs, "image_counts", "[explain_il]", kc, pc)
    exact(errs, "image_scores", "[explain_il]", ks, ps)
    naming = int(((pf["il_image_ids"] >= 0).any(dim=1) & pf["valid"]).sum())
    print(f"image_counts/image_scores [explain_il]: exact; K={ps.shape[0]} lanes, {int(pf['valid'].sum())} pods, "
          f"{naming} naming images, {int((ps > 0).sum())} pairs scoring")
    result = {
        "image_counts": timed(lambda _: kernels.image_counts(state, vocab),
                              lambda _: plain.image_counts(state, vocab), reps),
        # The plain plane computes every lane: 3 calls.
        "image_scores": timed(lambda _: kernels.image_scores(state, pf, pc),
                              lambda _: plain.image_scores(state, pf, pc), reps, plain_reps=3),
    }
    set_bound(result["image_counts"], image_counts_bytes(state, vocab))
    set_bound(result["image_scores"], image_scores_bytes(state, pf, pc))
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    return {"explain_il": result}


def run_images_ports(impl: str, trace: bool = False):
    """default_images_ports_5kn_10kpods (no harness counterpart): 5000
    nodes reporting 50 images each, 2048 warm-up and 10000 measured pods
    naming images, one in 32 with a host port."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.images_nodes(w.IMAGES_NODES), w.warm_pods(w.IMAGES_WARM_PODS, w.pod_images_ports),
                        [w.pod_images_ports(i) for i in range(w.IMAGES_MEASURED_PODS)],
                        w.IMAGES_BATCH, w.IMAGES_CHUNK, trace)


def port_conflicts(s) -> list:
    """(node, pod, pod) for every two pods on one node whose host ports
    conflict under HostPortInfo.CheckConflict: one protocol and port, and
    the same hostIP or either the wildcard."""
    uses: dict = {}
    for pr in s.cache.pods.values():
        for proto, ip, port in pr.pod.host_ports():
            uses.setdefault((pr.node_name, proto, port), []).append((pr.pod.name, ip))
    bad = []
    for (node, _proto, _port), held in uses.items():
        for a in range(len(held)):
            for b in range(a + 1, len(held)):
                if held[a][1] == held[b][1] or "0.0.0.0" in (held[a][1], held[b][1]):
                    bad.append((node, held[a][0], held[b][0]))
    return bad


def check_images_ports(s, outcomes, expected: int, label: str) -> dict:
    """The path's gates on top of check_density's: no node holds two pods
    whose host ports conflict (checked on the host from the bindings), the
    port and image tables did not grow in the measured window (no
    whole-state upload)."""
    bind = check_density(s, outcomes, expected, label)
    bad = port_conflicts(s)
    if bad:
        raise AssertionError(f"{label}: {len(bad)} host-port conflicts on one node, e.g. {bad[:3]}")
    if s.window["full_uploads"]:
        raise AssertionError(f"{label}: {s.window['full_uploads']} whole-state uploads in the measured window")
    h = s.builder.host
    ported = sum(bool(pr.pod.host_ports()) for pr in s.cache.pods.values())
    scores = {o.score for o in outcomes}
    print(f"{label}: {ported} pods with host ports bound, 0 conflicts, {int(h['port_counts'].sum())} port "
          f"uses on {int((h['port_counts'].sum(axis=0) > 0).sum())} nodes; {len(scores)} distinct scores; "
          f"P={s.builder.schema.P} PK={s.builder.schema.PK} IM={s.builder.schema.IM}, image vocabulary "
          f"{len(s.interns.images)}")
    return bind



# -- RequestedToCapacityRatio, the heterogeneity scorers, the filter range ----------


def _term_bytes(state, pf: dict, nom, learned: bool = False) -> int:
    """eval_chunk with the throughput (and learned) terms: eval_bytes plus
    topo_vals, the pods' score tables and slots (and requests) read once."""
    extra = nbytes(state.topo_vals, pf["tp_scores"], pf["tp_slot"])
    if learned:
        extra += nbytes(pf["ls_req_cpu"], pf["ls_req_mem"])
    return eval_bytes(state, pf, nom) + extra


def learned_ops(c: int, n: int, hidden: int) -> int:
    """The learned term's f32 operations per launch: five features (two
    subtractions, five divisions, three max, one conversion-free gather),
    2 x 5 x H for the hidden sums, H tanh, 2H for the output sum, four for
    the sigmoid and two for the rounding (a transcendental counted as one)."""
    return c * n * (10 + 2 * 5 * hidden + hidden + 2 * hidden + 4 + 2)


def check_rtcr_kernels(dev, reps: int) -> dict:
    """eval_chunk with NodeResourcesFit's RequestedToCapacityRatio strategy
    at the density shape (C=64, N=8192): the bin-packing shape of
    binpack_rtcr_5kn_10kpods, a five-point decreasing shape and a
    three-resource strategy, on the density cluster with nodes whose
    utilization with pod 0 hits every shape point exactly, or an ulp-size
    step beside it on byte-scale memory; zero allocatable; requests over
    allocatable.  Exact against the plain version; a 17-point shape is
    refused before launch.  Returns the timing of the bin-packing shape."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.engine.pass_ import eval_spec
    from kubernetes_tpu_torch.framework.config import (
        DEFAULT_PROFILE, REQUESTED_TO_CAPACITY_RATIO, ScoringStrategy,
    )
    from kubernetes_tpu_torch.kernels import plain

    builder, pf, nom, _steps, rng = kernel_inputs(2468, dev)
    state = builder.state().clone()
    schema, res_col = builder.schema, builder.res_col
    errs: dict[str, float] = {}
    n = state.valid.shape[0]
    # Pod 0's cpu (nonzero) request and memory request put the utilization
    # of a third of the nodes exactly at a point of the shape, or one byte
    # beside it.
    pod_cpu, pod_mem = int(pf["nonzero"][0, 0]), int(pf["nonzero"][0, 1])
    alloc = state.alloc[:, :2].cpu().numpy()
    nz = state.nonzero_req.cpu().numpy()
    pts = np.array([0, 25, 50, 60, 75, 100], np.int64)
    hit = rng.random(n) < 0.35
    u = rng.choice(pts, n)
    nz[hit, 0] = np.maximum(alloc[hit, 0] * u[hit] // 100 - pod_cpu, 0)
    nz[hit, 1] = np.maximum(alloc[hit, 1] * u[hit] // 100 - pod_mem + rng.integers(-1, 2, int(hit.sum())), 0)
    state.nonzero_req.copy_(torch.from_numpy(nz).to(dev))
    shapes = {
        "binpack": (w.BINPACK_STRATEGY, ),
        "decreasing": (ScoringStrategy(REQUESTED_TO_CAPACITY_RATIO, (("cpu", 1), ("memory", 1)),
                                       ((0, 10), (25, 8), (50, 5), (60, 5), (100, 0))),),
        "three": (ScoringStrategy(REQUESTED_TO_CAPACITY_RATIO, (("cpu", 2), ("memory", 1), ("example.com/gpu", 3)),
                                  ((0, 0), (50, 8), (100, 10))),),
    }
    active = frozenset({"NodeUnschedulable", "NodeName", "NodeResourcesFit", "NodeResourcesBalancedAllocation"})
    out = None
    for label, (strategy,) in shapes.items():
        prof = dataclasses.replace(DEFAULT_PROFILE, scoring_strategy=strategy)
        spec = eval_spec(prof, schema, res_col, active)
        for nom_in in (nom, None):
            ke = kernels.eval_chunk(state, pf, spec, nom_in)
            pe = plain.eval_chunk(state, pf, spec, nom_in)
            torch.cuda.synchronize()
            for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
                exact(errs, "eval_chunk/rtcr", f"[rtcr {label}] {what}", a, b)
        print(f"eval_chunk/rtcr [{label}]: exact; {int(pe[1][pe[0]].unique().numel())} distinct totals, "
              f"{int(pe[0].sum())} feasible pairs")
        if label == "binpack":
            out = timed(lambda _: kernels.eval_chunk(state, pf, spec, nom),
                        lambda _: plain.eval_chunk(state, pf, spec, nom), reps)
            set_bound(out, eval_bytes(state, pf, nom) + 2 * 8 * 2)
    long = dataclasses.replace(DEFAULT_PROFILE, scoring_strategy=ScoringStrategy(
        REQUESTED_TO_CAPACITY_RATIO, (("cpu", 1),), tuple((6 * i, i % 11) for i in range(17))))
    before = kernels.eval_chunk.launches
    try:
        kernels.eval_chunk(state, pf, eval_spec(long, schema, res_col, active), None)
    except NotImplementedError as e:
        if "MAX_SHAPE_POINTS" not in str(e):
            raise
    else:
        raise AssertionError("a 17-point shape was not refused")
    if kernels.eval_chunk.launches != before:
        raise AssertionError("the refused shape launched")
    out["max_abs_err"] = errs["eval_chunk/rtcr"]
    # The bin-packing path's eval_chunk, select_host and resolve_commit at
    # its own chunk, and build_dom of its state.
    prof = dataclasses.replace(DEFAULT_PROFILE, scoring_strategy=w.BINPACK_STRATEGY)
    result = check_main_at(dev, "rtcr", builder, state, pf, active, prof, 64, errs, reps)
    result["build_dom"] = dom_at(errs, "rtcr", builder, state, reps)
    for name in result:
        result[name]["max_abs_err"] = errs[name]
    return {"eval_chunk/rtcr": out, **result}


def hetero_inputs(dev, nodes: int, seed: int = 97):
    """A heterogeneity cluster (hetero_nodes: 5:3:2 tpu-v4/tpu-v5e/gpu-a100,
    one node in ten unlabelled, one in 50 of a class the matrix lacks) with
    the throughput and learned profiles' 64-pod chunk: the four workload
    classes, a class the matrix lacks and unlabelled pods, requests from
    100m to 20 CPU (over allocatable) and 128 MiB to 80 GiB; featurized
    under a profile with both scorers (twice: the second pass sees the
    final vocabularies).  The node state is then loaded on the card:
    0-110 pods a node (some full), cpu and memory in use up to 120% of
    allocatable, a few nodes with no cpu or no memory."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.ops.learned import learned_scorer_profile
    from kubernetes_tpu_torch.ops.throughput import (
        ACCEL_LABEL_KEY, WORKLOAD_CLASS_LABEL_KEY, preseed_hetero_vocab,
    )
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    rng = np.random.default_rng(seed)
    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    for key in ("kubernetes.io/hostname", ZONE, "topology.kubernetes.io/region"):
        builder.ensure_topo_key(key)
    preseed_hetero_vocab(builder)
    for i, node in enumerate(w.hetero_nodes(nodes)):
        if i % 10 == 9:
            node = make_node(f"node-{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110}).zone(
                f"zone-{i % 10}").obj()
        elif i % 50 == 7:
            node.metadata.labels[ACCEL_LABEL_KEY] = "fpga-x"
        cache.add_node(node)
    both = dataclasses.replace(learned_scorer_profile(), name="both", scorers=learned_scorer_profile().scorers + (
        ("ThroughputAware", 3),))
    classes = ("train-large", "train-small", "serve", "batch", "inference-x", None)
    pods = []
    for k in range(64):
        p = make_pod(f"h{k}").req({"cpu": f"{int(rng.choice([100, 500, 4000, 20000]))}m",
                                   "memory": f"{int(rng.choice([128, 256, 4096, 81920]))}Mi"})
        wc = classes[k % len(classes)]
        if wc is not None:
            p = p.label(WORKLOAD_CLASS_LABEL_KEY, wc)
        pods.append(p.label("app", f"app-{k % 10}").obj())
    for _ in range(2):
        batch, _, active = build_pod_batch(pods, builder, both, 64)
    state = builder.state()
    n = state.valid.shape[0]
    allowed = state.allowed_pods.cpu().numpy()
    num = np.minimum(rng.integers(0, 111, n), allowed).astype(np.int32)
    full = rng.random(n) < 0.05
    num[full] = allowed[full]
    alloc = state.alloc.cpu().numpy().copy()
    alloc[rng.random(n) < 0.02, 0] = 0
    alloc[rng.random(n) < 0.02, 1] = 0
    req = (alloc * rng.random(alloc.shape) * 1.2).astype(np.int64)
    state.num_pods.copy_(torch.from_numpy(num).to(dev))
    state.alloc.copy_(torch.from_numpy(alloc).to(dev))
    state.req.copy_(torch.from_numpy(req).to(dev))
    state.nonzero_req.copy_(torch.from_numpy(np.ascontiguousarray(req[:, :2])).to(dev))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {key: to(v) for key, v in batch.items()}
    pf["nominated_row"] = to(np.full(64, -1, np.int32))
    return builder, state, pf, active, both


def check_hetero_kernels(dev, reps: int, shape: str) -> dict:
    """eval_chunk with ThroughputAware, and with ThroughputAware and
    LearnedScorer, at a heterogeneity shape: "hetero" (5000 nodes, N=8192)
    or "hetero_learned" (1000 nodes, N=1024), C=64 (hetero_inputs); and the
    learned term alone.  Exact against the plain versions (the learned term
    in XLA's arithmetic on the card, ops/learned.py).  Returns the timings of
    the throughput term and of both terms."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import eval_spec
    from kubernetes_tpu_torch.framework.config import Profile
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.ops.learned import learned_scorer_profile
    from kubernetes_tpu_torch.ops.throughput import throughput_aware_profile

    nodes = 5000 if shape == "hetero" else 1000
    builder, state, pf, active, both = hetero_inputs(dev, nodes)
    schema, res_col = builder.schema, builder.res_col
    if not {"ThroughputAware", "LearnedScorer"} <= active:
        raise AssertionError(f"{shape}: active {sorted(active)}")
    lp = learned_scorer_profile()
    only_ls = Profile(name="ls", filters=("NodeUnschedulable",), scorers=(("LearnedScorer", 1),),
                      throughput_matrix=lp.throughput_matrix, learned_weights=lp.learned_weights)
    variants = {"throughput": throughput_aware_profile(), "throughput+learned": both, "learned": only_ls}
    errs: dict[str, float] = {}
    out = {}
    for label, prof in variants.items():
        act = active & (set(prof.filters) | {s for s, _ in prof.scorers})
        spec = eval_spec(prof, schema, res_col, act)
        ke = kernels.eval_chunk(state, pf, spec, None)
        pe = plain.eval_chunk(state, pf, spec, None)
        torch.cuda.synchronize()
        name = "eval_chunk/throughput" if label == "throughput" else "eval_chunk/learned"
        for what, a, b in zip(("feasible", "total", "fail_mask"), ke, pe):
            exact(errs, name, f"[{shape} {label}] {what}", a, b)
        if label == "learned":
            scores = pe[1][pe[0]]
            print(f"eval_chunk/learned [{shape}]: exact; scores {int(scores.min())}..{int(scores.max())}, "
                  f"{int(scores.unique().numel())} distinct")
            continue
        print(f"eval_chunk/{label} [{shape}]: exact; {int(pe[0].sum())} feasible pairs")
        tm = timed(lambda _: kernels.eval_chunk(state, pf, spec, None),
                   lambda _: plain.eval_chunk(state, pf, spec, None), reps)
        learned = "learned" in label
        c, n = pf["req"].shape[0], state.valid.shape[0]
        set_bound(tm, _term_bytes(state, pf, None, learned),
                  learned_ops(c, n, len(lp.learned_weights[1])) if learned else 0)
        tm["max_abs_err"] = errs[name]
        out[name] = tm
    # The path's eval_chunk (its profile's term), select_host and
    # resolve_commit at its own chunk, and build_dom of its state.
    prof = variants["throughput" if shape == "hetero" else "throughput+learned"]
    act = active & (set(prof.filters) | {s for s, _ in prof.scorers})
    out.update(check_main_at(dev, shape, builder, state, pf, act, prof, 64, errs, reps))
    out["build_dom"] = dom_at(errs, shape, builder, state, reps)
    for name in ("eval_chunk", "select_host", "resolve_commit", "build_dom"):
        out[name]["max_abs_err"] = errs[name]
    return out


def split_inputs(dev):
    """The "split" shape: DynamicResources ordered after InterPodAffinity,
    both active in one chunk.  1000 nodes in 10 zones (N=1024), one in four
    publishing 4 GPUs; 2000 bound pods with the IPA cluster's colours and
    (anti-)affinity terms, 200 of them holding a claim; then a 64-pod chunk
    of ipa_chunk_pods, every third with its own claim for a device (some for
    two, some shared with the previous pod, one missing), featurized under
    the default profile (twice)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    rng = np.random.default_rng(4711)
    s = TorchScheduler(DEFAULT_PROFILE, batch_size=64, chunk_size=64, device=dev)
    for node in w.basic_nodes(1000, zones=10):
        s.add_node(node)
    gpu = w.DRA_CLASS
    for i in range(0, 1000, 4):
        s.add_resource_slice(t.ResourceSlice(node_name=f"node-{i}", device_class=gpu, devices=tuple(
            t.Device(name=f"gpu-{d}", attributes={"model": "h100", "memory": 80}) for d in range(4))))

    def claim(name, count=1):
        s.add_resource_claim(t.ResourceClaim(name=name, requests=(t.DeviceRequest("r0", gpu, count),)))

    for j in range(2000):
        kind = j % 4
        p = make_pod(f"b{j}").req({"cpu": "100m", "memory": "128Mi"})
        if kind == 0:
            p = p.label("color", f"c{j % 1000}").pod_anti_affinity_in("color", [f"c{j % 1000}"], ZONE)
        elif kind == 1:
            p = p.label("acolor", f"a{j % 50}").pod_affinity_in("acolor", [f"a{j % 50}"], ZONE)
        elif kind == 2:
            p = p.label("app", f"web{j % 4}").pod_anti_affinity_in("app", [f"web{j % 4}"], HOST)
        if j % 10 == 3:
            claim(f"held-{j}", 2)
            s.add_pod(p.resource_claim(f"held-{j}").node(f"node-{4 * int(rng.integers(250))}").obj())
        else:
            s.add_pod(p.node(f"node-{int(rng.integers(1000))}").obj())
    pods = []
    for k, p in enumerate(ipa_chunk_pods(rng)):
        if k % 3 == 0:
            claim(f"own-{k}", 1 + (k % 2))
            p.spec.resource_claims = (f"own-{k}",)
        elif k % 9 == 4:
            p.spec.resource_claims = (f"own-{k - 1}",)
        elif k == 5:
            p.spec.resource_claims = ("ghost",)
        pods.append(p)
    for _ in range(2):
        batch, _, active = build_pod_batch(pods, s.builder, s.profile, 64)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pf = {key: to(v) for key, v in batch.items()}
    pf["nominated_row"] = to(np.full(64, -1, np.int32))
    return s.builder, s.builder.state(), pf, active


def check_split_kernels(dev, reps: int) -> dict:
    """The filters after InterPodAffinity (ROADMAP §3): on
    the "split" shape, eval_chunk (the filters before InterPodAffinity),
    ipa_eval's filter launch, eval_chunk's second launch with
    DynamicResources on the nodes it left (fail bit after
    InterPodAffinity's), ipa_eval's score launch; every output after every
    launch against the plain versions, exactly.  Returns the timing of the
    second eval_chunk launch."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import after_spec, build_dom, eval_spec, ipa_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    builder, state, pf, active = split_inputs(dev)
    schema, res_col = builder.schema, builder.res_col
    inv = builder.batch_invariants()
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    dom = build_dom(state, to(inv["et_slot"]), to(inv["et_host"]), schema.DV)
    spec = eval_spec(DEFAULT_PROFILE, schema, res_col, active)
    after = after_spec(DEFAULT_PROFILE, schema, res_col, active)
    ipa = ipa_spec(DEFAULT_PROFILE, schema, res_col, active)
    ipa = dataclasses.replace(ipa, ctx=dataclasses.replace(ipa.ctx, dom=dom))
    if after is None or after.filters != ("DynamicResources",):
        raise AssertionError(f"split shape: active {sorted(active)}, after {after}")
    errs: dict[str, float] = {}
    runs = {}
    for label, mod in (("kernel", kernels), ("plain", plain)):
        out = list(mod.eval_chunk(state, pf, spec, None))
        steps = [tuple(x.clone() for x in out)]
        mod.ipa_eval(state, pf, *out, ipa, plain.IPA_FILTER)
        steps.append(tuple(x.clone() for x in out))
        mod.eval_chunk(state, pf, after, None, None, None, tuple(out))
        steps.append(tuple(x.clone() for x in out))
        mod.ipa_eval(state, pf, *out, ipa, plain.IPA_SCORE)
        steps.append(tuple(x.clone() for x in out))
        runs[label] = steps
    torch.cuda.synchronize()
    for i, launch in enumerate(("eval_chunk", "ipa_eval filter", "eval_chunk after", "ipa_eval score")):
        for what, a, b in zip(("feasible", "total", "fail_mask"), runs["kernel"][i], runs["plain"][i]):
            exact(errs, "eval_chunk/after_ipa", f"[split, {launch}] {what}", a, b)
    ipa_bit = 1 << plain.ipa_bit(ipa)
    dra_bit = 1 << after.bit0
    fails = runs["plain"][3][2]
    dra_after = int((runs["plain"][1][0] & ~runs["plain"][2][0]).sum())
    print(f"split: exact; {int(((fails & ipa_bit) != 0).sum())} pods with InterPodAffinity's bit, "
          f"{int(((fails & dra_bit) != 0).sum())} with DynamicResources' (bit {after.bit0}), {dra_after} "
          f"(pod, node) pairs DynamicResources rejected after InterPodAffinity")
    if not dra_after or not int(((fails & ipa_bit) != 0).sum()):
        raise AssertionError("the split shape exercises neither filter")
    fresh = lambda: tuple(x.clone() for x in runs["plain"][1])  # noqa: E731
    tm = timed(lambda a: kernels.eval_chunk(state, pf, after, None, None, None, a),
               lambda a: plain.eval_chunk(state, pf, after, None, None, None, a), reps, fresh)
    c, n = pf["req"].shape[0], state.valid.shape[0]
    dra = nbytes(state.dra_cap, state.dra_alloc, *(pf[k] for k in ("dra_pin_ids", "dra_missing")))
    if "dra_claim_ids" in pf:
        dra += nbytes(*(pf[k] for k in ("dra_claim_ids", "dra_claim_cls", "dra_claim_cnt")))
    # The feasible set and totals read and written once, the fail mask
    # read and written, the node validity and names read.
    set_bound(tm, dra + c * n * (1 + 8) * 2 + c * 4 * 2 + nbytes(state.valid, state.name_id))
    tm["max_abs_err"] = errs["eval_chunk/after_ipa"]
    return {"eval_chunk/after_ipa": tm}


COLS_SHAPES = {"cols": 5000, "cols_1k": 1000}


def explain_cluster(s, nodes: int, seed: int) -> None:
    """The attribution shapes' cluster on a scheduler: ``nodes`` nodes in 10
    zones with tier labels, a NoSchedule taint "dedicated" on one in 7 and
    "gpu-only" on one in 11, a PreferNoSchedule taint on one in 5, 50
    images each from a 400-image Zipf pool, one in 100 unschedulable; two
    bound pods a node with colours c0-c4, one in 8 holding hostPort 8080,
    one in 6 with a zone anti-affinity to c4, and a few of colour c9 in
    zones 0 and 1."""
    import numpy as np

    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_node, make_pod

    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, 401) ** 1.1
    weights /= weights.sum()
    for i in range(nodes):
        nw = make_node(f"node-{i}").capacity({"cpu": "32", "memory": "128Gi", "pods": 110})
        nw = nw.zone(f"zone-{i % 10}").label("tier", ("gold", "silver", "bronze", "bronze", "silver")[i % 5])
        for img in rng.choice(400, 50, replace=False, p=weights):
            nw = nw.image(f"registry.example/img-{img}:v1", int(rng.integers(50, 900)) << 20)
        if i % 7 == 3:
            nw = nw.taint("dedicated", "infra")
        if i % 11 == 5:
            nw = nw.taint("gpu-only", "true")
        if i % 5 == 2:
            nw = nw.taint("spot", "yes", t.EFFECT_PREFER_NO_SCHEDULE)
        if i % 100 == 42:
            nw = nw.unschedulable()
        s.add_node(nw.obj())
    for j in range(2 * nodes):
        if j % 97 == 0:
            node = f"node-{10 * int(rng.integers(nodes // 10)) + j % 2}"
            s.add_pod(make_pod(f"held-{j}").req({"cpu": "1"}).label("color", "c9").node(node).obj())
            continue
        pw = make_pod(f"held-{j}").req({"cpu": "1", "memory": "2Gi"}).label("color", f"c{j % 5}")
        if j % 8 == 1:
            pw = pw.host_port(8080)
        if j % 6 == 0:
            pw = pw.pod_anti_affinity_in("color", ["c4"], ZONE)
        s.add_pod(pw.node(f"node-{int(rng.integers(nodes))}").obj())


def explain_pod_full(name: str = "explained"):
    """A pod with NodeAffinity (required and preferred), tolerations, zone
    spread (DoNotSchedule and ScheduleAnyway), pod affinity and
    anti-affinity, a hostPort and images: every op of the default profile
    but the volume and claim ops scores or filters it."""
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod

    return (make_pod(name).req({"cpu": "2", "memory": "4Gi"}).label("color", "c1").label("app", "web")
            .node_affinity_in(ZONE, [f"zone-{z}" for z in range(8)])
            .preferred_node_affinity_in("tier", ["gold"], 5).preferred_node_affinity_in("tier", ["silver"], 2)
            .toleration("dedicated", t.TOLERATION_OP_EQUAL, "infra", t.EFFECT_NO_SCHEDULE)
            .spread_constraint(1, ZONE, t.DO_NOT_SCHEDULE, "app", ["web"])
            .spread_constraint(2, ZONE, t.SCHEDULE_ANYWAY, "color", ["c1", "c2"])
            .pod_anti_affinity_in("color", ["c9"], ZONE).preferred_pod_affinity_in("color", ["c0"], ZONE, 4)
            .preferred_pod_affinity_in("color", ["c4"], ZONE, 2, anti=True)
            .host_port(8080).container_image("registry.example/img-0:v1", "registry.example/img-3:v1").obj())


def cols_inputs(dev, shape: str):
    """One attribution shape: the scheduler with explain_cluster, the full
    pod's featurized batch of one (twice: the second under the final
    vocabularies), its active ops, the invariants and the state."""
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    s = TorchScheduler(DEFAULT_PROFILE, batch_size=8, device=dev)
    explain_cluster(s, COLS_SHAPES[shape], 71)
    pod = explain_pod_full()
    for _ in range(2):
        batch, _d, active = build_pod_batch([pod], s.builder, DEFAULT_PROFILE, 1)
    batch["nominated_row"] = __import__("numpy").full(1, -1, "int32")
    return s, batch, active, s._full_inv(), s.builder.state()


def check_cols_kernels(dev, reps: int, shape: str) -> dict:
    """The attribution pass's three columns modes (eval_chunk_cols,
    ipa_eval_cols in its two phases, late_scores_cols) at one attribution
    shape: "cols" (5000 nodes, N=8192) or "cols_1k" (1000 nodes, N=1024),
    C=1 (cols_inputs).  Each is held against its plain version on the same
    inputs, exactly, and timed; the whole pass through the kernels against
    the pass through the plain versions, all four outputs."""
    import dataclasses as dc

    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine import pass_
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain

    s, batch, active, inv, state = cols_inputs(dev, shape)
    schema, res_col = s.builder.schema, s.builder.res_col
    want = set(DEFAULT_PROFILE.filters) | {n for n, _ in DEFAULT_PROFILE.scorers}
    want -= {"VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone", "DynamicResources"}
    if not want <= active:
        raise AssertionError(f"{shape}: ops not active: {sorted(want - active)}")
    errs: dict[str, float] = {}
    outs = [pass_.build_attribution_pass(DEFAULT_PROFILE, schema, res_col, active, _impl=impl)(state, batch, inv)
            for impl in ("kernel", "plain")]
    torch.cuda.synchronize()
    for what, a, b in zip(("ok_cols", "feasible", "score_cols", "total"), *outs):
        exact(errs, "attribution", f"[{shape}] {what}", a, b)
    ok, feas, cols, _total = outs[1]
    print(f"attribution pass [{shape}]: exact; {int(feas.sum())} feasible of {int(state.valid.sum())} nodes, "
          f"{int((~ok).any(dim=1).sum())} of {ok.shape[0]} filters reject somewhere, score columns nonzero "
          f"off the feasible set: {int((cols[:, ~feas] != 0).any(dim=1).sum())} of {cols.shape[0]}")
    plan = pass_._plan(DEFAULT_PROFILE, schema, res_col, active, "kernel")
    tb = pass_._one_pod(batch, dev)
    _dom, ipa, nom, node_bits, il = pass_._setup(plan, state, tb, inv, None)
    ext = pass_._chunk_planes(plan, state, tb, node_bits, il)
    names = pass_.filter_op_names(DEFAULT_PROFILE, active)
    spec = dc.replace(plan.spec, filters=tuple(n for n in names if n != plain.IPA), bit0=0, _device_config={})
    c, n = 1, state.valid.shape[0]
    out = {}
    # node_filters of the one explained pod (the attribution pass's launch).
    kb = kernels.node_filters(state, tb, plan.spec.ctx)
    pb = plain.node_filters(state, tb, plan.spec.ctx)
    exact(errs, "node_filters", f"[{shape}]", kb, pb)
    tm = timed(lambda _: kernels.node_filters(state, tb, plan.spec.ctx),
               lambda _: plain.node_filters(state, tb, plan.spec.ctx), reps)
    set_bound(tm, nf_bytes(state, tb, plan.spec.ctx))
    tm["max_abs_err"] = errs["node_filters"]
    out["node_filters"] = tm
    k_e = kernels.eval_chunk_cols(state, tb, spec, nom, ext)
    p_e = plain.eval_chunk_cols(state, tb, spec, nom, ext)
    for what, a, b in zip(("ok_bits", "feasible", "cols", "total"), k_e, p_e):
        exact(errs, "eval_chunk/cols", f"[{shape}] {what}", a, b)
    tm = timed(lambda _: kernels.eval_chunk_cols(state, tb, spec, nom, ext),
               lambda _: plain.eval_chunk_cols(state, tb, spec, nom, ext), reps)
    planes = sum(nbytes(p) for p in ext if p is not None)
    set_bound(tm, eval_bytes(state, tb, nom) + planes + c * n * (4 + 8 * len(spec.scorers)))
    tm["max_abs_err"] = errs["eval_chunk/cols"]
    out["eval_chunk/cols"] = tm
    feasible, total = p_e[1], p_e[3]

    def ipa_both(impl, x):
        f, t_ = x
        ok_ = impl.ipa_eval_cols(state, tb, f, t_, ipa, plain.IPA_FILTER)
        return ok_, impl.ipa_eval_cols(state, tb, f, t_, ipa, plain.IPA_SCORE), f, t_

    clone = lambda: (feasible.clone(), total.clone())  # noqa: E731
    for what, a, b in zip(("ok", "col", "feasible", "total"), ipa_both(kernels, clone()), ipa_both(plain, clone())):
        exact(errs, "ipa_eval/cols", f"[{shape}] {what}", a, b)
    tm = timed(lambda x: ipa_both(kernels, x), lambda x: ipa_both(plain, x), reps, setup=clone)
    set_bound(tm, 2 * ipa_bytes(state, ipa.ctx.dom, tb) + c * n * (1 + 8))
    tm["max_abs_err"] = errs["ipa_eval/cols"]
    out["ipa_eval/cols"] = tm
    f_final, t_final = clone()
    ipa_both(plain, (f_final, t_final))
    late = plan.late
    lclone = lambda: t_final.clone()  # noqa: E731
    ka = kernels.late_scores_cols(state, tb, f_final, (tk := lclone()), node_bits, late)
    pa = plain.late_scores_cols(state, tb, f_final, (tp := lclone()), node_bits, late)
    exact(errs, "late_scores/cols", f"[{shape}] cols", ka, pa)
    exact(errs, "late_scores/cols", f"[{shape}] total", tk, tp)
    tm = timed(lambda x: kernels.late_scores_cols(state, tb, f_final, x, node_bits, late),
               lambda x: plain.late_scores_cols(state, tb, f_final, x, node_bits, late), reps, setup=lclone)
    set_bound(tm, late_bytes(state, tb, late, c) + 3 * c * n * 8)
    tm["max_abs_err"] = errs["late_scores/cols"]
    out["late_scores/cols"] = tm
    for name in out:
        print(f"{name} [{shape}]: exact")
    return out


def ipa_c1_inputs(dev):
    """The "ipa_c1" shape: explain_cluster's 5000 nodes in 10 zones
    (N=8192) and bound pods, plus 200 bound pods whose terms match the
    pod (preferred zone affinity, preferred hostname anti-affinity,
    required zone affinity: weighted existing terms; required hostname
    anti-affinity: forbidden nodes), and one pod with required zone and
    hostname affinity, zone and hostname anti-affinity and preferred zone
    and hostname terms of both signs, featurized under the final
    vocabularies.  Returns (state, the pod's batch of one on the device,
    the IpaSpec bound to the domain tables, the domain tables, eval_chunk's
    plain result for the pod)."""
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.engine import pass_
    from kubernetes_tpu_torch.engine.features import build_pod_batch
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.kernels import plain
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    s = TorchScheduler(DEFAULT_PROFILE, batch_size=8, device=dev)
    explain_cluster(s, COLS_SHAPES["cols"], 71)
    for j in range(200):
        pw = make_pod(f"matcher-{j}").req({"cpu": "100m"}).label("color", "c7")
        kind = j % 4
        if kind == 0:
            pw = pw.preferred_pod_affinity_in("color", ["c1"], ZONE, 7)
        elif kind == 1:
            pw = pw.preferred_pod_affinity_in("color", ["c1"], HOST, 9, anti=True)
        elif kind == 2:
            pw = pw.pod_affinity_in("color", ["c1"], ZONE)
        elif j % 40 == 3:
            pw = pw.pod_anti_affinity_in("color", ["c1"], HOST)
        s.add_pod(pw.node(f"node-{(j * 37) % COLS_SHAPES['cols']}").obj())
    pod = (make_pod("ipa-c1").req({"cpu": "2", "memory": "4Gi"}).label("color", "c1")
           .pod_affinity_in("color", ["c0", "c1"], ZONE).pod_affinity_in("color", ["c1", "c2"], HOST)
           .pod_anti_affinity_in("color", ["c9"], ZONE).pod_anti_affinity_in("color", ["c3"], HOST)
           .preferred_pod_affinity_in("color", ["c0"], ZONE, 4).preferred_pod_affinity_in("color", ["c2"], HOST, 3)
           .preferred_pod_affinity_in("color", ["c4"], ZONE, 2, anti=True)
           .preferred_pod_affinity_in("color", ["c3"], HOST, 5, anti=True).obj())
    for _ in range(2):
        batch, _d, active = build_pod_batch([pod], s.builder, DEFAULT_PROFILE, 1)
    batch["nominated_row"] = __import__("numpy").full(1, -1, "int32")
    state, inv = s.builder.state(), s._full_inv()
    plan = pass_._plan(DEFAULT_PROFILE, s.builder.schema, s.builder.res_col, active, "plain")
    tb = pass_._one_pod(batch, dev)
    dom, ipa, nom, node_bits, il = pass_._setup(plan, state, tb, inv, None)
    ext = pass_._chunk_planes(plan, state, tb, node_bits, il)
    return state, tb, ipa, dom, plain.eval_chunk(state, tb, plan.spec, nom, ext)


def check_ipa_c1_kernels(dev, reps: int) -> dict:
    """ipa_eval at the "ipa_c1" shape (ipa_c1_inputs: C=1, N=8192, the
    explain and search paths' launches): both phases in one launch, and
    the filter launch then the score launch, against the plain version,
    exactly, on eval_chunk's feasible set, on that set cut to the last
    slice of 16 that holds node rows (the other slices empty), on one
    feasible row (min = max) and on none; timed in one launch of both
    phases on eval_chunk's set."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    state, tb, ipa, dom, base = ipa_c1_inputs(dev)
    n = state.valid.shape[0]
    nvalid = int(state.valid.sum())
    errs: dict[str, float] = {}
    last = max(b for b in slice_starts(n) if b < nvalid)
    rows = torch.arange(n, device=dev)
    feas0 = base[0]
    one = feas0 & (rows == int(torch.nonzero(feas0[0]).max()))[None]
    sets = {"eval_chunk's set": feas0, f"rows {last}-{nvalid - 1} only": feas0 & (rows >= last)[None],
            "one feasible row": one, "none feasible": torch.zeros_like(feas0)}
    for name, feas in sets.items():
        for phases in ((plain.IPA_BOTH,), (plain.IPA_FILTER, plain.IPA_SCORE)):
            outs = []
            for mod in (kernels, plain):
                a = (feas.clone(), base[1].clone(), base[2].clone())
                for ph in phases:
                    mod.ipa_eval(state, tb, *a, ipa, ph)
                outs.append(a)
            torch.cuda.synchronize()
            for what, x, y in zip(("feasible", "total", "fail_mask"), *outs):
                exact(errs, "ipa_eval", f"[ipa_c1, {name}, phases {phases}] {what}", x, y)
    after = plain.ipa_eval(state, tb, *(t.clone() for t in base), ipa)
    print(f"ipa_eval [ipa_c1]: exact; {int(feas0.sum())} of {nvalid} nodes feasible before, "
          f"{int(after[0].sum())} after; {len(sets)} feasible sets, one launch and two")
    fresh = lambda: tuple(t.clone() for t in base)  # noqa: E731
    tm = timed(lambda a: kernels.ipa_eval(state, tb, *a, ipa), lambda a: plain.ipa_eval(state, tb, *a, ipa), reps,
               fresh)
    set_bound(tm, ipa_bytes(state, dom, tb))
    tm["max_abs_err"] = errs["ipa_eval"]
    return {"ipa_eval": tm}


def run_extender(impl: str, trace: bool = False):
    """extender_5kn_1kpods (no harness counterpart): 5000 tiered nodes in
    10 zones, one in five denied by the filter extender, 512 warm-up and
    1000 measured density pods, each scheduled through the eval-only pass
    and the three extenders of workloads.extender_chain.  The eval-pass
    outputs of 32 measured pods are kept for the selectHost gate."""
    from kubernetes_tpu_torch import workloads as w

    nodes = w.extender_nodes()
    chain = w.extender_chain(nodes)
    step = w.EXTENDER_MEASURED_PODS // 32
    sample = {f"pod-{i}" for i in range(0, 32 * step, step)}
    seen: dict = {}

    def keep_sample(s):
        orig = s._run_eval_pass

        def run_eval(pod, profile, nomrow):
            got = orig(pod, profile, nomrow)
            if pod.name in sample and pod.name not in seen:
                seen[pod.name] = (got[3].copy(), got[4].copy())
            return got

        s._run_eval_pass = run_eval

    s, out, measured, dt, spans = run_workload(
        impl, nodes, w.warm_pods(w.EXTENDER_WARM_PODS), [w.pod_basic(i) for i in range(w.EXTENDER_MEASURED_PODS)],
        w.EXTENDER_BATCH, 1, trace, setup=keep_sample, sched_kw={"extenders": chain})
    s.extender_eval, s.extender_chain = seen, chain
    return s, out, measured, dt, spans


def check_extender(s, outcomes, expected: int, label: str) -> dict:
    """extender_5kn_1kpods' gates on top of check_density's: no pod on a
    denied node; the ignorable extender raised and was skipped; for each of
    the 32 sampled pods, the bound node is the first in row order that
    maximizes the plugin total plus 5 x its tier score among the feasible
    nodes the filter extender kept, recomputed from that pod's eval-pass
    outputs."""
    from kubernetes_tpu_torch import workloads as w

    bind = check_density(s, outcomes, expected, label)
    deny, tiers, flaky = s.extender_chain
    on_deny = [p for p, n in bind.items() if n in deny.denied]
    if on_deny:
        raise AssertionError(f"{label}: {len(on_deny)} pods on denied nodes, e.g. {on_deny[:3]}")
    if not flaky.raised:
        raise AssertionError(f"{label}: the ignorable extender never raised")
    if len(s.extender_eval) != 32:
        raise AssertionError(f"{label}: {len(s.extender_eval)} sampled pods, want 32")
    for name, (feasible, total) in s.extender_eval.items():
        rows = [int(r) for r in feasible.nonzero()[0]]
        kept = [(s.cache.node_name_at_row(r), r) for r in rows]
        kept = [(n, r) for n, r in kept if n not in deny.denied]
        combined = [int(total[r]) + w.TIER_WEIGHT * w.TIER_SCORES[tiers.tier[n]] for n, r in kept]
        best = kept[max(range(len(kept)), key=lambda i: (combined[i], -i))][0]
        if bind[name] != best:
            raise AssertionError(f"{label}: {name} bound to {bind[name]}, the extenders' best is {best}")
    print(f"{label}: no pod on the {len(deny.denied)} denied nodes ({len(deny.unresolvable)} reported "
          f"unresolvable); the ignorable extender raised {flaky.raised} times in {flaky.calls} calls; 32 sampled "
          f"picks equal the host's argmax of total + {w.TIER_WEIGHT} x tier")
    return bind


def extender_postfilter(s, impl: str) -> dict:
    """extender_5kn_1kpods' PostFilter phase: 500 nodes of 4 CPU filled by
    four priority-1 pods each, then 32 preemptors of 2 CPU at priority
    1000, scheduled through the extender path twice: with an extender that
    keeps every preemption candidate (every preemptor binds, each evicting
    two priority-1 pods) and with one that vetoes every candidate (nothing
    is evicted, every preemptor waits unschedulable).  Returns the victims
    and bindings of both runs."""
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    result = {}
    for veto in (False, True):
        ex = w.PreemptExtender(veto)
        ps = TorchScheduler(DEFAULT_PROFILE, batch_size=64, chunk_size=1, _impl=impl, extenders=[ex])
        for node in w.basic_nodes(500, w.EXTENDER_ZONES, cpu="4", mem="16Gi"):
            ps.add_node(node)
        for j in range(2000):
            ps.add_pod(make_pod(f"fill-{j}").req({"cpu": "1", "memory": "2Gi"}).priority(1).start_time(float(j))
                       .node(f"node-{j % 500}").obj())
        for k in range(32):
            ps.add_pod(make_pod(f"preemptor-{k}").req({"cpu": "2", "memory": "4Gi"}).priority(1000).obj())
        out = ps.schedule_all_pending()
        bound = {o.pod.name: o.node_name for o in out if o.node_name}
        victims = sorted(ps.preempted)
        label = f"extender PostFilter ({'veto' if veto else 'accept'}, {impl})"
        if veto:
            if victims or bound or len(ps.queue.unschedulable_uids()) != 32 or ex.calls != 32:
                raise AssertionError(f"{label}: {len(victims)} evicted, {len(bound)} bound, "
                                     f"{len(ps.queue.unschedulable_uids())} parked, {ex.calls} vetoes")
        else:
            prio = {v for v, _p, _n in victims if not v.startswith("default/fill-")}
            if len(bound) != 32 or len(victims) != 64 or prio or not ps.builder.host_mirror_equal():
                raise AssertionError(f"{label}: {len(bound)} bound, {len(victims)} victims")
        print(f"{label}: {len(bound)} preemptors bound, {len(victims)} victims, {ex.calls} extender calls")
        result["veto" if veto else "accept"] = (victims, bound)
    return result


def explain_mixed_pods(rng, n: int = 1024) -> list:
    """The explain phase's batch: ``n`` mixed pods (zone affinity and
    anti-affinity, zone spread with DoNotSchedule and ScheduleAnyway,
    preferred node affinity, tolerations, host ports, images from the
    pool), 32 of them needing a zone no node has, and one pod of 999 CPU
    that fits nowhere."""
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.api.wrappers import make_pod

    pool, _weights = w.image_pool(0)
    pods = []
    for k in range(n):
        pw = make_pod(f"explain-{k}").req({"cpu": "500m", "memory": "1Gi"}).label("color", f"c{k % 10}")
        pw = pw.label("app", f"app-{k % 4}")
        kind = k % 8
        if k < 32:
            pw = pw.node_affinity_in(ZONE, ["zone-none"])
        elif kind == 0:
            pw = pw.pod_anti_affinity_in("color", [f"c{k % 10}"], ZONE)
        elif kind == 1:
            pw = pw.pod_affinity_in("color", [f"c{(k + 1) % 10}"], ZONE)
        elif kind == 2:
            pw = pw.spread_constraint(1, ZONE, t.DO_NOT_SCHEDULE, "app", [f"app-{k % 4}"])
        elif kind == 3:
            pw = pw.spread_constraint(2, ZONE, t.SCHEDULE_ANYWAY, "color", [f"c{k % 10}"])
        elif kind == 4:
            pw = pw.preferred_node_affinity_in(ZONE, [f"zone-{k % 3}"], 1 + k % 7)
        elif kind == 5:
            pw = pw.toleration("dedicated", t.TOLERATION_OP_EXISTS, "", "")
        elif kind == 6:
            pw = pw.host_port(int(rng.choice([80, 8080, 9100])))
        else:
            pw = pw.container_image(*(pool[int(i)][0] for i in rng.choice(len(pool), 2, replace=False)))
        pods.append(pw.obj())
    pods.append(make_pod("unfit").req({"cpu": "999"}).obj())
    return pods


def explain_phase(s, impl: str) -> dict:
    """After default_images_ports_5kn_10kpods' window: arm provenance,
    schedule one more batch (explain_mixed_pods), then explain 32 bound
    pods, 32 pending pods and the unfit pod.  Gates: the unfit pod's first
    rejecting plugin is NodeResourcesFit on every node.  Returns the
    records, the capsules of the bound pods, the records a second and the
    attribution pass's device ms (kernel run: one pass of the unfit pod,
    CUDA events behind the spin kernel; its timing launches are not
    counted)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.features import build_pod_batch

    s.arm_provenance()
    pods = explain_mixed_pods(np.random.default_rng(23))
    for pod in pods:
        s.add_pod(pod)
    s.schedule_all_pending()
    bound = [p.uid for p in pods if p.uid in s.cache.pods][:32]
    pending = [p.uid for p in pods if p.uid not in s.cache.pods and p.name != "unfit"][:32]
    if len(bound) != 32 or len(pending) != 32:
        raise AssertionError(f"explain phase ({impl}): {len(bound)} bound, {len(pending)} pending")
    uids = bound + pending + ["default/unfit"]
    t0 = time.perf_counter()
    records = {uid: s.explain_pod(uid) for uid in uids}
    rate = len(uids) / (time.perf_counter() - t0)
    unfit = records["default/unfit"]
    if set(unfit["first_reject"]) != set(unfit["nodes"]) or set(unfit["first_reject"].values()) != {
            "NodeResourcesFit"}:
        raise AssertionError(f"explain phase ({impl}): the unfit pod's first_reject is not NodeResourcesFit "
                             f"on every node")
    for uid in bound:
        if records[uid]["decision"] is None:
            raise AssertionError(f"explain phase ({impl}): {uid} has no recorded decision")
    capsules = {uid: s.provenance.get(uid).as_dict() for uid in bound}
    attr_ms = None
    if impl == "kernel":
        saved = kernels.launch_counts()
        pod = s.queue._info["default/unfit"].pod
        batch, _d, active = build_pod_batch([pod], s.builder, s.profile, 1)
        batch["nominated_row"] = np.full(1, -1, np.int32)
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(s.device) for k, v in batch.items()}
        run = s.passes.get_attribution(s.profile, s.builder.schema, s.builder.res_col, active)
        inv, state = s._full_inv(), s.builder.state()
        attr_ms, _call = median_ms(lambda _: run(state, tb, inv), 10)
        for name, count in saved.items():
            kernels.WRAPPERS[name].launches = count
    print(f"explain phase ({impl}): {len(records)} records at {rate:.1f} records/s"
          + ("" if attr_ms is None else f"; attribution pass {attr_ms:.4f} device ms"))
    return {"records": records, "capsules": capsules, "rate": rate, "attr_ms": attr_ms}


def run_hetero(impl: str, trace: bool = False):
    """hetero_5kn_10kpods (harness.py:1089): 5000 nodes in 10 zones dealt
    5:3:2 tpu-v4/tpu-v5e/gpu-a100, 2048 + 10000 pods naming
    throughput-aware-scheduler; three profiles, batch 4096, chunk 64."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.hetero_nodes(w.HETERO_NODES), w.warm_pods(w.HETERO_WARM_PODS, w.pod_hetero),
                        [w.pod_hetero(i) for i in range(w.HETERO_MEASURED_PODS)], w.HETERO_BATCH, w.HETERO_CHUNK,
                        trace, setup=w.hetero_warm, sched_kw={"profiles": w.hetero_profiles()})


def run_hetero_learned(impl: str, trace: bool = False):
    """hetero_learned_1kn_5kpods (harness.py:1099): 1000 such nodes,
    1024 + 5000 pods naming learned-scorer-scheduler."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.hetero_nodes(w.HETERO_SMALL_NODES),
                        w.warm_pods(w.HETERO_SMALL_WARM_PODS, w.pod_hetero_learned),
                        [w.pod_hetero_learned(i) for i in range(w.HETERO_SMALL_MEASURED_PODS)], w.HETERO_BATCH,
                        w.HETERO_CHUNK, trace, setup=w.hetero_warm, sched_kw={"profiles": w.hetero_profiles()})


def run_binpack(impl: str, trace: bool = False):
    """binpack_rtcr_5kn_10kpods (no harness counterpart): density's 5000
    nodes and 2048 + 10000 pods under upstream's documented
    RequestedToCapacityRatio bin-packing strategy; batch 4096, chunk 64."""
    from kubernetes_tpu_torch import workloads as w

    return run_workload(impl, w.basic_nodes(w.BINPACK_NODES), w.warm_pods(w.BINPACK_WARM_PODS),
                        [w.pod_basic(i) for i in range(w.BINPACK_MEASURED_PODS)], w.BINPACK_BATCH,
                        w.BINPACK_CHUNK, trace, profile=w.binpack_profile())


def check_hetero(s, outcomes, expected: int, label: str) -> dict:
    """The heterogeneity paths' gates (check_density's), and the share of
    each workload class's pods on its matrix-best accelerator class."""
    from kubernetes_tpu_torch.ops.throughput import (
        ACCEL_LABEL_KEY, DEFAULT_THROUGHPUT_MATRIX, WORKLOAD_CLASS_LABEL_KEY,
    )

    bind = check_density(s, outcomes, expected, label)
    best = {wc: max(row, key=lambda at: at[1])[0] for wc, row in DEFAULT_THROUGHPUT_MATRIX}
    accel = {name: rec.node.metadata.labels.get(ACCEL_LABEL_KEY) for name, rec in s.cache.nodes.items()}
    on, total = {}, {}
    for o in outcomes:
        wc = o.pod.metadata.labels.get(WORKLOAD_CLASS_LABEL_KEY)
        total[wc] = total.get(wc, 0) + 1
        on[wc] = on.get(wc, 0) + int(accel.get(o.node_name) == best.get(wc))
    shares = {wc: round(on[wc] / total[wc], 4) for wc in sorted(total)}
    print(f"{label}: share of each workload class's pods on its best accelerator class {shares}")
    return bind


def check_binpack(s, outcomes, expected: int, label: str) -> dict:
    """binpack_rtcr_5kn_10kpods' gates (check_density's), and how packed the
    cluster is: the nodes in use against the fewest that could hold the
    pods."""
    import numpy as np

    bind = check_density(s, outcomes, expected, label)
    h = s.builder.host
    used = int((h["num_pods"][h["valid"]] > 0).sum())
    print(f"{label}: {used} nodes hold pods, at least {int(np.ceil(expected / 17))} needed by cpu")
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
    images = base + ("conflict_pairs", "image_counts", "image_scores")
    # extender: the eval-only pass a pod (no select_host, no commit: the
    # host's assume flushes as rows).
    extender = ("build_dom", "eval_chunk", "scatter_rows")
    search = spread + ("ipa_eval", "preempt_eval", "preempt_pick", "preempt_commit", "unpack_victims",
                       "dom_release", "search_step", "scatter_rows", "expand_rows")
    # dra: node-local search ops only (no domain op, no node_filters bit);
    # a retried batch of one pod is uniform (expand_rows).
    dra = base + ("conflict_pairs", "preempt_eval", "preempt_pick", "preempt_commit", "unpack_victims",
                  "scatter_rows", "expand_rows")
    parity = base + ("truncate_feasible",)
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
        "default_images_ports_5kn_10kpods": (run_images_ports, w.IMAGES_WARM_PODS + w.IMAGES_MEASURED_PODS,
                                             images, None, check_images_ports, 1),
        "preemption_default_search_5kn": (run_search, w.SEARCH_MEASURED_PODS + 1, search, None, check_search, 1),
        "dra_claims_5kn_5kpods": (run_dra, w.DRA_MEASURED_PODS + w.DRA_PREEMPTORS, dra, None, check_dra, 1),
        "parity_basic_5kn_10kpods": (run_parity, w.PARITY_WARM_PODS + w.PARITY_MEASURED_PODS, parity, None,
                                     check_parity, 1),
        "hetero_5kn_10kpods": (run_hetero, w.HETERO_WARM_PODS + w.HETERO_MEASURED_PODS, base, None, check_hetero,
                               1),
        "hetero_learned_1kn_5kpods": (run_hetero_learned, w.HETERO_SMALL_WARM_PODS + w.HETERO_SMALL_MEASURED_PODS,
                                      base, None, check_hetero, 1),
        "binpack_rtcr_5kn_10kpods": (run_binpack, w.BINPACK_WARM_PODS + w.BINPACK_MEASURED_PODS, base, None,
                                     check_binpack, 1),
        "extender_5kn_1kpods": (run_extender, w.EXTENDER_WARM_PODS + w.EXTENDER_MEASURED_PODS, extender, None,
                                check_extender, 1),
    }


def compare_postfilter(path: str, got, want, card: str) -> None:
    """The PostFilter phase's victims and bindings through the kernels
    against the plain run's."""
    if got != want:
        raise AssertionError(f"{path} PostFilter phase: kernel and plain victims or bindings differ")
    print(f"{path} PostFilter phase: kernel and plain victims and bindings identical  [{card}]")


def compare_explain(path: str, got, want, card: str) -> None:
    """The explain phase through the kernels against the plain run's: every
    record (diff_records None) and capsule."""
    from kubernetes_tpu_torch.framework.provenance import diff_records

    for uid, rec in got["records"].items():
        diff = diff_records(rec, want["records"][uid])
        if diff is not None:
            raise AssertionError(f"{path} explain phase: {uid} differs: {diff}")
    if got["capsules"] != want["capsules"]:
        raise AssertionError(f"{path} explain phase: kernel and plain capsules differ")
    print(f"{path} explain phase: diff_records None on all {len(got['records'])} records, "
          f"{len(got['capsules'])} capsules equal; {got['rate']:.1f} records/s through the kernels, "
          f"{want['rate']:.1f} through the plain versions; attribution pass {got['attr_ms']:.4f} device ms  "
          f"[{card}]")


# What runs after a path's first kernel run and after its plain run: the
# phase's name, its runner, the comparison of the kernel run's result with
# the plain run's, and the kernels it must launch.  Its launches are
# counted apart from the path's, under "<path>/<phase>".
PATH_AFTER = {
    # The explain batch steps chunk 1 (InterPodAffinity), so no
    # conflict_pairs; one attribution pass an explained pod.
    "default_images_ports_5kn_10kpods": (
        "explain", explain_phase, compare_explain,
        ("build_dom", "eval_chunk", "select_host", "resolve_commit", "image_counts", "image_scores", "ipa_eval",
         "node_filters", "spread_filter", "late_scores", "eval_chunk/cols", "ipa_eval/cols", "late_scores/cols")),
    # The eval-only pass a preemptor, then its dry-run.
    "extender_5kn_1kpods": (
        "postfilter", extender_postfilter, compare_postfilter,
        ("build_dom", "eval_chunk", "scatter_rows", "preempt_eval", "preempt_pick", "preempt_commit",
         "unpack_victims")),
}


# eval_chunk's score terms and its filter range: the paths whose
# first kernel run must launch them; on every other path they launch
# nowhere.
PATH_TERMS = {
    "hetero_5kn_10kpods": ("throughput",),
    "hetero_learned_1kn_5kpods": ("learned",),
    "binpack_rtcr_5kn_10kpods": ("rtcr",),
}


def window_line(s, measured: int, dt: float) -> str:
    """The measured window: pods/s and what the wall clock waited on."""
    win = s.window
    virtual = (f" (on the virtual clock: {win['virtual_s']:.1f}s stepped over {win['virtual_steps']} steps)"
               if win["virtual_steps"] else "")
    return (f"measured {measured} pods in {dt:.4f}s = {measured / dt:.1f} pods/s; backoff waited{virtual} "
            f"{win['backoff_s']:.4f}s over {win['sleeps']} sleeps, {win['to_backoff']} pods sent to backoff, "
            f"garbage collector {win['gc_s']:.4f}s over {win['gc_runs']} runs ({win['gc_full']} full; a full "
            f"collection just before the window took {win['gc_before_s']:.4f}s), {win['full_uploads']} "
            f"whole-state uploads")


def drive(path: str, card: str) -> tuple[dict, dict]:
    """Phase 4 for one path in this process: drive_kernel, then
    drive_plain.  Returns (launch counts by path and phase, data moves of
    the path's window)."""
    by_key, moves, ref = drive_kernel(path, card)
    ok, text = drive_plain(path, card, ref)
    print(text, end="")
    if not ok:
        raise AssertionError(f"{path}: the plain run failed")
    return by_key, moves


def drive_kernel(path: str, card: str) -> tuple[dict, dict, dict]:
    """Phase 4's kernel part: one main path through the kernels (launch
    counts set to 0 just before and read just after), again through the
    kernels where the path asks for more runs, and traced; gates, launch
    counts, and identical bindings (and victims), outcome counts and
    backoff requeues in every run required.  A phase of PATH_AFTER runs
    after the first kernel run, with its launches counted from 0 on their
    own.  Returns (launch counts by path and phase, data moves of the
    path's window, what the plain run is held to: the first run's
    bindings, its outcome and requeue counts, the after-phase's result)."""
    from kubernetes_tpu_torch import kernels

    runner, expected, must, gate, check, runs = _paths()[path]
    kernels.reset_launches()
    s, out, measured, dt, _ = runner("kernel")
    terms = dict(kernels.eval_chunk.term_launches)
    bind_k = check(s, out, expected, f"{path} kernel path")
    if gate is not None:
        gate(out)
    history = (len(out), s.window["to_backoff"])
    launches = kernels.launch_counts()
    print(f"{path} (kernels): {len(out)} outcomes; {window_line(s, measured, dt)}; deferred {s.deferred}; "
          f"packed batches {s.packed_batches}, planned collisions {s.pack_collisions}, last pack width "
          f"{s.pack_width}; domain tables rebuilt {s.dom_carry_rebuilds}, carried {s.dom_carry_hits}; "
          f"preemptions {s.preemptions} ({len(s.preempted)} victims, {s.speculative_batches} speculative "
          f"dry-runs), {s.pinned_batches} pinned batches; schema N={s.builder.schema.N} G={s.builder.schema.G} "
          f"ET={s.builder.schema.ET} DV={s.builder.schema.DV}; launches {launches}; data moves "
          f"{s.data_moves}  [{card}]")
    launches = check_launches(path, launches, terms, must, PATH_TERMS.get(path, ()), card)
    by_key = {path: launches}
    after = PATH_AFTER.get(path)
    after_k = None
    if after is not None:
        phase, run_after, _compare, after_must = after
        kernels.reset_launches()
        after_k = run_after(s, "kernel")
        key = f"{path}/{phase}"
        got = kernels.launch_counts()
        print(f"{key} (kernels): launches {got}  [{card}]")
        by_key[key] = check_launches(key, got, dict(kernels.eval_chunk.term_launches), after_must, (), card)
    if launches["search_step"]:
        # A searched dry-run launches preempt_eval twice (prologue, tail) and
        # search_step on the live state, for phase 1 and per reprieve step.
        searched = launches["preempt_eval"] // 2
        print(f"{path}: {launches['preempt_pick']} dry-runs, {searched} searched, "
              f"{launches['search_step'] - 2 * searched} reprieve steps, {launches['dom_release']} released "
              f"domain tables  [{card}]")
    if s.data_moves["index_copy_"] or s.data_moves["expand"]:
        raise AssertionError(f"{path} path: data moved outside the hand kernels: {s.data_moves}")
    moves = s.data_moves
    if moves["scatter_rows"] != moves["flushes"] + moves["victim_scatters"] or moves["flush_copies"] > moves["flushes"]:
        raise AssertionError(f"{path} path: scatter_rows launches are not one a flush and one a victim-buffer "
                             f"scatter, or a flush made more than one copy: {moves}")
    ref = {"bind": bind_k, "history": history, "after": after_k}
    for rep in range(2, runs + 1):
        s4, out4, m4, dt4, _ = runner("kernel")
        same_run(path, f"kernel run {rep}", ref, s4, out4)
        print(f"{path} (kernels, run {rep}): {window_line(s4, m4, dt4)}  [{card}]")
    s3, out3, m3, dt3, spans = runner("kernel", trace=True)
    same_run(path, "traced kernel run", ref, s3, out3)
    print_trace(path, dt3, spans, card)
    print(f"{path} traced run: {window_line(s3, m3, dt3)}  [{card}]")
    return by_key, moves, ref


def same_run(path: str, label: str, ref: dict, s_, out_) -> None:
    """Another run of a path against its first kernel run: the same
    bindings (and victims), outcome count and backoff requeues."""
    _runner, expected, _must, _gate, check, _runs = _paths()[path]
    compare_bindings(ref["bind"], check(s_, out_, expected, f"{path} {label}"))
    if (len(out_), s_.window["to_backoff"]) != ref["history"]:
        raise AssertionError(f"{path} {label}: {len(out_)} outcomes and {s_.window['to_backoff']} "
                             f"backoff requeues, the first kernel run {ref['history']}")


def drive_plain(path: str, card: str, ref: dict) -> tuple[bool, str]:
    """Phase 4's plain part: the path through the plain versions on the
    card, held to the first kernel run (drive_kernel's ``ref``), then its
    PATH_AFTER phase, held to the kernel run's.  Returns (passed, what it
    printed, with the traceback where it failed)."""
    import contextlib
    import io
    import traceback

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runner = _paths()[path][0]
            s2, out2, measured2, dt2, _ = runner("plain")
            same_run(path, "plain run", ref, s2, out2)
            after = PATH_AFTER.get(path)
            if after is not None:
                _phase, run_after, compare_after, _must = after
                compare_after(path, ref["after"], run_after(s2, "plain"), card)
            print(f"{path} (plain versions on the card): identical bindings, victims and requeues; "
                  f"{window_line(s2, measured2, dt2)}  [{card}]")
        return True, buf.getvalue()
    except Exception:  # reported by the caller, which fails the run
        return False, buf.getvalue() + traceback.format_exc()


# The plain runs go to PLAIN_WORKERS processes once every kernel run is
# done, longest first (by the kernel part's wall time): they only check
# bindings, and the card sits idle under a host-bound path, so this keeps
# the kernel runs alone on the card and cuts the script's wall time.
PLAIN_WORKERS = 4


def plain_runs(refs: dict, order: list, card: str) -> None:
    """drive_plain of every path in ``order`` on PLAIN_WORKERS spawned
    processes; prints each path's output as it finishes and fails the run
    if any path failed, after every process has ended."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed

    failed = []
    with ProcessPoolExecutor(PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {pool.submit(drive_plain, path, card, refs[path]): path for path in order}
        for fut in as_completed(futures):
            ok, text = fut.result()
            print(text, end="", flush=True)
            if not ok:
                failed.append(futures[fut])
    if failed:
        raise AssertionError(f"plain runs failed: {failed}")


# The kernel-phase shapes nearest to each main path's launches (chunk size
# and node rows), for the redesign queue, in order: a kernel takes its
# numbers from the first shape that measured it, or else its first
# shape's numbers (a fallback the queue reports).  parity reads the pos-mode
# select_host and truncate_feasible at "truncate", the rest at "c1"; the
# explain phase reads the image kernels at "explain_il"; the paths that
# flush rows a pod or a dry-run (extender and its PostFilter phase, search,
# claims) read scatter_rows at "flush"; the explain phase reads the
# columns modes at "cols" (its records' own pod and cluster); the chunk-1
# paths (the explain phase, search) read spread_filter and late_scores at
# "spread_c1"; the
# claims path reads its dry-runs at "search_dra_path" (C=8, N=4096) and
# the PostFilter phase its own at "preemption_500n" (500 nodes), its
# chunk-1 preempt_pick at "preemption_500n_c1".
PATH_SHAPE = {
    "density": ["density"], "ipa": ["ipa"], "spread_na": ["spread_na"], "inclusion": ["inclusion"],
    "preemption_500n": ["preemption_500n"], "preemption_async_5kn": ["preemption_async_5kn"],
    "daemonset_15kn": ["daemonset"], "intree_pvs_5kn_2kpods": ["pv"], "migrated_intree_pvs_5kn_5kpods": ["pv"],
    "csi_pvs_5kn_5kpods": ["pv"], "default_images_ports_5kn_10kpods": ["ports_images"],
    "default_images_ports_5kn_10kpods/explain": ["c1", "ipa_c1", "cols", "spread_c1", "explain_il"],
    "preemption_default_search_5kn": ["search", "ipa_c1", "spread_c1", "flush"],
    "dra_claims_5kn_5kpods": ["dra_path", "search_dra_path", "flush"],
    "parity_basic_5kn_10kpods": ["truncate", "c1"],
    "hetero_5kn_10kpods": ["hetero"], "hetero_learned_1kn_5kpods": ["hetero_learned"],
    "binpack_rtcr_5kn_10kpods": ["rtcr"], "extender_5kn_1kpods": ["c1", "flush"],
    "extender_5kn_1kpods/postfilter": ["c1", "preemption_500n_c1", "preemption_500n", "flush"],
}


def redesign_queue(entries: list) -> dict:
    """Each kernel's device ms lost to its bound on the main paths:
    launches x (ms - bound_ms), at the shapes nearest to each path
    (PATH_SHAPE), on density alone and summed over every path and
    after-phase; largest first.  ``fallback`` lists, per kernel, the
    paths with launches whose figure fell back to the kernel's first
    shape.  eval_chunk's term entries are subsets of its launches and are
    left out."""
    density, every, fallback = {}, {}, {}
    for e in entries:
        if e["launches_by_path"] is None or e["name"] in ("eval_chunk/rtcr", "eval_chunk/throughput",
                                                          "eval_chunk/learned"):
            continue
        for path, n in e["launches_by_path"].items():
            at = next((e["by_shape"][s] for s in PATH_SHAPE.get(path, ()) if s in e["by_shape"]), None)
            if at is None:
                at = e
                if n:
                    fallback.setdefault(e["name"], []).append(path)
            lost = n * (at["ms"] - at["bound_ms"])
            every[e["name"]] = every.get(e["name"], 0.0) + lost
            if path == "density":
                density[e["name"]] = lost
    order = lambda d: dict(sorted(((k, v) for k, v in d.items() if v > 0), key=lambda kv: -kv[1]))  # noqa: E731
    return {"density_ms": order(density), "all_paths_ms": order(every), "fallback": fallback}


def check_launches(label: str, launches: dict, terms: dict, must, must_terms, card: str) -> dict:
    """Fails unless exactly the kernels in ``must`` and eval_chunk's terms
    in ``must_terms`` launched; returns the counts with a key a term."""
    for name, count in launches.items():
        if (count == 0) == (name in must):
            raise AssertionError(f"{label}: {name} launched {count} times")
    for term, count in terms.items():
        if (count == 0) == (term in must_terms):
            raise AssertionError(f"{label}: eval_chunk's {term} launched {count} times")
    print(f"{label}: eval_chunk launches by term {terms}  [{card}]")
    return {**launches, **{f"eval_chunk/{term}": count for term, count in terms.items()}}


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
print(json.dumps({"pods_s": n / dt, "traced_pods_s": n2 / dt2, "featurize_s": spans["featurize_s"],
                  "other_host_s": spans["other_host_s"],
                  "device_busy_s": sum(spans["device_ms_by_kernel"].values()) / 1e3}))
"""


def compare(other: str, paths: list[str], card: str) -> None:
    """Each path's measured window through the kernels, in ``other`` and
    in this tree, each run a fresh process, three times in the order
    other, this, this, other; pods/s untraced and traced, and the traced
    window's featurize span, other host seconds and device busy seconds."""
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
    ap.add_argument("--shapes", metavar="GROUPS",
                    help="with --kernels-only: run only these groups of the kernel phase (comma-separated, "
                         "e.g. ports_images,flush), and print no kernels line")
    ap.add_argument("--kernels-of", metavar="DIR",
                    help="with --kernels-only: run this script's kernel phase on the port's tree in DIR "
                         "(e.g. the parent commit unpacked), its kernels and wrappers")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.shapes and not args.kernels_only:
        ap.error("--shapes needs --kernels-only")
    if args.kernels_of:
        if not args.kernels_only:
            ap.error("--kernels-of needs --kernels-only")
        import os

        sys.path.insert(0, os.path.abspath(args.kernels_of))
    import kubernetes_tpu_torch  # (fails outside the repository)
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import build

    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(f"package: {kubernetes_tpu_torch.__file__}")
    if args.compare:
        compare(args.compare, args.paths.split(","), card)
        return 0

    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(key in line for key in ("registers", "spill", "entry function")) or "error" in line.lower():
                print(f"  {name}: {line.strip()}")
        for entry, info in ptxas_entries(log).items():
            kernel = next((k for k in PTXAS_SHOWN if k in entry), None)
            if kernel is not None:
                print(f"ptxas {kernel} ({entry}): {info.get('registers')} registers, {info.get('stack')} bytes "
                      f"stack frame")
                if kernel in PTXAS_NO_STACK and info.get("stack") != 0:
                    raise AssertionError(f"{entry}: {info.get('stack')} bytes of stack frame, want 0")

    floor = launch_floor(REPS)
    print(f"launch floor (an empty kernel): device ms {floor['ms']:.4f}, call ms {floor['call_ms']:.4f}  [{card}]")
    def images_group():
        explain: dict = {}  # check_ports_images_kernels fills "explain_il" on its cluster
        return {"ports_images": check_ports_images_kernels(dev, REPS, explain), **explain}

    def spread_group():
        c1: dict = {}  # check_spread_kernels fills "spread_c1" on the inclusion cluster
        out = {shape: check_spread_kernels(dev, shape, REPS, c1 if shape == "inclusion" else None)
               for shape in ("spread_na", "inclusion")}
        return {**out, **c1}

    def preempt_group():
        c1: dict = {}  # preempt_pick on the 500-node chunk-1 dry-run (the PostFilter phase's launches)
        out = {shape: check_preempt_kernels(dev, shape, REPS, c1 if shape == "preemption_500n" else None)
               for shape in PREEMPT_SHAPES}
        return {**out, **c1}

    def search_group():
        c1: dict = {}  # preempt_pick on the search cluster's chunk-1 tail (N=8192)
        out = {shape: check_search_kernels(dev, shape, REPS, extra=c1 if shape == "search" else None)
               for shape in ("search", "search_pv", "search_dra", "search_dra_path")}
        return {**out, **c1}

    dom_errs: dict[str, float] = {}

    def dom_group():  # untimed exactness cases: no shapes
        if args.kernels_of and not hasattr(kernels, "dom_split"):
            print("dom_cases: skipped, the package of --kernels-of has no dom_split (one block a table row)")
            return {}
        dom_cases(dom_errs, dev)
        return {}

    eval_errs: dict[str, float] = {}

    def eval_group():  # untimed exactness cases: no shapes
        if args.kernels_of and not hasattr(kernels, "eval_split"):
            print("eval_cases: skipped, the package of --kernels-of has no eval_split (one thread a node)")
            return {}
        eval_cases(eval_errs, dev)
        return {}

    # The kernel phase's checks in their order, each returning its shapes.
    groups = {
        "density": lambda: {"density": check_kernels(dev, REPS)}, "c1": lambda: {"c1": check_c1_kernels(dev, REPS)},
        "ipa": lambda: {"ipa": check_ipa_kernels(dev, REPS)},
        "spread": spread_group,
        "preempt": preempt_group,
        "flush": lambda: check_flush_kernels(dev, REPS),
        "daemonset": lambda: {"daemonset": check_pinned_kernels(dev, REPS)},
        "pv": lambda: {"pv": check_pv_kernels(dev, REPS)},
        "ports_images": images_group,
        "search": search_group,
        "dra": lambda: {shape: check_dra_kernels(dev, REPS, shape) for shape in ("dra", "dra_path")},
        "truncate": lambda: check_truncate_kernels(dev, REPS),
        "rtcr": lambda: {"rtcr": check_rtcr_kernels(dev, REPS)},
        "hetero": lambda: {shape: check_hetero_kernels(dev, REPS, shape) for shape in ("hetero", "hetero_learned")},
        "split": lambda: {"split": check_split_kernels(dev, REPS)},
        "cols": lambda: {shape: check_cols_kernels(dev, REPS, shape) for shape in COLS_SHAPES},
        "ipa_c1": lambda: {"ipa_c1": check_ipa_c1_kernels(dev, REPS)},
        "dom": dom_group,
        "eval": eval_group,
    }
    picked = args.shapes.split(",") if args.shapes else list(groups)
    unknown = sorted(set(picked) - set(groups))
    if unknown:
        ap.error(f"--shapes: unknown {unknown}; known {sorted(groups)}")
    shapes: dict[str, dict] = {}
    for group in picked:
        shapes.update(groups[group]())
        print(f"kernel phase: {group} done at {time.perf_counter() - t0:.1f}s")
    exact_cases = {} if args.shapes else check_exact_cases(dev)
    for errs in (dom_errs, eval_errs):
        for name, err in errs.items():
            exact_cases[name] = {"max_abs_err": max(err, exact_cases.get(name, {}).get("max_abs_err", 0.0))}
    for shape, table in shapes.items():
        for name, tm in table.items():
            lib = "" if tm.get("library_ms") is None else f", library {tm['library_ms']:.4f}"
            print(f"{name} [{shape} shapes]: device ms: kernel {tm['ms']:.4f}, plain {tm['plain_ms']:.4f}{lib}, "
                  f"bound {tm['bound_ms']:.5f} ({tm['bound_by']}: {tm['bytes']} bytes, {tm['ops']} "
                  f"operations); call ms with the host's launch overhead: kernel {tm['call_ms']:.4f}, "
                  f"plain {tm['plain_call_ms']:.4f}  [{card}]")

    print(f"kernel phase done at {time.perf_counter() - t0:.1f}s")
    if args.shapes:  # a part of the kernel phase: no kernels line
        print(card)
        return 0
    by_path: dict[str, dict] = {}  # empty: the main paths did not run
    moves: dict[str, dict] = {}
    if not args.kernels_only:
        refs, took = {}, {}
        for path in _paths():
            t1 = time.perf_counter()
            counts, moves[path], refs[path] = drive_kernel(path, card)
            took[path] = time.perf_counter() - t1
            by_path.update(counts)
            print(f"{path} kernel runs done at {time.perf_counter() - t0:.1f}s", flush=True)
        plain_runs(refs, sorted(refs, key=lambda p: -took[p]), card)
        print(f"plain runs done at {time.perf_counter() - t0:.1f}s")
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
        "dom_release": "kubernetes_tpu/preemption.py:274",
        "search_step": "kubernetes_tpu/preemption.py:391",
        "unpack_victims": "kubernetes_tpu/preemption.py:94",
        "scatter_rows": "kubernetes_tpu/snapshot.py:796",
        "expand_rows": "kubernetes_tpu/scheduler.py:44",
        "pinned_fit": "kubernetes_tpu/engine/pass_.py:941",
        "vol_filter": "kubernetes_tpu/ops/volumes.py:217",
        "image_counts": "kubernetes_tpu/ops/imagelocality.py:63",
        "image_scores": "kubernetes_tpu/ops/imagelocality.py:53",
        "truncate_feasible": "kubernetes_tpu/engine/pass_.py:510",
        # The attribution pass's columns modes.
        **dict.fromkeys(("eval_chunk/cols", "ipa_eval/cols", "late_scores/cols"), "kubernetes_tpu/engine/pass_.py:848"),
    }
    source = {**build.ENTRIES, "eval_chunk/cols": "eval_chunk", "ipa_eval/cols": "ipa_eval",
              "late_scores/cols": "spread_eval"}
    # The top-level numbers of a kernel come from the shapes of the path it
    # was first ported for (density: eval_chunk, select_host,
    # resolve_commit; IPA: build_dom, ipa_eval, conflict_pairs; spread_na:
    # node_filters, spread_filter, late_scores; preemption_async_5kn: the
    # preemption kernels and data moves; daemonset: pinned_fit; pv:
    # vol_filter; ports_images: image_counts, image_scores); "by_shape"
    # holds every shape it was measured at.  "launches" sums the main
    # paths' first kernel runs and their after-phases, "launches_by_path"
    # splits them (an after-phase under "<path>/<phase>").
    first = {name: "ipa" for name in kernels.WRAPPERS}
    first.update(eval_chunk="density", select_host="density", resolve_commit="density",
                 node_filters="spread_na", spread_filter="spread_na", late_scores="spread_na",
                 **dict.fromkeys(("preempt_eval", "preempt_pick", "preempt_commit", "unpack_victims",
                                  "scatter_rows", "expand_rows"), "preemption_async_5kn"),
                 pinned_fit="daemonset", vol_filter="pv", image_counts="ports_images",
                 image_scores="ports_images", dom_release="search", search_step="search",
                 truncate_feasible="truncate",
                 **dict.fromkeys(("eval_chunk/cols", "ipa_eval/cols", "late_scores/cols"), "cols"))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [], "data_moves_by_path": moves}
    for name in kernels.WRAPPERS:
        top = shapes[first[name]][name]
        counts = {path: c[name] for path, c in by_path.items()}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": f"{csrc}{source[name]}.cu",
            "replaces": replaces[name],
            "launches": sum(counts.values()) if counts else None, "launches_by_path": counts,
            "max_abs_err": max(t[name]["max_abs_err"] for t in (*shapes.values(), exact_cases) if name in t),
            **{k: top.get(k) for k in keys},
            "by_shape": {shape: {k: t[name].get(k) for k in keys} for shape, t in shapes.items() if name in t},
        })
        if name in ("eval_chunk", "resolve_commit"):
            line["kernels"][-1]["launch_floor_ms"] = floor["ms"]
    # eval_chunk's score terms, each its own entry: the numbers of
    # eval_chunk launched with the term, and the launches that ran it.  Its
    # filter range after InterPodAffinity is a mode no main path reaches
    # (no path has both ops active); the "split" shape's line above gives
    # its numbers.
    term_src = {
        "eval_chunk/rtcr": ("kubernetes_tpu/ops/noderesources.py:125", "rtcr"),
        "eval_chunk/throughput": ("kubernetes_tpu/ops/throughput.py:149", "hetero"),
        "eval_chunk/learned": ("kubernetes_tpu/ops/learned.py:154", "hetero_learned"),
    }
    for name, (where, shape0) in term_src.items():
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": f"{csrc}eval_chunk.cu", "replaces": where,
            "launches": sum(counts.values()) if counts else None, "launches_by_path": counts,
            "max_abs_err": max(t[name]["max_abs_err"] for t in shapes.values() if name in t),
            **{k: shapes[shape0][name].get(k) for k in keys},
            "by_shape": {shape: {k: t[name].get(k) for k in keys} for shape, t in shapes.items() if name in t},
        })
    if by_path:
        print(f"redesign queue, launches x (ms - bound_ms): {json.dumps(redesign_queue(line['kernels']))}  [{card}]")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


# Entry functions whose ptxas counts the run prints, and those that must
# keep no stack frame (no per-thread array indexed at run time).
PTXAS_SHOWN = ("image_merge_kernel", "image_tile_kernel", "image_pinned_kernel", "scatter_rows_kernel",
               "preempt_pick_kernel", "preempt_eval_kernel")
PTXAS_NO_STACK = ("image_merge_kernel", "image_tile_kernel")


def ptxas_entries(log: str) -> dict[str, dict]:
    """Each entry function of an ``nvcc -Xptxas -v`` log: its registers and
    stack frame bytes."""
    import re

    out: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def print_trace(label: str, dt: float, spans: dict, card: str) -> None:
    busy = sum(spans["device_ms_by_kernel"].values()) / 1e3
    top = sorted(spans["device_ms_by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} traced window {dt:.3f}s (backoff waited {spans['backoff_s']:.3f}s): featurize "
          f"{spans['featurize_s']:.3f}s, host-to-device "
          f"features {spans['h2d_s']:.3f}s ({spans['h2d_bytes']} bytes), waiting on device results "
          f"{spans['fetch_wait_s']:.3f}s, other host {spans['other_host_s']:.3f}s (victim packs "
          f"{spans['pack_s']:.3f}s); device busy "
          f"{busy:.3f}s ({'not measured' if busy == 0 else f'{1 - busy / dt:.3f} idle share'})  [{card}]")
    for key, ms in top:
        print(f"  device {ms:9.3f} ms  {key[:90]}")


def compare_bindings(bind_k: dict, bind_p: dict) -> None:
    if bind_k != bind_p:
        diff = [k for k in bind_k if bind_k[k] != bind_p.get(k)]
        raise AssertionError(f"kernel and plain bindings differ for {len(diff)} pods, e.g. {diff[:5]}")


if __name__ == "__main__":
    sys.exit(main())
