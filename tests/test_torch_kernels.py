"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests need a card and skip
without one; ``python3 chip_smoke.py`` runs the same checks (and the
density, inter-pod-affinity, spread, preemption, daemonset,
persistent-volume and images/ports workloads at full size) on the H100.  Run them there with ``python -m pytest --noconftest
tests/test_torch_kernels.py -m cuda`` (tests/conftest.py imports JAX,
which that machine lacks).  The DRA kernels (eval_chunk's filter code 5,
the claim commit, the claim pairs, DynamicResources' release in
preempt_eval and search_step) are held at cuts of the "dra" and
"search_dra" shapes and of dra_claims_5kn_5kpods; truncated mode's
truncate_feasible, select_host's pos mode and ipa_eval's two launches at
the "truncate" shapes and on a cut of parity_basic_5kn_10kpods;
eval_chunk's RequestedToCapacityRatio, throughput and learned terms at
the "rtcr", "hetero" and "hetero_learned" shapes and on cuts of
hetero_5kn_10kpods and binpack_rtcr_5kn_10kpods; eval_chunk's second
launch after InterPodAffinity at the "split" shape; select_host,
ipa_eval, spread_filter and late_scores, each pod on a thread block
cluster, at the chunk-1 shapes ("c1", "ipa_c1", "spread_c1") and on cases
that cross the cluster's node slices; image_scores'
merged lists and node tiles on seeded rows with repeats, -1 slots and ids
past the vocabulary, and on the explain phase's batch ("explain_il"); the
one-launch row flush over every field ("flush"); build_dom's one launch at
every (R, K) class dom_split gives (dom_cases).  dom_split's geometry is
plain Python and its tests run everywhere."""

import dataclasses

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_exactly(cuda_device):
    import chip_smoke

    timing = chip_smoke.check_kernels(cuda_device, reps=1)
    assert set(timing) == {"build_dom", "eval_chunk", "select_host", "resolve_commit"}


@pytest.mark.cuda
def test_chunk_one_kernels_match_plain_versions_exactly(cuda_device):
    """eval_chunk, select_host in row mode (with the cases that cross the
    node-axis slices of a thread block cluster), the strict resolve_commit
    and build_dom at the chunk-1 paths' shape ("c1": C=1, N=8192)."""
    import chip_smoke

    timing = chip_smoke.check_c1_kernels(cuda_device, reps=1)
    assert set(timing) == {"eval_chunk", "select_host", "resolve_commit", "build_dom"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_ipa_chunk_one_kernel_matches_plain_version_exactly(cuda_device):
    """ipa_eval at the "ipa_c1" shape (C=1, N=8192, zone and hostname
    terms): one launch of both phases and the two launches of truncated
    mode, on feasible sets that leave slices of the cluster empty."""
    import chip_smoke

    timing = chip_smoke.check_ipa_c1_kernels(cuda_device, reps=1)
    assert set(timing) == {"ipa_eval"}
    assert timing["ipa_eval"]["max_abs_err"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["division", "branches", "crowd"])
def test_exactness_cases_match_plain_versions(cuda_device, part):
    """eval_chunk at the division boundaries (multiples of the allocatable
    and one either side, al = 1, rq = al, rq > al, both sides of 2^53);
    resolve_commit with every optional commit branch under a sparse and a
    dense conflict table, and with C=33 and C=1024 pods crowding one nearly
    full row; each against its plain version with max_abs_err 0."""
    import chip_smoke

    errs = chip_smoke.check_exact_cases(cuda_device, (part,))
    want = {"eval_chunk"} if part == "division" else {"resolve_commit"}
    assert set(errs) == want
    assert all(e["max_abs_err"] == 0 for e in errs.values())


@pytest.mark.cuda
def test_pick_cases_match_plain_version_exactly(cuda_device):
    """preempt_pick's one launch in every mode and cluster size pick_split
    chooses (argmin and split at K = 1, 2, 4, 8, 16, tiled at 16), on
    chip_smoke.pick_cases' synthetic cases, against its plain version with
    max_abs_err 0."""
    import chip_smoke

    errs = chip_smoke.check_exact_cases(cuda_device, ("pick",))
    assert set(errs) == {"preempt_pick"}
    assert errs["preempt_pick"]["max_abs_err"] == 0


@pytest.mark.cuda
def test_dom_cases_match_plain_version_exactly(cuda_device):
    """build_dom's one launch at every (R, K) class dom_split gives (R = 1
    at K = 1, 2, 4, 8, 16, R > 1 at K = 1), with the domain values in
    registers and from topo_vals, on chip_smoke.dom_cases' inputs (slices ending short, N = 1
    and N = 5, G = 0, ET = 0, slots outside [0, TK), hostname ids inside
    and past DV, a warp on one cell, sums near 2^24, unaligned views),
    against its plain version with max_abs_err 0."""
    import chip_smoke

    errs: dict = {}
    chip_smoke.dom_cases(errs, cuda_device)
    assert errs == {"build_dom": 0.0}


# dom_split at the paths' shapes and around its limits on a 132-SM card:
# (table rows, node rows, TK, DV).
DOM_SHAPES = [
    (16, 8192, 4, 8), (4096, 1024, 4, 16), (16, 512, 4, 8), (8, 1024, 4, 16), (16, 5776, 4, 8),
    (0, 0, 4, 8), (0, 10, 4, 8), (1, 1, 4, 8), (3, 5, 1, 1), (131, 8192, 4, 8), (132, 8192, 4, 8),
    (133, 100, 4, 8), (300, 1030, 4, 3000), (20000, 16384, 8, 64), (5, 50000, 4, 14528), (5, 8192, 4, 14000),
    (2, 70000, 16, 100), (40, 2049, 3, 7), (528, 100, 4, 8), (529, 100, 4, 8), (4000, 64, 4, 3000),
]


@pytest.mark.parametrize("rows,n,tk,dv", DOM_SHAPES)
def test_dom_split_geometry(rows, n, tk, dv):
    """K a power of two at most 16 (1 with R > 1), R the smallest that
    makes the grid one wave of DOM_WAVE CTAs an SM unless the tables cut it
    (R x max(TK, 1) x DV x 4 bytes within DOM_SMEM_CAP), threads in whole
    warps, and a grid of ceil(rows / R) x K CTAs covering every table row
    once and, over each cluster's slices and their steps of DOM_VEC nodes a
    thread, every node row once."""
    import numpy as np

    from kubernetes_tpu_torch import kernels as k_

    sms = 132
    r, k, s, threads = k_.dom_split(rows, n, tk, dv, sms)
    assert k in (1, 2, 4, 8, 16) and r >= 1 and (r == 1 or k == 1)
    assert r * max(tk, 1) * dv * 4 <= k_.DOM_SMEM_CAP
    cap = k_.DOM_SMEM_CAP // (max(tk, 1) * dv * 4)
    assert r == min(cap, max(1, -(-rows // (k_.DOM_WAVE * sms))))
    assert r == cap or -(-rows // r) <= k_.DOM_WAVE * sms  # one wave unless the tables cut R
    assert threads % 32 == 0 and 32 <= threads <= k_.DOM_THREADS and s % k_.DOM_VEC == 0
    assert k == 1 or -(-n // k) >= k_.DOM_ROWS_MIN
    row_hits = np.zeros(rows, int)
    for cta in range(-(-rows // r)):
        row_hits[cta * r:min(rows, cta * r + r)] += 1
    assert (row_hits == 1).all()
    node_hits = np.zeros(n, int)
    for rank in range(k):
        s0, s1 = min(n, rank * s), min(n, rank * s + s)
        for base in range(s0, s1, k_.DOM_VEC * threads):
            nodes = base + np.arange(k_.DOM_VEC * threads)
            node_hits[nodes[nodes < s1]] += 1
    assert (node_hits == 1).all()


def test_dom_split_maps_the_path_shapes():
    """"c1" (G = ET = 8, N = 8192, TK = 4, DV = 8): one row a CTA over a
    cluster of 8 CTAs of 1024 node rows (256 threads, one step); "ipa" (G =
    ET = 2048, N = 1024, DV = 16): K = 1 and 8 rows a CTA (four passes of
    DOM_PASS), 512 CTAs: one wave of DOM_WAVE an SM."""
    from kubernetes_tpu_torch import kernels as k_

    assert k_.dom_split(16, 8192, 4, 8, 132) == (1, 8, 1024, 256)
    assert k_.dom_split(4096, 1024, 4, 16, 132) == (8, 1, 1024, 256)
    assert -(-4096 // 8) <= k_.DOM_WAVE * 132


@pytest.mark.parametrize("tk,dv", [(4, 14528), (1, 58112), (8, 7264), (58112, 1), (0, 58112)])
def test_dom_split_takes_every_table_a_block_holds(tk, dv):
    """Every (TK, DV) whose one-row table fits a block's 227 KB is taken,
    at R = 1; one cell more is refused before launch."""
    from kubernetes_tpu_torch import kernels as k_

    for rows, n in ((1, 1), (16, 8192), (4096, 1024)):
        assert k_.dom_split(rows, n, tk, dv, 132)[0] == 1
        with pytest.raises(NotImplementedError):
            k_.dom_split(rows, n, tk, dv + 1, 132)


@pytest.mark.cuda
def test_eval_cases_match_plain_version_exactly(cuda_device):
    """preempt_eval's one launch at every lane count eval_lanes gives (1,
    2, 4, 8, 16, 32), in FULL, PROLOGUE and TAIL, on chip_smoke.eval_cases'
    inputs (every op family alone and together, ties, no victim below, a
    ReadWriteOncePod-blocked, late or missing representative, the
    speculative view), against its plain version with max_abs_err 0."""
    import chip_smoke

    errs: dict = {}
    chip_smoke.eval_cases(errs, cuda_device)
    assert errs == {"preempt_eval": 0.0}


# eval_split at the paths' shapes and around its limits on a 132-SM card:
# (node rows, victim slots).
EVAL_SHAPES = [
    (4096, 8), (512, 8), (8192, 8), (0, 8), (1, 1), (333, 3), (5000, 33), (100, 64), (70000, 16), (7, 2),
    (20000, 64), (1056, 4), (1057, 4), (2112, 8),
]


@pytest.mark.parametrize("n,v", EVAL_SHAPES)
def test_eval_split_geometry(n, v):
    """L a power of two at most 32 with L >= min(V, 32), the smallest such;
    each slot owned once (lane v % L, its j = v // L below 2, two only at L
    = 32); threads whole warps from 32 to EVAL_THREADS, halved only while
    the grid was short of EVAL_BLOCKS_PER_SM blocks an SM, threads / L
    nodes a block; the grid covers every node row once."""
    import numpy as np

    from kubernetes_tpu_torch import kernels as k_

    sms = 132
    lanes, nodes, threads, blocks = k_.eval_split(n, v, sms)
    assert lanes in (1, 2, 4, 8, 16, 32) and lanes >= min(v, 32) and (lanes == 1 or lanes // 2 < v)
    owners = {(s % lanes, s // lanes) for s in range(v)}
    assert len(owners) == v and all(j < (2 if lanes == 32 else 1) for _lane, j in owners)
    assert threads % 32 == 0 and 32 <= threads <= k_.EVAL_THREADS and nodes == threads // lanes
    assert threads == k_.EVAL_THREADS or -(-n // (2 * nodes)) < k_.EVAL_BLOCKS_PER_SM * sms
    assert threads == 32 or blocks >= k_.EVAL_BLOCKS_PER_SM * sms
    hits = np.zeros(n, int)
    for b in range(blocks):
        rows = b * nodes + np.arange(nodes)
        hits[rows[rows < n]] += 1
    assert (hits == 1).all() and blocks * nodes - n < nodes


def test_eval_split_maps_the_path_shapes():
    """"se-dra-p" (N = 4096, V = 8) and "500n" (N = 512, V = 8): 8 lanes a
    node; the claims path's 4096 rows over 512 blocks of 64 threads (8
    nodes a block), the 500-node path's 512 rows over 128 one-warp blocks
    (4 nodes a block)."""
    from kubernetes_tpu_torch import kernels as k_

    assert k_.eval_split(4096, 8, 132) == (8, 8, 64, 512)
    assert k_.eval_split(512, 8, 132) == (8, 4, 32, 128)


def test_eval_split_bounds_shared_memory():
    """A node's group takes 8 bytes a victim request (not in TAIL) and, in
    FULL, 4 an id span entry and counter, rounded to 8; a warp 4 a
    representative slot's id in FULL (eval_smem, preempt.cu EvalLayout);
    at the widest tables (V = 64, every width 16) a block keeps within
    EVAL_SMEM_CAP by taking fewer nodes, and every width the dry-run takes
    fits."""
    from kubernetes_tpu_torch import kernels as k_
    from kubernetes_tpu_torch.kernels import plain

    dims = dict.fromkeys(k_._SEARCH_DIMS, 0)
    dims.update(V=8, R=4, PS=1, SD=2, SC=3, SK=2, QP=1, QD=2, QC=3, QK=1)
    node, warp = k_.eval_smem(dims, plain.FULL)
    assert node == 4 * (8 * 4 * 2 + 8 * (2 + 4 + 12 + 12) + 2 + 2 + 9 + 3) and warp == 4 * (4 + 4 + 6 + 3)
    assert k_.eval_smem({**dims, "QD": 1}, plain.FULL)[0] == node  # 319 ints, rounded up to 320
    assert k_.eval_smem(dims, plain.PROLOGUE) == (8 * 4 * 8, 0) and k_.eval_smem(dims, plain.TAIL) == (0, 0)
    dims.update(R=16, PS=16, SD=16, SC=16, SK=16, QP=16, QD=16, QC=16, QK=16)
    for v in (1, 2, 3, 8, 16, 32, 33, 64):
        node, warp = k_.eval_smem({**dims, "V": v}, plain.FULL)
        for n in (1, 100, 8192):
            lanes, nodes, threads, _blocks = k_.eval_split(n, v, 132, node, warp)
            assert threads // 32 * warp + nodes * node <= k_.EVAL_SMEM_CAP and nodes == threads // lanes
    node, warp = k_.eval_smem({**dims, "V": 64}, plain.FULL)
    assert k_.eval_split(8192, 64, 132, node, warp)[1:3] == (2, 64)  # two groups of 32 lanes a block


@pytest.mark.cuda
def test_ipa_kernels_match_plain_versions_exactly(cuda_device):
    import chip_smoke

    timing = chip_smoke.check_ipa_kernels(cuda_device, reps=1)
    assert set(timing) == {"build_dom", "eval_chunk", "ipa_eval", "select_host", "resolve_commit",
                           "conflict_pairs"}


@pytest.mark.cuda
def test_ipa_shared_memory_cap_raises_before_launch(cuda_device):
    import chip_smoke
    from kubernetes_tpu_torch import kernels

    x = chip_smoke.ipa_inputs(7, cuda_device)
    # More required-affinity terms than the shared-memory tables can hold.
    pf = dict(x["pf"], ipa_ra_valid=torch.zeros((64, 4096), dtype=torch.bool, device=cuda_device))
    before = kernels.ipa_eval.launches
    with pytest.raises(NotImplementedError, match="IPA_SMEM_CAP"):
        kernels.ipa_eval(x["state"], pf, *(t.clone() for t in x["base"]), x["ipa"])
    assert kernels.ipa_eval.launches == before


@pytest.mark.cuda
def test_scheduler_ipa_kernel_path_matches_plain_path(cuda_device):
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.workloads import basic_nodes, pod_ipa_heavy

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=128, chunk_size=16, _impl=impl)
        for n in basic_nodes(40, zones=10):
            s.add_node(n)
        for i in range(600):
            s.add_pod(pod_ipa_heavy(i, anti_colours=50, aff_colours=7))
        kernels.reset_launches()
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("build_dom", "eval_chunk", "ipa_eval", "select_host",
                                           "resolve_commit", "conflict_pairs")) > 0
            assert s.deferred > 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
def test_scheduler_kernel_path_matches_plain_path(cuda_device):
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.workloads import basic_nodes, pod_basic

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=256, chunk_size=16, _impl=impl)
        for n in basic_nodes(300):
            s.add_node(n)
        for i in range(1500):
            s.add_pod(pod_basic(i))
        kernels.reset_launches()
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            # Density batches carry no affinity features: the affinity
            # kernels launch nothing.
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("build_dom", "eval_chunk", "select_host",
                                           "resolve_commit")) > 0
            assert counts["ipa_eval"] == counts["conflict_pairs"] == 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["spread_na", "inclusion", "spread_c1"])
def test_spread_kernels_match_plain_versions_exactly(cuda_device, shape):
    """node_filters, spread_filter, late_scores and the extended eval_chunk
    and conflict_pairs against their plain versions on the mixed chunks;
    "spread_c1": spread_filter, late_scores and late_scores/cols one pod a
    launch over the inclusion cluster (C=1, N=8192, 16 CTAs a pod)."""
    import chip_smoke

    c1: dict = {}
    timing = chip_smoke.check_spread_kernels(cuda_device, "inclusion" if shape == "spread_c1" else shape, reps=1,
                                             c1=c1 if shape == "spread_c1" else None)
    if shape == "spread_c1":
        timing = c1["spread_c1"]
        assert set(timing) == {"spread_filter", "late_scores", "late_scores/cols"}
    else:
        assert {"node_filters", "spread_filter", "late_scores", "eval_chunk", "conflict_pairs"} <= set(timing)
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_spread_slice_cases_match_plain_versions(cuda_device):
    """spread_filter, late_scores and late_scores/cols on the cases that
    cross the node slices of a thread block cluster (chip_smoke.spread_cases:
    a domain on one slice, a hostname minimum in the last slice, the zone
    key missing where slices meet, minDomains above the domain count, one
    slice, no scored node, max = min, the 9·log(19) rounding boundary at
    K=16), each against its plain version with max_abs_err 0."""
    import chip_smoke

    errs = chip_smoke.check_exact_cases(cuda_device, ("spread",))
    assert set(errs) == {"spread_filter", "late_scores", "late_scores/cols"}
    assert all(e["max_abs_err"] == 0 for e in errs.values())


@pytest.mark.cuda
def test_spread_shared_memory_cap_raises_before_launch(cuda_device):
    import chip_smoke
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import eval_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE

    x = chip_smoke.spread_inputs("spread_na", 7, cuda_device)
    prof, pf, active = x["mixed"]["default"]
    b = x["builder"]
    ctx = eval_spec(prof, b.schema, b.res_col, active).ctx
    big_dv = dataclasses.replace(ctx, schema=dataclasses.replace(b.schema, DV=1 << 16))
    bits = torch.full((32, b.schema.N), 3, dtype=torch.uint8, device=cuda_device)
    before = kernels.spread_filter.launches
    with pytest.raises(NotImplementedError, match="SPREAD_SMEM_CAP"):
        kernels.spread_filter(x["state"], pf, bits, big_dv)
    assert kernels.spread_filter.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["spread_na", "inclusion"])
def test_scheduler_spread_kernel_path_matches_plain_path(cuda_device, workload):
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.workloads import basic_nodes, inclusion_nodes, pod_inclusion, pod_spread_na

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=128, chunk_size=64, _impl=impl)
        nodes = basic_nodes(60) if workload == "spread_na" else inclusion_nodes(60)
        for n in nodes:
            s.add_node(n)
        for i in range(600):
            s.add_pod(pod_spread_na(i) if workload == "spread_na" else pod_inclusion(i))
        kernels.reset_launches()
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("node_filters", "spread_filter", "eval_chunk", "late_scores",
                                           "select_host", "resolve_commit", "conflict_pairs")) > 0
            assert counts["ipa_eval"] == 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["preemption_500n", "preemption_async_5kn"])
def test_preempt_kernels_match_plain_versions_exactly(cuda_device, shape):
    """preempt_eval, preempt_pick, preempt_commit, unpack_victims,
    scatter_rows and expand_rows against their plain versions: chunk 1,
    the rank split, a deferring mixed chunk and the speculative mode, with
    PDBs at the 500-node shape; and eval_chunk, select_host,
    resolve_commit and build_dom at the path's own chunk and node count."""
    import chip_smoke

    timing = chip_smoke.check_preempt_kernels(cuda_device, shape, reps=1)
    assert set(timing) == {"preempt_eval", "preempt_pick", "preempt_commit", "unpack_victims",
                           "scatter_rows", "expand_rows", "eval_chunk", "select_host", "resolve_commit",
                           "build_dom"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 8])
def test_scheduler_preemption_kernel_path_matches_plain_path(cuda_device, chunk):
    """A cut of preemption_500n through TorchScheduler on the card: the
    kernel path binds, evicts and nominates as the plain path does, and
    launches the preemption kernels and data moves."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import fit_only_profile
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    seen = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(fit_only_profile(), batch_size=32, chunk_size=chunk, _impl=impl)
        for n in w.preemption_nodes(24):
            s.add_node(n)
        for p in w.preemption_background(96):
            s.add_pod(p)
        s.schedule_all_pending()
        for i in range(24):
            s.add_pod(w.preemptor(f"vip-{i}"))
        kernels.reset_launches()
        out = s.schedule_all_pending()
        seen[impl] = ([(o.pod.name, o.node_name, o.nominated_node, o.victim_uids) for o in out],
                      sorted(s.cache.pods), sorted(s.nominator))
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("preempt_eval", "preempt_pick", "preempt_commit",
                                           "unpack_victims", "scatter_rows")) > 0
    assert seen["kernel"] == seen["plain"]
    assert s.preemptions > 0


@pytest.mark.cuda
def test_pinned_kernels_match_plain_versions_exactly(cuda_device):
    """node_filters, image_scores, eval_chunk and late_scores in pinned
    mode, pinned_fit, the strict resolve_commit and the pinned pass end to
    end against their plain versions at the daemonset_15kn shapes."""
    import chip_smoke

    timing = chip_smoke.check_pinned_kernels(cuda_device, reps=1)
    assert set(timing) == {"node_filters", "image_scores", "eval_chunk", "late_scores", "pinned_fit",
                           "resolve_commit"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_scheduler_daemonset_kernel_path_matches_plain_path(cuda_device):
    """A cut of daemonset_15kn through TorchScheduler on the card: every
    batch takes the pinned pass, through pinned_fit on the kernel path,
    and binds as the plain path does."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=128, chunk_size=64, _impl=impl)
        for n in w.basic_nodes(300):
            s.add_node(n)
        kernels.reset_launches()
        for i in range(300):
            s.add_pod(w.daemon_pod(f"ds-{i}", i))
        s.add_pod(w.daemon_pod("ds-ghost", 999))
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.pinned_batches == 3 and s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert counts["pinned_fit"] == 3 and counts["select_host"] == 0
    assert binds["kernel"] == binds["plain"]
    assert binds["kernel"]["ds-7"] == "node-7" and binds["kernel"]["ds-ghost"] is None


@pytest.mark.cuda
def test_pv_kernels_match_plain_versions_exactly(cuda_device):
    """node_filters with VolumeBinding's and VolumeZone's bits (and on the
    cases of every op with groups at the mask's windows, tiled and
    pinned), vol_filter, eval_chunk reading the volume planes, select_host,
    resolve_commit with the device and CSI commit and the attach-limit
    clash, conflict_pairs with volume ids and build_dom, at the "pv" shape
    (chip_smoke.check_pv_kernels)."""
    import chip_smoke

    timing = chip_smoke.check_pv_kernels(cuda_device, reps=1)
    assert set(timing) == {"node_filters", "conflict_pairs", "vol_filter", "eval_chunk", "select_host",
                           "resolve_commit", "build_dom"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["intree", "migrated", "csi"])
def test_scheduler_pv_kernel_path_matches_plain_path(cuda_device, workload):
    """Cuts of the three PV workloads through TorchScheduler on the card:
    the kernel path binds as the plain path does, through vol_filter and
    the VolumeBinding/VolumeZone bits of node_filters."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=128, chunk_size=64, _impl=impl)
        for n in w.basic_nodes(60, zones=10):
            s.add_node(n)
        if workload == "migrated":
            for cs in w.migrated_csinodes(60):
                s.add_csinode(cs)
        kernels.reset_launches()
        if workload == "csi":
            w.csi_warm(s, 64, table_claims=400)
            w.csi_measured(s, 300)
        else:
            driver = w.MIGRATED_DRIVER if workload == "migrated" else ""
            w.pv_warm(s, 300, driver=driver, count=64)
            w.pv_measured(s, 300, driver=driver)
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("node_filters", "vol_filter", "eval_chunk", "resolve_commit")) > 0
            assert (counts["conflict_pairs"] > 0) == (workload != "intree")
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
def test_ports_images_kernels_match_plain_versions_exactly(cuda_device):
    """image_counts, image_scores, eval_chunk with NodePorts and the image
    plane, select_host, resolve_commit with the port commit and
    conflict_pairs with port keys at the "ports/images" shape, and the
    ImageLocality rounding cases (chip_smoke.check_ports_images_kernels)."""
    import chip_smoke

    timing = chip_smoke.check_ports_images_kernels(cuda_device, reps=1)
    assert set(timing) == {"image_counts", "image_scores", "conflict_pairs", "eval_chunk", "select_host",
                           "resolve_commit", "build_dom"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_explain_batch_image_plane_matches_plain_version_exactly(cuda_device):
    """image_counts and image_scores on the explain phase's 4096-lane batch
    over the "ports/images" cluster (chip_smoke.check_explain_il), at a
    cut of that cluster."""
    import chip_smoke

    explain: dict = {}
    chip_smoke.check_ports_images_kernels(cuda_device, 1, explain, nodes=500, k=512, bound=600)
    assert set(explain["explain_il"]) == {"image_counts", "image_scores"}
    assert all(t["max_abs_err"] == 0 for t in explain["explain_il"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("n,im,k,ci", [(70, 8, 40, 1), (96, 40, 33, 16), (37, 128, 300, 4), (33, 300, 20, 3)])
def test_image_scores_tiles_match_plain_version_exactly(cuda_device, n, im, k, ci):
    """image_merge and image_tile on seeded rows: ids repeated in a row,
    -1 slots among them, ids at or above the vocabulary, pods naming an id
    twice, unknown ids and padding lanes; N not a multiple of the tile, P
    from 32 to 512; and the pinned mode on the same rows."""
    from types import SimpleNamespace

    import numpy as np

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import plain

    rng = np.random.default_rng(n * im)
    vocab = im
    ids = rng.integers(-1, vocab + 4, size=(n, im)).astype(np.int32)
    ids[:, im // 2:] = ids[:, :im - im // 2]  # every id at least twice
    ids[rng.random((n, im)) < 0.1] = -1
    sizes = rng.integers(1, 2**34, size=(n, im))
    pod_ids = rng.integers(-1, vocab + 6, size=(k, ci)).astype(np.int32)
    if ci > 1:
        pod_ids[::5, 1] = pod_ids[::5, 0]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    state = SimpleNamespace(image_ids=to(ids), image_sizes=to(sizes), valid=to(rng.random(n) > 0.1))
    pf = {"il_image_ids": to(pod_ids), "il_ncontainers": to(rng.integers(1, 5, size=k)),
          "valid": to(rng.random(k) > 0.15)}
    counts = plain.image_counts(state, vocab)
    assert torch.equal(kernels.image_counts(state, vocab), counts)
    got, want = kernels.image_scores(state, pf, counts), plain.image_scores(state, pf, counts)
    assert torch.equal(got, want) and int((want > 0).sum()) > 0
    pin = to(rng.integers(-2, n + 2, size=k).astype(np.int32))
    assert torch.equal(kernels.image_scores(state, pf, None, pin), plain.image_scores(state, pf, None, pin))


@pytest.mark.cuda
def test_flush_matches_per_field_plain_scatter(cuda_device):
    """The row flush at the extender path's schema, 1, 8 and 64 dirty rows
    of all 27 fields, one scatter_rows launch and one copy each, exact
    against the per-field plain scatter (chip_smoke.check_flush_kernels)."""
    import chip_smoke

    timing = chip_smoke.check_flush_kernels(cuda_device, reps=1)
    assert set(timing) == set(chip_smoke.FLUSH_ROWS)
    assert all(t["scatter_rows"]["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_scheduler_images_ports_kernel_path_matches_plain_path(cuda_device):
    """A cut of default_images_ports_5kn_10kpods through TorchScheduler on
    the card: the kernel path binds as the plain path does, through
    image_counts, image_scores and the port branches, with no host-port
    conflict on any node."""
    import chip_smoke
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=128, chunk_size=64, _impl=impl)
        for n in w.images_nodes(60):
            s.add_node(n)
        kernels.reset_launches()
        for pod in w.warm_pods(64, w.pod_images_ports) + [w.pod_images_ports(i) for i in range(600)]:
            s.add_pod(pod)
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal() and chip_smoke.port_conflicts(s) == []
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("image_counts", "image_scores", "conflict_pairs", "eval_chunk",
                                           "resolve_commit")) > 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["search", "search_pv", "search_dra"])
def test_search_kernels_match_plain_versions_exactly(cuda_device, shape):
    """unpack_victims with the victim features, preempt_eval's three modes,
    dom_release, search_step and preempt_pick on every tail against their
    plain versions, step by step, at a 500-node cut of each search shape
    (the path's cluster; a volume cluster with shared CSI claims and device
    volumes; a DRA cluster with shared, external and selector claims), with
    preempt_commit and expand_rows; on the path's cluster also its main
    pass's kernels at chunk 128, node_filters, conflict_pairs and
    build_dom."""
    import chip_smoke

    timing = chip_smoke.check_search_kernels(cuda_device, shape, reps=1, nodes=500)
    want = {"unpack_victims", "preempt_eval", "dom_release", "search_step", "preempt_pick", "preempt_commit",
            "expand_rows"}
    if shape == "search":
        want |= {"eval_chunk", "select_host", "resolve_commit", "node_filters", "conflict_pairs", "build_dom"}
    assert set(timing) == want
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
@pytest.mark.parametrize("inline", [False, True])
def test_scheduler_search_kernel_path_matches_plain_path(cuda_device, inline):
    """A cut of preemption_default_search_5kn through TorchScheduler on the
    card (40 nodes in 4 zones, 160 background pods, 24 preemptors): the
    kernel path binds, evicts and nominates as the plain path does, and
    launches dom_release and search_step."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    seen = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=32, chunk_size=8, inline_preempt_commit=inline, _impl=impl)
        for n in w.search_nodes(40, 4):
            s.add_node(n)
        for p in w.search_background(160):
            s.add_pod(p)
        s.schedule_all_pending()
        for i in range(24):
            s.add_pod(w.search_preemptor(f"vip-{i}"))
        kernels.reset_launches()
        out = s.schedule_all_pending()
        seen[impl] = ([(o.pod.name, o.node_name, o.nominated_node, o.victim_uids) for o in out],
                      sorted(s.cache.pods), sorted(s.nominator))
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("preempt_eval", "dom_release", "search_step", "unpack_victims")) > 0
    assert seen["kernel"] == seen["plain"]
    assert s.preemptions > 0


@pytest.mark.cuda
def test_dra_kernels_match_plain_versions_exactly(cuda_device):
    """conflict_pairs with claim ids, eval_chunk with DynamicResources,
    select_host and resolve_commit with the claim commit against their
    plain versions at a 600-node cut of the "dra" shape (shared claims
    inside a chunk, a claim named twice, reserved claims, pins, missing
    claims)."""
    import chip_smoke

    timing = chip_smoke.check_dra_kernels(cuda_device, reps=1, nodes=600)
    assert set(timing) == {"conflict_pairs", "eval_chunk", "select_host", "resolve_commit", "build_dom"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_scheduler_dra_kernel_path_matches_plain_path(cuda_device):
    """A cut of dra_claims_5kn_5kpods through TorchScheduler on the card
    (120 nodes, 30 with GPUs; 160 claim pods, then 8 whole-node
    preemptors): the kernel path binds, allocates, evicts and nominates as
    the plain path does, and launches the claim kernels."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.queue import SchedulingQueue
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    seen = {}
    for impl in ("kernel", "plain"):
        clock = [0.0]
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=64, chunk_size=8, _impl=impl,
                           queue=SchedulingQueue(backoff=True, clock=lambda: clock[0]))
        for n in w.basic_nodes(120, zones=10):
            s.add_node(n)
        w.dra_setup(s, 120, 512)
        for c in w.dra_claims(160):
            s.add_resource_claim(c)
        for c in w.dra_preemptor_claims(8):
            s.add_resource_claim(c)
        pods = [w.dra_pod(i) for i in range(160)]
        kernels.reset_launches()
        out = []
        for wave in (pods, [w.dra_preemptor(i) for i in range(8)]):
            for p in wave:
                s.add_pod(p)
            for _ in range(100):
                out += s.schedule_all_pending()
                expiry = s.queue.next_backoff_expiry()
                if expiry is None:
                    break
                clock[0] = max(clock[0], expiry)
        seen[impl] = ([(o.pod.name, o.node_name, o.nominated_node, o.victim_uids) for o in out],
                      sorted(s.cache.pods), {u: (c.allocated_node, c.allocated_devices)
                                             for u, c in s.builder.dra.claims.items()})
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("eval_chunk", "resolve_commit", "conflict_pairs", "preempt_eval")) > 0
    assert seen["kernel"] == seen["plain"]
    assert s.preemptions > 0 and all(f"default/vip-{i}" in s.cache.pods for i in range(8))


@pytest.mark.cuda
def test_truncate_kernels_match_plain_versions_exactly(cuda_device):
    """truncate_feasible and select_host in pos mode at the path's shape,
    and truncated chunk-1 steps with ipa_eval's two launches and
    late_scores over the truncated set (chip_smoke.check_truncate_kernels)."""
    import chip_smoke

    shapes = chip_smoke.check_truncate_kernels(cuda_device, reps=1)
    assert set(shapes) == {"truncate", "truncate_ipa", "truncate_spread"}
    assert set(shapes["truncate"]) == {"truncate_feasible", "select_host", "build_dom"}


@pytest.mark.cuda
@pytest.mark.parametrize("pct", [None, 40])
def test_scheduler_truncated_kernel_path_matches_plain_path(cuda_device, pct):
    """A cut of parity_basic_5kn_10kpods with pod affinity and spread pods
    mixed in, through TorchScheduler in truncated mode on the card: the
    kernel path binds as the plain path does, ends on the same scan start,
    and launches truncate_feasible and ipa_eval's two phases."""
    from dataclasses import replace

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    seen = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(replace(DEFAULT_PROFILE, percentage_of_nodes_to_score=pct), batch_size=64, chunk_size=1,
                           _impl=impl)
        for n in w.basic_nodes(300, zones=w.PARITY_ZONES):
            s.add_node(n)
        kernels.reset_launches()
        for i in range(300):
            s.add_pod(w.pod_basic(i) if i % 3 else w.pod_ipa_heavy(i, anti_colours=40, aff_colours=5))
        out = s.schedule_all_pending()
        seen[impl] = ({o.pod.name: o.node_name for o in out}, s._next_start)
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert counts["truncate_feasible"] == counts["select_host"] > 0
            assert counts["ipa_eval"] > 0
    assert seen["kernel"] == seen["plain"]
    assert all(seen["kernel"][0].values()) and seen["kernel"][1] != 0


@pytest.mark.cuda
def test_rtcr_kernel_matches_plain_version_exactly(cuda_device):
    """eval_chunk with RequestedToCapacityRatio (three shapes, utilizations
    on the shape points) exact; a 17-point shape refused before launch."""
    import chip_smoke

    timing = chip_smoke.check_rtcr_kernels(cuda_device, reps=1)
    assert timing["eval_chunk/rtcr"]["max_abs_err"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["hetero", "hetero_learned"])
def test_hetero_kernels_match_plain_versions_exactly(cuda_device, shape):
    """eval_chunk's throughput and learned terms exact against the plain
    versions (XLA's arithmetic, ops/learned.py, on the card), and the
    path's eval_chunk, select_host, resolve_commit and build_dom at its
    shape."""
    import chip_smoke

    timing = chip_smoke.check_hetero_kernels(cuda_device, 1, shape)
    assert set(timing) == {"eval_chunk/throughput", "eval_chunk/learned", "eval_chunk", "select_host",
                           "resolve_commit", "build_dom"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_split_kernels_match_plain_versions_exactly(cuda_device):
    """The filters after InterPodAffinity: eval_chunk, ipa_eval's filter,
    eval_chunk's second launch with DynamicResources, ipa_eval's score."""
    import chip_smoke

    timing = chip_smoke.check_split_kernels(cuda_device, 1)
    assert timing["eval_chunk/after_ipa"]["max_abs_err"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hetero", "pinned", "binpack"])
def test_scheduler_hetero_and_binpack_kernel_paths_match_plain_paths(cuda_device, kind):
    """Cuts of hetero_5kn_10kpods (with pods of all three profiles; and its
    pods pinned to their nodes, so eval_chunk runs the terms in pinned
    mode) and of binpack_rtcr_5kn_10kpods through TorchScheduler on the
    card: the kernel path binds as the plain path does and launches the
    path's terms."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    binds = {}
    for impl in ("kernel", "plain"):
        if kind in ("hetero", "pinned"):
            s = TorchScheduler(DEFAULT_PROFILE, batch_size=256, chunk_size=16, profiles=w.hetero_profiles(),
                               _impl=impl)
            w.hetero_warm(s)
            nodes = w.hetero_nodes(300)
            names = ("default-scheduler", w.THROUGHPUT_SCHEDULER, w.LEARNED_SCHEDULER)
            pods = [w.pod_hetero(i, names[i % 3]) for i in range(1500)]
            if kind == "pinned":
                for i, p in enumerate(pods):
                    p.spec.affinity = w.daemon_pod(p.name, i % 300).spec.affinity
        else:
            s = TorchScheduler(w.binpack_profile(), batch_size=256, chunk_size=16, _impl=impl)
            nodes = w.basic_nodes(300)
            pods = [w.pod_basic(i) for i in range(1500)]
        for n in nodes:
            s.add_node(n)
        for p in pods:
            s.add_pod(p)
        kernels.reset_launches()
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            terms = kernels.eval_chunk.term_launches
            if kind != "binpack":
                assert terms["throughput"] > 0 and terms["learned"] > 0 and terms["rtcr"] == 0
                assert (s.pinned_batches > 0) == (kind == "pinned")
            else:
                assert terms["rtcr"] == kernels.eval_chunk.launches > 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["cols", "cols_1k"])
def test_columns_modes_match_plain_versions_exactly(cuda_device, shape):
    """The attribution pass's columns modes (eval_chunk_cols, ipa_eval_cols,
    late_scores_cols), node_filters of the explained pod and the whole pass
    against the plain versions."""
    import chip_smoke

    timing = chip_smoke.check_cols_kernels(cuda_device, 1, shape)
    assert set(timing) == {"eval_chunk/cols", "ipa_eval/cols", "late_scores/cols", "node_filters"}
    assert all(t["max_abs_err"] == 0 for t in timing.values())
