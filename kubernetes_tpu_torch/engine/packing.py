"""Conflict-aware chunk packing: reorder a featurized pod batch so that
same-interaction-class pods land in DIFFERENT chunk slices of the pass.

The port's host NumPy copy of ``kubernetes_tpu/engine/packing.py``; the
port's bindings equal the JAX scheduler's only if it packs exactly as the
JAX scheduler does, so the functions below keep the reference's arithmetic
and tie-breaks line for line.

The chunked pass (pass_.py) defers a pod whose decision could depend on an
earlier chunk-mate's commit (``_conflict_pairs``) to a strict tail.  A
batch whose interaction classes are dense (the affinity-heavy workload:
every chunk holds several pods of one label group) would turn that tail
into the dominant cost.  The packer builds an exact plan from the same
signals the pass derives conflicts from:

1. **Conflict classes** (`conflict_classes`): connected components over the
   hard write→read relations the pass defers on — pod label-group writes
   vs hard group reads (required (anti-)affinity selector masks),
   own-affinity-term writes vs existing-term hard anti reads, shared
   host-port keys, volume/DRA identity overlaps and the any-vs-any classes.
   Merging two pods that would not conflict only costs parallelism.

2. **Width choice** (`plan_packing`): the largest chunk width from the
   configured width's halving ladder whose chunk count hosts every class
   with few same-chunk collisions; width 1 (the sequential pass) always
   qualifies.

3. **Placement** (`pack_batch`): classes are dealt column-major over the
   (chunks × width) grid, largest class first, then each class's cells are
   re-sorted into scan order so same-class pods evaluate in their ORIGINAL
   relative order.  With the tie-break seed riding the pod (the scheduler
   ships per-pod ``step_offset``), bindings stay those of the sequential
   pass for every interacting pod.

Pure function of the batch arrays; ties break on original position.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Residual same-chunk collisions tolerated per batch before stepping the
# width down, as a cap: a residue this size drains in a single strict-tail
# invocation (scheduler.tail_size), cheaper than doubling the scan length
# for one outlier class.  The effective tolerance scales down with the
# batch (npods // 16) so small batches don't accept whole-batch residues.
COLLISION_TOLERANCE = 64


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """One batch's packing decision.

    ``perm`` maps packed row → original batch position (None = identity
    order); ``width`` is the chosen chunk width (≤ the configured chunk);
    ``collisions`` counts pods sharing a chunk with an earlier same-class
    pod under this plan — each is an expected strict-tail deferral."""

    perm: np.ndarray | None
    width: int
    n_classes: int
    max_class: int
    collisions: int
    class_sizes: np.ndarray  # descending


def _hard_group_reads(batch: dict, npods: int) -> np.ndarray | None:
    """(P, G) bool — groups each pod's HARD filters read (the exact masks
    pass_.py ``_conflict_pairs`` unions); None when no group-reading op is
    active in this batch."""
    reads = None
    if "ipa_ra_allmask" in batch:
        reads = np.asarray(batch["ipa_ra_allmask"][:npods], np.bool_).copy()
        reads |= np.asarray(batch["ipa_rs_groups"][:npods]).any(axis=1)
    if "tps_h_groups" in batch:
        h = np.asarray(batch["tps_h_groups"][:npods]).any(axis=1)
        reads = h.copy() if reads is None else (reads | h)
    return reads


def conflict_classes(batch: dict, npods: int) -> np.ndarray:
    """(P,) int32 dense class ids: connected components of the batch's
    possible-conflict graph (see module docstring).  Pure NumPy — edges are
    (pod, shared-key) pairs; components resolve by min-label propagation
    (deterministic: labels are original positions)."""
    pod_edges: list[np.ndarray] = []
    key_edges: list[np.ndarray] = []
    next_key = 0

    def add_edges(pods: np.ndarray, keys: np.ndarray, space: int) -> None:
        nonlocal next_key
        if pods.size:
            pod_edges.append(pods.astype(np.int64))
            key_edges.append(keys.astype(np.int64) + next_key)
        next_key += space

    # -- label-group write→read crossings -----------------------------------
    groups = np.asarray(batch["group"][:npods], np.int64)
    reads_g = _hard_group_reads(batch, npods)
    if reads_g is not None and reads_g.any():
        g_cap = reads_g.shape[1]
        write_any = np.zeros(g_cap, np.bool_)
        write_any[np.clip(groups, 0, g_cap - 1)] = True
        read_any = reads_g.any(axis=0)
        active_g = write_any & read_any
        if active_g.any():
            # Writers touch their own group's key; readers touch every
            # active group their masks select.
            own_active = active_g[np.clip(groups, 0, g_cap - 1)]
            add_pods = np.nonzero(own_active)[0]
            pod_edges.append(add_pods.astype(np.int64))
            key_edges.append(groups[add_pods] + next_key)
            rp, rg = np.nonzero(reads_g & active_g[None, :])
            pod_edges.append(rp.astype(np.int64))
            key_edges.append(rg.astype(np.int64) + next_key)
        next_key += reads_g.shape[1]

    # -- existing-term write→hard-read crossings ----------------------------
    if "ipa_et_match" in batch:
        own = np.asarray(batch["ipa_own_terms"][:npods], np.int64)  # (P, A)
        hard_reads_t = np.asarray(batch["ipa_et_match"][:npods], np.bool_) & np.asarray(
            batch["ipa_et_anti"][:npods], np.bool_
        )  # (P, ET)
        et_cap = hard_reads_t.shape[1]
        write_any_t = np.zeros(et_cap, np.bool_)
        valid_own = own >= 0
        if valid_own.any():
            write_any_t[np.clip(own[valid_own], 0, et_cap - 1)] = True
        read_any_t = hard_reads_t.any(axis=0)
        active_t = write_any_t & read_any_t
        if active_t.any():
            wp, ws = np.nonzero(valid_own & active_t[np.clip(own, 0, et_cap - 1)])
            add_edges(wp, own[wp, ws], 0)
            rp, rt = np.nonzero(hard_reads_t & active_t[None, :])
            add_edges(rp, rt, 0)
        next_key += et_cap

    # -- symmetric identity overlaps (ports, volumes, DRA claims) -----------
    for key in ("port_keys", "vol_dev_ids", "vol_csi_ids", "dra_claim_ids"):
        if key not in batch:
            continue
        ids = np.asarray(batch[key][:npods], np.int64)  # (P, S)
        vp, vs = np.nonzero(ids >= 0)
        space = int(ids.max(initial=-1)) + 1
        add_edges(vp, ids[vp, vs], max(space, 0))

    # -- any-vs-any classes (racing pools, per-node shared budgets) ---------
    for key, reduce_axis in (
        ("vol_unbound", False),
        ("vol_csi_lim", False),
        ("dra_claim_unalloc", True),
    ):
        if key not in batch:
            continue
        flags = np.asarray(batch[key][:npods], np.bool_)
        if reduce_axis and flags.ndim > 1:
            flags = flags.any(axis=1)
        add_edges(np.nonzero(flags)[0], np.zeros(int(flags.sum()), np.int64), 1)

    if not pod_edges:
        return np.arange(npods, dtype=np.int32)
    e_pod = np.concatenate(pod_edges)
    e_key = np.concatenate(key_edges)

    # Min-label propagation over the bipartite pod↔key graph: converges in
    # O(component diameter) rounds — a handful for the star-shaped unions
    # real workloads produce, but a CHAIN (pod i sharing a key with pod
    # i+1 only) needs diameter rounds, so the bound must be npods: a
    # truncated propagation would split one component into several
    # classes and let the packer reorder directly-conflicting pods
    # across chunks.
    labels = np.arange(npods, dtype=np.int64)
    for _ in range(npods + 1):
        key_lab = np.full(next_key, npods, np.int64)
        np.minimum.at(key_lab, e_key, labels[e_pod])
        new = labels.copy()
        np.minimum.at(new, e_pod, key_lab[e_key])
        if np.array_equal(new, labels):
            break
        labels = new
    _, dense = np.unique(labels, return_inverse=True)
    return dense.astype(np.int32)


def _width_ladder(chunk: int) -> list[int]:
    out = []
    w = chunk
    while w >= 1:
        out.append(w)
        w //= 2
    return out


def plan_packing(
    classes: np.ndarray,
    npods: int,
    chunk: int,
    tolerance: int | None = None,
) -> tuple[int, np.ndarray]:
    """(width, class_sizes): the largest width from the halving ladder whose
    chunk count hosts every class with ≤ ``tolerance`` forced collisions.
    Width 1 (the sequential pass) always qualifies."""
    if tolerance is None:
        tolerance = min(COLLISION_TOLERANCE, npods // 16)
    sizes = np.bincount(classes, minlength=1)
    for w in _width_ladder(chunk):
        if w == 1:
            return 1, sizes
        m = -(-npods // w)  # chunk count at this width
        if npods % w:
            m = max(m - 1, 1)  # the partial last chunk shortens the cycle
        coll = int(np.maximum(sizes - m, 0).sum())
        if coll <= tolerance:
            return w, sizes
    return 1, sizes


def pack_batch(batch: dict, npods: int, chunk: int) -> PackPlan:
    """Compute the batch's packing plan: conflict classes → width → the
    order-preserving round-robin permutation (see module docstring)."""
    classes = conflict_classes(batch, npods)
    width, sizes = plan_packing(classes, npods, chunk)
    n_classes = int(sizes.shape[0])
    max_class = int(sizes.max(initial=0))
    sizes_desc = np.sort(sizes)[::-1].copy()
    if width <= 1 or max_class <= 1:
        # Sequential fallback (no packing can help) or no interactions at
        # all (identity order is already collision-free at full width).
        return PackPlan(
            perm=None,
            width=width if max_class > 1 else chunk,
            n_classes=n_classes,
            max_class=max_class,
            collisions=0,
            class_sizes=sizes_desc,
        )

    # Class blocks: largest first (ties → earliest first appearance, which
    # np.lexsort's stable original-position key provides), members inside a
    # block keep original order.
    first_pos = np.full(n_classes, npods, np.int64)
    np.minimum.at(first_pos, classes, np.arange(npods))
    block_rank = np.lexsort((first_pos, -sizes))  # class id → dealt order
    block_of_class = np.empty(n_classes, np.int64)
    block_of_class[block_rank] = np.arange(n_classes)
    blk = block_of_class[classes]  # (P,)
    seq = np.lexsort((np.arange(npods), blk))  # block-major, original-minor

    # Column-major cells over the (M × width) grid; the last chunk may be
    # partial (real pods stay contiguous in the batch rows), so columns
    # past its fill skip it.
    m = -(-npods // width)
    last = npods - (m - 1) * width  # rows in the last chunk (1..width)
    s = np.arange(npods, dtype=np.int64)
    in_full = s < last * m
    c_full = s % max(m, 1)
    l_full = s // max(m, 1)
    s2 = s - last * m
    m1 = max(m - 1, 1)
    c_part = s2 % m1
    l_part = last + s2 // m1
    chunk_of = np.where(in_full, c_full, c_part)
    slice_of = np.where(in_full, l_full, l_part)
    rows = chunk_of * width + slice_of  # scan position == batch row

    # Re-sort each block's cells into scan order so same-class pods keep
    # their original relative order in the scan.
    cell_order = np.lexsort((rows, blk[seq]))
    perm = np.empty(npods, np.int64)
    perm[rows[cell_order]] = seq

    # Exact residual collisions under this layout (counted by the
    # scheduler; each is an expected strict-tail deferral).
    cls_at_row = classes[perm]
    chunk_idx = np.arange(npods) // width
    uniq = np.unique(np.stack([chunk_idx, cls_at_row.astype(np.int64)]), axis=1)
    collisions = int(npods - uniq.shape[1])

    if np.array_equal(perm, np.arange(npods)):
        return PackPlan(
            perm=None,
            width=width,
            n_classes=n_classes,
            max_class=max_class,
            collisions=collisions,
            class_sizes=sizes_desc,
        )
    return PackPlan(
        perm=perm,
        width=width,
        n_classes=n_classes,
        max_class=max_class,
        collisions=collisions,
        class_sizes=sizes_desc,
    )


def residual_collisions(classes: np.ndarray, npods: int, width: int) -> int:
    """Forced same-chunk collisions at ``width`` under an optimal deal
    (``Σ max(0, class_size − chunk_count)``): the per-width pack quality."""
    if width <= 1:
        return 0
    sizes = np.bincount(classes, minlength=1)
    m = -(-npods // width)
    if npods % width:
        m = max(m - 1, 1)
    return int(np.maximum(sizes - m, 0).sum())
