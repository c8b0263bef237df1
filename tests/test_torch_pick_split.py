"""preempt_pick's one launch (kubernetes_tpu_torch/kernels/csrc/preempt.cu,
preempt_pick_kernel), emulated here in plain numpy step for step: K CTAs of
a thread block cluster, CTA r owning the node rows [r*S, min(N, (r+1)*S)),
S = ceil(N/K); in argmin mode (min(C, N) <= 1) each thread's least (keys,
row) over its strided rows, the warps' shuffle tree, the CTA's warps, the
cluster's K minima; in split mode each CTA's slice's nodes that take part
gathered to the front (the ballot compaction) and sorted by the kernel's
bitonic network of width_for(count), its kept list (the first min(C, N,
count)), each kept node's rank as its place plus a lower bound in every
peer's list (a binary search the kernel's way, peers in the kernel's
staggered order, their lists in rounds of at most 2048 records), and
order_at written once a rank; in tiled mode (a slice wider than one
network) each tile sorted and merged into a running kept list of L rows
(the list read in pieces); then the mates' assignment (the first valid
mate's signature, cumsum ranks clipped to N-1, -2 deferral at chunk > 1).
It is held exactly against the port's plain preempt_pick
(kernels/plain.py) and the reference's own arithmetic computed with
jax.numpy: the chunk-1 narrowing (kubernetes_tpu/preemption.py:483-512)
and the jnp.lexsort rank split (:576-600); for K in 1, 2, 4, 8, 16, N in
1, 31, 500, 4096, 5000, 8192 and 20000 (past what 16 slices of one network
hold), C in 1, 8, 64, 512, 1024; with no node possible, every node tied,
ties across slice boundaries, keys differing only in the start key, keys
at ±2^62 and -2^61, C > N, more eligible mates than possible nodes, a
mixed-signature chunk that defers, the speculative view, and a
hypothesis-drawn set.  Also pick_split's contract.  Tolerance: none
(exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import kubernetes_tpu  # noqa: F401  (turns on JAX's int64)
from kubernetes_tpu_torch.kernels import (
    CLUSTER_MAX, PICK_ARGMIN, PICK_ROWS, PICK_SPLIT, PICK_TILED, PICK_WIDTH, pick_split, plain,
)

BIG = 2**62  # the rank split's sentinel on violations (preemption.py:579)
I64_MAX, I32_MAX = 2**63 - 1, 2**31 - 1
PAD = np.array([I64_MAX] * 5 + [I32_MAX], dtype=np.int64)
SPLITS = (1, 2, 4, 8, 16)
PEER_RECS, PIECES = 2048, 16  # preempt.cu kPeerRecs, kPieces
NS = (1, 31, 500, 4096, 5000, 8192, 20000)
CS = (1, 8, 64, 512, 1024)
KINDS = ("drawn", "none possible", "all tied", "ties across slices", "start key only", "extremes",
         "sentinel", "few possible", "mixed signatures")


# ---- the kernel, emulated ---------------------------------------------------

def recs(crit: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """(m, 6) int64: each row's five criteria, then the row."""
    return np.concatenate([crit[:, rows].T, rows[:, None].astype(np.int64)], axis=1)


def before(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a sorts before b, record by record (the last axis): preempt.cu's
    branch-free compare."""
    lt = a[..., 5] < b[..., 5]
    for q in range(4, -1, -1):
        lt = (a[..., q] < b[..., q]) | ((a[..., q] == b[..., q]) & lt)
    return lt


def bitonic(x: np.ndarray) -> np.ndarray:
    """The kernel's network over T positions (thread t holds position t),
    for every (..., T, 6) block of records at once: at stage (k, j) the
    pair (t, t ^ j), t the lower place, is put in order, ascending where
    t & k is 0 (the lower place keeps the smaller) and descending else."""
    t = np.arange(x.shape[-2])
    k = 2
    while k <= len(t):
        j = k // 2
        while j > 0:
            low = t[(t & j) == 0]
            a, b = x[..., low, :], x[..., low ^ j, :]
            lt = before(b, a)
            swap = np.where((low & k) == 0, lt, ~lt)[..., None]  # equal records swap harmlessly
            x = x.copy()
            x[..., low, :] = np.where(swap, b, a)
            x[..., low ^ j, :] = np.where(swap, a, b)
            j //= 2
        k *= 2
    return x


def lower_bound(arr: np.ndarray, e: np.ndarray) -> np.ndarray:
    """For each record of e, the entries of the sorted arr that sort
    before it: the kernel's binary search, every search a step at a time."""
    lo = np.zeros(len(e), np.int64)
    hi = np.full(len(e), len(arr), np.int64)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        less = before(arr[np.minimum(mid, max(len(arr) - 1, 0))], e) if len(arr) else np.zeros(len(e), bool)
        lo = np.where(act & less, mid + 1, lo)
        hi = np.where(act & ~less, mid, hi)
    return lo


def width_for(m: int) -> int:
    """The network's width for m records (preempt.cu width_for)."""
    return 32 if m <= 32 else 1 << (m - 1).bit_length()


def tiles(possible, crit, bounds: list):
    """The tiles of rows [lo, hi) of ``bounds`` as a CTA sorts them: the
    rows that take part gathered to the front in row order (the ballot
    compaction), padded to width_for(count), through the network; tiles of
    one width go through it together.  Returns (the sorted tiles, the
    count of each)."""
    groups: dict = {}
    counts = []
    for i, (lo, hi) in enumerate(bounds):
        rows = np.arange(lo, hi)
        cand = rows[possible[rows] & (crit[0, rows] < BIG)]
        counts.append(len(cand))
        groups.setdefault(width_for(len(cand)), []).append((i, cand))
    out = [None] * len(bounds)
    for width, members in groups.items():
        x = np.tile(PAD, (len(members), width, 1))
        for g, (_i, cand) in enumerate(members):
            x[g, :len(cand)] = recs(crit, cand)
        x = bitonic(x)
        for g, (i, _cand) in enumerate(members):
            out[i] = x[g]
    return out, counts


def slices(n: int, k: int) -> list[tuple[int, int]]:
    s = -(-n // k)
    return [(min(n, r * s), min(n, min(n, r * s) + s)) for r in range(k)]


def xor_tree(x: np.ndarray) -> np.ndarray:
    """Lane 0's record after a warp's shuffle tree (xor offsets 16 .. 1)
    over up to 32 records, the missing lanes padded."""
    w = np.tile(PAD, (32, 1))
    w[:len(x)] = x
    off = 16
    while off:
        o = w[np.arange(32) ^ off]
        w = np.where(before(o, w)[:, None], o, w)
        off //= 2
    return w[0]


def emulate_argmin(possible, crit, k: int, threads: int):
    """(order_at of one entry, M): argmin mode.  Each thread folds the rows
    lo + t, lo + t + T, ... of its CTA's slice to their least record; each
    warp's shuffle tree, warp 0 over the warps' minima, CTA 0's warp over
    the K CTAs' minima."""
    n = possible.shape[0]
    ctas, total = [], 0
    for lo, hi in slices(n, k):
        rows = np.arange(lo, hi)
        cand = rows[possible[rows] & (crit[0, rows] < BIG)]
        total += len(cand)
        mins = np.tile(PAD, (threads, 1))
        if len(cand):
            t = (cand - lo) % threads
            r = recs(crit, cand)
            order = np.lexsort((r[:, 5], r[:, 4], r[:, 3], r[:, 2], r[:, 1], r[:, 0], t))
            first = np.unique(t[order], return_index=True)[1]
            mins[t[order][first]] = r[order][first]
        warps = np.array([xor_tree(mins[w:w + 32]) for w in range(0, threads, 32)])
        ctas.append(xor_tree(warps))
    top = xor_tree(np.array(ctas))
    return np.array([int(top[5]) if total else I32_MAX]), total


def emulate_lists(possible, crit, k: int, threads: int, mode: int, cp: int):
    """Each CTA's kept list (records, ascending) and its count of nodes
    taking part: split mode one network a slice, tiled mode tiles merged
    into a running list of L = min(Cp, S) rows."""
    n = possible.shape[0]
    s = -(-n // k)
    if mode == PICK_SPLIT:
        assert all(hi - lo <= threads for lo, hi in slices(n, k))
        x, counts = tiles(possible, crit, slices(n, k))
        return [x[r][:min(cp, cnt)] for r, cnt in enumerate(counts)], counts
    cap = min(cp, s)
    bounds = [[(b, min(hi, b + threads)) for b in range(lo, hi, threads)] for lo, hi in slices(n, k)]
    sorted_tiles, tile_counts = tiles(possible, crit, [b for cta in bounds for b in cta])
    lists, counts, i = [], [], 0
    for cta in bounds:
        a = np.zeros((0, 6), np.int64)
        cnt = 0
        for _ in cta:
            x, m = sorted_tiles[i], tile_counts[i]
            i += 1
            keep = min(cap, len(a) + m)
            b = np.tile(PAD, (keep, 1))
            # A tile node's place: its place plus the kept nodes before it,
            # the list read in pieces of PEER_RECS.
            pos = np.arange(m)
            for c0 in range(0, len(a), PEER_RECS):
                more = lower_bound(a[c0:c0 + PEER_RECS], x[:m])
                pos = np.where(pos < keep, pos + more, pos)
            b[pos[pos < keep]] = x[:m][pos < keep]
            # A kept node's place: its place plus the tile's nodes before it.
            p = np.arange(len(a)) + lower_bound(x[:m], a)
            b[p[p < keep]] = a[p < keep]
            assert (b[:, 5] != I32_MAX).all()  # every place written
            a, cnt = b, cnt + m
        lists.append(a)
        counts.append(cnt)
    return lists, counts


def rounds(r: int, k: int, lens: list) -> list:
    """CTA r's rounds over its peers' lists as its thread 0 plans them:
    peers in the staggered order (r + d) & (K - 1), each list cut into
    pieces (peer, start, width) so that a round holds at most PEER_RECS
    records in at most PIECES pieces."""
    out, d, c0 = [], 1, 0
    while True:
        plan, used = [], 0
        while d < k and len(plan) < PIECES and used < PEER_RECS:
            j = (r + d) & (k - 1)
            left = lens[j] - c0
            if left <= 0:
                d, c0 = d + 1, 0
                continue
            w = min(left, PEER_RECS - used)
            plan.append((j, c0, w))
            used += w
            if w < left:
                c0 += w
            else:
                d, c0 = d + 1, 0
        if not plan:
            return out
        out.append(plan)


def emulate_order(possible, crit, k: int, threads: int, mode: int, cp: int):
    """(order_at, M): the cross-slice rank of every kept node, T of them at
    a time, over the rounds of pieces of the peers' lists, each rank below
    Cp written exactly once."""
    lists, counts = emulate_lists(possible, crit, k, threads, mode, cp)
    lens = [len(x) for x in lists]
    order = np.full(cp, -1, np.int64)
    for r, own in enumerate(lists):
        for ob in range(0, len(own), threads):
            mine = own[ob:ob + threads]
            rank = np.arange(ob, ob + len(mine))
            for plan in rounds(r, k, lens):
                for j, c0, w in plan:
                    more = lower_bound(lists[j][c0:c0 + w], mine)
                    rank = np.where(rank < cp, rank + more, rank)
            keep = rank < cp
            assert (order[rank[keep]] == -1).all()
            order[rank[keep]] = mine[keep, 5]
    m = sum(counts)
    assert (order[:min(cp, m)] >= 0).all() and (order[min(cp, m):] == -1).all()
    return order, m


def mates_valid(pf: dict) -> np.ndarray:
    if "valid" in pf:
        return pf["valid"].copy()
    return pf["elig"] & (pf["spec_picks"] < 0)


def emulate(possible, crit, pf: dict, chunk_mode: bool, k: int | None = None):
    """The kernel's picks; ``k`` forces the cluster size (the launcher takes
    any power of two up to 16 with a mode that fits it), else pick_split's."""
    n, c = possible.shape[0], pf["sig"].shape[0]
    mode, k0, s, threads = pick_split(c, n)
    if k is not None and k != k0:
        s = -(-n // k)
        if min(c, n) <= 1:
            mode, threads = PICK_ARGMIN, max(32, min(PICK_ROWS, -(-s // 32) * 32))
        elif s <= PICK_WIDTH:
            mode, threads = PICK_SPLIT, max(32, 1 << (s - 1).bit_length())
        else:
            mode, threads = PICK_TILED, PICK_WIDTH
    else:
        k = k0
    cp = min(c, n)
    if mode == PICK_ARGMIN:
        order, m = emulate_argmin(possible, crit, k, threads)
    else:
        order, m = emulate_order(possible, crit, k, threads, mode, cp)
    valid = mates_valid(pf)
    idx0 = int(np.argmax(valid)) if valid.any() else 0
    eligible = valid & (pf["sig"] == pf["sig"][idx0])
    rank = np.cumsum(eligible) - 1
    r = np.minimum(rank, n - 1)
    ok = eligible & (r >= 0) & (r < m)
    picks = np.where(ok, order[np.clip(r, 0, max(len(order) - 1, 0))] if len(order) else -1, -1)
    if chunk_mode:
        picks = np.where(valid & (picks < 0), -2, picks)
    return picks.astype(np.int32), (mode, k, threads)


# ---- the reference's arithmetic (jax.numpy) ---------------------------------

def reference_narrowing(possible, crit) -> int:
    """preemption.py:483-512: five narrowings of the possible nodes, the
    first remaining row, -1 with none possible."""
    big = jnp.int64(BIG)
    mask = jnp.asarray(possible)

    def narrow(mask, key):
        best = jnp.min(jnp.where(mask, key, big))
        return mask & (key == best)

    for q in range(5):
        mask = narrow(mask, jnp.asarray(crit[q]))
    pick = jnp.argmax(mask).astype(jnp.int32)
    return int(jnp.where(jnp.asarray(possible).any(), pick, -1))


def reference_rank_split(possible, crit, pf: dict) -> np.ndarray:
    """preemption.py:562-600 and :618: the representative, the eligible
    mates, the exact lexicographic order by jnp.lexsort, the cumsum ranks
    clipped to n - 1, the deferrals."""
    valid = jnp.asarray(mates_valid(pf))
    sig = jnp.asarray(pf["sig"])
    n = possible.shape[0]
    idx0 = jnp.argmax(valid)
    eligible = valid & (sig == sig[idx0])
    big = jnp.int64(BIG)
    c = [jnp.asarray(crit[q]) for q in range(5)]
    vio_m = jnp.where(jnp.asarray(possible), c[0], big)
    order = jnp.lexsort((c[4], c[3], c[2], c[1], vio_m))
    srt = vio_m[order]
    rank = jnp.cumsum(eligible.astype(jnp.int32)) - 1
    safe_rank = jnp.clip(rank, 0, n - 1)
    row = order[safe_rank]
    has = eligible & (srt[safe_rank] < big)
    picks = jnp.where(has, row.astype(jnp.int32), -1)
    defer = valid & ~has
    return np.asarray(jnp.where(defer, -2, picks))


# ---- cases ------------------------------------------------------------------

def make_case(rng, n: int, c: int, kind: str, spec: bool = False):
    """(possible, crit, pf) numpy: criteria from few values (ties) unless
    ``kind`` says otherwise."""
    crit = np.stack([rng.integers(0, 2, n), rng.integers(0, 3, n), rng.integers(0, 4, n),
                     rng.integers(0, 3, n), rng.integers(-3, 0, n)]).astype(np.int64)
    possible = rng.random(n) < 0.8
    if kind == "none possible":
        possible[:] = False
    elif kind == "all tied":
        crit[:] = 7
        possible[:] = True
    elif kind == "ties across slices":
        for step in (32, 313, 512, 625, 1024):  # slice and tile widths of the shapes
            for e in range(step, n, step):
                crit[:, max(0, e - 2):e + 2] = crit[:, e - 1:e]
    elif kind == "start key only":
        crit[:4] = 1
        crit[4] = rng.integers(-(2**61), 2**61, n)
    elif kind == "extremes":
        pool = np.array([-(2**62), 2**62, 2**62 - 1, 0, -(2**61)])
        crit = rng.choice(pool, (5, n)).astype(np.int64)
        crit[0] = rng.choice(np.array([-(2**62), 2**62 - 1, 0]), n)  # violations below the sentinel
    elif kind == "sentinel":  # violations at and past 2^62 on possible nodes
        crit[0] = np.where(rng.random(n) < 0.3, rng.choice(np.array([2**62, 2**62 + 5]), n), crit[0])
    elif kind == "few possible":
        possible[:] = False
        possible[rng.choice(n, min(n, 3), replace=False)] = True
    sig = (rng.integers(0, 2, c) if kind == "mixed signatures" else np.zeros(c)).astype(np.int32)
    valid = rng.random(c) < 0.9
    if spec:
        pf = {"sig": sig, "elig": valid, "spec_picks": np.where(rng.random(c) < 0.3, 4, -1).astype(np.int32)}
    else:
        pf = {"sig": sig, "valid": valid}
    return possible, crit, pf


def plain_picks(possible, crit, pf: dict, chunk_mode: bool) -> np.ndarray:
    tpf = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in pf.items()}
    out = plain.preempt_pick(torch.from_numpy(possible), torch.from_numpy(crit), tpf, chunk_mode)
    return out.numpy()


def check(possible, crit, pf: dict, k: int | None = None, reference: bool = True):
    """The emulation against plain preempt_pick and the reference's
    arithmetic (the chunk-1 narrowing at C = 1, the rank split above)."""
    c = pf["sig"].shape[0]
    chunk_mode = c > 1
    got, how = emulate(possible, crit, pf, chunk_mode, k)
    want = plain_picks(possible, crit, pf, chunk_mode)
    np.testing.assert_array_equal(got, want, err_msg=f"emulation vs plain at {how}")
    if not reference:
        return how
    if chunk_mode:
        np.testing.assert_array_equal(got, reference_rank_split(possible, crit, pf), err_msg=f"vs lexsort at {how}")
    elif mates_valid(pf)[0] and possible.any() == (possible & (crit[0] < BIG)).any():
        # The narrowing keeps a node whose violations reach the sentinel
        # when no possible node is below it, where the rank split (and so
        # the plain version and the kernel) gives none: violations count
        # PDB overruns and never come near 2^62.
        assert int(got[0]) == reference_narrowing(possible, crit), how
    return how


@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("n", NS)
def test_emulation_matches_plain_and_reference_at_every_split(n, c):
    """Drawn criteria at every cluster size K, pick_split's own K included,
    and every case kind at pick_split's K, with the mates valid and in the
    speculative view."""
    rng = np.random.default_rng(1800 + n + c)
    for k in SPLITS:
        possible, crit, pf = make_case(rng, n, c, "drawn", spec=k % 2 == 0)
        check(possible, crit, pf, k, reference=k in (1, 16))
    for kind in KINDS:
        for spec in (False, True):
            possible, crit, pf = make_case(rng, n, c, kind, spec)
            check(possible, crit, pf)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", SPLITS)
def test_case_kinds_at_every_split(kind, k):
    """Every case kind at K CTAs on the async shape's node count (5000) and
    a slice-sized one (1000), for C = 1, 8 and 1024."""
    rng = np.random.default_rng(100 * KINDS.index(kind) + k)
    for n in (1000, 5000):
        for c in (1, 8, 1024):
            possible, crit, pf = make_case(rng, n, c, kind, spec=c == 8)
            check(possible, crit, pf, k)


def test_tiled_mode_beyond_the_cluster():
    """Past 16 slices of one network (N > 16 * PICK_WIDTH) pick_split takes
    tiled mode at K = 16; its running lists stay exact when a slice's
    nodes are all in its last tile, all in its first, and C exceeds a
    tile."""
    n = CLUSTER_MAX * PICK_WIDTH + 3000
    assert pick_split(64, n)[:2] == (PICK_TILED, CLUSTER_MAX)
    rng = np.random.default_rng(1818)
    for c in (2, 64, 1024, 3000):
        possible, crit, pf = make_case(rng, n, c, "drawn")
        possible[: n // 2] = c % 2 == 0
        assert check(possible, crit, pf)[0] == PICK_TILED
    # Kept lists longer than a round holds (L = 2500 > PEER_RECS): read in
    # pieces, in the merge and across the slices.
    possible, crit, pf = make_case(rng, 6000, 2500, "drawn")
    assert check(possible, crit, pf, k=2)[:2] == (PICK_TILED, 2)


def test_c_beyond_n_and_mates_beyond_possible_nodes():
    """C > N (the 500-node path's rank split: C=512 over 500 rows): ranks
    past N - 1 are clipped to N - 1 and take the last row if every row is
    possible; more eligible mates than possible nodes: the rest get none
    (-2 at chunk > 1)."""
    rng = np.random.default_rng(7)
    n, c = 500, 512
    possible, crit, pf = make_case(rng, n, c, "drawn")
    possible[:] = True
    pf["valid"][:] = True
    got, _ = emulate(possible, crit, pf, True)
    assert (got[n - 1:] == got[n - 1]).all() and got[n - 1] >= 0
    np.testing.assert_array_equal(got, plain_picks(possible, crit, pf, True))
    np.testing.assert_array_equal(got, reference_rank_split(possible, crit, pf))
    possible[:] = False
    possible[[3, 200, 499]] = True
    got, _ = emulate(possible, crit, pf, True)
    assert sorted(got[:3].tolist()) == [3, 200, 499] and (got[3:] == -2).all()


def test_mixed_signatures_defer_and_speculative_view():
    """The representative is the first valid mate; other-signature mates
    defer (-2); in the speculative view, mates the main pass placed are not
    valid and keep -1."""
    rng = np.random.default_rng(11)
    n, c = 4096, 64
    possible, crit, pf = make_case(rng, n, c, "mixed signatures")
    pf["valid"][:3] = False
    check(possible, crit, pf)
    got = emulate(possible, crit, pf, True)[0]
    rep = pf["sig"][np.argmax(pf["valid"])]
    assert (got[3:][pf["valid"][3:] & (pf["sig"][3:] != rep)] == -2).all()
    assert (got[:3] == -1).all()
    possible, crit, pf = make_case(rng, n, c, "drawn", spec=True)
    got = emulate(possible, crit, pf, True)[0]
    placed = pf["elig"] & (pf["spec_picks"] >= 0)
    assert (got[placed | ~pf["elig"]] == -1).all()
    check(possible, crit, pf)


def test_pick_split_contract():
    """K is the smallest power of two with K * PICK_ROWS >= N, at most 16;
    argmin where min(C, N) <= 1; split where a slice fits one network
    (threads: S rounded up to a power of two, at least a warp); tiled past
    that, at K = 16 only; argmin threads S rounded up to a warp, at most
    PICK_ROWS."""
    seen = set()
    for n in (0, 1, 31, 500, 512, 513, 1000, 2000, 4096, 5000, 8192, 8193, 12000, 16384, 16385, 20000, 10**6):
        for c in (1, 2, 8, 1024):
            mode, k, s, threads = pick_split(c, n)
            seen.add((mode, k))
            want_k = 1
            while want_k < CLUSTER_MAX and want_k * PICK_ROWS < n:
                want_k *= 2
            assert k == want_k
            assert s == -(-n // k) and k * s >= n
            assert threads % 32 == 0 and 32 <= threads <= PICK_WIDTH
            if min(c, n) <= 1:
                assert mode == PICK_ARGMIN and threads == max(32, min(PICK_ROWS, -(-s // 32) * 32))
            elif s <= PICK_WIDTH:
                assert mode == PICK_SPLIT and threads >= s and threads & (threads - 1) == 0
                assert threads == 32 or threads // 2 < s
            else:
                assert mode == PICK_TILED and k == CLUSTER_MAX and threads == PICK_WIDTH
    assert seen >= {(PICK_ARGMIN, k) for k in SPLITS} | {(PICK_SPLIT, k) for k in SPLITS} | {(PICK_TILED, 16)}


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 400), st.integers(1, 40), st.sampled_from(SPLITS), st.booleans(), st.data())
def test_hypothesis_drawn_sets(n, c, k, spec, data):
    """Small drawn sets: criteria from a handful of values (many ties),
    possible flags, mates, signatures and the speculative view."""
    vals = data.draw(st.lists(st.integers(-(2**62), 2**62 - 1), min_size=1, max_size=4))
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    crit = rng.choice(np.array(vals, dtype=np.int64), (5, n))
    possible = rng.random(n) < data.draw(st.floats(0.0, 1.0))
    sig = rng.integers(0, 2, c).astype(np.int32)
    valid = rng.random(c) < 0.8
    pf = ({"sig": sig, "elig": valid, "spec_picks": np.where(rng.random(c) < 0.3, 1, -1).astype(np.int32)}
          if spec else {"sig": sig, "valid": valid})
    check(possible, crit, pf, k)
