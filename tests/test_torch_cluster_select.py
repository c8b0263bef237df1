"""select_host's split of one pod's node axis over a thread block cluster
(kubernetes_tpu_torch/kernels/csrc/select_host.cu), emulated here in plain
numpy step for step: K CTAs a pod, each owning a slice of ceil(N/K) rows
rounded up to 32; each CTA's (max, ties at the max, feasible count), the
pod's triple and each CTA's tie offset from the K triples; in row mode the
CTA whose tie range holds kth ranks its ties in tiles of 512 rows, groups
of eight tiles, (tile, warp) counts scanned in row order; pos mode (one CTA
a pod) the bitmap of the ties' positions, the bit of rank kth and the row
holding that position; the nominated-node fast path.  It is held
against the JAX package's select_host (kubernetes_tpu/engine/pass_.py:136,
with eval_pod's nominated fast path, :548-553) and the port's plain
version (kernels/plain.py select_host), exactly, for K in 1, 2, 4, 8, 16,
N in 1, 31, 1000, 5000, 8192 and C in 1, 8, 64; on every row infeasible,
one feasible row, every row tied, ties only in the last slice, kth on a
slice boundary and totals at ±2^62; with nominated rows feasible and not;
in pos mode at the parity starts 0, 4999 and 2777; and on a
hypothesis-drawn set.  Also cluster_split's contract.  Tolerance: none
(exact)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import kubernetes_tpu  # noqa: F401  (turns on JAX's int64)
from kubernetes_tpu.engine.pass_ import _hash_u32
from kubernetes_tpu.engine.pass_ import select_host as jax_select_host
from kubernetes_tpu_torch.kernels import (
    CLUSTER_MAX, IPA_ROWS_MIN, IPA_SMEM_CAP, SELECT_ROWS_MIN, cluster_split, ipa_smem, plain,
)

THREADS, WARPS, ROWS = 512, 16, 8  # select_host.cu: kThreads, kWarps, kRows
NEG = -(2**62)
NO_POS = 1 << 30
SPLITS = (1, 2, 4, 8, 16)
SEED_MUL = (12345 * 2654435761) & 0xFFFFFFFF


def slices(n: int, k: int) -> list[tuple[int, int]]:
    size = ((n + k - 1) // k + 31) // 32 * 32
    out = []
    for r in range(k):
        lo = min(n, r * size)
        out.append((lo, min(n, lo + size)))
    return out


def hash_u32(x: int) -> int:
    x &= 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    x = ((x ^ (x >> 15)) * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def tile_search(ties: np.ndarray, lo: int, hi: int, q: int) -> int:
    """The row of the q-th tie (0-based) of the slice [lo, hi) as the
    kernel finds it: rows lo + tid + t*THREADS of tile t; a slice of one
    tile ranks by the warps' counts; a longer one takes groups of ROWS
    tiles, each group's (tile, warp) counts scanned in row order, then the
    warp's ballot."""
    tiles = -(-(hi - lo) // THREADS)
    for g in range(0, max(tiles, 1), ROWS):
        counts = []
        for j in range(ROWS):
            for w in range(WARPS):
                a = lo + (g + j) * THREADS + w * 32
                counts.append(int(ties[a:min(a + 32, hi)].sum()) if a < hi else 0)
        excl = np.concatenate([[0], np.cumsum(counts)])
        if q < excl[-1]:
            e = int(np.searchsorted(excl, q, side="right")) - 1
            j, w = divmod(e, WARPS)
            a = lo + (g + j) * THREADS + w * 32
            lanes = np.nonzero(ties[a:min(a + 32, hi)])[0]
            return a + int(lanes[q - excl[e]])
        q -= int(excl[-1])
    raise AssertionError("kth past the slice's ties")


def emulate(feasible, total, steps, nominated, pos, k: int):
    """The kernel on (C, N) numpy inputs, one cluster of ``k`` CTAs a pod:
    (pick, best, feasible count)."""
    c, n = feasible.shape
    picks, bests, counts = [], [], []
    for i in range(c):
        fe, to = feasible[i], total[i]
        parts = slices(n, k)
        trip = []
        for lo, hi in parts:
            v = to[lo:hi][fe[lo:hi]]
            mx = max(NEG, int(v.max())) if v.size else NEG
            trip.append((mx, int((v == mx).sum()), int(fe[lo:hi].sum())))
        best = max(t[0] for t in trip)
        m = sum(t[1] for t in trip if t[0] == best)
        kth = hash_u32(SEED_MUL + int(steps[i])) % max(m, 1)
        nom = -1 if nominated is None else int(nominated[i])
        if nom >= 0 and not fe[nom]:
            nom = -1
        ties = fe & (to == best)
        pick = -1
        if nom >= 0:
            pick, best = nom, int(to[nom])
        elif m and pos is None:
            off = 0
            for r, (lo, hi) in enumerate(parts):
                if trip[r][0] != best:
                    continue
                if off <= kth < off + trip[r][1]:
                    pick = tile_search(ties, lo, hi, kth - off)
                    break
                off += trip[r][1]
        elif m:
            # Pos mode runs one CTA a pod: the bitmap of the ties' positions,
            # the set bit of rank kth, the tie at that position.
            assert k == 1
            bits = np.zeros(n, bool)
            p = pos[np.nonzero(ties)[0]]
            bits[p[(p >= 0) & (p < n)]] = True
            thr = int(np.nonzero(bits)[0][kth])
            pick = int(np.nonzero(ties & (pos == thr))[0][0])
        picks.append(pick)
        bests.append(best)
        counts.append(int(fe.sum()))
    return np.array(picks, np.int32), np.array(bests, np.int64), np.array(counts, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_fn(with_pos: bool):
    fn = jax.vmap(jax_select_host, in_axes=(0, 0, 0, None) if with_pos else (0, 0, 0))
    return jax.jit(fn)


def reference(feasible, total, steps, nominated, pos):
    """The JAX package's select_host with eval_pod's nominated fast path."""
    tie_rand = _hash_u32(jnp.uint32(SEED_MUL) + jnp.asarray(steps).astype(jnp.uint32))
    args = (jnp.asarray(feasible), jnp.asarray(total), tie_rand)
    pick, best, _m = _jax_fn(pos is not None)(*args, *(() if pos is None else (jnp.asarray(pos),)))
    pick, best = np.asarray(pick), np.asarray(best)
    if nominated is not None:
        rows = np.arange(feasible.shape[0])
        safe = np.maximum(nominated, 0)
        use = (nominated >= 0) & feasible[rows, safe]
        pick = np.where(use, safe, pick)
        best = np.where(use, total[rows, safe], best)
    return pick.astype(np.int32), best.astype(np.int64), feasible.sum(axis=1).astype(np.int32)


def check(feasible, total, steps, nominated=None, pos=None, splits=SPLITS):
    want = reference(feasible, total, steps, nominated, pos)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got_plain = plain.select_host(t(feasible), t(total), t(np.asarray(steps, np.int64)), SEED_MUL, t(nominated),
                                  t(pos))
    for name, a, b in zip(("pick", "best", "feasible count"), got_plain, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"plain {name}")
    for k in splits:
        for name, a, b in zip(("pick", "best", "feasible count"), emulate(feasible, total, steps, nominated, pos, k),
                              want):
            np.testing.assert_array_equal(a, b, err_msg=f"K={k} {name}")


def kth_step(m: int, k: int) -> int:
    """A step whose hashed draw picks the (k+1)-th of m ties."""
    s = 0
    while m > 1 and hash_u32(SEED_MUL + s) % m != k:
        s += 1
    return s


def random_inputs(rng, c: int, n: int):
    """Per pod a feasible density and a spread of totals: few distinct
    totals (many ties) or wide ones."""
    feasible = np.zeros((c, n), bool)
    total = np.zeros((c, n), np.int64)
    for i in range(c):
        feasible[i] = rng.random(n) < rng.choice([0.0, 0.01, 0.3, 1.0])
        total[i] = rng.integers(0, rng.choice([1, 3, 1000]), n)
    return feasible, total, rng.integers(0, 2**32, c)


@pytest.mark.parametrize("c", [1, 8, 64])
@pytest.mark.parametrize("n", [1, 31, 1000, 5000, 8192])
@pytest.mark.parametrize("k", SPLITS)
def test_split_matches_jax_and_plain(k, n, c):
    rng = np.random.default_rng(n * 100 + c)
    feasible, total, steps = random_inputs(rng, c, n)
    check(feasible, total, steps, splits=(k,))


def _edge(case: str, n: int):
    """(feasible, total, steps) of one edge case at N=n, C=1."""
    rng = np.random.default_rng(7)
    feasible = np.zeros((1, n), bool)
    total = rng.integers(0, 5, (1, n))
    k = None
    if case == "all infeasible":
        pass
    elif case == "one feasible row":
        feasible[0, n - 1] = True
    elif case == "all tied":
        feasible[:] = True
        total[:] = 3
        k = n - 1
    elif case == "ties only in the last slice":
        lo = slices(n, 16)[-1][0]
        feasible[0, lo:] = True
        total[0, lo:] = 9
    elif case == "kth on a slice boundary":
        feasible[0, ::7] = True
        bounds = [lo for lo, _ in slices(n, 16)[1:]]
        feasible[0, [b - 1 for b in bounds] + bounds] = True
        total[0, [b - 1 for b in bounds] + bounds] = 9
        k = int(np.sum(feasible[0, :bounds[7]] & (total[0, :bounds[7]] == 9)))
    elif case == "totals near ±2^62":
        feasible[0] = rng.random(n) < 0.5
        total[0] = rng.choice(np.array([2**62 - 1, 2**62 - 2, NEG, NEG + 1]), n)
    m = int((feasible[0] & (total[0] == np.where(feasible[0], total[0], NEG).max())).sum()) if feasible.any() else 0
    return feasible, total.astype(np.int64), [kth_step(m, k if k is not None else m // 2)]


@pytest.mark.parametrize("case", ["all infeasible", "one feasible row", "all tied", "ties only in the last slice",
                                  "kth on a slice boundary", "totals near ±2^62"])
@pytest.mark.parametrize("k", SPLITS)
def test_edge_cases(k, case):
    check(*_edge(case, 8192), splits=(k,))


def test_kth_at_every_slice_first_and_last_tie():
    """Ties straddling every slice start of every split; kth at each
    slice's first tie and at the previous slice's last."""
    n = 8192
    starts = sorted({lo for k in SPLITS[1:] for lo, _ in slices(n, k)[1:]})
    rows = sorted({r for b in starts for r in (b - 1, b)})
    feasible = np.zeros((1, n), bool)
    feasible[0, rows] = True
    total = np.zeros((1, n), np.int64)
    for i, r in enumerate(rows):
        if r in starts:
            for kk in (i - 1, i):
                check(feasible, total, [kth_step(len(rows), kk)])


@pytest.mark.parametrize("k", SPLITS)
def test_nominated_rows(k):
    rng = np.random.default_rng(11)
    c, n = 64, 5000
    feasible, total, steps = random_inputs(rng, c, n)
    nominated = np.full(c, -1, np.int32)
    for i in range(0, c, 2):
        rows = np.nonzero(feasible[i] if i % 4 == 0 else ~feasible[i])[0]
        if rows.size:
            nominated[i] = rows[rng.integers(rows.size)]
    assert (nominated >= 0).any()
    check(feasible, total, steps, nominated, splits=(k,))


@pytest.mark.parametrize("density", [0.05, 0.5])
@pytest.mark.parametrize("start", [0, 4999, 2777])
def test_pos_mode_at_the_parity_starts(start, density):
    """Ties in rotated scan order (one CTA a pod): 5000 node rows of 8192
    in a random cache order, the scan starting at ``start``; kth at the
    first and last tie and on both sides of every 32-word boundary of the
    positions' bitmap."""
    n, nvalid = 8192, 5000
    rng = np.random.default_rng(start + 1)
    order = rng.permutation(nvalid)
    pos = np.full(n, NO_POS, np.int32)
    pos[:nvalid] = (order - start) % nvalid
    feasible = ((rng.random(n) < density) & (np.arange(n) < nvalid))[None]
    total = rng.integers(0, 2, (1, n)).astype(np.int64)
    ties = feasible[0] & (total[0] == total[0][feasible[0]].max())
    tpos = np.sort(pos[ties])
    ranks = {0, tpos.size - 1} | {int(np.searchsorted(tpos, b)) - d for b in range(1024, n, 1024) for d in (0, 1)}
    for r in sorted(x for x in ranks if 0 <= x < tpos.size):
        check(feasible, total, [kth_step(tpos.size, r)], pos=pos, splits=(1,))


@settings(max_examples=40, deadline=None)
@given(
    n=st.integers(1, 3000), c=st.sampled_from([1, 3, 8]), k=st.sampled_from(SPLITS), spread=st.integers(1, 4),
    density=st.floats(0.0, 1.0), with_pos=st.booleans(), seed=st.integers(0, 2**31),
)
def test_hypothesis_drawn(n, c, k, spread, density, with_pos, seed):
    rng = np.random.default_rng(seed)
    nvalid = int(rng.integers(1, n + 1))
    feasible = (rng.random((c, n)) < density) & (np.arange(n) < nvalid)
    total = rng.integers(-spread, spread, (c, n)).astype(np.int64)
    pos = None
    if with_pos:
        pos = np.full(n, NO_POS, np.int32)
        pos[:nvalid] = (rng.permutation(nvalid) - int(rng.integers(nvalid))) % nvalid
    nominated = np.where(rng.random(c) < 0.3, rng.integers(0, n, c), -1).astype(np.int32)
    check(feasible, total, rng.integers(0, 2**32, c), nominated, pos, splits=(1 if with_pos else k,))


# -- cluster_split ------------------------------------------------------------


@pytest.mark.parametrize("one_wave", [False, True])
@pytest.mark.parametrize("sms", [1, 16, 132, 144])
@pytest.mark.parametrize("rows_min", [SELECT_ROWS_MIN, IPA_ROWS_MIN, 1])
def test_cluster_split_contract(sms, rows_min, one_wave):
    """K is a power of two of at most 16, non-increasing in C, leaves each
    CTA at least rows_min rows (N // K), with one_wave puts at most one CTA
    on each SM (C·K <= sms), is the smallest with C·K >= sms where those
    caps allow, and is 1 at C >= sms."""
    for n in (1, 31, 512, 1000, 1024, 5000, 8192, 16384):
        last = CLUSTER_MAX
        for c in (1, 2, 3, 8, 33, 64, 128, 131, 132, 1024):
            k = cluster_split(c, n, sms, rows_min, one_wave=one_wave)
            assert k in (1, 2, 4, 8, 16) and k <= last
            assert k == 1 or n // k >= rows_min
            assert k == 1 or not one_wave or c * k <= sms
            if c >= sms:
                assert k == 1
            elif n // (2 * k) >= rows_min and k < CLUSTER_MAX and not (one_wave and c * 2 * k > sms):
                assert c * k >= sms  # a larger K was allowed, so this one already fills the card
            if k > 1:
                assert c * (k // 2) < sms  # the smallest that does
            last = k


def test_cluster_split_at_the_main_shapes():
    """The shapes of the paths' launches on a 132-SM card: select_host in
    row mode (one wave) and ipa_eval."""
    assert [cluster_split(c, n, 132, SELECT_ROWS_MIN, one_wave=True) for c, n in
            ((1, 8192), (8, 8192), (64, 8192), (128, 8192), (64, 1024), (8, 1024), (64, 512), (1024, 16384))] == \
        [8, 8, 2, 1, 1, 1, 1, 1]
    assert [cluster_split(c, n, 132, IPA_ROWS_MIN) for c, n in ((1, 8192), (64, 1024), (1, 1024), (8, 1024))] == \
        [16, 4, 8, 8]


def test_cluster_split_within_the_shared_memory_cap():
    """ipa_eval's split keeps a CTA's tables within IPA_SMEM_CAP: tables
    that fit once but not twice take one CTA a pod."""
    for ra, rs, pf, tk, dv in ((2, 1, 2, 4, 16), (4, 4, 4, 8, 256), (8, 8, 8, 8, 700), (1, 1, 1, 4, 3000)):
        k = cluster_split(1, 8192, 132, IPA_ROWS_MIN, lambda k: ipa_smem(ra, rs, pf, tk, dv, k))
        assert ipa_smem(ra, rs, pf, tk, dv, k) <= IPA_SMEM_CAP or k == 1
        if k == 1 and ipa_smem(ra, rs, pf, tk, dv, 2) <= IPA_SMEM_CAP:
            pytest.fail("a split that fits was refused")
    assert cluster_split(1, 8192, 132, IPA_ROWS_MIN, lambda k: ipa_smem(8, 8, 8, 8, 700, k)) == 1
    assert ipa_smem(8, 8, 8, 8, 700, 1) <= IPA_SMEM_CAP < ipa_smem(8, 8, 8, 8, 700, 2)
