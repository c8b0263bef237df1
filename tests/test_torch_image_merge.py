"""image_scores' tiled design (kernels/csrc/image_locality.cu), emulated in
numpy step for step and held exactly against the plain plane
(kubernetes_tpu_torch/ops/imagelocality.py image_scores) and the JAX op's
score_fn: image_merge's bitonic network over a warp of P / 32 slots a lane,
its segmented run sums and list positions; image_tile's element-major
staging, the branchless binary search over the tile's longest list, the
pods staged in groups of 32 with their known ids and spreads, the low
score of a sum at or below 23 MiB; and the launch shape (image_grid).
Cases: duplicate ids in one node row, -1 slots among the ids, node ids at
or above the vocabulary, a wanted id named twice, unknown wanted ids,
padding lanes, CI = 1 and 16, N not a multiple of the tile, P from 32 to
512, and chip_smoke.py's rounding cases.  Tolerance: none (exact)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops import imagelocality as _jax_il  # noqa: F401  (registers the op)
from kubernetes_tpu_torch.kernels import IMAGE_GROUP, IMAGE_SLOTS_MAX, IMAGE_TILE, image_grid, plain
from kubernetes_tpu_torch.ops.imagelocality import MAX_CONTAINER_THRESHOLD, MB, MIN_THRESHOLD

from chip_smoke import threshold_cases

SENT = np.uint32(0xFFFFFFFF)
VALID_KEY = np.uint32(0x80000000)
UNWRITTEN = np.uint32(0xDEADBEEF)


def _shfl_up(a, d):
    """__shfl_up_sync over the lane axis (1): a lane below d keeps its own."""
    out = a.copy()
    out[:, d:] = a[:, :-d]
    return out


def emulate_merge(ids: np.ndarray, sizes: np.ndarray, p: int):
    """image_merge_kernel<P / 32> on every row: (m_ids (N, P) u32, m_sizes
    (N, P) i64, m_len (N,))."""
    n, im = ids.shape
    e_ = p // 32
    key = np.full((n, p), SENT, np.uint32)
    val = np.zeros((n, p), np.int64)
    key[:, :im] = ids.astype(np.int32).view(np.uint32)
    val[:, :im] = sizes
    idx = np.arange(p)
    k = 2
    while k <= p:  # the bitonic network: slot i meets i ^ j
        j = k // 2
        while j > 0:
            partner = idx ^ j
            pk, pv = key[:, partner], val[:, partner]
            up = (idx & k) == 0
            lower = (idx & j) == 0
            take = np.where(lower == up, pk < key, pk > key)
            key, val = np.where(take, pk, key), np.where(take, pv, val)
            j //= 2
        k *= 2
    kl, vl = key.reshape(n, 32, e_), val.reshape(n, 32, e_)  # lane l holds slots l E .. l E + E - 1
    lane = np.arange(32)[None, :]
    prev_last = _shfl_up(kl[:, :, e_ - 1], 1)
    next_first = kl[:, :, 0].copy()
    next_first[:, :-1] = kl[:, 1:, 0]
    head = np.zeros((n, 32, e_), bool)
    run = np.zeros((n, 32, e_), np.int64)
    for e in range(e_):
        if e == 0:
            head[:, :, 0] = (lane == 0) | (kl[:, :, 0] != prev_last)
            run[:, :, 0] = vl[:, :, 0]
        else:
            head[:, :, e] = kl[:, :, e] != kl[:, :, e - 1]
            run[:, :, e] = np.where(head[:, :, e], vl[:, :, e], run[:, :, e - 1] + vl[:, :, e])
    heads = head.sum(2)
    valid_heads = (head & (kl < VALID_KEY)).sum(2)
    s, f, hs = run[:, :, e_ - 1].copy(), heads > 0, heads.copy()
    d = 1
    while d < 32:  # the segmented inclusive scan over the lanes
        s_up, f_up, h_up = _shfl_up(s, d), _shfl_up(f, d), _shfl_up(hs, d)
        on = lane >= d
        s = np.where(on & ~f, s + s_up, s)
        f = np.where(on, f | f_up, f)
        hs = np.where(on, hs + h_up, hs)
        d *= 2
    carry = _shfl_up(s, 1)
    carry[:, 0] = 0
    length = valid_heads.sum(1)
    seen = hs - heads
    opened = np.ones((n, 32), bool)
    m_ids = np.full((n, p), UNWRITTEN, np.uint32)
    m_sizes = np.zeros((n, p), np.int64)
    rows = np.arange(n)[:, None].repeat(32, 1)
    for e in range(e_):
        opened &= ~head[:, :, e]
        run[:, :, e] += np.where(opened, carry, 0)
        seen = seen + head[:, :, e]
        if e < e_ - 1:
            tail = kl[:, :, e + 1] != kl[:, :, e]
        else:
            tail = (lane == 31) | (next_first != kl[:, :, e])
        w = tail & (kl[:, :, e] < VALID_KEY)
        m_ids[rows[w], seen[w] - 1] = kl[:, :, e][w]
        m_sizes[rows[w], seen[w] - 1] = run[:, :, e][w]
        slot = lane * e_ + e
        past = slot >= length[:, None]
        m_ids[rows[past], slot.repeat(n, 0)[past]] = SENT
    return m_ids, m_sizes, length


def finish(sums: np.ndarray, ncont) -> np.ndarray:
    """calculatePriority as the kernel's finish (int64, floor division)."""
    max_t = MAX_CONTAINER_THRESHOLD * np.int64(ncont)
    clamped = np.minimum(np.maximum(sums, MIN_THRESHOLD), max_t)
    denom = np.maximum(max_t - MIN_THRESHOLD, 1)
    return (100 * (clamped - MIN_THRESHOLD) // denom).astype(np.uint8)


def emulate_tile(m_ids, m_sizes, m_len, counts, pod_ids, ncont, pod_valid, n: int, slices: int, per: int):
    """image_tile_kernel over its (ceil(N / 32), slices) grid: the (K, N)
    u8 plane; every entry must be written."""
    k, ci = pod_ids.shape
    v = counts.shape[0] - 1
    total = counts[v] if counts[v] > 1 else 1
    out = np.full((k, n), 999, np.int64)  # 999: not written
    lane = np.arange(IMAGE_TILE)
    for bx in range(-(-n // IMAGE_TILE)):
        n0 = bx * IMAGE_TILE
        live_t = n0 + lane < n
        smax = max([0] + [int(m_len[n0 + t]) for t in lane if live_t[t]])
        pt = 8
        while pt < smax:
            pt *= 2
        s_id = np.full((pt, IMAGE_TILE), SENT, np.uint32)  # element-major: entry j of lane t at [j, t]
        s_size = np.zeros((pt, IMAGE_TILE), np.int64)
        s_id[:, live_t] = m_ids[n0 + lane[live_t], :pt].T
        s_size[:, live_t] = m_sizes[n0 + lane[live_t], :pt].T
        for by in range(slices):
            kb, ke = by * per, min(k, by * per + per)
            for g0 in range(kb, ke, IMAGE_GROUP):
                staged = []  # what the group's first warp stages, a pod a thread
                for kk in range(g0, min(g0 + IMAGE_GROUP, ke)):
                    if not pod_valid[kk]:
                        staged.append(None)
                        continue
                    live = []
                    for q in range(ci):
                        w = int(pod_ids[kk, q])
                        cnt = int(counts[w]) if 0 <= w < v else 0
                        if cnt > 0:
                            live.append((np.uint32(w), np.float64(cnt) / np.float64(total)))
                    staged.append((live, int(ncont[kk]), finish(np.zeros(1, np.int64), ncont[kk])[0]))
                for p, pod in enumerate(staged):
                    score = np.zeros(IMAGE_TILE, np.int64)
                    if pod is not None:
                        live, nc, low = pod
                        sums = np.zeros(IMAGE_TILE, np.int64)
                        for w, spread in live:
                            base = np.zeros(IMAGE_TILE, np.int64)
                            half = pt // 2
                            while half > 0:
                                base = np.where(s_id[base + half, lane] <= w, base + half, base)
                                half //= 2
                            hit = s_id[base, lane] == w
                            term = (s_size[base, lane].astype(np.float64) * spread).astype(np.int64)
                            sums += np.where(hit, term, 0)
                        score = np.where(sums <= MIN_THRESHOLD, low, finish(sums, nc))
                    out[g0 + p, n0 + lane[live_t]] = score[live_t]
    assert (out < 256).all(), "an entry of the plane was not written"
    return out.astype(np.uint8)


def emulate_scores(ids, sizes, valid, pod_ids, ncont, pod_valid, vocab: int, sms: int = 132):
    """The whole entry point as the wrapper launches it, and the counts it
    read (the plain image_counts)."""
    n, im = ids.shape
    state = SimpleNamespace(image_ids=torch.from_numpy(ids), image_sizes=torch.from_numpy(sizes),
                            valid=torch.from_numpy(valid))
    counts = plain.image_counts(state, vocab).numpy()
    p, slices, per = image_grid(n, pod_ids.shape[0], im, sms)
    m_ids, m_sizes, m_len = emulate_merge(ids, sizes, p)
    assert not (m_ids == UNWRITTEN).any()
    return emulate_tile(m_ids, m_sizes, m_len, counts, pod_ids, ncont, pod_valid, n, slices, per), state, counts


def plain_scores(state, pod_ids, ncont, pod_valid, counts):
    pf = {"il_image_ids": torch.from_numpy(pod_ids), "il_ncontainers": torch.from_numpy(ncont),
          "valid": torch.from_numpy(pod_valid)}
    return plain.image_scores(state, pf, torch.from_numpy(counts)).numpy()


def jax_scores(ids, sizes, valid, pod_ids, ncont):
    """kubernetes_tpu/ops/imagelocality.py score_fn a pod, vmapped."""
    st = SimpleNamespace(image_ids=jnp.asarray(ids), image_sizes=jnp.asarray(sizes), valid=jnp.asarray(valid))
    op = jcommon.get("ImageLocality")
    pf = {"il_image_ids": jnp.asarray(pod_ids), "il_ncontainers": jnp.asarray(ncont)}
    return np.asarray(jax.vmap(lambda q: op.score(st, q, None, None))(pf))


def random_case(seed: int, n: int, im: int, k: int, ci: int, vocab: int):
    """Node rows of ``im`` slots: runs of ids drawn from [0, vocab + 4)
    (some at or above the vocabulary) with repeats inside a row and -1
    slots among them, sizes up to 2^34, one row in 9 invalid; ``k`` pods
    of ``ci`` ids from [-1, vocab + 6) (unknown ones among them), one in 5
    naming an id twice, one in 7 a padding lane, 1-4 containers."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, im), -1, np.int32)
    sizes = np.zeros((n, im), np.int64)
    for r in range(n):
        fill = int(rng.integers(0, im + 1))
        row = rng.integers(0, vocab + 4, size=fill).astype(np.int32)
        if fill > 2 and rng.random() < 0.5:
            row[rng.integers(fill)] = row[0]  # an id twice in one row
        if fill > 3:
            row[rng.choice(fill, max(1, fill // 8), replace=False)] = -1
        ids[r, :fill] = row
        sizes[r, :fill] = rng.integers(1, 2**34, size=fill)
        if rng.random() < 0.3:  # a -1 slot before live ones
            ids[r] = np.roll(ids[r], int(rng.integers(im)))
            sizes[r] = np.roll(sizes[r], int(rng.integers(im)))
    valid = rng.random(n) > 1 / 9
    pod_ids = rng.integers(-1, vocab + 6, size=(k, ci)).astype(np.int32)
    pod_ids[rng.random((k, ci)) < 0.2] = -1
    twice = rng.random(k) < 0.2
    if ci > 1:
        pod_ids[twice, 1] = pod_ids[twice, 0]
    ncont = rng.integers(1, 5, size=k).astype(np.int64)
    pod_valid = rng.random(k) > 1 / 7
    return ids, sizes, valid, pod_ids, ncont, pod_valid


CASES = [  # seed, N, IM, K, CI, vocab
    (0, 70, 8, 40, 1, 6),
    (1, 96, 40, 33, 16, 30),
    (2, 37, 128, 64, 4, 200),
    (3, 130, 64, 100, 2, 12),
    (4, 33, 300, 20, 3, 500),
    (5, 64, 32, 70, 16, 3),
]


@pytest.mark.parametrize("seed,n,im,k,ci,vocab", CASES)
def test_tiled_plane_matches_plain_and_jax(seed, n, im, k, ci, vocab):
    ids, sizes, valid, pod_ids, ncont, pod_valid = random_case(seed, n, im, k, ci, vocab)
    # A vocabulary below some node ids: those ids count for nothing.
    got, state, counts = emulate_scores(ids, sizes, valid, pod_ids, ncont, pod_valid, vocab)
    np.testing.assert_array_equal(got, plain_scores(state, pod_ids, ncont, pod_valid, counts))
    assert (got[~pod_valid] == 0).all()
    # A vocabulary over every id: the JAX op's counts.
    full = int(max(ids.max(), pod_ids.max())) + 1
    got, state, counts = emulate_scores(ids, sizes, valid, pod_ids, ncont, pod_valid, full)
    np.testing.assert_array_equal(got, plain_scores(state, pod_ids, ncont, pod_valid, counts))
    want = jax_scores(ids, sizes, valid, pod_ids, ncont)
    np.testing.assert_array_equal(got[pod_valid].astype(np.int64), want[pod_valid])
    assert 0 < (got > 0).sum() < got.size


@pytest.mark.parametrize("p", [32, 64, 128, 256, 512])
def test_merged_lists_are_each_rows_distinct_ids_with_summed_sizes(p):
    rng = np.random.default_rng(p)
    n, im = 23, p - int(rng.integers(0, p // 2))
    ids = rng.integers(-3, im // 2, size=(n, im)).astype(np.int32)  # repeats and negative ids
    ids[0] = -1  # an empty row
    ids[1] = 7  # one id in every slot
    ids[2, -1] = 2**31 - 1  # the largest id sorts below every negative one
    sizes = rng.integers(0, 2**40, size=(n, im))
    m_ids, m_sizes, m_len = emulate_merge(ids, sizes, p)
    for r in range(n):
        live = ids[r] >= 0
        want_ids = np.unique(ids[r][live])
        want_sizes = [sizes[r][ids[r] == v].sum() for v in want_ids]
        assert m_len[r] == len(want_ids)
        np.testing.assert_array_equal(m_ids[r, :m_len[r]], want_ids.astype(np.uint32))
        np.testing.assert_array_equal(m_sizes[r, :m_len[r]], want_sizes)
        assert (m_ids[r, m_len[r]:] == SENT).all()


def _rounding(total, cnt, size, ncont, twice):
    """``total`` nodes, the first ``cnt`` holding image 0 of ``size``, one
    pod naming it once or twice."""
    ids = np.full((total, 8), -1, np.int32)
    sizes = np.zeros((total, 8), np.int64)
    ids[:cnt, 0] = 0
    sizes[:cnt, 0] = size
    pod = np.array([[0, 0 if twice else -1]], np.int32)
    return ids, sizes, np.ones(total, bool), pod, np.array([ncont], np.int64), np.ones(1, bool)


def _rounding_cases():
    on, below = threshold_cases()
    mx, mn = MAX_CONTAINER_THRESHOLD, MIN_THRESHOLD
    twice = 100 * (2 * 400 * MB - mn) // (2 * mx - mn)
    return [("product on 1000 MiB", *on, 1, False, 100), ("product an ulp below", *below, 1, False, 99),
            ("23 MiB - 1", 4, 4, mn - 1, 1, False, 0), ("23 MiB", 4, 4, mn, 1, False, 0),
            ("1000 MiB x 2", 4, 4, 2 * mx, 2, False, 100), ("1000 MiB x 2 + 1", 4, 4, 2 * mx + 1, 2, False, 100),
            ("1000 MiB x 2 - 1", 4, 4, 2 * mx - 1, 2, False, 99),
            ("same image twice", 4, 4, 400 * MB, 2, True, twice)]


@pytest.mark.parametrize("case", _rounding_cases(), ids=lambda c: c[0])
def test_rounding_cases(case):
    _label, total, cnt, size, ncont, twice, score = case
    ids, sizes, valid, pod, nc, pv = _rounding(total, cnt, size, ncont, twice)
    got, state, counts = emulate_scores(ids, sizes, valid, pod, nc, pv, 1)
    np.testing.assert_array_equal(got, plain_scores(state, pod, nc, pv, counts))
    np.testing.assert_array_equal(got.astype(np.int64), jax_scores(ids, sizes, valid, pod, nc))
    assert got[0, 0] == score and (got[0, cnt:] == 0).all()


@pytest.mark.parametrize("n,k,im,sms", [
    (8192, 4096, 128, 132), (8192, 4096, 100, 132), (64, 4096, 8, 132), (1, 1, 1, 1), (8192, 1, 512, 132),
    (16384, 4096, 64, 132), (50, 33, 33, 8), (8192, 65535 * 2, 40, 132),
])
def test_image_grid(n, k, im, sms):
    """P covers IM in a power of two from 32; the slices cover every pod
    in whole groups, none empty, within the grid's y limit."""
    p, slices, per = image_grid(n, k, im, sms)
    assert p >= max(im, 32) and p & (p - 1) == 0 and p // 2 < max(im, 32)
    assert per % IMAGE_GROUP == 0 and slices * per >= k and (slices - 1) * per < k
    assert 1 <= slices <= 65535


def test_image_grid_refuses_rows_over_the_shared_memory_tile():
    image_grid(8192, 64, IMAGE_SLOTS_MAX, 132)
    with pytest.raises(NotImplementedError):
        image_grid(8192, 64, IMAGE_SLOTS_MAX + 1, 132)
