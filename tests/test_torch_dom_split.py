"""build_dom's one launch (kubernetes_tpu_torch/kernels/csrc/build_dom.cu),
emulated here in plain numpy step for step: the table rows (G group rows,
then ET term rows) cut into groups of R a CTA; the node axis cut over the K
CTAs of a thread block cluster into slices of S rows, walked in steps of
4 x threads nodes, thread t taking node group t (4 nodes); the CTA's rows
in passes (one row with R = 1, DOM_PASS rows with R > 1); with TK = 4 the
topology tile, thread t's 4 node rows (-1 at and past the slice end)
loaded into its registers at its first non-zero count of a step and kept
for every later row of the step, else each value read from topo_vals as a
count needs it; each non-zero count added to its column k*DV + v of the
CTA's table by its own lane's atomic; then each CTA's disjoint 1/K share
of the cells summed over the K partial tables and written as f32, every
cell written once.  It is held exactly against the JAX pass's build_dom
(kubernetes_tpu/engine/pass_.py:96-119, the one-hot of
ops/helpers.py:25) and the port's plain version: at every (R, K) dom_split
gives, K = 1, 2, 4, 8, 16; at forced geometries on small N (N not a
multiple of S or of 4, N = 1); with G = 0 or ET = 0; with et_slot outside
[0, TK), -1 keys and hostname ids both >= DV and inside [0, DV); with
every count on one domain (a warp's 32 lanes on one cell); with a domain's
sum near 2^24; with a DV so large that R shrinks, to 1.  dom_split's own
contract is in tests/test_torch_kernels.py.  Tolerance: none (exact)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu  # noqa: F401  (turns on JAX's int64)
from kubernetes_tpu.engine.pass_ import build_dom as jax_build_dom
from kubernetes_tpu_torch.kernels import (
    CLUSTER_MAX, DOM_CTAS_PER_SM, DOM_PASS, DOM_ROWS_MIN, DOM_SMEM_CAP, DOM_THREADS, DOM_VEC, DOM_WAVE,
    dom_columns, dom_slices, dom_split, plain,
)

SPLITS = (1, 2, 4, 8, 16)


# ---- the kernel, emulated ---------------------------------------------------

def columns(vals: np.ndarray, tk: int, dv: int) -> np.ndarray:
    """(..., TK) topology values → (..., TK) columns k*DV + v, -1 where the
    value is missing or >= DV."""
    k = np.arange(tk)
    return np.where((vals >= 0) & (vals < dv), k * dv + vals, -1)


def emulate(gc, ec, topo, slot, dv: int, geometry: tuple, stats: dict | None = None):
    """(group_dom (G, TK, DV) f32, et_dom (ET, DV) f32) as build_dom's
    launch with ``geometry`` (R, K, S, threads) computes them.  ``stats``
    counts the passes, the adds and the tile loads (threads that loaded
    their topology rows in a step)."""
    r_cta, k_cta, s, threads = geometry
    g, n = gc.shape
    et, tk = ec.shape[0], topo.shape[1]
    rows, w = g + et, max(tk, 1) * dv
    assert r_cta >= 1 and k_cta in SPLITS and s % DOM_VEC == 0 and k_cta * s >= n
    assert 32 <= threads <= DOM_THREADS and threads % 32 == 0 and r_cta * w * 4 <= DOM_SMEM_CAP
    source = dom_columns(tk)
    per_pass = 1 if r_cta == 1 else DOM_PASS
    counts = np.concatenate([gc, ec]).astype(np.int64)
    keys = np.concatenate([np.full(g, -2), np.where((slot >= 0) & (slot < tk), slot, -1)]).astype(np.int64)
    group_flat = np.full(g * tk * dv, np.nan, np.float32)
    et_flat = np.full(et * dv, np.nan, np.float32)
    written = np.zeros(g * tk * dv + et * dv, np.int64)
    stats = {} if stats is None else stats
    stats.setdefault("columns", set()).add(source)
    for key in ("passes", "adds", "tile_loads"):
        stats.setdefault(key, 0)
    for r0 in range(0, rows, r_cta):
        r1 = min(rows, r0 + r_cta)
        tables = np.zeros((k_cta, r1 - r0, w), np.int64)
        for rank in range(k_cta):
            s0 = min(n, rank * s)
            s1 = min(n, s0 + s)
            for base in range(s0, s1, DOM_VEC * threads):
                # Thread t's node group t; its topology rows, -1 at and past
                # the slice end: what its registers hold once loaded, or
                # what topo_vals gives it.
                nodes = base + DOM_VEC * np.arange(threads)[:, None] + np.arange(DOM_VEC)[None, :]
                inside = nodes < s1
                safe = np.minimum(nodes, n - 1)
                vals = np.where(inside[:, :, None], topo[safe], -1)  # (T, 4, TK)
                have = np.zeros(threads, bool)  # the tile loaded this step
                for rp in range(r0, r1, per_pass):
                    stats["passes"] += 1
                    batch = range(rp, min(r1, rp + per_pass))
                    cnts = {row: np.where(inside, counts[row][safe], 0) for row in batch}
                    live = np.zeros(threads, bool)
                    for row in batch:
                        if keys[row] != -1:
                            live |= (cnts[row] != 0).any(axis=1)
                    if source == "registers":
                        stats["tile_loads"] += int((live & ~have).sum())
                        have |= live
                    for row in batch:
                        key = keys[row]
                        if key == -1:
                            continue
                        off = 0 if key == -2 else key * dv  # a term row's cells are its key's DV
                        cnt = cnts[row]
                        for k in (range(tk) if key == -2 else (key,)):
                            v = vals[:, :, k]
                            col = np.where((v >= 0) & (v < dv), k * dv + v, -1)
                            on = (cnt != 0) & (col >= 0)
                            if source == "registers":
                                assert have[on.any(axis=1)].all()  # a thread adds only from its loaded tile
                            np.add.at(tables[rank, row - r0], col[on] - off, cnt[on])
                            stats["adds"] += int(on.sum())
        # The cluster's sum: CTA ``rank`` takes cells [rank*share, ...).
        cells = (r1 - r0) * w
        share = -(-cells // k_cta)
        for rank in range(k_cta):
            i = np.arange(rank * share, min(cells, (rank + 1) * share))
            row, c = r0 + i // w, i % w
            sums = tables[:, i // w, c].sum(axis=0)
            grp = (row < g) & (c < tk * dv)
            term = (row >= g) & (c < dv)
            group_flat[row[grp] * tk * dv + c[grp]] = sums[grp]
            et_flat[(row[term] - g) * dv + c[term]] = sums[term]
            np.add.at(written, np.concatenate([row[grp] * tk * dv + c[grp],
                                               g * tk * dv + (row[term] - g) * dv + c[term]]), 1)
    assert (written == 1).all()  # every cell written once, no memset needed
    assert (np.abs(tables) < 2**31).all()  # int32 tables
    return group_flat.reshape(g, tk, dv), et_flat.reshape(et, dv)


# ---- references -------------------------------------------------------------

def reference(gc, ec, topo, slot, dv: int):
    """The JAX pass's build_dom on the same inputs: (group_dom, et_dom)."""
    state = SimpleNamespace(group_counts=jnp.asarray(gc), et_counts=jnp.asarray(ec), topo_vals=jnp.asarray(topo))
    dom = jax_build_dom(state, jnp.asarray(slot), jnp.zeros(ec.shape[0], bool), dv)
    return np.asarray(dom.group_dom), np.asarray(dom.et_dom)


def plain_dom(gc, ec, topo, slot, dv: int):
    state = SimpleNamespace(group_counts=torch.from_numpy(gc), et_counts=torch.from_numpy(ec),
                            topo_vals=torch.from_numpy(topo))
    gd, ed = plain.build_dom(state, torch.from_numpy(slot), dv)
    return gd.numpy(), ed.numpy()


def make_case(rng, g: int, et: int, n: int, tk: int, dv: int, kind: str = "drawn"):
    """Seeded (group_counts, et_counts, topo_vals, et_slot): topology
    values over [-1, DV + 3) (missing keys and hostname-like ids past DV),
    key 0 hostname ids (the node's row, inside [0, DV) for the first rows),
    slots over [-1, TK + 1), counts zero on most nodes; or as ``kind``
    says: every count on one domain (one cell for a whole warp), or a
    domain's sum near 2^24."""
    topo = rng.integers(-1, dv + 3, (n, tk)).astype(np.int32)
    if tk:
        topo[:, 0] = np.arange(n)  # hostname: ids inside [0, DV) for rows < DV, past it after
    gc = np.where(rng.random((g, n)) < 0.3, rng.integers(1, 9, (g, n)), 0).astype(np.int32)
    ec = np.where(rng.random((et, n)) < 0.3, rng.integers(1, 9, (et, n)), 0).astype(np.int32)
    slot = rng.integers(-1, tk + 2, et).astype(np.int32)
    if kind == "one domain":
        topo[:] = min(1, dv - 1) if dv else -1
        gc[:] = rng.integers(1, 4, (g, n))
        ec[:] = rng.integers(1, 4, (et, n))
        slot = np.full(et, tk - 1 if tk else 0, np.int32)
    elif kind == "near 2^24":
        topo[:] = 0
        per = (2**24 - 7) // n
        gc[:] = per
        ec[:] = per
        gc[:, -1] = ec[:, -1] = 2**24 - 7 - per * (n - 1)
        slot = np.zeros(et, np.int32)
    return gc, ec, topo, slot


def check(gc, ec, topo, slot, dv: int, geometry: tuple, stats: dict | None = None):
    got = emulate(gc, ec, topo, slot, dv, geometry, stats)
    want = reference(gc, ec, topo, slot, dv)
    plain_out = plain_dom(gc, ec, topo, slot, dv)
    for name, a, b, p in zip(("group_dom", "et_dom"), got, want, plain_out):
        assert a.dtype == b.dtype == p.dtype == np.float32 and a.shape == b.shape == p.shape, name
        np.testing.assert_array_equal(a, b, err_msg=f"{name} at {geometry}")
        np.testing.assert_array_equal(p, b, err_msg=f"plain {name}")


# ---- tests ------------------------------------------------------------------

@pytest.mark.parametrize("k", SPLITS)
def test_emulation_at_the_split_dom_split_gives(k):
    """Each K of dom_split's few-rows branch: 3 rows on 64 SMs want K = 16,
    halved to K at N = K x DOM_ROWS_MIN + 37 (K CTAs of at least
    DOM_ROWS_MIN rows, the last slice short)."""
    rng = np.random.default_rng(1900 + k)
    g, et, tk, dv = 2, 1, 4, 8
    n = k * DOM_ROWS_MIN + 37
    assert (g + et) * CLUSTER_MAX < DOM_CTAS_PER_SM * 64
    geometry = dom_split(g + et, n, tk, dv, 64)
    assert geometry[:2] == (1, k)
    check(*make_case(rng, g, et, n, tk, dv), dv, geometry)


@pytest.mark.parametrize("sms", (1, 2, 5, 16))
def test_emulation_at_many_rows_a_cta(sms):
    """dom_split's many-rows side: R = ceil(rows / (DOM_WAVE x SMs)) rows a
    CTA (K = 1; 11, 6, 3 and 1 of 41 rows, the last CTA's rows fewer), at
    N = 300; and R = 20 forced: passes of DOM_PASS rows, every thread with
    a non-zero count loading its tile once a step however many rows
    follow."""
    rng = np.random.default_rng(1910 + sms)
    g, et, n, tk, dv = 23, 18, 300, 4, 16
    geometry = dom_split(g + et, n, tk, dv, sms)
    assert geometry[1] == 1 and geometry[0] == -(-(g + et) // (DOM_WAVE * sms))
    case = make_case(rng, g, et, n, tk, dv)
    stats: dict = {}
    check(*case, dv, geometry, stats)
    assert stats["columns"] == {"registers"}
    stats = {}
    check(*case, dv, (20, 1, *dom_slices(n, 1)), stats)
    assert stats["passes"] == 10 + 10 + 1  # rows 0-19 and 20-39 in passes of 2, row 40 alone
    # One tile load a (CTA, node group) where a row of the CTA with a key
    # has a non-zero count (one step: 96 threads cover the 300 nodes).
    gc, ec, _, slot = case
    live = np.concatenate([gc, ec]) != 0
    live[g:] &= ((slot >= 0) & (slot < tk))[:, None]
    groups = np.pad(live, ((0, 0), (0, -n % DOM_VEC))).reshape(g + et, -1, DOM_VEC).any(axis=2)
    assert stats["tile_loads"] == sum(int(groups[r0:r0 + 20].any(axis=0).sum()) for r0 in (0, 20, 40))


@pytest.mark.parametrize("n", (1, 3, 5, 31, 130, 517, 1030))
@pytest.mark.parametrize("k", SPLITS)
def test_emulation_at_forced_splits_on_small_n(n, k):
    """Any K over small N, with R = 1 and R = 5: slices of ceil(N/K)
    rounded up to 4 rows, so that the last slices are short or empty; N = 1
    and N not a multiple of 4 (the scalar tail)."""
    rng = np.random.default_rng(1920 + n * 17 + k)
    g, et, tk, dv = 3, 4, 3, 6
    case = make_case(rng, g, et, n, tk, dv)
    s, threads = dom_slices(n, k)
    for r in (1, 5):
        check(*case, dv, (r, k, s, threads))


def test_emulation_walks_a_slice_in_steps():
    """A slice wider than 4 x threads nodes is walked in steps, the tables
    carried across them: 32 threads over 1000 rows (8 steps)."""
    rng = np.random.default_rng(1930)
    case = make_case(rng, 3, 2, 1000, 4, 8)
    check(*case, 8, (2, 1, 1000, 32))
    check(*case, 8, (3, 2, 500, 64))


@pytest.mark.parametrize("g,et", [(0, 5), (5, 0), (1, 0), (0, 1)])
def test_emulation_without_group_or_term_rows(g, et):
    rng = np.random.default_rng(1940 + g * 7 + et)
    n, tk, dv = 257, 4, 8
    case = make_case(rng, g, et, n, tk, dv)
    for k in SPLITS:
        s, threads = dom_slices(n, k)
        check(*case, dv, (2, k, s, threads))


def test_emulation_slots_keys_and_hostname_ids():
    """et_slot outside [0, TK) on both sides (zero rows), -1 keys, values
    past DV, and hostname ids inside [0, DV) on the first rows (they add
    as the one-hot adds them)."""
    rng = np.random.default_rng(1950)
    n, tk, dv = 200, 4, 16
    gc, ec, topo, _ = make_case(rng, 4, 6, n, tk, dv)
    slot = np.array([-1, 0, 3, 4, 7, 2], np.int32)
    topo[::7, 1] = -1
    for k in (1, 4, 16):
        s, threads = dom_slices(n, k)
        check(gc, ec, topo, slot, dv, (3, k, s, threads))
    want_g, want_e = reference(gc, ec, topo, slot, dv)
    assert (want_e[[0, 3, 4]] == 0).all() and want_e[[1, 2, 5]].sum() > 0
    assert want_g[:, 0, :].sum() > 0  # hostname ids inside [0, DV) counted


@pytest.mark.parametrize("k", SPLITS)
def test_emulation_with_a_warp_on_one_cell(k):
    """Every count on one domain: the 32 lanes of every warp add to one
    cell."""
    rng = np.random.default_rng(1960 + k)
    n, tk, dv = 700, 4, 8
    case = make_case(rng, 3, 3, n, tk, dv, "one domain")
    s, threads = dom_slices(n, k)
    stats: dict = {}
    check(*case, dv, (2, k, s, threads), stats)
    assert stats["adds"] == 3 * n * tk + 3 * n  # every count, every key of a group row, one of a term row


def test_emulation_sums_near_2_24():
    """A domain's counts summing to 2^24 - 7 over every node: exact in the
    int32 sums and in the JAX f32 product alike."""
    rng = np.random.default_rng(1970)
    n, tk, dv = 300, 2, 4
    case = make_case(rng, 2, 2, n, tk, dv, "near 2^24")
    for k in (1, 8):
        s, threads = dom_slices(n, k)
        check(*case, dv, (1, k, s, threads))
    want_g, want_e = reference(*case, dv)
    assert want_g[0, 0, 0] == 2**24 - 7 and want_e[0, 0] == 2**24 - 7


@pytest.mark.parametrize("tk,dv", [(4, 3000), (3, 3000), (4, 13000), (4, 14528), (3, 15000), (3, 19000), (8, 7200)])
def test_emulation_with_r_shrunk_to_one(tk, dv):
    """A DV so large that R shrinks: 60 rows on one SM want R = 15; at
    DV=3000 the tables leave room for a few rows (4 with TK=4, 6 with
    TK=3); at DV=13000 and at the cap (TK x DV = 58112 cells, 227 KB) for
    one.  The domain values in registers with TK=4, from topo_vals
    else."""
    rng = np.random.default_rng(1980 + dv + tk)
    g, et, n = 40, 20, 200
    geometry = dom_split(g + et, n, tk, dv, 1)
    stats: dict = {}
    check(*make_case(rng, g, et, n, tk, dv), dv, geometry, stats)
    r = geometry[0]
    assert r * tk * dv * 4 <= DOM_SMEM_CAP < (r + 1) * tk * dv * 4
    assert r == {3000: 4 if tk == 4 else 6}.get(dv, 1)
    assert stats["columns"] == {"registers" if tk == 4 else "topo_vals"}


def test_emulation_at_the_chunk_one_and_ipa_shapes_cut():
    """The paths' two regimes at cut sizes: few rows over many nodes (as
    "c1": G = ET = 8, TK = 4, DV = 8) at K = 8 and 16, and many rows over
    few nodes (as "ipa": K = 1, R rows a CTA) at 40 and 8 SMs."""
    rng = np.random.default_rng(1990)
    case = make_case(rng, 8, 8, 2048, 4, 8)
    for k in (8, 16):
        s, threads = dom_slices(2048, k)
        check(*case, 8, (1, k, s, threads))
    case = make_case(rng, 96, 96, 256, 4, 16)
    geometry = dom_split(192, 256, 4, 16, 40)
    assert geometry[:2] == (2, 1)
    check(*case, 16, geometry)
    geometry = dom_split(192, 256, 4, 16, 8)
    assert geometry[:2] == (6, 1)
    check(*case, 16, geometry)
