"""truncate_feasible's H100 design on the CPU: the node count and
numFeasibleNodesToFind as constants of a pass, and the kernel's cut.

The pass hands every step the same (nvalid, limit) (``plain.scan_counts``
of the host's node count, ``inv["scan_nodes"]``, which it requires), where the
JAX truncated pass computes both in every step from its state
(kubernetes_tpu/engine/pass_.py:408-432, :510-532).  Held against that
pass over a batch whose commits fill nodes, so the feasible count falls
from above the limit to below it inside the batch: the JAX steps' cut
counts and processedNodes show the same two numbers, and the port's pass
equals the JAX pass (and refuses to run without the host's count).  A numpy
emulation of the kernel step by step (``trunc_shape``'s rows a thread in
registers, each row's feasible flag at its position, each warp's slice of
the flags as bitmap words and its count, every warp's own select of rank
limit-1 from the warp counts, the owning warp's words and the bit, and
processedNodes as the next set bit)
against the plain version:
0, 1, limit - 1, limit, limit + 1 and all rows feasible, starts at 0, at
nvalid - 1 and in the middle, padding rows past nvalid, N not a multiple of
the rows a thread, a padding lane.  Tolerance: none (exact)."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.cache import NO_POS
from kubernetes_tpu_torch.engine.pass_ import build_pass
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.kernels import plain

from test_torch_truncate import REAL, _sides


@pytest.mark.parametrize("pct", [None, 40])
def test_pass_constants_match_the_jax_steps_as_commits_fill_nodes(pct):
    n = 300
    nvalid, limit = plain.scan_counts(n, pct or 0)
    assert (nvalid, limit) == (300, 144 if pct is None else 120)
    # limit + 3 nodes take one pod each: the feasible count falls by one a
    # step, from over the limit to under it.
    j, t = _sides(n, set(range(limit + 3)), seed=None)
    jprof = replace(registered_subset(JDEF), percentage_of_nodes_to_score=pct)
    tprof = replace(TDEF, percentage_of_nodes_to_score=pct)
    s = j.b.schema
    jinv = dict(j.b.batch_invariants(), order_pos=j.cache.order_pos(s.N), scan_start=np.uint32(7))
    jrun = jax_build_pass(jprof, s, j.b.res_col, j.active, 1, carry_dom=True)
    jstate = j.b.state()
    jst, jout, _ = jrun(jstate, j.batch, jinv, np.uint32(3), jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                        jnp.zeros((s.ET, s.DV), jnp.float32), np.bool_(False))
    feas = np.asarray(jout.feasible_counts)[:REAL]
    processed = np.asarray(jout.processed)[:REAL]
    # Steps 0-2 cut to the limit; steps 3-5 keep every feasible node and
    # examine every node: each step's nvalid and limit are the pass's.
    np.testing.assert_array_equal(feas, [limit, limit, limit, limit, limit - 1, limit - 2])
    assert (processed[3:] == nvalid).all() and (processed[:3] < nvalid).all()
    assert int(np.asarray(jst.valid).sum()) == int(np.asarray(jstate.valid).sum()) == nvalid
    trun = build_pass(tprof, t.b.schema, t.b.res_col, t.active, 1, carry_dom=True, _impl="plain")
    start = torch.tensor([7], dtype=torch.int64)
    tinv = dict(t.b.batch_invariants(), order_pos=t.cache.order_pos(s.N), scan_start=start)
    with pytest.raises(KeyError, match="scan_nodes"):  # the host's node count is required
        trun(t.b.state().clone(), t.batch, tinv, 3, None, None, False)
    assert int(start[0]) == 7
    tinv["scan_nodes"] = t.cache.node_count()
    assert tinv["scan_nodes"] == nvalid
    _st, tout, _ = trun(t.b.state().clone(), t.batch, tinv, 3, None, None, False)
    for f in ("picks", "scores", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(getattr(tout, f).numpy().astype(np.int64),
                                      np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f)
    assert int(start[0]) == (7 + int(processed.astype(np.int64).sum())) % nvalid


def test_trunc_shape_contract():
    for n, want in ((8, (32, 4)), (1000, (256, 4)), (1024, (256, 4)), (4096, (1024, 4)), (4097, (544, 8)),
                    (8192, (1024, 8)), (16384, (1024, 16)), (32768, (1024, 32))):
        threads, rows = kernels.trunc_shape(n)
        assert (threads, rows) == want and threads * rows >= n and threads % 32 == 0
    with pytest.raises(NotImplementedError, match="32768"):
        kernels.trunc_shape(32769)


def emulate(feasible, valid, order_pos, start: int, pod_valid: bool, nvalid: int, limit: int):
    """truncate.cu step by step: (feasible row, pos, processed, start)."""
    n = valid.shape[0]
    threads, rows = kernels.trunc_shape(n)
    words = -(-n // 32)
    bits = np.zeros(words, np.uint64)
    nv = max(nvalid, 1)
    pos = np.zeros(threads * rows, np.int64)
    feas = np.zeros(threads * rows, bool)
    flags = np.zeros(n, bool)  # by position; the kernel's entries past nvalid are never read
    for t in range(threads):  # each thread's rows, positions and feasible bits in "registers"
        for i in range(rows):
            r = t * rows + i
            v = r < n and bool(valid[r])
            pos[r] = (int(order_pos[r]) - start) % nv if v else NO_POS
            if v:
                flags[pos[r]] = bool(feasible[r])
                feas[r] = bool(feasible[r])
    nwarps = threads // 32
    per = -(-words // nwarps)
    for w in range(words):  # a warp's ballot of 32 flags a word
        bits[w] = sum(1 << lane for lane in range(32) if w * 32 + lane < nvalid and flags[w * 32 + lane])
    popc = [bin(int(w)).count("1") for w in bits]
    totals = [sum(popc[w * per + lane] for lane in range(min(per, 32)) if w * per + lane < words)
              for w in range(nwarps)]
    total = sum(totals)

    def select_rank(r: int) -> int:
        incl = np.cumsum(totals)
        own = [w for w in range(nwarps) if incl[w] - totals[w] <= r < incl[w]]
        if r < 0 or not own:
            return -1
        w = own[0]
        k = r - (incl[w] - totals[w])
        wc = [popc[w * per + lane] if lane < per and w * per + lane < words else 0 for lane in range(32)]
        wincl = np.cumsum(wc)
        lane = next(lane for lane in range(32) if wincl[lane] - wc[lane] <= k < wincl[lane])
        word = w * per + lane
        v = int(bits[word])
        for _ in range(k - (wincl[lane] - wc[lane])):
            v &= v - 1
        return word * 32 + (v & -v).bit_length() - 1

    def next_set(c: int) -> int:  # the first set bit after position c
        rest = int(bits[c >> 5]) & ~((2 << (c & 31)) - 1) & 0xFFFFFFFF
        if rest:
            return (c >> 5) * 32 + (rest & -rest).bit_length() - 1
        word = next(w for w in range((c >> 5) + 1, words) if bits[w])
        v = int(bits[word])
        return word * 32 + (v & -v).bit_length() - 1

    processed = nvalid
    if total > limit:
        cutoff = select_rank(limit - 1)
        processed = next_set(cutoff)
        feas &= pos <= cutoff
    out = np.asarray(feasible, bool).copy()
    if total > limit:
        out = feas[:n]
    processed = processed if pod_valid else 0
    new_start = (start + processed) % nv if pod_valid else start
    return out, pos[:n].astype(np.int32), processed, new_start


@pytest.mark.parametrize("n,nvalid", [(8, 5), (1000, 999), (4097, 4000), (8192, 5000), (16384, 16384)])
def test_kernel_emulation_matches_plain(n, nvalid):
    rng = np.random.default_rng(n)
    limit = plain.scan_counts(nvalid, 0)[1]
    rows = rng.permutation(n)[:nvalid]
    valid = np.zeros(n, bool)
    valid[rows] = True
    order = np.full(n, NO_POS, np.int32)
    order[rows] = rng.permutation(nvalid)
    cases = 0
    for count in sorted({0, 1, limit - 1, limit, limit + 1, nvalid} & set(range(nvalid + 1))):
        feasible = np.zeros(n, bool)
        feasible[rows[rng.permutation(nvalid)[:count]]] = True
        for start in sorted({0, nvalid - 1, nvalid // 2}):
            for pod_valid in (True, False):
                got = emulate(feasible, valid, order, start, pod_valid, nvalid, limit)
                f = torch.from_numpy(feasible.copy())[None]
                st = torch.tensor([start], dtype=torch.int64)
                wf, wpos, wpr = plain.truncate_feasible(f, torch.from_numpy(valid), torch.from_numpy(order), st,
                                                        torch.tensor([pod_valid]), nvalid, limit)
                np.testing.assert_array_equal(got[0], wf[0].numpy())
                np.testing.assert_array_equal(got[1], wpos.numpy())
                assert got[2] == int(wpr[0]) and got[3] == int(st[0])
                cases += 1
    assert cases >= 12
