#!/usr/bin/env python3
"""node_filters' tiled launch shape (nodes a block, pods a block) and
truncate_feasible's block size, swept on a card.

    python3 scripts/shape_sweep.py                        # from the repository root, one CUDA card
    python3 scripts/shape_sweep.py --only truncate_feasible
    python3 scripts/shape_sweep.py --out sweep.json       # the medians also to a file

At chip_smoke.py's node_filters shapes: "pv" (a 4096-pod batch of mixed
claims over 5000 nodes, N=8192: VolumeBinding and VolumeZone programs),
"spread" and "incl." (the spread_na and inclusion workloads' 4096-pod
batches, N=1024 and N=8192: node selectors, required terms, taints),
"search" (the search path's 1024 preemptors, N=8192) and "cols" (the
explained pod alone, K=1, N=8192).  Each (nodes, pods) of NODES x PODS is
forced in place of kernels.nf_tile, the launch is held exactly against the
plain version and timed (median of 30 calls, CUDA events behind a spin
kernel, chip_smoke.median_ms), the grid ascending then descending.
Prints one line a shape with nf_tile's own choice, the best shape and the
ratio of each to the best.  truncate_feasible at
"tr" (parity_basic_5kn_10kpods' 5000 nodes, N=8192, every node feasible,
the start mid-list): each block size of THREADS (rows a thread from
trunc_shape), held exactly against the plain version and timed the same
way.  Then the medians as JSON (also to ``--out``) and the card's name
and power limit.  NF_TILE, NF_TILE_MIN, NF_GROUP, NF_BLOCKS_PER_SM and
TRUNC_THREADS were chosen from its output.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from kubernetes_tpu_torch import kernels  # noqa: E402
from kubernetes_tpu_torch.engine import pass_  # noqa: E402
from kubernetes_tpu_torch.engine.pass_ import eval_spec  # noqa: E402
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE  # noqa: E402
from kubernetes_tpu_torch.kernels import build, plain  # noqa: E402

NODES = (32, 64, 128, 256)
PODS = (1, 2, 4, 8, 16, 32, 64)
THREADS = (1024, 512, 256)
REPS = 30


def shapes(dev):
    """(label, state, batch, ctx) of each swept shape."""
    builder, state, big, active, _rng = cs.pv_inputs(dev)
    yield "pv", state, big, eval_spec(DEFAULT_PROFILE, builder.schema, builder.res_col, active).ctx
    for label, shape in (("spread", "spread_na"), ("incl.", "inclusion")):
        x = cs.spread_inputs(shape, 2468, dev)
        ctx = eval_spec(DEFAULT_PROFILE, x["builder"].schema, x["builder"].res_col, x["big_active"]).ctx
        yield label, x["state"], x["big_pf"], ctx
    s, _pack, batches, _active = cs.search_inputs("search", dev)
    tb, act = batches["uniform"]
    yield "search", s.builder.state(), tb, eval_spec(s.profile, s.builder.schema, s.builder.res_col, act).ctx
    s, batch, active, _inv, state = cs.cols_inputs(dev, "cols")
    tb = pass_._one_pod(batch, dev)
    yield "cols", state, tb, eval_spec(DEFAULT_PROFILE, s.builder.schema, s.builder.res_col, active).ctx


def sweep_truncate(dev, card: str) -> dict:
    """truncate_feasible at "tr" for each block size of THREADS."""
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    builder = SnapshotBuilder(device=dev)
    cache = Cache(builder)
    for node in w.basic_nodes(w.PARITY_NODES, zones=w.PARITY_ZONES):
        cache.add_node(node)
    state = builder.state()
    n = state.valid.shape[0]
    order = cs.scan_order(cache, n, dev)
    nvalid, limit = plain.scan_counts(int(state.valid.sum()), 0)
    real = torch.tensor([True], device=dev)
    fresh = lambda: (state.valid[None, :].clone(), torch.tensor([2777], dtype=torch.int64, device=dev))  # noqa: E731
    f0, s0 = fresh()
    want = plain.truncate_feasible(f0, state.valid, order, s0, real, nvalid, limit)
    orig = kernels.TRUNC_THREADS
    times: dict = {}
    for threads in THREADS + THREADS[::-1]:
        kernels.TRUNC_THREADS = threads
        try:
            rows = kernels.trunc_shape(n)[1]
            f, s0 = fresh()
            got = kernels.truncate_feasible(f, state.valid, order, s0, real, nvalid, limit)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"truncate_feasible at {threads} threads: differs")
            ms, _call = cs.median_ms(lambda a: kernels.truncate_feasible(a[0], state.valid, order, a[1], real,
                                                                        nvalid, limit), REPS, fresh)
        finally:
            kernels.TRUNC_THREADS = orig
        times.setdefault(f"{threads}x{rows}", []).append(ms)
    print(f"truncate_feasible sweep [tr] N={n}: exact at every block size; {times}  [{card}]", flush=True)
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("node_filters", "truncate_feasible"), help="sweep one kernel alone")
    ap.add_argument("--out", metavar="FILE", help="write the medians as JSON to FILE too")
    args = ap.parse_args()
    build.build(("node_filters", "truncate"))
    dev = torch.device("cuda")
    card = cs.card_line()
    orig = kernels.nf_tile
    res = {}
    if args.only != "node_filters":
        res["truncate_feasible"] = sweep_truncate(dev, card)
    for label, state, pf, ctx in (shapes(dev) if args.only != "truncate_feasible" else ()):
        k, n = pf["valid"].shape[0], state.valid.shape[0]
        want = plain.node_filters(state, pf, ctx)
        own = orig(k, n, kernels._sms(dev))
        grid = [(nt, p) for nt in NODES for p in PODS if p <= min(k, nt)]
        times: dict = {}
        for nt, p in grid + grid[::-1]:
            kernels.nf_tile = lambda *a, _s=(nt, p): _s
            try:
                got = kernels.node_filters(state, pf, ctx)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"node_filters [{label}] at {nt} nodes, {p} pods: differs")
                ms, _call = cs.median_ms(lambda _: kernels.node_filters(state, pf, ctx), REPS)
            finally:
                kernels.nf_tile = orig
            times.setdefault(f"{nt}x{p}", []).append(ms)
        best = min(times.items(), key=lambda kv: sum(kv[1]))
        mine = times.get(f"{own[0]}x{own[1]}")
        print(f"nf_tile sweep [{label}] K={k} N={n}: exact at every shape; nf_tile's own {own[0]}x{own[1]}: "
              f"{mine} ({sum(mine) / sum(best[1]):.4f} of the best); best {best[0]}: {best[1]}; by shape, "
              f"the sum of its two medians over the best's: "
              f"{ {key: round(sum(v) / sum(best[1]), 4) for key, v in times.items()} }  [{card}]", flush=True)
        res[label] = times
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "medians_ms": res}, f)
    print(card)


if __name__ == "__main__":
    main()
