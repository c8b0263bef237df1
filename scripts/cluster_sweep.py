#!/usr/bin/env python3
"""The thread block cluster size K of select_host, ipa_eval, spread_filter,
late_scores and build_dom, swept on a card.

    python3 scripts/cluster_sweep.py                # from the repository root, one CUDA card
    python3 scripts/cluster_sweep.py --only spread  # spread_filter and late_scores alone
    python3 scripts/cluster_sweep.py --only dom     # build_dom alone
    python3 scripts/cluster_sweep.py --only eval    # preempt_eval's block size alone

At chip_smoke.py's kernel-phase shapes (density "a", C=8 and C=128 at
N=8192, C=64 at N=512, "c1", a 10000-node cluster at N=16384, the IPA
shapes "b", C=8 at N=1024 and the two truncated-mode launches, and
"ipa_c1"; select_host in row mode: its pos mode runs one CTA a pod),
each K is forced in
place of kernels.cluster_split, the launch is held exactly against the
plain version and timed (median of 50 calls, CUDA events behind a spin
kernel, chip_smoke.median_ms), K ascending then descending.  Prints one
line a shape, then the medians as JSON and the card's name and power
limit.  cluster_split's row minimums (SELECT_ROWS_MIN, IPA_ROWS_MIN) and
select_host's one-wave cap were chosen from its output.  The spread part
sweeps spread_filter, late_scores and late_scores_cols at "spread_c1" (a
workload pod of the inclusion cluster, C=1, N=8192), at "inclusion" (C=8,
N=8192) and at "spread_na" (C=8, N=1024); SPREAD_ROWS_MIN was chosen from
it.  The dom part sweeps build_dom's K (R = 1) on the "c1" state (G = ET =
8, N = 8192, TK = 4, DV = 8, the builder's term slots), on seeded
counts (three in ten non-zero) of 16 rows over N = 4096, 2048, 1024 and
512 and on the "inclusion" and "spread_na" states (72 rows over N = 8192
and 1024), and its rows a CTA R (K = 1) on the "ipa" state (G = ET = 2048, N =
1024, DV = 16); kernels.dom_split is forced in place, S and threads from
kernels.dom_slices.  DOM_ROWS_MIN and DOM_CTAS_PER_SM (K), and DOM_WAVE (the
R it gives at the IPA shape, 8) were chosen from it.  The eval part sweeps
preempt_eval's threads a block (32, 64, 128, 256: 256 / L to 32 / L node
groups of L lanes) in FULL at the rank split of "preemption_500n" and
"preemption_async_5kn" and with the node-local ops of "search",
"search_pv", "search_dra" and "search_dra_path" (chip_smoke.py's inputs),
kernels.eval_split forced in place, and at eval_split's own geometry
PROLOGUE, TAIL (on the prologue's carry) and FULL with the closed-form
fit alone; EVAL_THREADS and EVAL_BLOCKS_PER_SM were chosen from it.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from kubernetes_tpu_torch import kernels  # noqa: E402
from kubernetes_tpu_torch.engine.pass_ import eval_spec  # noqa: E402
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE  # noqa: E402
from kubernetes_tpu_torch.kernels import build, plain  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--only", choices=("select_ipa", "spread", "dom", "eval"), help="sweep one part alone")
args = ap.parse_args()
build.build({None: ("select_host", "ipa_eval", "spread_eval", "build_dom", "preempt"),
             "select_ipa": ("select_host", "ipa_eval"), "spread": ("spread_eval",), "dom": ("build_dom",),
             "eval": ("preempt", "node_filters")}[args.only])
dev = torch.device("cuda")
orig = kernels.cluster_split
REPS = 50
card = cs.card_line()
res = {}


def force(k):
    kernels.cluster_split = orig if k is None else (lambda *a, **kw: k)


def sweep(label, kernel_fn, plain_fn, ks, setup=None, outs=None):
    for k in list(ks) + list(reversed(ks)):
        force(k)
        errs = {}
        a = setup() if setup else None
        b = setup() if setup else None
        got, want = kernel_fn(a), plain_fn(b)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(outs(got, a), outs(want, b))):
            cs.exact(errs, label, f"K={k} out {i}", x, y)
        ms, _ = cs.median_ms(kernel_fn, REPS, setup)
        res.setdefault(label, {}).setdefault(k, []).append(ms)
        force(None)
    print(label, {k: [round(x, 4) for x in v] for k, v in res[label].items()}, flush=True)


def select_ipa():
    seed_mul = ((DEFAULT_PROFILE.tie_break_seed & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    builder, pf, nom, steps, _rng = cs.kernel_inputs(1234, dev)
    state, schema = builder.state(), builder.schema
    ported = {"NodeUnschedulable", "NodeName", "NodeResourcesFit", "NodeResourcesBalancedAllocation"}
    active = frozenset(ported & (set(DEFAULT_PROFILE.filters) | {s for s, _ in DEFAULT_PROFILE.scorers}))
    spec = eval_spec(DEFAULT_PROFILE, schema, builder.res_col, active)
    fe, to, _ = plain.eval_chunk(state, pf, spec, nom)
    nomr = pf["nominated_row"]
    sel_out = lambda r, _a: r  # noqa: E731
    sweep("select a (C=64, N=8192)", lambda _: kernels.select_host(fe, to, steps, seed_mul, nomr),
          lambda _: plain.select_host(fe, to, steps, seed_mul, nomr), (1, 2, 4, 8, 16), outs=sel_out)
    f8, t8, s8 = fe[:8].contiguous(), to[:8].contiguous(), steps[:8].contiguous()
    sweep("select d-like (C=8, N=8192)", lambda _: kernels.select_host(f8, t8, s8, seed_mul, None),
          lambda _: plain.select_host(f8, t8, s8, seed_mul, None), (1, 2, 4, 8, 16), outs=sel_out)
    big_f = torch.cat([fe, fe]).contiguous()
    big_t = torch.cat([to, to]).contiguous()
    big_s = torch.cat([steps, steps + 1]).contiguous()
    sweep("select async-like (C=128, N=8192)", lambda _: kernels.select_host(big_f, big_t, big_s, seed_mul, None),
          lambda _: plain.select_host(big_f, big_t, big_s, seed_mul, None), (1, 2, 4), outs=sel_out)
    f5, t5 = fe[:, :512].contiguous(), to[:, :512].contiguous()
    sweep("select 500n-like (C=64, N=512)", lambda _: kernels.select_host(f5, t5, steps, seed_mul, None),
          lambda _: plain.select_host(f5, t5, steps, seed_mul, None), (1, 2), outs=sel_out)
    pf1 = cs._chunk(pf, 0, 1)
    f1, t1, _ = plain.eval_chunk(state, pf1, spec, None)
    sweep("select c1 (C=1, N=8192)", lambda _: kernels.select_host(f1, t1, steps[:1], 0, None),
          lambda _: plain.select_host(f1, t1, steps[:1], 0, None), (1, 2, 4, 8, 16), outs=sel_out)

    # Row mode at N=16384 (10000 nodes).  Pos mode runs one CTA a pod: no K.
    from kubernetes_tpu_torch import workloads as w
    from kubernetes_tpu_torch.cache import Cache
    from kubernetes_tpu_torch.snapshot import SnapshotBuilder

    rng = np.random.default_rng(5)
    psteps = torch.from_numpy(rng.integers(0, 2**32, size=1, dtype=np.int64)).to(dev)
    qb = SnapshotBuilder(device=dev)
    qcache = Cache(qb)
    for node in w.basic_nodes(10000, zones=w.PARITY_ZONES):
        qcache.add_node(node)
    qstate = qb.state()
    qtotal = torch.from_numpy(rng.integers(0, 3, (1, qstate.valid.shape[0]))).to(dev)
    q1f = qstate.valid[None, :].clone()
    sweep(f"select row mode (C=1, N={qstate.valid.shape[0]})",
          lambda _: kernels.select_host(q1f, qtotal, psteps, seed_mul, None),
          lambda _: plain.select_host(q1f, qtotal, psteps, seed_mul, None), (1, 2, 4, 8, 16), outs=sel_out)

    # IPA shapes.
    x = cs.ipa_inputs(4321, dev)
    ist, ipf, ipa, base = x["state"], x["pf"], x["ipa"], x["base"]
    fresh = lambda: tuple(t.clone() for t in base)  # noqa: E731
    ipa_out = lambda r, _a: r  # noqa: E731
    ib = plain.ipa_eval(ist, ipf, *fresh(), ipa)
    isteps = torch.from_numpy(rng.integers(0, 2**32, size=64, dtype=np.int64)).to(dev)
    sweep("select b (C=64, N=1024)", lambda _: kernels.select_host(ib[0], ib[1], isteps, seed_mul, None),
          lambda _: plain.select_host(ib[0], ib[1], isteps, seed_mul, None), (1, 2, 4), outs=sel_out)
    c8f, c8t = ib[0][:8].contiguous(), ib[1][:8].contiguous()
    sweep("select c-like (C=8, N=1024)", lambda _: kernels.select_host(c8f, c8t, isteps[:8], seed_mul, None),
          lambda _: plain.select_host(c8f, c8t, isteps[:8], seed_mul, None), (1, 2, 4, 8), outs=sel_out)
    sweep("ipa b (C=64, N=1024)", lambda a: kernels.ipa_eval(ist, ipf, *a, ipa),
          lambda a: plain.ipa_eval(ist, ipf, *a, ipa), (1, 2, 4, 8), setup=fresh, outs=ipa_out)
    p1 = cs._chunk(ipf, 63, 1)
    b1 = plain.eval_chunk(ist, p1, x["spec"], None)
    fresh1 = lambda: tuple(t.clone() for t in b1)  # noqa: E731


    def two(mod):
        def run(a):
            mod.ipa_eval(ist, p1, *a, ipa, plain.IPA_FILTER)
            return mod.ipa_eval(ist, p1, *a, ipa, plain.IPA_SCORE)
        return run


    sweep("ipa tr-ipa two launches (C=1, N=1024)", two(kernels), two(plain), (1, 2, 4, 8), setup=fresh1, outs=ipa_out)
    cstate, ctb, cipa, cdom, cbase = cs.ipa_c1_inputs(dev)
    cfresh = lambda: tuple(t.clone() for t in cbase)  # noqa: E731
    sweep("ipa ipa_c1 (C=1, N=8192)", lambda a: kernels.ipa_eval(cstate, ctb, *a, cipa),
          lambda a: plain.ipa_eval(cstate, ctb, *a, cipa), (1, 4, 8, 16), setup=cfresh, outs=ipa_out)
    ic8 = cs._chunk(ipf, 0, 8)
    b8 = plain.eval_chunk(ist, ic8, x["spec"], None)
    fresh8 = lambda: tuple(t.clone() for t in b8)  # noqa: E731
    sweep("ipa C=8 (N=1024)", lambda a: kernels.ipa_eval(ist, ic8, *a, ipa),
          lambda a: plain.ipa_eval(ist, ic8, *a, ipa), (1, 2, 4, 8, 16), setup=fresh8, outs=ipa_out)


def spread():
    """spread_filter, late_scores and late_scores_cols at the spread shapes,
    every K: the filter's verdicts, the scores' total (and columns) held
    exactly against the plain versions."""
    from kubernetes_tpu_torch.engine.pass_ import late_spec

    out1 = lambda r, _a: (r,)  # noqa: E731
    for shape in ("inclusion", "spread_na"):
        x = cs.spread_inputs(shape, 2468, dev)
        b, st = x["builder"], x["state"]
        big, active = x["big_pf"], x["big_active"]
        spec = eval_spec(DEFAULT_PROFILE, b.schema, b.res_col, active)
        late = late_spec(DEFAULT_PROFILE, b.schema, b.res_col, active)
        bits = plain.node_filters(st, big, spec.ctx)
        chunks = {"spread_c1": 1, shape: 8} if shape == "inclusion" else {shape: 8}
        for label, c in chunks.items():
            pf, bc = cs._chunk(big, 0, c), bits[:c].contiguous()
            ps = plain.spread_filter(st, pf, bc, spec.ctx)
            fe, to, _ = plain.eval_chunk(st, pf, spec, None, (bc, ps))
            ks = (1, 2, 4, 8, 16)
            sweep(f"spread_filter {label} (C={c}, N={st.valid.shape[0]})",
                  lambda _: kernels.spread_filter(st, pf, bc, spec.ctx),
                  lambda _: plain.spread_filter(st, pf, bc, spec.ctx), ks, outs=out1)
            sweep(f"late_scores {label} (C={c}, N={st.valid.shape[0]})",
                  lambda a: kernels.late_scores(st, pf, fe, a, bc, late),
                  lambda a: plain.late_scores(st, pf, fe, a, bc, late), ks, setup=lambda: to.clone(), outs=out1)
            if c == 1:
                sweep(f"late_scores/cols {label} (C={c}, N={st.valid.shape[0]})",
                      lambda a: kernels.late_scores_cols(st, pf, fe, a, bc, late),
                      lambda a: plain.late_scores_cols(st, pf, fe, a, bc, late), ks, setup=lambda: to.clone(),
                      outs=lambda r, a: (r, a))


def dom():
    """build_dom at every K (R = 1) at few rows, and at R = 2 to 16 rows a
    CTA (K = 1) at the IPA shape, each held exactly against plain."""
    from types import SimpleNamespace

    orig_dom = kernels.dom_split

    def force_dom(r, k):
        kernels.dom_split = lambda rows, n, tk, dv, sms: (r, k, *kernels.dom_slices(n, k))

    def dom_sweep(label, state, et_slot, dv, geometries):
        run = lambda _: kernels.build_dom(state, et_slot, dv)  # noqa: E731
        want = plain.build_dom(state, et_slot, dv)
        for r, k in list(geometries) + list(reversed(geometries)):
            force_dom(r, k)
            errs = {}
            for i, (x, y) in enumerate(zip(run(None), want)):
                torch.cuda.synchronize()
                cs.exact(errs, label, f"R={r} K={k} out {i}", x, y)
            ms, _ = cs.median_ms(run, REPS)
            res.setdefault(label, {}).setdefault(f"R={r} K={k}", []).append(ms)
            kernels.dom_split = orig_dom
        print(label, {g: [round(x, 4) for x in v] for g, v in res[label].items()}, flush=True)

    ks = [(1, k) for k in (1, 2, 4, 8, 16)]
    builder, *_ = cs.kernel_inputs(1234, dev)
    slot = torch.from_numpy(builder.batch_invariants()["et_slot"]).to(dev)
    dom_sweep("build_dom c1 (G=ET=8, N=8192)", builder.state(), slot, builder.schema.DV, ks)
    rng = np.random.default_rng(7)
    for n in (4096, 2048, 1024, 512):
        gc, ec, topo, eslot = cs.dom_case(rng, 8, 8, n, 4, 8, "drawn")
        to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        st = SimpleNamespace(group_counts=to(gc), et_counts=to(ec), topo_vals=to(topo))
        dom_sweep(f"build_dom drawn (G=ET=8, N={n})", st, to(eslot), 8, ks)
    for shape in ("inclusion", "spread_na"):
        x = cs.spread_inputs(shape, 2468, dev)
        b = x["builder"]
        slot = torch.from_numpy(b.batch_invariants()["et_slot"]).to(dev)
        dom_sweep(f"build_dom {shape} (G={b.schema.G}, ET={b.schema.ET}, N={b.schema.N})", x["state"], slot,
                  b.schema.DV, ks)
    x = cs.ipa_inputs(4321, dev)
    dom_sweep("build_dom ipa (G=ET=2048, N=1024)", x["state"], x["dom"].et_slot, x["builder"].schema.DV,
              [(r, 1) for r in (1, 2, 4, 8, 16)])


def eval_threads():
    """preempt_eval in FULL at every block size, held exactly against plain."""
    import dataclasses

    from kubernetes_tpu_torch import preemption as tpre
    from kubernetes_tpu_torch.kernels import PreemptSpec

    orig_split = kernels.eval_split

    def force_threads(t):
        def split(n, v, sms, node_bytes=0, block_bytes=0):
            lanes = kernels.eval_lanes(v)
            return lanes, t // lanes, t, -(-n // (t // lanes))
        kernels.eval_split = split

    def eval_sweep(label, state, vic, pf, spec):
        run = lambda _: kernels.preempt_eval(state, vic, pf, spec)  # noqa: E731
        want = plain.preempt_eval(state, vic, pf, spec)
        lanes = kernels.eval_lanes(vic.prio.shape[1])
        threads = [t for t in (32, 64, 128, 256) if t >= lanes]
        for t in threads + threads[::-1]:
            force_threads(t)
            errs = {}
            got = run(None)
            torch.cuda.synchronize()
            for i, (x, y) in enumerate(zip(got, want)):
                cs.exact(errs, label, f"threads={t} out {i}", x, y)
            ms, _ = cs.median_ms(run, REPS)
            res.setdefault(label, {}).setdefault(f"threads={t}", []).append(ms)
            kernels.eval_split = orig_split
        # The other modes and the closed form alone, at eval_split's geometry.
        fit = dataclasses.replace(spec, ports=False, vr=False, nvl=False, dra=False)
        carry = plain.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)
        for mode, fn in (("PROLOGUE", lambda _: kernels.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)),
                         ("TAIL", lambda _: kernels.preempt_eval(state, vic, pf, spec, plain.TAIL, carry)),
                         ("FULL, fit alone", lambda _: kernels.preempt_eval(state, vic, pf, fit))):
            res[label].setdefault(mode, []).append(cs.median_ms(fn, REPS)[0])
        n = state.valid.shape[0]
        print(label, f"L={lanes}, eval_split {orig_split(n, vic.prio.shape[1], kernels._sms(dev))}",
              {g: [round(x, 4) for x in v] for g, v in res[label].items()}, flush=True)

    for shape in ("preemption_500n", "preemption_async_5kn"):
        s, pack, batches = cs.preempt_inputs(shape, dev)
        tb, _ = batches["uniform"]
        pf = {**tb, "valid": torch.ones(tb["sig"].shape[0], dtype=torch.bool, device=dev)}
        spec = PreemptSpec(check_unsched=True, check_nodename=True, bits_mask=0)
        eval_sweep(f"preempt_eval {shape} (N={s.builder.schema.N})", s.builder.state(), pack["vic"], pf, spec)
    for shape in ("search", "search_pv", "search_dra", "search_dra_path"):
        s, pack, batches, active = cs.search_inputs(shape, dev)
        state = s.builder.state()
        spec = tpre.preempt_spec(s.profile, s.builder.schema, s.builder.res_col, active)
        local = dataclasses.replace(spec, ipa=False, pts=False)
        tb, _ = batches["uniform"]
        pf = {**tb, "valid": torch.ones(tb["sig"].shape[0], dtype=torch.bool, device=dev)}
        pf["node_bits"] = kernels.node_filters(state, pf, spec.ctx)
        eval_sweep(f"preempt_eval {shape} (N={s.builder.schema.N})", state, pack["vic"], pf, local)


if args.only in (None, "select_ipa"):
    select_ipa()
if args.only in (None, "spread"):
    spread()
if args.only in (None, "dom"):
    dom()
if args.only in (None, "eval"):
    eval_threads()
print(json.dumps({k: {str(kk): vv for kk, vv in v.items()} for k, v in res.items()}))
print(card)
