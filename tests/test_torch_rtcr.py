"""NodeResourcesFit's RequestedToCapacityRatio strategy in the port against
the JAX package: the interpolation (``_interp`` against ``jnp.interp``) at,
and one ulp either side of, every shape point and outside the shape; the
per-node score on utilizations that hit the shape points exactly, with
zero allocatable (skipped with its weight) and requests above allocatable;
and the batch pass's picks, scores, feasible counts and fail masks under
the bin-packing profile of ``binpack_rtcr_5kn_10kpods`` at chunk 1 and 16.
Every output is an int (or the f64 interpolation, compared bit for bit),
so every comparison is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.framework import config as jcfg
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops import noderesources as jnr
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import ClusterState as JState
from kubernetes_tpu.snapshot import Schema as JSchema
from kubernetes_tpu.snapshot import _host_arrays
from kubernetes_tpu_torch import workloads as tw_loads
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import build_pass
from kubernetes_tpu_torch.framework import config as tcfg
from kubernetes_tpu_torch.ops import common as tcommon
from kubernetes_tpu_torch.ops import noderesources as tnr
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import Schema as TSchema
from kubernetes_tpu_torch.snapshot import state_from_numpy, state_to_numpy

SHAPES = (
    ((0, 0), (100, 10)),  # upstream's documented bin-packing shape
    ((0, 10), (100, 0)),  # spreading
    ((0, 0), (25, 3), (50, 8), (75, 9), (100, 10)),
    ((10, 2), (30, 2), (90, 7)),  # a flat segment, constant outside [10, 90]
)
N, R, C = 96, 4, 8
RES_COL = {"cpu": 0, "memory": 1, "ephemeral-storage": 2, "example.com/gpu": 3}


@pytest.mark.parametrize("shape", SHAPES)
def test_interp_matches_jnp_at_and_beside_every_point(shape):
    xs = np.array([p[0] for p in shape], np.float64)
    ys = np.array([p[1] for p in shape], np.float64)
    pts = [-1.0, 0.0, 100.0, 150.0, 33.333333333333336, 66.66666666666667]
    for x in xs:
        pts += [x, np.nextafter(x, -np.inf), np.nextafter(x, np.inf)]
    for a, b in zip(xs, xs[1:]):
        pts += list(np.linspace(a, b, 7))
    util = np.array(pts, np.float64)
    want = np.asarray(jnp.interp(jnp.asarray(util), jnp.asarray(xs), jnp.asarray(ys)))
    got = tnr._interp(torch.from_numpy(util), xs, ys).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def _state(rng, shape) -> dict:
    """Nodes whose cpu utilization with the pod hits each shape point
    exactly, nodes with zero cpu or memory, nodes the pod overfills."""
    h = _host_arrays(JSchema(N=N, R=R))
    h["valid"][:] = True
    h["allowed_pods"][:] = 110
    alloc = np.zeros((N, R), np.int64)
    alloc[:, 0] = rng.choice([4000, 8000, 16000], N)
    alloc[:, 1] = rng.choice([16, 64], N) << 30
    alloc[:, 3] = rng.choice([0, 4, 8], N)
    alloc[rng.random(N) < 0.1, 0] = 0
    alloc[rng.random(N) < 0.1, 1] = 0
    h["alloc"][:] = alloc
    req = (alloc * rng.random((N, R)) * 1.1).astype(np.int64)
    # The pod asks 1000m: the node's requested cpu puts util exactly at a
    # shape point on a third of the nodes.
    hit = rng.random(N) < 0.35
    u = rng.choice([p[0] for p in shape], N)
    req[hit, 0] = np.maximum(alloc[hit, 0] * u[hit] // 100 - 1000, 0)
    h["req"][:] = req
    h["nonzero_req"][:] = req[:, :2]
    return h


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_ratio_scores_match_jax(shape, seed):
    rng = np.random.default_rng(seed)
    h = _state(rng, shape)
    req = np.zeros((C, R), np.int64)
    req[:, 0] = 1000
    req[:, 1] = rng.choice([1, 2, 40], C) << 30
    req[:, 3] = rng.choice([0, 1, 9], C)
    pods = {"req": req, "nonzero": np.maximum(req[:, :2], [100, 200 << 20]).astype(np.int64)}
    res = (("cpu", 1), ("memory", 2), ("example.com/gpu", 3))
    jp = jcfg.Profile(scoring_strategy=jcfg.ScoringStrategy(jcfg.REQUESTED_TO_CAPACITY_RATIO, res, shape))
    tp = tcfg.Profile(scoring_strategy=tcfg.ScoringStrategy(tcfg.REQUESTED_TO_CAPACITY_RATIO, res, shape))
    jstatic = jnr.static_features(jp, JSchema(N=N, R=R), RES_COL)
    tstatic = tnr.static_features(tp, TSchema(N=N, R=R), RES_COL)
    jctx = jcommon.PassContext(profile=jp, schema=JSchema(N=N, R=R), static=jstatic)
    tctx = tcommon.PassContext(profile=tp, schema=TSchema(N=N, R=R), static=tstatic)
    jstate = JState(**{k: jnp.asarray(v) for k, v in h.items()})
    pf = {k: jnp.asarray(v) for k, v in pods.items()}
    want = np.asarray(jax.vmap(lambda p: jnr.score_fn(jstate, p, jctx))(pf))
    got = tnr.score_fn(state_from_numpy(h, "cpu"), {k: torch.from_numpy(v) for k, v in pods.items()}, tctx)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 5


def _cluster(s, w, seed):
    """24 nodes of three sizes, some half full; returns 60 density pods."""
    rng = np.random.default_rng(seed)
    for i in range(24):
        cpu = str(int(rng.choice([4, 8, 16])))
        s.add_node(w.make_node(f"n{i}").capacity({"cpu": cpu, "memory": "32Gi", "pods": 110})
                   .zone(f"zone-{i % 3}").obj())
    for j in range(30):
        s.add_pod(w.make_pod(f"b{j}").req({"cpu": "1500m", "memory": "3Gi"}).node(f"n{rng.integers(24)}").obj())
    return [w.make_pod(f"q{j}").req({"cpu": f"{int(rng.choice([300, 900, 2000]))}m", "memory": "2Gi"})
            .label("app", f"app-{j % 10}").obj() for j in range(60)]


@pytest.mark.parametrize("chunk", [1, 16])
def test_binpack_pass_matches_jax(chunk):
    jp = registered_subset(dataclasses.replace(
        jcfg.DEFAULT_PROFILE, scoring_strategy=jcfg.ScoringStrategy(
            jcfg.REQUESTED_TO_CAPACITY_RATIO, (("cpu", 1), ("memory", 1)), ((0, 0), (100, 10)))))
    tp = tw_loads.binpack_profile()
    j = TPUScheduler(profile=jp, batch_size=16)
    t = TorchScheduler(tp, batch_size=16, device="cpu")
    jpods, tpods = _cluster(j, jw, 7), _cluster(t, tw, 7)
    k = 64
    jbatch, _jd, active = jax_batch(jpods, j.builder, jp, k)
    tbatch, _td, tactive = torch_batch(tpods, t.builder, tp, k)
    assert active == tactive and "NodeResourcesFit" in active
    jbatch["nominated_row"] = np.full(k, -1, np.int32)
    tbatch["nominated_row"] = np.full(k, -1, np.int32)
    jb = j.builder
    inv = jb.batch_invariants()
    s = jb.schema
    jstate = jb.state()
    tstate = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)},
                              "cpu")
    _jst, jout = jax_build_pass(jp, s, jb.res_col, active, chunk)(jstate, jbatch, inv, np.uint32(3))
    tst, tout = build_pass(tp, s, jb.res_col, active, chunk, _impl="plain")(tstate, tbatch, inv, 3)
    for f in ("picks", "scores", "feasible_counts", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f)
    got = state_to_numpy(tst)
    for f in dataclasses.fields(_jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(_jst, f.name)), err_msg=f.name)
    picks = np.asarray(jout.picks)[:60]
    # Bin-packing: the pods crowd onto few nodes.
    placed = picks[picks >= 0]
    assert len(placed) > 10 and len(np.unique(placed)) < len(placed)


@pytest.mark.parametrize("shape", SHAPES + (((0, 10), (30, 7), (70, 1), (100, 0)),))
def test_ratio_scorer_matches_jax_on_integer_and_random_utilizations(shape):
    """Every integer utilization 0..100 and 40000 seeded (requested,
    allocatable) pairs, cpu-like and byte-like.  The reference's last
    interpolation step is one fused multiply-add (XLA contracts it); two
    roundings flip a decreasing shape's truncated score at utilizations
    74, 80, 84, 88, 90 and others."""
    rng = np.random.default_rng(11)
    alloc = np.concatenate([np.full(101, 100), rng.integers(1, 20000, 20000),
                            rng.integers(1, 1 << 36, 20000)]).astype(np.int64)
    reqd = np.concatenate([np.arange(101), (rng.random(40000) * alloc[101:] * 1.05).astype(np.int64)])
    want = np.asarray(jax.jit(jnr._ratio_scorer(shape))(jnp.asarray(alloc), jnp.asarray(reqd)))
    got = tnr._ratio_scorer(shape)(torch.from_numpy(alloc), torch.from_numpy(reqd)).numpy()
    np.testing.assert_array_equal(got, want)
