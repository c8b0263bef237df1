"""LearnedScorer in the port against the JAX package and the pure-Python
f32 oracle ``learned.reference_scores``.

The score is ``floor(y·100 + 0.5)`` of an f32 MLP with tanh and a sigmoid.
The port computes it in XLA's CPU arithmetic (its tanh and exp
approximations, its algebraic rewrites and the multiply-adds LLVM fuses;
``ops/learned.py``), so the integer scores equal JAX's exactly: on over
2,000,000 seeded (pod, node) inputs at a node count that is not a multiple
of 8, and on inputs built to land within 16 ulp of a rounding point.
Tolerance: none.

XLA's jitted score runs a vectorized loop and a scalar epilogue over the
last elements of each loop; the epilogue leaves nine multiply-adds
unfused, so JAX's f32 ``y·100 + 0.5`` of those elements is a second
function of the same inputs.  ``test_xla_vector_loop_and_epilogue_bit_exact``
holds every f32 value of JAX bit for bit: the port's where the vector loop
ran, ``_epilogue_pre_floor`` (an emulation of the scalar loop's object
code) in the last columns of each row.  The oracle uses numpy's tanh and
exp: it is held within 1 of JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.framework.config import MAX_NODE_SCORE
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops import learned as jls
from kubernetes_tpu.ops.helpers import gather_mask
from kubernetes_tpu.ops.throughput import ACCEL_LABEL_KEY, DEFAULT_THROUGHPUT_MATRIX, WORKLOAD_CLASS_LABEL_KEY
from kubernetes_tpu.snapshot import RES_CPU, RES_MEMORY
from kubernetes_tpu.snapshot import ClusterState as JState
from kubernetes_tpu.snapshot import Schema as JSchema
from kubernetes_tpu.snapshot import _host_arrays
from kubernetes_tpu_torch.ops import common as tcommon
from kubernetes_tpu_torch.ops import learned as tls
from kubernetes_tpu_torch.ops.helpers import fma_f32
from kubernetes_tpu_torch.snapshot import state_from_numpy

ACCELS = tuple(a for a, _ in DEFAULT_THROUGHPUT_MATRIX[0][1])
WEIGHTS = jls.load_weights()


def _pre_floor(state, pf, weights):
    """JAX's f32 ``y·100 + 0.5`` (learned.py:154-192 up to the floor), the
    same operations as ``score_fn``."""
    w1, b1, w2, b2 = weights
    f32 = jnp.float32
    alloc_cpu = state.alloc[:, RES_CPU].astype(f32)
    alloc_mem = state.alloc[:, RES_MEMORY].astype(f32)
    safe_cpu = jnp.maximum(alloc_cpu, 1.0)
    safe_mem = jnp.maximum(alloc_mem, 1.0)
    req_cpu = pf["ls_req_cpu"].astype(f32)
    req_mem = pf["ls_req_mem"].astype(f32)
    vals = jnp.take(state.topo_vals, pf["tp_slot"], axis=1)
    tput = gather_mask(pf["tp_scores"], vals[:, None])[:, 0].astype(f32)
    x = [
        jnp.maximum((alloc_cpu - req_cpu) / safe_cpu, 0.0),
        jnp.maximum((alloc_mem - req_mem) / safe_mem, 0.0),
        state.num_pods.astype(f32) / jnp.maximum(state.allowed_pods.astype(f32), 1.0),
        tput / f32(MAX_NODE_SCORE),
        req_cpu / safe_cpu,
    ]
    hs = []
    for j in range(len(b1)):
        acc = jnp.full(alloc_cpu.shape, f32(b1[j]))
        for i in range(len(x)):
            acc = acc + f32(w1[i][j]) * x[i]
        hs.append(jnp.tanh(acc))
    y = jnp.full(alloc_cpu.shape, f32(b2))
    for j in range(len(b1)):
        y = y + f32(w2[j]) * hs[j]
    y = 1.0 / (1.0 + jnp.exp(-y))
    return y * f32(MAX_NODE_SCORE) + f32(0.5)


def _jax(h: dict, pods: dict):
    """(JAX's scores, JAX's pre-floor values), both (C, N), from the jitted
    score_fn as the batch pass compiles it: the state an argument, the
    weights constants."""
    jstate = JState(**{k: jnp.asarray(v) for k, v in h.items()})
    ctx = jcommon.PassContext(profile=None, schema=None, static={"learned_weights": WEIGHTS})
    pf = {k: jnp.asarray(v) for k, v in pods.items()}
    scores = jax.jit(lambda st, p: jax.vmap(lambda q: jls.score_fn(st, q, ctx, None))(p))(jstate, pf)
    pre = jax.jit(lambda st, p: jax.vmap(lambda q: _pre_floor(st, q, WEIGHTS))(p))(jstate, pf)
    return np.asarray(scores), np.asarray(pre)


def _tpods(pods: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in pods.items()}


def _port(h: dict, pods: dict) -> np.ndarray:
    ctx = tcommon.PassContext(profile=None, schema=None, static={"learned_weights": WEIGHTS})
    return tls.score_fn(state_from_numpy(h, "cpu"), _tpods(pods), ctx, None).numpy()


def _port_pre(h: dict, pods: dict) -> np.ndarray:
    return tls.pre_floor(state_from_numpy(h, "cpu"), _tpods(pods), WEIGHTS).numpy()


def _epilogue_pre_floor(h: dict, pods: dict) -> np.ndarray:
    """JAX's f32 ``y·100 + 0.5`` as XLA's scalar epilogue computes it for
    the committed weights (read off its object code, jaxlib 0.9.0): the
    vector loop's operations, except that these stay a rounded product and
    a rounded sum: hidden unit 1's request term, unit 2's throughput and
    request terms, unit 3's pod-count, throughput and request terms, and
    the output sum's first three terms."""
    state = state_from_numpy(h, "cpu")
    x = [v.expand(pods["tp_slot"].shape[0], h["valid"].shape[0]) for v in tls.features(state, _tpods(pods))]
    w1, b1, w2, b2 = WEIGHTS
    f32 = torch.float32
    k = lambda v: torch.tensor(v, dtype=f32)  # noqa: E731
    fused = {0: (True,) * 5, 1: (True,) * 4 + (False,), 2: (True,) * 3 + (False,) * 2,
             3: (True,) * 2 + (False,) * 3}
    hs = []
    for j in range(len(b1)):
        w = [k(w1[i][j]) / k(100.0) if i == 3 else k(w1[i][j]) for i in range(5)]
        if b1[j] == 0.0:
            acc, start = fma_f32(x[0], w[0], x[1] * w[1]), 2
        else:
            acc, start = fma_f32(x[0], w[0], k(b1[j])), 1
        for i in range(start, 5):
            acc = fma_f32(x[i], w[i], acc) if fused[j][i] else acc + x[i] * w[i]
        hs.append(tls.xla_tanh(acc))
    y = hs[0] * k(w2[0]) + k(b2)
    y = y + hs[1] * k(w2[1])
    y = y + hs[2] * k(w2[2])
    y = fma_f32(hs[3], k(w2[3]), y)
    s = k(1.0) / tls.xla_exp_plus_one(-y)
    return fma_f32(s, k(float(MAX_NODE_SCORE)), k(0.5)).numpy()


def _random(seed: int, n: int, c: int):
    rng = np.random.default_rng(seed)
    h = _host_arrays(JSchema(N=n, R=3, TK=2, DV=4))
    h["valid"][:] = True
    h["allowed_pods"][:] = rng.choice([0, 3, 110, 250], n)
    h["num_pods"][:] = (rng.random(n) * (h["allowed_pods"] + 1)).astype(np.int32)
    h["alloc"][:, 0] = rng.choice([0, 1000, 4000, 16000, 96000, 256000], n) + rng.integers(0, 4, n) * 250
    h["alloc"][:, 1] = (rng.choice([0, 1, 16, 64, 512], n) << 30) + (rng.integers(0, 64, n) << 20)
    h["topo_vals"][:, 1] = rng.integers(-1, 4, n)
    tables = np.zeros((c, 4), np.int64)
    tables[:, :3] = rng.integers(0, 101, (c, 3))
    pods = {
        "tp_scores": tables,
        "tp_slot": np.ones(c, np.int32),
        "ls_req_cpu": rng.choice([0, 100, 500, 2000, 16000, 64000], c).astype(np.int64),
        "ls_req_mem": (rng.choice([0, 128, 256, 4096, 65536], c) << 20).astype(np.int64),
    }
    return h, pods


@pytest.mark.parametrize("seed", [0, 1])
def test_learned_scores_hold_against_jax_within_the_stated_tolerance(seed):
    """Exact (the tolerance stated is none), 32 pods on 8191 nodes."""
    h, pods = _random(seed, 8191, 32)
    want, pre = _jax(h, pods)
    np.testing.assert_array_equal(np.floor(pre).astype(np.int64), want)
    got = _port(h, pods)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 40


def test_learned_scores_exact_on_two_million_inputs():
    """256 pods on 8191 nodes: 2,096,896 (pod, node) inputs, exact."""
    h, pods = _random(7, 8191, 256)
    want, _pre = _jax(h, pods)
    np.testing.assert_array_equal(_port(h, pods), want)


def test_xla_vector_loop_and_epilogue_bit_exact():
    """Every f32 ``y·100 + 0.5`` of JAX bit for bit: the port's value on the
    elements XLA's vector loop computes, the scalar epilogue's emulation on
    the last elements of each row (N = 1003: columns 1000-1002)."""
    h, pods = _random(3, 1003, 32)
    _want, pre = _jax(h, pods)
    vec, epi = _port_pre(h, pods), _epilogue_pre_floor(h, pods)
    bits = lambda a: a.astype(np.float32).view(np.int32)  # noqa: E731
    loop = np.arange(1003) < 1000
    np.testing.assert_array_equal(bits(pre[:, loop]), bits(vec[:, loop]))
    np.testing.assert_array_equal(bits(pre[:, ~loop]), bits(epi[:, ~loop]))
    # The two loops are two functions: they differ in the last bits somewhere.
    assert (bits(vec) != bits(epi)).any()


def test_learned_scores_exact_near_rounding_points():
    """Nodes chosen so that the pre-floor value lies within 16 ulp of an
    integer for some of 8 pods (393 nodes at this seed): exact."""
    cand, pods = _random(11, 262144, 8)
    pre = _port_pre(cand, pods).astype(np.float32)
    near = np.abs(pre - np.round(pre)) <= 16 * np.spacing(pre)
    rows = np.nonzero(near.any(axis=0))[0][:1023]
    h = {k: np.ascontiguousarray(v[rows]) if v.ndim and v.shape[0] == 262144 else v for k, v in cand.items()}
    want, pre_j = _jax(h, pods)
    pre_j = pre_j.astype(np.float32)
    in_band = np.abs(pre_j - np.round(pre_j)) <= 16 * np.spacing(pre_j)
    np.testing.assert_array_equal(_port(h, pods), want)
    print(f"{int(in_band.sum())} of {in_band.size} inputs within 16 ulp of a rounding point")
    assert in_band.sum() >= 200


def _nodes_and_pods(h: dict, pods: dict, rows, cols):
    """The API objects of some state rows and pod lanes, for
    reference_scores (accelerator id i is ACCELS[i]; 3 is a class the
    matrix lacks)."""
    nodes, num = [], {}
    names = ACCELS + ("fpga-x",)
    for r in rows:
        nw = jw.make_node(f"r{r}").capacity({"cpu": f"{int(h['alloc'][r, 0])}m", "memory": int(h["alloc"][r, 1]),
                                             "pods": int(h["allowed_pods"][r])})
        v = int(h["topo_vals"][r, 1])
        if v >= 0:
            nw = nw.label(ACCEL_LABEL_KEY, names[v])
        nodes.append(nw.obj())
        num[f"r{r}"] = int(h["num_pods"][r])
    return nodes, num


def test_learned_scores_hold_against_the_reference_oracle():
    h, pods = _random(5, 1024, 8)
    # One matrix row per pod, so reference_scores sees the same tables.
    classes = [w for w, _ in DEFAULT_THROUGHPUT_MATRIX]
    for k in range(8):
        row = dict(DEFAULT_THROUGHPUT_MATRIX[k % 4][1])
        best = max(row.values())
        pods["tp_scores"][k, :3] = [row[a] * MAX_NODE_SCORE // best for a in ACCELS]
        pods["tp_scores"][k, 3] = 0
    want, pre = _jax(h, pods)
    got = _port(h, pods)
    rows = list(range(1024))
    nodes, num = _nodes_and_pods(h, pods, rows, None)
    oracle = np.zeros_like(got)
    for k in range(8):
        pod = jw.make_pod(f"p{k}").req({"cpu": f"{int(pods['ls_req_cpu'][k])}m",
                                        "memory": int(pods["ls_req_mem"][k])}).label(
            WORKLOAD_CLASS_LABEL_KEY, classes[k % 4]).obj()
        oracle[k] = jls.reference_scores(pod, nodes, WEIGHTS, DEFAULT_THROUGHPUT_MATRIX, num)
    np.testing.assert_array_equal(got, want)
    # The oracle's numpy tanh/exp are not XLA's: it is held within 1.
    assert np.abs(oracle - want).max() <= 1
    print(f"reference_scores: {int((oracle != want).sum())} of {oracle.size} scores 1 apart from JAX")


def test_learned_scores_exact_on_the_hetero_learned_domain():
    """Every (workload class, accelerator class, pods on the node) input of
    hetero_learned_1kn_5kpods: 4 x 3 x 111."""
    classes = [w for w, _ in DEFAULT_THROUGHPUT_MATRIX]
    n = len(ACCELS) * 111
    h = _host_arrays(JSchema(N=n, R=3, TK=1, DV=4))
    h["valid"][:] = True
    h["allowed_pods"][:] = 110
    h["alloc"][:, 0] = 16000
    h["alloc"][:, 1] = 64 << 30
    h["topo_vals"][:, 0] = np.repeat(np.arange(len(ACCELS)), 111)
    h["num_pods"][:] = np.tile(np.arange(111), len(ACCELS))
    tables = np.zeros((4, 4), np.int64)
    for k, (_w, row) in enumerate(DEFAULT_THROUGHPUT_MATRIX):
        row = dict(row)
        best = max(row.values())
        tables[k, :3] = [row[a] * MAX_NODE_SCORE // best for a in ACCELS]
    pods = {"tp_scores": tables, "tp_slot": np.zeros(4, np.int32),
            "ls_req_cpu": np.full(4, 100, np.int64), "ls_req_mem": np.full(4, 256 << 20, np.int64)}
    want, pre = _jax(h, pods)
    got = _port(h, pods)
    np.testing.assert_array_equal(got, want)
    nodes = [jw.make_node(f"d{r}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110}).label(
        ACCEL_LABEL_KEY, ACCELS[r // 111]).obj() for r in range(n)]
    num = {f"d{r}": r % 111 for r in range(n)}
    for k, wc in enumerate(classes):
        pod = jw.make_pod(f"p{k}").req({"cpu": "100m", "memory": "256Mi"}).label(WORKLOAD_CLASS_LABEL_KEY, wc).obj()
        assert got[k].tolist() == jls.reference_scores(pod, nodes, WEIGHTS, DEFAULT_THROUGHPUT_MATRIX, num)
    pre = pre.astype(np.float32)
    ulps = np.abs(pre - np.round(pre)) / np.spacing(pre)
    print(f"hetero_learned domain: {got.size} inputs, nearest JAX y*100+0.5 {float(ulps.min()):.1f} ulp "
          f"from an integer")
