"""LearnedScorer in the port against the JAX package and the pure-Python
f32 oracle ``learned.reference_scores``.

The score is ``floor(y·100 + 0.5)`` of an f32 MLP with tanh and a sigmoid.
XLA's f32 ``tanh``/``exp`` (and its fused multiply-adds inside a jitted
pass) differ from torch's in the last bits on some inputs, so the integer
score can differ where ``y·100 + 0.5`` lies within a few ulp of an
integer.  The stated tolerance: equal wherever JAX's f32 ``y·100 + 0.5``
lies more than 16 ulp from an integer; within that band at most 1 apart
(the count of band cases is printed).  The same rule holds against
``reference_scores``.  On every input ``hetero_learned_1kn_5kpods`` can
produce (each workload class × accelerator class × 0-110 pods on a node of
16 CPU, 64 GiB and 110 pods, for a pod of 100m and 256 MiB) the scores are
equal exactly."""

import dataclasses

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
from kubernetes_tpu_torch.snapshot import Schema as TSchema
from kubernetes_tpu_torch.snapshot import state_from_numpy

BAND_ULPS = 16
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
    score_fn as the batch pass compiles it."""
    jstate = JState(**{k: jnp.asarray(v) for k, v in h.items()})
    ctx = jcommon.PassContext(profile=None, schema=None, static={"learned_weights": WEIGHTS})
    pf = {k: jnp.asarray(v) for k, v in pods.items()}
    scores = jax.jit(jax.vmap(lambda p: jls.score_fn(jstate, p, ctx, None)))(pf)
    pre = jax.jit(jax.vmap(lambda p: _pre_floor(jstate, p, WEIGHTS)))(pf)
    return np.asarray(scores), np.asarray(pre)


def _port(h: dict, pods: dict) -> np.ndarray:
    ctx = tcommon.PassContext(profile=None, schema=None, static={"learned_weights": WEIGHTS})
    return tls.score_fn(state_from_numpy(h, "cpu"), {k: torch.from_numpy(np.asarray(v)) for k, v in pods.items()},
                        ctx, None).numpy()


def _band(pre: np.ndarray) -> np.ndarray:
    """Where JAX's f32 value lies within BAND_ULPS ulp of an integer."""
    pre = pre.astype(np.float32)
    return np.abs(pre - np.round(pre)) <= BAND_ULPS * np.spacing(pre)


def _hold(name: str, got: np.ndarray, want: np.ndarray, band: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    outside = ~band
    np.testing.assert_array_equal(got[outside], want[outside], err_msg=f"{name}: outside the band")
    assert diff[band].max(initial=0) <= 1, name
    print(f"{name}: {int(band.sum())} of {band.size} scores in the {BAND_ULPS}-ulp band, "
          f"{int((diff[band] != 0).sum())} of them differ by 1")


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
    h, pods = _random(seed, 8192, 32)
    want, pre = _jax(h, pods)
    # The band is defined by the value score_fn floors.
    np.testing.assert_array_equal(np.floor(pre).astype(np.int64), want)
    got = _port(h, pods)
    _hold("port vs JAX", got, want, _band(pre))
    assert len(np.unique(want)) > 40


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
    band = _band(pre)
    _hold("port vs reference_scores", got, oracle, band)
    _hold("JAX vs reference_scores", want, oracle, band)


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
