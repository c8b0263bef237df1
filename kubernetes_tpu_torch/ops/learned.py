"""LearnedScorer: a fixed-weight MLP score under the profile map.

Counterpart of ``kubernetes_tpu/ops/learned.py``.  A small perceptron over
five (pod, node) features, evaluated inside the batch pass like every other
score.  Inference only and deterministic: the weights are a committed
artifact (``learned_weights.json`` beside this module, the same bytes as the
reference's), loaded once per profile, and the forward pass is float32
arithmetic whose association order is fixed by hand.

Input features per (pod, node), all node-axis state or pod features:

  0. free-cpu fraction      max((alloc − pod req)/max(alloc, 1), 0), cpu
  1. free-memory fraction   the same, memory
  2. pod-count fraction     num_pods / max(allowed_pods, 1)
  3. normalized throughput  the ThroughputAware table gather / 100
  4. request pressure       pod cpu request / max(node cpu allocatable, 1)

Output: ``floor(sigmoid(tanh(x·W1 + b1)·W2 + b2) · 100 + 0.5)`` in float32.
The port's plain ``score_fn`` computes it with ``torch.tanh`` and
``torch.exp``; the ``eval_chunk`` kernel (kernels/csrc/eval_chunk.cu)
computes the same operations in the same order with ``tanhf``/``expf`` and
no contracted multiply-adds.  XLA's f32 ``tanh``/``exp`` differ from
torch's in the last bits on some inputs, so a score whose ``y·100 + 0.5``
lies within a few ulp of an integer can differ by 1 from JAX's
(tests/test_torch_learned.py states the tolerance).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from ..api import types as t
from ..framework.config import MAX_NODE_SCORE, Profile
from ..snapshot import RES_CPU, RES_MEMORY
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register
from .throughput import DEFAULT_THROUGHPUT_MATRIX, _tp_features, tput_gather

# The committed inference artifact, loaded once per profile.
DEFAULT_WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "learned_weights.json")

N_FEATURES = 5


def load_weights(path: str = DEFAULT_WEIGHTS_PATH) -> tuple:
    """Load and check the MLP artifact into the hashable form
    Profile.learned_weights carries: ``((w1 rows...), (b1...), (w2...),
    b2)`` with w1 (F, H), b1 (H,), w2 (H,), b2 a scalar.  A wrong version,
    a wrong shape or a non-finite value raises ValueError."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("version") != 1:
        raise ValueError(f"learned_weights: unsupported version {doc.get('version')!r}")
    w1, b1, w2, b2 = doc["w1"], doc["b1"], doc["w2"], doc["b2"]
    if len(w1) != N_FEATURES:
        raise ValueError(f"learned_weights: w1 has {len(w1)} feature rows, want {N_FEATURES}")
    hidden = len(b1)
    if hidden < 1:
        raise ValueError("learned_weights: empty hidden layer")
    for i, row in enumerate(w1):
        if len(row) != hidden:
            raise ValueError(f"learned_weights: w1[{i}] has {len(row)} cols, want {hidden}")
    if len(w2) != hidden:
        raise ValueError(f"learned_weights: w2 has {len(w2)} entries, want {hidden}")
    flat = [x for row in w1 for x in row] + list(b1) + list(w2) + [b2]
    for x in flat:
        if not math.isfinite(float(x)):
            raise ValueError("learned_weights: non-finite weight")
    return (
        tuple(tuple(float(x) for x in row) for row in w1),
        tuple(float(x) for x in b1),
        tuple(float(x) for x in w2),
        float(b2),
    )


def reference_scores(pod, nodes, weights, matrix=DEFAULT_THROUGHPUT_MATRIX, num_pods=None):
    """Pure-Python float32 scores of the pod on each node, in the same
    association order; ``num_pods`` maps a node name to the pods already
    on it (default none)."""
    from .throughput import node_accel_class, pod_workload_class

    w1, b1, w2, b2 = weights
    row = dict(matrix).get(pod_workload_class(pod)) if matrix else None
    best = max(max((tp for _a, tp in row), default=1), 1) if row else 1
    by_accel = dict(row) if row else {}
    req = pod.resource_request()
    req_cpu = req.get(t.CPU, 0)
    req_mem = req.get(t.MEMORY, 0)
    f32 = np.float32
    out = []
    for n in nodes:
        alloc_cpu = n.status.allocatable.get(t.CPU, 0)
        alloc_mem = n.status.allocatable.get(t.MEMORY, 0)
        allowed = n.status.allocatable.get(t.PODS, 110)
        x = [
            max(f32(alloc_cpu - req_cpu) / f32(max(alloc_cpu, 1)), f32(0.0)),
            max(f32(alloc_mem - req_mem) / f32(max(alloc_mem, 1)), f32(0.0)),
            f32((num_pods or {}).get(n.name, 0)) / f32(max(allowed, 1)),
            f32(by_accel.get(node_accel_class(n) or "", 0) * MAX_NODE_SCORE // best) / f32(MAX_NODE_SCORE),
            f32(req_cpu) / f32(max(alloc_cpu, 1)),
        ]
        h = []
        for j in range(len(b1)):
            acc = f32(b1[j])
            for i in range(len(x)):
                acc = f32(acc + f32(f32(w1[i][j]) * f32(x[i])))
            h.append(np.tanh(acc, dtype=np.float32))
        y = f32(b2)
        for j in range(len(b1)):
            y = f32(y + f32(f32(w2[j]) * h[j]))
        y = f32(1.0) / f32(1.0 + np.exp(-y, dtype=np.float32))
        out.append(int(np.floor(f32(y * MAX_NODE_SCORE) + f32(0.5))))
    return out


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    profile = fctx.profile
    matrix = profile.throughput_matrix if profile is not None else ()
    feats = _tp_features(pod, fctx, matrix)
    req = pod.resource_request()
    return {
        "tp_scores": feats["tp_scores"],
        "tp_slot": feats["tp_slot"],
        "ls_req_cpu": np.int64(req.get(t.CPU, 0)),
        "ls_req_mem": np.int64(req.get(t.MEMORY, 0)),
    }


def _static(profile: Profile, schema, builder_res_col) -> dict:
    return {"learned_weights": profile.learned_weights}


def features(state, pf) -> list[torch.Tensor]:
    """The five f32 input features, each broadcastable to (C, N)."""
    f32 = torch.float32
    alloc_cpu = state.alloc[:, RES_CPU].to(f32)[None, :]
    alloc_mem = state.alloc[:, RES_MEMORY].to(f32)[None, :]
    safe_cpu = torch.clamp(alloc_cpu, min=1.0)
    safe_mem = torch.clamp(alloc_mem, min=1.0)
    req_cpu = pf["ls_req_cpu"].to(f32)[:, None]
    req_mem = pf["ls_req_mem"].to(f32)[:, None]
    tput = tput_gather(state, pf).to(f32)
    return [
        torch.clamp((alloc_cpu - req_cpu) / safe_cpu, min=0.0),
        torch.clamp((alloc_mem - req_mem) / safe_mem, min=0.0),
        state.num_pods.to(f32)[None, :] / torch.clamp(state.allowed_pods.to(f32)[None, :], min=1.0),
        # A device tensor, not a Python number: CUDA divides a tensor by a
        # host scalar as a multiply by its reciprocal, which rounds
        # differently.
        tput / torch.tensor(float(MAX_NODE_SCORE), dtype=f32, device=tput.device),
        req_cpu / safe_cpu,
    ]


def score_fn(state, pf, ctx: PassContext, feasible):
    """The plain version of eval_chunk's learned term: (C, N) i64."""
    c, n = pf["tp_slot"].shape[0], state.valid.shape[0]
    dev = state.valid.device
    weights = ctx.static.get("learned_weights") if ctx.static else None
    if not weights:
        return torch.zeros((c, n), dtype=torch.int64, device=dev)
    w1, b1, w2, b2 = weights
    f32 = torch.float32

    def k(v: float) -> torch.Tensor:  # a weight rounded to f32, as JAX's f32(w)
        return torch.tensor(v, dtype=f32, device=dev)

    x = features(state, pf)
    hs = []
    for j in range(len(b1)):
        acc = torch.full((c, n), b1[j], dtype=f32, device=dev)
        for i in range(len(x)):
            acc = acc + k(w1[i][j]) * x[i]
        hs.append(torch.tanh(acc))
    y = torch.full((c, n), b2, dtype=f32, device=dev)
    for j in range(len(b1)):
        y = y + k(w2[j]) * hs[j]
    y = k(1.0) / (k(1.0) + torch.exp(-y))
    return torch.floor(y * k(float(MAX_NODE_SCORE)) + k(0.5)).to(torch.int64)


feature_fill("ls_req_cpu", 0)
feature_fill("ls_req_mem", 0)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    profile = fctx.profile
    return profile is not None and bool(profile.learned_weights)


register(OpDef(name="LearnedScorer", featurize=featurize, score=score_fn, static=_static, is_active=is_active))


def learned_scorer_profile(
    weights_path: str = DEFAULT_WEIGHTS_PATH,
    matrix: tuple = DEFAULT_THROUGHPUT_MATRIX,
    weight: int = 3,
) -> Profile:
    """The default plugin set plus the MLP scorer, selected by
    ``schedulerName: learned-scorer-scheduler``; the matrix rides along so
    feature 3 (normalized throughput) is live."""
    base = Profile()
    return Profile(
        name="learned-scorer-scheduler",
        scorers=base.scorers + (("LearnedScorer", weight),),
        throughput_matrix=tuple((w, tuple(r)) for w, r in matrix),
        learned_weights=load_weights(weights_path),
    )
