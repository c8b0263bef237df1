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

Output: ``floor(sigmoid(tanh(x·W1 + b1)·W2 + b2) · 100 + 0.5)`` in float32,
computed as XLA on the CPU computes the reference's jitted ``score_fn``
(read off its ``XLA_FLAGS=--xla_dump_to`` dump, jaxlib 0.9.0): the
algebraic simplifier drops a zero bias (``0 + a`` is ``a``) and folds the
throughput feature's ``/ 100`` into its weight (``tput · fl(w / 100)``);
``tanh`` is XLA's rational approximation (``xla_tanh``) and ``exp`` its
range-reduced polynomial (``xla_exp_plus_one``); and LLVM contracts every
multiply whose one use is an add into a fused multiply-add, as the
object code's vector loop shows (``vfmadd``): each hidden unit's sum, the
output sum, every Horner step, the exponential's reduction and scaling
(``e · 2^n + 1`` fused with the sigmoid's ``+ 1``) and the last
``s · 100 + 0.5``.  The plain version rounds each fused step once with
``helpers.fma_f32``; the ``eval_chunk`` kernel uses ``fmaf`` at the same
places and plain operations elsewhere (its build keeps ``-fmad=false``).

XLA's scalar epilogue loop (the last elements of each vectorized loop)
contracts nine fewer multiply-adds than its vector loop, so the JAX
package's score of those elements can differ in the last bit before the
floor: the port computes the vector loop's function on every element
(ROADMAP §3, logged as a reference fault; tests/test_torch_learned.py holds
both loops exactly).
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
from .helpers import fma_f32
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
    """The five f32 input features, each broadcastable to (C, N); feature 3
    is the throughput gather unscaled, its division by MaxNodeScore folded
    into its weights (``pre_floor``)."""
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
        tput,
        req_cpu / safe_cpu,
    ]


# XLA's f32 tanh (its rational approximation of Eigen's ptanh): the input
# clamped to ±7.998811721801758, x·P(x²)/Q(x²) with Horner steps fused, x
# itself below 0.0004 and ±1 from 20 on.
_TANH_CLAMP = 7.998811721801758
_TANH_P = (-2.7607683663038313e-16, 2.0001879384549948e-13, -8.604671836165423e-11, 5.122297253024044e-08,
           1.4857223504805006e-05, 0.0006372619536705315, 0.004893524572253227)
_TANH_Q = (1.1982583600911312e-06, 0.00011853470641653985, 0.0022684347350150347, 0.0048935250379145145)
# XLA's f32 exp: the input clamped to [-87.8, 88.8], n = floor(x·log2(e) +
# 0.5) clamped to ±127, r = x − n·ln2 in two fused steps, a fused Horner
# polynomial, e = r + p·r² + 1, then e·2^n.
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511, 0.04166579619050026,
          0.1666666567325592, 0.5)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 tanh on the CPU, bit for bit (f32 in, f32 out)."""
    f32 = torch.float32
    k = lambda v: torch.tensor(v, dtype=f32, device=x.device)  # noqa: E731
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = k(_TANH_P[0]).expand_as(x2)
    for c in _TANH_P[1:]:
        p = fma_f32(x2, p, k(c))
    q = k(_TANH_Q[0]).expand_as(x2)
    for c in _TANH_Q[1:]:
        q = fma_f32(x2, q, k(c))
    out = (xc * p) / q
    ax = torch.abs(x)
    out = torch.where(ax < k(0.00039999998989515007), x, out)
    return torch.where(ax >= k(20.0), torch.copysign(k(1.0), x), out)


def xla_exp_plus_one(x: torch.Tensor) -> torch.Tensor:
    """exp(x) + 1 as XLA's f32 exp followed by ``+ 1`` computes it on the
    CPU, bit for bit: the last scaling e·2^n and the ``+ 1`` are one fused
    multiply-add."""
    f32 = torch.float32
    k = lambda v: torch.tensor(v, dtype=f32, device=x.device)  # noqa: E731
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma_f32(x, k(_LOG2E), k(0.5))), -127.0, 127.0)
    r = fma_f32(n, k(-_LN2_HI), x)
    r = fma_f32(n, k(-_LN2_LO), r)
    p = k(_EXP_P[0]).expand_as(r)
    for c in _EXP_P[1:]:
        p = fma_f32(p, r, k(c))
    e = fma_f32(p, r * r, r) + k(1.0)
    two_n = ((n.to(torch.int32) + 127) << 23).view(f32)
    return fma_f32(e, two_n, k(1.0))


def _affine(terms: list, bias: torch.Tensor) -> torch.Tensor:
    """bias + Σ w·x over ``terms`` [(x, w)] left to right, each step one
    fused multiply-add; a zero bias vanishes, and the first two products
    then meet in one fused multiply-add (XLA's ``0 + a → a``, LLVM's fusion
    of the left product)."""
    (x0, w0), rest = terms[0], terms[1:]
    if float(bias) == 0.0:
        (x1, w1), rest = rest[0], rest[1:]
        acc = fma_f32(x0, w0, x1 * w1)
    else:
        acc = fma_f32(x0, w0, bias)
    for x, w in rest:
        acc = fma_f32(x, w, acc)
    return acc


def pre_floor(state, pf, weights) -> torch.Tensor:
    """(C, N) f32: ``y · 100 + 0.5``, the value the score floors, in XLA's
    arithmetic (see the module docstring)."""
    c, n = pf["tp_slot"].shape[0], state.valid.shape[0]
    dev = state.valid.device
    w1, b1, w2, b2 = weights
    f32 = torch.float32

    def k(v: float) -> torch.Tensor:  # a weight rounded to f32, as JAX's f32(w)
        return torch.tensor(v, dtype=f32, device=dev)

    x = [v.expand(c, n) for v in features(state, pf)]
    hs = []
    for j in range(len(b1)):
        # The throughput feature's division by MaxNodeScore folds into its
        # weight: tput · fl(w / 100).  A device tensor divides, not a Python
        # number: CUDA divides by a host scalar as a multiply by its
        # reciprocal, which rounds differently.
        terms = [(x[i], k(w1[i][j]) / k(float(MAX_NODE_SCORE)) if i == 3 else k(w1[i][j])) for i in range(len(x))]
        hs.append(xla_tanh(_affine(terms, k(b1[j]))))
    y = _affine([(hs[j], k(w2[j])) for j in range(len(b1))], k(b2))
    s = k(1.0) / xla_exp_plus_one(-y)
    return fma_f32(s, k(float(MAX_NODE_SCORE)), k(0.5))


def score_fn(state, pf, ctx: PassContext, feasible):
    """The plain version of eval_chunk's learned term: (C, N) i64."""
    weights = ctx.static.get("learned_weights") if ctx.static else None
    if not weights:
        return torch.zeros((pf["tp_slot"].shape[0], state.valid.shape[0]), dtype=torch.int64,
                           device=state.valid.device)
    return torch.floor(pre_floor(state, pf, weights)).to(torch.int64)


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
