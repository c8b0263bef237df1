"""ThroughputAware: heterogeneity-aware scoring from a throughput matrix.

Counterpart of ``kubernetes_tpu/ops/throughput.py``.  A candidate node
scores its accelerator class's throughput for the pod's workload class,
normalized by the best throughput of the matrix row (Gavel's normalized
effective throughput, arxiv 2008.09213).  The normalizer is the static
row maximum, never the feasible-set maximum, so a node's score depends on
that node alone.

The accelerator class is a node label (``scheduler.tpu/accel``) that rides
``state.topo_vals`` as a topology key; the pod's workload class is a label
(``scheduler.tpu/workload-class``).  Featurization turns the pod's matrix
row into a (DV,) table of normalized scores, so the device score is one
gather per node: the table at the node's class id, 0 for a node with no
class.  On the card the ``eval_chunk`` kernel (kernels/csrc/eval_chunk.cu)
computes the same gather; ``score_fn`` below is its plain version.

``load_matrix`` (a measured matrix file) waits for the serving surface,
which brings ``framework/measured.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from ..framework.config import MAX_NODE_SCORE, Profile
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register

# The accelerator-class node label, featurized as a topology key.
ACCEL_LABEL_KEY = "scheduler.tpu/accel"
# The pod-side workload class selecting the matrix row.
WORKLOAD_CLASS_LABEL_KEY = "scheduler.tpu/workload-class"

# The default per-(workload-class, accelerator-class) throughput matrix, in
# integer milli-throughput (only ratios matter); each class has its own
# ordering of the accelerators.
DEFAULT_THROUGHPUT_MATRIX: tuple[tuple[str, tuple[tuple[str, int], ...]], ...] = (
    ("train-large", (("tpu-v4", 1000), ("tpu-v5e", 520), ("gpu-a100", 410))),
    ("train-small", (("tpu-v4", 760), ("tpu-v5e", 980), ("gpu-a100", 650))),
    ("serve", (("tpu-v4", 540), ("tpu-v5e", 1000), ("gpu-a100", 720))),
    ("batch", (("tpu-v4", 330), ("tpu-v5e", 450), ("gpu-a100", 1000))),
)


def matrix_accel_classes(
    matrix: tuple[tuple[str, tuple[tuple[str, int], ...]], ...]
) -> tuple[str, ...]:
    """Every accelerator class any matrix row names, first-seen order."""
    seen: dict[str, None] = {}
    for _wclass, row in matrix:
        for accel, _tput in row:
            seen.setdefault(accel, None)
    return tuple(seen)


def pod_workload_class(pod: t.Pod) -> str | None:
    return pod.metadata.labels.get(WORKLOAD_CLASS_LABEL_KEY)


def node_accel_class(node: t.Node) -> str | None:
    return node.metadata.labels.get(ACCEL_LABEL_KEY)


def reference_scores(pod: t.Pod, nodes: list[t.Node], matrix=DEFAULT_THROUGHPUT_MATRIX) -> list[int]:
    """Pure-Python scores of the pod on each node: the normalized
    throughput in [0, MAX_NODE_SCORE], 0 for an unlabeled node or a class
    the matrix does not list."""
    row = dict(matrix).get(pod_workload_class(pod))
    if not row:
        return [0 for _ in nodes]
    best = max(max(tput for _accel, tput in row), 1)
    by_accel = dict(row)
    return [(by_accel.get(node_accel_class(n) or "", 0) * MAX_NODE_SCORE) // best for n in nodes]


def preseed_hetero_vocab(builder, matrix=DEFAULT_THROUGHPUT_MATRIX) -> None:
    """Intern the accelerator-class key and values and the workload-class
    keys before any pod or labeled node arrives, so the first
    heterogeneous pod of a window grows no vocabulary or schema.
    Idempotent."""
    it = builder.interns
    builder.ensure_topo_key(ACCEL_LABEL_KEY)
    it.label_keys.id(ACCEL_LABEL_KEY)
    it.label_keys.id(WORKLOAD_CLASS_LABEL_KEY)
    for accel in matrix_accel_classes(matrix):
        it.topo_value_id(ACCEL_LABEL_KEY, accel)
        it.label_pairs.id((ACCEL_LABEL_KEY, accel))
    for wclass, _row in matrix:
        it.label_pairs.id((WORKLOAD_CLASS_LABEL_KEY, wclass))
    builder._ensure(DV=it.max_topo_vocab())


def _tp_features(pod: t.Pod, fctx: FeaturizeContext, matrix) -> dict:
    """(tp_scores (DV,) i64, tp_slot () i32): the pod's normalized score per
    accelerator-class id and the class key's topology slot.  Every class
    of the row is interned first, so DV grows here, on the host, before a
    pass."""
    builder = fctx.builder
    it = fctx.interns
    slot = builder.ensure_topo_key(ACCEL_LABEL_KEY)
    row = dict(matrix).get(pod_workload_class(pod)) if matrix else None
    if row:
        vids = {it.topo_value_id(ACCEL_LABEL_KEY, accel): tput for accel, tput in row}
        builder._ensure(DV=it.max_topo_vocab())
    else:
        vids = {}
    dv = builder.schema.DV
    scores = np.zeros(dv, np.int64)
    if vids:
        # validate_profile refuses an all-zero row; max(..., 1) keeps an
        # unvalidated one at score 0.
        best = max(max(vids.values()), 1)
        for vid, tput in vids.items():
            if vid < dv:
                scores[vid] = tput * MAX_NODE_SCORE // best
    return {"tp_scores": scores, "tp_slot": np.int32(slot)}


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    matrix = fctx.profile.throughput_matrix if fctx.profile is not None else ()
    return _tp_features(pod, fctx, matrix)


def tput_gather(state, pf) -> torch.Tensor:
    """(C, N) i64: each pod's score table at each node's accelerator-class
    id (``topo_vals`` at the pod's ``tp_slot``), 0 where the node has no
    class.  An id past the table reads its last entry, as JAX's clamped
    gather does."""
    tk = state.topo_vals.shape[1]
    slot = pf["tp_slot"].to(torch.int64).clamp(0, tk - 1)
    vals = state.topo_vals.t().index_select(0, slot)  # (C, N)
    dv = pf["tp_scores"].shape[1]
    got = pf["tp_scores"].gather(1, vals.to(torch.int64).clamp(0, dv - 1))
    return torch.where(vals >= 0, got, 0).to(torch.int64)


def score_fn(state, pf, ctx: PassContext, feasible):
    """The plain version of eval_chunk's throughput term."""
    return tput_gather(state, pf)


feature_fill("tp_scores", 0)
feature_fill("tp_slot", 0)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    """Active when the profile has a matrix row for the pod's class and some
    node carries the class label (else every score is 0)."""
    profile = fctx.profile
    if profile is None or not profile.throughput_matrix:
        return False
    if pod_workload_class(pod) not in dict(profile.throughput_matrix):
        return False
    return ACCEL_LABEL_KEY in fctx.interns.label_keys


register(OpDef(name="ThroughputAware", featurize=featurize, score=score_fn, is_active=is_active))


def throughput_aware_profile(matrix: tuple = DEFAULT_THROUGHPUT_MATRIX, weight: int = 3) -> Profile:
    """The default plugin set plus the ThroughputAware scorer, selected by
    pods naming ``schedulerName: throughput-aware-scheduler``; registered
    beside the default with ``TorchScheduler(profiles=[...])``."""
    base = Profile()
    return Profile(
        name="throughput-aware-scheduler",
        scorers=base.scorers + (("ThroughputAware", weight),),
        throughput_matrix=tuple((w, tuple(r)) for w, r in matrix),
    )
