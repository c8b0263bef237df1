"""Op interface: the counterpart of ``kubernetes_tpu/ops/common.py``.

Each op is the batched form of one in-tree scheduling plugin.  It
contributes

  featurize(pod, fctx) → per-pod feature dict (host, numpy; stacked over
      the batch by the engine),
  filter(state, pf, ctx) → (C, N) bool feasibility of C pods over all node
      rows at once,
  score(state, pf, ctx, feasible) → (C, N) int64 in [0, MAX_NODE_SCORE],

where ``pf`` is the feature dict of one chunk of C pods (each leaf (C, …)).
Unlike the JAX ops, which are traced per pod and vmapped, the plain
versions here are written over the chunk axis directly.  They are the
reference for the CUDA kernels (kernels/csrc) and what a CPU tensor runs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

from ..framework.config import Profile
from ..framework.features import DEFAULT_GATES, FeatureGates
from ..snapshot import Schema, SnapshotBuilder


@dataclass
class FeaturizeContext:
    """Host-side context handed to op featurizers."""

    builder: SnapshotBuilder
    profile: Optional[Profile] = None
    # Batch-active op names (None until build_pod_batch resolves them).
    active: Optional[frozenset] = None

    @property
    def interns(self):
        return self.builder.interns

    @property
    def schema(self) -> Schema:
        return self.builder.schema

    @property
    def gates(self) -> FeatureGates:
        """Feature gates set on the SnapshotBuilder, or the defaults."""
        return self.builder.feature_gates or DEFAULT_GATES


@dataclass(frozen=True)
class PassContext:
    """Static context of op filter/score functions.  ``static`` holds
    per-profile resolved config (e.g. scoring-strategy resource columns).
    ``nom`` is the nominated-pod overlay bound per pass: (nom_req (N,R)
    i64, nom_cnt (N,) i32, nom_prio (N,) i32 = max nominated priority, or
    INT32_MIN when none) — RunFilterPluginsWithNominatedPods
    (runtime/framework.go:973)."""

    profile: Profile
    schema: Schema
    static: dict = None  # type: ignore[assignment]
    dom: object = None  # engine.pass_.DomTables, bound per pass
    nom: object = None


@dataclass(frozen=True)
class OpDef:
    name: str
    featurize: Optional[Callable] = None  # (pod, FeaturizeContext) -> dict
    filter: Optional[Callable] = None  # (state, pf, PassContext) -> (C, N) bool
    # (state, pf, PassContext, feasible (C, N) bool) -> (C, N) i64
    score: Optional[Callable] = None
    # (state, pf, PassContext) -> (C, N) bool: nodes the op rejects as
    # UnschedulableAndUnresolvable.  Preemption's candidacy check reads it
    # for the ops of the what-if search (InterPodAffinity,
    # PodTopologySpread, DynamicResources; preemption.py:237-243, 363-366)
    # and nowhere else.
    hard_filter: Optional[Callable] = None
    # (profile, schema, builder_res_col) -> dict merged into PassContext.static
    static: Optional[Callable] = None
    # (pod, FeaturizeContext) -> bool: does this op do anything for this
    # pod in this cluster?  None ⇒ always active.
    is_active: Optional[Callable] = None


# Pad fill per feature key when featurization grows the schema mid-batch and
# early pods' arrays are shorter than the final schema shape.
FEATURE_FILLS: dict[str, int] = {}


def feature_fill(key: str, fill: int) -> None:
    FEATURE_FILLS[key] = fill


_REGISTRY: dict[str, OpDef] = {}


def register(op: OpDef) -> OpDef:
    _REGISTRY[op.name] = op
    return op


def get(name: str) -> OpDef:
    return _REGISTRY[name]


def has(name: str) -> bool:
    return name in _REGISTRY


def registered_subset(profile: Profile) -> Profile:
    """Restrict a profile to plugins with registered ops."""
    return dataclasses.replace(
        profile,
        filters=tuple(f for f in profile.filters if f in _REGISTRY),
        scorers=tuple((s, w) for s, w in profile.scorers if s in _REGISTRY),
    )
