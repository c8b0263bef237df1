"""TaintToleration: featurization and the plain PyTorch filter and score.

Counterpart of ``kubernetes_tpu/ops/tainttoleration.py``.  Reference
(plugins/tainttoleration/taint_toleration.go):
  * Filter (:110): a node is infeasible if it has any NoSchedule/NoExecute
    taint the pod does not tolerate.
  * Score (:171): the count of PreferNoSchedule taints the pod's
    PreferNoSchedule-effect tolerations do not tolerate, reverse-normalized
    over the feasible nodes.

Taints are interned into a (key, value, effect) vocabulary and node rows
carry taint-id slots; featurization evaluates the pod's tolerations against
the whole vocabulary once into two (TV,) masks, so the filter and score are
gathers.  The functions below are the plain versions over a chunk of C
pods; on the card the ``node_filters`` kernel computes the filter once per
batch and the ``late_scores`` entry of ``spread_eval`` the score.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register
from .helpers import default_normalize_score, gather_mask

_DO_NOT_SCHEDULE = (t.EFFECT_NO_SCHEDULE, t.EFFECT_NO_EXECUTE)


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    it = fctx.interns
    builder = fctx.builder
    builder._ensure(TV=max(len(it.taints), 1))
    tv = builder.schema.TV
    intol_hard = np.zeros(tv, np.bool_)
    intol_pref = np.zeros(tv, np.bool_)
    tols = pod.spec.tolerations
    # Only empty-effect / PreferNoSchedule tolerations count for scoring
    # (getAllTolerationPreferNoSchedule, taint_toleration.go:143).
    pref_tols = tuple(
        tol for tol in tols if not tol.effect or tol.effect == t.EFFECT_PREFER_NO_SCHEDULE
    )
    for tid in range(len(it.taints)):
        key, value, effect = it.taints.value(tid)
        taint = t.Taint(key, value, effect)
        if effect in _DO_NOT_SCHEDULE:
            intol_hard[tid] = not any(tol.tolerates(taint) for tol in tols)
        elif effect == t.EFFECT_PREFER_NO_SCHEDULE:
            intol_pref[tid] = not any(tol.tolerates(taint) for tol in pref_tols)
    return {"taint_intol_hard": intol_hard, "taint_intol_pref": intol_pref}


def filter_fn(state, pf, ctx: PassContext, own: bool = False):
    """(C, N) bool: no intolerable hard taint on the node; with ``own``,
    (C, 1): pod c on node c of a gathered view."""
    return ~gather_mask(pf["taint_intol_hard"], state.taint_ids, own).any(dim=2)


def raw_score(state, pf) -> torch.Tensor:
    """(C, N) i64: intolerable PreferNoSchedule taints on the node."""
    return gather_mask(pf["taint_intol_pref"], state.taint_ids).to(torch.int64).sum(dim=2)


def score_fn(state, pf, ctx: PassContext, feasible):
    return default_normalize_score(raw_score(state, pf), feasible, reverse=True)


feature_fill("taint_intol_hard", 0)
feature_fill("taint_intol_pref", 0)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    # With no taints interned anywhere, the filter passes every node and the
    # score is a uniform MaxNodeScore, which cannot change a decision.
    return len(fctx.interns.taints) > 0


register(
    OpDef(
        name="TaintToleration",
        featurize=featurize,
        filter=filter_fn,
        score=score_fn,
        is_active=is_active,
    )
)
