"""Profiles: which plugins run, with what weights.

The port's own copy of the profile surface of
``kubernetes_tpu/framework/config.py`` (Profile, ScoringStrategy, the
strategy constants, DEFAULT_PROFILE, fit_only_profile) and of
``validate_profile``'s rules for the filter and score lists, the scoring
strategy and the heterogeneity config.  Config parsing, the rules for the
other extension points and multiPoint expansion stay with the JAX package
until the serving slice ports them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from ..api import types as t

MAX_NODE_SCORE = 100  # framework.MaxNodeScore (interface.go)

# Scoring strategy types (apis/config/types_pluginargs.go:187–194).
LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"


@dataclass(frozen=True)
class ScoringStrategy:
    type: str = LEAST_ALLOCATED
    # (resource name, weight) — default cpu/memory weight 1 each
    # (v1/default_plugins.go defaultResourceSpec).
    resources: tuple[tuple[str, int], ...] = (("cpu", 1), ("memory", 1))
    # RequestedToCapacityRatio shape points: (utilization%, score 0..10),
    # rescaled to MaxNodeScore like the reference's buildRequestedToCapacityRatioScorerFunction.
    shape: tuple[tuple[int, int], ...] = ((0, 0), (100, 10))


@dataclass(frozen=True)
class Profile:
    """One scheduler profile = one compiled device program variant."""

    name: str = "default-scheduler"
    # Filter plugins, in the reference's MultiPoint order
    # (v1/default_plugins.go:32–52).
    filters: tuple[str, ...] = (
        "NodeUnschedulable",
        "NodeName",
        "TaintToleration",
        "NodeAffinity",
        "NodePorts",
        "NodeResourcesFit",
        "VolumeRestrictions",
        "NodeVolumeLimits",
        "VolumeBinding",
        "VolumeZone",
        "PodTopologySpread",
        "InterPodAffinity",
        "DynamicResources",
    )
    # (score plugin, weight) — default weights from default_plugins.go.
    scorers: tuple[tuple[str, int], ...] = (
        ("TaintToleration", 3),
        ("NodeAffinity", 2),
        ("NodeResourcesFit", 1),
        ("PodTopologySpread", 2),
        ("InterPodAffinity", 2),
        ("NodeResourcesBalancedAllocation", 1),
        ("ImageLocality", 1),
    )
    scoring_strategy: ScoringStrategy = field(default_factory=ScoringStrategy)
    # None → adaptive default formula 50 − nodes/125 (schedule_one.go:676);
    # 100 → evaluate all nodes (the TPU-native default: full evaluation is a
    # small matrix op, truncation only exists for upstream-parity configs).
    percentage_of_nodes_to_score: int | None = 100
    # InterPodAffinityArgs.HardPodAffinityWeight (types_pluginargs.go:28):
    # score bonus per existing pod whose required affinity matches the
    # incoming pod.
    hard_pod_affinity_weight: int = 1
    # NodeAffinityArgs.AddedAffinity (types_pluginargs.go:90): a per-profile
    # NodeAffinity ANDed with every pod's own — required terms join the
    # filter (node_affinity.go:146), preferred terms join the score.
    added_affinity: Optional["t.NodeAffinity"] = None
    # NodeResourcesFitArgs.IgnoredResources / IgnoredResourceGroups
    # (types_pluginargs.go:45): EXTENDED resources (never cpu/memory/
    # ephemeral-storage/pods) the fit FILTER skips; groups match the prefix
    # before "/" (fit.go:488 fitsRequest).
    fit_ignored_resources: tuple[str, ...] = ()
    fit_ignored_resource_groups: tuple[str, ...] = ()
    # PodTopologySpreadArgs.DefaultConstraints (types_pluginargs.go:72, List
    # defaulting): applied to pods with no constraints of their own.  The
    # reference derives each constraint's selector from the services/
    # replicasets owning the pod (plugins/helper DefaultSelector); without a
    # controller model the analog is the pod's own full label set, and
    # label-less pods are skipped like selector-less defaults are.
    pts_default_constraints: tuple["t.TopologySpreadConstraint", ...] = ()
    # Deterministic tie-break seed (parity mode: both sides share it).
    tie_break_seed: int = 0
    # The remaining extension-point lists (types.go Plugins struct; effective
    # defaults = multiPoint expansion, runtime/framework.go:511).  ``filters``
    # and ``scorers`` above are the filter/score lists; these map to host
    # behaviors: preEnqueue → queue gating, postFilter → preemption,
    # reserve/preBind → host ReservePlugins, permit → PermitPlugins,
    # bind → the in-process binder.  preFilter/preScore are accepted and
    # validated for config parity; the device engine fuses those phases into
    # featurize + the compiled pass, so membership there has no separate
    # runtime switch (the fused op activates off filters/scorers).
    pre_enqueue: tuple[str, ...] = ("SchedulingGates", "DynamicResources")
    queue_sort: tuple[str, ...] = ("PrioritySort",)
    pre_filter: tuple[str, ...] = (
        "NodeAffinity", "NodePorts", "NodeResourcesFit", "VolumeRestrictions",
        "NodeVolumeLimits", "VolumeBinding", "VolumeZone", "PodTopologySpread",
        "InterPodAffinity", "DynamicResources",
    )
    post_filter: tuple[str, ...] = ("DynamicResources", "DefaultPreemption")
    pre_score: tuple[str, ...] = (
        "TaintToleration", "NodeAffinity", "NodeResourcesFit",
        "PodTopologySpread", "InterPodAffinity",
        "NodeResourcesBalancedAllocation",
    )
    reserve: tuple[str, ...] = ("VolumeBinding", "DynamicResources")
    permit: tuple[str, ...] = ("Coscheduling",)
    pre_bind: tuple[str, ...] = ("VolumeBinding", "DynamicResources")
    bind: tuple[str, ...] = ("DefaultBinder",)
    post_bind: tuple[str, ...] = ()
    # Out-of-tree plugins accepted by the config surface with opaque args
    # (name → json-encoded args), served by the sidecar, not the engine.
    foreign: tuple[tuple[str, str], ...] = ()  # (name, json-encoded args)
    # Heterogeneity-aware scoring (kubernetes_tpu/ops/throughput.py): the
    # per-(workload-class, accelerator-class) throughput matrix —
    # ((workload_class, ((accel_class, milli_throughput), ...)), ...) —
    # deterministic profile config the ThroughputAware op bakes into its
    # featurized score tables.  Empty ⇒ the op is inactive.
    throughput_matrix: tuple[tuple[str, tuple[tuple[str, int], ...]], ...] = ()
    # LearnedScorer MLP weights (kubernetes_tpu/ops/learned.py load_weights output:
    # ((w1 rows...), (b1...), (w2...), b2)) — the committed inference
    # artifact, static per pass.  Empty ⇒ the op is inactive.
    learned_weights: tuple = ()


DEFAULT_PROFILE = Profile()


def validate_profile(profile: Profile) -> list[str]:
    """Strict config validation (pkg/scheduler/apis/config/validation):
    the violations of the filter and score lists, the scoring strategy and
    the heterogeneity config, as messages (empty = valid).  A plugin is
    known when the port registers its op."""
    from ..ops import common as opcommon

    errs: list[str] = []
    if not profile.name:
        errs.append("profile.name must be non-empty")
    seen_f: set[str] = set()
    for name in profile.filters:
        if not opcommon.has(name) or opcommon.get(name).filter is None:
            errs.append(f"filters[{name!r}]: unknown plugin")
        if name in seen_f:
            errs.append(f"filters[{name!r}]: duplicate entry")
        seen_f.add(name)
    seen: set[str] = set()
    for name, weight in profile.scorers:
        if not opcommon.has(name) or opcommon.get(name).score is None:
            errs.append(f"scorers[{name!r}]: unknown plugin")
        if name in seen:
            errs.append(f"scorers[{name!r}]: duplicate entry")
        seen.add(name)
        # Weight bounds (validation.go validatePluginConfig: weight 1..100).
        if not 1 <= weight <= 100:
            errs.append(f"scorers[{name!r}]: weight {weight} outside [1, 100]")
    pct = profile.percentage_of_nodes_to_score
    if pct is not None and not 0 <= pct <= 100:
        errs.append(f"percentage_of_nodes_to_score {pct} outside [0, 100]")
    strat = profile.scoring_strategy
    if strat.type not in (LEAST_ALLOCATED, MOST_ALLOCATED, REQUESTED_TO_CAPACITY_RATIO):
        errs.append(f"scoring_strategy.type {strat.type!r} unknown")
    if not strat.resources:
        errs.append("scoring_strategy.resources must be non-empty")
    for rname, weight in strat.resources:
        if not 1 <= weight <= 100:
            errs.append(f"scoring_strategy.resources[{rname!r}]: weight {weight} outside [1, 100]")
    if strat.type == REQUESTED_TO_CAPACITY_RATIO:
        # validateFunctionShape: at least 2 points, utilization strictly
        # increasing in [0, 100], scores in [0, 10].
        utils = [p[0] for p in strat.shape]
        if len(strat.shape) < 2 or any(b <= a for a, b in zip(utils, utils[1:])):
            errs.append("scoring_strategy.shape must be ≥2 points with strictly increasing utilization")
        for u, score in strat.shape:
            if not 0 <= u <= 100:
                errs.append(f"scoring_strategy.shape utilization {u} outside [0, 100]")
            if not 0 <= score <= 10:
                errs.append(f"scoring_strategy.shape score {score} outside [0, 10]")
    if profile.hard_pod_affinity_weight < 0 or profile.hard_pod_affinity_weight > 100:
        errs.append("hard_pod_affinity_weight outside [0, 100]")
    # Heterogeneity config: an enabled op without its artifact would score
    # a constant.
    scorer_names = {s for s, _w in profile.scorers}
    seen_classes: set[str] = set()
    for wclass, row in profile.throughput_matrix:
        if wclass in seen_classes:
            errs.append(f"throughput_matrix[{wclass!r}]: duplicate workload class")
        seen_classes.add(wclass)
        if not row:
            errs.append(f"throughput_matrix[{wclass!r}]: empty accelerator row")
        elif not any(isinstance(tput, int) and tput > 0 for _a, tput in row):
            # The featurizer divides by the row's maximum.
            errs.append(f"throughput_matrix[{wclass!r}]: row needs at least one positive throughput")
        seen_accels: set[str] = set()
        for accel, tput in row:
            if accel in seen_accels:
                errs.append(f"throughput_matrix[{wclass!r}][{accel!r}]: duplicate accelerator")
            seen_accels.add(accel)
            if not isinstance(tput, int) or tput < 0:
                errs.append(f"throughput_matrix[{wclass!r}][{accel!r}]: throughput {tput!r} must be a "
                            "non-negative int")
    if "ThroughputAware" in scorer_names and not profile.throughput_matrix:
        errs.append("scorers[ThroughputAware]: profile.throughput_matrix is empty")
    if "LearnedScorer" in scorer_names and not profile.learned_weights:
        errs.append("scorers[LearnedScorer]: profile.learned_weights is empty")
    if profile.learned_weights:
        lw = profile.learned_weights
        if len(lw) != 4 or not (lw[0] and lw[1] and lw[2] is not None):
            errs.append("learned_weights: want ((w1...), (b1...), (w2...), b2)")
        else:
            w1, b1, w2, _b2 = lw
            hidden = len(b1)
            if any(len(r) != hidden for r in w1) or len(w2) != hidden:
                errs.append("learned_weights: inconsistent hidden width")
    return errs


def fit_only_profile() -> Profile:
    """NodeResourcesFit-only profile (BASELINE config #1 shape)."""
    return Profile(
        name="fit-only",
        filters=("NodeUnschedulable", "NodeName", "NodeResourcesFit"),
        scorers=(("NodeResourcesFit", 1),),
    )
