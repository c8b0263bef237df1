"""NodeResourcesFit + NodeResourcesBalancedAllocation, plain PyTorch.

Counterpart of ``kubernetes_tpu/ops/noderesources.py``.  Reference semantics:
  * Filter — fitsRequest (plugins/noderesources/fit.go:488–560): pod count,
    then for each requested resource, request ≤ allocatable − requested(node).
    A resource the pod does not request never fails.
  * Score — strategy scorers (least_allocated.go / most_allocated.go /
    requested_to_capacity_ratio.go) over NonZeroRequested for cpu/memory and
    Requested for other resources (resource_allocation.go:89–114).
  * BalancedAllocation — 1 − std of resource utilization fractions
    (balanced_allocation.go:138 balancedResourceScorer), over plain Requested.

These are the plain versions over a chunk of C pods × N nodes, with the
JAX package's operation order (floor division, f64 fractions, the
two-resource ``|f − mean|`` form).  On the card the ``eval_chunk`` kernel
(kernels/csrc/eval_chunk.cu) computes the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from ..framework.config import (
    LEAST_ALLOCATED,
    MAX_NODE_SCORE,
    MOST_ALLOCATED,
    REQUESTED_TO_CAPACITY_RATIO,
)
from ..snapshot import FIXED_RESOURCES
from .common import FeaturizeContext, OpDef, PassContext, register
from .helpers import fma_f64

# Kind tags for strategy resource columns: where the "requested" number for a
# resource comes from (resource_allocation.go:89 calculateResourceAllocatableRequest).
_KIND_NONZERO_CPU = 0  # NodeInfo.NonZeroRequested.MilliCPU
_KIND_NONZERO_MEM = 1  # NodeInfo.NonZeroRequested.Memory
_KIND_REQ_COL = 2  # NodeInfo.Requested column


def strategy_columns(profile, builder_res_col: dict[str, int]):
    """Resolve the scoring strategy's resource list to (kind, col, weight)."""
    out = []
    for name, weight in profile.scoring_strategy.resources:
        if name == t.CPU:
            out.append((_KIND_NONZERO_CPU, 0, weight))
        elif name == t.MEMORY:
            out.append((_KIND_NONZERO_MEM, 1, weight))
        else:
            col = builder_res_col.get(name)
            if col is not None:
                out.append((_KIND_REQ_COL, col, weight))
    return tuple(out)


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    # Base req/nonzero features are provided by the engine; nothing extra here.
    return {}


def _floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def filter_fn(state, pf, ctx: PassContext):
    # Pod count check always applies (fit.go:491).
    fits = (state.num_pods + 1 <= state.allowed_pods)[None, :]  # (1, N)
    req = pf["req"]  # (C, R) i64
    # NodeResourcesFitArgs.IgnoredResources: zero the demand in the FIT
    # check only — bind-time accounting still charges the full delta.
    ig = ctx.static.get("fit_ignored_cols", ()) if ctx.static else ()
    req_fit = req
    if ig:
        req_fit = req.clone()
        req_fit[:, list(ig)] = 0
    rf = req_fit[:, None, :]  # (C, 1, R)
    free = (state.alloc - state.req)[None]  # (1, N, R)
    fits = fits & ((rf == 0) | (rf <= free)).all(dim=-1)
    if ctx.nom is not None:
        # Nominated-pod accounting (RunFilterPluginsWithNominatedPods,
        # runtime/framework.go:973), per node when the pod's priority ≤ the
        # node's max nominated priority; the pod's own nomination is
        # excluded.
        nom_req, nom_cnt, nom_prio = ctx.nom
        n = state.alloc.shape[0]
        own = pf["nominated_row"][:, None]  # (C, 1)
        rows = torch.arange(n, device=own.device)[None, :]
        self_mask = (rows == own) & (own >= 0)  # (C, N)
        eff_req = torch.clamp(
            nom_req[None]
            - torch.where(self_mask[:, :, None], req[:, None, :], torch.zeros_like(req[:, None, :])),
            min=0,
        )  # (C, N, R)
        eff_cnt = torch.clamp(nom_cnt[None] - self_mask.to(torch.int32), min=0)
        fits_nom = ((rf == 0) | (rf <= free - eff_req)).all(dim=-1)
        fits_nom = fits_nom & (state.num_pods[None] + 1 + eff_cnt <= state.allowed_pods[None])
        applies = pf["priority"][:, None] <= nom_prio[None]
        fits = fits & (fits_nom | ~applies)
    return fits


def _requested_totals(state, pf, cols):
    """Per strategy resource: (alloc (1, N), requested-including-pod (C, N), weight)."""
    out = []
    for kind, col, weight in cols:
        if kind == _KIND_NONZERO_CPU:
            alloc = state.alloc[:, 0]
            reqd = state.nonzero_req[None, :, 0] + pf["nonzero"][:, 0:1]
        elif kind == _KIND_NONZERO_MEM:
            alloc = state.alloc[:, 1]
            reqd = state.nonzero_req[None, :, 1] + pf["nonzero"][:, 1:2]
        else:
            alloc = state.alloc[:, col]
            reqd = state.req[None, :, col] + pf["req"][:, col : col + 1]
        out.append((alloc[None, :], reqd, weight))
    return out


def _least_requested(alloc, reqd):
    # least_allocated.go:97 — ((capacity-requested)*MaxNodeScore)/capacity,
    # 0 when capacity == 0 or requested > capacity.
    ok = (alloc > 0) & (reqd <= alloc)
    safe_alloc = torch.clamp(alloc, min=1)
    return torch.where(ok, _floordiv((alloc - reqd) * MAX_NODE_SCORE, safe_alloc), 0)


def _most_requested(alloc, reqd):
    # most_allocated.go — requested*MaxNodeScore/capacity, 0 outside [0, cap].
    ok = (alloc > 0) & (reqd <= alloc)
    safe_alloc = torch.clamp(alloc, min=1)
    return torch.where(ok, _floordiv(reqd * MAX_NODE_SCORE, safe_alloc), 0)


def _interp(x: torch.Tensor, xs: np.ndarray, ys: np.ndarray) -> torch.Tensor:
    """jnp.interp in f64 as the reference computes it (constant
    extrapolation outside [xs[0], xs[-1]]): the same operation order, and
    the last step ``fp[i-1] + (delta/dx)*df`` rounded once, as XLA fuses it
    into a multiply-add (``fma_f64``; rounded twice it differs in the last
    bit, which flips the truncated score of a decreasing shape at some
    integer utilizations)."""
    xp = torch.tensor(xs, dtype=torch.float64, device=x.device)
    fp = torch.tensor(ys, dtype=torch.float64, device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xs) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(np.float64).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fma_f64(delta / torch.where(dx0, 1.0, dx), df, fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _ratio_scorer(shape):
    """BuildBrokenLinearFunction over (utilization%, score 0..10) points,
    scaled to MaxNodeScore (requested_to_capacity_ratio.go)."""
    xs = np.array([p[0] for p in shape], np.float64)
    ys = np.array([p[1] for p in shape], np.float64)

    def f(alloc, reqd):
        alloc, reqd = torch.broadcast_tensors(alloc, reqd)
        util = torch.where(
            alloc > 0,
            (reqd.to(torch.float64) * 100.0) / torch.clamp(alloc, min=1).to(torch.float64),
            0.0,
        )
        raw = _interp(util.contiguous(), xs, ys)
        ok = (alloc > 0) & (reqd <= alloc)
        return torch.where(ok, (raw * (MAX_NODE_SCORE / 10)).to(torch.int64), 0)

    return f


def score_fn(state, pf, ctx: PassContext, feasible=None):
    cols = ctx.static["fit_strategy_cols"]
    strat = ctx.profile.scoring_strategy.type
    if strat == REQUESTED_TO_CAPACITY_RATIO:
        scorer = _ratio_scorer(ctx.profile.scoring_strategy.shape)
    elif strat == MOST_ALLOCATED:
        scorer = _most_requested
    elif strat == LEAST_ALLOCATED:
        scorer = _least_requested
    else:
        raise ValueError(f"unknown scoring strategy {strat!r}")
    c, n = pf["req"].shape[0], state.alloc.shape[0]
    dev = state.alloc.device
    node_score = torch.zeros((c, n), dtype=torch.int64, device=dev)
    weight_sum = torch.zeros((1, n), dtype=torch.int64, device=dev)
    for alloc, reqd, weight in _requested_totals(state, pf, cols):
        # `if allocable[i] == 0 { continue }` skips the weight too
        # (least_allocated.go:72) — weightSum varies per node.
        present = alloc > 0
        node_score = node_score + torch.where(present, scorer(alloc, reqd) * weight, 0)
        weight_sum = weight_sum + torch.where(present, weight, 0)
    return torch.where(
        weight_sum > 0, _floordiv(node_score, torch.clamp(weight_sum, min=1)), 0
    )


def balanced_score_fn(state, pf, ctx: PassContext, feasible=None):
    """balancedResourceScorer: fractions of Requested/Allocatable (capped at
    1), score = (1 − std) * MaxNodeScore, truncated.  Uses plain Requested
    (useRequested, balanced_allocation.go:135) — no nonzero defaults."""
    cols = ctx.static["balanced_cols"]
    c, n = pf["req"].shape[0], state.alloc.shape[0]
    dev = state.alloc.device
    fracs = []
    present = []
    for (col,) in cols:
        alloc = state.alloc[:, col][None, :]  # (1, N)
        reqd = state.req[None, :, col] + pf["req"][:, col : col + 1]  # (C, N)
        f = torch.clamp(
            reqd.to(torch.float64) / torch.clamp(alloc, min=1).to(torch.float64), max=1.0
        )
        fracs.append(torch.where(alloc > 0, f, 0.0))
        present.append((alloc > 0).expand(c, n))
    zero = torch.zeros((c, n), dtype=torch.float64, device=dev)
    count = torch.zeros((c, n), dtype=torch.int64, device=dev)
    total = zero
    for f, p in zip(fracs, present):
        count = count + p.to(torch.int64)
        total = total + f
    mean = torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)
    # Exactly two resources → std = |f0 - f1| / 2 (balanced_allocation.go:155);
    # otherwise the root of the mean squared deviation.
    sq = zero
    ab = zero
    for f, p in zip(fracs, present):
        d = f - mean
        sq = sq + torch.where(p, d * d, 0.0)
        ab = ab + torch.where(p, d.abs(), 0.0)
    std_general = torch.sqrt(sq / torch.clamp(count, min=1))
    std_two = ab / 2.0
    std = torch.where(count == 2, std_two, torch.where(count > 2, std_general, 0.0))
    return ((1.0 - std) * MAX_NODE_SCORE).to(torch.int64)


def static_features(profile, schema, builder_res_col: dict[str, int]) -> dict:
    """Static (non-tensor) per-profile config the score fns need."""
    ignored = set(profile.fit_ignored_resources)
    groups = set(profile.fit_ignored_resource_groups)
    return {
        "fit_strategy_cols": strategy_columns(profile, builder_res_col),
        "balanced_cols": tuple(
            (builder_res_col[name],)
            for name, _ in profile.scoring_strategy.resources
            if name in builder_res_col
        ),
        # Only EXTENDED resources may be ignored (fit.go:488; built-ins are
        # always checked).  Groups match the "<group>/<name>" prefix.
        "fit_ignored_cols": tuple(
            sorted(
                col
                for name, col in builder_res_col.items()
                if name not in FIXED_RESOURCES
                and (
                    name in ignored
                    or ("/" in name and name.split("/", 1)[0] in groups)
                )
            )
        ),
    }


register(
    OpDef(
        name="NodeResourcesFit",
        featurize=featurize,
        filter=filter_fn,
        score=score_fn,
        static=static_features,
    )
)
register(
    OpDef(
        name="NodeResourcesBalancedAllocation",
        score=balanced_score_fn,
        static=static_features,
    )
)
