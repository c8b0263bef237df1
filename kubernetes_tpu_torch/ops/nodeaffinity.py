"""NodeAffinity: featurization and the plain PyTorch filter and score.

Counterpart of ``kubernetes_tpu/ops/nodeaffinity.py``.  Reference
(plugins/nodeaffinity/node_affinity.go):
  * Filter (:146): pod.Spec.NodeSelector (ANDed pairs) AND the required
    node affinity: an OR of terms, each an AND of matchExpressions and
    matchFields; operators In/NotIn/Exists/DoesNotExist/Gt/Lt; the only
    field is metadata.name.  A profile's addedAffinity is a second required
    selector ANDed with the pod's.
  * Score: the sum of the weights of matching preferred terms (the pod's
    and the profile's), then DefaultNormalizeScore (not reversed).

Featurization compiles the pod's selectors into requirement programs:
(T, Q) opcode and key-id tensors, (T, Q, V) value-id tensors and (T, Q)
integer operands, with strings turned into interned ids.  The functions
below evaluate them over a chunk of C pods against every node's label
slots (the plain versions); on the card the ``node_filters`` kernel
evaluates the filter once per batch and the ``late_scores`` entry of
``spread_eval`` the score.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from ..snapshot import INT_SENTINEL, _bucket
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register
from .helpers import default_normalize_score

# Requirement opcodes. Pad slots are OP_PAD and evaluate True (AND identity).
OP_PAD = -1
OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_NOT_EXISTS = 3
OP_GT = 4
OP_LT = 5
OP_NAME_IN = 6
OP_NAME_NOT_IN = 7
OP_FALSE = 8  # unsupported field/operator or unparseable Gt/Lt operand

_OPCODE = {
    t.OP_IN: OP_IN,
    t.OP_NOT_IN: OP_NOT_IN,
    t.OP_EXISTS: OP_EXISTS,
    t.OP_DOES_NOT_EXIST: OP_NOT_EXISTS,
    t.OP_GT: OP_GT,
    t.OP_LT: OP_LT,
}


def _const(shape, fill, dtype) -> np.ndarray:
    """A read-only array shared by every pod that needs it."""
    a = np.full(shape, fill, dtype)
    a.flags.writeable = False
    return a


_EMPTY_PROG: dict[str, dict] = {}
_EMPTY_SEL = _const(1, -1, np.int32)
# Name-pin fast path: the fixed parts of a single metadata.name In [v]
# program (only the value id differs per pod).
_NAME_PIN_OP = _const((1, 1), OP_NAME_IN, np.int32)
_NAME_PIN_KEY = _const((1, 1), -1, np.int32)
_NAME_PIN_INT = _const((1, 1), 0, np.int64)
_NAME_PIN_VALID = _const(1, 1, np.bool_)
_EMPTY_PREF = {
    "na_pref_op": _const((1, 1), OP_PAD, np.int32),
    "na_pref_key": _const((1, 1), -1, np.int32),
    "na_pref_vals": _const((1, 1, 1), -1, np.int32),
    "na_pref_int": _const((1, 1), 0, np.int64),
    "na_pref_weight": _const(1, 0, np.int64),
}


class _Program:
    """Mutable builder for a (T, Q, V) requirement program."""

    def __init__(self) -> None:
        self.terms: list[list[tuple[int, int, list[int], int]]] = []  # op, key, vals, int

    def add_term(self, term: t.NodeSelectorTerm, it) -> None:
        """Compile one NodeSelectorTerm; empty terms match nothing
        (nodeaffinity.go nodeSelectorTermsMatch skips them)."""
        reqs: list[tuple[int, int, list[int], int]] = []
        for r in term.match_expressions:
            op = _OPCODE.get(r.operator, None)
            if op is None:
                reqs.append((OP_FALSE, -1, [], 0))
                continue
            key_id = it.label_keys.id(r.key)
            if op in (OP_IN, OP_NOT_IN):
                reqs.append((op, key_id, [it.label_pairs.id((r.key, v)) for v in r.values], 0))
            elif op in (OP_GT, OP_LT):
                if len(r.values) != 1:
                    reqs.append((OP_FALSE, -1, [], 0))
                    continue
                try:
                    rhs = int(r.values[0])
                except ValueError:
                    reqs.append((OP_FALSE, -1, [], 0))
                    continue
                reqs.append((op, key_id, [], rhs))
            else:
                reqs.append((op, key_id, [], 0))
        for r in term.match_fields:
            # Only metadata.name is a valid field selector.
            if r.key != "metadata.name" or r.operator not in (t.OP_IN, t.OP_NOT_IN):
                reqs.append((OP_FALSE, -1, [], 0))
                continue
            op = OP_NAME_IN if r.operator == t.OP_IN else OP_NAME_NOT_IN
            # Unknown node names intern fine; they simply match no live row.
            reqs.append((op, -1, [it.node_names.id(v) for v in r.values], 0))
        if reqs:
            self.terms.append(reqs)

    def tensors(self, prefix: str, min_terms: int = 1) -> dict:
        """Pack into dense tensors, each dimension bucketed to a power of
        two, with at least ``min_terms`` term rows.  A term with zero
        requirements is all-OP_PAD and matches every node: add_term never
        makes one, the grouped volume programs use them as always-true
        entries (ops/volumes._GroupedProgram)."""
        if not self.terms and min_terms <= 1:
            # No affinity of this kind: shared all-pad tensors.
            cached = _EMPTY_PROG.get(prefix)
            if cached is None:
                cached = {
                    f"{prefix}_op": _const((1, 1), OP_PAD, np.int32),
                    f"{prefix}_key": _const((1, 1), -1, np.int32),
                    f"{prefix}_vals": _const((1, 1, 1), -1, np.int32),
                    f"{prefix}_int": _const((1, 1), 0, np.int64),
                    f"{prefix}_term_valid": _const(1, 0, np.bool_),
                }
                _EMPTY_PROG[prefix] = cached
            return dict(cached)
        tdim = _bucket(max(len(self.terms), min_terms, 1), 1)
        qdim = _bucket(max((len(te) for te in self.terms), default=1) or 1, 1)
        vdim = _bucket(max((len(v) for te in self.terms for _, _, v, _ in te), default=1) or 1, 1)
        ops = np.full((tdim, qdim), OP_PAD, np.int32)
        keys = np.full((tdim, qdim), -1, np.int32)
        vals = np.full((tdim, qdim, vdim), -1, np.int32)
        ints = np.zeros((tdim, qdim), np.int64)
        valid = np.zeros(tdim, np.bool_)
        for ti, te in enumerate(self.terms):
            valid[ti] = True
            for qi, (op, key, vlist, rhs) in enumerate(te):
                ops[ti, qi] = op
                keys[ti, qi] = key
                vals[ti, qi, : len(vlist)] = vlist
                ints[ti, qi] = rhs
        return {
            f"{prefix}_op": ops,
            f"{prefix}_key": keys,
            f"{prefix}_vals": vals,
            f"{prefix}_int": ints,
            f"{prefix}_term_valid": valid,
        }


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    it = fctx.interns
    # spec.nodeSelector map: every (k, v) pair must be present on the node.
    if pod.spec.node_selector:
        sel_pairs = [it.label_pairs.id((k, v)) for k, v in sorted(pod.spec.node_selector.items())]
        sel = np.full(_bucket(len(sel_pairs), 1), -1, np.int32)
        sel[: len(sel_pairs)] = sel_pairs
    else:
        sel = _EMPTY_SEL
    aff = pod.spec.affinity
    na = aff.node_affinity if aff else None
    # Name-pin fast path (the daemonset shape): a required affinity of one
    # metadata.name In [one value] term compiles to fixed-shape tensors with
    # only the interned name id filled in.  (Imported here: engine.features
    # imports the ops package.)
    from ..engine.features import pin_name

    pinned_name = pin_name(pod)
    if (
        pinned_name is not None
        and (fctx.profile is None or fctx.profile.added_affinity is None)
        and not na.preferred
    ):
        vals = np.empty((1, 1, 1), np.int32)
        vals[0, 0, 0] = it.node_names.id(pinned_name)
        feats = {
            "na_sel_pairs": sel, "na_has_required": np.bool_(True),
            "na_req_op": _NAME_PIN_OP, "na_req_key": _NAME_PIN_KEY, "na_req_vals": vals,
            "na_req_int": _NAME_PIN_INT, "na_req_term_valid": _NAME_PIN_VALID,
        }
        feats.update(_EMPTY_PREF)
        return feats
    req_prog = _Program()
    has_required = False
    if na and na.required is not None:
        has_required = True
        for term in na.required.terms:
            req_prog.add_term(term, it)
    pref_prog = _Program()
    weights: list[int] = []
    if na:
        for p in na.preferred:
            before = len(pref_prog.terms)
            pref_prog.add_term(p.preference, it)
            if len(pref_prog.terms) > before:
                weights.append(p.weight)
    # NodeAffinityArgs.AddedAffinity (node_affinity.go:117): a SEPARATE
    # required selector ANDed with the pod's; its preferred terms join the
    # pod's in Score.  Profiles without it emit no na_add features.
    added = fctx.profile.added_affinity if fctx.profile else None
    feats = {"na_sel_pairs": sel, "na_has_required": np.bool_(has_required)}
    feats.update(req_prog.tensors("na_req"))
    if added is not None:
        add_prog = _Program()
        has_added = False
        if added.required is not None and added.required.terms:
            has_added = True
            for term in added.required.terms:
                add_prog.add_term(term, it)
        for p in added.preferred:
            before = len(pref_prog.terms)
            pref_prog.add_term(p.preference, it)
            if len(pref_prog.terms) > before:
                weights.append(p.weight)
        feats["na_has_added"] = np.bool_(has_added)
        feats.update(add_prog.tensors("na_add"))
    pref = pref_prog.tensors("na_pref")
    w = np.zeros(pref["na_pref_term_valid"].shape[0], np.int64)
    w[: len(weights)] = weights
    pref["na_pref_weight"] = w
    del pref["na_pref_term_valid"]  # weight 0 already neutralizes pad terms
    feats.update(pref)
    return feats


def _node_axes(state, own: bool):
    """The label key, pair and integer slots and the name ids, shaped
    against a (C, T, Q) requirement axis: every node, (1, 1, 1, N, LS) and
    (1, 1, 1, N); or, ``own``, each pod's own row of a gathered view whose
    node c is pod c's, (C, 1, 1, 1, LS) and (C, 1, 1, 1)."""
    fields = (state.label_key_ids, state.label_pair_ids, state.label_int_vals, state.name_id)
    if own:
        return tuple(f[:, None, None, None] for f in fields)
    return tuple(f[None, None, None] for f in fields)


def eval_terms(state, ops, keys, vals, ints, own: bool = False) -> torch.Tensor:
    """Evaluate a chunk's requirement programs on every node (nodeaffinity.py:162):
    ops/keys/ints (C, T, Q), vals (C, T, Q, V) → (C, T, N) term matches; with
    ``own``, pod c on node c of a gathered view only → (C, T, 1)."""
    lk, lp, li, name = _node_axes(state, own)
    keymatch = lk == keys[..., None, None]  # (C, T, Q, N, LS)
    has_key = keymatch.any(-1)  # (C, T, Q, N)
    vmask = vals >= 0
    pair_any = torch.zeros(has_key.shape, dtype=torch.bool, device=lk.device)
    name_any = torch.zeros(has_key.shape, dtype=torch.bool, device=lk.device)
    for v in range(vals.shape[-1]):  # over V, so no (C, T, Q, V, N, LS) tensor
        want = vals[..., v]
        hit = (lp == want[..., None, None]).any(-1)
        pair_any |= hit & vmask[..., v, None]
        name_any |= (name == want[..., None]) & vmask[..., v, None]
    # Per-slot integer label value; one slot holds a given key, so a masked
    # sum extracts it (INT_SENTINEL marks non-integer values).
    label_int = torch.where(keymatch, li, 0).sum(-1)
    int_ok = has_key & (label_int != int(INT_SENTINEL))
    op = ops[..., None]
    result = torch.ones(has_key.shape, dtype=torch.bool, device=lk.device)
    result &= torch.where(op == OP_IN, pair_any, True)
    result &= torch.where(op == OP_NOT_IN, ~pair_any, True)
    result &= torch.where(op == OP_EXISTS, has_key, True)
    result &= torch.where(op == OP_NOT_EXISTS, ~has_key, True)
    result &= torch.where(op == OP_GT, int_ok & (label_int > ints[..., None]), True)
    result &= torch.where(op == OP_LT, int_ok & (label_int < ints[..., None]), True)
    result &= torch.where(op == OP_NAME_IN, name_any, True)
    result &= torch.where(op == OP_NAME_NOT_IN, ~name_any, True)
    result &= op != OP_FALSE
    return result.all(dim=2)  # AND over Q → (C, T, N)


def _any_term(state, pf, prefix: str, own: bool = False) -> torch.Tensor:
    match = eval_terms(state, pf[f"{prefix}_op"], pf[f"{prefix}_key"], pf[f"{prefix}_vals"],
                       pf[f"{prefix}_int"], own)
    return (match & pf[f"{prefix}_term_valid"][:, :, None]).any(dim=1)  # (C, N)


def filter_fn(state, pf, ctx: PassContext, own: bool = False):
    """(C, N) bool: nodeSelector, required affinity and the profile's added
    affinity (nodeaffinity.py:285); with ``own``, (C, 1): pod c on node c
    of a gathered view (the pinned pass's own-row evaluation)."""
    lp = state.label_pair_ids  # (N, LS)
    lp = lp[:, None, None] if own else lp[None, None]
    sel = pf["na_sel_pairs"]  # (C, S)
    sel_hit = (lp == sel[:, :, None, None]).any(-1)  # (C, S, N)
    ok = (sel_hit | (sel < 0)[:, :, None]).all(dim=1)
    ok &= torch.where(pf["na_has_required"][:, None], _any_term(state, pf, "na_req", own), True)
    if ctx.profile.added_affinity is not None:
        ok &= torch.where(pf["na_has_added"][:, None], _any_term(state, pf, "na_add", own), True)
    return ok


def raw_score(state, pf) -> torch.Tensor:
    """(C, N) i64: the summed weights of the matching preferred terms."""
    match = eval_terms(state, pf["na_pref_op"], pf["na_pref_key"], pf["na_pref_vals"],
                       pf["na_pref_int"])
    return (match.to(torch.int64) * pf["na_pref_weight"][:, :, None]).sum(dim=1)


def score_fn(state, pf, ctx: PassContext, feasible):
    return default_normalize_score(raw_score(state, pf), feasible, reverse=False)


for _k, _fill in [
    ("na_sel_pairs", -1),
    ("na_req_op", OP_PAD),
    ("na_req_key", -1),
    ("na_req_vals", -1),
    ("na_req_int", 0),
    ("na_req_term_valid", 0),
    ("na_pref_op", OP_PAD),
    ("na_pref_key", -1),
    ("na_pref_vals", -1),
    ("na_pref_int", 0),
    ("na_pref_weight", 0),
    ("na_add_op", OP_PAD),
    ("na_add_key", -1),
    ("na_add_vals", -1),
    ("na_add_int", 0),
    ("na_add_term_valid", 0),
]:
    feature_fill(_k, _fill)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    # No nodeSelector and no node affinity: the filter passes everywhere and
    # the score is uniformly zero.  A profile's addedAffinity applies to
    # every pod of the profile.
    if fctx.profile is not None and fctx.profile.added_affinity is not None:
        return True
    aff = pod.spec.affinity
    return bool(pod.spec.node_selector) or bool(aff and aff.node_affinity)


register(
    OpDef(
        name="NodeAffinity",
        featurize=featurize,
        filter=filter_fn,
        score=score_fn,
        is_active=is_active,
    )
)
