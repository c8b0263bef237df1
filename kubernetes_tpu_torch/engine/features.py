"""Pod-batch featurization: list[Pod] → padded feature arrays.

Counterpart of ``kubernetes_tpu/engine/features.py``: everything about a pod
that the device pass needs is computed once per pod here (resource vectors,
interned ids) and shipped as one (K, …) batch.  Padding rows carry
valid=False and are ignored by the commit.

The port featurizes only the ported ops.  An unported op that is
active for any pod of the batch raises NotImplementedError, and so does a
pod whose commit would touch state the port's commit does not write yet
(host ports): such a pod must fail loudly, never be scheduled as if its
constraints were absent.

The volume base features (engine/features.py:23-28, 347-377 of the JAX
package: device uses, CSI attachments, the PreBind-race and attach-limit
flags) are what the commit, the chunk-mate conflict table and the
VolumeRestrictions/NodeVolumeLimits filters read.  They are built from the
pods' deltas after the loop, and a batch carries a group of them only when
some pod fills it (``_vol_features``): a batch without volumes pays nothing,
and an absent key is all padding, which every reader treats as contributing
nothing, exactly as the JAX pass does with padding.
"""

from __future__ import annotations

import numpy as np

from ..api import types as t
from ..framework.config import Profile
from ..ops import common as opcommon
from ..snapshot import SnapshotBuilder, _bucket

# The pod's own (anti-)affinity term ids, committed into et_counts; -1 pads.
opcommon.feature_fill("ipa_own_terms", -1)
# Injected by the scheduler after featurization (nomination is pod status).
opcommon.feature_fill("nominated_row", -1)
opcommon.feature_fill("vol_dev_ids", -1)
opcommon.feature_fill("vol_dev_rw", 0)
opcommon.feature_fill("vol_csi_ids", -1)
opcommon.feature_fill("vol_csi_drv", -1)
opcommon.feature_fill("vol_unbound", 0)
opcommon.feature_fill("vol_csi_lim", 0)



def _vol_features(deltas: list[dict], k: int) -> dict:
    """The volume base features of a batch of ``k`` lanes from its pods'
    deltas: (ids, second) rows of the device uses and of the CSI
    attachments, -1 pads, ``_bucket`` wide, and the PreBind-race and
    attach-limit flags.  A group no pod fills is left out; padding lanes
    are zeros, gated by ``valid``."""
    out = {}
    for name, ids_key, second_key, dtype, fill in (
        ("devices", "vol_dev_ids", "vol_dev_rw", np.bool_, 0),
        ("csivols", "vol_csi_ids", "vol_csi_drv", np.int32, -1),
    ):
        width = max((len(d[name]) for d in deltas), default=0)
        if not width:
            continue
        ids = np.zeros((k, _bucket(width, 1)), np.int32)
        second = np.zeros(ids.shape, dtype)
        ids[: len(deltas)] = -1
        second[: len(deltas)] = fill
        for i, d in enumerate(deltas):
            for j, (a, b) in enumerate(d[name]):
                ids[i, j] = a
                second[i, j] = b
        out[ids_key], out[second_key] = ids, second
    # Chunk conflict classes (pass_.py _conflict_pairs): only PreBind-racing
    # claims conflict any-vs-any; bound claims conflict only on shared
    # volume or device ids.
    for key in ("vol_unbound", "vol_csi_lim"):
        if any(d[key] for d in deltas):
            flags = np.zeros(k, np.bool_)
            flags[: len(deltas)] = [d[key] for d in deltas]
            out[key] = flags
    return out


def pin_name(pod: t.Pod):
    """The single node a pod's own constraints reduce its candidate set to,
    or None: a required node affinity of exactly one term with one
    metadata.name In [one value] matchFields (nodeaffinity.go PreFilter's
    PreFilterResult.NodeNames)."""
    aff = pod.spec.affinity
    na = aff.node_affinity if aff else None
    if na is not None and na.required is not None and len(na.required.terms) == 1:
        term = na.required.terms[0]
        if not term.match_expressions and len(term.match_fields) == 1:
            mf = term.match_fields[0]
            if (
                mf.key == "metadata.name"
                and mf.operator == t.OP_IN
                and len(mf.values) == 1
            ):
                return mf.values[0]
    return None


def pod_sig(pod: t.Pod):
    """The featurization cache key of a pod: (namespace, labels, spec).
    Workload pods are stamped from templates, so thousands of pods collapse
    onto a handful of keys.  Names and uids are excluded (featurization
    never reads them); equal keys imply equal features."""
    return repr((pod.namespace, sorted(pod.metadata.labels.items()), pod.spec))


def _check_ported(ops, reps, fctx, deltas) -> None:
    for op in ops:
        if op.unported and any(op.is_active(p, fctx) for p in reps):
            raise NotImplementedError(f"{op.name} is not yet ported")
    for d in deltas:
        if d["ports"]:
            raise NotImplementedError("host-port commits (NodePorts) are not yet ported")


def build_pod_batch(
    pods: list[t.Pod],
    builder: SnapshotBuilder,
    profile: Profile,
    k: int,
    force_active: frozenset[str] | None = None,
) -> tuple[dict, list[dict], frozenset[str]]:
    """Featurize up to ``k`` pods into a dict of (k, …) numpy arrays, plus the
    per-pod commit deltas (reused by the cache's assume step) and the
    batch's ACTIVE op set — ops whose ``is_active`` predicate is False for
    every pod are left out of the batch's pass (the batch analog of
    PreFilter Skip).  ``force_active`` rebuilds features for a pass already
    built for that op set (the strict tail)."""
    if len(pods) > k:
        raise ValueError(f"{len(pods)} pods exceed batch size {k}")
    if not pods:
        raise ValueError("empty pod batch")
    fctx = opcommon.FeaturizeContext(builder=builder, profile=profile)
    all_ops = [opcommon.get(name) for name in dict.fromkeys(
        list(profile.filters) + [s for s, _ in profile.scorers]
    )]
    # Name-pinned pods (the daemonset shape) differ only in the pinned node
    # name; they are featurized one by one instead of through the cache.
    keys = [None if pin_name(p) is not None else pod_sig(p) for p in pods]
    # is_active reads only (labels, spec) and builder vocabularies, so one
    # representative per distinct key suffices.
    reps = list({key: p for key, p in zip(keys, pods) if key is not None}.values())
    reps += [p for key, p in zip(keys, pods) if key is None]
    if force_active is not None:
        ops = [op for op in all_ops if op.name in force_active]
    else:
        ops = [
            op
            for op in all_ops
            if op.is_active is None or any(op.is_active(p, fctx) for p in reps)
        ]
    _check_ported(ops, reps, fctx, ())
    active = frozenset(op.name for op in ops)
    fctx.active = active
    # Featurization cache: identical (namespace, labels, spec) pods produce
    # identical features and deltas while nothing featurization reads has
    # changed (the version token).  An entry whose own featurization grew a
    # vocabulary is not cached.
    version = (builder.feature_version(), profile, active)
    if builder.feat_cache is None or builder.feat_cache[0] != version:
        builder.feat_cache = (version, {})
    store = builder.feat_cache[1]
    per_pod: list[dict] = []
    deltas: list[dict] = []
    for pod, key in zip(pods, keys):
        hit = store.get(key) if key is not None else None
        if hit is not None:
            per_pod.append(dict(hit[0]))
            deltas.append(dict(hit[1]))
            continue
        delta = builder.pod_delta_vectors(pod)
        _check_ported((), (), fctx, (delta,))
        own = delta["own_terms"]
        own_terms = np.full(_bucket(max(len(own), 1), 1), -1, np.int32)
        own_terms[: len(own)] = own
        feats = {
            "ipa_own_terms": own_terms,
            "req": delta["req"],
            "nonzero": delta["nonzero"],
            "group": np.int32(delta["group"]),
            "priority": np.int32(pod.spec.priority),
        }
        for op in ops:
            if op.featurize is not None:
                feats.update(op.featurize(pod, fctx))
        per_pod.append(feats)
        deltas.append(delta)
        v2 = (builder.feature_version(), profile, active)
        if v2 != version:  # this pod grew a vocabulary — new cache generation
            version = v2
            store = {}
            builder.feat_cache = (version, store)
        elif key is not None:
            if len(store) > 8192:
                store.clear()
            store[key] = (dict(feats), dict(delta))

    # Stack + pad.  Schema growth during featurization means early pods may
    # have shorter arrays than late ones: pad each key to its max shape.
    batch = {}
    for key in per_pod[-1]:
        rows = [np.asarray(f[key]) for f in per_pod]
        shapes = {a.shape for a in rows}
        if len(shapes) > 1:
            target = tuple(max(dims) for dims in zip(*shapes))
            fill = opcommon.FEATURE_FILLS.get(key, 0)
            rows = [
                np.pad(a, [(0, tg - cur) for cur, tg in zip(a.shape, target)], constant_values=fill)
                for a in rows
            ]
        stacked = np.stack(rows)
        pad_width = [(0, k - len(pods))] + [(0, 0)] * (stacked.ndim - 1)
        batch[key] = np.pad(stacked, pad_width)
    batch.update(_vol_features(deltas, k))
    batch["valid"] = np.zeros(k, np.bool_)
    batch["valid"][: len(pods)] = True
    return batch, deltas, active
