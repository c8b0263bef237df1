"""Volume plugins: featurization and the plain PyTorch filters of
VolumeBinding, VolumeZone, VolumeRestrictions and NodeVolumeLimits.

Counterpart of ``kubernetes_tpu/ops/volumes.py``.  Reference semantics:
  * VolumeBinding (plugins/volumebinding/volume_binding.go): bound claims
    restrict the pod to nodes matching each PV's node affinity; unbound
    claims with a WaitForFirstConsumer class need, per claim, a matching
    static PV whose affinity fits the node, or a provisioner whose
    StorageClass allowedTopologies fit; unbound Immediate claims are
    UnschedulableAndUnresolvable.  The binding itself (PreBind) happens on
    the host after the pick (volumes.VolumeCatalog.bind_pod_volumes).
  * VolumeZone (plugins/volumezone/volume_zone.go): each bound PV's
    zone/region labels (``__``-separated value sets) must match the node.
  * VolumeRestrictions (plugins/volumerestrictions/volume_restrictions.go):
    an in-tree device volume conflicts with an existing use on the node
    unless both sides are read-only; a ReadWriteOncePod claim already used
    by another pod is Unschedulable everywhere.
  * NodeVolumeLimits (plugins/nodevolumelimits/csi.go): per CSI driver,
    attached volumes plus the pod's new volumes must stay within the
    CSINode allocatable count.

PV affinities and zone labels compile into NodeAffinity's requirement
programs with one more axis: each claim (or bound PV) is an OR-group of
terms and the node must satisfy every group.  On the card, VolumeBinding's
and VolumeZone's filters are bits 2 and 3 of the per-batch ``node_filters``
kernel (node labels do not change inside a pass), and VolumeRestrictions'
and NodeVolumeLimits' filters the per-chunk ``vol_filter`` kernel (they
read counts that commits change); ``eval_chunk`` reads both as planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from ..volumes import NO_PROVISIONER
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register
from .nodeaffinity import _Program, eval_terms

VB, VZ, VR, NVL = "VolumeBinding", "VolumeZone", "VolumeRestrictions", "NodeVolumeLimits"


class _GroupedProgram(_Program):
    """Requirement program whose terms belong to AND-ed OR-groups
    (ops/volumes.py:42)."""

    def __init__(self) -> None:
        super().__init__()
        self.groups: list[int] = []  # group id per term
        self.n_groups = 0

    def start_group(self) -> int:
        gid = self.n_groups
        self.n_groups += 1
        return gid

    def add_group_term(self, gid: int, term: t.NodeSelectorTerm, it) -> None:
        before = len(self.terms)
        self.add_term(term, it)
        if len(self.terms) > before:
            self.groups.append(gid)

    def add_group_true(self, gid: int) -> None:
        """A term that matches every node (a PV without node affinity)."""
        self.terms.append([])
        self.groups.append(gid)

    def tensors(self, prefix: str) -> dict:
        # The term axis covers every group id, so the group reduction sees
        # term-less (unsatisfiable) groups too.
        out = super().tensors(prefix, min_terms=self.n_groups)
        gdim = out[f"{prefix}_op"].shape[0]
        groups = np.full(gdim, -1, np.int32)
        groups[: len(self.groups)] = self.groups
        out[f"{prefix}_group"] = groups
        out[f"{prefix}_ngroups"] = np.int32(self.n_groups)
        return out


def eval_grouped(state, pf, prefix: str, own: bool = False) -> torch.Tensor:
    """(C, N) bool: every group of each pod's program has ≥1 valid matching
    term (ops/volumes.py:78 _eval_grouped); a group with no terms fails.
    With ``own``, (C, 1): pod c on node c of a gathered view."""
    match = eval_terms(state, pf[f"{prefix}_op"], pf[f"{prefix}_key"], pf[f"{prefix}_vals"],
                       pf[f"{prefix}_int"], own)  # (C, T, N)
    match &= pf[f"{prefix}_term_valid"][:, :, None]
    groups = pf[f"{prefix}_group"]  # (C, T), -1 pads
    n_groups = pf[f"{prefix}_ngroups"]  # (C,)
    ok = torch.ones(match.shape[0], match.shape[2], dtype=torch.bool, device=match.device)
    for g in range(groups.shape[1]):
        hit = (match & (groups == g)[:, :, None]).any(dim=1)
        ok &= hit | (n_groups <= g)[:, None]
    return ok


# --------------------------------------------------------------------------
# VolumeBinding
# --------------------------------------------------------------------------


def _vb_featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    cat = fctx.builder.volumes
    it = fctx.interns
    prog = _GroupedProgram()
    feasible = True
    for pvc in cat.pod_pvcs(pod):
        if pvc is None:
            feasible = False
            break
        kind, *rest = cat.classify(pvc)
        if kind in ("lost", "unbound_immediate"):
            feasible = False
            break
        gid = prog.start_group()
        if kind == "bound":
            pv = rest[0]
            if pv.node_affinity is None or not pv.node_affinity.terms:
                prog.add_group_true(gid)
            else:
                for term in pv.node_affinity.terms:
                    prog.add_group_term(gid, term, it)
            continue
        candidates, sc = rest  # delayed
        for pv in candidates:
            if pv.node_affinity is None or not pv.node_affinity.terms:
                prog.add_group_true(gid)
            else:
                for term in pv.node_affinity.terms:
                    prog.add_group_term(gid, term, it)
        if sc.provisioner != NO_PROVISIONER:
            if sc.allowed_topologies is None or not sc.allowed_topologies.terms:
                prog.add_group_true(gid)
            else:
                for term in sc.allowed_topologies.terms:
                    prog.add_group_term(gid, term, it)
        # No candidates and no provisioner: an empty group, infeasible
        # everywhere (nothing can satisfy the claim yet).
    feats = prog.tensors("vb")
    feats["vb_feasible"] = np.bool_(feasible)
    return feats


def vb_filter(state, pf, ctx: PassContext, own: bool = False) -> torch.Tensor:
    return pf["vb_feasible"][:, None] & eval_grouped(state, pf, "vb", own)


def _pvc_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.pvc for v in pod.spec.volumes)


# --------------------------------------------------------------------------
# VolumeZone
# --------------------------------------------------------------------------


def _vz_featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    cat = fctx.builder.volumes
    it = fctx.interns
    prog = _GroupedProgram()
    feasible = True
    for pvc in cat.pod_pvcs(pod):
        if pvc is None:
            feasible = False
            break
        kind, *rest = cat.classify(pvc)
        if kind in ("lost", "unbound_immediate"):
            feasible = False
            break
        if kind != "bound":
            continue  # delayed claims are VolumeBinding's business
        reqs = cat.zone_requirements(rest[0])
        if reqs:
            gid = prog.start_group()
            prog.add_group_term(gid, t.NodeSelectorTerm(match_expressions=tuple(reqs)), it)
    feats = prog.tensors("vz")
    feats["vz_feasible"] = np.bool_(feasible)
    return feats


def vz_filter(state, pf, ctx: PassContext, own: bool = False) -> torch.Tensor:
    return pf["vz_feasible"][:, None] & eval_grouped(state, pf, "vz", own)


# --------------------------------------------------------------------------
# VolumeRestrictions
# --------------------------------------------------------------------------


def _vr_featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    cat = fctx.builder.volumes
    # ReadWriteOncePod: any other pod already using the claim blocks
    # scheduling everywhere (volume_restrictions.go isRWOPConflict).
    rwop_ok = True
    for pvc in cat.pod_pvcs(pod):
        if pvc is not None and t.RWOP in pvc.access_modes and cat.pvc_users.get(pvc.uid, 0) > 0:
            rwop_ok = False
            break
    return {"vr_rwop_ok": np.bool_(rwop_ok)}


def vr_filter(state, pf, ctx: PassContext) -> torch.Tensor:
    """(C, N): no device-volume use conflicts (a read-only use conflicts
    only with a writer), and the ReadWriteOncePod check (ops/volumes.py:217).
    A batch without ``vol_dev_ids`` has no device volumes."""
    rwop = pf["vr_rwop_ok"][:, None]
    ids = pf.get("vol_dev_ids")
    n = state.valid.shape[0]
    if ids is None:
        return rwop.expand(-1, n).clone()
    active = ids >= 0  # (C, S)
    safe = ids.clamp(min=0).to(torch.int64)
    uses = state.dev_counts[safe]  # (C, S, N): rows gathered, never the whole table
    rw_uses = state.dev_rw_counts[safe]
    ro = ~pf["vol_dev_rw"]
    conflict = torch.where(ro[:, :, None], rw_uses > 0, uses > 0) & active[:, :, None]
    return rwop & ~conflict.any(dim=1)


def _vr_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.device_id or v.pvc for v in pod.spec.volumes)


# --------------------------------------------------------------------------
# NodeVolumeLimits
# --------------------------------------------------------------------------


def nvl_filter(state, pf, ctx: PassContext) -> torch.Tensor:
    """(C, N): the attach limit by DISTINCT volume (csi.go:219; ops/volumes.py:238):
    the pod's volumes already attached to the node (csivol_counts > 0) do
    not count again; per driver, used + new ≤ limit wherever new > 0.  A
    batch without ``vol_csi_ids`` attaches nothing."""
    n = state.valid.shape[0]
    ids = pf.get("vol_csi_ids")
    if ids is None:
        return torch.ones((pf["valid"].shape[0], n), dtype=torch.bool, device=state.valid.device)
    act = ids >= 0  # (C, S)
    present = state.csivol_counts[ids.clamp(min=0).to(torch.int64)] > 0  # (C, S, N)
    newv = act[:, :, None] & ~present
    drv = pf["vol_csi_drv"]
    ok = torch.ones((ids.shape[0], n), dtype=torch.bool, device=ids.device)
    for d in range(state.csi_used.shape[0]):
        new_cnt = (newv & (drv == d)[:, :, None]).sum(dim=1)  # (C, N) i64
        fits = state.csi_used[d].to(torch.int64) + new_cnt <= state.csi_limit[d].to(torch.int64)
        ok &= fits | (new_cnt == 0)
    return ok


def _nvl_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return any(v.pvc for v in pod.spec.volumes) and len(fctx.interns.drivers) > 0


for _k, _fill in [
    ("vb_op", -1), ("vb_key", -1), ("vb_vals", -1), ("vb_int", 0),
    ("vb_term_valid", 0), ("vb_group", -1), ("vb_ngroups", 0), ("vb_feasible", 1),
    ("vz_op", -1), ("vz_key", -1), ("vz_vals", -1), ("vz_int", 0),
    ("vz_term_valid", 0), ("vz_group", -1), ("vz_ngroups", 0), ("vz_feasible", 1),
    ("vr_rwop_ok", 1),
]:
    feature_fill(_k, _fill)

# VolumeBinding and VolumeZone are release-independent: preemption applies
# their filters on the live state (node_filters bits 2 and 3), so neither
# needs a hard filter (preemption.py:244-249).
register(OpDef(name=VB, featurize=_vb_featurize, filter=vb_filter, is_active=_pvc_active))
register(OpDef(name=VZ, featurize=_vz_featurize, filter=vz_filter, is_active=_pvc_active))
register(OpDef(name=VR, featurize=_vr_featurize, filter=vr_filter, is_active=_vr_active))
register(OpDef(name=NVL, filter=nvl_filter, is_active=_nvl_active))
