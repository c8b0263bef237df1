"""DynamicResources with structured parameters, over selector pools.

Counterpart of ``kubernetes_tpu/ops/dynamicresources.py``.  Reference
(plugins/dynamicresources/, staging dynamic-resource-allocation/structured/
allocator.go):

  * A pod referencing a missing claim is UnschedulableAndUnresolvable until
    the claim appears.
  * An allocated claim pins the pod to the claim's node.
  * Unallocated claims demand free devices per request from the request's
    selector pool, a (device class, canonical CEL selector) column (dra.py
    pool_sig), and from the bare class pool: dra_alloc + need ≤ dra_cap per
    pool.  One feature slot per (request × charged pool), slots of a claim
    sharing its id (the builder's pod delta, engine/features.py).

The claim slots are base features of the batch (``dra_claim_*``, absent
when no pod of the batch has a resolved claim); this op adds the pins and
the missing-claim flag.  The filter below is the plain version over a
chunk of C pods; on the card it runs inside the ``eval_chunk`` kernel
(filter code 5), and the hard filter, with the release of a dry-run's
victims, inside ``preempt_eval`` and ``search_step``.  Exact named-device
allocation happens on the host at Reserve (dra.ClaimCatalog.
allocate_pod_claims, framework/hostplugins.py DRAReserve).
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register

PIN_SLOTS = 4  # allocated claims per pod; more is rejected at featurize time


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    pins_of = []
    missing = False
    for claim in fctx.builder.dra.pod_claims(pod):
        if claim is None:
            missing = True
        elif claim.allocated_node:
            pins_of.append(fctx.interns.node_names.id(claim.allocated_node))
    if len(pins_of) > PIN_SLOTS:
        raise ValueError(f"pod {pod.uid}: >{PIN_SLOTS} allocated claims")
    pins = np.full(PIN_SLOTS, -1, np.int32)
    pins[: len(pins_of)] = pins_of
    return {"dra_pin_ids": pins, "dra_missing": np.bool_(missing)}


def pins_ok(state, pf) -> torch.Tensor:
    """(C, N) bool: every allocated claim of the pod is on the node."""
    pins = pf["dra_pin_ids"]  # (C, PIN_SLOTS), -1 pad
    same = state.name_id[None, None, :] == pins[:, :, None]
    return ((pins < 0)[:, :, None] | same).all(dim=1)


def claim_demand(state, pf):
    """(present (C, S, N) bool, demand (C, S, DC) i64): whether each claim
    slot's claim is already reserved on the node, and each slot's device
    count one-hot on its pool (zero for padding slots)."""
    kids = pf["dra_claim_ids"].to(torch.int64)  # (C, S), -1 pad
    act = kids >= 0
    present = state.dra_claim_counts[kids.clamp(min=0)] > 0  # (C, S, N)
    dc = state.dra_cap.shape[0]
    pools = torch.arange(dc, device=kids.device)
    cls_oh = (pf["dra_claim_cls"][:, :, None] == pools[None, None, :]) & act[:, :, None]
    return present, cls_oh.to(torch.int64) * pf["dra_claim_cnt"].to(torch.int64)[:, :, None]


def filter_fn(state, pf, ctx: PassContext):
    """(C, N) bool.  The demand per pool is the devices of the claims not
    already reserved on the node (distinct-claim accounting, like CSI
    attach limits: a claim someone on the node reserves is a free ride)."""
    ok = ~pf["dra_missing"][:, None] & pins_ok(state, pf)
    if "dra_claim_ids" not in pf:
        return ok
    present, demand = claim_demand(state, pf)
    need = (demand[:, :, :, None] * (~present)[:, :, None, :]).sum(dim=1)  # (C, DC, N)
    fits = ((need == 0) | (state.dra_alloc[None].to(torch.int64) + need <= state.dra_cap[None])).all(dim=1)
    return ok & fits


def hard_filter_fn(state, pf, ctx: PassContext):
    """(C, N) bool rejections preemption cannot resolve: a missing claim or
    an allocation pin elsewhere (deleting pods moves no allocation); a
    device shortage can be resolved."""
    return pf["dra_missing"][:, None] | ~pins_ok(state, pf)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    return bool(pod.spec.resource_claims)


feature_fill("dra_pin_ids", -1)
feature_fill("dra_missing", 0)
register(OpDef(name="DynamicResources", featurize=featurize, filter=filter_fn, hard_filter=hard_filter_fn,
               is_active=is_active))
