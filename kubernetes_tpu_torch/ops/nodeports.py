"""NodePorts: host-port conflicts against the node's port counts.

Counterpart of ``kubernetes_tpu/ops/nodeports.py``.  Reference
(plugins/nodeports/node_ports.go): a pod with hostPort requests is
infeasible on a node where any wanted (hostIP, protocol, hostPort)
conflicts with a port already in use (HostPortInfo.CheckConflict,
framework/types.go): a wildcard-IP want conflicts with any use of the same
(protocol, port); a specific-IP want conflicts with the same triple or with
a wildcard-IP use of its (protocol, port).

The snapshot keeps per-node usage counts keyed by interned port ids:
``port_counts`` rows for exact (proto, ip, port) triples and
``portkey_counts`` rows for (proto, *, port) keys.  The pod's own triples
and keys are base features of the batch (``port_triples``/``port_keys``,
engine/features.py, also the commit's deltas); this op adds the wildcard
triple of each want for the specific-IP rule.  The filter below is the
plain version over a chunk of C pods; on the card it runs inside the
``eval_chunk`` kernel (filter code 4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import types as t
from ..snapshot import POD_PORT_SLOTS
from .common import FeaturizeContext, OpDef, PassContext, feature_fill, register


def featurize(pod: t.Pod, fctx: FeaturizeContext) -> dict:
    # The ids were interned by the builder's pod_delta_vectors for this pod.
    wild_triples = np.full(POD_PORT_SLOTS, -1, np.int32)
    is_wild = np.zeros(POD_PORT_SLOTS, np.bool_)
    ports = fctx.interns.ports
    for j, (proto, ip, port) in enumerate(pod.host_ports()[:POD_PORT_SLOTS]):
        wild_triples[j] = ports.id((proto, "0.0.0.0", port))
        is_wild[j] = ip == "0.0.0.0"
    return {"port_wild_triples": wild_triples, "port_is_wild": is_wild}


def filter_fn(state, pf, ctx: PassContext):
    """(C, N) bool.  A chunk without ``port_triples`` (no pod of its batch
    asks for a host port) conflicts nowhere."""
    if "port_triples" not in pf:
        c, n = pf["port_wild_triples"].shape[0], state.valid.shape[0]
        return torch.ones((c, n), dtype=torch.bool, device=state.valid.device)
    triples = pf["port_triples"].to(torch.int64)  # (C, S), -1 pad
    keys = pf["port_keys"].to(torch.int64)
    wilds = pf["port_wild_triples"].to(torch.int64)
    is_wild = pf["port_is_wild"]
    active = triples >= 0
    # (C, S, N) usage counts of each wanted port.
    exact = state.port_counts[triples.clamp(min=0)]
    wild_use = state.port_counts[wilds.clamp(min=0)]
    any_ip = state.portkey_counts[keys.clamp(min=0)]
    conflict = torch.where(is_wild[:, :, None], any_ip > 0, (exact > 0) | (wild_use > 0))
    return ~(conflict & active[:, :, None]).any(dim=1)


def is_active(pod: t.Pod, fctx: FeaturizeContext) -> bool:
    # A pod without hostPort requests conflicts with nothing (PreFilter
    # returns Skip, node_ports.go:97).
    return bool(pod.host_ports())


feature_fill("port_wild_triples", -1)
feature_fill("port_triples", -1)
feature_fill("port_keys", -1)
register(OpDef(name="NodePorts", featurize=featurize, filter=filter_fn, is_active=is_active))
