"""TorchScheduler(device="cpu") against TPUScheduler on a cut of the port's
path ``dra_claims_5kn_5kpods`` (kubernetes_tpu_torch/workloads.py): 200 of
its nodes in 10 zones (50 publishing 8 named GPUs, h100 and a100
alternating), 64 claim-less fill pods, then 300 claim pods (one in four
h100 only, one in 32 sharing its predecessor's claim), then 16 preemptors
at priority 1000 wanting all 8 devices of a node; the path's batch shape
scaled down to batch 64, chunk 8.  The JAX side gets the same objects,
field for field.  Both queues run on injected clocks.  Outcomes (bindings,
nominations, victims) must be equal pod for pod, and so must the claim
allocations and the DRA rows; and the path's gates hold: every pod and
preemptor binds, every claim is allocated on its pod's node to devices the
node publishes (h100 ones for h100 claims), shared pairs are co-located,
no pool column exceeds its cap and each equals the catalog's count of
owned devices matching the pool, every victim is a priority-1 claim pod
whose claim was released, and the host mirror equals the device state.
Tolerance: none (exact)."""

import dataclasses

import numpy as np

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch import dra_cel
from kubernetes_tpu_torch import workloads as w
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.queue import SchedulingQueue as TQueue
from kubernetes_tpu_torch.scheduler import TorchScheduler
from test_torch_volumes import FakeClock, drive

NODES, FILL, MEASURED, PREEMPTORS, BATCH, CHUNK = 200, 64, 300, 16, 64, 8


def to_jax(obj):
    """The JAX package's twin of a port API object, field for field."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_jax(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_jax(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        cls = getattr(jt, type(obj).__name__)
        return cls(**{f.name: to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init})
    return obj


def run(s, clock, conv):
    for node in w.basic_nodes(NODES, zones=10):
        s.add_node(conv(node))
    s.builder._ensure(CLM=512)
    for sl in w.dra_slices(NODES):
        s.add_resource_slice(conv(sl))
    for pod in w.warm_pods(FILL):
        s.add_pod(conv(pod))
    out = drive(s, clock)
    for c in w.dra_claims(MEASURED):
        s.add_resource_claim(conv(c))
    for i in range(MEASURED):
        s.add_pod(conv(w.dra_pod(i)))
    out += drive(s, clock)
    for c in w.dra_preemptor_claims(PREEMPTORS):
        s.add_resource_claim(conv(c))
    for i in range(PREEMPTORS):
        s.add_pod(conv(w.dra_preemptor(i)))
    return out + drive(s, clock, max_steps=200)


def gates(s):
    bound = {pr.pod.name: pr.node_name for pr in s.cache.pods.values()}
    evicted = {v for v, _p, _n in s.preempted}
    assert all(f"gpu-{i}" in bound or f"default/gpu-{i}" in evicted for i in range(MEASURED))
    assert all(f"vip-{i}" in bound for i in range(PREEMPTORS))
    cat = s.builder.dra
    for pr in s.cache.pods.values():
        for claim in cat.pod_claims(pr.pod):
            assert claim.allocated_node == pr.node_name, (pr.pod.name, claim.uid)
            devs = cat.devices[(pr.node_name, w.DRA_CLASS)]
            assert len(claim.allocated_devices) == claim.device_requests()[0].count
            for _r, d in claim.allocated_devices:
                assert d in devs and cat.device_owner[(pr.node_name, w.DRA_CLASS)][d] == claim.uid
                if claim.device_requests()[0].selectors:
                    assert devs[d]["model"] == "h100"
    for i in range(1, MEASURED, w.DRA_SHARE_EVERY):
        a, b = f"gpu-{i - 1}", f"gpu-{i}"
        if a in bound and b in bound:
            assert bound[a] == bound[b]
    h = s.builder.host
    assert (h["dra_alloc"] <= h["dra_cap"]).all()
    it = s.builder.interns.device_classes
    for sig, (cls, reqs) in cat.pools.items():
        for (node, c), owners in cat.device_owner.items():
            if c != cls:
                continue
            want = sum(1 for d in owners if dra_cel.matches(reqs, cat.devices[(node, c)][d]))
            assert h["dra_alloc"][it.id(sig), s.cache.row_of(node)] == want, (sig, node)
    for vic, _pre, _node in s.preempted:
        assert vic.startswith("default/gpu-")
        name = vic.split("/", 1)[1]
        claim = cat.claims[f"default/{w.dra_claim_of(int(name.split('-')[1]))}"]
        assert vic not in claim.reserved_for
    assert s.builder.host_mirror_equal()


def test_dra_workload_cut_matches_jax():
    jc, tc = FakeClock(), FakeClock()
    j = TPUScheduler(profile=registered_subset(JDEF), batch_size=BATCH, chunk_size=CHUNK)
    j.queue._clock = jc
    t = TorchScheduler(TDEF, batch_size=BATCH, chunk_size=CHUNK, device="cpu", queue=TQueue(backoff=True, clock=tc))
    jout = run(j, jc, to_jax)
    tout = run(t, tc, lambda x: x)
    key = lambda outs: [(o.pod.name, o.node_name, o.nominated_node, o.victim_uids) for o in outs]  # noqa: E731
    assert key(tout) == key(jout)
    assert len(t.preempted) >= PREEMPTORS  # the victims are in the outcomes compared above
    for name in ("dra_cap", "dra_alloc", "dra_claim_counts"):
        np.testing.assert_array_equal(t.builder.host[name], j.builder.host[name], err_msg=name)
    tclaims = {u: (c.allocated_node, c.allocated_devices, c.reserved_for) for u, c in t.builder.dra.claims.items()}
    assert tclaims == {u: (c.allocated_node, c.allocated_devices, c.reserved_for)
                       for u, c in j.builder.dra.claims.items()}
    gates(t)
