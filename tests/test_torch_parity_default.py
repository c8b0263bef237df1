"""The two cases of tests/test_parity_default.py through the port: the
default profile in truncated (parity) mode at chunk 1,
TorchScheduler(device="cpu"), against tests/oracle_full.py's
FullOracleScheduler (a scalar sequential scheduler with the reference's
filters, truncation and rotation, normalized weighted scoring, seeded
tie-breaks, greedy-reprieve preemption and the nominated retry), on the
same fixture (``build_fixture``, its objects converted to the port's
types field for field).  Bindings, nominations and victims must be equal.
Tolerance: none (exact)."""

import copy
import dataclasses
from dataclasses import replace

from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.engine.features import build_pod_batch
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.scheduler import TorchScheduler
from oracle_full import FullOracleScheduler, RefClaims, RefVolumes, build_fixture


def to_torch(obj):
    """The port's twin of a JAX package API object, field for field."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_torch(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_torch(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(tt, type(obj).__name__)
        return cls(**{f.name: to_torch(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init})
    return obj


def _drive(volumes: bool):
    nodes, bound, pending, pdbs, objs = build_fixture(volumes=volumes)
    prof = replace(TDEF, percentage_of_nodes_to_score=None)
    s = TorchScheduler(prof, batch_size=64, chunk_size=1, device="cpu")
    for n in nodes:
        s.add_node(to_torch(n))
    if volumes:
        for sc in objs["classes"]:
            s.add_storage_class(to_torch(sc))
        for pv in objs["pvs"]:
            s.add_pv(to_torch(pv))
        for pvc in objs["pvcs"]:
            s.add_pvc(to_torch(pvc))
        for cn in objs["csinodes"]:
            s.add_csinode(to_torch(cn))
        for sl in objs["slices"]:
            s.add_resource_slice(to_torch(sl))
        for cl in objs["dclaims"]:
            s.add_resource_claim(to_torch(cl))
    for p in bound:
        s.add_pod(to_torch(p))
    for pdb in pdbs:
        s.add_pdb(to_torch(pdb))
    extra = {}
    if volumes:
        extra = dict(
            vols=RefVolumes(pvs=copy.deepcopy(objs["pvs"]), pvcs=copy.deepcopy(objs["pvcs"]),
                            classes=copy.deepcopy(objs["classes"]), csinodes=copy.deepcopy(objs["csinodes"])),
            claims=RefClaims(claims=copy.deepcopy(objs["dclaims"]), slices=copy.deepcopy(objs["slices"])),
        )
    oracle = FullOracleScheduler(nodes, pct=None, seed=prof.tie_break_seed,
                                 hard_pod_affinity_weight=prof.hard_pod_affinity_weight, batch_size=64,
                                 pdbs=[copy.deepcopy(p) for p in pdbs], **extra)
    for p in bound:
        oracle.add_bound(copy.deepcopy(p))
    # Pre-grow every vocabulary the pending pods need (featurization
    # interns without committing), as the JAX test does.
    build_pod_batch([to_torch(p) for p in pending], s.builder, s.profile, len(pending))
    for p in pending:
        s.add_pod(to_torch(p))
    got = s.schedule_all_pending(wait_backoff=True)
    want = oracle.run([copy.deepcopy(p) for p in pending], prefetch=not volumes)
    got_bind = {o.pod.name: o.node_name for o in got if o.node_name}
    want_bind = {d.pod.name: d.node for d in want if d.node}
    diffs = {k: (got_bind.get(k), want_bind.get(k)) for k in set(got_bind) | set(want_bind)
             if got_bind.get(k) != want_bind.get(k)}
    assert not diffs, f"{len(diffs)} binding mismatches, first 5: {dict(sorted(diffs.items())[:5])}"
    assert {o.pod.name: o.nominated_node for o in got if o.nominated_node} == \
        {d.pod.name: d.nominated for d in want if d.nominated}
    assert {o.pod.name: tuple(sorted(o.victim_uids)) for o in got if o.victim_uids} == \
        {d.pod.name: tuple(sorted(d.victims)) for d in want if d.victims}
    assert s.builder.host_mirror_equal()
    return s, got_bind, want, objs


def test_port_default_profile_decision_parity_with_preemption():
    s, got_bind, want, _objs = _drive(volumes=False)
    assert any(d.nominated for d in want), "fixture no longer exercises preemption"
    assert all(f"vip-{i}" in got_bind for i in range(6))
    assert s._next_start != 0


def test_port_full_surface_parity_volumes_dra_gates():
    _s, got_bind, _want, objs = _drive(volumes=True)
    assert "rw-a" in got_bind and "rw-b" not in got_bind
    assert "dra-missing" not in got_bind
    for uid in objs["gated_uids"]:
        assert uid.split("/")[1] not in got_bind
