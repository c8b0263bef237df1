"""The port's truncated (parity) mode against a second reference that shares
no code with JAX: tests/test_parity.py's OracleScheduler, a scalar
sequential scheduler written to the reference's semantics
(schedule_one.go:53-58, 628, 676-702; node_tree.go:119).
TorchScheduler(device="cpu") must make the same decision for every pod:
the adaptive sequence (304 nodes in 4 zones, 120 pods), the fixed 40%
sequence (256 nodes in 3 zones, 60 pods), full evaluation (no rotation),
and the rotation really advancing (the scan start equals the oracle's and
is not 0).  Plus a cut of the port's path parity_basic_5kn_10kpods (300
of its nodes, 64 warm-up and 300 measured pods, batch 64, chunk 1) against
the JAX TPUScheduler with the same profile: bindings and the final scan
start.  Tolerance: none (exact)."""

from dataclasses import replace

import pytest

from kubernetes_tpu.benchmarks.harness import _basic_nodes, _pod_basic
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch import workloads as w
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import fit_only_profile as tfit
from kubernetes_tpu_torch.scheduler import TorchScheduler
from test_parity import OracleScheduler, _nodes, _pod, num_feasible_nodes_to_find


def _tnodes(n: int, zones: int = 4):
    """test_parity._nodes in the port's types."""
    return [
        tnode(f"node-{i:04d}").capacity({"cpu": "4" if i % 3 else "8", "memory": "16Gi", "pods": 110})
        .zone(f"zone-{i % zones}").obj()
        for i in range(n)
    ]


def _tpod(i: int):
    return tpod(f"pod-{i}").req({"cpu": "500m", "memory": "1Gi"}).obj()


def _sequence(n, zones, pods, pct, batch):
    s = TorchScheduler(profile=replace(tfit(), percentage_of_nodes_to_score=pct), batch_size=batch,
                       chunk_size=1, device="cpu")
    for node in _tnodes(n, zones):
        s.add_node(node)
    for i in range(pods):
        s.add_pod(_tpod(i))
    got = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
    oracle = OracleScheduler(_nodes(n, zones=zones), pct=pct, seed=0)
    want = {f"pod-{i}": oracle.schedule(_pod(i)) for i in range(pods)}
    return s, oracle, got, want


def test_port_parity_sequence_adaptive_truncation():
    s, oracle, got, want = _sequence(304, 4, 120, None, 32)
    diffs = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
    assert not diffs, f"{len(diffs)} mismatches, first 5: {dict(list(diffs.items())[:5])}"
    # The rotation really advanced (the config field is not dead).
    assert s._next_start == oracle.start != 0
    assert s.builder.host_mirror_equal()


def test_port_parity_sequence_fixed_percentage():
    s, oracle, got, want = _sequence(256, 3, 60, 40, 16)
    assert got == want
    assert s._next_start == oracle.start != 0


def test_port_full_evaluation_never_rotates():
    """percentage 100 (the default): no truncation, no rotation."""
    s = TorchScheduler(batch_size=8, device="cpu")
    for node in _tnodes(16):
        s.add_node(node)
    for i in range(8):
        s.add_pod(_tpod(i))
    out = s.schedule_all_pending()
    assert all(o.node_name for o in out)
    assert s._next_start == 0 and not s._truncated


def test_port_truncated_mode_needs_chunk_one():
    with pytest.raises(ValueError, match="chunk_size=1"):
        TorchScheduler(replace(TDEF, percentage_of_nodes_to_score=None), batch_size=64, chunk_size=8,
                       device="cpu")


NODES, WARM, MEASURED, BATCH = 300, 64, 300, 64


def test_parity_path_cut_matches_jax():
    """parity_basic_5kn_10kpods cut to 300 nodes: the default profile with
    the adaptive percentage (48% of 300, 144 nodes a scan), zone-interleaved
    over 3 zones."""
    js = TPUScheduler(profile=replace(registered_subset(JDEF), percentage_of_nodes_to_score=w.PARITY_PCT),
                      batch_size=BATCH, chunk_size=w.PARITY_CHUNK)
    _basic_nodes(NODES)(js)
    for i in range(WARM):
        p = _pod_basic(10**6 + i)
        p.metadata.name = f"warm-{i}"
        js.add_pod(p)
    jout = js.schedule_all_pending()
    for i in range(MEASURED):
        js.add_pod(_pod_basic(i))
    jout += js.schedule_all_pending()
    ts = TorchScheduler(replace(TDEF, percentage_of_nodes_to_score=w.PARITY_PCT), batch_size=BATCH,
                        chunk_size=w.PARITY_CHUNK, device="cpu")
    for node in w.basic_nodes(NODES, zones=w.PARITY_ZONES):
        ts.add_node(node)
    for p in w.warm_pods(WARM):
        ts.add_pod(p)
    tout = ts.schedule_all_pending()
    for i in range(MEASURED):
        ts.add_pod(w.pod_basic(i))
    tout += ts.schedule_all_pending()
    tb = {o.pod.name: o.node_name for o in tout}
    assert len(tb) == WARM + MEASURED and all(tb.values())
    assert tb == {o.pod.name: o.node_name for o in jout}
    assert ts._next_start == js._next_start != 0
    # Truncation was not vacuous: every pod kept only the first 144
    # feasible nodes of its scan.
    assert {o.feasible_nodes for o in tout} == {num_feasible_nodes_to_find(w.PARITY_PCT, NODES)} == {144}
    assert ts.builder.host_mirror_equal()
