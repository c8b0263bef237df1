"""The port's snapshot (kubernetes_tpu_torch.snapshot) against the JAX
builder: after the same node and pod adds and removes, every ClusterState
field equals the JAX builder's, field by field and dtype by dtype; the
dirty-row flush agrees with the full rebuild; state_from_numpy carries the
JAX state across and back exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.snapshot import (
    ClusterState,
    SnapshotBuilder,
    state_from_numpy,
    state_to_numpy,
)

ZONE = "topology.kubernetes.io/zone"


def _node(mk, i, rng):
    w = mk(f"n{i}").capacity(
        {"cpu": str(int(rng.choice([0, 2, 4, 16]))), "memory": f"{int(rng.choice([0, 8, 64]))}Gi",
         "pods": int(rng.choice([3, 110]))}
    ).zone(f"z{i % 3}").label("rack", f"r{i % 5}")
    if i % 4 == 1:
        w = w.capacity({"example.com/gpu": 4})
    if i % 7 == 3:
        w = w.unschedulable()
    if i % 6 == 2:
        w = w.taint("dedicated", "infra")
    if i % 5 == 4:
        w = w.image("busybox:1", 1 << 20)
    return w.obj()


def _pod(mk, j, rng, node=None):
    w = mk(f"p{j}").req(
        {"cpu": f"{int(rng.choice([100, 500, 1500]))}m", "memory": f"{int(rng.choice([1, 3]))}Gi"}
    ).label("app", f"a{j % 4}")
    if j % 5 == 0:
        w = w.req({"example.com/gpu": 1})
    if j % 9 == 4:
        w = w.host_port(8000 + j % 3)
    if j % 11 == 6:
        w = w.pod_anti_affinity_in("app", [f"a{j % 4}"], ZONE)
    if node is not None:
        w = w.node(node)
    return w.obj()


def _drive(builder, mk_node, mk_pod, seed, flush_midway):
    """The same sequence of row writes and pod deltas on either builder."""
    rng = np.random.default_rng(seed)
    for i in range(40):
        builder.set_node_row(i, _node(mk_node, i, rng))
    if flush_midway:
        builder.state()
    deltas = []
    for j in range(120):
        row = int(rng.integers(40))
        d = builder.pod_delta_vectors(_pod(mk_pod, j, rng))
        builder.apply_pod_delta(row, d, +1, device_already=False)
        deltas.append((row, d))
    for row, d in deltas[::7]:
        builder.apply_pod_delta(row, d, -1, device_already=False)
    builder.clear_node_row(5)
    builder.clear_node_row(17)
    builder.set_node_row(17, _node(mk_node, 99, rng))
    return builder


def _jax_fields(state) -> dict:
    return {f.name: np.asarray(jax.device_get(getattr(state, f.name))) for f in dataclasses.fields(state)}


@pytest.mark.parametrize("seed,flush_midway", [(0, False), (1, True), (2, True)])
def test_state_fields_equal_jax_builder(seed, flush_midway):
    jb = _drive(JaxBuilder(), jnode, jpod, seed, flush_midway)
    tb = _drive(SnapshotBuilder(device="cpu"), tnode, tpod, seed, flush_midway)
    assert tb.schema.__dict__ == jb.schema.__dict__
    assert tb.res_col == jb.res_col
    want = _jax_fields(jb.state())
    got = state_to_numpy(tb.state())
    assert set(got) == set(want) == {f.name for f in dataclasses.fields(ClusterState)}
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert tb.host_mirror_equal()


def test_dirty_row_flush_matches_full_rebuild():
    tb = _drive(SnapshotBuilder(device="cpu"), tnode, tpod, 3, True)
    flushed = state_to_numpy(tb.state())
    tb.invalidate_device()
    rebuilt = state_to_numpy(tb.state())
    for name in rebuilt:
        np.testing.assert_array_equal(flushed[name], rebuilt[name], err_msg=name)


def test_device_already_delta_dirties_nothing_and_mirror_detects_drift():
    tb = _drive(SnapshotBuilder(device="cpu"), tnode, tpod, 4, True)
    st = tb.state()
    epoch = tb.mutation_epoch
    d = tb.pod_delta_vectors(tpod("late").req({"cpu": "1"}).obj())
    tb.apply_pod_delta(3, d, +1, device_already=True)
    assert tb.mutation_epoch == epoch and not tb._dirty_rows
    assert not tb.host_mirror_equal()  # the device never saw the commit
    st.req[3] += torch.from_numpy(d["req"])
    st.nonzero_req[3] += torch.from_numpy(d["nonzero"])
    st.num_pods[3] += 1
    st.group_counts[d["group"], 3] += 1
    assert tb.host_mirror_equal()


def test_state_from_numpy_round_trip():
    jb = _drive(JaxBuilder(), jnode, jpod, 5, False)
    fields = _jax_fields(jb.state())
    st = state_from_numpy(fields, "cpu")
    for f in dataclasses.fields(st):
        t = getattr(st, f.name)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), fields[f.name], err_msg=f.name)
    back = state_to_numpy(st)
    for name, arr in fields.items():
        assert back[name].dtype == arr.dtype
        np.testing.assert_array_equal(back[name], arr)
    st.req[0, 0] += 1  # a copy: the source arrays are untouched
    assert back["req"][0, 0] == fields["req"][0, 0]


def test_state_from_numpy_rejects_bad_fields():
    fields = _jax_fields(_drive(JaxBuilder(), jnode, jpod, 6, False).state())
    bad = dict(fields, num_pods=fields["num_pods"].astype(np.int64))
    with pytest.raises(TypeError):
        state_from_numpy(bad, "cpu")
    missing = {k: v for k, v in fields.items() if k != "valid"}
    with pytest.raises(ValueError):
        state_from_numpy(missing, "cpu")


def test_volume_and_claim_pods_raise():
    # Volumes are ported: a claim reference (dangling here) is accounted as
    # a PVC user with no device or CSI attachment.  Resource claims raise.
    tb = SnapshotBuilder(device="cpu")
    delta = tb.pod_delta_vectors(tpod("v").pvc_volume("data").obj())
    assert delta["pvcs"] == ["default/data"] and not delta["devices"] and not delta["csivols"]
    with pytest.raises(NotImplementedError):
        tb.pod_delta_vectors(tpod("c").resource_claim("gpu").obj())
