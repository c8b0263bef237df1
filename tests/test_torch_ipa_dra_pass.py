"""DynamicResources after InterPodAffinity (the default profile's filter
order) through the port's batch pass against the JAX build_pass: a batch
whose chunks hold affinity pods and claim pods together, so both ops are
active and DynamicResources runs in a second eval_chunk launch on the nodes
InterPodAffinity's filter left (plain versions on the CPU).  Both passes
start from ``state_from_numpy`` of the JAX builder's state; picks, scores,
feasible counts, fail masks and the post-commit state must be equal, at
chunk 1 and 16, in full evaluation and in truncated mode (chunk 1).
Tolerance: none (exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import after_spec, build_pass, filter_op_names
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import state_from_numpy, state_to_numpy

GPU = "gpu.example.com"
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
K = 64  # 56 pods and 8 padding rows


def cluster(s, t, w, seed):
    """16 nodes in 4 zones, the even ones publishing 2 GPUs; bound pods
    with colours, a zone anti-affinity and claims; returns the batch's 56
    pods: zone (anti-)affinity pods, claim pods, pods with both, plain
    pods."""
    rng = np.random.default_rng(seed)
    for i in range(16):
        s.add_node(w.make_node(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": 110})
                   .zone(f"zone-{i % 4}").obj())
        if i % 2 == 0:
            devs = tuple(t.Device(name=f"gpu-{j}", attributes={"model": "h100"}) for j in range(2))
            s.add_resource_slice(t.ResourceSlice(node_name=f"n{i}", device_class=GPU, devices=devs))

    def claim(name, count=1):
        s.add_resource_claim(t.ResourceClaim(name=name, requests=(t.DeviceRequest("r0", GPU, count),)))

    for j in range(12):
        p = w.make_pod(f"b{j}").req({"cpu": "1"}).label("color", f"c{j % 3}")
        if j % 3 == 0:
            p = p.pod_anti_affinity_in("color", [f"c{(j + 1) % 3}"], ZONE)
        if j % 4 == 0:
            claim(f"held-{j}", 2)  # a full GPU node
            p = p.resource_claim(f"held-{j}")
            node = f"n{2 * int(rng.integers(8))}"
        else:
            node = f"n{int(rng.integers(16))}"
        s.add_pod(p.node(node).obj())
    pods = []
    for k in range(56):
        p = w.make_pod(f"q{k}").req({"cpu": str(int(rng.choice([1, 2])))}).priority(int(rng.integers(0, 3)))
        kind = k % 7
        if kind in (0, 3):
            p = p.label("color", f"c{k % 3}").pod_anti_affinity_in("color", [f"c{k % 3}"], ZONE)
        elif kind == 1:
            p = p.label("color", f"c{k % 3}").pod_affinity_in("color", [f"c{(k + 1) % 3}"], ZONE)
        if kind in (2, 3, 4):
            claim(f"own-{k}", 1 + k % 2)
            p = p.resource_claim(f"own-{k}")
        elif kind == 5:
            p = p.pod_anti_affinity_in("color", ["c0"], HOST).resource_claim("ghost" if k % 2 else f"own-{k - 3}")
        pods.append(p.obj())
    return pods


def _both(seed, percentage):
    jp = registered_subset(dataclasses.replace(JDEF, percentage_of_nodes_to_score=percentage))
    tp = dataclasses.replace(TDEF, percentage_of_nodes_to_score=percentage)
    j = TPUScheduler(profile=jp, batch_size=16)
    t = TorchScheduler(tp, batch_size=16, device="cpu")
    jpods, tpods = cluster(j, jt, jw, seed), cluster(t, tt, tw, seed)
    jbatch, _jd, jactive = jax_batch(jpods, j.builder, jp, K)
    tbatch, _td, tactive = torch_batch(tpods, t.builder, tp, K)
    assert jactive == tactive and {"InterPodAffinity", "DynamicResources"} <= tactive
    jbatch["nominated_row"] = np.full(K, -1, np.int32)
    tbatch["nominated_row"] = np.full(K, -1, np.int32)
    return j, jp, tp, jbatch, tbatch, jactive


@pytest.mark.parametrize("chunk,percentage", [(1, 100), (16, 100), (1, 50)])
@pytest.mark.parametrize("seed", [3, 4])
def test_dra_after_ipa_pass_matches_jax(chunk, percentage, seed):
    j, jp, tp, jbatch, tbatch, active = _both(seed, percentage)
    jb = j.builder
    inv = jb.batch_invariants()
    s = jb.schema
    after = after_spec(tp, s, jb.res_col, active)
    assert after is not None and after.filters == ("DynamicResources",)
    names = filter_op_names(tp, active)
    assert names.index("DynamicResources") == names.index("InterPodAffinity") + 1 == after.bit0
    jstate = jb.state()
    tstate = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)},
                              "cpu")
    tinv = dict(inv)
    if percentage != 100:
        import torch

        inv["order_pos"] = tinv["order_pos"] = j.cache.order_pos(s.N)
        inv["scan_start"] = np.uint32(0)
        tinv["scan_start"] = torch.zeros(1, dtype=torch.int64)
        tinv["scan_nodes"] = j.cache.node_count()
    jrun = jax_build_pass(jp, s, jb.res_col, active, chunk, carry_dom=True)
    jst, jout, _jdom = jrun(jstate, jbatch, inv, np.uint32(9), jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                            jnp.zeros((s.ET, s.DV), jnp.float32), np.bool_(False))
    trun = build_pass(tp, s, jb.res_col, active, chunk, carry_dom=True, _impl="plain")
    tst, tout, _tdom = trun(tstate, tbatch, tinv, 9, None, None, False)
    for f in ("picks", "scores", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f)
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)
    fails = np.asarray(jout.fail_masks)[:56].astype(np.int64)
    ipa_bit, dra_bit = 1 << names.index("InterPodAffinity"), 1 << names.index("DynamicResources")
    # Both ops rejected nodes, and for some pods DynamicResources rejected
    # nodes InterPodAffinity had passed.
    by_ipa, by_dra = (fails & ipa_bit) != 0, (fails & dra_bit) != 0
    assert by_ipa.any() and by_dra.any() and (by_ipa & by_dra).any()
    picks = np.asarray(jout.picks)[:56]
    assert (picks >= 0).sum() > 10 and (picks == -1).any()
