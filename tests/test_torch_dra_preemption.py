"""DynamicResources in preemption's what-if search, the port against the
JAX package.

The victim pack with its four DRA columns (claim id, pool, devices, first
slot; the count-only slot of an externally charged claim a victim alone
reserves) against the JAX stage, and the dry-run pass (plain versions on
the CPU) against JAX ``build_preempt_pass(...).run`` from the same
cluster, batch and victims, at chunk 1 and chunk 8: picks, victim masks,
victim counts, the final carry and the final victim priorities equal.
The cluster's nodes publish named devices of two models; their victims
hold claims of their own (bare and selector pools), a claim shared by two
victims of a node, and externally allocated claims; the preemptors want
whole nodes, h100 devices only, a missing claim or a claim allocated
elsewhere.  Also the plain release step by step against a released copy of
the state, and, side by side through TPUScheduler and TorchScheduler, the
device shortage of tests/test_dra.py:130 resolved by preemption and the
selector case of tests/test_dra_structured.py:478 left to preemption
(which, as in the reference, does not free it).  Tolerance: exact."""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu import preemption as jpre
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu_torch import preemption as tpre
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.kernels import Victims, plain
from kubernetes_tpu_torch.ops import dynamicresources as tdra
from kubernetes_tpu_torch.snapshot import state_from_numpy
from tests.test_torch_preemption import JPROF, TDEF, drive, make_pair

GPU = "gpu.example.com"
H100 = 'device.attributes["model"].string == "h100"'
DRA_VF = ("dra_kid", "dra_cid", "dra_cnt", "dra_first")
PACK_KEYS = ("d_prio", "d_vic_req", "d_vic_nonzero", "d_vic_start", "d_pdb", "d_allowed")
FILTERS = ("NodeUnschedulable", "NodeName", "NodeResourcesFit", "DynamicResources")


def profiles(case):
    if case == "default":
        return JPROF, TDEF
    kw = dict(filters=FILTERS, scorers=(("NodeResourcesFit", 1),))
    return JProfile(name="dra", **kw), TProfile(name="dra", **kw)


def cluster(s, t, w, seed, nodes=8):
    """``nodes`` nodes of 4 GPUs (h100 on even ones, a100 on odd ones),
    each filled through the scheduler with claim holders of priority 1-9
    (one device each, some under the h100 selector, a claim shared by two
    holders on every third node) and, on nodes 1 and 5, a holder bound
    directly with an externally allocated claim it alone reserves."""
    rng = np.random.default_rng(seed)
    for i in range(nodes):
        s.add_node(w.make_node(f"n{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": 110}).obj())
        model = "h100" if i % 2 == 0 else "a100"
        s.add_resource_slice(t.ResourceSlice(node_name=f"n{i}", device_class=GPU, devices=tuple(
            t.Device(name=f"gpu-{j}", attributes={"model": model}) for j in range(4))))
    for i in (1, 5):
        s.add_resource_claim(t.ResourceClaim(name=f"ext-{i}", device_class=GPU, allocated_node=f"n{i}",
                                             allocated_devices=(("r0", "gpu-3"),), reserved_for=(f"default/x{i}",)))
        s.add_pod(w.make_pod(f"x{i}").req({"cpu": "1"}).priority(2).resource_claim(f"ext-{i}").node(f"n{i}").obj())
    for j in range(3 * nodes - 2):
        sel = (H100,) if j % 5 == 0 else ()
        if j % 7 == 3:
            s.add_resource_claim(t.ResourceClaim(name=f"pair-{j}", requests=(t.DeviceRequest("r0", GPU, 1, sel),)))
            for k in range(2):
                s.add_pod(w.make_pod(f"v{j}-{k}").req({"cpu": "1"}).priority(int(rng.integers(1, 10)))
                          .start_time(float(j)).resource_claim(f"pair-{j}").obj())
            continue
        s.add_resource_claim(t.ResourceClaim(name=f"c{j}", requests=(t.DeviceRequest("r0", GPU, 1, sel),)))
        s.add_pod(w.make_pod(f"v{j}").req({"cpu": "1"}).priority(int(rng.integers(1, 10))).start_time(float(j))
                  .resource_claim(f"c{j}").obj())


def preemptors(s, t, w, k):
    """``k`` preemptors at priority 100: whole nodes (four devices), h100
    devices, a missing claim, a claim allocated on node 0 (pinned)."""
    out = []
    for i in range(k):
        kind = i % 4
        name = f"p{i}"
        pw = w.make_pod(name).req({"cpu": "1"}).priority(100)
        if kind == 0:
            s.add_resource_claim(t.ResourceClaim(name=f"want-{i}", requests=(t.DeviceRequest("r0", GPU, 4),)))
            pw = pw.resource_claim(f"want-{i}")
        elif kind == 1:
            s.add_resource_claim(t.ResourceClaim(name=f"want-{i}", requests=(t.DeviceRequest("r0", GPU, 2, (H100,)),)))
            pw = pw.resource_claim(f"want-{i}")
        elif kind == 2:
            pw = pw.resource_claim("ghost")
        else:
            pw = pw.resource_claim("c0")  # allocated with its holder: pinned there
        out.append(pw.obj())
    return out


def setup(case, seed, k):
    jp, tp = profiles(case)
    (j, jc), (t, tc) = make_pair(batch_size=16, profile=(jp, tp))
    cluster(j, jt, jw, seed)
    cluster(t, tt, tw, seed)
    drive(j, jc)
    drive(t, tc)
    assert sorted(j.cache.pods) == sorted(t.cache.pods)
    jpods, tpods = preemptors(j, jt, jw, k), preemptors(t, tt, tw, k)
    jb, _, jactive = jax_batch(jpods, j.builder, j.profile, k)
    tb, _, tactive = torch_batch(tpods, t.builder, t.profile, k)
    assert jactive == tactive and "DynamicResources" in tactive
    return j, t, jpods, jb, tb, jactive


def victims_of(pack) -> Victims:
    vf = {key: torch.from_numpy(np.array(v)) for key, v in pack["d_vfeat"].items()}
    return Victims(*(torch.from_numpy(np.array(pack[key])) for key in PACK_KEYS), vf)


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("case", ["dra", "default"])
def test_dra_dry_run_matches_jax(case, chunk):
    k = 16
    j, t, jpods, jb, tb, active = setup(case, 5, k)
    jpack = j.preemption.pack_victims(j.profile, active)
    tpack = t.preemption.pack_victims(t.profile, active)
    want = victims_of(jpack)
    for name, a, b in zip(PACK_KEYS, tpack["vic"][:6], want[:6]):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    assert sorted(tpack["vic"].vfeat) == sorted(want.vfeat) and set(DRA_VF) <= set(want.vfeat)
    for key, arr in want.vfeat.items():
        np.testing.assert_array_equal(tpack["vic"].vfeat[key].numpy(), arr.numpy(), err_msg=key)
    kid, cnt = want.vfeat["dra_kid"].numpy(), want.vfeat["dra_cnt"].numpy()
    assert ((kid >= 0) & (cnt == 0)).any()  # the compensating slot of an external claim
    vic = tpre.victims_from_numpy(tpack["buf"], tpack["layout"], "cpu")  # the staged buffer unpacked again
    for key in DRA_VF:
        np.testing.assert_array_equal(vic.vfeat[key].numpy(), want.vfeat[key].numpy(), err_msg=key)
    sigs, _ = j.preemption._sig_ids(jpods, j.profile, k)
    valid = np.ones(k, np.bool_)
    valid[-1] = False
    jb["valid"], jb["sig"] = valid, sigs
    inv = j.builder.batch_invariants()
    fn = jpre.build_preempt_pass(j.profile, j.builder.schema, j.builder.res_col, active, jpack["n_pdbs"], chunk)
    jstate = j.builder.state()
    jout, jfinal, jprio = fn(jstate, jb, inv, *(jpack[key] for key in PACK_KEYS[:4]), jpack["d_vfeat"],
                             jpack["d_pdb"], jpack["d_allowed"])
    tbatch = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tb.items()}
    tbatch["valid"], tbatch["sig"] = torch.from_numpy(valid), torch.from_numpy(sigs)
    state = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate.__dataclass_fields__}, "cpu")
    run = tpre.build_preempt_pass(t.profile, t.builder.schema, t.builder.res_col, active, chunk, _impl="plain")
    tout, carry, tprio = run(state, tbatch, tpack["vic"], inv={key: np.asarray(v) for key, v in inv.items()})
    np.testing.assert_array_equal(tout.picks.numpy(), np.asarray(jout.picks))
    np.testing.assert_array_equal(tout.vic_mask.numpy(), np.asarray(jout.vic_mask))
    np.testing.assert_array_equal(tout.n_victims.numpy(), np.asarray(jout.n_victims))
    for tv, f in zip(carry, ("req", "nonzero_req", "num_pods")):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(getattr(jfinal, f)), err_msg=f)
    np.testing.assert_array_equal(tprio.numpy(), np.asarray(jprio))
    picks = np.asarray(jout.picks)[:15]
    assert (picks >= 0).any()  # whole nodes freed
    if chunk > 1:
        assert (picks == -2).any()  # other-signature mates defer
    else:
        assert (picks[2::4] == -1).all()  # a missing claim has no candidate


def test_release_matches_a_released_copy():
    """The plain release (no copy of the claim table) against the op's own
    filter on a state with the masked victims' claims removed by hand, for
    every node and a few masks: every slot of a claim that reaches 0
    releases its pool charge; the compensating slot moves the count only."""
    _j, t, _pods, _jb, tb, active = setup("dra", 7, 16)
    pack = t.preemption.pack_victims(t.profile, active)
    vic, state = pack["vic"], t.builder.state()
    vf = vic.vfeat
    rng = np.random.default_rng(3)
    n, v = vic.prio.shape
    checked = 0
    for i0 in (0, 1, 4):
        pf1 = {key: torch.from_numpy(np.ascontiguousarray(val[i0:i0 + 1])) for key, val in tb.items()}
        for _ in range(3):
            tent = torch.from_numpy(rng.random((n, v)) < 0.6) & (vic.prio < 2**31 - 1)
            counts, alloc = state.dra_claim_counts.clone(), state.dra_alloc.clone()
            for node, slot in zip(*torch.nonzero(tent, as_tuple=True)):
                for b in range(vf["dra_kid"].shape[2]):
                    k_ = int(vf["dra_kid"][node, slot, b])
                    if k_ >= 0 and int(vf["dra_first"][node, slot, b]):
                        counts[k_, node] -= 1
            for node, slot in zip(*torch.nonzero(tent, as_tuple=True)):
                for b in range(vf["dra_kid"].shape[2]):
                    k_ = int(vf["dra_kid"][node, slot, b])
                    if k_ >= 0 and int(counts[k_, node]) == 0:
                        alloc[max(int(vf["dra_cid"][node, slot, b]), 0), node] -= int(vf["dra_cnt"][node, slot, b])
            released = dataclasses.replace(state, dra_claim_counts=counts, dra_alloc=alloc)
            want = tdra.filter_fn(released, pf1, None)[0]
            got = plain._dra_released(state, vic, tent, pf1)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
            checked += int(want.sum())
    assert checked > 0


def _shortage(s, t, w):  # tests/test_dra.py:130
    s.add_node(w.make_node("n0").capacity({"cpu": "16", "memory": "64Gi", "pods": 110}).obj())
    s.add_resource_slice(t.ResourceSlice(node_name="n0", device_class=GPU, count=1))
    s.add_resource_claim(t.ResourceClaim(name="held", device_class=GPU))
    s.add_pod(w.make_pod("holder").req({"cpu": "1"}).resource_claim("held").priority(1).obj())


def _shortage_then(s, t, w):
    s.add_resource_claim(t.ResourceClaim(name="wanted", device_class=GPU))
    s.add_pod(w.make_pod("vip").req({"cpu": "1"}).resource_claim("wanted").priority(100).obj())


def _selector(s, t, w):  # tests/test_dra_structured.py:478, the holder evicted
    s.add_node(w.make_node("n1").capacity({"cpu": "8", "memory": "16Gi", "pods": 110}).obj())
    s.add_resource_slice(t.ResourceSlice(node_name="n1", device_class=GPU, devices=(
        t.Device(name="d0", attributes={"memory": 80, "arch": "hopper", "nvlink": True}),)))
    s.add_resource_claim(t.ResourceClaim(name="holder", requests=(t.DeviceRequest("r0", GPU, count=1),)))
    s.add_pod(w.make_pod("holder").req({"cpu": "1"}).resource_claim("holder").priority(1).obj())


def _selector_then(s, t, w):
    s.add_resource_claim(t.ResourceClaim(name="wants", requests=(
        t.DeviceRequest("r0", GPU, count=1, selectors=('device.attributes["memory"].int >= 40',)),)))
    s.add_pod(w.make_pod("wants").req({"cpu": "1"}).resource_claim("wants").priority(100).obj())


@pytest.mark.parametrize("case", ["shortage", "selector"])
@pytest.mark.parametrize("profile", ["dra", "default"])
def test_preemption_frees_devices_as_the_reference(case, profile):
    build, then = {"shortage": (_shortage, _shortage_then), "selector": (_selector, _selector_then)}[case]
    (j, jc), (t, tc) = make_pair(batch_size=4, profile=profiles(profile))
    outs = []
    for s, c, T, W in ((j, jc, jt, jw), (t, tc, tt, tw)):
        build(s, T, W)
        out = drive(s, c)
        then(s, T, W)
        outs.append(out + drive(s, c))
    jout, tout = outs
    summary = [(o.pod.name, o.node_name, o.nominated_node, o.victim_uids) for o in tout]
    assert summary == [(o.pod.name, o.node_name, o.nominated_node, o.victim_uids) for o in jout]
    if case == "shortage":
        assert "default/holder" not in t.cache.pods and tout[-1].node_name == "n0"
        assert t.builder.dra.claims["default/held"].allocated_node == ""
    else:
        # The what-if releases a victim's own pool charges but not the
        # pool-overlap correction its named device carries in the selector
        # pool, so no node is possible and the holder stays, as in the
        # reference (ROADMAP §3, "Selector pools stay charged").
        assert "default/holder" in t.cache.pods and tout[-1].node_name is None
    assert t.builder.dra.device_owner == j.builder.dra.device_owner
    for key in ("dra_cap", "dra_alloc", "dra_claim_counts"):
        np.testing.assert_array_equal(t.builder.host[key], j.builder.host[key], err_msg=key)
    assert t.builder.host_mirror_equal()
