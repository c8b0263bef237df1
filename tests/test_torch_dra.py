"""The port's DynamicResources against the JAX package, exactly.

Op level, on seeded random states (claim counts 0-2, pool caps and
allocations, pods with one to three claim slots of shared and duplicate
ids, allocation pins, missing claims): the plain filter and hard filter
against the JAX op's ``filter``/``hard_filter`` vmapped over the pods, the
DRA branch of the plain commit against the JAX ``_commit_chunk`` and the
DRA pairs of the plain conflict table against the JAX ``_conflict_pairs``;
and on a cluster built through both schedulers' informers (named devices
with attributes, a selector pool, a shared claim, an allocated claim, a
missing claim, a pod naming one claim twice) the ``dra_*`` features of
both featurizations.

Scheduler level: the ten scenarios of tests/test_dra.py and those of
tests/test_dra_structured.py:267-675 (not the two that need remove_node,
which the port lacks) run side by side through TPUScheduler and
TorchScheduler(device="cpu") on injected clocks: the same outcomes in
order, the same claim allocations (node, named devices, reservations), the
same device ownership, the same ``dra_*`` host rows, and host mirrors equal
to the device state.  Tolerance: none (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import DomTables as JDom
from kubernetes_tpu.engine.pass_ import _commit_chunk as jax_commit
from kubernetes_tpu.engine.pass_ import _conflict_pairs as jax_conflict_pairs
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import DomTables
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.framework.features import FeatureGates
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.ops import common as tcommon
from kubernetes_tpu_torch.queue import SchedulingQueue as TQueue
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import state_from_numpy

GPU = "gpu.example.com"
DRA_KEYS = ("dra_claim_ids", "dra_claim_cls", "dra_claim_cnt", "dra_claim_first", "dra_claim_unalloc")
DRA_ROWS = ("dra_cap", "dra_alloc", "dra_claim_counts")


# -- op level: random states ------------------------------------------------------


def random_case(seed, n=12, c=8, s=4, clm=16, dc=4):
    """A state of ``n`` nodes with random DRA columns and ``c`` pods of up
    to ``s`` claim slots (claims shared across pods, a claim's slots
    adjacent with its first slot marked), as both ClusterStates and
    feature dicts."""
    rng = np.random.default_rng(seed)
    jb = JaxBuilder()
    for i in range(n):
        jb.set_node_row(i, jw.make_node(f"n{i}").capacity({"cpu": "8"}).obj())
    jb._ensure(CLM=clm, DC=dc)
    h = jb.host
    h["dra_cap"][:] = rng.integers(0, 4, h["dra_cap"].shape)
    h["dra_alloc"][:] = np.minimum(h["dra_cap"], rng.integers(0, 3, h["dra_alloc"].shape))
    h["dra_claim_counts"][:] = rng.integers(0, 3, h["dra_claim_counts"].shape) * (
        rng.random(h["dra_claim_counts"].shape) < 0.3)
    jstate = jb.state()
    tstate = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name))
                               for f in dataclasses.fields(jstate)}, "cpu")
    feats = {key: np.full((c, s), -1 if key in ("dra_claim_ids", "dra_claim_cls") else 0,
                          np.bool_ if key in ("dra_claim_first", "dra_claim_unalloc") else np.int32)
             for key in DRA_KEYS}
    for i in range(c):
        j = 0
        while j < s and rng.random() < 0.8:
            kid = int(rng.integers(0, clm // 2))  # a small id space: shared claims
            unalloc = bool(rng.random() < 0.6)
            for a in range(min(int(rng.integers(1, 3)), s - j)):
                feats["dra_claim_ids"][i, j] = kid
                feats["dra_claim_cls"][i, j] = int(rng.integers(0, dc))
                feats["dra_claim_cnt"][i, j] = int(rng.integers(1, 4))
                feats["dra_claim_first"][i, j] = a == 0
                feats["dra_claim_unalloc"][i, j] = unalloc
                j += 1
    name_ids = np.asarray(jstate.name_id)[:n]
    pins = np.full((c, 4), -1, np.int32)
    for i in range(c):
        if rng.random() < 0.3:
            pins[i, 0] = name_ids[int(rng.integers(0, n))]
        if rng.random() < 0.1:
            pins[i, 1] = name_ids[int(rng.integers(0, n))]
    feats["dra_pin_ids"] = pins
    feats["dra_missing"] = rng.random(c) < 0.15
    return jb, jstate, tstate, feats


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_filter_and_hard_filter_match_jax(seed):
    _jb, jstate, tstate, feats = random_case(seed)
    jop, top = jcommon.get("DynamicResources"), tcommon.get("DynamicResources")
    jpf = {k: jnp.asarray(v) for k, v in feats.items()}
    tpf = {k: torch.from_numpy(v) for k, v in feats.items()}
    for jfn, tfn in ((jop.filter, top.filter), (jop.hard_filter, top.hard_filter)):
        want = np.asarray(jax.vmap(lambda p: jfn(jstate, p, None))(jpf))
        np.testing.assert_array_equal(tfn(tstate, tpf, None).numpy(), want)
    want = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, None))(jpf))
    valid = np.asarray(jstate.valid)
    assert want[:, valid].any() and not want[:, valid].all()
    # Without any claim slot in the batch the port leaves the base
    # features out; the JAX batch then holds one all-padding slot.
    bare = {k: v for k, v in feats.items() if k not in DRA_KEYS}
    pad = dict(bare, **{k: np.full((8, 1), -1 if k in ("dra_claim_ids", "dra_claim_cls") else 0,
                                   feats[k].dtype) for k in DRA_KEYS})
    want = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, None))({k: jnp.asarray(v) for k, v in pad.items()}))
    got = top.filter(tstate, {k: torch.from_numpy(v) for k, v in bare.items()}, None).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_and_pairs_match_jax(seed):
    """The DRA branch of the commit (two pods per node, shared claims and
    claims already reserved on a node among them) and the DRA pairs."""
    jb, jstate, tstate, feats = random_case(seed)
    c = 8
    s = jb.schema
    base = {"req": np.zeros((c, s.R), np.int64), "nonzero": np.zeros((c, 2), np.int64),
            "group": np.zeros(c, np.int32), "valid": np.ones(c, np.bool_)}
    allf = dict(feats, **base)
    rows = np.array([0, 0, 3, 3, 5, 5, 9, 9], np.int32)
    do = np.array([True] * 7 + [False])
    jdom = JDom(jnp.zeros((s.N, s.TK, s.DV), jnp.float32), jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                jnp.zeros((s.ET, s.DV), jnp.float32), jnp.zeros((s.ET, s.N), jnp.int32),
                jnp.zeros(s.ET, jnp.int32), jnp.zeros(s.ET, jnp.bool_))
    jst, _ = jax_commit(jstate, jdom, {k: jnp.asarray(v) for k, v in allf.items()}, jnp.asarray(rows),
                        jnp.asarray(do))
    tdom = DomTables(torch.zeros((s.G, s.TK, s.DV)), torch.zeros((s.ET, s.DV)),
                     torch.zeros(s.ET, dtype=torch.int32), torch.zeros(s.ET, dtype=torch.bool))
    tpf = {k: torch.from_numpy(v) for k, v in dict(allf, valid=do).items()}
    plain.resolve_commit(tstate, tdom, tpf, torch.from_numpy(rows), None, True)
    for f in DRA_ROWS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)
    assert (np.asarray(jst.dra_alloc) != np.asarray(jstate.dra_alloc)).any()
    got = plain.conflict_pairs({k: torch.from_numpy(v) for k, v in allf.items()}, 2, 4).numpy()
    for b in range(2):
        pf = {k: jnp.asarray(v[b * 4:(b + 1) * 4]) for k, v in allf.items()}
        pf.update({k: jnp.full((4, 1), -1, jnp.int32) for k in ("vol_dev_ids", "vol_csi_ids")})
        np.testing.assert_array_equal(got[b], np.asarray(jax_conflict_pairs(pf, s)))
    assert got.any()


# -- featurization of an informer-built cluster -------------------------------------


def make_devices(t, mems, archs, nvlinks):
    return tuple(t.Device(name=f"d{i}", attributes={"memory": m, "arch": a, "nvlink": v})
                 for i, (m, a, v) in enumerate(zip(mems, archs, nvlinks)))


BIG_MEM = 'device.attributes["memory"].int >= 40'
HOPPER_LINKED = 'device.attributes["arch"].string == "hopper" && device.attributes["nvlink"].bool == true'


def feature_cluster(s, t, w):
    """Three nodes with named devices, claims of every kind, and the pods
    naming them (returned, not added)."""
    for name, devs in (("n0", make_devices(t, [16, 80], ["ada", "hopper"], [False, True])),
                       ("n1", make_devices(t, [40, 80, 80], ["hopper"] * 3, [True, True, False])),
                       ("n2", ())):
        s.add_node(w.make_node(name).capacity({"cpu": "8", "memory": "16Gi", "pods": 110}).obj())
        if devs:
            s.add_resource_slice(t.ResourceSlice(node_name=name, device_class=GPU, devices=devs))
    s.add_resource_claim(t.ResourceClaim(name="plain", requests=(t.DeviceRequest("r0", GPU, 1),)))
    s.add_resource_claim(t.ResourceClaim(name="big", requests=(t.DeviceRequest("r0", GPU, 2, (BIG_MEM,)),)))
    s.add_resource_claim(t.ResourceClaim(name="two", requests=(
        t.DeviceRequest("a", GPU, 1, (HOPPER_LINKED,)), t.DeviceRequest("b", GPU, 1))))
    s.add_resource_claim(t.ResourceClaim(name="held", device_class=GPU, allocated_node="n1",
                                         allocated_devices=(("r0", "d2"),), reserved_for=("ext/pod",)))
    return [
        w.make_pod("a").req({"cpu": "1"}).resource_claim("plain").obj(),
        w.make_pod("b").req({"cpu": "1"}).resource_claim("big").resource_claim("plain").obj(),
        w.make_pod("c").req({"cpu": "1"}).resource_claim("two").obj(),
        w.make_pod("d").req({"cpu": "1"}).resource_claim("held").obj(),
        w.make_pod("e").req({"cpu": "1"}).resource_claim("ghost").resource_claim("plain").obj(),
        w.make_pod("f").req({"cpu": "1"}).resource_claim("plain").resource_claim("plain").obj(),
        w.make_pod("g").req({"cpu": "1"}).obj(),
    ]


def test_features_match_jax():
    j = TPUScheduler(profile=registered_subset(JDEF), batch_size=8)
    t = TorchScheduler(TDEF, batch_size=8, device="cpu")
    jpods, tpods = feature_cluster(j, jt, jw), feature_cluster(t, tt, tw)
    jbatch, _jd, jactive = jax_batch(jpods, j.builder, registered_subset(JDEF), 8)
    tbatch, tdeltas, tactive = torch_batch(tpods, t.builder, TDEF, 8)
    assert jactive == tactive and "DynamicResources" in tactive
    for key in (*DRA_KEYS, "dra_pin_ids", "dra_missing"):
        np.testing.assert_array_equal(tbatch[key], np.asarray(jbatch[key]), err_msg=key)
    assert tbatch["dra_missing"][:7].tolist() == [False] * 4 + [True, False, False]
    assert (tbatch["dra_pin_ids"][3] >= 0).sum() == 1  # the allocated claim pins pod d
    assert (tbatch["dra_claim_ids"][5] >= 0).sum() == 1  # a claim named twice: one slot
    assert t.builder.feature_version()[-2] == t.builder.dra.epoch
    for key in DRA_ROWS:
        np.testing.assert_array_equal(t.builder.host[key], j.builder.host[key], err_msg=key)
    # A batch without a resolved claim carries none of the base features.
    nb, _d, _a = torch_batch(tpods[6:], t.builder, TDEF, 8)
    assert not set(DRA_KEYS) & set(nb)


# -- scheduler level ------------------------------------------------------------------


class FakeClock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def dra_profile(cls):
    return cls(name="dra", filters=("NodeResourcesFit", "DynamicResources"), scorers=(("NodeResourcesFit", 1),))


def gpu_cluster(s, t, w, counts=(2, 1)):
    for i, cnt in enumerate(counts):
        s.add_node(w.make_node(f"n{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110}).obj())
        if cnt:
            s.add_resource_slice(t.ResourceSlice(node_name=f"n{i}", device_class=GPU, count=cnt))


def claim(t, name, count=1):
    return t.ResourceClaim(name=name, device_class=GPU, count=count)


def claim_pod(w, name, claim_name, prio=0):
    return w.make_pod(name).req({"cpu": "1"}).resource_claim(claim_name).priority(prio).obj()


# Scenarios: (build, then) pairs of steps over (scheduler, types, wrappers),
# each step followed by a drain; tests/test_dra.py line numbers.
def sc_gate_until_fit(s, t, w):  # :31
    gpu_cluster(s, t, w, counts=(2, 0))
    for i in range(3):
        s.add_resource_claim(claim(t, f"c{i}"))
        s.add_pod(claim_pod(w, f"p{i}", f"c{i}"))


def sc_missing_claim(s, t, w):  # :47
    gpu_cluster(s, t, w)
    s.add_pod(claim_pod(w, "p", "late-claim"))


def then_missing_claim(s, t, w):
    s.add_resource_claim(claim(t, "late-claim"))


def sc_allocated_pins(s, t, w):  # :60
    gpu_cluster(s, t, w, counts=(1, 1))
    s.add_resource_claim(claim(t, "shared"))
    s.add_pod(claim_pod(w, "first", "shared"))


def then_allocated_pins(s, t, w):
    s.add_pod(claim_pod(w, "second", "shared"))


def sc_freed_on_delete(s, t, w):  # :74
    gpu_cluster(s, t, w, counts=(1, 0))
    s.add_resource_claim(claim(t, "c0"))
    s.add_resource_claim(claim(t, "c1"))
    s.add_pod(claim_pod(w, "p0", "c0"))


def then_freed_on_delete(s, t, w):
    s.add_pod(claim_pod(w, "p1", "c1"))


def then2_freed_on_delete(s, t, w):
    s.delete_pod("default/p0")


def sc_slice_before_node(s, t, w):  # :91
    s.add_resource_slice(t.ResourceSlice(node_name="late", device_class=GPU, count=1))
    s.add_node(w.make_node("late").capacity({"cpu": "8", "pods": 110}).obj())
    s.add_resource_claim(claim(t, "c"))
    s.add_pod(claim_pod(w, "p", "c"))


def sc_shared_claim(s, t, w):  # :102
    gpu_cluster(s, t, w, counts=(1,))
    s.add_resource_claim(claim(t, "shared"))
    s.add_pod(claim_pod(w, "a", "shared"))
    s.add_pod(claim_pod(w, "b", "shared"))


def then_shared_claim(s, t, w):
    s.delete_pod("default/a")
    s.add_resource_claim(claim(t, "want"))
    s.add_pod(claim_pod(w, "c", "want"))


def then2_shared_claim(s, t, w):
    s.delete_pod("default/b")


def sc_shortage_preemptible(s, t, w):  # :130
    gpu_cluster(s, t, w, counts=(1,))
    s.add_resource_claim(claim(t, "held"))
    s.add_pod(claim_pod(w, "holder", "held", prio=1))


def then_shortage_preemptible(s, t, w):
    s.add_resource_claim(claim(t, "wanted"))
    s.add_pod(claim_pod(w, "vip", "wanted", prio=100))


def sc_external_allocation(s, t, w):  # :151
    gpu_cluster(s, t, w, counts=(2,))
    s.add_resource_claim(t.ResourceClaim(name="ext", device_class=GPU, count=1, allocated_node="n0",
                                         reserved_for=("other-scheduler/pod",)))
    s.add_resource_claim(claim(t, "big", count=2))
    s.add_pod(claim_pod(w, "pbig", "big"))


def then_external_allocation(s, t, w):
    s.add_resource_claim(claim(t, "one", count=1))
    s.add_pod(claim_pod(w, "pone", "one"))


def then2_external_allocation(s, t, w):
    s.add_pod(claim_pod(w, "pext", "ext"))


def then3_external_allocation(s, t, w):
    s.delete_pod("default/pext")


def sc_claim_before_node(s, t, w):  # :186
    s.add_resource_claim(t.ResourceClaim(name="early", device_class=GPU, count=2, allocated_node="late-node",
                                         reserved_for=("elsewhere/pod",)))
    s.add_resource_slice(t.ResourceSlice(node_name="late-node", device_class=GPU, count=2))
    s.add_node(w.make_node("late-node").capacity({"cpu": "8", "pods": 110}).obj())
    s.add_resource_claim(claim(t, "want", count=1))
    s.add_pod(claim_pod(w, "p", "want"))


def sc_stale_echo(s, t, w):  # :208
    gpu_cluster(s, t, w, counts=(1,))
    s.add_resource_claim(claim(t, "c", count=1))
    s.add_pod(claim_pod(w, "p", "c"))


def then_stale_echo(s, t, w):
    s.add_resource_claim(claim(t, "c", count=1))
    s.add_resource_claim(claim(t, "c2", count=1))
    s.add_pod(claim_pod(w, "p2", "c2"))


# tests/test_dra_structured.py, on its "dra" profile.
def build_structured(s, t, w):  # :241 build_cluster
    specs = [
        ("n0", "30", make_devices(t, [16, 16], ["ada", "ada"], [False, False])),
        ("n1", "22", make_devices(t, [40, 80], ["hopper", "hopper"], [True, True])),
        ("n2", "14", make_devices(t, [80], ["hopper"], [False])),
        ("n3", "6", make_devices(t, [40, 16, 80], ["ada", "hopper", "hopper"], [True, False, True])),
    ]
    for name, cpu, devs in specs:
        s.add_node(w.make_node(name).capacity({"cpu": cpu, "memory": "64Gi", "pods": 110}).obj())
        s.add_resource_slice(t.ResourceSlice(node_name=name, device_class=GPU, devices=devs))


def sc_selector_restricts(s, t, w):  # :267
    build_structured(s, t, w)
    s.add_resource_claim(t.ResourceClaim(name="linked", requests=(
        t.DeviceRequest("r0", GPU, count=2, selectors=(HOPPER_LINKED,)),)))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).resource_claim("linked").obj())


def sc_structured_mix(s, t, w):  # :295
    build_structured(s, t, w)
    shapes = [(), (BIG_MEM,), (HOPPER_LINKED,)]
    for i in range(8):
        s.add_resource_claim(t.ResourceClaim(name=f"c{i}", requests=(
            t.DeviceRequest("r0", GPU, count=1, selectors=shapes[i % 3]),)))
        s.add_pod(w.make_pod(f"p{i}").req({"cpu": "1"}).resource_claim(f"c{i}").obj())


CAP_OR_ADA = 'device.capacity["memory"] >= quantity("40Gi") || device.attributes["arch"].string == "ada"'


def sc_capacity_disjunction(s, t, w):  # :377
    gi = 1024**3
    table = {"n0": [(16, "hopper"), (16, "hopper")], "n1": [(80, "hopper"), (16, "ada")],
             "n2": [(40, "blackwell")], "n3": [(16, "ada"), (16, "hopper")]}
    for name, cpu in (("n0", "30"), ("n1", "22"), ("n2", "14"), ("n3", "6")):
        s.add_node(w.make_node(name).capacity({"cpu": cpu, "memory": "64Gi", "pods": 110}).obj())
        devs = tuple(t.Device(name=f"d{i}", attributes={"arch": a}, capacity={"memory": m * gi})
                     for i, (m, a) in enumerate(table[name]))
        s.add_resource_slice(t.ResourceSlice(node_name=name, device_class=GPU, devices=devs))
    for i in range(5):
        s.add_resource_claim(t.ResourceClaim(name=f"c{i}", requests=(
            t.DeviceRequest("r0", GPU, count=2 if i == 0 else 1, selectors=(CAP_OR_ADA,)),)))
        s.add_pod(w.make_pod(f"p{i}").req({"cpu": "1"}).resource_claim(f"c{i}").obj())


def one_gpu_node(s, t, w):  # :526 _dra_sched
    s.add_node(w.make_node("n1").capacity({"cpu": "8", "memory": "16Gi", "pods": 110}).obj())
    s.add_resource_slice(t.ResourceSlice(node_name="n1", device_class=GPU,
                                         devices=make_devices(t, [80], ["hopper"], [True])))


def sc_victim_frees_selector(s, t, w):  # :478
    one_gpu_node(s, t, w)
    s.add_resource_claim(t.ResourceClaim(name="holder", requests=(t.DeviceRequest("r0", GPU, count=1),)))
    s.add_pod(w.make_pod("holder").req({"cpu": "1"}).resource_claim("holder").obj())


def then_victim_frees_selector(s, t, w):
    s.add_resource_claim(t.ResourceClaim(name="wants", requests=(
        t.DeviceRequest("r0", GPU, count=1, selectors=(BIG_MEM,)),)))
    s.add_pod(w.make_pod("wants").req({"cpu": "1"}).resource_claim("wants").obj())


def then2_victim_frees_selector(s, t, w):
    s.delete_pod("default/holder")


def _ext(t, allocated=True):
    kw = dict(allocated_node="n1", allocated_devices=(("r0", "d0"),), reserved_for=("other-pod",)) if allocated else {}
    return t.ResourceClaim(name="ext", requests=(t.DeviceRequest("r0", GPU, count=1, selectors=(BIG_MEM,)),), **kw)


def sc_external_backfill(s, t, w):  # :548
    one_gpu_node(s, t, w)
    s.add_resource_claim(_ext(t))


def then_external_backfill(s, t, w):
    s.add_resource_claim(_ext(t, allocated=False))
    s.add_resource_claim(t.ResourceClaim(name="mine", requests=(
        t.DeviceRequest("r0", GPU, count=1, selectors=(BIG_MEM,)),)))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).resource_claim("mine").obj())


def sc_claim_twice(s, t, w):  # :653
    one_gpu_node(s, t, w)
    s.add_resource_slice(t.ResourceSlice(node_name="n1", device_class=GPU,
                                         devices=make_devices(t, [40], ["ada"], [False])))
    s.add_resource_claim(t.ResourceClaim(name="c", requests=(t.DeviceRequest("r0", GPU, 1),)))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).resource_claim("c").resource_claim("c").obj())


def sc_claim_removals(s, t, w):
    """The claim and slice removals on top of test_dra.py:151's cluster."""
    sc_external_allocation(s, t, w)
    s.add_resource_claim(claim(t, "one", count=1))
    s.add_pod(claim_pod(w, "pone", "one"))


def then_claim_removals(s, t, w):
    s.remove_resource_claim("default/ext")
    s.remove_resource_claim("default/nothing")
    s.add_resource_claim(claim(t, "big", count=2))  # a re-add of an unallocated claim


def then2_claim_removals(s, t, w):
    s.remove_resource_slice(f"n0/{GPU}")
    s.remove_resource_slice(f"n9/{GPU}")


SCENARIOS = {
    "gate_until_fit": ("default", sc_gate_until_fit),
    "missing_claim": ("default", sc_missing_claim, then_missing_claim),
    "allocated_pins": ("default", sc_allocated_pins, then_allocated_pins),
    "freed_on_delete": ("default", sc_freed_on_delete, then_freed_on_delete, then2_freed_on_delete),
    "slice_before_node": ("default", sc_slice_before_node),
    "shared_claim": ("default", sc_shared_claim, then_shared_claim, then2_shared_claim),
    "shortage_preemptible": ("default", sc_shortage_preemptible, then_shortage_preemptible),
    "external_allocation": ("default", sc_external_allocation, then_external_allocation,
                            then2_external_allocation, then3_external_allocation),
    "claim_before_node": ("default", sc_claim_before_node),
    "stale_echo": ("default", sc_stale_echo, then_stale_echo),
    "selector_restricts": ("dra", sc_selector_restricts),
    "structured_mix": ("dra4", sc_structured_mix),
    "capacity_disjunction": ("dra4", sc_capacity_disjunction),
    "victim_frees_selector": ("dra4", sc_victim_frees_selector, then_victim_frees_selector,
                              then2_victim_frees_selector),
    "external_backfill": ("dra4", sc_external_backfill, then_external_backfill),
    "claim_twice": ("dra4", sc_claim_twice),
    "claim_removals": ("default", sc_claim_removals, then_claim_removals, then2_claim_removals),
}


def make_pair(kind, chunk_size=1):
    batch = 4 if kind in ("dra4",) else 8
    jc, tc = FakeClock(), FakeClock()
    jprof = registered_subset(JDEF) if kind == "default" else dra_profile(JProfile)
    tprof = TDEF if kind == "default" else dra_profile(TProfile)
    js = TPUScheduler(profile=jprof, batch_size=batch, chunk_size=chunk_size)
    js.queue._clock = jc
    ts = TorchScheduler(tprof, batch_size=batch, chunk_size=chunk_size, device="cpu",
                        queue=TQueue(backoff=True, clock=tc))
    return (js, jc), (ts, tc)


def drive(s, clock, max_steps=50):
    """schedule_all_pending, stepping the clock to each backoff expiry."""
    out = []
    for _ in range(max_steps):
        out += s.schedule_all_pending()
        expiry = s.queue.next_backoff_expiry()
        if expiry is None:
            break
        clock.now = max(clock.now, expiry)
    return out


def claims_state(s) -> tuple:
    cat = s.builder.dra
    claims = {u: (c.allocated_node, tuple(c.allocated_devices), tuple(sorted(c.reserved_for)))
              for u, c in cat.claims.items()}
    owners = {k: dict(v) for k, v in cat.device_owner.items() if v}
    return (claims, owners, {k: v for k, v in cat.allocated.items() if v}, dict(cat.slices),
            sorted(cat.pools), {k: sorted(v) for k, v in cat.local_reserved.items()},
            dict(cat.row_charged), dict(cat.corrections), dict(cat.pending_external))


def run_scenario(name, chunk_size=1):
    kind, build, *thens = SCENARIOS[name]
    (j, jc), (t, tc) = make_pair(kind, chunk_size)
    build(j, jt, jw)
    build(t, tt, tw)
    jout, tout = drive(j, jc), drive(t, tc)
    for then in thens:
        then(j, jt, jw)
        then(t, tt, tw)
        jout += drive(j, jc)
        tout += drive(t, tc)
    summary = [(o.pod.name, o.node_name, o.feasible_nodes, o.victim_uids) for o in tout]
    assert summary == [(o.pod.name, o.node_name, o.feasible_nodes, o.victim_uids) for o in jout]
    assert claims_state(t) == claims_state(j)
    assert sorted(t.cache.pods) == sorted(j.cache.pods)
    assert t.builder.host_mirror_equal()
    for key in DRA_ROWS:
        np.testing.assert_array_equal(t.builder.host[key], j.builder.host[key], err_msg=key)
    return j, t, tout


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    run_scenario(name)


def test_scenario_outcomes_as_in_the_reference_tests():
    """The port keeps the reference tests' own expectations."""
    _j, t, out = run_scenario("gate_until_fit")
    assert sorted(o.node_name for o in out if o.node_name) == ["n0", "n0"]
    _j, t, out = run_scenario("missing_claim")
    assert out[0].node_name is None and out[0].unschedulable_plugins == {"DynamicResources"}
    assert out[-1].node_name is not None
    _j, t, out = run_scenario("shared_claim")
    assert {o.pod.name: o.node_name for o in out if o.pod.name in "ab"} == {"a": "n0", "b": "n0"}
    assert [o.node_name for o in out if o.pod.name == "c"][-1] == "n0"
    _j, t, out = run_scenario("shortage_preemptible")
    assert "default/holder" not in t.cache.pods and t.builder.dra.claims["default/held"].allocated_node == ""
    _j, t, out = run_scenario("external_allocation")
    row = t.cache.nodes["n0"].row
    assert t.builder.host["dra_alloc"][t.interns.device_classes.id(GPU), row] == 2
    _j, t, out = run_scenario("selector_restricts")
    assert out[0].node_name == "n1" and len(t.builder.dra.claims["default/linked"].allocated_devices) == 2
    _j, t, out = run_scenario("claim_twice")
    assert len(t.builder.dra.claims["default/c"].allocated_devices) == 1
    assert t.builder.dra.allocated[("n1", GPU)] == 1


@pytest.mark.parametrize("name", ["structured_mix", "shared_claim", "gate_until_fit"])
def test_scenario_at_chunk_4_matches_jax(name):
    """Chunked passes: pods with unallocated claims defer behind each other
    and shared claims defer their mate, as in the JAX pass."""
    if SCENARIOS[name][0] == "dra4":
        run_scenario(name, chunk_size=4)
    else:
        run_scenario(name, chunk_size=8)


def test_gate_off_drops_the_plugin():
    """With DynamicResourceAllocation off the plugin exists nowhere: claims
    are neither filtered nor allocated (scheduler.py:159-183)."""
    t = TorchScheduler(TDEF, batch_size=4, device="cpu",
                       feature_gates=FeatureGates((("DynamicResourceAllocation", False),)))
    assert "DynamicResources" not in t.profile.filters and "DynamicResources" not in t.profile.reserve
    gpu_cluster(t, tt, tw, counts=(0, 0))
    t.add_pod(claim_pod(tw, "p", "missing"))
    out = t.schedule_all_pending()
    assert out[0].node_name is not None and not t.builder.dra.claims


def test_reserve_rolls_back_earlier_plugins():
    """A pod whose second Reserve plugin fails has its claims released by
    the first plugin's unreserve, is forgotten and goes to backoff."""
    t = TorchScheduler(TDEF, batch_size=4, device="cpu", queue=TQueue(backoff=True, clock=FakeClock()))
    gpu_cluster(t, tt, tw, counts=(1,))
    t.add_resource_claim(claim(tt, "c"))

    class Refuse:
        name = "VolumeBinding"

        def relevant(self, pod, sched):
            return True

        def reserve(self, pod, node_name, sched):
            return None

        def unreserve(self, undo, sched):
            raise AssertionError("a failed reserve is not unreserved")

    t.reserve_plugins[1] = Refuse()
    t.add_pod(claim_pod(tw, "p", "c"))
    out = t.schedule_batch()
    assert out[0].node_name is None and t.reserve_failures == 1
    c = t.builder.dra.claims["default/c"]
    assert c.allocated_node == "" and c.reserved_for == () and not t.cache.pods
    assert int(t.builder.host["dra_alloc"].sum()) == 0 and t.builder.host_mirror_equal()
    assert t.queue.next_backoff_expiry() is not None
