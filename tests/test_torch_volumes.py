"""The port's volume slice against the JAX package, exactly.

Op level: one seeded mixed cluster goes through both builders (zones and
regions, bound zonal PVs with ``a__b`` value sets, PV node affinity with
ORed terms, term-less PVs, WaitForFirstConsumer classes with static
candidates and with provisioners with and without allowedTopologies, an
Immediate class, a ReadWriteOncePod claim in use, read-only and read-write
device volumes in use, CSI limits hit exactly and volumes already attached,
dangling claims), and pods mixing all of them are featurized by both: every
``vb_*``, ``vz_*``, ``vr_*`` and ``vol_*`` feature must be equal (a volume
feature the port leaves out of a batch must be all padding in the JAX
batch), and the four plain filters must equal the JAX ops vmapped over the
same pods.

Scheduler level: the 16 scenarios of tests/test_volumes.py (and one of
the PV, StorageClass, CSINode and claim removals) run side by side
through TPUScheduler and TorchScheduler(device="cpu") on injected clocks
(the backoff expiries are stepped to, no test sleeps): the same outcomes in
order, the same PV and PVC state in the catalogs, the same claim users,
and host mirrors equal to the device state.  Also the refusals by name:
"wait" provisioning, a preemption with a volume op active, DRA and host
ports still unported.  Tolerance: none (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.ops import volumes as vol_op
from kubernetes_tpu_torch.ops.common import PassContext
from kubernetes_tpu_torch.queue import SchedulingQueue as TQueue
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import SnapshotBuilder, state_to_numpy

ZONE = "topology.kubernetes.io/zone"
REGION = "topology.kubernetes.io/region"
VOL_FILTERS = ("NodeResourcesFit", "VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone")
PREFIXES = ("vb_", "vz_", "vr_", "vol_")
OPS = {"VolumeBinding": vol_op.vb_filter, "VolumeZone": vol_op.vz_filter,
       "VolumeRestrictions": vol_op.vr_filter, "NodeVolumeLimits": vol_op.nvl_filter}


class FakeClock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def vol_profile(cls):
    """tests/test_volumes.py:vol_profile."""
    return cls(name="vol", filters=VOL_FILTERS, scorers=(("NodeResourcesFit", 1),))


def _terms(t, *zone_sets):
    return t.NodeSelector(terms=tuple(
        t.NodeSelectorTerm(match_expressions=(t.NodeSelectorRequirement(ZONE, t.OP_IN, tuple(zs)),))
        for zs in zone_sets))


# -- op level: the mixed cluster -------------------------------------------------


def mixed_cluster(t, w, builder, cache, seed, crowd=False):
    """18 nodes in zones a/b/c, PVs, claims, classes, CSI limits and bound
    pods that use devices and CSI volumes; returns 24 pods to schedule.
    ``crowd`` adds a much larger empty node that every pod scores best, so
    chunk-mates pick the same node."""
    rng = np.random.default_rng(seed)
    cat = builder.volumes
    for i in range(18):
        nw = w.make_node(f"n{i}").capacity({"cpu": "32", "memory": "64Gi", "pods": 110})
        nw = nw.zone("abc"[i % 3]).region("r1" if i < 12 else "r2")
        cache.add_node(nw.obj())
        if i % 2:
            builder.set_csinode_limits(i, t.CSINode(f"n{i}", {"ebs": 2, "pd": 1 + i % 3}))
    if crowd:
        cache.add_node(w.make_node("big").capacity({"cpu": "256", "memory": "1Ti", "pods": 110})
                       .zone("b").region("r1").obj())
        builder.set_csinode_limits(18, t.CSINode("big", {"ebs": 3, "pd": 3}))
    # Classes: a WaitForFirstConsumer class with static PVs, two with
    # provisioners (one limited to zones a and b), an Immediate one.
    cat.add_class(t.StorageClass("local", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    cat.add_class(t.StorageClass("dyn", provisioner="ebs", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER,
                                 allowed_topologies=_terms(t, ["a", "b"])))
    cat.add_class(t.StorageClass("dyn2", provisioner="pd", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    cat.add_class(t.StorageClass("slow"))
    for j, zs in enumerate((["a"], ["b", "c"], ["c"])):
        pv = w.make_pv(f"lpv{j}", storage_class="local", capacity=f"{5 + j}Gi")
        pv.node_affinity = _terms(t, zs, ["a"]) if j == 1 else _terms(t, zs)
        cat.add_pv(pv)
    cat.add_pv(w.make_pv("lpv-free", storage_class="local", capacity="1Gi"))  # no affinity
    # Bound PVs: zonal labels (a value set too), ORed affinity, none, CSI.
    bound = {
        "za": w.make_pv("za", zone="a"),
        "zab": w.make_pv("zab", zone="a__b"),
        "aff": w.make_pv("aff", node_affinity_zone=["b"]),
        "free": w.make_pv("free"),
        "csi0": w.make_pv("csi0", csi_driver="ebs", access_modes=(t.RWX,)),
        "csi1": w.make_pv("csi1", csi_driver="pd"),
        "rwop": w.make_pv("rwop", access_modes=(t.RWOP,)),
    }
    bound["aff"].node_affinity = _terms(t, ["b"], ["c"])
    bound["zab"].labels[REGION] = "r1"
    for name, pv in bound.items():
        pv.claim_ref = f"default/c-{name}"
        cat.add_pv(pv)
        cat.add_pvc(w.make_pvc(f"c-{name}", volume_name=name, access_modes=pv.access_modes))
    for k in range(4):
        cat.add_pvc(w.make_pvc(f"wl{k}", storage_class="local", request="2Gi"))
        cat.add_pvc(w.make_pvc(f"wd{k}", storage_class="dyn"))
        cat.add_pvc(w.make_pvc(f"wp{k}", storage_class="dyn2"))
    cat.add_pvc(w.make_pvc("imm", storage_class="slow"))
    cat.add_pvc(w.make_pvc("lost", volume_name="gone"))
    # Bound pods: device users (read-only and writers), CSI users filling
    # some nodes' limits, the RWOP claim in use.
    for j in range(14):
        pw = w.make_pod(f"b{j}").req({"cpu": "100m"})
        if j % 3 == 0:
            pw = pw.device_volume(f"disk{j % 4}", read_only=bool(j % 2))
        if j % 4 == 1:
            pw = pw.pvc_volume("c-csi0")
        if j % 5 == 2:
            pw = pw.pvc_volume("c-csi1")
        cache.add_pod(pw.node(f"n{(2 * j + 1) % 18}").obj())
    cache.add_pod(w.make_pod("holder").req({"cpu": "100m"}).pvc_volume("c-rwop").node("n0").obj())
    claims = ["c-za", "c-zab", "c-aff", "c-free", "c-csi0", "c-csi1", "c-rwop", "imm", "lost", "missing"]
    claims += [f"w{kind}{k}" for kind in "ldp" for k in range(4)]
    pods = []
    for k in range(24):
        pw = w.make_pod(f"p{k}").req({"cpu": "100m"})
        for _ in range(int(rng.integers(1, 3))):
            if rng.random() < 0.75:
                pw = pw.pvc_volume(claims[int(rng.integers(len(claims)))])
            else:
                pw = pw.device_volume(f"disk{int(rng.integers(5))}", read_only=bool(rng.integers(2)))
        pods.append(pw.obj())
    return pods


def featurized(seed, k=None, crowd=False, profiles=None):
    """Both builders over the mixed cluster, its pods featurized into a
    batch of ``k`` rows (default: the pod count) under ``profiles`` (JAX,
    port; default the volume profile); the volume features, the deltas, the
    schema and the state checked equal."""
    jp, tp = profiles or (vol_profile(JProfile), vol_profile(TProfile))
    jb = JaxBuilder()
    jpods = mixed_cluster(jt, jw, jb, JaxCache(jb), seed, crowd)
    tb = SnapshotBuilder(device="cpu")
    tpods = mixed_cluster(tt, tw, tb, TorchCache(tb), seed, crowd)
    k = k or len(jpods)
    jbatch, jdeltas, jactive = jax_batch(jpods, jb, jp, k)
    tbatch, tdeltas, tactive = torch_batch(tpods, tb, tp, k)
    assert set(VOL_FILTERS) <= tactive and jactive == tactive
    jkeys = sorted(key for key in jbatch if key.startswith(PREFIXES))
    keys = sorted(key for key in tbatch if key.startswith(PREFIXES))
    n = len(jpods)
    for key in set(jkeys) - set(keys):  # left out: all padding
        fill = {"vol_unbound": 0, "vol_csi_lim": 0, "vol_dev_rw": 0}.get(key, -1)
        assert (np.asarray(jbatch[key])[:n] == fill).all(), key
    assert set(keys) <= set(jkeys)
    for key in keys:
        np.testing.assert_array_equal(np.asarray(jbatch[key]), tbatch[key], err_msg=key)
    for jd, td in zip(jdeltas, tdeltas):
        for key in ("devices", "csivols", "pvcs", "vol_unbound", "vol_csi_lim"):
            assert jd[key] == td[key], key
    assert dataclasses.asdict(jb.schema) == dataclasses.asdict(tb.schema)
    jstate, tstate = jb.state(), tb.state()
    for name, got in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(got, np.asarray(getattr(jstate, name)), err_msg=name)
    return dict(jb=jb, tb=tb, jp=jp, tp=tp, jstate=jstate, tstate=tstate, jbatch=jbatch,
                tbatch=tbatch, keys=keys, jkeys=jkeys, active=tactive)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_features_and_plain_filters_match_jax(seed):
    x = featurized(seed)
    jb, tb, jstate, tstate = x["jb"], x["tb"], x["jstate"], x["tstate"]
    jctx = jcommon.PassContext(profile=x["jp"], schema=jb.schema, static={})
    tctx = PassContext(profile=x["tp"], schema=tb.schema, static={})
    jpf = {key: jnp.asarray(x["jbatch"][key]) for key in x["jkeys"]}
    tpf = {key: torch.from_numpy(np.ascontiguousarray(x["tbatch"][key])) for key in x["keys"]}
    tpf["valid"] = torch.ones(len(x["tbatch"]["valid"]), dtype=torch.bool)
    valid = np.asarray(jstate.valid)
    for name, fn in OPS.items():
        jop = jcommon.get(name)
        jok = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, jctx))(jpf))
        tok = fn(tstate, tpf, tctx).numpy()
        np.testing.assert_array_equal(tok, jok, err_msg=name)
        assert (~jok & valid).any() and (jok & valid).any(), name  # rejects and admits somewhere


def test_grouped_program_edge_cases():
    """A term-less group fails everywhere, a term-less PV passes everywhere,
    vb_feasible false fails everywhere — as the JAX op computes them."""
    jb, tb = JaxBuilder(), SnapshotBuilder(device="cpu")
    jc, tc = JaxCache(jb), TorchCache(tb)
    for b, c, t, w in ((jb, jc, jt, jw), (tb, tc, tt, tw)):
        for i in range(4):
            c.add_node(w.make_node(f"n{i}").capacity({"cpu": "4"}).zone("ab"[i % 2]).obj())
        b.volumes.add_class(t.StorageClass("local", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
        b.volumes.add_pv(w.make_pv("free"))
        b.volumes.add_pvc(w.make_pvc("bound", volume_name="free"))
        b.volumes.add_pvc(w.make_pvc("nothing", storage_class="local"))
    pods = {}
    for t, w, key in ((jt, jw, "j"), (tt, tw, "t")):
        pods[key] = [w.make_pod("ok").pvc_volume("bound").obj(),
                     w.make_pod("empty").pvc_volume("bound").pvc_volume("nothing").obj(),
                     w.make_pod("dangling").pvc_volume("none").obj()]
    jbatch, _, _ = jax_batch(pods["j"], jb, vol_profile(JProfile), 4)
    tbatch, _, _ = torch_batch(pods["t"], tb, vol_profile(TProfile), 4)
    tpf = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tbatch.items()}
    ok = vol_op.vb_filter(tb.state(), tpf, None).numpy()[:3, :4]
    assert ok[0].all() and not ok[1].any() and not ok[2].any()
    for key in ("vb_group", "vb_ngroups", "vb_feasible", "vb_term_valid", "vb_op"):
        np.testing.assert_array_equal(np.asarray(jbatch[key]), tbatch[key], err_msg=key)


# -- scheduler level: the 16 scenarios of tests/test_volumes.py ---------------------


def zoned_nodes(s, w, zones=("a", "b")):
    for z in zones:
        s.add_node(w.make_node(f"n-{z}").capacity({"cpu": "8", "memory": "16Gi", "pods": 110}).zone(z).obj())


def sc_bound_pv_node_affinity(s, t, w):  # :36
    zoned_nodes(s, w)
    s.add_pv(w.make_pv("pv1", storage_class="fast", node_affinity_zone=["b"]))
    s.add_pvc(w.make_pvc("claim", storage_class="fast", volume_name="pv1"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_volume_zone_labels(s, t, w):  # :48
    zoned_nodes(s, w)
    s.add_pv(w.make_pv("pv1", storage_class="", zone="a"))
    s.add_pvc(w.make_pvc("claim", volume_name="pv1"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_zone_label_value_set(s, t, w):  # :59
    zoned_nodes(s, w, zones=("a", "b", "c"))
    s.add_pv(w.make_pv("pv1", zone="a__b"))
    s.add_pvc(w.make_pvc("claim", volume_name="pv1"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_unbound_immediate(s, t, w):  # :72
    zoned_nodes(s, w)
    s.add_storage_class(t.StorageClass(name="slow", binding_mode=t.BINDING_IMMEDIATE))
    s.add_pvc(w.make_pvc("claim", storage_class="slow"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_wffc_binds_on_matching_node(s, t, w):  # :82
    zoned_nodes(s, w)
    s.add_storage_class(t.StorageClass(name="local", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    s.add_pv(w.make_pv("pv-b", storage_class="local", node_affinity_zone=["b"]))
    s.add_pvc(w.make_pvc("claim", storage_class="local"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_wfc_same_batch_race(s, t, w):  # :98
    zoned_nodes(s, w)
    s.add_storage_class(t.StorageClass(name="local", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    s.add_pv(w.make_pv("only-pv", storage_class="local", node_affinity_zone=["a"]))
    s.add_pvc(w.make_pvc("c1", storage_class="local"))
    s.add_pvc(w.make_pvc("c2", storage_class="local"))
    s.add_pod(w.make_pod("p1").req({"cpu": "1"}).pvc_volume("c1").obj())
    s.add_pod(w.make_pod("p2").req({"cpu": "1"}).pvc_volume("c2").obj())


def sc_dynamic_provisioning(s, t, w):  # :117
    zoned_nodes(s, w)
    s.add_storage_class(t.StorageClass(name="dyn", provisioner="ebs.csi.aws.com",
                                       binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER,
                                       allowed_topologies=_terms(t, ["b"])))
    s.add_pvc(w.make_pvc("claim", storage_class="dyn"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_device_volume_conflict(s, t, w):  # :144
    zoned_nodes(s, w)
    s.add_pod(w.make_pod("p1").req({"cpu": "1"}).device_volume("gce-pd-1").obj())
    s.add_pod(w.make_pod("p2").req({"cpu": "1"}).device_volume("gce-pd-1").obj())


def sc_device_volume_both_read_only(s, t, w):  # :158
    s.add_node(w.make_node("n1").capacity({"cpu": "8", "pods": 110}).obj())
    s.add_pod(w.make_pod("p1").req({"cpu": "1"}).device_volume("disk", read_only=True).obj())
    s.add_pod(w.make_pod("p2").req({"cpu": "1"}).device_volume("disk", read_only=True).obj())


def sc_rwop_blocks_second_pod(s, t, w):  # :167
    zoned_nodes(s, w)
    s.add_pv(w.make_pv("pv1", access_modes=(t.RWOP,)))
    s.add_pvc(w.make_pvc("claim", volume_name="pv1", access_modes=(t.RWOP,)))
    s.add_pod(w.make_pod("p1").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_csi_attach_limits(s, t, w):  # :180
    s.add_node(w.make_node("n1").capacity({"cpu": "64", "pods": 110}).obj())
    s.add_node(w.make_node("n2").capacity({"cpu": "64", "pods": 110}).obj())
    s.add_csinode(t.CSINode(name="n1", driver_limits={"ebs.csi.aws.com": 2}))
    s.add_csinode(t.CSINode(name="n2", driver_limits={"ebs.csi.aws.com": 1}))
    s.add_storage_class(t.StorageClass(name="ebs", provisioner="ebs.csi.aws.com",
                                       binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    for i in range(4):
        s.add_pvc(w.make_pvc(f"c{i}", storage_class="ebs"))
        s.add_pod(w.make_pod(f"p{i}").req({"cpu": "1"}).pvc_volume(f"c{i}").obj())


def sc_unsatisfiable_wfc_claim(s, t, w):  # :200
    zoned_nodes(s, w)
    s.add_storage_class(t.StorageClass(name="local", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    s.add_pvc(w.make_pvc("claim", storage_class="local"))
    s.add_pv(w.make_pv("pv1", node_affinity_zone=["a"]))
    s.add_pvc(w.make_pvc("bound-claim", volume_name="pv1"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("bound-claim").pvc_volume("claim").obj())


def sc_rwop_same_batch_race(s, t, w):  # :219
    zoned_nodes(s, w)
    s.add_pv(w.make_pv("pv1", access_modes=(t.RWOP,)))
    s.add_pvc(w.make_pvc("claim", volume_name="pv1", access_modes=(t.RWOP,)))
    s.add_pod(w.make_pod("p1").req({"cpu": "1"}).pvc_volume("claim").obj())
    s.add_pod(w.make_pod("p2").req({"cpu": "1"}).pvc_volume("claim").obj())


def sc_csinode_before_node(s, t, w):  # :232
    s.add_csinode(t.CSINode(name="late", driver_limits={"d1": 1}))
    s.add_node(w.make_node("late").capacity({"cpu": "64", "pods": 110}).obj())
    s.add_storage_class(t.StorageClass(name="c", provisioner="d1", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    for i in range(2):
        s.add_pvc(w.make_pvc(f"c{i}", storage_class="c"))
        s.add_pod(w.make_pod(f"p{i}").req({"cpu": "1"}).pvc_volume(f"c{i}").obj())


def sc_shared_pvc_counts_once(s, t, w):  # :245
    s.add_node(w.make_node("n1").capacity({"cpu": "64", "pods": 110}).obj())
    s.add_csinode(t.CSINode(name="n1", driver_limits={"ebs.csi.aws.com": 1}))
    s.add_pv(w.make_pv("pv1", csi_driver="ebs.csi.aws.com", access_modes=(t.RWX,)))
    s.add_pvc(w.make_pvc("shared", volume_name="pv1", access_modes=(t.RWX,)))
    for i in range(3):
        s.add_pod(w.make_pod(f"p{i}").req({"cpu": "1"}).pvc_volume("shared").obj())


def sc_two_refs_to_one_claim(s, t, w):  # :267
    s.add_node(w.make_node("n1").capacity({"cpu": "64", "pods": 110}).obj())
    s.add_csinode(t.CSINode(name="n1", driver_limits={"d1": 1}))
    s.add_pv(w.make_pv("pv1", csi_driver="d1"))
    s.add_pvc(w.make_pvc("c1", volume_name="pv1"))
    s.add_pod(w.make_pod("p").req({"cpu": "1"}).pvc_volume("c1").pvc_volume("c1").obj())


def sc_object_removals(s, t, w):
    """Beyond tests/test_volumes.py: the informers' removal halves."""
    s.add_node(w.make_node("n1").capacity({"cpu": "64", "pods": 110}).obj())
    s.add_csinode(t.CSINode(name="n1", driver_limits={"d1": 1}))
    s.add_storage_class(t.StorageClass(name="c", provisioner="d1", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    for i in range(2):
        s.add_pvc(w.make_pvc(f"c{i}", storage_class="c"))
        s.add_pod(w.make_pod(f"p{i}").req({"cpu": "1"}).pvc_volume(f"c{i}").obj())
    s.add_storage_class(t.StorageClass(name="c2", provisioner="d2", binding_mode=t.BINDING_WAIT_FOR_FIRST_CONSUMER))
    s.add_pv(w.make_pv("gone-pv"))
    s.add_pvc(w.make_pvc("gone", volume_name="gone-pv"))


def _then_removals(s, t, w):
    s.remove_csinode("n1")  # the limit goes: the parked pod binds
    s.remove_pv("gone-pv")  # its claim is lost
    s.add_pod(w.make_pod("lost").req({"cpu": "1"}).pvc_volume("gone").obj())
    s.remove_storage_class("c2")  # a new claim of the class is unbound Immediate
    s.add_pvc(w.make_pvc("c9", storage_class="c2"))
    s.add_pod(w.make_pod("p9").req({"cpu": "1"}).pvc_volume("c9").obj())
    s.remove_pvc("default/c0")


# A second wave added after the first drain (the scenarios that add pods
# later) and deletions after it, per scenario.
def _then_device_conflict(s, t, w):
    s.add_pod(w.make_pod("p3").req({"cpu": "1"}).device_volume("gce-pd-1").obj())


def _then_rwop(s, t, w):
    s.add_pod(w.make_pod("p2").req({"cpu": "1"}).pvc_volume("claim").obj())


def _then_shared(s, t, w):
    s.delete_pod("default/p0")
    s.delete_pod("default/p1")


SCENARIOS = {
    "bound_pv_node_affinity": (sc_bound_pv_node_affinity, None),
    "volume_zone_labels": (sc_volume_zone_labels, None),
    "zone_label_value_set": (sc_zone_label_value_set, None),
    "unbound_immediate": (sc_unbound_immediate, None),
    "wffc_binds_on_matching_node": (sc_wffc_binds_on_matching_node, None),
    "wfc_same_batch_race": (sc_wfc_same_batch_race, None),
    "dynamic_provisioning": (sc_dynamic_provisioning, None),
    "device_volume_conflict": (sc_device_volume_conflict, _then_device_conflict),
    "device_volume_both_read_only": (sc_device_volume_both_read_only, None),
    "rwop_blocks_second_pod": (sc_rwop_blocks_second_pod, _then_rwop),
    "csi_attach_limits": (sc_csi_attach_limits, None),
    "unsatisfiable_wfc_claim": (sc_unsatisfiable_wfc_claim, None),
    "rwop_same_batch_race": (sc_rwop_same_batch_race, None),
    "csinode_before_node": (sc_csinode_before_node, None),
    "shared_pvc_counts_once": (sc_shared_pvc_counts_once, _then_shared),
    "two_refs_to_one_claim": (sc_two_refs_to_one_claim, None),
    "object_removals": (sc_object_removals, _then_removals),
}


def make_pair(batch_size=8, chunk_size=1):
    jc, tc = FakeClock(), FakeClock()
    js = TPUScheduler(profile=vol_profile(JProfile), batch_size=batch_size, chunk_size=chunk_size)
    js.queue._clock = jc
    ts = TorchScheduler(vol_profile(TProfile), batch_size=batch_size, chunk_size=chunk_size, device="cpu",
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


def catalog(s) -> tuple:
    cat = s.builder.volumes
    pvs = {n: (pv.claim_ref, pv.storage_class, pv.csi_driver, pv.capacity, tuple(pv.access_modes))
           for n, pv in cat.pvs.items()}
    pvcs = {u: (c.volume_name, c.storage_class) for u, c in cat.pvcs.items()}
    users = {u: n for u, n in cat.pvc_users.items() if n}
    unbound = {k: sorted(v) for k, v in cat.unbound.items() if v}
    return pvs, pvcs, users, unbound


def run_scenario(name, batch_size=8, chunk_size=1):
    build, then = SCENARIOS[name]
    (j, jc), (t, tc) = make_pair(batch_size, chunk_size)
    build(j, jt, jw)
    build(t, tt, tw)
    jout, tout = drive(j, jc), drive(t, tc)
    if then is not None:
        then(j, jt, jw)
        then(t, tt, tw)
        jout += drive(j, jc)
        tout += drive(t, tc)
    summary = [(o.pod.name, o.node_name, o.feasible_nodes) for o in tout]
    assert summary == [(o.pod.name, o.node_name, o.feasible_nodes) for o in jout]
    assert catalog(t) == catalog(j)
    assert sorted(t.cache.pods) == sorted(j.cache.pods)
    assert t.builder.host_mirror_equal()
    for key in ("dev_counts", "dev_rw_counts", "csivol_counts", "csi_used", "csi_limit"):
        np.testing.assert_array_equal(t.builder.host[key], j.builder.host[key], err_msg=key)
    return j, t, tout


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    run_scenario(name)


def test_scenario_outcomes_as_in_the_reference_tests():
    """The port keeps the reference tests' own expectations."""
    _j, t, out = run_scenario("wffc_binds_on_matching_node")
    assert out[0].node_name == "n-b"
    assert t.builder.volumes.pvcs["default/claim"].volume_name == "pv-b"
    assert t.builder.volumes.pvs["pv-b"].claim_ref == "default/claim"
    _j, t, out = run_scenario("wfc_same_batch_race")
    placed = [o for o in out if o.node_name]
    assert len(placed) == 1 and placed[0].node_name == "n-a" and t.reserve_failures == 1
    _j, t, out = run_scenario("csi_attach_limits")
    placed = sorted(o.node_name for o in out if o.node_name)
    assert placed == ["n1", "n1", "n2"]
    _j, t, out = run_scenario("shared_pvc_counts_once")
    assert [o.node_name for o in out] == ["n1", "n1", "n1"]
    assert int(t.builder.host["csi_used"].max()) == 1
    t.delete_pod("default/p2")
    assert int(t.builder.host["csi_used"].max()) == 0
    _j, t, out = run_scenario("dynamic_provisioning")
    assert out[0].node_name == "n-b" and t.builder.volumes.pvcs["default/claim"].volume_name


@pytest.mark.parametrize("name", ["csi_attach_limits", "wfc_same_batch_race", "device_volume_conflict"])
def test_scenario_at_chunk_4_matches_jax(name):
    """Chunked passes: the attach-limit clash, the PreBind race pairs and
    shared device ids defer the later mate, as in the JAX pass."""
    run_scenario(name, batch_size=8, chunk_size=4)


# -- refusals by name ----------------------------------------------------------------


def test_wait_provisioning_refused():
    t = TorchScheduler(vol_profile(TProfile), batch_size=8, device="cpu")
    with pytest.raises(NotImplementedError, match="wait"):
        t.builder.volumes.wffc_provisioning = "wait"
    assert t.builder.volumes.wffc_provisioning == "sync"


def test_preemption_with_volume_op_refused_by_name():
    t = TorchScheduler(vol_profile(TProfile), batch_size=8, device="cpu")
    t.add_node(tw.make_node("n1").capacity({"cpu": "2", "pods": 110}).obj())
    t.add_pv(tw.make_pv("pv1"))
    t.add_pvc(tw.make_pvc("claim", volume_name="pv1"))
    t.add_pod(tw.make_pod("low").req({"cpu": "2"}).priority(1).node("n1").obj())
    t.add_pod(tw.make_pod("vip").req({"cpu": "2"}).priority(100).pvc_volume("claim").obj())
    with pytest.raises(NotImplementedError, match="VolumeRestrictions"):
        t.schedule_all_pending()
    assert "default/low" in t.cache.pods


@pytest.mark.parametrize("kind", ["claim", "host-port"])
def test_dra_and_host_ports_still_refused(kind):
    t = TorchScheduler(TProfile(), batch_size=4, device="cpu")
    t.add_node(tw.make_node("n1").capacity({"cpu": "4"}).obj())
    pw = tw.make_pod("p").req({"cpu": "1"}).pvc_volume("data")
    pw = pw.resource_claim("gpu") if kind == "claim" else pw.host_port(8080)
    t.add_pod(pw.obj())
    with pytest.raises(NotImplementedError, match="DynamicResources" if kind == "claim" else "NodePorts"):
        t.schedule_batch()


def test_catalog_epoch_keys_the_feature_cache():
    """A catalog change (here a new candidate PV) bumps volumes.epoch, so
    the featurization cache misses and the pod's VolumeBinding program
    grows; with no change the cached features come back unchanged."""
    tb = SnapshotBuilder(device="cpu")
    cache = TorchCache(tb)
    for i in range(3):
        cache.add_node(tw.make_node(f"n{i}").capacity({"cpu": "4"}).zone("abc"[i]).obj())
    tb.volumes.add_class(tt.StorageClass("local", binding_mode=tt.BINDING_WAIT_FOR_FIRST_CONSUMER))
    tb.volumes.add_pv(tw.make_pv("pv-a", storage_class="local", node_affinity_zone=["a"]))
    tb.volumes.add_pvc(tw.make_pvc("claim", storage_class="local"))
    pod = tw.make_pod("p").pvc_volume("claim").obj()
    prof = vol_profile(TProfile)
    first, _, _ = torch_batch([pod], tb, prof, 2)
    token = tb.feature_version()
    again, _, _ = torch_batch([pod], tb, prof, 2)
    assert tb.feature_version() == token
    for key in first:
        np.testing.assert_array_equal(first[key], again[key], err_msg=key)
    tb.volumes.add_pv(tw.make_pv("pv-b", storage_class="local", node_affinity_zone=["b"]))
    assert tb.feature_version() != token
    grown, _, _ = torch_batch([pod], tb, prof, 2)
    assert int(grown["vb_term_valid"][0].sum()) == int(first["vb_term_valid"][0].sum()) + 1
    ok = vol_op.vb_filter(tb.state(), {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in grown.items()},
                          None).numpy()[0, :3]
    assert ok.tolist() == [True, True, False]


def test_batch_without_volumes_carries_no_volume_features():
    """Pods without volumes grow no volume vocabulary and add no volume
    rows to their batch; a device pod among them brings the device pair
    only, equal to the JAX builder's rows, padding lanes included."""
    batches = []
    for types_, wrappers, builder, cache_cls, featurize, profile in (
        (jt, jw, JaxBuilder(), JaxCache, jax_batch, vol_profile(JProfile)),
        (tt, tw, SnapshotBuilder(device="cpu"), TorchCache, torch_batch, vol_profile(TProfile)),
    ):
        cache = cache_cls(builder)
        for i in range(3):
            cache.add_node(wrappers.make_node(f"n{i}").capacity({"cpu": "4"}).obj())
        plain_pods = [wrappers.make_pod(f"p{i}").req({"cpu": "100m"}).obj() for i in range(3)]
        schema = builder.schema
        batch, _, _ = featurize(plain_pods, builder, profile, 8)
        if builder.__class__ is SnapshotBuilder:
            assert not [key for key in batch if key.startswith("vol_")]
            assert builder.schema == schema
        disk = wrappers.make_pod("d").req({"cpu": "100m"}).device_volume("disk0", read_only=True).obj()
        batch, _, _ = featurize(plain_pods + [disk], builder, profile, 8)
        batches.append(batch)
    jbatch, tbatch = batches
    assert sorted(key for key in tbatch if key.startswith("vol_")) == ["vol_dev_ids", "vol_dev_rw"]
    for key in ("vol_dev_ids", "vol_dev_rw"):
        np.testing.assert_array_equal(np.asarray(jbatch[key]), tbatch[key], err_msg=key)
