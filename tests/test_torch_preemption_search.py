"""Preemption's what-if search in the port against the JAX package.

The dry-run pass (plain versions on the CPU) against JAX
``build_preempt_pass(...).run`` from the same seeded cluster, batch and
victim pack, with each op of the search alone (NodePorts,
InterPodAffinity, PodTopologySpread, VolumeRestrictions,
NodeVolumeLimits) and with all five in the default profile, at chunk 1 and
at chunk 8 (the rank split of same-signature mates and the defers of the
others): picks, victim masks, victim counts, the final carry and the final
victim priorities are equal.  The clusters' victims carry label groups,
own anti-affinity terms, host ports (wildcard and specific IP), device
volumes read-write and read-only, CSI volumes of which some are shared by
two victims of a node, and PDBs; one preemptor is ReadWriteOncePod-blocked.
Also: the port's victim pack with its features against the JAX stage, also
after a slot-width growth on the incremental path; the two hard filters'
plain versions; the search kernels' plain versions step by step against the
released state.  Tolerance: exact."""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu import preemption as jpre
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.api.wrappers import make_pvc as jpvc
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_dom as jax_build_dom
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.ops import interpodaffinity as jipa
from kubernetes_tpu.ops import podtopologyspread as jpts
from kubernetes_tpu.ops.common import PassContext as JPassContext
from kubernetes_tpu_torch import preemption as tpre
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.api.wrappers import make_pvc as tpvc
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import DomTables, build_dom
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.kernels import Victims, plain
from kubernetes_tpu_torch.ops import interpodaffinity as tipa
from kubernetes_tpu_torch.ops import podtopologyspread as tpts
from kubernetes_tpu_torch.ops.common import PassContext as TPassContext
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import state_from_numpy
from tests.test_torch_preemption import JPROF, TDEF, make_pair

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
DRIVER = "ebs.csi.aws.com"
BASE = ("NodeUnschedulable", "NodeName", "NodeResourcesFit")
OPS = {
    "ports": BASE + ("NodePorts",),
    "ipa": BASE + ("InterPodAffinity",),
    "spread": BASE + ("PodTopologySpread",),
    "devices": BASE + ("VolumeRestrictions",),
    "csi": BASE + ("VolumeBinding", "NodeVolumeLimits"),
}
VF_KEYS = ("group", "terms", "port_triples", "port_keys", "vol_dev_ids", "vol_dev_rw", "csi_ids", "csi_drv")
PACK_KEYS = ("d_prio", "d_vic_req", "d_vic_nonzero", "d_vic_start", "d_pdb", "d_allowed")


def profiles(case):
    if case == "all":
        return JPROF, TDEF
    kw = dict(filters=OPS[case], scorers=(("NodeResourcesFit", 1),))
    return JProfile(name=case, **kw), TProfile(name=case, **kw)


def cluster(s, mn, mp, mpvc, T, seed, nodes=16):
    """``nodes`` nodes of 4 CPU in 4 zones, each attaching at most two
    volumes of the CSI driver, filled with bound pods of priority 1-39:
    label groups (app web/db/batch, some tier=noisy), required
    anti-affinity to app=svc at the hostname on some, host ports 8080 on
    the wildcard and 9090 on 10.0.0.1, device volumes disk-0..2 read-write
    or read-only, and CSI claims of which node i's shared claim is held by
    two of its pods; priority-500 app=svc pods sit on nodes of zones 0 and
    1 (not victims of any preemptor here), a claim with ReadWriteOncePod
    is in use, and two PDBs (db with no disruption left, web with one)."""
    rng = np.random.default_rng(seed)
    s.add_storage_class(T.StorageClass(name="ebs", provisioner=DRIVER,
                                       binding_mode=T.BINDING_WAIT_FOR_FIRST_CONSUMER))
    s.add_pvc(mpvc("rwop", storage_class="ebs", access_modes=(T.RWOP,)))
    for c in ("wanted", "wanted-2"):
        s.add_pvc(mpvc(c, storage_class="ebs"))
    for i in range(nodes):
        s.add_node(mn(f"n{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 110}).zone(f"z{i % 4}").obj())
        s.add_csinode(T.CSINode(name=f"n{i}", driver_limits={DRIVER: 2}))
        s.add_pvc(mpvc(f"shared-{i}", storage_class="ebs"))
    for i in range(nodes):
        shared = 0
        for j in range(int(rng.integers(1, 5))):
            w = mp(f"v{i}-{j}").req({"cpu": "1", "memory": "1Gi"}).priority(int(rng.integers(1, 40)))
            w = w.start_time(float(rng.integers(0, 9)) + 0.25 * j).label("app", str(rng.choice(["web", "db", "batch"])))
            r = int(rng.integers(0, 8))
            if r == 0:
                w = w.host_port(8080)
            elif r == 1:
                w = w.host_port(9090, host_ip="10.0.0.1")
            if rng.integers(0, 4) == 0:
                w = w.label("tier", "noisy")
            if rng.integers(0, 5) == 0:
                w = w.pod_anti_affinity_in("app", ["svc"], HOST)
            if rng.integers(0, 4) == 0:
                w = w.device_volume(f"disk-{int(rng.integers(0, 3))}", read_only=bool(rng.integers(0, 2)))
            if shared < 2 and rng.integers(0, 2) == 0:
                w = w.pvc_volume(f"shared-{i}")
                shared += 1
            elif rng.integers(0, 4) == 0:
                s.add_pvc(mpvc(f"own-{i}-{j}", storage_class="ebs"))
                w = w.pvc_volume(f"own-{i}-{j}")
            s.add_pod(w.node(f"n{i}").obj())
    for i, node in enumerate((0, 4, 8, 1)):
        s.add_pod(mp(f"svc-{i}").req({"cpu": "100m"}).priority(500).label("app", "svc").node(f"n{node}").obj())
    s.add_pod(mp("rwop-user").req({"cpu": "100m"}).priority(500).pvc_volume("rwop").node("n3").obj())
    for name, allowed in (("db", 0), ("web", 1)):
        s.add_pdb(T.PodDisruptionBudget(
            name=name, selector=T.LabelSelector(match_labels=(("app", name),)), disruptions_allowed=allowed))


def preemptors(mp, T, case, k):
    """``k`` preemptors: the shapes of the case's op (chunk mates of one
    signature come in runs, so the rank split and the defers both occur)."""
    def svc(name, i):
        w = mp(name).req({"cpu": "2", "memory": "2Gi"}).priority(100).label("app", "svc")
        kind = i % 8
        if case in ("ports", "all") and kind in (0, 1, 2):
            w = w.host_port(8080)
        if case in ("ports", "all") and kind == 3:
            w = w.host_port(9090, host_ip="10.0.0.1")
        if case in ("ipa", "all") and kind in (0, 1, 4):
            w = w.pod_anti_affinity_in("tier", ["noisy"], HOST)
        if case in ("ipa", "all") and kind == 5:
            w = w.pod_affinity_in("app", ["web"], ZONE)
        if case in ("ipa", "all") and kind == 6:
            w = w.pod_anti_affinity_in("app", ["db"], ZONE)
        if case in ("spread", "all") and kind in (0, 1, 2, 5):
            w = w.spread_constraint(1, ZONE, T.DO_NOT_SCHEDULE, "app", ["svc"])
        if case in ("spread", "all") and kind == 6:
            w = w.spread_constraint(1, HOST, T.DO_NOT_SCHEDULE, "app", ["svc"])
        if case in ("devices", "all") and kind in (0, 1, 4):
            w = w.device_volume("disk-1")
        if case in ("devices", "all") and kind == 5:
            w = w.device_volume("disk-2", read_only=True)
        if case in ("csi", "all") and kind in (0, 1, 2):
            w = w.pvc_volume("wanted")
        if case in ("csi", "all") and kind == 6:
            w = w.pvc_volume("wanted").pvc_volume("wanted-2")
        if case in ("devices", "csi", "all") and kind == 7:
            w = w.pvc_volume("rwop")
        return w.obj()

    order = [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 0, 0, 1, 1, 6, 5]
    return [svc(f"p{i}", order[i % len(order)]) for i in range(k)]


def victims_of(pack) -> Victims:
    vf = {key: torch.from_numpy(np.array(pack["d_vfeat"][key])) for key in VF_KEYS if key in pack["d_vfeat"]}
    return Victims(*(torch.from_numpy(np.array(pack[key])) for key in PACK_KEYS), vf)


def setup(case, seed, k):
    jp, tp = profiles(case)
    (j, _jc), (t, _tc) = make_pair(batch_size=k, profile=(jp, tp))
    cluster(j, jnode, jpod, jpvc, jt, seed)
    cluster(t, tnode, tpod, tpvc, tt, seed)
    jpods, tpods = preemptors(jpod, jt, case, k), preemptors(tpod, tt, case, k)
    jb, _, jactive = jax_batch(jpods, j.builder, j.profile, k)
    tb, _, tactive = torch_batch(tpods, t.builder, t.profile, k)
    assert jactive == tactive
    return j, t, jpods, jb, tb, jactive


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("case", ["ports", "ipa", "spread", "devices", "csi", "all"])
def test_search_pass_matches_jax(case, chunk):
    k = 16
    j, t, jpods, jb, tb, active = setup(case, 3, k)
    jpack = j.preemption.pack_victims(j.profile, active)
    tpack = t.preemption.pack_victims(t.profile, active)
    want_vic = victims_of(jpack)
    for name, a, b in zip(PACK_KEYS, tpack["vic"][:6], want_vic[:6]):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    assert sorted(tpack["vic"].vfeat) == sorted(want_vic.vfeat)
    for key, arr in want_vic.vfeat.items():
        np.testing.assert_array_equal(tpack["vic"].vfeat[key].numpy(), arr.numpy(), err_msg=key)
    sigs, _ = j.preemption._sig_ids(jpods, j.profile, k)
    valid = np.ones(k, np.bool_)
    valid[-1] = False  # an invalid lane rides along
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
    picks = np.asarray(jout.picks)
    assert (picks >= 0).any() and (picks == -1).any()
    if chunk > 1:
        assert (picks == -2).any()


def test_search_reaches_every_op():
    """The scenarios exercise what they claim: in the all-op batch some
    preemptor evicts a host-port holder, a tier=noisy pod, a pod whose
    anti-affinity names app=svc, a device holder and a CSI volume holder;
    and the ReadWriteOncePod-blocked preemptor evicts every lower pod of its
    node."""
    k = 16
    j, t, jpods, _jb, tb, active = setup("all", 3, k)
    assert {"NodePorts", "InterPodAffinity", "PodTopologySpread", "VolumeRestrictions",
            "NodeVolumeLimits", "VolumeBinding"} <= active
    pack = t.preemption.pack_victims(t.profile, active)
    tbatch = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tb.items()}
    tbatch["valid"] = torch.ones(k, dtype=torch.bool)
    sigs, _ = t.preemption._sig_ids(jpods, k)
    tbatch["sig"] = torch.from_numpy(sigs)
    run = tpre.build_preempt_pass(t.profile, t.builder.schema, t.builder.res_col, active, 1, _impl="plain")
    out, _carry, _prio = run(t.builder.state(), tbatch, pack["vic"], inv=t.builder.batch_invariants())
    evicted = []
    for i, pick in enumerate(out.picks.tolist()):
        if pick >= 0:
            vics = pack["per_node"][pick]
            evicted += [vics[s] for s in np.nonzero(out.vic_mask[i].numpy())[0] if s < len(vics)]
    assert any(p.host_ports() for p in evicted)
    assert any(p.metadata.labels.get("tier") == "noisy" for p in evicted)
    assert any(p.spec.affinity and p.spec.affinity.pod_anti_affinity for p in evicted)
    assert any(v.device_id for p in evicted for v in p.spec.volumes)
    assert any(v.pvc for p in evicted for v in p.spec.volumes)
    rwop = [i for i, p in enumerate(jpods) if any(v.pvc == "rwop" for v in p.spec.volumes)]
    i = rwop[0]
    pick = int(out.picks[i])
    if pick >= 0:
        lower = [p for p in pack["per_node"][pick] if p.spec.priority < jpods[i].spec.priority]
        assert int(out.n_victims[i]) == len(lower)


def test_search_steps_match_jax_release():
    """dom_release's plain version equals JAX build_dom of the released
    state, and search_step's HARD_STEP equals the two hard filters, for
    the representative of the all-op batch; each reprieve step keeps the
    carry's release equal to the masked victims' requests."""
    k = 16
    j, t, jpods, jb, tb, active = setup("all", 5, k)
    pack = t.preemption.pack_victims(t.profile, active)
    vic = pack["vic"]
    inv = t.builder.batch_invariants()
    state = t.builder.state()
    spec = tpre.preempt_spec(t.profile, t.builder.schema, t.builder.res_col, active)
    dom = build_dom(state, torch.from_numpy(inv["et_slot"]), torch.from_numpy(inv["et_host"]),
                    t.builder.schema.DV, plain.build_dom)
    pf = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tb.items()}
    pf["valid"] = torch.ones(k, dtype=torch.bool)
    pf["node_bits"] = plain.node_filters(state, pf, spec.ctx)
    carry = plain.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)
    plain.search_step(state, vic, pf, spec, carry, plain.HARD_STEP, dom)
    jstate = j.builder.state()
    jdom = jax_build_dom(jstate, inv["et_slot"], inv["et_host"], j.builder.schema.DV)
    jctx = JPassContext(profile=j.profile, schema=j.builder.schema, static={}, dom=jdom)
    jpf0 = {key: np.asarray(v)[0] for key, v in jb.items()}
    want_hard = ~np.asarray(jipa.hard_filter_fn(jstate, jpf0, jctx)) & ~np.asarray(
        jpts.hard_filter_fn(jstate, jpf0, jctx))
    got_hard = (carry.flags & plain.F_HARD) != 0
    np.testing.assert_array_equal(got_hard.numpy(), want_hard)
    assert not want_hard.all() and want_hard.any()
    for s in [plain.PHASE1, *range(vic.prio.shape[1] - 1, -1, -1)]:
        tent = plain.slot_mask(carry.mask, vic.prio.shape[1])
        if s >= 0:
            tent[:, s] = False
        gd, ed = plain.dom_release(dom, state, vic, carry, s)
        gc, ec = plain.released_counts(state, vic, tent)
        jrel = dataclasses.replace(jstate, group_counts=gc.numpy(), et_counts=ec.numpy())
        want = jax_build_dom(jrel, inv["et_slot"], inv["et_host"], j.builder.schema.DV)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(want.group_dom), err_msg=f"group_dom step {s}")
        np.testing.assert_array_equal(ed.numpy(), np.asarray(want.et_dom), err_msg=f"et_dom step {s}")
        plain.search_step(state, vic, pf, spec, carry, s, dom, DomTables(gd, ed, dom.et_slot, dom.et_host))
        mask = plain.slot_mask(carry.mask, vic.prio.shape[1])
        np.testing.assert_array_equal(
            carry.rel.numpy(), torch.where(mask[:, :, None], vic.req, 0).sum(dim=1).numpy())
        np.testing.assert_array_equal(carry.cnt.numpy(), mask.sum(dim=1).to(torch.int32).numpy())


@pytest.mark.parametrize("which", ["ipa", "spread"])
def test_hard_filters_match_jax(which):
    """The ops' plain hard filters against JAX hard_filter_fn, pod by pod,
    on the all-op cluster (required zone affinity with and without
    matching pods, zone and hostname spread keys, nodes missing the zone
    key)."""
    k = 16
    j, t, jpods, jb, tb, _active = setup("all", 9, k)
    for name in ("nokey-0", "nokey-1"):
        j.add_node(jnode(name).capacity({"cpu": "4", "pods": 110}).obj())
        t.add_node(tnode(name).capacity({"cpu": "4", "pods": 110}).obj())
    jb, _, _ = jax_batch(jpods, j.builder, j.profile, k)
    tb, _, _ = torch_batch(preemptors(tpod, tt, "all", k), t.builder, t.profile, k)
    inv = j.builder.batch_invariants()
    jstate = j.builder.state()
    jdom = jax_build_dom(jstate, inv["et_slot"], inv["et_host"], j.builder.schema.DV)
    jctx = JPassContext(profile=j.profile, schema=j.builder.schema, static={}, dom=jdom)
    state = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate.__dataclass_fields__}, "cpu")
    dom = build_dom(state, torch.from_numpy(np.asarray(inv["et_slot"])),
                    torch.from_numpy(np.asarray(inv["et_host"])), t.builder.schema.DV, plain.build_dom)
    tctx = TPassContext(profile=t.profile, schema=t.builder.schema, static={}, dom=dom)
    pf = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tb.items()}
    jfn, tfn = (jipa.hard_filter_fn, tipa.hard_filter_fn) if which == "ipa" else (jpts.hard_filter_fn,
                                                                                  tpts.hard_filter_fn)
    got = tfn(state, pf, tctx).numpy()
    rejected = 0
    for i in range(k):
        want = np.asarray(jfn(jstate, {key: np.asarray(v)[i] for key, v in jb.items()}, jctx))
        np.testing.assert_array_equal(got[i], want, err_msg=f"pod {i}")
        rejected += int(want.sum())
    assert rejected > 0


def test_victim_pack_after_width_growth_matches_jax():
    """The incremental repack (no PDBs) after a victim widens the device
    and CSI slot widths (tests/test_preemption.py:634) stages the same
    buffer, features and victims as the JAX evaluator."""
    kw = dict(filters=("NodeResourcesFit", "VolumeRestrictions", "VolumeBinding", "NodeVolumeLimits",
                       "InterPodAffinity"), scorers=(("NodeResourcesFit", 1),))
    (j, jc), (t, tc) = make_pair(batch_size=8, profile=(JProfile(name="vol", **kw), TProfile(name="vol", **kw)))
    packs = []
    for s, c, mn, mp, mpvc, T in ((j, jc, jnode, jpod, jpvc, jt), (t, tc, tnode, tpod, tpvc, tt)):
        s.add_storage_class(T.StorageClass(name="ebs", provisioner=DRIVER,
                                           binding_mode=T.BINDING_WAIT_FOR_FIRST_CONSUMER))
        for i in range(3):
            s.add_node(mn(f"n{i}").capacity({"cpu": "64", "pods": 110}).zone(f"z{i}").obj())
        for name in ("a", "b", "c", "d", "e"):
            s.add_pvc(mpvc(name, storage_class="ebs"))
        s.add_pod(mp("holder").req({"cpu": "1"}).priority(1).device_volume("disk-1").pvc_volume("e").node("n1").obj())
        pods = [mp("vip").req({"cpu": "1"}).priority(100).device_volume("disk-1").pvc_volume("d").obj()]
        _b, _d, active = (jax_batch if s is j else torch_batch)(pods, s.builder, s.profile, 8)
        s.preemption.pack_victims(s.profile, active)  # stages 1-wide device slots
        s.add_pod(mp("wide").req({"cpu": "1"}).priority(1).device_volume("disk-2").device_volume("disk-3")
                  .pvc_volume("a").pvc_volume("b").pvc_volume("c").label("app", "x")
                  .pod_anti_affinity_in("app", ["y"], HOST).node("n2").obj())
        packs.append((s.preemption.pack_victims(s.profile, active), s.preemption._stage))
    (jpack, jst), (tpack, tst) = packs
    np.testing.assert_array_equal(tst["buf"], jst["buf"])
    want = victims_of(jpack)
    for name, a, b in zip(PACK_KEYS, tpack["vic"][:6], want[:6]):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    assert sorted(tpack["vic"].vfeat) == sorted(want.vfeat)
    for key, arr in want.vfeat.items():
        np.testing.assert_array_equal(tpack["vic"].vfeat[key].numpy(), arr.numpy(), err_msg=key)
    assert tpack["vic"].vfeat["vol_dev_ids"].shape[2] == 2 and tpack["vic"].vfeat["csi_ids"].shape[2] == 4
    layout = {"r": t.builder.schema.R, "n_pdbs": 1, "pdb_words": 1, "v": jst["v"], "vf_cols": jst["vf_cols"]}
    vic = tpre.victims_from_numpy(jst["buf"], layout, "cpu")
    for key, arr in want.vfeat.items():
        np.testing.assert_array_equal(vic.vfeat[key].numpy(), arr.numpy(), err_msg=key)


def test_dra_preemption_refused_before_any_victim():
    """DynamicResources' release is ported: a dry-run with it active builds,
    and a filter outside the default profile's is still refused by name."""
    prof = TProfile(name="dra", filters=("NodeResourcesFit", "DynamicResources"),
                    scorers=(("NodeResourcesFit", 1),))
    assert tpre.refusal(prof, None) is None and tpre.refusal(TDEF, None) is None
    t = TorchScheduler(TProfile(name="fit", filters=("NodeResourcesFit",), scorers=(("NodeResourcesFit", 1),)),
                       batch_size=4, device="cpu")
    spec = tpre.preempt_spec(prof, t.builder.schema, t.builder.res_col, frozenset(prof.filters))
    assert spec.dra and not spec.domain
    tpre.build_preempt_pass(prof, t.builder.schema, t.builder.res_col, frozenset(prof.filters), 1)
    assert "Unknown" in tpre.refusal(dataclasses.replace(prof, filters=prof.filters + ("Unknown",)), None)
