"""TorchScheduler(device="cpu") against TPUScheduler on cuts of the three
persistent-volume workloads, with the harness's batch shape scaled down
(batch 64, chunk 8) and 50 nodes in 10 zones, 64 warm-up and 200 measured
pods:

  * intree_pvs_5kn_2kpods (kubernetes_tpu/benchmarks/harness.py:664-716):
    every pod's claim pre-bound to its own zonal PV;
  * migrated_intree_pvs_5kn_5kpods (:718-737): the same PVs fronted by a
    CSI driver, every node's CSINode allowing 39 attachments;
  * csi_pvs_5kn_5kpods (:740-792): unbound WaitForFirstConsumer claims of
    one provisioner class, provisioned at PreBind.

The port runs its own copies (kubernetes_tpu_torch/workloads.py); the JAX
side runs the harness's measured feeders and a 64-pod copy of its warm-up.
Both queues run on injected clocks.  Outcomes must be equal pod for pod,
and so must the catalogs (PVs with their claim refs, claims with their
volumes) and the volume counts; every pod binds, each pod with a zonal PV
sits in its PV's zone, csi_used equals the distinct CSI volumes per
(driver, node) and stays within csi_limit, and every CSI claim ends bound
to a provisioned PV that names it.  Tolerance: none (exact)."""

from collections import defaultdict

import numpy as np
import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.api.wrappers import make_pv as jpv
from kubernetes_tpu.api.wrappers import make_pvc as jpvc
from kubernetes_tpu.benchmarks import harness
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import _bucket
from kubernetes_tpu_torch import workloads as w
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.queue import SchedulingQueue as TQueue
from kubernetes_tpu_torch.scheduler import TorchScheduler
from test_torch_volumes import FakeClock, catalog, drive

NODES, ZONES, WARM, MEASURED, BATCH, CHUNK = 50, 10, 64, 200, 64, 8


def _jax_pv_warm(s, total, driver=""):
    """harness.py:_pv_warm with WARM pods."""
    s.builder._ensure(CV=_bucket(total + WARM))
    for i in range(WARM):
        s.add_pv(jpv(f"warmpv-{i}", zone=f"zone-{i % ZONES}", csi_driver=driver))
        s.add_pvc(jpvc(f"warmclaim-{i}", volume_name=f"warmpv-{i}"))
        s.add_pod(jpod(f"warm-{i}").req({"cpu": "100m", "memory": "256Mi"}).pvc_volume(f"warmclaim-{i}").obj())


def _jax_csi_warm(s):
    """harness.py:_csi_warm with WARM pods."""
    s.builder._ensure(CV=_bucket(MEASURED + WARM))
    s.add_storage_class(jt.StorageClass(name="csi-sc", provisioner="ebs.csi.aws.com",
                                        binding_mode=jt.BINDING_WAIT_FOR_FIRST_CONSUMER))
    for i in range(WARM):
        s.add_pvc(jpvc(f"warmcsi-{i}", storage_class="csi-sc"))
        s.add_pod(jpod(f"warm-{i}").req({"cpu": "100m", "memory": "256Mi"}).pvc_volume(f"warmcsi-{i}").obj())


def _jax(name):
    jc = FakeClock()
    s = TPUScheduler(profile=registered_subset(JDEF), batch_size=BATCH, chunk_size=CHUNK)
    s.queue._clock = jc
    harness._basic_nodes(NODES, zones=ZONES)(s)
    if name == "migrated":
        for i in range(NODES):
            s.add_csinode(jt.CSINode(name=f"node-{i}", driver_limits={w.MIGRATED_DRIVER: w.MIGRATED_LIMIT}))
    driver = w.MIGRATED_DRIVER if name == "migrated" else ""
    if name == "csi":
        _jax_csi_warm(s)
    else:
        _jax_pv_warm(s, MEASURED, driver)
    out = drive(s, jc)
    if name == "csi":
        harness._csi_measured(MEASURED)(s)
    else:
        harness._pv_measured(MEASURED, zones=ZONES, driver=driver)(s)
    return s, out + drive(s, jc)


def _torch(name):
    tc = FakeClock()
    s = TorchScheduler(TDEF, batch_size=BATCH, chunk_size=CHUNK, device="cpu",
                       queue=TQueue(backoff=True, clock=tc))
    for node in w.basic_nodes(NODES, zones=ZONES):
        s.add_node(node)
    if name == "migrated":
        for cs in w.migrated_csinodes(NODES):
            s.add_csinode(cs)
    driver = w.MIGRATED_DRIVER if name == "migrated" else ""
    if name == "csi":
        w.csi_warm(s, WARM, table_claims=MEASURED + WARM)
    else:
        w.pv_warm(s, MEASURED, ZONES, driver, count=WARM)
    out = drive(s, tc)
    if name == "csi":
        w.csi_measured(s, MEASURED)
    else:
        w.pv_measured(s, MEASURED, ZONES, driver)
    return s, out + drive(s, tc)


def pv_gates(s, out, expected: int) -> None:
    """The workloads' own gates on the port's result."""
    bind = {o.pod.name: o.node_name for o in out}
    assert len(bind) == expected and all(bind.values())
    cat = s.builder.volumes
    nodes = {name: rec.node for name, rec in s.cache.nodes.items()}
    used = defaultdict(set)  # (driver, node) → distinct claims attached there
    for pr in s.cache.pods.values():
        for pvc in cat.pod_pvcs(pr.pod):
            pv = cat.pvs[pvc.volume_name]
            zone = pv.labels.get("topology.kubernetes.io/zone")
            if zone is not None:
                assert nodes[pr.node_name].metadata.labels[w.ZONE] in zone.split("__")
            driver = cat.pvc_driver(pvc)
            if driver:
                used[(driver, pr.node_name)].add(pvc.uid)
            if pvc.storage_class == w.CSI_CLASS:
                assert pv.claim_ref == pvc.uid and pv.name.startswith("provisioned-")
    h, it = s.builder.host, s.interns
    want = np.zeros_like(h["csi_used"])
    for (driver, node), claims in used.items():
        want[it.drivers.id(driver), s.cache.row_of(node)] = len(claims)
    np.testing.assert_array_equal(h["csi_used"], want)
    assert (h["csi_used"] <= h["csi_limit"]).all()
    assert s.builder.host_mirror_equal()


@pytest.mark.parametrize("name", ["intree", "migrated", "csi"])
def test_pv_workload_cut_matches_jax(name):
    j, jout = _jax(name)
    t, tout = _torch(name)
    assert [(o.pod.name, o.node_name) for o in tout] == [(o.pod.name, o.node_name) for o in jout]
    assert catalog(t) == catalog(j)
    for key in ("dev_counts", "csivol_counts", "csi_used", "csi_limit", "num_pods"):
        np.testing.assert_array_equal(t.builder.host[key], j.builder.host[key], err_msg=key)
    pv_gates(t, tout, WARM + MEASURED)
    if name != "intree":
        assert int(t.builder.host["csi_used"].sum()) == WARM + MEASURED
