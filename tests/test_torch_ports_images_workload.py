"""TorchScheduler(device="cpu") against TPUScheduler on a cut of
default_images_ports_5kn_10kpods (kubernetes_tpu_torch/workloads.py; the
harness has no counterpart): 40 nodes in 3 zones each reporting 50 images
from the 400-image Zipf pool under two names, 64 warm-up and 300 measured
pods from the 40 templates (untagged and unknown references, init
containers, one pod in 32 with a host port, a quarter of those on a
specific hostIP), the default profile, batch 64, chunk 8.  The JAX side
gets the same objects, rebuilt from the workload's plain specs.  Outcomes
must be equal pod for pod and so must the port and image state; every pod
binds, no node holds two pods whose host ports conflict under the
reference rule (HostPortInfo.CheckConflict), and the host mirror equals
the device state.  Also: a fit-only closed-form preemption whose victim
holds a host port releases it exactly as the JAX scheduler does, and
chunk-mates crowding the nodes that hold their image defer into the host
tail and finish there as in the JAX scheduler.  Tolerance: none (exact)."""

import numpy as np

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import fit_only_profile as jfit
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch import workloads as w
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import fit_only_profile as tfit
from kubernetes_tpu_torch.queue import SchedulingQueue as TQueue
from kubernetes_tpu_torch.scheduler import TorchScheduler

from chip_smoke import port_conflicts
from test_torch_volumes import FakeClock, drive

NODES, WARM, MEASURED, BATCH, CHUNK = 40, 64, 300, 64, 8
STATE = ("port_counts", "portkey_counts", "image_ids", "image_sizes", "num_pods", "req")


def jax_node(node):
    out = (jnode(node.name).capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
           .zone(node.metadata.labels[w.ZONE]).region("region-1").obj())
    out.status.images = tuple(jt.ContainerImage(names=im.names, size_bytes=im.size_bytes)
                              for im in node.status.images)
    return out


def jax_pod(name: str, i: int):
    """The JAX twin of w.pod_images_ports(i), renamed."""
    spec = w.images_ports_pod_spec(i)
    pod = jpod(name).req({"cpu": "900m", "memory": "2Gi"}).label("app", f"tmpl-{spec['template']}").obj()
    pod.spec.containers[0].images = spec["refs"][:1]
    pod.spec.containers += [jt.Container(name=f"c{k}", images=(ref,)) for k, ref in enumerate(spec["refs"][1:], 1)]
    if spec["init"] is not None:
        pod.spec.init_containers.append(jt.Container(name="init", images=(spec["init"],)))
    if spec["port"] is not None:
        proto, ip, number = spec["port"]
        pod.spec.containers[0].ports += (jt.ContainerPort(host_port=number, protocol=proto, host_ip=ip),)
    return pod


def _jax():
    jc = FakeClock()
    s = TPUScheduler(profile=registered_subset(JDEF), batch_size=BATCH, chunk_size=CHUNK)
    s.queue._clock = jc
    for node in w.images_nodes(NODES):
        s.add_node(jax_node(node))
    for i in range(WARM):
        s.add_pod(jax_pod(f"warm-{i}", 10**6 + i))
    out = drive(s, jc)
    for i in range(MEASURED):
        s.add_pod(jax_pod(f"pod-{i}", i))
    return s, out + drive(s, jc)


def _torch():
    tc = FakeClock()
    s = TorchScheduler(TDEF, batch_size=BATCH, chunk_size=CHUNK, device="cpu",
                       queue=TQueue(backoff=True, clock=tc))
    for node in w.images_nodes(NODES):
        s.add_node(node)
    for pod in w.warm_pods(WARM, w.pod_images_ports):
        s.add_pod(pod)
    out = drive(s, tc)
    for i in range(MEASURED):
        s.add_pod(w.pod_images_ports(i))
    return s, out + drive(s, tc)


def test_images_ports_cut_matches_jax():
    j, jout = _jax()
    t, tout = _torch()
    assert [(o.pod.name, o.node_name) for o in tout] == [(o.pod.name, o.node_name) for o in jout]
    for key in STATE:
        np.testing.assert_array_equal(t.builder.host[key], j.builder.host[key], err_msg=key)
    bind = {o.pod.name: o.node_name for o in tout}
    assert len(bind) == WARM + MEASURED and all(bind.values())
    assert sum(bool(pr.pod.host_ports()) for pr in t.cache.pods.values()) >= 10
    assert port_conflicts(t) == []
    assert t.builder.host_mirror_equal()
    assert int(t.builder.host["port_counts"].sum()) == int(t.builder.host["portkey_counts"].sum()) > 0
    # The scores moved with the images: not every bound pod scored the same.
    assert len({o.score for o in tout}) > 1


def _preempt(sched, node_fn, pod_fn):
    """Two nodes, each filled by one priority-1 pod (one holds hostPort
    8080), then a priority-100 preemptor that needs a whole node."""
    for i in range(2):
        sched.add_node(node_fn(f"n{i}").capacity({"cpu": "4", "memory": "8Gi", "pods": 110}).obj())
    sched.add_pod(pod_fn("holder").req({"cpu": "3"}).priority(1).host_port(8080).node("n0").obj())
    sched.add_pod(pod_fn("plain").req({"cpu": "3"}).priority(1).start_time(-5.0).node("n1").obj())
    sched.add_pod(pod_fn("vip").req({"cpu": "4"}).priority(100).obj())


def test_fit_only_preemption_releases_victim_host_ports():
    """The closed form evicts the host-port holder (the later start time
    goes first); its port counts come off, equal to JAX's."""
    jc, tc = FakeClock(), FakeClock()
    j = TPUScheduler(profile=jfit(), batch_size=8)
    j.queue._clock = jc
    t = TorchScheduler(tfit(), batch_size=8, device="cpu", queue=TQueue(backoff=True, clock=tc))
    _preempt(j, jnode, jpod)
    _preempt(t, tnode, tpod)
    assert int(t.builder.host["port_counts"].sum()) == 1
    jout, tout = drive(j, jc), drive(t, tc)
    assert [(o.pod.name, o.node_name) for o in tout] == [(o.pod.name, o.node_name) for o in jout]
    assert t.preempted == [("default/holder", "default/vip", "n0")]
    for key in ("port_counts", "portkey_counts", "num_pods", "req"):
        np.testing.assert_array_equal(t.builder.host[key], j.builder.host[key], err_msg=key)
    assert int(t.builder.host["port_counts"].sum()) == 0
    assert t.builder.host_mirror_equal()


def _crowd(sched, node_fn, pod_fn):
    """12 one-pod nodes, three of them holding a 900 MiB image that all 16
    pods name (one in four with hostPort 9100): chunk-mates pick the same
    image nodes and overflow them."""
    for i in range(12):
        nw = node_fn(f"n{i}").capacity({"cpu": "1", "memory": "4Gi", "pods": 110})
        sched.add_node((nw.image("big:v1", 900 * 1024 * 1024) if i < 3 else nw).obj())
    for k in range(16):
        pw = pod_fn(f"p{k}").req({"cpu": "600m"}).container_image("big:v1")
        sched.add_pod((pw.host_port(9100) if k % 4 == 1 else pw).obj())


def test_crowded_image_nodes_defer_into_host_tail():
    """With NodePorts active the strict tail is the scheduler's host tail
    (NodePorts is not pinned-safe): the deferred pods re-run against the
    committed state and bind, score and fail as in the JAX scheduler."""
    j = TPUScheduler(profile=registered_subset(JDEF), batch_size=16, chunk_size=8)
    t = TorchScheduler(TDEF, batch_size=16, chunk_size=8, device="cpu")
    _crowd(j, jnode, jpod)
    _crowd(t, tnode, tpod)
    key = lambda outs: [(o.pod.name, o.node_name, o.score) for o in outs]  # noqa: E731
    tout = t.schedule_all_pending()
    assert key(tout) == key(j.schedule_all_pending())
    assert t.deferred > 0 and sum(o.node_name is None for o in tout) == 4
    for k in ("port_counts", "portkey_counts", "num_pods"):
        np.testing.assert_array_equal(t.builder.host[k], j.builder.host[k], err_msg=k)
    assert port_conflicts(t) == [] and t.builder.host_mirror_equal()
