"""The port's NodePorts against the JAX op: the host-port scenarios of
tests/test_ops_taints_ports.py:114-185 (three pods on two nodes wanting one
port, specific-IP uses against a later wildcard want, two protocols on one
port, the randomized check against the scalar oracle
tests/reference_impl.py node_ports_filter) run by TorchScheduler on the
CPU and by TPUScheduler side by side, bindings and feasible counts equal;
then at op level on a cluster whose bound pods hold wildcard and
specific-IP ports: the port features, the plain filter, the host-port
conflict pairs and the port commit of a chunk, against the JAX featurize,
filter_fn, _conflict_pairs and _commit_chunk.  Tolerance: none (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import _conflict_pairs as jax_conflict_pairs
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import DomTables
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.ops import common as tcommon
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import SnapshotBuilder

from reference_impl import node_ports_filter

PORT_FEATURES = ("port_triples", "port_keys", "port_wild_triples", "port_is_wild")


def _profile(cls):
    return cls(name="ports", filters=("NodePorts", "NodeResourcesFit"), scorers=())


def _two_nodes(s, mknode, n=2):
    for i in range(1, n + 1):
        s.add_node(mknode(f"n{i}").capacity({"cpu": "8", "pods": 110}).obj())


def _conflict(s, mknode, mkpod):
    _two_nodes(s, mknode)
    for name in ("p1", "p2", "p3"):
        s.add_pod(mkpod(name).req({"cpu": "1"}).host_port(8080).obj())


def _protocols(s, mknode, mkpod):
    _two_nodes(s, mknode, 1)
    s.add_pod(mkpod("p1").req({"cpu": "1"}).host_port(53, protocol="UDP").obj())
    s.add_pod(mkpod("p2").req({"cpu": "1"}).host_port(53, protocol="TCP").obj())


def _both(build, batch_size=8):
    j = TPUScheduler(profile=_profile(JProfile), batch_size=batch_size)
    t = TorchScheduler(_profile(TProfile), batch_size=batch_size, device="cpu")
    build(j, jnode, jpod)
    build(t, tnode, tpod)
    jout, tout = j.schedule_all_pending(), t.schedule_all_pending()
    key = lambda outs: [(o.pod.name, o.node_name, o.feasible_nodes) for o in outs]  # noqa: E731
    assert key(tout) == key(jout)
    np.testing.assert_array_equal(t.builder.host["port_counts"], j.builder.host["port_counts"])
    np.testing.assert_array_equal(t.builder.host["portkey_counts"], j.builder.host["portkey_counts"])
    assert t.builder.host_mirror_equal()
    return {o.pod.name: o.node_name for o in tout}, t


def test_host_port_conflict():
    out, _ = _both(_conflict)
    assert {out["p1"], out["p2"]} == {"n1", "n2"}
    assert out["p3"] is None


def test_host_port_wildcard_vs_specific_ip():
    j = TPUScheduler(profile=_profile(JProfile), batch_size=8)
    t = TorchScheduler(_profile(TProfile), batch_size=8, device="cpu")
    for s, mknode in ((j, jnode), (t, tnode)):
        _two_nodes(s, mknode, 1)
    outs = []
    for name, ip in (("p1", "10.0.0.1"), ("p2", "10.0.0.2"), ("p3", "")):
        got = []
        for s, mkpod in ((j, jpod), (t, tpod)):
            s.add_pod(mkpod(name).req({"cpu": "1"}).host_port(9090, host_ip=ip).obj())
            got.append([(o.pod.name, o.node_name, o.feasible_nodes) for o in s.schedule_all_pending()])
        assert got[1] == got[0]
        outs.append(got[1][0][1])
    # Different specific IPs share the port; a wildcard want conflicts.
    assert outs == ["n1", "n1", None]


def test_different_protocols_do_not_conflict():
    out, _ = _both(_protocols)
    assert out == {"p1": "n1", "p2": "n1"}


def _random_pods(mkpod):
    rng = np.random.default_rng(11)
    pods = []
    for i in range(40):
        w = mkpod(f"p{i}").req({"cpu": "1m"})
        for _ in range(int(rng.integers(0, 3))):
            ip = ["", "10.0.0.1", "10.0.0.2"][int(rng.integers(0, 3))]
            w = w.host_port(int(rng.integers(8000, 8004)), host_ip=ip)
        pods.append(w.obj())
    return pods


def _random(s, mknode, mkpod):
    for i in range(6):
        s.add_node(mknode(f"n{i}").capacity({"cpu": "64", "pods": 110}).obj())
    for pod in _random_pods(mkpod):
        s.add_pod(pod)


def test_ports_match_reference_randomized():
    """Replay the picks in order with the scalar oracle: each pick was
    legal and each unschedulable pod had no feasible node."""
    got, _t = _both(_random, batch_size=64)
    on_node: dict[str, list] = {f"n{i}": [] for i in range(6)}
    for p in _random_pods(tpod):
        feas = [n for n in on_node if node_ports_filter(p, on_node[n])]
        pick = got[p.name]
        if pick is None:
            assert not feas, (p.name, feas)
        else:
            assert pick in feas, (p.name, pick, feas)
            on_node[pick].append(p)
    assert any(v is None for v in got.values()) and sum(v is not None for v in got.values()) > 20


# -- op level ----------------------------------------------------------------------


def _port_cluster(mknode, mkpod, cache, seed):
    """10 nodes; 18 bound pods holding wildcard and specific-IP ports of
    TCP 80/8080 and UDP 53; returns 16 pods to schedule with 0-3 wants
    each (duplicates across pods, so chunk-mates share keys)."""
    rng = np.random.default_rng(seed)
    for i in range(10):
        cache.add_node(mknode(f"n{i}").capacity({"cpu": "16", "pods": 110}).obj())
    ports = [("TCP", 80), ("TCP", 8080), ("UDP", 53)]
    ips = ["", "10.0.0.1", "10.0.0.2"]

    def wants(w, count):
        for _ in range(count):
            proto, port = ports[int(rng.integers(len(ports)))]
            w = w.host_port(port, protocol=proto, host_ip=ips[int(rng.integers(len(ips)))])
        return w

    for j in range(18):
        cache.add_pod(wants(mkpod(f"b{j}").req({"cpu": "100m"}), 1).node(f"n{int(rng.integers(10))}").obj())
    return [wants(mkpod(f"q{k}").req({"cpu": "100m"}), int(rng.integers(0, 4))).obj() for k in range(16)]


def _op_inputs(seed, k=16):
    jb, tb = JaxBuilder(), SnapshotBuilder(device="cpu")
    jpods = _port_cluster(jnode, jpod, JaxCache(jb), seed)
    tpods = _port_cluster(tnode, tpod, TorchCache(tb), seed)
    jbatch, _, jactive = jax_batch(jpods, jb, registered_subset(JDEF), k)
    tbatch, tdeltas, tactive = torch_batch(tpods, tb, TDEF, k)
    assert jactive == tactive and "NodePorts" in tactive
    for key in PORT_FEATURES:
        np.testing.assert_array_equal(tbatch[key], np.asarray(jbatch[key]), err_msg=key)
    return jb, tb, jbatch, tbatch


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_filter_matches_jax(seed):
    jb, tb, jbatch, tbatch = _op_inputs(seed)
    jstate, tstate = jb.state(), tb.state()
    for f in ("port_counts", "portkey_counts"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)))
    jop, top = jcommon.get("NodePorts"), tcommon.get("NodePorts")
    jpf = {key: jnp.asarray(np.asarray(jbatch[key])) for key in PORT_FEATURES}
    want = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, None))(jpf))
    tpf = {key: torch.from_numpy(tbatch[key]) for key in PORT_FEATURES}
    got = top.filter(tstate, tpf, None).numpy()
    np.testing.assert_array_equal(got, want)
    assert not want[:16].all() and want[:16].any()


@pytest.mark.parametrize("seed", [1, 2])
def test_conflict_pairs_and_commit_match_jax(seed):
    """Host-port pairs of 8-pod chunks against JAX _conflict_pairs, and the
    port branch of the commit against the JAX _commit_chunk."""
    from kubernetes_tpu.engine.pass_ import DomTables as JDom
    from kubernetes_tpu.engine.pass_ import _commit_chunk as jax_commit

    jb, tb, jbatch, tbatch = _op_inputs(seed)
    c, k = 8, 16
    full = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tbatch.items()}
    got = plain.conflict_pairs(full, k // c, c).numpy()
    for b in range(k // c):
        pf = {key: jnp.asarray(np.asarray(v)[b * c:(b + 1) * c]) for key, v in jbatch.items() if np.ndim(v) >= 1}
        want = np.asarray(jax_conflict_pairs(pf, jb.schema)) & ~np.eye(c, dtype=bool)
        np.testing.assert_array_equal(got[b], want)
    assert got.any()
    # Commit: every pod of the first chunk placed on a node (two per node).
    rows = np.array([0, 0, 3, 3, 5, 5, 9, 9], np.int32)
    jstate, tstate = jb.state(), tb.state()
    s = jb.schema
    jdom = JDom(jnp.zeros((s.N, s.TK, s.DV), jnp.float32), jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                jnp.zeros((s.ET, s.DV), jnp.float32), jnp.zeros((s.ET, s.N), jnp.int32),
                jnp.zeros(s.ET, jnp.int32), jnp.zeros(s.ET, jnp.bool_))
    jpf = {key: jnp.asarray(np.asarray(v)[:c]) for key, v in jbatch.items() if np.ndim(v) >= 1}
    jst, _ = jax_commit(jstate, jdom, jpf, jnp.asarray(rows), jnp.ones(c, jnp.bool_))
    tdom = DomTables(torch.zeros((s.G, s.TK, s.DV)), torch.zeros((s.ET, s.DV)),
                     torch.zeros(s.ET, dtype=torch.int32), torch.zeros(s.ET, dtype=torch.bool))
    tpf = {key: v[:c] for key, v in full.items()}
    plain.resolve_commit(tstate, tdom, tpf, torch.from_numpy(rows), None, True)
    for f in ("port_counts", "portkey_counts", "num_pods"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)
    assert int(tstate.port_counts.sum()) > 18
