"""The port's batch pass with NodePorts and ImageLocality active (plain
versions on the CPU: image_counts and image_scores once per batch,
eval_chunk with the port filter and the image plane, select_host,
resolve_commit with the port commit, conflict_pairs with the port keys)
against the JAX build_pass on the same state, batch, invariants and seed,
under the default profile at chunk 1 and chunk 8: picks (port deferrals
included), feasible counts, fail masks, the scores of the real pods, the
post-commit state field by field (port_counts and portkey_counts among
them) and the domain tables must be equal.  A padding lane's score is not
compared: the JAX pass scores ImageLocality there with ncontainers 0 (a
negative number), the port's plane holds 0.  Then the pinned pass against
JAX ``build_pinned_pass``: ImageLocality on pinned pods (its spread over
the pinned row alone, as the JAX pass's one-row slice takes it), and the
pinned strict commit of host ports under the fit-only profile.  Last, a
DaemonSet whose pods share a hostPort: the pass defers all but one pod
of a chunk, as the JAX pass does, and the packer runs them at width 1.
Tolerance: none (exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.engine.pass_ import build_pinned_pass as jax_pinned_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import fit_only_profile as jfit
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import PINNED_SAFE_OPS, build_pass, build_pinned_pass, filter_op_names
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import fit_only_profile as tfit
from kubernetes_tpu_torch.snapshot import SnapshotBuilder, state_to_numpy

K = 32  # 24 pods and 8 padding lanes
MB = 1024 * 1024
PORTS = [("TCP", 80), ("TCP", 8080), ("UDP", 53)]
IPS = ["", "10.0.0.1"]


def _pool(rng):
    return [(f"repo/app{i}:v1", f"repo/app{i}@sha256:{i:064x}", int(rng.integers(10, 1200)) * MB + i)
            for i in range(8)]


def _cluster(mknode, mkpod, t, cache, seed, ports=True, images=True, pinned=False):
    """16 nodes of 4 CPU in 2 zones, each holding a few of 8 images (some
    under two names), 16 bound pods holding host ports; returns 24 pods
    with 0-2 host-port wants (chunk-mates sharing keys) and 1-3 images."""
    rng = np.random.default_rng(seed)
    pool = _pool(rng)
    for i in range(16):
        node = mknode(f"n{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 110}).zone(f"z{i % 2}").obj()
        for k in rng.choice(8, int(rng.integers(0, 6)), replace=False):
            names = pool[k][:2] if k % 2 else pool[k][:1]
            node.status.images += (t.ContainerImage(names=names, size_bytes=pool[k][2]),)
        cache.add_node(node)

    def with_ports(w, count):
        for _ in range(count):
            proto, port = PORTS[int(rng.integers(len(PORTS)))]
            w = w.host_port(port, protocol=proto, host_ip=IPS[int(rng.integers(len(IPS)))])
        return w

    for j in range(16):
        w = mkpod(f"b{j}").req({"cpu": "500m"})
        cache.add_pod(with_ports(w, 1 if j % 2 else 0).node(f"n{int(rng.integers(16))}").obj())
    pods = []
    for k in range(24):
        w = mkpod(f"p{k}").req({"cpu": f"{int(rng.choice([250, 1000, 1500]))}m", "memory": "1Gi"})
        w = w.label("app", f"a{k % 3}")
        if ports:
            w = with_ports(w, int(rng.integers(0, 3)))
        if pinned:  # pod k pinned to node k mod 16 (which sits on row k mod 16)
            w = w.node_name_affinity(f"n{k % 16}")
        pod = w.obj()
        if images:
            refs = [pool[int(rng.integers(8))][0] for _ in range(int(rng.integers(1, 4)))]
            pod.spec.containers[0].images = tuple(refs[:1])
            pod.spec.containers += [t.Container(name=f"c{c}", images=(r,)) for c, r in enumerate(refs[1:], 1)]
        pods.append(pod)
    return pods


def _setup(seed, jprof, tprof, **kw):
    jb, tb = JaxBuilder(), SnapshotBuilder(device="cpu")
    jpods = _cluster(jnode, jpod, jt, JaxCache(jb), seed, **kw)
    tpods = _cluster(tnode, tpod, tt, TorchCache(tb), seed, **kw)
    jbatch, _, jactive = jax_batch(jpods, jb, jprof, K)
    tbatch, _, tactive = torch_batch(tpods, tb, tprof, K)
    assert jactive == tactive
    for key in ("port_triples", "port_keys", "port_wild_triples", "port_is_wild", "il_image_ids", "il_ncontainers"):
        if key in tbatch:
            np.testing.assert_array_equal(tbatch[key], np.asarray(jbatch[key]), err_msg=key)
    assert dataclasses.asdict(jb.schema) == dataclasses.asdict(tb.schema)
    for side in (jbatch, tbatch):
        side["nominated_row"] = np.full(K, -1, np.int32)
    return jb, tb, jbatch, tbatch, tactive


def _check(jout, tout, jst, tst, tpods=24):
    for f in ("picks", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(tout.scores.numpy()[:tpods], np.asarray(jout.scores)[:tpods])
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("seed", [31, 32])
def test_ports_images_pass_matches_jax(chunk, seed):
    jb, tb, jbatch, tbatch, active = _setup(seed, registered_subset(JDEF), TDEF)
    assert {"NodePorts", "ImageLocality"} <= active
    inv = jb.batch_invariants()
    s = jb.schema
    jrun = jax_build_pass(registered_subset(JDEF), s, jb.res_col, active, chunk, carry_dom=True)
    jst, jout, jdom = jrun(jb.state(), jbatch, inv, np.uint32(5),
                           jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                           jnp.zeros((s.ET, s.DV), jnp.float32), np.bool_(False))
    tinv = dict(inv, image_vocab=len(tb.interns.images))
    trun = build_pass(TDEF, tb.schema, tb.res_col, active, chunk, carry_dom=True, _impl="plain")
    tst, tout, tdom = trun(tb.state(), tbatch, tinv, 5, None, None, False)
    _check(jout, tout, jst, tst)
    np.testing.assert_array_equal(tdom[0].numpy(), np.asarray(jdom[0]))
    picks = np.asarray(jout.picks)
    bit = 1 << filter_op_names(TDEF, active).index("NodePorts")
    assert (picks[:24] >= 0).any() and (np.asarray(jout.fail_masks)[:24] & bit).any()
    assert int(np.asarray(jst.port_counts).sum()) > int(np.asarray(jb.state().port_counts).sum())
    if chunk > 1:
        assert (picks == -2).any()  # chunk-mates deferred on shared port keys


@pytest.mark.parametrize("variant", ["default-images", "fit-only-ports"])
@pytest.mark.parametrize("seed", [41, 42])
def test_pinned_pass_matches_jax(variant, seed):
    """Every pod pinned by matchFields.  default-images: ImageLocality
    scores each pod on its pinned row alone.  fit-only-ports: pods with
    host ports under the fit-only profile; the strict commit adds their
    port counts."""
    if variant == "default-images":
        jprof, tprof, kw = registered_subset(JDEF), TDEF, dict(ports=False)
    else:
        jprof, tprof, kw = jfit(), tfit(), dict(images=False)
    jb, tb, jbatch, tbatch, active = _setup(seed, jprof, tprof, pinned=True, **kw)
    assert active <= PINNED_SAFE_OPS
    assert ("ImageLocality" in active) == (variant == "default-images")
    pin = (np.arange(K) % 16).astype(np.int32)
    pin[3], pin[5], pin[24:] = -1, 6, -1  # a pin naming no node; one its affinity rejects
    for batch in (jbatch, tbatch):
        batch["pin_row"] = pin.copy()
    inv = jb.batch_invariants()
    n, r = jb.schema.N, jb.schema.R
    inv.update(nom_req=np.zeros((n, r), np.int64), nom_cnt=np.zeros(n, np.int32),
               nom_prio=np.full(n, -(2**31), np.int32))
    jst, jout = jax_pinned_pass(jprof, jb.schema, jb.res_col, active)(jb.state(), jbatch, inv)
    trun = build_pinned_pass(tprof, tb.schema, tb.res_col, active, _impl="plain")
    tst, tout = trun(tb.state(), tbatch, {k: torch.from_numpy(v) for k, v in inv.items()})
    for f in ("picks", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f)
    # Scores of the feasible pods (an infeasible pod's score is read by no
    # caller; the port's pinned pass scores it 0).
    feas = np.asarray(jout.feasible_counts) > 0
    np.testing.assert_array_equal(tout.scores.numpy()[feas], np.asarray(jout.scores)[feas])
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)
    assert (np.asarray(jout.picks) >= 0).sum() > 10
    if variant == "fit-only-ports":
        assert int(got["port_counts"].sum()) > int(np.asarray(jb.state().port_counts).sum())
    else:
        assert len(set(np.asarray(jout.scores)[feas].tolist())) > 1


def test_daemonset_host_port_serializes_the_chunk():
    """Host-port pairs conflict on the key whatever the nodes: 64 daemon
    pods, each pinned to its own node and asking for hostPort 9100, defer
    63 of 64 in one chunk of the pass (as in the JAX pass), and the
    scheduler's packer, which sees one conflict class, runs them at width
    1: 64 chunk steps for 64 pods."""
    jb, tb = JaxBuilder(), SnapshotBuilder(device="cpu")
    for mknode, cache in ((jnode, JaxCache(jb)), (tnode, TorchCache(tb))):
        for i in range(64):
            cache.add_node(mknode(f"n{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 110}).obj())
    pods = {side: [mk(f"ds-{i}").req({"cpu": "100m"}).host_port(9100).node_name_affinity(f"n{i}").obj()
                   for i in range(64)] for side, mk in (("j", jpod), ("t", tpod))}
    jbatch, _, active = jax_batch(pods["j"], jb, registered_subset(JDEF), 64)
    tbatch, _, tactive = torch_batch(pods["t"], tb, TDEF, 64)
    assert active == tactive and "NodePorts" in active and not active <= PINNED_SAFE_OPS
    for side in (jbatch, tbatch):
        side["nominated_row"] = np.full(64, -1, np.int32)
    jst, jout = jax_build_pass(registered_subset(JDEF), jb.schema, jb.res_col, active, 64)(
        jb.state(), jbatch, jb.batch_invariants(), np.uint32(0))
    tst, tout = build_pass(TDEF, tb.schema, tb.res_col, active, 64, _impl="plain")(
        tb.state(), tbatch, jb.batch_invariants(), 0)
    _check(jout, tout, jst, tst, 64)
    assert int((tout.picks == -2).sum()) == 63 and int((tout.picks >= 0).sum()) == 1
    from kubernetes_tpu_torch.scheduler import TorchScheduler

    s = TorchScheduler(TDEF, batch_size=64, chunk_size=64, device="cpu")
    for i in range(64):
        s.add_node(tnode(f"n{i}").capacity({"cpu": "4", "memory": "16Gi", "pods": 110}).obj())
    for i in range(64):
        s.add_pod(tpod(f"ds-{i}").req({"cpu": "100m"}).host_port(9100).node_name_affinity(f"n{i}").obj())
    out = s.schedule_all_pending()
    assert all(o.node_name == f"n{o.pod.name[3:]}" for o in out) and len(out) == 64
    assert s.pack_width == 1 and s.deferred == 0 and s.pinned_batches == 0
