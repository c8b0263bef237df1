"""The port's batch pass (kubernetes_tpu_torch.engine.pass_.build_pass, plain
versions of the kernels on the CPU) against the JAX build_pass on the same
state, batch, invariants and seed: picks, scores, feasible counts, fail
masks, the post-commit state field by field and the domain tables must all
be equal.  Covers chunk=1 and chunk=8, carried domain tables valid and
invalid, the uniform all-fail shortcut, the nominated-pod overlay, and a
crowded node that makes chunk-mates defer into the fused strict tail."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import build_pass, filter_op_names
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.snapshot import SnapshotBuilder, state_from_numpy, state_to_numpy

ZONE = "topology.kubernetes.io/zone"
JPROF = registered_subset(JDEF)
PORT_KEYS = ("valid", "req", "nonzero", "group", "priority", "nodename_id", "tolerates_unschedulable")


def _cluster(builder, cache, mknode, mkpod, seed, crowd=False):
    rng = np.random.default_rng(seed)
    builder.ensure_topo_key(ZONE)  # non-trivial domain tables
    for i in range(40):
        cap = {"cpu": str(int(rng.choice([2, 4, 8]))), "memory": "16Gi", "pods": int(rng.choice([6, 110]))}
        w = mknode(f"n{i}").capacity(cap).zone(f"z{i % 3}")
        if i % 9 == 4:
            w = w.unschedulable()
        cache.add_node(w.obj())
    if crowd:  # one empty, much larger node that every pod scores best
        cache.add_node(mknode("big").capacity({"cpu": "64", "memory": "256Gi", "pods": 4}).zone("z0").obj())
    for j in range(60):
        cache.add_pod(
            mkpod(f"b{j}").req({"cpu": f"{int(rng.choice([200, 700]))}m", "memory": "1Gi"})
            .label("app", f"a{j % 3}").node(f"n{int(rng.integers(40))}").obj()
        )


def _pods(mkpod, seed, k, uniform=False):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(k):
        if uniform:
            out.append(mkpod(f"u{j}").req({"cpu": "100", "memory": "1Gi"}).label("app", "huge").obj())
            continue
        w = mkpod(f"q{j}").req(
            {"cpu": f"{int(rng.choice([100, 500, 1500, 9000]))}m", "memory": f"{int(rng.choice([1, 2]))}Gi"}
        ).label("app", f"a{j % 4}").priority(int(rng.integers(-2, 2)))
        if j % 7 == 3:
            w = w.toleration("node.kubernetes.io/unschedulable", effect="NoSchedule")
        out.append(w.obj())
    return out


def _setup(seed, k, crowd=False, uniform=False):
    jb = JaxBuilder()
    _cluster(jb, JaxCache(jb), jnode, jpod, seed, crowd)
    tb = SnapshotBuilder(device="cpu")
    _cluster(tb, TorchCache(tb), tnode, tpod, seed, crowd)
    jbatch, _, jactive = jax_batch(_pods(jpod, seed + 100, k, uniform), jb, JPROF, k)
    tbatch, _, tactive = torch_batch(_pods(tpod, seed + 100, k, uniform), tb, TDEF, k)
    assert jactive == tactive
    n = k if not uniform else 1  # a uniform JAX batch broadcasts its template into padding rows
    for key in PORT_KEYS:  # featurization parity on the real rows
        np.testing.assert_array_equal(np.asarray(jbatch[key])[:n], tbatch[key][:n], err_msg=key)
    jbatch["nominated_row"] = np.full(k, -1, np.int32)
    return jb, jactive, jbatch


def _inv(jb, nom_seed=None):
    inv = jb.batch_invariants()
    s = jb.schema
    inv["nom_req"] = np.zeros((s.N, s.R), np.int64)
    inv["nom_cnt"] = np.zeros(s.N, np.int32)
    inv["nom_prio"] = np.full(s.N, -(2**31), np.int32)
    if nom_seed is not None:
        rng = np.random.default_rng(nom_seed)
        hot = rng.choice(40, 10, replace=False)
        inv["nom_req"][hot, 0] = rng.integers(0, 4000, 10)
        inv["nom_cnt"][hot] = 1
        inv["nom_prio"][hot] = rng.integers(-2, 2, 10)
    return inv


def _assert_same(jout, tout, jstate, tstate, jdom=None, tdom=None):
    for f in ("picks", "scores", "feasible_counts", "processed"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy(), np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f
        )
    np.testing.assert_array_equal(
        tout.fail_masks.numpy().astype(np.int64), np.asarray(jout.fail_masks).astype(np.int64)
    )
    got = state_to_numpy(tstate)
    for f in dataclasses.fields(jstate):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jstate, f.name)), err_msg=f.name)
    if jdom is not None:
        np.testing.assert_array_equal(tdom[0].numpy(), np.asarray(jdom[0]))
        np.testing.assert_array_equal(tdom[1].numpy(), np.asarray(jdom[1]))


def _run_both(jb, active, jbatch, chunk, seed_base, inv, carry=None):
    """One pass on each side from the same state.  ``carry``: None for the
    plain signature, else (jax_dom, torch_dom, valid) for carry_dom."""
    jstate0 = jb.state()
    tstate = state_from_numpy({f.name: np.asarray(getattr(jstate0, f.name))
                               for f in dataclasses.fields(jstate0)}, "cpu")
    tbatch = {k: np.asarray(jbatch[k]) for k in (*PORT_KEYS, "nominated_row", "step_offset", "uniform_all")
              if k in jbatch}
    s = jb.schema
    if carry is None:
        jst, jout = jax_build_pass(JPROF, s, jb.res_col, active, chunk)(jstate0, jbatch, inv, np.uint32(seed_base))
        tst, tout = build_pass(TDEF, s, jb.res_col, active, chunk)(tstate, tbatch, inv, seed_base)
        _assert_same(jout, tout, jst, tst)
        return jst, jout, None, None
    jdom_in, tdom_in, valid = carry
    jst, jout, jdom = jax_build_pass(JPROF, s, jb.res_col, active, chunk, carry_dom=True)(
        jstate0, jbatch, inv, np.uint32(seed_base), jdom_in[0], jdom_in[1], np.bool_(valid))
    tst, tout, tdom = build_pass(TDEF, s, jb.res_col, active, chunk, carry_dom=True)(
        tstate, tbatch, inv, seed_base, tdom_in[0], tdom_in[1], valid)
    _assert_same(jout, tout, jst, tst, jdom, tdom)
    return jst, jout, jdom, tdom


@pytest.mark.parametrize("chunk,nom_seed", [(1, None), (8, None), (8, 11)])
def test_pass_matches_jax(chunk, nom_seed):
    jb, active, jbatch = _setup(3, 32)
    jbatch["nominated_row"] = np.where(np.arange(32) % 5 == 1, np.arange(32) % 40, -1).astype(np.int32)
    _jst, jout, _, _ = _run_both(jb, active, jbatch, chunk, 7, _inv(jb, nom_seed))
    picks = np.asarray(jout.picks)
    assert (picks >= 0).any() and (picks == -1).any()  # placements and failures
    names = filter_op_names(TDEF, active)
    assert names == ["NodeUnschedulable", "NodeName", "NodeResourcesFit"]


def test_carried_domain_tables_across_three_batches():
    """Batch 1 rebuilds the tables (carry invalid); batches 2 and 3 carry
    the previous batch's tables (valid) — every table equal to JAX's."""
    jb, active, jbatch = _setup(4, 32)
    inv = _inv(jb)
    s = jb.schema
    jdom = (jnp.zeros((s.G, s.TK, s.DV), jnp.float32), jnp.zeros((s.ET, s.DV), jnp.float32))
    tdom = (torch.zeros((s.G, s.TK, s.DV)), torch.zeros((s.ET, s.DV)))
    valid = False
    for b in range(3):
        jst, jout, jdom, tdom = _run_both(jb, active, jbatch, 8, 100 * b, inv, (jdom, tdom, valid))
        # Adopt the committed state on the JAX builder (the scheduler's
        # absorb_device_state) so the next batch starts from it.
        jb.absorb_device_state(jst)
        valid = True
    assert float(np.asarray(jdom[0]).sum()) > 0


def test_uniform_all_fail_shortcut():
    jb, active, jbatch = _setup(5, 16, uniform=True)
    jbatch["uniform_all"] = np.bool_(True)
    _jst, jout, _, _ = _run_both(jb, active, jbatch, 8, 3, _inv(jb))
    assert (np.asarray(jout.picks) == -1).all()
    assert (np.asarray(jout.fail_masks)[:16] != 0).all()


def test_crowded_node_defers_into_fused_tail():
    jb, active, jbatch = _setup(6, 32, crowd=True)
    jst, jout, _, _ = _run_both(jb, active, jbatch, 8, 0, _inv(jb))
    big = jb.interns.node_names.get("big")
    row = int(np.nonzero(np.asarray(jst.name_id) == big)[0][0])
    assert int(np.asarray(jst.num_pods)[row]) == 4  # filled exactly to its pod cap
    assert (np.asarray(jout.picks) >= 0).sum() > 4


def test_unported_op_in_pass_raises():
    jb = JaxBuilder()
    with pytest.raises(NotImplementedError):
        build_pass(TDEF, jb.schema, jb.res_col, frozenset({"NodeResourcesFit", "NodePorts"}), 8)
    with pytest.raises(NotImplementedError):
        build_pass(dataclasses.replace(TDEF, percentage_of_nodes_to_score=50), jb.schema, jb.res_col)


@pytest.mark.parametrize("key", ["dra_claim_ids", "port_keys"])
def test_conflict_pair_feature_raises(key):
    """A batch feature from which the JAX pass derives conflict pairs is
    refused, not read as 'no pairs'."""
    jb, active, jbatch = _setup(3, 16)
    jstate = jb.state()
    tstate = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name))
                               for f in dataclasses.fields(jstate)}, "cpu")
    tbatch = {k: np.asarray(jbatch[k]) for k in (*PORT_KEYS, "nominated_row")}
    tbatch[key] = np.zeros((16, 2), np.int32)
    with pytest.raises(NotImplementedError, match=key):
        build_pass(TDEF, jb.schema, jb.res_col, active, 8)(tstate, tbatch, _inv(jb), 0)


def test_hash_matches_jax():
    from kubernetes_tpu.engine.pass_ import _hash_u32
    from kubernetes_tpu_torch.kernels.plain import hash_u32

    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    want = np.asarray(_hash_u32(jnp.asarray(x.astype(np.uint32)))).astype(np.int64)
    got = hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert jax.devices()[0].platform == "cpu"
