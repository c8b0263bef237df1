"""The port's batch pass with PodTopologySpread, NodeAffinity and
TaintToleration active (plain versions on the CPU: node_filters,
spread_filter, eval_chunk reading their planes, late_scores, select_host,
resolve_commit, conflict_pairs with spread's group reads) against the JAX
build_pass on the same state, batch, invariants and seed: picks
(deferrals included), scores, feasible counts, fail masks, the post-commit
state field by field and the domain tables must be equal, at chunk 1 and
chunk 8, under the default profile, a profile with addedAffinity and the
spread gates off.  The conflict table and the node filter bits are held
against the JAX ``_conflict_pairs`` and the JAX ops' filters.
Tolerance: none (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine.pass_ import _conflict_pairs as jax_conflict_pairs
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu_torch.engine.pass_ import build_pass
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.snapshot import state_to_numpy
from test_torch_topologyspread import featurized, op_inputs

K = 32  # 24 pods and 8 padding rows


def _both(seed, variant):
    x = featurized(seed, variant, K)
    for side in ("jbatch", "tbatch"):
        x[side] = dict(x[side], nominated_row=np.full(K, -1, np.int32))
    return x


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("seed,variant", [(21, "default"), (22, "added-affinity"), (23, "gates-off")])
def test_spread_pass_matches_jax(chunk, seed, variant):
    x = _both(seed, variant)
    jb, tb, active = x["jb"], x["tb"], x["active"]
    inv = jb.batch_invariants()
    s = jb.schema
    jrun = jax_build_pass(x["jp"], s, jb.res_col, active, chunk, carry_dom=True)
    jst, jout, jdom = jrun(x["jstate"], x["jbatch"], inv, np.uint32(9),
                           jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                           jnp.zeros((s.ET, s.DV), jnp.float32), np.bool_(False))
    trun = build_pass(x["tp"], tb.schema, tb.res_col, active, chunk, carry_dom=True, _impl="plain")
    tst, tout, tdom = trun(x["tstate"], x["tbatch"], inv, 9, None, None, False)
    for f in ("picks", "scores", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64),
            err_msg=f)
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(tdom[0].numpy(), np.asarray(jdom[0]))
    picks = np.asarray(jout.picks)
    assert (picks >= 0).any() and (picks[:24] == -1).any()
    if chunk > 1:
        assert (picks == -2).any()  # chunk-mates deferred on spread's group reads


@pytest.mark.parametrize("seed,variant", [(21, "default"), (22, "added-affinity")])
def test_node_filters_and_conflict_pairs_match_jax(seed, variant):
    x = _both(seed, variant)
    jctx, jpf, tctx, tpf = op_inputs(x)
    jstate = x["jstate"]
    tpf["valid"] = torch.from_numpy(x["tbatch"]["valid"])
    bits = plain.node_filters(x["tstate"], tpf, tctx).numpy()
    for bit, name in ((1, "NodeAffinity"), (2, "TaintToleration")):
        jop = jcommon.get(name)
        want = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, jctx))(jpf))
        np.testing.assert_array_equal((bits & bit) != 0, want, err_msg=name)
        assert not want[:24].all()
    c = 8
    full = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x["tbatch"].items()}
    got = plain.conflict_pairs(full, K // c, c).numpy()
    valid = x["tbatch"]["valid"].reshape(K // c, c)
    for b in range(K // c):
        pf = {k: jnp.asarray(np.asarray(v)[b * c:(b + 1) * c]) for k, v in x["jbatch"].items()
              if np.ndim(v) >= 1}
        want = np.asarray(jax_conflict_pairs(pf, x["jb"].schema))
        real = valid[b][:, None] & valid[b][None, :]
        np.testing.assert_array_equal(got[b] & real, want & real)
    assert got.any()


def test_spread_only_batch_conflict_pairs():
    """A batch with spread but no inter-pod-affinity features builds its
    conflict table from tps_h_groups alone."""
    x = _both(21, "default")
    assert "ipa_ra_allmask" not in x["tbatch"]
    tpf = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x["tbatch"].items()}
    pairs = plain.conflict_pairs(tpf, 1, K)[0]
    groups = tpf["group"].long()
    reads = tpf["tps_h_groups"].any(dim=1)
    want = reads[:, groups].T & ~torch.eye(K, dtype=torch.bool)
    assert torch.equal(pairs, want) and pairs.any()
