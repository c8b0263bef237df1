"""The port's batch pass with InterPodAffinity active (plain versions on the
CPU: eval_chunk, ipa_eval, select_host, resolve_commit with the
affinity-term commit, conflict_pairs) against the JAX build_pass on the
same state, batch, invariants and seed: picks (deferrals included),
scores, feasible counts, fail masks, the post-commit state field by field
and the domain tables must be equal, at chunk 1 and chunk 16, on zone,
hostname and mixed topology.  The conflict table is held against the JAX
``_conflict_pairs`` chunk by chunk.  Tolerance: none (exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine.pass_ import _conflict_pairs as jax_conflict_pairs
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu_torch.engine.pass_ import build_pass
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.snapshot import state_to_numpy
from test_torch_interpodaffinity import JPROF, _featurized

K = 32  # 24 pods and 8 padding rows


def _both(seed, host_share):
    jb, tb, jstate, jbatch, inv, tstate, tbatch, _keys = _featurized(seed, host_share, K)
    jbatch = dict(jbatch, nominated_row=np.full(K, -1, np.int32))
    tbatch = dict(tbatch, nominated_row=np.full(K, -1, np.int32))
    return jb, tb, jstate, jbatch, inv, tstate, tbatch


@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("seed,host_share", [(11, 0.0), (12, 1.0), (13, 0.4)],
                         ids=["zone", "hostname", "mixed"])
def test_ipa_pass_matches_jax(chunk, seed, host_share):
    jb, tb, jstate, jbatch, inv, tstate, tbatch = _both(seed, host_share)
    active = frozenset(n for n in TDEF.filters + tuple(s for s, _ in TDEF.scorers)
                       if n in {"NodeUnschedulable", "NodeName", "NodeResourcesFit",
                                "NodeResourcesBalancedAllocation", "InterPodAffinity"})
    s = jb.schema
    jrun = jax_build_pass(JPROF, s, jb.res_col, active, chunk, carry_dom=True)
    jst, jout, jdom = jrun(jstate, jbatch, inv, np.uint32(5),
                           jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                           jnp.zeros((s.ET, s.DV), jnp.float32), np.bool_(False))
    trun = build_pass(TDEF, tb.schema, tb.res_col, active, chunk, carry_dom=True, _impl="plain")
    tst, tout, tdom = trun(tstate, tbatch, inv, 5, None, None, False)
    for f in ("picks", "scores", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64),
            err_msg=f)
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(tdom[0].numpy(), np.asarray(jdom[0]))
    np.testing.assert_array_equal(tdom[1].numpy(), np.asarray(jdom[1]))
    picks = np.asarray(jout.picks)
    assert (picks >= 0).any()
    assert np.asarray(jst.et_counts).sum() > np.asarray(jstate.et_counts).sum()  # own terms committed
    if chunk > 1:
        assert (picks == -2).any()  # chunk-mates deferred on affinity conflicts
    ipa_bit = 1 << 3  # NodeUnschedulable, NodeName, NodeResourcesFit, InterPodAffinity
    assert (np.asarray(jout.fail_masks) & ipa_bit).any()


@pytest.mark.parametrize("seed,host_share", [(11, 0.0), (12, 1.0), (13, 0.4)],
                         ids=["zone", "hostname", "mixed"])
def test_conflict_pairs_match_jax(seed, host_share):
    jb, tb, _jstate, jbatch, _inv, _tstate, tbatch = _both(seed, host_share)
    c = 8
    tpf = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tbatch.items()}
    got = plain.conflict_pairs(tpf, K // c, c).numpy()
    valid = tbatch["valid"].reshape(K // c, c)
    for b in range(K // c):
        pf = {k: jnp.asarray(np.asarray(v)[b * c:(b + 1) * c]) for k, v in jbatch.items()
              if np.ndim(v) >= 1}
        want = np.asarray(jax_conflict_pairs(pf, jb.schema))
        # Padding rows never attempt and never defer, so their pairs are
        # read by nobody (the JAX batch pads volume ids with 0, which pairs
        # padding rows with each other).
        real = valid[b][:, None] & valid[b][None, :]
        np.testing.assert_array_equal(got[b] & real, want & real)
    assert got.any()
