"""The port's batch pass with the four volume ops active (plain versions on
the CPU: node_filters with VolumeBinding's and VolumeZone's bits,
vol_filter, eval_chunk reading the planes, select_host, resolve_commit with
the device and CSI commit and the attach-limit clash, conflict_pairs with
shared device and CSI ids and PreBind-racing claims) against the JAX
build_pass from the same state, batch, invariants and seed: picks
(deferrals included), scores, feasible counts, fail masks and the
post-commit state field by field (dev_counts, dev_rw_counts, csivol_counts
and csi_used among them) must be equal, at chunk 1 and chunk 8, under the
volume profile and the default profile.  The batch is the mixed cluster of
tests/test_torch_volumes.py with a large node every pod prefers, so
limited chunk-mates pick one node.  The conflict table and the node filter
bits are held against the JAX ``_conflict_pairs`` and the JAX ops'
filters.  Tolerance: none (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine.pass_ import _conflict_pairs as jax_conflict_pairs
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu_torch.engine.pass_ import build_pass
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.ops.common import PassContext
from kubernetes_tpu_torch.snapshot import state_to_numpy
from test_torch_volumes import featurized

K = 32  # 24 pods and 8 padding rows
PROFILES = {"vol": None, "default": (registered_subset(JDEF), TDEF)}


def _both(seed, profile):
    x = featurized(seed, K, crowd=True, profiles=PROFILES[profile])
    for side in ("jbatch", "tbatch"):
        x[side] = dict(x[side], nominated_row=np.full(K, -1, np.int32))
    return x


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("seed,profile", [(31, "vol"), (32, "vol"), (33, "default")])
def test_volume_pass_matches_jax(chunk, seed, profile):
    x = _both(seed, profile)
    jb, tb, active = x["jb"], x["tb"], x["active"]
    inv = jb.batch_invariants()
    s = jb.schema
    jrun = jax_build_pass(x["jp"], s, jb.res_col, active, chunk, carry_dom=True)
    jst, jout, jdom = jrun(x["jstate"], x["jbatch"], inv, np.uint32(7),
                           jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                           jnp.zeros((s.ET, s.DV), jnp.float32), np.bool_(False))
    trun = build_pass(x["tp"], tb.schema, tb.res_col, active, chunk, carry_dom=True, _impl="plain")
    tst, tout, tdom = trun(x["tstate"], x["tbatch"], inv, 7, None, None, False)
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
    before = state_to_numpy(featurized(seed, K, crowd=True, profiles=PROFILES[profile])["tstate"])
    assert (got["csivol_counts"] != before["csivol_counts"]).any()  # CSI attachments committed
    assert (got["csi_used"] != before["csi_used"]).any()
    if chunk > 1:
        assert (picks == -2).any()  # chunk-mates deferred on volume pairs or the limit clash


@pytest.mark.parametrize("seed", [31, 33])
def test_volume_node_filters_and_conflict_pairs_match_jax(seed):
    x = _both(seed, "vol")
    jb, tb, jstate = x["jb"], x["tb"], x["jstate"]
    jctx = jcommon.PassContext(profile=x["jp"], schema=jb.schema, static={})
    tctx = PassContext(profile=x["tp"], schema=tb.schema, static={})
    jpf = {key: jnp.asarray(x["jbatch"][key]) for key in x["jkeys"]}
    tpf = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x["tbatch"].items()}
    bits = plain.node_filters(x["tstate"], tpf, tctx).numpy()
    vbits = plain.vol_filter(x["tstate"], tpf, tctx, True, True).numpy()
    for plane, bit, name in ((bits, 4, "VolumeBinding"), (bits, 8, "VolumeZone"),
                             (vbits, 1, "VolumeRestrictions"), (vbits, 2, "NodeVolumeLimits")):
        jop = jcommon.get(name)
        want = np.asarray(jax.vmap(lambda p: jop.filter(jstate, p, jctx))(jpf))
        np.testing.assert_array_equal((plane & bit) != 0, want, err_msg=name)
        assert not want[:24].all()
    assert ((bits & 3) == 3).all()  # no NodeAffinity or taint features: those bits pass
    c = 8
    got = plain.conflict_pairs(tpf, K // c, c).numpy()
    valid = x["tbatch"]["valid"].reshape(K // c, c)
    for b in range(K // c):
        pf = {k: jnp.asarray(np.asarray(v)[b * c:(b + 1) * c]) for k, v in x["jbatch"].items()
              if np.ndim(v) >= 1}
        want = np.asarray(jax_conflict_pairs(pf, jb.schema))
        real = valid[b][:, None] & valid[b][None, :]
        np.testing.assert_array_equal(got[b] & real, want & real)
    assert got.any()
    for key in ("vol_dev_ids", "vol_csi_ids", "vol_unbound", "vol_csi_lim"):
        assert key in x["tbatch"], key  # every pair source and the clash flag occur
