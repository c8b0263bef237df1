"""The port's batch pass with DynamicResources active (plain versions on the
CPU: eval_chunk with the DRA filter, select_host, resolve_commit with the
claim-count and pool commit, conflict_pairs with shared claims and racing
unallocated claims) against the JAX build_pass from the same state, batch,
invariants and seed: picks (deferrals included), scores, feasible counts,
fail masks and the post-commit state field by field (dra_claim_counts and
dra_alloc among them) must be equal, at chunk 1 and chunk 64, under the
default profile and a fit-plus-DRA profile.  The cluster is built through
both schedulers' informers: nodes publishing named devices (two models),
a bare and a selector pool, a first wave of bound claim holders, an
externally allocated claim, then a batch of pods with their own claims,
claims shared by two pods, an allocated claim that pins, a missing claim
and a claim named twice.  Tolerance: none (exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.engine.pass_ import build_pass as jax_build_pass
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.engine.pass_ import build_pass
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import state_from_numpy, state_to_numpy

GPU = "gpu.example.com"
H100 = 'device.attributes["model"].string == "h100"'
K = 128  # 100 pods and 28 padding rows
PROFILES = {
    "default": (registered_subset(JDEF), TDEF),
    "dra": (JProfile(name="dra", filters=("NodeResourcesFit", "DynamicResources"),
                     scorers=(("NodeResourcesFit", 1),)),
            TProfile(name="dra", filters=("NodeResourcesFit", "DynamicResources"),
                     scorers=(("NodeResourcesFit", 1),))),
}


def cluster(s, t, w, seed):
    """12 nodes (8 with four GPUs each, models alternating), 16 bound claim
    holders, an external allocation; returns the batch's 100 pods."""
    rng = np.random.default_rng(seed)
    for i in range(12):
        s.add_node(w.make_node(f"n{i}").capacity({"cpu": str(int(rng.choice([8, 16, 32]))), "memory": "64Gi",
                                                  "pods": 110}).obj())
        if i < 8:
            model = "h100" if i % 2 == 0 else "a100"
            devs = tuple(t.Device(name=f"gpu-{j}", attributes={"model": model, "memory": 80 if i % 2 == 0 else 40})
                         for j in range(4))
            s.add_resource_slice(t.ResourceSlice(node_name=f"n{i}", device_class=GPU, devices=devs))

    def claim(name, sel=(), count=1, **kw):
        s.add_resource_claim(t.ResourceClaim(name=name, requests=(t.DeviceRequest("r0", GPU, count, sel),), **kw))

    for j in range(16):
        claim(f"held-{j}", (H100,) if j % 4 == 0 else ())
        s.add_pod(w.make_pod(f"h{j}").req({"cpu": "1"}).resource_claim(f"held-{j}").obj())
    claim("ext", allocated_node="n3", allocated_devices=(("r0", "gpu-3"),), reserved_for=("elsewhere/pod",))
    pods = []
    for j in range(100):
        p = w.make_pod(f"q{j}").req({"cpu": str(int(rng.choice([1, 2])))}).priority(int(rng.integers(0, 3)))
        kind = j % 10
        if kind == 0:
            p = p.resource_claim("held-0")  # allocated: pinned where its holder is
        elif kind == 1:
            p = p.resource_claim(f"pair-{j // 20}")  # shared by two pods of the batch
        elif kind == 2:
            p = p.resource_claim("ghost")  # missing
        elif kind == 3:
            claim(f"own-{j}", count=2)
            p = p.resource_claim(f"own-{j}").resource_claim(f"own-{j}")  # named twice
        elif kind == 4:
            p = p.resource_claim("ext")
        elif kind == 5:
            pass  # no claim
        else:
            claim(f"own-{j}", (H100,) if kind == 6 else ())
            p = p.resource_claim(f"own-{j}")
        pods.append(p.obj())
    for j in range(5):
        claim(f"pair-{j}")
    return pods


def _both(seed, profile):
    jp, tp = PROFILES[profile]
    j = TPUScheduler(profile=jp, batch_size=16)
    t = TorchScheduler(tp, batch_size=16, device="cpu")
    jpods, tpods = cluster(j, jt, jw, seed), cluster(t, tt, tw, seed)
    j.schedule_all_pending()
    t.schedule_all_pending()
    jbatch, _jd, jactive = jax_batch(jpods, j.builder, jp, K)
    tbatch, _td, tactive = torch_batch(tpods, t.builder, tp, K)
    assert jactive == tactive and "DynamicResources" in tactive
    for key in ("dra_claim_ids", "dra_claim_cls", "dra_claim_cnt", "dra_claim_first", "dra_claim_unalloc",
                "dra_pin_ids", "dra_missing"):
        np.testing.assert_array_equal(tbatch[key], np.asarray(jbatch[key]), err_msg=key)
    for key, arr in t.builder.host.items():
        np.testing.assert_array_equal(arr, j.builder.host[key], err_msg=key)
    jbatch["nominated_row"] = np.full(K, -1, np.int32)
    tbatch["nominated_row"] = np.full(K, -1, np.int32)
    return j, jp, tp, jbatch, tbatch, jactive


@pytest.mark.parametrize("chunk", [1, 64])
@pytest.mark.parametrize("seed,profile", [(41, "dra"), (42, "default")])
def test_dra_pass_matches_jax(chunk, seed, profile):
    j, jp, tp, jbatch, tbatch, active = _both(seed, profile)
    jb = j.builder
    inv = jb.batch_invariants()
    s = jb.schema
    jstate = jb.state()
    tstate = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)},
                              "cpu")
    jrun = jax_build_pass(jp, s, jb.res_col, active, chunk, carry_dom=True)
    jst, jout, jdom = jrun(jstate, jbatch, inv, np.uint32(5), jnp.zeros((s.G, s.TK, s.DV), jnp.float32),
                           jnp.zeros((s.ET, s.DV), jnp.float32), np.bool_(False))
    trun = build_pass(tp, s, jb.res_col, active, chunk, carry_dom=True, _impl="plain")
    tst, tout, tdom = trun(tstate, tbatch, inv, 5, None, None, False)
    for f in ("picks", "scores", "feasible_counts", "processed", "fail_masks"):
        np.testing.assert_array_equal(
            getattr(tout, f).numpy().astype(np.int64), np.asarray(getattr(jout, f)).astype(np.int64), err_msg=f)
    got = state_to_numpy(tst)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(jst, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(tdom[0].numpy(), np.asarray(jdom[0]))
    picks = np.asarray(jout.picks)[:100]
    assert (picks >= 0).sum() > 5 and (picks == -1).any()
    assert (got["dra_alloc"] != np.asarray(jstate.dra_alloc)).any()  # claims committed
    if chunk > 1:
        assert (picks == -2).sum() > 20  # racing unallocated claims defer behind their mates
