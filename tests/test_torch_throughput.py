"""ThroughputAware in the port against the JAX package: the pod features
(the per-class score table and the accelerator slot), the vocabulary
pre-seed, and the plain score (the throughput gather, eval_chunk's term on
the card) against JAX's ``score_fn`` and ``throughput.reference_scores``
on a cluster with every accelerator class, unlabelled nodes and a class the
matrix lacks, for pods of every workload class, an unknown class and none.
Integer scores: exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops import throughput as jtp
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.ops import common as tcommon
from kubernetes_tpu_torch.ops import throughput as ttp
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import state_from_numpy

ACCELS = ("tpu-v4", "tpu-v5e", "gpu-a100", "fpga-x", None)
CLASSES = ("train-large", "train-small", "serve", "batch", "inference-x", None)


def nodes(w):
    out = []
    for i in range(20):
        n = w.make_node(f"n{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110}).zone(f"zone-{i % 3}")
        accel = ACCELS[i % len(ACCELS)]
        if accel is not None:
            n = n.label(jtp.ACCEL_LABEL_KEY, accel)
        out.append(n.obj())
    return out


def pods(w):
    out = []
    for k in range(24):
        p = w.make_pod(f"p{k}").req({"cpu": "100m", "memory": "256Mi"}).label("app", f"a{k % 3}")
        wc = CLASSES[k % len(CLASSES)]
        if wc is not None:
            p = p.label(jtp.WORKLOAD_CLASS_LABEL_KEY, wc)
        out.append(p.obj())
    return out


def _setup(preseed: bool):
    jp, tp = jtp.throughput_aware_profile(), ttp.throughput_aware_profile()
    j = TPUScheduler(profiles=[jp], batch_size=8)
    t = TorchScheduler(profiles=[tp], batch_size=8, device="cpu")
    if preseed:
        jtp.preseed_hetero_vocab(j.builder)
        ttp.preseed_hetero_vocab(t.builder)
    jn, tn = nodes(jw), nodes(tw)
    for a, b in zip(jn, tn):
        j.add_node(a)
        t.add_node(b)
    jpods, tpods = pods(jw), pods(tw)
    for _ in range(2):  # the second pass sees the final vocabularies
        jbatch, _, jactive = jax_batch(jpods, j.builder, jp, 32)
        tbatch, _, tactive = torch_batch(tpods, t.builder, tp, 32)
    assert jactive == tactive and "ThroughputAware" in tactive
    for key in ("tp_scores", "tp_slot"):
        np.testing.assert_array_equal(tbatch[key], np.asarray(jbatch[key]), err_msg=key)
    for key, arr in t.builder.host.items():
        np.testing.assert_array_equal(arr, j.builder.host[key], err_msg=key)
    return j, t, jp, tp, jbatch, tbatch, jn, jpods


def test_throughput_scores_match_jax_and_the_reference():
    for preseed in (False, True):
        j, t, jp, tp, jbatch, tbatch, jn, jpods = _setup(preseed)
        jstate = j.builder.state()
        tstate = state_from_numpy({f.name: np.asarray(getattr(jstate, f.name))
                                   for f in dataclasses.fields(jstate)}, "cpu")
        jctx = jcommon.PassContext(profile=jp, schema=j.builder.schema, static={})
        tctx = tcommon.PassContext(profile=tp, schema=t.builder.schema, static={})
        pf = {k: jnp.asarray(jbatch[k]) for k in ("tp_scores", "tp_slot")}
        want = np.asarray(jax.vmap(lambda p: jtp.score_fn(jstate, p, jctx, None))(pf))
        got = ttp.score_fn(tstate, {k: torch.from_numpy(np.asarray(tbatch[k])) for k in ("tp_scores", "tp_slot")},
                           tctx, None).numpy()
        np.testing.assert_array_equal(got, want)
        rows = [t.cache.row_of(n.name) for n in jn]
        for k, pod in enumerate(jpods):
            assert got[k, rows].tolist() == jtp.reference_scores(pod, jn)
        assert {0, 100} <= set(np.unique(got[:24, rows]).tolist()) and len(np.unique(got[:24, rows])) >= 8


def test_is_active_and_preseed_follow_the_reference():
    j, t, *_ = _setup(True)
    assert len(t.interns.label_keys) == len(j.interns.label_keys)
    assert t.builder.schema.DV == j.builder.schema.DV
    from kubernetes_tpu.ops.common import FeaturizeContext as JF
    from kubernetes_tpu_torch.ops.common import FeaturizeContext as TF

    jf, tf = JF(builder=j.builder, profile=jtp.throughput_aware_profile()), TF(
        builder=t.builder, profile=ttp.throughput_aware_profile())
    for jpod, tpod in zip(pods(jw), pods(tw)):
        assert ttp.is_active(tpod, tf) == jtp.is_active(jpod, jf)
