"""The port's conflict-aware chunk packer (kubernetes_tpu_torch.engine.packing)
against the JAX package's, exactly: conflict classes, the width choice, the
permutation and the collision count on seeded random batches (sparse and
dense group reads, own-term writes against existing-term hard reads, short
and full batches) and on a featurized batch of the inter-pod-affinity
workload.  Tolerance: none (exact)."""

import numpy as np
import pytest

from kubernetes_tpu.engine import packing as jpack
from kubernetes_tpu_torch.engine import packing as tpack
from kubernetes_tpu_torch.engine.features import build_pod_batch
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
from kubernetes_tpu_torch.snapshot import SnapshotBuilder
from kubernetes_tpu_torch.workloads import pod_ipa_heavy


def _random_batch(seed: int, k: int, g: int, et: int, density: float) -> dict:
    rng = np.random.default_rng(seed)
    own = np.full((k, 2), -1, np.int32)
    has = rng.random(k) < 0.6
    own[has, 0] = rng.integers(0, et, has.sum())
    two = has & (rng.random(k) < 0.3)
    own[two, 1] = rng.integers(0, et, two.sum())
    return {
        "group": rng.integers(0, g, k).astype(np.int32),
        "ipa_ra_allmask": rng.random((k, g)) < density,
        "ipa_rs_groups": rng.random((k, 1, g)) < density,
        "ipa_own_terms": own,
        "ipa_et_match": rng.random((k, et)) < 0.05,
        "ipa_et_anti": rng.random((k, et)) < 0.5,
        "valid": np.ones(k, np.bool_),
    }


def _assert_same_plan(batch: dict, npods: int, chunk: int) -> tpack.PackPlan:
    np.testing.assert_array_equal(
        tpack.conflict_classes(batch, npods), jpack.conflict_classes(batch, npods)
    )
    want = jpack.pack_batch(batch, npods, chunk)
    got = tpack.pack_batch(batch, npods, chunk)
    for f in ("width", "n_classes", "max_class", "collisions"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.class_sizes, want.class_sizes)
    if want.perm is None:
        assert got.perm is None
    else:
        np.testing.assert_array_equal(got.perm, want.perm)
    classes = jpack.conflict_classes(batch, npods)
    for w in (1, 2, 8, chunk):
        assert tpack.residual_collisions(classes, npods, w) == jpack.residual_collisions(classes, npods, w)
    return got


@pytest.mark.parametrize(
    "seed,k,npods,g,et,density,chunk",
    [
        (0, 256, 256, 32, 16, 0.02, 16),
        (1, 256, 200, 64, 64, 0.005, 16),
        (2, 128, 128, 8, 8, 0.3, 16),
        (3, 512, 512, 128, 32, 0.002, 64),
        (4, 64, 37, 16, 4, 0.05, 8),
        (5, 256, 256, 256, 8, 0.0, 16),
    ],
)
def test_pack_batch_matches_jax_on_random_batches(seed, k, npods, g, et, density, chunk):
    _assert_same_plan(_random_batch(seed, k, g, et, density), npods, chunk)


def test_no_affinity_reads_keeps_identity_order():
    batch = _random_batch(7, 64, 16, 8, 0.0)
    batch["ipa_et_match"][:] = False
    plan = _assert_same_plan(batch, 64, 16)
    assert plan.perm is None and plan.width == 16 and plan.collisions == 0


def test_width_ladder_matches_jax():
    for chunk in (1, 3, 16, 64):
        assert tpack._width_ladder(chunk) == jpack._width_ladder(chunk)


@pytest.mark.parametrize("aff_colours,chunk", [(5, 16), (7, 16), (50, 64)])
def test_pack_batch_matches_jax_on_the_affinity_workload(aff_colours, chunk):
    """A featurized 512-pod batch of the workload's pods: zone
    anti-affinity to the pod's own colour, zone affinity to its own
    affinity colour."""
    builder = SnapshotBuilder(device="cpu")
    pods = [pod_ipa_heavy(i, anti_colours=100, aff_colours=aff_colours) for i in range(512)]
    batch, _, active = build_pod_batch(pods, builder, DEFAULT_PROFILE, 512)
    assert "InterPodAffinity" in active
    plan = _assert_same_plan(batch, 512, chunk)
    assert plan.perm is not None and plan.max_class > 1
