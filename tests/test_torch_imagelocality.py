"""The port's ImageLocality against the JAX op: the four scenarios of
tests/test_ops_imagelocality.py:31-83 (a node holding the image, an
untagged reference normalized to :latest, the spread scaling against the
scalar formula, an image known by two names) run by TorchScheduler on the
CPU and by TPUScheduler side by side, bindings and scores equal; then the
features, the op's plain score, and the plain image_counts/image_scores
plane against the JAX featurize and score_fn on a cluster with aliases, a
node listing one name twice, untagged, unknown and repeated references and
init containers; and the rounding cases: a size × spread product that
lands exactly on the 1000 MiB threshold and one an ulp below it, sums at
23 MiB - 1, 23 MiB, 1000 MiB x n and + 1, and a pod naming the same image
twice.  Tolerance: none (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.cache import Cache as JaxCache
from kubernetes_tpu.engine.features import build_pod_batch as jax_batch
from kubernetes_tpu.framework.config import Profile as JProfile
from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.cache import Cache as TorchCache
from kubernetes_tpu_torch.engine.features import build_pod_batch as torch_batch
from kubernetes_tpu_torch.framework.config import Profile as TProfile
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.ops import common as tcommon
from kubernetes_tpu_torch.ops.imagelocality import MAX_CONTAINER_THRESHOLD, MB, MIN_THRESHOLD
from kubernetes_tpu_torch.scheduler import TorchScheduler
from kubernetes_tpu_torch.snapshot import SnapshotBuilder

from chip_smoke import threshold_cases

IL_FEATURES = ("il_image_ids", "il_ncontainers")


def _profile(cls):
    return cls(name="il", filters=("NodeResourcesFit",), scorers=(("ImageLocality", 1),))


def _cap(w):
    return w.capacity({"cpu": "4", "pods": 110})


def _with_image(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("with-img")).image("redis:7", 300 * MB).obj())
    s.add_node(_cap(mknode("without")).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).container_image("redis:7").obj())


def _untagged(s, mknode, mkpod, t):
    s.add_node(_cap(mknode("n1")).image("nginx:latest", 200 * MB).obj())
    s.add_node(_cap(mknode("n2")).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).container_image("nginx").obj())


def _spread(s, mknode, mkpod, t):
    rng = np.random.default_rng(5)
    images = [f"img{i}:v1" for i in range(6)]
    sizes = {img: int(rng.integers(30, 900)) * MB for img in images}
    for i in range(8):
        w = mknode(f"n{i}").capacity({"cpu": "64", "pods": 110})
        for img in images:
            if rng.integers(0, 2):
                w = w.image(img, sizes[img])
        s.add_node(w.obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).container_image(images[0], images[3]).obj())


def _alias(s, mknode, mkpod, t):
    node = _cap(mknode("n1")).obj()
    node.status.images += (t.ContainerImage(names=("docker.io/library/app:1", "app:1"), size_bytes=400 * MB),)
    s.add_node(node)
    s.add_node(_cap(mknode("n2")).obj())
    s.add_pod(mkpod("p").req({"cpu": "1"}).container_image("app:1").obj())


def ref_score(pod_images, node_images: dict, all_nodes_images, n_containers):
    """tests/test_ops_imagelocality.py:ref_score (calculatePriority of
    sumImageScores)."""
    total = len(all_nodes_images)
    s = 0
    for img in pod_images:
        if img in node_images:
            num = sum(1 for ni in all_nodes_images if img in ni)
            s += int(node_images[img] * (num / total))
    mn, mx = 23 * MB, 1000 * MB * n_containers
    s = min(max(s, mn), mx)
    return 100 * (s - mn) // (mx - mn)


@pytest.mark.parametrize("build,want", [
    (_with_image, "with-img"), (_untagged, "n1"), (_spread, None), (_alias, "n1"),
], ids=["prefers-node-with-image", "untagged-normalizes-to-latest", "spread-scaling", "image-alias"])
def test_scenarios_match_jax(build, want):
    j = TPUScheduler(profile=_profile(JProfile), batch_size=8)
    t = TorchScheduler(_profile(TProfile), batch_size=8, device="cpu")
    build(j, jnode, jpod, jt)
    build(t, tnode, tpod, tt)
    jout, tout = j.schedule_all_pending(), t.schedule_all_pending()
    key = lambda outs: [(o.pod.name, o.node_name, o.score, o.feasible_nodes) for o in outs]  # noqa: E731
    assert key(tout) == key(jout)
    if want is not None:
        assert tout[0].node_name == want
    else:  # the winner holds the reference's best score
        nodes = [t.cache.nodes[f"n{i}"].node for i in range(8)]
        have = [{im.names[0]: im.size_bytes for im in n.status.images} for n in nodes]
        scores = {f"n{i}": ref_score(["img0:v1", "img3:v1"], have[i], have, 1) for i in range(8)}
        assert scores[tout[0].node_name] == max(scores.values())
        assert tout[0].score == max(scores.values())


# -- op level ----------------------------------------------------------------------


def _cluster(mknode, mkpod, t, cache, seed):
    """14 nodes holding images of a 10-image pool under one or two names
    (n3 lists one name twice; 3 nodes hold none); 20 pods
    with 1-3 containers and init containers naming tagged, untagged,
    unknown and repeated references."""
    rng = np.random.default_rng(seed)
    pool = [(f"repo/app{i}:v{i % 3}", f"repo/app{i}@sha256:{i:064x}", int(rng.integers(1, 900)) * MB + i)
            for i in range(10)]
    pool[4] = ("repo/app4:latest", pool[4][1], pool[4][2])
    for i in range(14):
        node = mknode(f"n{i}").capacity({"cpu": "16", "pods": 110}).obj()
        if i < 11:
            for k in rng.choice(10, int(rng.integers(1, 7)), replace=False):
                names = pool[k][:2] if rng.random() < 0.5 else pool[k][:1]
                node.status.images += (t.ContainerImage(names=names, size_bytes=pool[k][2]),)
        if i == 3:
            node.status.images += (t.ContainerImage(names=(pool[0][0],), size_bytes=pool[0][2]),) * 2
        cache.add_node(node)
    refs = [p[0] for p in pool] + ["repo/app4", "repo/unknown:v1", pool[1][1]]
    pods = []
    for k in range(20):
        pod = mkpod(f"p{k}").req({"cpu": "100m"}).obj()
        for c in range(int(rng.integers(1, 4))):
            img = refs[int(rng.integers(len(refs)))]
            if c == 0:
                pod.spec.containers[0].images = (img,)
            else:
                pod.spec.containers.append(t.Container(name=f"c{c}", images=(img,)))
        if k % 4 == 1:
            pod.spec.init_containers.append(t.Container(name="init", images=(refs[int(rng.integers(10))],)))
        if k % 7 == 2:  # the same image twice
            pod.spec.containers.append(t.Container(name="again", images=pod.spec.containers[0].images))
        pods.append(pod)
    return pods


def _featurized(build, k):
    """Both builders over ``build``'s cluster and the batch featurized by
    each under the ImageLocality profile."""
    jb, tb = JaxBuilder(), SnapshotBuilder(device="cpu")
    jpods = build(jnode, jpod, jt, JaxCache(jb))
    tpods = build(tnode, tpod, tt, TorchCache(tb))
    jbatch, _, jactive = jax_batch(jpods, jb, _profile(JProfile), k)
    tbatch, _, tactive = torch_batch(tpods, tb, _profile(TProfile), k)
    assert jactive == tactive and "ImageLocality" in tactive
    for key in IL_FEATURES:
        np.testing.assert_array_equal(tbatch[key], np.asarray(jbatch[key]), err_msg=key)
    return jb, tb, jbatch, tbatch, len(jpods)


def scores_all_ways(build, k):
    """(JAX score_fn, the port op's score_fn, plain image_scores over
    image_counts) on the real pods: three (pods, N) int64 arrays."""
    jb, tb, jbatch, tbatch, npods = _featurized(build, k)
    jstate, tstate = jb.state(), tb.state()
    for f in ("image_ids", "image_sizes", "valid"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), err_msg=f)
    jop, top = jcommon.get("ImageLocality"), tcommon.get("ImageLocality")
    jpf = {key: jnp.asarray(np.asarray(jbatch[key])) for key in IL_FEATURES}
    want = np.asarray(jax.vmap(lambda p: jop.score(jstate, p, None, None))(jpf))[:npods]
    tpf = {key: torch.from_numpy(tbatch[key]) for key in (*IL_FEATURES, "valid")}
    op = top.score(tstate, tpf, None, None).numpy()[:npods]
    counts = plain.image_counts(tstate, len(tb.interns.images))
    plane = plain.image_scores(tstate, tpf, counts).numpy().astype(np.int64)
    assert (plane[npods:] == 0).all()  # padding lanes
    return want, op, plane[:npods]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_score_and_plane_match_jax(seed):
    want, op, plane = scores_all_ways(lambda mn, mp, t, cache: _cluster(mn, mp, t, cache, seed), 24)
    np.testing.assert_array_equal(op, want)
    np.testing.assert_array_equal(plane, want)
    assert 0 < (want > 0).sum() < want.size


def test_image_counts_once_per_node():
    """A node listing one name twice counts once; invalid rows not at all;
    the last entry is the number of valid nodes."""
    tb = SnapshotBuilder(device="cpu")
    _cluster(tnode, tpod, tt, TorchCache(tb), 1)
    st = tb.state()
    vocab = len(tb.interns.images)
    counts = plain.image_counts(st, vocab).numpy()
    ids, valid = st.image_ids.numpy(), st.valid.numpy()
    want = [sum(int((ids[n] == v).any()) for n in range(ids.shape[0]) if valid[n]) for v in range(vocab)]
    np.testing.assert_array_equal(counts[:vocab], want)
    assert counts[vocab] == valid.sum() == 14
    row = ids[3][ids[3] >= 0]
    assert len(set(row.tolist())) < len(row)  # n3 lists a name twice


# -- rounding cases ----------------------------------------------------------------


def _spread_cluster(total, cnt, size, ncontainers=1, twice=False):
    """``total`` nodes, the first ``cnt`` holding img:v1 of ``size``; one pod
    naming it (twice with ``twice``) in ``ncontainers`` containers."""
    def build(mknode, mkpod, t, cache):
        for i in range(total):
            w = mknode(f"n{i}").capacity({"cpu": "4", "pods": 110})
            if i < cnt:
                w = w.image("img:v1", size)
            cache.add_node(w.obj())
        pod = mkpod("p").req({"cpu": "1"}).container_image("img:v1").obj()
        for c in range(1, ncontainers):
            pod.spec.containers.append(t.Container(name=f"c{c}", images=("img:v1",) if twice else ()))
        return [pod]
    return build


def test_threshold_product_on_and_below_an_integer():
    """chip_smoke.threshold_cases: S * c / T exactly 1000 MiB as rationals,
    once with the f64 product on it and once an ulp below (100 vs 99)."""
    on, below = threshold_cases()
    assert on is not None and below is not None
    for (total, cnt, size), score in ((on, 100), (below, 99)):
        want, op, plane = scores_all_ways(_spread_cluster(total, cnt, size), 8)
        np.testing.assert_array_equal(op, want)
        np.testing.assert_array_equal(plane, want)
        assert want[0, 0] == score and (want[0, cnt:total] == 0).all()


@pytest.mark.parametrize("ncontainers,size,score", [
    (1, MIN_THRESHOLD - 1, 0), (1, MIN_THRESHOLD, 0), (1, MIN_THRESHOLD + 10 * MB, 1),
    (2, 2 * MAX_CONTAINER_THRESHOLD, 100), (2, 2 * MAX_CONTAINER_THRESHOLD + 1, 100),
    (2, 2 * MAX_CONTAINER_THRESHOLD - 1, 99), (3, 3 * MAX_CONTAINER_THRESHOLD + 1, 100),
])
def test_clamp_boundaries(ncontainers, size, score):
    # Every node holds the image: spread 1, so the sum is the size itself.
    want, op, plane = scores_all_ways(_spread_cluster(4, 4, size, ncontainers), 8)
    np.testing.assert_array_equal(op, want)
    np.testing.assert_array_equal(plane, want)
    assert (want[0, :4] == score).all()


def test_same_image_named_twice_counts_twice():
    size = 400 * MB
    want, op, plane = scores_all_ways(_spread_cluster(4, 4, size, 2, twice=True), 8)
    np.testing.assert_array_equal(plane, want)
    np.testing.assert_array_equal(op, want)
    sum_ = 2 * size
    mx = 2 * MAX_CONTAINER_THRESHOLD
    assert (want[0, :4] == 100 * (sum_ - MIN_THRESHOLD) // (mx - MIN_THRESHOLD)).all()
