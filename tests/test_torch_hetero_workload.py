"""Scheduler-level parity of the profile map, the heterogeneity scorers and
RequestedToCapacityRatio: TorchScheduler(device="cpu") against JAX
TPUScheduler on cuts of hetero_5kn_10kpods, hetero_learned_1kn_5kpods and
binpack_rtcr_5kn_10kpods (40 nodes, 64 warm-up and 300 measured pods,
batch 64), and on a mixed burst of pods naming default-scheduler,
throughput-aware-scheduler, learned-scorer-scheduler and one unknown
scheduler (neither side schedules that pod), and on a burst of pods of
both heterogeneity profiles each pinned to its node (the pinned pass), at
chunk 1 and 64.  Bindings and outcome counts must be equal.  Tolerance:
none (exact)."""

import dataclasses

import pytest

from kubernetes_tpu.api import wrappers as jw
from kubernetes_tpu.framework.config import DEFAULT_PROFILE as JDEF
from kubernetes_tpu.framework.config import REQUESTED_TO_CAPACITY_RATIO, ScoringStrategy
from kubernetes_tpu.ops import learned as jls
from kubernetes_tpu.ops import throughput as jtp
from kubernetes_tpu.ops.common import registered_subset
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu_torch import workloads as w
from kubernetes_tpu_torch.api import wrappers as tw
from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE as TDEF
from kubernetes_tpu_torch.ops.throughput import preseed_hetero_vocab
from kubernetes_tpu_torch.scheduler import TorchScheduler

NODES, WARM, MEASURED, BATCH = 40, 64, 300, 64


def jax_hetero_nodes(n):
    return [jw.make_node(f"node-{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
            .zone(f"zone-{i % 10}").region("region-1").label(jtp.ACCEL_LABEL_KEY, w.hetero_accel_for(i)).obj()
            for i in range(n)]


def jax_pod_hetero(i, scheduler=w.THROUGHPUT_SCHEDULER):
    classes = [c for c, _ in jtp.DEFAULT_THROUGHPUT_MATRIX]
    return (jw.make_pod(f"pod-{i}").req({"cpu": "100m", "memory": "256Mi"}).label("app", f"app-{i % 10}")
            .label(jtp.WORKLOAD_CLASS_LABEL_KEY, classes[i % len(classes)]).scheduler(scheduler).obj())


def jax_pod_basic(i):
    return jw.make_pod(f"pod-{i}").req({"cpu": "900m", "memory": "2Gi"}).label("app", f"app-{i % 10}").obj()


def warm(template, count):
    out = []
    for i in range(count):
        p = template(10**6 + i)
        p.metadata.name = f"warm-{i}"
        out.append(p)
    return out


def mixed(pod_fn, i):
    """Pod i of the mixed burst: the three registered schedulers in turn,
    pod 7 naming one nobody registered."""
    names = ("default-scheduler", w.THROUGHPUT_SCHEDULER, w.LEARNED_SCHEDULER)
    return pod_fn(i, "someone-else" if i == 7 else names[i % 3])


def pinned(wr, i):
    classes = [c for c, _ in jtp.DEFAULT_THROUGHPUT_MATRIX]
    return (wr.make_pod(f"pod-{i}").req({"cpu": "100m", "memory": "256Mi"})
            .label(jtp.WORKLOAD_CLASS_LABEL_KEY, classes[i % 4])
            .scheduler((w.THROUGHPUT_SCHEDULER, w.LEARNED_SCHEDULER)[i % 2])
            .node_name_affinity(f"node-{i % NODES}").obj())


def sides(kind, chunk):
    if kind == "binpack":
        jp = registered_subset(dataclasses.replace(JDEF, scoring_strategy=ScoringStrategy(
            REQUESTED_TO_CAPACITY_RATIO, (("cpu", 1), ("memory", 1)), ((0, 0), (100, 10)))))
        j = TPUScheduler(profile=jp, batch_size=BATCH, chunk_size=chunk)
        t = TorchScheduler(w.binpack_profile(), batch_size=BATCH, chunk_size=chunk, device="cpu")
        jnodes, tnodes = [jw.make_node(f"node-{i}").capacity({"cpu": "16", "memory": "64Gi", "pods": 110})
                          .zone(f"zone-{i % 3}").region("region-1").obj() for i in range(NODES)], w.basic_nodes(NODES)
        jt_pods = (warm(jax_pod_basic, WARM), [jax_pod_basic(i) for i in range(MEASURED)])
        tt_pods = (w.warm_pods(WARM), [w.pod_basic(i) for i in range(MEASURED)])
    else:
        j = TPUScheduler(profile=registered_subset(JDEF), batch_size=BATCH, chunk_size=chunk,
                         profiles=[jtp.throughput_aware_profile(), jls.learned_scorer_profile()])
        t = TorchScheduler(TDEF, batch_size=BATCH, chunk_size=chunk, device="cpu", profiles=w.hetero_profiles())
        jtp.preseed_hetero_vocab(j.builder)
        preseed_hetero_vocab(t.builder)
        jnodes, tnodes = jax_hetero_nodes(NODES), w.hetero_nodes(NODES)
        if kind == "mixed":
            jt_pods = ([], [mixed(jax_pod_hetero, i) for i in range(MEASURED)])
            tt_pods = ([], [mixed(w.pod_hetero, i) for i in range(MEASURED)])
        elif kind == "pinned":
            # Every pod pinned to one node by matchFields (a DaemonSet's
            # pods): each batch takes the pinned pass, whose eval_chunk
            # scores the pod on its own node alone.
            jt_pods = ([], [pinned(jw, i) for i in range(MEASURED)])
            tt_pods = ([], [pinned(tw, i) for i in range(MEASURED)])
        else:
            sched = w.THROUGHPUT_SCHEDULER if kind == "throughput" else w.LEARNED_SCHEDULER
            jt_pods = (warm(lambda i: jax_pod_hetero(i, sched), WARM),
                       [jax_pod_hetero(i, sched) for i in range(MEASURED)])
            tt_pods = (w.warm_pods(WARM, lambda i: w.pod_hetero(i, sched)),
                       [w.pod_hetero(i, sched) for i in range(MEASURED)])
    return (j, jnodes, jt_pods), (t, tnodes, tt_pods)


def drive(s, nodes, pods):
    for n in nodes:
        s.add_node(n)
    out = []
    for stage in pods:
        for p in stage:
            s.add_pod(p)
        out += s.schedule_all_pending()
    return out


@pytest.mark.parametrize("chunk", [1, 64])
@pytest.mark.parametrize("kind", ["throughput", "learned", "binpack", "mixed", "pinned"])
def test_bindings_match_jax(kind, chunk):
    (j, jnodes, jpods), (t, tnodes, tpods) = sides(kind, chunk)
    want = drive(j, jnodes, jpods)
    got = drive(t, tnodes, tpods)
    wb = {o.pod.name: o.node_name for o in want}
    gb = {o.pod.name: o.node_name for o in got}
    assert len(got) == len(want)
    diffs = {k: (gb.get(k), wb.get(k)) for k in set(gb) | set(wb) if gb.get(k) != wb.get(k)}
    assert not diffs, f"{len(diffs)} binding mismatches, first 5: {dict(sorted(diffs.items())[:5])}"
    assert t.builder.host_mirror_equal()
    bound = sum(v is not None for v in gb.values())
    if kind == "mixed":
        assert "pod-7" not in gb and bound == MEASURED - 1
        by_sched = {}
        for o in got:
            by_sched[o.pod.spec.scheduler_name] = by_sched.get(o.pod.spec.scheduler_name, 0) + 1
        assert set(by_sched) == {"default-scheduler", w.THROUGHPUT_SCHEDULER, w.LEARNED_SCHEDULER}
    elif kind == "pinned":
        assert bound == MEASURED and t.pinned_batches > 0
        assert all(o.node_name == f"node-{int(o.pod.name.split('-')[1]) % NODES}" for o in got)
    else:
        assert bound == WARM + MEASURED
    if kind in ("throughput", "learned"):
        # Each workload class lands on its matrix-best accelerator class.
        best = {c: max(row, key=lambda at: at[1])[0] for c, row in jtp.DEFAULT_THROUGHPUT_MATRIX}
        accel = {f"node-{i}": w.hetero_accel_for(i) for i in range(NODES)}
        on_best = sum(accel[o.node_name] == best[o.pod.metadata.labels[jtp.WORKLOAD_CLASS_LABEL_KEY]]
                      for o in got)
        assert on_best > 0.9 * len(got)
    if kind == "binpack" and chunk > 1:
        assert t.deferred > 0  # a chunk's pods crowd onto the most-requested node
