"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests need a card and skip
without one; ``python3 chip_smoke.py`` runs the same checks (and the
density, inter-pod-affinity and spread workloads at full size) on the
H100.  Run them there with ``python -m pytest --noconftest
tests/test_torch_kernels.py -m cuda`` (tests/conftest.py imports JAX,
which that machine lacks)."""

import dataclasses

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_exactly(cuda_device):
    import chip_smoke

    timing = chip_smoke.check_kernels(cuda_device, reps=1)
    assert set(timing) == {"build_dom", "eval_chunk", "select_host", "resolve_commit"}


@pytest.mark.cuda
def test_ipa_kernels_match_plain_versions_exactly(cuda_device):
    import chip_smoke

    timing = chip_smoke.check_ipa_kernels(cuda_device, reps=1)
    assert set(timing) == {"build_dom", "eval_chunk", "ipa_eval", "select_host", "resolve_commit",
                           "conflict_pairs"}


@pytest.mark.cuda
def test_ipa_shared_memory_cap_raises_before_launch(cuda_device):
    import chip_smoke
    from kubernetes_tpu_torch import kernels

    x = chip_smoke.ipa_inputs(7, cuda_device)
    # More required-affinity terms than the shared-memory tables can hold.
    pf = dict(x["pf"], ipa_ra_valid=torch.zeros((64, 4096), dtype=torch.bool, device=cuda_device))
    before = kernels.ipa_eval.launches
    with pytest.raises(NotImplementedError, match="IPA_SMEM_CAP"):
        kernels.ipa_eval(x["state"], pf, *(t.clone() for t in x["base"]), x["ipa"])
    assert kernels.ipa_eval.launches == before


@pytest.mark.cuda
def test_scheduler_ipa_kernel_path_matches_plain_path(cuda_device):
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.workloads import basic_nodes, pod_ipa_heavy

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=128, chunk_size=16, _impl=impl)
        for n in basic_nodes(40, zones=10):
            s.add_node(n)
        for i in range(600):
            s.add_pod(pod_ipa_heavy(i, anti_colours=50, aff_colours=7))
        kernels.reset_launches()
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("build_dom", "eval_chunk", "ipa_eval", "select_host",
                                           "resolve_commit", "conflict_pairs")) > 0
            assert s.deferred > 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
def test_scheduler_kernel_path_matches_plain_path(cuda_device):
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.workloads import basic_nodes, pod_basic

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=256, chunk_size=16, _impl=impl)
        for n in basic_nodes(300):
            s.add_node(n)
        for i in range(1500):
            s.add_pod(pod_basic(i))
        kernels.reset_launches()
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            # Density batches carry no affinity features: the affinity
            # kernels launch nothing.
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("build_dom", "eval_chunk", "select_host",
                                           "resolve_commit")) > 0
            assert counts["ipa_eval"] == counts["conflict_pairs"] == 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["spread_na", "inclusion"])
def test_spread_kernels_match_plain_versions_exactly(cuda_device, shape):
    """node_filters, spread_filter, late_scores and the extended eval_chunk
    and conflict_pairs against their plain versions on the mixed chunks."""
    import chip_smoke

    timing = chip_smoke.check_spread_kernels(cuda_device, shape, reps=1)
    assert {"node_filters", "spread_filter", "late_scores", "eval_chunk", "conflict_pairs"} <= set(timing)
    assert all(t["max_abs_err"] == 0 for t in timing.values())


@pytest.mark.cuda
def test_spread_shared_memory_cap_raises_before_launch(cuda_device):
    import chip_smoke
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.engine.pass_ import eval_spec
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE

    x = chip_smoke.spread_inputs("spread_na", 7, cuda_device)
    prof, pf, active = x["mixed"]["default"]
    b = x["builder"]
    ctx = eval_spec(prof, b.schema, b.res_col, active).ctx
    big_dv = dataclasses.replace(ctx, schema=dataclasses.replace(b.schema, DV=1 << 16))
    bits = torch.full((32, b.schema.N), 3, dtype=torch.uint8, device=cuda_device)
    before = kernels.spread_filter.launches
    with pytest.raises(NotImplementedError, match="SPREAD_SMEM_CAP"):
        kernels.spread_filter(x["state"], pf, bits, big_dv)
    assert kernels.spread_filter.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["spread_na", "inclusion"])
def test_scheduler_spread_kernel_path_matches_plain_path(cuda_device, workload):
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.framework.config import DEFAULT_PROFILE
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.workloads import basic_nodes, inclusion_nodes, pod_inclusion, pod_spread_na

    binds = {}
    for impl in ("kernel", "plain"):
        s = TorchScheduler(DEFAULT_PROFILE, batch_size=128, chunk_size=64, _impl=impl)
        nodes = basic_nodes(60) if workload == "spread_na" else inclusion_nodes(60)
        for n in nodes:
            s.add_node(n)
        for i in range(600):
            s.add_pod(pod_spread_na(i) if workload == "spread_na" else pod_inclusion(i))
        kernels.reset_launches()
        binds[impl] = {o.pod.name: o.node_name for o in s.schedule_all_pending()}
        assert s.builder.host_mirror_equal()
        if impl == "kernel":
            counts = kernels.launch_counts()
            assert min(counts[k] for k in ("node_filters", "spread_filter", "eval_chunk", "late_scores",
                                           "select_host", "resolve_commit", "conflict_pairs")) > 0
            assert counts["ipa_eval"] == 0
    assert binds["kernel"] == binds["plain"]
    assert all(v is not None for v in binds["kernel"].values())
