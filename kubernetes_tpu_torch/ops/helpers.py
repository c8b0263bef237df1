"""Shared tensor helpers of the ops (counterpart of ``kubernetes_tpu/ops/helpers.py``;
the domain-table and normalization helpers come with the affinity slices)."""

from __future__ import annotations

import torch


def make_topo_onehot(topo_vals: torch.Tensor, dv: int) -> torch.Tensor:
    """(N, TK, DV) f32 one-hot of the per-node topology values, which the
    plain domain-table build contracts with.  Hostname-key values exceed DV
    by design (excluded from the vocabulary) and match no column."""
    vals = torch.arange(dv, device=topo_vals.device, dtype=topo_vals.dtype)
    return (
        (topo_vals[:, :, None] == vals[None, None, :]) & (topo_vals >= 0)[:, :, None]
    ).to(torch.float32)
