"""Shared tensor helpers of the ops (counterpart of ``kubernetes_tpu/ops/helpers.py``).

The JAX helpers work on one pod (vmapped over the batch); these take the
chunk axis C first.  ``domain_tables`` sums into the domain axis with a
scatter-add instead of the JAX version's one-hot product: the values are
integer counts, exact in f32 below 2^24 in any order.
"""

from __future__ import annotations

import math

import torch

from ..framework.config import MAX_NODE_SCORE


def default_normalize_score(raw: torch.Tensor, feasible: torch.Tensor, reverse: bool) -> torch.Tensor:
    """DefaultNormalizeScore (plugins/helper/normalize_score.go, helpers.py:10)
    per pod: rescale (C, N) raw scores by each pod's max over its feasible
    nodes to [0, MaxNodeScore] with int64 floor division; with ``reverse``
    higher raw scores map to lower results.  A max of 0 gives MaxNodeScore
    everywhere when reversed, 0 otherwise."""
    raw = raw.to(torch.int64)
    max_count = torch.where(feasible, raw, 0).max(dim=1, keepdim=True).values
    scaled = torch.div(raw * MAX_NODE_SCORE, max_count.clamp(min=1), rounding_mode="floor")
    if reverse:
        return torch.where(max_count == 0, MAX_NODE_SCORE, MAX_NODE_SCORE - scaled)
    return torch.where(max_count == 0, 0, scaled)


def make_topo_onehot(topo_vals: torch.Tensor, dv: int) -> torch.Tensor:
    """(N, TK, DV) f32 one-hot of the per-node topology values, which the
    plain domain-table build contracts with.  Hostname-key values exceed DV
    by design (excluded from the vocabulary) and match no column."""
    vals = torch.arange(dv, device=topo_vals.device, dtype=topo_vals.dtype)
    return (
        (topo_vals[:, :, None] == vals[None, None, :]) & (topo_vals >= 0)[:, :, None]
    ).to(torch.float32)


def domain_tables(state, slots: torch.Tensor, counts: torch.Tensor, dv: int):
    """Per-term domain sums (helpers.py:40) for a chunk.

    ``slots`` (C, T) topology-key slot per term; ``counts`` (C, T, N) f32.
    Returns (vals (C, T, N), key_present, masked, tbl (C, T, DV)) with
    ``tbl[c, t, d] = Σ_n masked[c, t, n]·[vals[c, t, n] == d]``; values
    outside [0, DV) (missing keys, hostname values) add nowhere."""
    vals = state.topo_vals.T[slots.to(torch.int64)]  # (C, T, N)
    key_present = vals >= 0
    masked = torch.where(key_present, counts, 0.0)
    inside = key_present & (vals < dv)
    idx = torch.where(inside, vals, dv).to(torch.int64)
    tbl = torch.zeros(vals.shape[:2] + (dv + 1,), dtype=counts.dtype, device=counts.device)
    tbl.scatter_add_(2, idx, torch.where(inside, masked, 0.0))
    return vals, key_present, masked, tbl[:, :, :dv]


def gather_mask(table: torch.Tensor, ids: torch.Tensor, own: bool = False) -> torch.Tensor:
    """table[c, ids] with -1-padded ids contributing False/0 (helpers.py:63).

    ``table`` (C, V) per-pod vocabulary masks; ``ids`` (N, S) node slot ids.
    Returns (C, N, S); with ``own``, ``ids`` is (C, S), row c pod c's own
    node's, and the result (C, 1, S)."""
    safe = ids.clamp(min=0).to(torch.int64)
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    if own:
        return torch.where(ids >= 0, table.gather(1, safe), zero)[:, None]
    got = table[:, safe]  # (C, N, S)
    return torch.where(ids[None] >= 0, got, zero)


_LOG_TABLES: dict = {}


def log_table(n: int, device) -> torch.Tensor:
    """(n + 1,) f64: log(k + 2) for k = 0..n, from Python's math.log."""
    key = (n, torch.device(device))
    tab = _LOG_TABLES.get(key)
    if tab is None:
        tab = torch.tensor([math.log(k + 2.0) for k in range(n + 1)], dtype=torch.float64,
                           device=device)
        _LOG_TABLES[key] = tab
    return tab


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Veltkamp's split of an f64 into two halves of 26 bits each."""
    t = a * 134217729.0  # 2^27 + 1
    hi = t - (t - a)
    return hi, a - hi


def fma_f64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f64 with one rounding, as a fused multiply-add gives it,
    from separately rounded operations only: Dekker's exact product, an
    exact sum, the low parts added with rounding to odd, then one rounding
    to nearest (Boldo and Melquiond, "Emulation of FMA and correctly
    rounded sums: proved algorithms using rounding to odd", IEEE TC 2008).
    Exact for finite operands whose product neither overflows nor
    underflows."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl  # a * b = p + pe exactly
    th, tl = _two_sum(c, p)
    v, ve = _two_sum(pe, tl)
    # Round v to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact value.
    even = (v.view(torch.int64) & 1) == 0
    inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
    v = torch.where((ve != 0) & even, torch.nextafter(v, torch.where(ve > 0, inf, -inf)), v)
    return th + v


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors with one rounding to f32, as a fused
    multiply-add gives it.  The product is exact in f64 (24 + 24 bits); the
    sum's f64 rounding error is found exactly (Knuth's two-sum) and the f64
    sum rounded to odd, so that its rounding to f32 is the correctly rounded
    f32 of the exact a * b + c (Boldo and Melquiond, IEEE TC 2008: f64 has
    more than 24 + 1 bits)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    s = torch.where((err != 0) & even, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.to(torch.float32)
