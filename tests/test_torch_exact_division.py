"""eval_chunk's int64 floor division without the 64-bit divide routine
(``floordiv_f64`` in kubernetes_tpu_torch/kernels/csrc/common.cuh),
emulated here in plain torch step for step: the f64 quotient floored, one
correction step against the exact int64 remainder, and the exact int64
routine where an operand is at or above 2^53 in magnitude.  It is held
against ``torch.div(..., rounding_mode="floor")`` (the plain versions'
division) and JAX's ``//`` (the reference's) on the same numpy int64
arrays: the fit score's numerators ((al - rq) * 100 and rq * 100 over al)
at multiples of al and one either side, al = 1, rq = al, both sides of
2^53, the largest numerator the schema admits, the weighted sum over the
weight sum, negative operands, a seeded set and a hypothesis-drawn one.
Also ``eval_tile``, the host's choice of eval_chunk's node tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import kubernetes_tpu  # noqa: F401  (turns on JAX's int64)
from kubernetes_tpu_torch.kernels import EVAL_GROUP, EVAL_TILE, EVAL_TILE_MIN, eval_tile

LIM = 1 << 53
I64_MAX = (1 << 63) - 1


def floordiv_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's scheme on int64 tensors (b != 0)."""
    q = torch.floor(a.double() / b.double()).to(torch.int64)
    r = a - q * b
    pos = b > 0
    down = torch.where(pos, r < 0, r > 0)
    up = ~down & torch.where(pos, r >= b, r <= b)
    q = q - down.to(torch.int64) + up.to(torch.int64)
    big = (a >= LIM) | (a <= -LIM) | (b >= LIM) | (b <= -LIM)
    return torch.where(big, torch.div(a, b, rounding_mode="floor"), q)


def _check(a: np.ndarray, b: np.ndarray) -> None:
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    got = floordiv_f64(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    torch_floor = torch.div(torch.from_numpy(a), torch.from_numpy(b), rounding_mode="floor").numpy()
    jax_floor = np.asarray(jnp.asarray(a) // jnp.asarray(b))
    assert jax_floor.dtype == np.int64
    np.testing.assert_array_equal(got, torch_floor)
    np.testing.assert_array_equal(got, jax_floor)


# Allocatable values: small, multiples and neighbours of 100, both sides of
# 2^53 for the numerator (al * 100) and for al itself, and the largest al
# whose (al - 0) * 100 fits int64.
ALLOCS = (1, 2, 3, 7, 50, 99, 100, 101, 1000, 4096, LIM // 100 - 1, LIM // 100, LIM // 100 + 1, LIM - 1, LIM,
          LIM + 1, (1 << 56) - 3, I64_MAX // 100)


def _fit_cases():
    """(numerator, al) of the fit score's two strategies for rq from 0 to
    al, at the edges and across the range."""
    nums, dens = [], []
    for al in ALLOCS:
        for rq in sorted({0, 1, 2, al // 3, al // 2, al - 2, al - 1, al}):
            if 0 <= rq <= al:
                nums += [(al - rq) * 100, rq * 100]
                dens += [al, al]
    return np.array(nums, np.int64), np.array(dens, np.int64)


@pytest.mark.parametrize("strategy", ["least", "most"])
def test_fit_score_numerators(strategy):
    nums, dens = _fit_cases()
    pick = slice(0, None, 2) if strategy == "least" else slice(1, None, 2)
    _check(nums[pick], dens[pick])


@pytest.mark.parametrize("al", [1, 3, 7, 99, 100, 101, LIM // 100, LIM // 100 + 1, LIM - 1, LIM + 1])
def test_multiples_of_al_and_one_either_side(al):
    k = np.arange(0, 101, dtype=np.int64)
    base = k * al
    nums = np.concatenate([base, base + 1, base - 1])
    nums = nums[(nums >= 0) & (nums <= I64_MAX)]
    _check(nums, np.full(nums.shape, al, np.int64))


def test_weighted_sum_over_weight_sum():
    """node_score / weight_sum: scores 0-100 a column, weights 1-3, so
    numerators up to 600 over sums 1-6; and large weights."""
    num = np.arange(0, 601, dtype=np.int64)
    for ws in (1, 2, 3, 4, 5, 6, 7, 1000, LIM - 1, LIM):
        _check(num * (ws if ws > 6 else 1), np.full(num.shape, ws, np.int64))


def test_both_sides_of_the_switch():
    """Operands just below, at and just above 2^53 in magnitude, both
    signs: the f64 quotient below the switch, the exact routine above."""
    edge = np.array([LIM - 2, LIM - 1, LIM, LIM + 1, LIM + 2, LIM + 3], np.int64)
    a = np.concatenate([edge, -edge, edge * 3 + 1])
    for b in (1, 2, 3, 7, 100, LIM - 1, LIM, LIM + 1, -1, -3, -(LIM + 1)):
        _check(a, np.full(a.shape, b, np.int64))


def test_the_switch_is_needed_above_2_53():
    """Without the switch the f64 quotient is wrong where an operand does
    not convert exactly: (2^53 + 1) // 1 rounds to 2^53 first."""
    a = torch.tensor([LIM + 1], dtype=torch.int64)
    b = torch.tensor([1], dtype=torch.int64)
    naive = torch.floor(a.double() / b.double()).to(torch.int64)
    assert int(naive) == LIM
    assert int(floordiv_f64(a, b)) == LIM + 1


def test_no_correction_needed_below_the_switch():
    """Below 2^53 the floored f64 quotient already equals the floor (the
    correction step is a guard): seeded operands of every magnitude."""
    rng = np.random.default_rng(12)
    a = (rng.random(200_000) * 2.0 ** rng.integers(0, 53, 200_000)).astype(np.int64)
    a = np.where(rng.random(a.size) < 0.5, -a, a)
    b = np.maximum((rng.random(a.size) * 2.0 ** rng.integers(0, 53, a.size)).astype(np.int64), 1)
    b = np.where(rng.random(b.size) < 0.3, -b, b)
    q0 = torch.floor(torch.from_numpy(a).double() / torch.from_numpy(b).double()).to(torch.int64)
    want = torch.div(torch.from_numpy(a), torch.from_numpy(b), rounding_mode="floor")
    assert torch.equal(q0, want)
    _check(a, b)


def test_seeded_operands_of_every_magnitude():
    rng = np.random.default_rng(7)
    mag_a = rng.integers(0, 63, 100_000)
    mag_b = rng.integers(0, 62, 100_000)
    a = (rng.random(mag_a.size) * 2.0 ** mag_a).astype(np.int64)
    b = np.maximum((rng.random(mag_b.size) * 2.0 ** mag_b).astype(np.int64), 1)
    a = np.where(rng.random(a.size) < 0.5, -a, a)
    b = np.where(rng.random(b.size) < 0.5, -b, b)
    _check(a, b)


@settings(max_examples=400, deadline=None, database=None, derandomize=True)
@given(st.integers(-(1 << 62), 1 << 62), st.integers(-(1 << 62), 1 << 62).filter(lambda v: v != 0))
def test_hypothesis_operands(a, b):
    got = int(floordiv_f64(torch.tensor([a], dtype=torch.int64), torch.tensor([b], dtype=torch.int64)))
    assert got == a // b
    _check(np.array([a]), np.array([b]))


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(st.integers(1, I64_MAX // 100), st.data())
def test_hypothesis_fit_numerators(al, data):
    rq = data.draw(st.integers(0, al))
    _check(np.array([(al - rq) * 100, rq * 100]), np.array([al, al]))


@pytest.mark.parametrize(("c", "n", "want"), [
    (64, 8192, (128, 4)),  # density: 64 x 16 blocks
    (1, 8192, (32, 1)),  # the chunk-1 paths: 256 blocks of one warp
    (64, 1024, (128, 1)),  # the affinity shape
    (8, 1024, (32, 1)),
    (8, 8192, (128, 1)),
    (128, 8192, (128, 4)),
    (1, 1024, (32, 1)),  # as many blocks as a warp a block gives
    (1024, 8192, (128, 4)),
])
def test_eval_tile(c, n, want):
    assert eval_tile(c, n, 132) == want


@pytest.mark.parametrize("c", [1, 2, 3, 8, 33, 64, 1000])
@pytest.mark.parametrize("n", [64, 1024, 8192, 16384])
def test_eval_tile_fills_the_card_or_stops_at_the_floor(c, n):
    sms = 132
    nodes, pods = eval_tile(c, n, sms)
    assert EVAL_TILE_MIN <= nodes <= EVAL_TILE and nodes % 32 == 0
    assert 1 <= pods <= min(c, EVAL_GROUP)
    blocks = -(-n // nodes) * -(-c // pods)
    assert blocks >= 2 * sms or (pods == 1 and nodes == EVAL_TILE_MIN)
