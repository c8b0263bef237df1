"""The one-launch row flush (kernels/csrc/rows.cu scatter_rows, the
snapshot's _flush): the packed buffer's layout (flush_layout: the row
index first, every field's block 8-byte aligned, widths 1, 2, 4 and 8,
fields indexed by node on axis 0 and on axis 1), pack_rows, and the
kernel's descriptors (field_descs) walked word by word in a numpy
emulation of scatter_rows_kernel, all held exactly against the per-field
plain scatter (plain.scatter_rows) and plain.scatter_fields; then a
SnapshotBuilder round trip: random dirty rows written into all 27 fields,
one flush by state(), the host mirror equal to the device state and every
field equal to the JAX builder's after its own _scatter_rows."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.wrappers import make_node as jnode
from kubernetes_tpu.api.wrappers import make_pod as jpod
from kubernetes_tpu.snapshot import SnapshotBuilder as JaxBuilder
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.api.wrappers import make_node as tnode
from kubernetes_tpu_torch.api.wrappers import make_pod as tpod
from kubernetes_tpu_torch.kernels import FlushLayout, field_descs, flush_layout, pack_rows, plain
from kubernetes_tpu_torch.snapshot import _NODE_AXIS, SnapshotBuilder, state_to_numpy

from test_torch_snapshot import _drive

N = 80
# (name, dtype, shape with N for the node axis, node axis, expected word)
FIELDS = [
    ("flag", np.bool_, (N,), 0, 1),
    ("id", np.int32, (N,), 0, 4),
    ("pair", np.int32, (N, 2), 0, 8),
    ("triple", np.int32, (N, 3), 0, 4),
    ("short", np.int16, (N, 3), 0, 2),
    ("bits", np.bool_, (N, 5), 0, 1),
    ("wide", np.int64, (N, 4), 0, 8),
    ("start", np.float64, (N,), 0, 8),
    ("counts", np.int32, (7, N), 1, 4),
    ("big", np.int64, (3, N), 1, 8),
    ("mask", np.bool_, (2, N), 1, 1),
    ("empty", np.int32, (0, N), 1, 4),
]


def _fields(rng):
    out = []
    for _name, dtype, shape, axis, _word in FIELDS:
        if dtype is np.bool_:
            a = rng.random(shape) < 0.5
        elif dtype is np.float64:
            a = rng.standard_normal(shape)
        else:
            a = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, size=shape, dtype=dtype)
        out.append(np.ascontiguousarray(a))
    return out


def emulate_scatter(descs, rows: np.ndarray, buf: np.ndarray, base: int, dsts: list[torch.Tensor]) -> None:
    """scatter_rows_kernel on CPU tensors: each descriptor's source words
    (at its address less ``base`` in ``buf``) to destination word (o n +
    rows[i]) inner + b, as the kernel's grid-stride loop writes them."""
    by_addr = {d.data_ptr(): d for d in dsts}
    m = len(rows)
    for dst_addr, src_addr, outer, n, inner, word in descs:
        wt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[word]
        iw = inner // word
        total = outer * m * iw
        dst = by_addr[dst_addr].numpy().reshape(-1).view(np.uint8).view(wt)
        src = buf[src_addr - base:src_addr - base + total * word].view(wt)
        e = np.arange(total)
        b, i, o = e % iw, (e // iw) % m, e // (iw * m)
        dst[(o * n + rows[i]) * iw + b] = src[e]


@pytest.mark.parametrize("nrows", [1, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_flush_matches_per_field_scatter(nrows, seed):
    rng = np.random.default_rng(seed)
    host = _fields(rng)
    rows = np.sort(rng.choice(N, nrows, replace=False)).astype(np.int64)
    m = nrows
    before = _fields(np.random.default_rng(seed + 100))
    layout = flush_layout([(a.shape, a.itemsize, ax) for a, (_n, _d, _s, ax, _w) in zip(host, FIELDS)], m)
    # The layout: the row index first, then the blocks in order, 8-aligned, apart.
    assert layout.nrows == m and layout.slots[0].offset == 8 * m
    end = 8 * m
    for slot, a, (_n, _d, _s, ax, _w) in zip(layout.slots, host, FIELDS):
        assert slot.offset % 8 == 0 and slot.offset >= end and slot.offset - end < 8
        assert slot.axis == ax and (slot.outer, slot.n, slot.inner) == kernels.node_view(a.shape, a.itemsize, ax)
        end = slot.offset + slot.outer * m * slot.inner
    assert layout.nbytes == -(-end // 8) * 8
    buf = np.zeros(layout.nbytes + 16, np.uint8)
    pack_rows(buf, layout, rows, host)
    np.testing.assert_array_equal(buf[:8 * m].view(np.int64), rows)

    def fresh():
        return [torch.from_numpy(b.copy()) for b in before]

    want = fresh()  # the per-field plain scatter of the host rows
    idx = torch.from_numpy(rows)
    for dst, a, (_n, _d, _s, ax, _w) in zip(want, host, FIELDS):
        plain.scatter_rows(dst, ax, idx, torch.from_numpy(np.ascontiguousarray(a[rows] if ax == 0 else a[:, rows])))
    got = fresh()  # the kernel's walk over the descriptors
    tbuf = torch.from_numpy(buf)
    descs = field_descs(got, layout, tbuf.data_ptr())
    assert [d[5] for d in descs] == [w for *_x, w in FIELDS]
    emulate_scatter(descs, rows, buf, tbuf.data_ptr(), got)
    viaplain = fresh()  # the plain version of the one-launch entry point
    kernels.scatter_fields(viaplain, [f[3] for f in FIELDS], tbuf, layout)
    for name, w, g, p in zip([f[0] for f in FIELDS], want, got, viaplain):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
        np.testing.assert_array_equal(p.numpy(), w.numpy(), err_msg=name)


def test_descriptor_words_follow_alignment():
    """A word divides the field's inner bytes and both addresses: a source
    block at an odd address drops to bytes."""
    dst = torch.zeros((N, 2), dtype=torch.int32)
    layout = FlushLayout(3, (kernels.FlushSlot(0, 1, N, 8, 24),), 32)
    assert field_descs([dst], layout, 4096)[0][5] == 8
    assert field_descs([dst], layout, 4100)[0][5] == 4
    assert field_descs([dst], layout, 4097)[0][5] == 1
    assert field_descs([dst[1:]], layout._replace(slots=(layout.slots[0]._replace(n=N - 1),)), 4096)[0][5] == 8


def test_node_view_refuses_other_axes():
    with pytest.raises(ValueError):
        kernels.node_view((4, 5, 6), 4, 1)
    with pytest.raises(ValueError):
        kernels.node_view((), 4, 0)


def _jax_fields(state) -> dict:
    return {f.name: np.asarray(jax.device_get(getattr(state, f.name))) for f in dataclasses.fields(state)}


def _random_like(a: np.ndarray, rng, shape) -> np.ndarray:
    if a.dtype == np.bool_:
        return rng.random(shape) < 0.5
    info = np.iinfo(a.dtype)
    return rng.integers(info.min, info.max, size=shape, dtype=a.dtype)


@pytest.mark.parametrize("seed,nrows", [(0, 1), (1, 8), (2, 40)])
def test_builder_flush_round_trip_matches_jax(seed, nrows):
    jb = _drive(JaxBuilder(), jnode, jpod, seed, True)
    tb = _drive(SnapshotBuilder(device="cpu"), tnode, tpod, seed, True)
    jb.state()
    tb.state()
    flushes, uploads = tb.flushes, tb.full_uploads
    rng = np.random.default_rng(seed + 7)
    rows = sorted(rng.choice(tb.schema.N, nrows, replace=False).tolist())
    for name, axis in _NODE_AXIS.items():
        a = tb.host[name]
        shape = (len(rows),) + a.shape[1:] if axis == 0 else (a.shape[0], len(rows))
        vals = _random_like(a, rng, shape)
        for h in (tb.host[name], jb.host[name]):
            if axis == 0:
                h[rows] = vals
            else:
                h[:, rows] = vals
    for row in rows:
        tb._dirty_rows.add(row)
        jb._dirty_rows.add(row)
    want = _jax_fields(jb.state())
    got = state_to_numpy(tb.state())
    assert (tb.flushes, tb.full_uploads) == (flushes + 1, uploads)
    assert tb.flush_copies == 0  # the CPU flush scatters from the host buffer itself
    for name in _NODE_AXIS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert tb.host_mirror_equal() and jb.host_mirror_equal()
