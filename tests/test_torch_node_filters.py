"""node_filters' pinned mode and the logic of its H100 kernel, on the CPU.

The plain ``node_filters(..., pin=)`` (each pod on its own row, through the
label and taint rows gathered at the pins) against the JAX pinned pass's
own-row evaluation: the JAX state sliced at the pins as
``build_pinned_pass`` slices it and each op's filter vmapped over the pods,
for NodeAffinity (node selectors, matchExpressions, metadata.name
matchFields and NodeName pins), TaintToleration, VolumeBinding and
VolumeZone, with repeated pins, a pin of -1 (evaluated on row 0, as the
pass's ``max(pin, 0)`` does) and padding lanes.  A numpy emulation of the
kernel's evaluation (node_filters.cu, node_program.cuh: each pod's header,
which says which ops need evaluating at all; a requirement's values
compared with the node's pair slots, its keys first asked of the set of
the node's keys below 128; the name operators without the slots; a
grouped program's valid terms each evaluated once into a mask of 64
groups a window; taints as masks up to a vocabulary of 64) against the
plain version on random programs and against JAX ``_eval_grouped``:
groups -1, invalid terms, a group with no terms, ngroups 0,
``*_feasible`` false, groups at and past the mask width.  The tiled
launch's shape (``nf_tile``).  Tolerance: none (exact)."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import common as jcommon
from kubernetes_tpu.ops.volumes import _eval_grouped as jax_eval_grouped
from kubernetes_tpu.snapshot import _NODE_AXIS as J_NODE_AXIS
from kubernetes_tpu.snapshot import ClusterState as JClusterState
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import plain
from kubernetes_tpu_torch.ops.common import PassContext
from kubernetes_tpu_torch.snapshot import INT_SENTINEL

from test_torch_pinned_pass import _inputs as pinned_inputs
from test_torch_volumes import featurized

OPS = ("NodeAffinity", "TaintToleration", "VolumeBinding", "VolumeZone")
PREFIXES = ("na_", "taint_", "vb_", "vz_")
GROUP_WORD = 64  # node_program.cuh kGroupWord
TAINT_MASK = 64  # node_filters.cu kTaintMask


def jax_own_rows(jstate, jbatch: dict, safe: np.ndarray, jctx) -> dict:
    """Each op's own-row verdicts (K,) as the JAX pinned pass computes
    them: every node-axis field gathered at the pins with a kept axis of 1,
    the op's filter vmapped over (state slice, pod features)."""
    sliced = {}
    for f in dataclasses.fields(JClusterState):
        a = getattr(jstate, f.name)
        if J_NODE_AXIS[f.name] == 0:
            sliced[f.name] = jnp.expand_dims(a[safe], 1)
        else:
            sliced[f.name] = jnp.expand_dims(jnp.moveaxis(a[:, safe], 1, 0), 2)
    state_k = JClusterState(**sliced)
    pf = {key: jnp.asarray(v) for key, v in jbatch.items() if key.startswith(PREFIXES)}
    out = {}
    for name, key in zip(OPS, ("na_sel_pairs", "taint_intol_hard", "vb_op", "vz_op")):
        if key in pf:
            op = jcommon.get(name)
            out[name] = np.asarray(jax.vmap(lambda st1, p: op.filter(st1, p, jctx))(state_k, pf))[:, 0]
    return out


def _hold(bits: np.ndarray, want: dict) -> None:
    for b, name in enumerate(OPS):
        got = (bits[:, 0] >> b) & 1
        if name in want:
            np.testing.assert_array_equal(got.astype(bool), want[name], err_msg=name)
        else:
            assert got.all(), name


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_pinned_plain_matches_jax_own_row_affinity_and_taints(seed):
    x = pinned_inputs(seed)
    jb, tb = x["jb"], x["tb"]
    pin = np.asarray(x["tbatch"]["pin_row"], np.int32)
    assert (pin == -1).any() and len(set(pin.tolist())) < len(pin)  # a -1 pin, repeated pins
    safe = np.maximum(pin, 0).astype(np.int32)
    jctx = jcommon.PassContext(profile=x["jprof"], schema=jb.schema, static={})
    tctx = PassContext(profile=x["tprof"], schema=tb.schema, static={})
    want = jax_own_rows(jb.state(), x["jbatch"], safe, jctx)
    assert {"NodeAffinity", "TaintToleration"} <= set(want)
    assert not want["NodeAffinity"][:24].all() and not want["TaintToleration"][:24].all()
    tpf = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x["tbatch"].items()}
    bits = plain.node_filters(tb.state(), tpf, tctx, torch.from_numpy(safe)).numpy()
    assert bits.shape == (len(pin), 1)
    _hold(bits, want)
    # The pinned plane is the full plane read at the pins.
    full = plain.node_filters(tb.state(), tpf, tctx).numpy()
    np.testing.assert_array_equal(bits[:, 0], full[np.arange(len(pin)), safe])


@pytest.mark.parametrize("seed", [31, 33])
def test_pinned_plain_matches_jax_own_row_volumes(seed):
    k = 32
    x = featurized(seed, k, crowd=True)
    jb, tb = x["jb"], x["tb"]
    rng = np.random.default_rng(seed)
    n_nodes = int(np.asarray(x["jstate"].valid).sum())
    pin = rng.integers(-1, n_nodes, size=k).astype(np.int32)
    pin[3] = pin[4] = pin[5]
    pin[6] = -1
    safe = np.maximum(pin, 0).astype(np.int32)
    jctx = jcommon.PassContext(profile=x["jp"], schema=jb.schema, static={})
    tctx = PassContext(profile=x["tp"], schema=tb.schema, static={})
    want = jax_own_rows(x["jstate"], x["jbatch"], safe, jctx)
    assert {"VolumeBinding", "VolumeZone"} <= set(want)
    assert not want["VolumeBinding"].all() or not want["VolumeZone"].all()
    tpf = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in x["tbatch"].items()}
    bits = plain.node_filters(x["tstate"], tpf, tctx, torch.from_numpy(safe)).numpy()
    _hold(bits, want)


# -- random programs ---------------------------------------------------------------------


def random_case(seed: int, k: int = 12, n: int = 20, t: int = 5, v: int = 6, tb: int = 70, added: bool = True,
                tv: int = 7, ls: int = 6):
    """A node state of ``n`` rows (label keys 0-5 with pairs key * 8 +
    value, integers or the sentinel, pads; taints) and ``k`` pods whose
    programs draw every opcode (pads, unknown ones, False), keys, pair and
    name ids and -1 pads at random, with up to ``v`` values a requirement;
    VolumeBinding with ``tb`` terms whose groups run past the mask width,
    VolumeZone with few; pods with no groups, infeasible pods, invalid
    terms; a taint vocabulary of ``tv`` (past 64 the kernel walks the
    taint slots); ``ls`` label slots a node.  Returns (state, pf, ctx) of torch CPU tensors."""
    rng = np.random.default_rng(seed)
    ts = 3
    keys = rng.integers(-1, 6, size=(n, ls)).astype(np.int32)
    vals = rng.integers(0, 4, size=(n, ls))
    pairs = np.where(keys >= 0, keys * 8 + vals, -1).astype(np.int32)
    ints = np.where(rng.random((n, ls)) < 0.2, INT_SENTINEL, vals * 7 - 5).astype(np.int64)
    ints[0, :2] = np.int64(2**62)  # a wrap-around sum where one key repeats
    keys[0, :2] = 3
    keys[1, 0] = 131  # a key past the summary's 128: node 1's keys are walked
    state = SimpleNamespace(
        valid=torch.ones(n, dtype=torch.bool),
        label_key_ids=torch.from_numpy(keys), label_pair_ids=torch.from_numpy(pairs),
        label_int_vals=torch.from_numpy(ints),
        name_id=torch.from_numpy(rng.permutation(n).astype(np.int32)),
        taint_ids=torch.from_numpy(rng.integers(-1, tv, size=(n, ts)).astype(np.int32)),
    )

    def program(prefix: str, t_: int, q_: int, v_: int, valid_p: float = 0.8) -> dict:
        return {
            f"{prefix}_op": rng.integers(-1, 10, size=(k, t_, q_)).astype(np.int32),
            f"{prefix}_key": rng.integers(-1, 6, size=(k, t_, q_)).astype(np.int32),
            f"{prefix}_vals": rng.integers(-1, 48, size=(k, t_, q_, v_)).astype(np.int32),
            f"{prefix}_int": rng.integers(-8, 25, size=(k, t_, q_)).astype(np.int64),
            f"{prefix}_term_valid": rng.random((k, t_)) < valid_p,
        }

    pf = {"valid": np.arange(k) < k - 2}
    pf["na_sel_pairs"] = np.where(rng.random((k, 2)) < 0.3, rng.integers(0, 48, size=(k, 2)), -1).astype(np.int32)
    pf["na_has_required"] = rng.random(k) < 0.8
    pf.update(program("na_req", t, 2, v))
    pf["na_has_added"] = rng.random(k) < 0.5
    pf.update(program("na_add", 2, 2, 3))
    pf["taint_intol_hard"] = rng.random((k, tv)) < (0.2 if tv <= TAINT_MASK else 0.02)
    for prefix, t_, q_ in (("vb", tb, 1), ("vz", 3, 2)):
        pf.update(program(prefix, t_, q_, 2, 0.9))
        # Mostly always-true terms (pads), so groups are often satisfied.
        pf[f"{prefix}_op"] = np.where(rng.random((k, t_, q_)) < 0.6, -1, pf[f"{prefix}_op"]).astype(np.int32)
        ngroups = rng.integers(0, t_ + 1, size=k).astype(np.int32)
        ngroups[0] = 0
        ngroups[1] = t_  # every group, up to the term count
        group = rng.integers(-1, t_, size=(k, t_)).astype(np.int32)
        group[1] = np.arange(t_)  # term g in group g: groups at and past the mask width
        group[2, :] = -1  # no term in any group
        pf[f"{prefix}_group"] = group
        pf[f"{prefix}_ngroups"] = ngroups
        feas = rng.random(k) < 0.9
        feas[3] = False
        pf[f"{prefix}_feasible"] = feas
    pf = {key: torch.from_numpy(np.ascontiguousarray(a)) for key, a in pf.items()}
    ctx = SimpleNamespace(profile=SimpleNamespace(added_affinity=object() if added else None))
    return state, pf, ctx


def _np(pf: dict, state) -> tuple[dict, dict]:
    return ({key: v.numpy() for key, v in pf.items()},
            {f: getattr(state, f).numpy() for f in ("label_key_ids", "label_pair_ids", "label_int_vals",
                                                     "name_id", "taint_ids")})


def summary(st: dict, n: int) -> dict:
    """node_program::RegNode::load of node n: its keys below 128 and
    whether every key is below 128."""
    keys = {int(k) & 127 for k in st["label_key_ids"][n] if k >= 0}
    return {"keys": keys, "exact": all(k < 128 for k in st["label_key_ids"][n])}


def emu_requirement(p: dict, prefix: str, c: int, t: int, q: int, st: dict, n: int, sm: dict) -> bool:
    """node_program::requirement on a RegNode, step by step."""
    op = int(p[f"{prefix}_op"][c, t, q])
    if op == 8:
        return False
    if op < 0 or op > 7:
        return True
    vals = [int(x) for x in p[f"{prefix}_vals"][c, t, q]]
    if op >= 6:
        hit = any(w >= 0 and w == int(st["name_id"][n]) for w in vals)
        return (op == 6) == hit
    if op <= 1:  # each value against every pair slot
        hit = any(w >= 0 and w in st["label_pair_ids"][n] for w in vals)
        return (op == 0) == hit
    key = int(p[f"{prefix}_key"][c, t, q])
    known = -1
    if 0 <= key < 128:
        known = 0 if key not in sm["keys"] else (1 if sm["exact"] else -1)
    if known == 0:
        return op == 3
    if known == 1 and op <= 3:
        return op == 2
    has, total = False, 0
    for kk, num in zip(st["label_key_ids"][n], st["label_int_vals"][n]):
        if int(kk) == key:
            has = True
            total = (total + int(num)) & (2**64 - 1)
    if op <= 3:
        return (op == 2) == has
    total = total - 2**64 if total >= 2**63 else total
    if not has or total == int(INT_SENTINEL):
        return False
    want = int(p[f"{prefix}_int"][c, t, q])
    return total > want if op == 4 else total < want


def emu_term(p, prefix, c, t, st, n) -> bool:
    sm = summary(st, n)
    return all(emu_requirement(p, prefix, c, t, q, st, n, sm) for q in range(p[f"{prefix}_op"].shape[2]))


def emu_grouped(p: dict, prefix: str, c: int, st: dict, n: int, evaluated: list | None = None) -> bool:
    """node_program::grouped: each valid term of a window's groups
    evaluated at most once, its hit OR-ed into a 64-bit mask."""
    t_dim = p[f"{prefix}_op"].shape[1]
    g_all = min(int(p[f"{prefix}_ngroups"][c]), t_dim)
    for g0 in range(0, g_all, GROUP_WORD):
        width = min(GROUP_WORD, g_all - g0)
        need = (1 << width) - 1
        hit = 0
        for t in range(t_dim):
            if hit == need:
                break
            g = int(p[f"{prefix}_group"][c, t]) - g0
            if g < 0 or g >= width or not p[f"{prefix}_term_valid"][c, t] or hit >> g & 1:
                continue
            if evaluated is not None:
                evaluated.append(t)
            if emu_term(p, prefix, c, t, st, n):
                hit |= 1 << g
        if hit != need:
            return False
    return True


def emu_header(p: dict, added: bool, c: int) -> set:
    """node_filters.cu pod_header: the ops pod c needs evaluated, or that
    fail everywhere."""
    head = set()
    if (p["na_sel_pairs"][c] >= 0).any() or p["na_has_required"][c] or (added and p["na_has_added"][c]):
        head.add("na")
    for prefix in ("vb", "vz"):
        if not p[f"{prefix}_feasible"][c]:
            head.add(f"{prefix} fails")
        elif min(int(p[f"{prefix}_ngroups"][c]), p[f"{prefix}_op"].shape[1]) > 0:
            head.add(prefix)
    return head


def emu_bits(p: dict, st: dict, added: bool, c: int, n: int) -> int:
    """node_filters.cu pod_bits for pod c on node n."""
    head = emu_header(p, added, c)
    na = True
    if "na" in head:
        for want in p["na_sel_pairs"][c]:
            if want >= 0 and want not in st["label_pair_ids"][n]:
                na = False
                break

        def any_term(prefix):
            return any(p[f"{prefix}_term_valid"][c, t] and emu_term(p, prefix, c, t, st, n)
                       for t in range(p[f"{prefix}_op"].shape[1]))

        if na and p["na_has_required"][c]:
            na = any_term("na_req")
        if na and added and p["na_has_added"][c]:
            na = any_term("na_add")
    tv = p["taint_intol_hard"].shape[1]
    if tv <= TAINT_MASK:  # the node's ids as a mask against the pod's
        node = sum(1 << int(x) for x in set(st["taint_ids"][n].tolist()) if 0 <= x < tv)
        pod = sum(1 << i for i in range(tv) if p["taint_intol_hard"][c, i])
        tol = node & pod == 0
    else:
        tol = not any(0 <= x < tv and p["taint_intol_hard"][c, x] for x in st["taint_ids"][n])
    vb = "vb fails" not in head and ("vb" not in head or emu_grouped(p, "vb", c, st, n))
    vz = "vz fails" not in head and ("vz" not in head or emu_grouped(p, "vz", c, st, n))
    return int(na) | int(tol) << 1 | int(vb) << 2 | int(vz) << 3


@pytest.mark.parametrize("seed,added,tv", [(0, True, 7), (1, False, 7), (2, True, 70)])
def test_kernel_emulation_matches_plain(seed, added, tv):
    state, pf, ctx = random_case(seed, added=added, tv=tv)
    want = plain.node_filters(state, pf, ctx).numpy()
    p, st = _np(pf, state)
    k, n = want.shape
    got = np.array([[emu_bits(p, st, added, c, m) for m in range(n)] for c in range(k)], np.uint8)
    np.testing.assert_array_equal(got, want)
    for b in range(4):  # every bit both ways
        assert ((want >> b) & 1).any() and not ((want >> b) & 1).all(), b
    pin = torch.from_numpy(np.random.default_rng(seed).integers(0, n, size=k).astype(np.int32))
    own = plain.node_filters(state, pf, ctx, pin).numpy()
    np.testing.assert_array_equal(own[:, 0], want[np.arange(k), pin.numpy()])


@pytest.mark.parametrize("seed,tb", [(5, 64), (6, 65), (7, 130)])
def test_grouped_mask_emulation_matches_jax_eval_grouped(seed, tb):
    """The mask-window evaluation against JAX _eval_grouped pod by pod
    (VolumeBinding's program, ``tb`` terms: groups at the mask width, one
    past it, two windows), and each valid term evaluated at most once."""
    state, pf, _ctx = random_case(seed, k=10, n=12, tb=tb)
    p, st = _np(pf, state)
    jst = SimpleNamespace(**{f: jnp.asarray(a) for f, a in st.items()})
    for c in range(10):
        jpf = {key[3:]: jnp.asarray(v[c]) for key, v in p.items() if key.startswith("vb_")}
        want = np.asarray(jax_eval_grouped(jst, {f"vb_{key}": v for key, v in jpf.items()}, "vb"))
        for m in range(12):
            evaluated: list = []
            assert emu_grouped(p, "vb", c, st, m, evaluated) == bool(want[m]), (c, m)
            assert len(evaluated) == len(set(evaluated))
    assert p["vb_ngroups"][1] == tb and (p["vb_group"][1] == np.arange(tb)).all()


# -- launch shape --------------------------------------------------------------------------


def test_nf_tile_fills_the_card():
    for k, n in ((4096, 8192), (4096, 16384), (1024, 8192), (1, 8192), (8, 1024), (3, 10), (200000, 8)):
        nt, p = kernels.nf_tile(k, n, 132)
        assert kernels.NF_TILE_MIN <= nt <= kernels.NF_TILE <= 256 and nt % 32 == 0
        assert 1 <= p <= min(k, kernels.NF_GROUP) and p <= nt
        blocks = -(-n // nt) * -(-k // p)
        # NF_BLOCKS_PER_SM blocks an SM, unless the tile and the group are
        # at their least, and no more halving than that needs.
        assert blocks >= kernels.NF_BLOCKS_PER_SM * 132 or (p == 1 and nt == kernels.NF_TILE_MIN)
        if (nt, p) != (kernels.NF_TILE, min(k, kernels.NF_GROUP)):
            wider = (nt, 2 * p) if nt == kernels.NF_TILE else (2 * nt, p)
            assert -(-n // wider[0]) * -(-k // wider[1]) < kernels.NF_BLOCKS_PER_SM * 132
    # The swept shapes (pv and incl., spread, search, cols).
    assert kernels.nf_tile(4096, 8192, 132) == (kernels.NF_TILE, kernels.NF_GROUP) == (128, 32)
    assert kernels.nf_tile(4096, 1024, 132) == (128, 16)
    assert kernels.nf_tile(1024, 8192, 132) == (128, 32)
    assert kernels.nf_tile(1, 8192, 132) == (32, 1)
    with pytest.raises(NotImplementedError, match="2\\^31"):
        kernels.nf_tile(2**31, 2**20, 132)


@pytest.mark.parametrize("seed", [0, 2])
def test_pod_headers_answer_without_the_programs(seed):
    """A pod whose header asks no NodeAffinity evaluation passes bit 0 on
    every node; an infeasible volume pod fails its bit everywhere; a
    feasible one without groups passes it everywhere: the plain version
    agrees with each header on every node."""
    state, pf, ctx = random_case(seed, k=24)
    pf["na_has_required"][:6] = False
    pf["na_has_added"][:6] = False
    pf["na_sel_pairs"][:6] = -1
    bits = plain.node_filters(state, pf, ctx).numpy()
    p, _st = _np(pf, state)
    seen = set()
    for c in range(24):
        head = emu_header(p, True, c)
        if "na" not in head:
            assert (bits[c] & 1).all()
        for prefix, bit in (("vb", 4), ("vz", 8)):
            if f"{prefix} fails" in head:
                assert not (bits[c] & bit).any()
            elif prefix not in head:
                assert (bits[c] & bit).all()
        seen |= head
    assert {"na", "vb", "vb fails", "vz", "vz fails"} <= seen
