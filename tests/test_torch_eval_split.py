"""preempt_eval's one launch (kubernetes_tpu_torch/kernels/csrc/preempt.cu,
preempt_eval_kernel), emulated here in numpy step for step: a group of L
lanes a node (kernels.eval_lanes: the power of two >= V, at most 32), lane
l owning slots l and l + L and resources l, l + L, ..., the phase-1 mask
built from the lanes' ballots (bit j*L + l), the node's requests copied to
the group and each resource's release summed over the masked slots by its
lane; the representative found by each warp's ballots, four rounds of 32
mates in flight; in FULL the node's victim id spans copied to the group,
every live count gathered once (at the representative's port triples and
keys, devices, CSI volumes, drivers, claims and pools, and at the victims'
own CSI and claim ids) and carried less the masked slots holding it (a
reduction over the lanes, each counting its own slots; the victims'
crossing counts by each lane's walk of the group's masked ids); the
reprieve in lockstep from slot V-1 down, each lane taking slot s's
requests of its resources from the group's copy, each count a tentative
mask reads moved by what slot s holds,
the counts moved for good when the group takes the reprieve; the criteria
from ballots (the PDB counts, the victim count) and reductions (the
extrema and sums in int64, the earliest start at the top priority); TAIL
from the carry.

It is held exactly against the port's plain preempt_eval
(kernels/plain.py) in FULL, PROLOGUE and TAIL (on the prologue's carry and
on a drawn one), on chip_smoke.eval_case's inputs: V = 1, 2, 3, 8, 16, 33
and 64 at their own L and at a forced one (every L of 1, 2, 4, 8, 16, 32
for V = 1), R = 1 and 4, 0-3 PDBs, the closed-form fit alone, each op
family alone (ports with wildcard keys and triples shared between
victims; VolumeRestrictions with a ReadWriteOncePod-blocked
representative; NodeVolumeLimits with volumes shared by victims and
driver crossings; DynamicResources with shared claims, count-only slots,
phantom charges and pins elsewhere) and all four together, ties at the top
priority with infinite starts, no victim below the priority, the
representative late in a C = 1024 chunk or none valid, and the speculative
view; a test checks that the cases reach every crossing rule.  With the
emulation in the port's dry-run pass in place of the plain version, the
ports, devices, CSI, DRA and all-op passes equal JAX build_preempt_pass
(the scenarios of tests/test_torch_preemption_search.py and
tests/test_torch_dra_preemption.py).  eval_split's geometry is in
tests/test_torch_kernels.py.  Tolerance: none (exact)."""

import numpy as np
import pytest
import torch

import chip_smoke
import kubernetes_tpu  # noqa: F401  (turns on JAX's int64)
from kubernetes_tpu import preemption as jpre
from kubernetes_tpu_torch import preemption as tpre
from kubernetes_tpu_torch.kernels import SearchCarry, eval_lanes, plain
from kubernetes_tpu_torch.snapshot import state_from_numpy

I32_MAX = 2**31 - 1
NO_START = -(2**61)
REP_BATCH = 4  # preempt.cu kRepBatch
LANES = (1, 2, 4, 8, 16, 32)
VS = (1, 2, 3, 8, 16, 33, 64)
OPS = chip_smoke.EVAL_CASE_OPS
KINDS = chip_smoke.EVAL_CASE_KINDS
OUTS = ("possible", "crit", "vic_mask", "n_vic", "rel", "relnz")


# ---- the kernel, emulated ---------------------------------------------------

def representative(pf: dict) -> tuple[int, bool]:
    """(i0, a mate is valid): a warp's rounds of REP_BATCH x 32 mates, the
    first set bit of the first ballot that has one."""
    valid = plain.mate_valid(pf).numpy()
    c, found, base = len(valid), -1, 0
    while base < c and found < 0:
        for b in range(REP_BATCH):
            window = valid[base + 32 * b:base + 32 * (b + 1)]
            if found < 0 and window.any():
                found = base + 32 * b + int(np.argmax(window))
        base += 32 * REP_BATCH
    return (found, True) if found >= 0 else (0, False)


class Group:
    """Every node's group of L lanes: slot v = j*L + lane, j < J (J = 2 at
    L = 32, else 1)."""

    def __init__(self, n: int, v: int, lanes: int):
        self.n, self.v, self.L = n, v, lanes
        self.J = 2 if lanes == 32 else 1
        assert lanes in LANES and v <= lanes * self.J

    def lanes(self, x: np.ndarray, fill) -> np.ndarray:
        """(N, V, ...) → (N, J, L, ...), the slots past V at ``fill``."""
        pad = np.full((self.n, self.J * self.L - self.v) + x.shape[2:], fill, x.dtype)
        return np.concatenate([x, pad], axis=1).reshape((self.n, self.J, self.L) + x.shape[2:])

    def ballot(self, pred: np.ndarray) -> np.ndarray:
        """(N, J, L) → the (N, V) mask: ballot j's bit l is slot j*L + l."""
        return pred.reshape(self.n, self.J * self.L)[:, :self.v]

    def reduce(self, x: np.ndarray, op=np.sum) -> np.ndarray:
        """Each lane over its J slots, then the group over its L lanes."""
        return op(op(x, axis=1), axis=1)

    def per_slot(self, x: np.ndarray, op=np.sum) -> np.ndarray:
        """A group reduction of a per-slot (N, V[, W]) quantity, each slot
        summed over its width first."""
        if x.ndim == 3:
            x = x.sum(axis=2)
        return self.reduce(self.lanes(x, 0), op)


def _span(vf: dict, key: str, n: int, v: int, clamp: bool = False) -> np.ndarray:
    """Node n's V x width ids of one table, as the group's copy holds them
    (-1 pads, clamped at 0 where the kernel clamps); width 0 when absent."""
    if key not in vf:
        return np.zeros((n, v, 0), np.int64)
    x = vf[key].numpy().astype(np.int64)
    return np.maximum(x, 0) if clamp else x


class Ops:
    """EvalOps: the node-local ops' spans, live counts and counters of every
    node's group, on the masked state (``load``), a tentative mask
    (``ok``) and a taken reprieve (``take``).  ``stats`` counts what the
    cases reach."""

    def __init__(self, state, vic, pf: dict, spec, i0: int, mask: np.ndarray, grp: Group, hard, stats: dict):
        n, v = mask.shape
        self.grp, self.stats, self.hard = grp, stats, hard
        self.spec = spec
        node = np.arange(n)
        vf = vic.vfeat or {}
        col = lambda key: pf[key][i0].numpy().astype(np.int64) if key in pf else np.zeros(0, np.int64)  # noqa: E731
        self.on = {"ports": spec.ports, "vr": spec.vr, "nvl": spec.nvl, "dra": spec.dra}
        # NodePorts: the representative's slots and two counters a slot.
        self.pt, self.pk = _span(vf, "port_triples", n, v), _span(vf, "port_keys", n, v, True)
        self.rtr = col("port_triples") if spec.ports else np.zeros(0, np.int64)
        self.rk, self.rw = np.maximum(col("port_keys"), 0), np.maximum(col("port_wild_triples"), 0)
        self.ri = col("port_is_wild").astype(bool)
        pc, kc = state.port_counts.numpy(), state.portkey_counts.numpy()
        self.A = [kc[self.rk[q], node] if self.ri[q] else pc[max(t, 0), node] for q, t in enumerate(self.rtr)]
        self.B = [pc[self.rw[q], node] for q in range(len(self.rtr))]
        # VolumeRestrictions.
        self.vi, self.vw = _span(vf, "vol_dev_ids", n, v), _span(vf, "vol_dev_rw", n, v)
        self.rvi = col("vol_dev_ids") if spec.vr else np.zeros(0, np.int64)
        self.rvw = col("vol_dev_rw").astype(bool)
        dc, drc = state.dev_counts.numpy(), state.dev_rw_counts.numpy()
        self.C = [(dc if self.rvw[q] else drc)[max(i, 0), node] for q, i in enumerate(self.rvi)]
        # NodeVolumeLimits: counters, the drivers' used and limit, the
        # victims' own volumes' live counts.
        self.ci, self.cd = _span(vf, "csi_ids", n, v), _span(vf, "csi_drv", n, v, True)
        self.rci = col("vol_csi_ids") if spec.nvl else np.zeros(0, np.int64)
        self.rcd = col("vol_csi_drv")
        self.dr = state.csi_used.shape[0]
        cv = state.csivol_counts.numpy()
        self.D = [cv[max(i, 0), node] for i in self.rci]
        driver = lambda table, d: table.numpy()[d, node] if 0 <= d < self.dr else np.zeros(n, np.int32)  # noqa: E731
        self.U = [driver(state.csi_used, d) for d in self.rcd]
        self.LIM = [driver(state.csi_limit, d) for d in self.rcd]
        self.cl = np.where(self.ci >= 0, cv[np.maximum(self.ci, 0), node[:, None, None]], 0)
        # DynamicResources.
        self.ki, self.kc = _span(vf, "dra_kid", n, v), _span(vf, "dra_cid", n, v, True)
        self.kn, self.kf = _span(vf, "dra_cnt", n, v), _span(vf, "dra_first", n, v) > 0
        self.rki = col("dra_claim_ids") if spec.dra else np.zeros(0, np.int64)
        self.rkc, self.rkn = col("dra_claim_cls"), col("dra_claim_cnt")
        self.dc = state.dra_cap.shape[0]
        cc = state.dra_claim_counts.numpy()
        pool = lambda table, d: table.numpy()[d, node] if 0 <= d < self.dc else np.zeros(n, np.int32)  # noqa: E731
        self.K = [cc[max(i, 0), node] for i in self.rki]
        self.AL = [pool(state.dra_alloc, d) for d in self.rkc]
        self.CP = [pool(state.dra_cap, d) for d in self.rkc]
        self.kl = np.where(self.ki >= 0, cc[np.maximum(self.ki, 0), node[:, None, None]], 0)
        # The victims' crossing counts: each lane walks the group's masked
        # ids for its own (a kernel lane takes elements lane, lane + L, ...).
        self.ch = self._held_own(self.ci, np.ones_like(self.ci, bool), mask)
        self.kh = self._held_own(self.ki, self.kf, mask)
        # Each counter less the masked slots holding its id, reduced over
        # the lanes.
        m = mask[:, :, None]
        for q, t in enumerate(self.rtr):
            if t < 0:
                continue
            if self.ri[q]:
                self.A[q] = self.A[q] - grp.per_slot(m & (self.pt >= 0) & (self.pk == self.rk[q]))
            else:
                self.A[q] = self.A[q] - grp.per_slot(m & (self.pt == t))
                self.B[q] = self.B[q] - grp.per_slot(m & (self.pt == self.rw[q]))
            stats["shared triple"] += int((grp.per_slot(m & (self.pt == t)) >= 2).sum())
        for q, i in enumerate(self.rvi):
            if i >= 0:
                self.C[q] = self.C[q] - grp.per_slot(m & (self.vi == i) & (self.rvw[q] | (self.vw > 0)))
        for q, i in enumerate(self.rci):
            if i >= 0:
                self.D[q] = self.D[q] - grp.per_slot(m & (self.ci == i))
        for q, i in enumerate(self.rki):
            if i >= 0:
                self.K[q] = self.K[q] - grp.per_slot(m & (self.ki == i) & self.kf)

    @staticmethod
    def _held_own(ids: np.ndarray, gate: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(N, V, W): for each entry, the group's masked entries (gated)
        holding its id; 0 where the id is -1."""
        same = (ids[:, :, :, None, None] == ids[:, None, None, :, :]) & (gate & mask[:, :, None])[:, None, None]
        return np.where(ids >= 0, same.sum(axis=(3, 4)), 0)

    @staticmethod
    def _at_s(span: np.ndarray, s: int, ids, gate=None) -> np.ndarray:
        """Slot s's entries equal to ``ids`` (a scalar, or (N, V, W) per
        entry), gated; 0 with no slot (s < 0)."""
        n = span.shape[0]
        if s < 0:
            return np.zeros(np.shape(ids) if np.ndim(ids) else n, np.int64)
        row = span[:, s, :]
        g = np.ones_like(row, bool) if gate is None else gate[:, s, :]
        if np.ndim(ids) == 0:
            return ((row == ids) & g).sum(axis=1)
        return ((row[:, None, None, :] == ids[:, :, :, None]) & g[:, None, None, :]).sum(axis=3)

    def _own_q(self, nq: int, lane_ok) -> np.ndarray:
        """Each lane's own slots q (q % L), then g.all over the lanes."""
        ok = np.ones((self.grp.n, self.grp.L), bool)
        for q in range(nq):
            ok[:, q % self.grp.L] &= lane_ok(q)
        return ok.all(axis=1)

    def ok(self, tent: np.ndarray, s: int) -> np.ndarray:
        n = tent.shape[0]
        grp, stats = self.grp, self.stats
        out = np.ones(n, bool)
        if self.on["ports"]:
            def port_ok(q):
                t = self.rtr[q]
                if t < 0:
                    return True
                if self.ri[q]:
                    stats["wildcard"] += 1
                    x = self.A[q] + self._at_s(self.pk, s, self.rk[q], self.pt >= 0)
                    return x <= 0
                exact = self.A[q] + self._at_s(self.pt, s, t) <= 0
                return exact & (self.B[q] + self._at_s(self.pt, s, self.rw[q]) <= 0)
            out &= self._own_q(len(self.rtr), port_ok)
        if self.on["vr"]:
            def dev_ok(q):
                i = self.rvi[q]
                if i < 0:
                    return True
                return self.C[q] + self._at_s(self.vi, s, i, None if self.rvw[q] else self.vw > 0) <= 0
            out &= self._own_q(len(self.rvi), dev_ok)
        m = tent[:, :, None]
        if self.on["nvl"]:
            qc = len(self.rci)
            newv = np.zeros((n, qc), bool)
            for q, i in enumerate(self.rci):
                if i >= 0:
                    newv[:, q] = self.D[q] + self._at_s(self.ci, s, i) <= 0
            h = self.ch - np.where(self.ci >= 0, self._at_s(self.ci, s, self.ci), 0)
            crossed = m & (self.ci >= 0) & (self.cl - h == 0)
            stats["csi crossing shared"] += int((crossed & (h >= 2)).sum())
            for q in range(qc):
                d = self.rcd[q]
                if d < 0 or d >= self.dr:
                    continue
                same = newv & (self.rcd == d)[None, :]
                first = newv[:, q] & ~same[:, :q].any(axis=1)
                freed = grp.per_slot(crossed & (self.cd == d))
                out &= ~first | (self.U[q].astype(np.int64) - freed + same.sum(axis=1) <= self.LIM[q])
        if self.on["dra"]:
            out &= self.hard
            h = self.kh - np.where(self.ki >= 0, self._at_s(self.ki, s, self.ki, self.kf), 0)
            crossed = m & (self.ki >= 0) & (self.kl - h == 0)
            stats["claim crossing shared"] += int((crossed & (h >= 2)).sum())
            stats["count-only slot crossing"] += int((crossed & self.kf & (self.kn == 0)).sum())
            stats["phantom charge"] += int((m & (self.ki >= 0) & (self.kl - h > 0)).sum())
            for q, i in enumerate(self.rki):
                d = self.rkc[q]
                if i < 0 or d < 0 or d >= self.dc or any(self.rki[q2] >= 0 and self.rkc[q2] == d for q2 in range(q)):
                    continue
                need = np.zeros(n, np.int64)
                for q2, i2 in enumerate(self.rki):
                    if i2 >= 0 and self.rkc[q2] == d:
                        need += np.where(self.K[q2] + self._at_s(self.ki, s, i2, self.kf) <= 0, self.rkn[q2], 0)
                freed = grp.per_slot(np.where(crossed & (self.kc == d), self.kn, 0))
                out &= (need == 0) | (self.AL[q].astype(np.int64) - freed + need <= self.CP[q])
        return out

    def take(self, s: int, sel: np.ndarray) -> None:
        """Slot s reprieved on the nodes ``sel``: every count moves by what s
        holds."""
        add = lambda x, dx: np.where(sel, x + dx, x)  # noqa: E731
        for q, t in enumerate(self.rtr):
            if t < 0:
                continue
            if self.ri[q]:
                self.A[q] = add(self.A[q], self._at_s(self.pk, s, self.rk[q], self.pt >= 0))
            else:
                self.A[q] = add(self.A[q], self._at_s(self.pt, s, t))
                self.B[q] = add(self.B[q], self._at_s(self.pt, s, self.rw[q]))
        for q, i in enumerate(self.rvi):
            if i >= 0:
                self.C[q] = add(self.C[q], self._at_s(self.vi, s, i, None if self.rvw[q] else self.vw > 0))
        for q, i in enumerate(self.rci):
            if i >= 0:
                self.D[q] = add(self.D[q], self._at_s(self.ci, s, i))
        for q, i in enumerate(self.rki):
            if i >= 0:
                self.K[q] = add(self.K[q], self._at_s(self.ki, s, i, self.kf))
        sel3 = sel[:, None, None]
        self.ch = self.ch - np.where(sel3 & (self.ci >= 0), self._at_s(self.ci, s, self.ci), 0)
        self.kh = self.kh - np.where(sel3 & (self.ki >= 0), self._at_s(self.ki, s, self.ki, self.kf), 0)


def tail(vic, grp: Group, mask: np.ndarray, flags: np.ndarray, rep_ok: bool):
    """eval_tail: (possible, crit, vic_mask, n_vic, relnz) of the final
    masks, from the group's ballots and reductions."""
    prio = grp.lanes(vic.prio.numpy(), I32_MAX)
    m = grp.lanes(mask, False)
    nv = grp.reduce(m.astype(np.int64))
    possible = ((flags.astype(np.int64) & 7) == 7) & (nv >= 1) & rep_ok
    pdb, allowed = grp.lanes(vic.pdb.numpy(), False), vic.allowed.numpy()
    violations = np.zeros(grp.n, np.int64)
    for q in range(len(allowed)):
        violations += np.maximum(grp.reduce((m & pdb[..., q]).astype(np.int64)) - allowed[q], 0)
    top = grp.reduce(np.where(m, prio, -1), np.max)
    prio_sum = grp.reduce(np.where(m, prio.astype(np.int64), 0))
    relnz = np.stack([grp.reduce(np.where(m, grp.lanes(vic.nonzero.numpy()[..., k], 0), 0)) for k in (0, 1)], 1)
    start = grp.lanes(vic.start.numpy(), np.inf)
    first = grp.reduce(np.where(m & (prio == top[:, None, None]), start, np.inf), np.min)
    fin = np.isfinite(first)
    key = np.where(fin, (-np.where(fin, first, 0.0) * 1e6).astype(np.int64), NO_START)
    crit = np.stack([violations, top.astype(np.int64), prio_sum, nv, key])
    return possible, crit, grp.ballot(m), nv.astype(np.int32), relnz


def emulate(state, vic, pf: dict, spec, mode: int = plain.FULL, carry=None, lanes=None, stats=None):
    """preempt_eval's launch in ``mode`` at L = ``lanes`` (eval_lanes(V)
    when None): plain.preempt_eval's outputs, as torch tensors."""
    stats = stats if stats is not None else _stats()
    n, v = vic.prio.shape
    grp = Group(n, v, eval_lanes(v) if lanes is None else lanes)
    i0, rep_ok = representative(pf)
    if mode == plain.TAIL:
        bits = carry.mask.numpy()
        mask = ((bits[:, None] >> np.arange(v)) & 1).astype(bool)
        possible, crit, vmask, n_vic, relnz = tail(vic, grp, mask, carry.flags.numpy(), rep_ok)
        return _torch(possible, crit, vmask, n_vic, carry.rel.numpy().copy(), relnz)
    base = state.valid.numpy().copy()
    if spec.check_unsched:
        base &= ~state.unschedulable.numpy() | bool(pf["tolerates_unschedulable"][i0])
    if spec.check_nodename:
        want = int(pf["nodename_id"][i0])
        base &= (want == -1) | (state.name_id.numpy() == want)
    if spec.bits_mask:
        base &= (pf["node_bits"][i0].numpy().astype(np.int64) & spec.bits_mask) == spec.bits_mask
    hard = np.ones(n, bool)
    if spec.dra:
        pins = pf["dra_pin_ids"][i0].numpy()
        pinned = (pins[None, :] < 0) | (pins[None, :] == state.name_id.numpy()[:, None])
        hard = pinned.all(axis=1) & (not bool(pf["dra_missing"][i0]))
    base &= hard
    prio = grp.lanes(vic.prio.numpy(), I32_MAX)
    req = vic.req.numpy()  # the group's copy
    exists = grp.lanes(np.ones((n, v), bool), False)
    low = exists & (prio < int(pf["priority"][i0]))
    mask = grp.ballot(low).copy()
    cnt = mask.sum(axis=1)
    rel = np.where(mask[:, :, None], req, 0).sum(axis=1)  # lane r % L sums resource r
    flags = np.where(base, plain.F_BASE, 0) | plain.F_HARD
    if mode == plain.PROLOGUE:
        bits = (mask.astype(np.int64) << np.arange(v)).sum(axis=1)
        return SearchCarry(*(torch.from_numpy(x) for x in (bits, rel, cnt.astype(np.int32), flags.astype(np.uint8))))
    alloc, sreq = state.alloc.numpy(), state.req.numpy()
    slack = alloc - sreq  # int64 wrap-around, as the kernel's unsigned sum
    demand = pf["req"][i0].numpy()
    pods, allowed = state.num_pods.numpy().astype(np.int64), state.allowed_pods.numpy()

    def fits(t_rel, c):
        free = slack + t_rel
        return (pods - c + 1 <= allowed) & ((demand[None, :] == 0) | (demand[None, :] <= free)).all(axis=1)

    ops = Ops(state, vic, pf, spec, i0, mask, grp, hard, stats)
    feas = fits(rel, cnt) & ops.ok(mask, -1)
    flags = flags | np.where(feas, plain.F_FEAS, 0)
    if not (spec.vr and not bool(pf["vr_rwop_ok"][i0])):
        for s in range(v - 1, -1, -1):
            act = feas & mask[:, s]
            if not act.any():
                continue
            t_rel = rel - req[:, s]  # each lane reads slot s's requests of its resources
            tent = mask.copy()
            tent[:, s] = False
            take = act & fits(t_rel, cnt - 1) & ops.ok(tent, s)
            stats["reprieves"] += int(take.sum())
            mask[:, s] &= ~take
            rel = np.where(take[:, None], t_rel, rel)
            cnt = cnt - take
            ops.take(s, take)
    possible, crit, vmask, n_vic, relnz = tail(vic, grp, mask, flags, rep_ok)
    return _torch(possible, crit, vmask, n_vic, rel, relnz)


def _torch(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _stats() -> dict:
    return dict.fromkeys(("reprieves", "wildcard", "shared triple", "csi crossing shared", "claim crossing shared",
                          "count-only slot crossing", "phantom charge"), 0)


# ---- against the plain version ----------------------------------------------

def check(state, vic, pf, spec, rng, lanes=None, stats=None, where=""):
    """The emulation against plain.preempt_eval in FULL, PROLOGUE and TAIL
    (the prologue's carry and a drawn one)."""
    v = vic.prio.shape[1]
    got, want = emulate(state, vic, pf, spec, lanes=lanes, stats=stats), plain.preempt_eval(state, vic, pf, spec)
    for name, a, b in zip(OUTS, got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{where} FULL {name}")
    got_c = emulate(state, vic, pf, spec, plain.PROLOGUE, lanes=lanes)
    carry = plain.preempt_eval(state, vic, pf, spec, plain.PROLOGUE)
    for name, a, b in zip(("mask", "rel", "cnt", "flags"), got_c, carry):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{where} PROLOGUE {name}")
    for label, c in (("prologue", carry), ("drawn", chip_smoke.eval_carry(rng, carry, v))):
        got_t = emulate(state, vic, pf, spec, plain.TAIL, c, lanes=lanes)
        want_t = plain.preempt_eval(state, vic, pf, spec, plain.TAIL, c)
        for name, a, b in zip(OUTS, got_t, want_t):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{where} TAIL ({label}) {name}")
    return want


def forced_lanes(v: int, i: int) -> int:
    """The i-th (cyclically) lane count other than eval_lanes(V) that takes
    V slots, or eval_lanes(V) when none does."""
    other = [x for x in LANES if x != eval_lanes(v) and v <= x * (2 if x == 32 else 1) and x >= min(v, 32)]
    return other[i % len(other)] if other else eval_lanes(v)


@pytest.mark.parametrize("ops", OPS)
@pytest.mark.parametrize("v", VS)
def test_emulation_matches_plain(v, ops):
    """At V slots and one op family: a drawn case and one of each kind
    (cycling over V, so each family meets every kind), at eval_lanes(V)
    and at a forced lane count; R = 1 or 4 and 0-3 PDBs by turns."""
    iv, iop = VS.index(v), OPS.index(ops)
    rng = np.random.default_rng(2000 + 10 * iv + iop)
    r, p = (1, 4)[(iv + iop) % 2], iv % 4
    n = 24 if v <= 16 else 12
    for kind, lanes in (("drawn", None), (KINDS[(iv + iop) % len(KINDS)], forced_lanes(v, iop))):
        state, vic, pf, spec = chip_smoke.eval_case(rng, n, v, r, p, ops, kind, "cpu")
        check(state, vic, pf, spec, rng, lanes, where=f"[V={v} L={lanes} {ops} {kind}]")


def test_every_lane_count_at_one_slot():
    """V = 1 at every L of 1, 2, 4, 8, 16, 32 (one slot, the other lanes
    idle), all ops."""
    rng = np.random.default_rng(2011)
    for lanes in LANES:
        state, vic, pf, spec = chip_smoke.eval_case(rng, 16, 1, 4, 1, "all", "drawn", "cpu")
        check(state, vic, pf, spec, rng, lanes, where=f"[V=1 L={lanes}]")


def test_cases_reach_every_rule():
    """The drawn cases reprieve, check wildcard port slots, release
    triples two victims share, cross a CSI volume and a claim two masked
    victims share (freed only together), cross a count-only claim slot and
    keep a phantom charge, find a representative late in its chunk, and
    leave nodes both possible and not."""
    rng = np.random.default_rng(2012)
    stats = _stats()
    possible = 0
    for ops in ("ports", "nvl", "dra", "all"):
        for v in (3, 8):
            state, vic, pf, spec = chip_smoke.eval_case(rng, 40, v, 4, 2, ops, "drawn", "cpu")
            want = check(state, vic, pf, spec, rng, stats=stats, where=f"[{ops} V={v}]")
            possible += int(want[0].sum())
    assert min(stats.values()) > 0, stats
    assert 0 < possible < 40 * 8
    _, _, pf, _ = chip_smoke.eval_case(rng, 4, 2, 1, 0, "fit", "late", "cpu")
    assert representative(pf) == (1000, True)
    _, _, pf, _ = chip_smoke.eval_case(rng, 4, 2, 1, 0, "fit", "none valid", "cpu")
    assert representative(pf) == (0, False)


def test_ties_at_the_top_priority_and_no_victim_below():
    """Every victim at one priority with every start infinite (the start
    key -2^61), equal finite starts, and a representative no victim is
    below (no node possible, every mask empty)."""
    rng = np.random.default_rng(2013)
    state, vic, pf, spec = chip_smoke.eval_case(rng, 24, 8, 4, 2, "all", "ties", "cpu")
    vic = vic._replace(prio=torch.where(vic.prio < I32_MAX, 3, vic.prio), start=torch.full_like(vic.start, np.inf))
    want = check(state, vic, pf, spec, rng, where="[ties, no start]")
    assert (want[1][4][want[3] > 0] == NO_START).all() and (want[3] > 0).any()
    vic = vic._replace(start=torch.where(vic.prio < I32_MAX, 2.5, np.inf).to(torch.float64))
    want = check(state, vic, pf, spec, rng, where="[ties, equal starts]")
    assert (want[1][4][want[3] > 0] == -2_500_000).all()
    state, vic, pf, spec = chip_smoke.eval_case(rng, 24, 8, 4, 2, "all", "none below", "cpu")
    want = check(state, vic, pf, spec, rng, where="[none below]")
    assert not want[0].any() and not want[2].any()


# ---- against the reference ---------------------------------------------------

def _jax_run(setup, case: str, seed: int, k: int, chunk: int, monkeypatch):
    """JAX build_preempt_pass and the port's plain pass with the emulation
    as its preempt_eval, from one cluster, batch and victim pack; returns
    (the JAX outputs, the port's, the emulation's calls)."""
    j, t, jpods, jb, tb, active = setup(case, seed, k)
    jpack = j.preemption.pack_victims(j.profile, active)
    tpack = t.preemption.pack_victims(t.profile, active)
    keys = ("d_prio", "d_vic_req", "d_vic_nonzero", "d_vic_start")
    sigs, _ = j.preemption._sig_ids(jpods, j.profile, k)
    valid = np.ones(k, np.bool_)
    valid[-1] = False
    jb["valid"], jb["sig"] = valid, sigs
    inv = j.builder.batch_invariants()
    fn = jpre.build_preempt_pass(j.profile, j.builder.schema, j.builder.res_col, active, jpack["n_pdbs"], chunk)
    jstate = j.builder.state()
    jout = fn(jstate, jb, inv, *(jpack[key] for key in keys), jpack["d_vfeat"], jpack["d_pdb"], jpack["d_allowed"])
    calls = []

    def emulated(*args, **kw):
        calls.append(args[4] if len(args) > 4 else kw.get("mode", plain.FULL))
        return emulate(*args, **kw)

    monkeypatch.setattr(tpre, "_PLAIN_FNS", (emulated,) + tpre._PLAIN_FNS[1:])
    tbatch = {key: torch.from_numpy(np.ascontiguousarray(v)) for key, v in tb.items()}
    tbatch["valid"], tbatch["sig"] = torch.from_numpy(valid), torch.from_numpy(sigs)
    state = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate.__dataclass_fields__}, "cpu")
    run = tpre.build_preempt_pass(t.profile, t.builder.schema, t.builder.res_col, active, chunk, _impl="plain")
    tout = run(state, tbatch, tpack["vic"], inv={key: np.asarray(v) for key, v in inv.items()})
    return jout, tout, calls


def _same(jout, tout) -> np.ndarray:
    (jstep, jfinal, jprio), (tstep, carry, tprio) = jout, tout
    np.testing.assert_array_equal(tstep.picks.numpy(), np.asarray(jstep.picks))
    np.testing.assert_array_equal(tstep.vic_mask.numpy(), np.asarray(jstep.vic_mask))
    np.testing.assert_array_equal(tstep.n_victims.numpy(), np.asarray(jstep.n_victims))
    for tv, f in zip(carry, ("req", "nonzero_req", "num_pods")):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(getattr(jfinal, f)), err_msg=f)
    np.testing.assert_array_equal(tprio.numpy(), np.asarray(jprio))
    return np.asarray(jstep.picks)


@pytest.mark.parametrize("case", ["ports", "devices", "csi", "all"])
def test_search_pass_anchored_to_jax(case, monkeypatch):
    """The search scenarios (host ports on the wildcard and a specific IP,
    read-write and read-only devices, CSI claims two victims of a node
    share, a ReadWriteOncePod-blocked preemptor; "all" with the domain ops:
    PROLOGUE and TAIL around the plain search steps) at chunk 1."""
    from tests.test_torch_preemption_search import setup

    jout, tout, calls = _jax_run(setup, case, 3, 16, 1, monkeypatch)
    picks = _same(jout, tout)
    assert (picks >= 0).any()
    want = {plain.PROLOGUE, plain.TAIL} if case == "all" else {plain.FULL}
    assert set(calls) == want


def test_dra_pass_anchored_to_jax(monkeypatch):
    """The DRA scenario (claims shared by two victims, the count-only slot
    of an externally allocated claim, whole-node, h100, missing and
    pinned claims) at chunk 1."""
    from tests.test_torch_dra_preemption import setup

    jout, tout, calls = _jax_run(setup, "dra", 5, 16, 1, monkeypatch)
    picks = _same(jout, tout)
    assert (picks >= 0).any() and set(calls) == {plain.FULL}
