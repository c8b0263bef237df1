"""String interning: the bridge from the reference's string-keyed world
(labels, taints, topology values, resource names) to dense integer ids that
vectorize on device.

The reference matches labels with string comparisons inside the per-node hot
loop (e.g. labels.Selector in every affinity plugin).  Arbitrary string ops do
not vectorize on a device, so every string the device needs is interned host-side
into a vocabulary; device tensors hold only ids.  Vocabularies only grow;
ids are stable for the life of the process, so device tensors never need
re-keying when new strings appear.

The port's own copy of ``kubernetes_tpu/intern.py``: the vocabularies, and
the selector indexes over pod groups and affinity terms (GroupIndex,
TermIndex) that inter-pod affinity featurizes with.
"""

from __future__ import annotations

from typing import Hashable, Iterable

import numpy as np

from .api import types as t


def term_key(category: int, weight: int, term, namespace: str) -> tuple:
    """Canonical hashable identity of a pod (anti-)affinity term.

    Namespaces default to the owning pod's namespace when the term names none
    and has no namespaceSelector (framework/types.go newAffinityTerm)."""
    ns = tuple(sorted(term.namespaces))
    if not ns and term.namespace_selector is None:
        ns = (namespace,)
    return (category, weight, term.topology_key, ns, term.namespace_selector, term.label_selector)


class Vocab:
    """A grow-only bijection value → dense id (0-based). Thread-hostile by
    design: interning happens only on the (single-threaded) snapshot path,
    matching the reference's single scheduling goroutine."""

    __slots__ = ("_to_id", "_to_val", "name")

    def __init__(self, name: str = ""):
        self.name = name
        self._to_id: dict[Hashable, int] = {}
        self._to_val: list[Hashable] = []

    def id(self, value: Hashable) -> int:
        """Intern value, returning its id (allocating if new)."""
        i = self._to_id.get(value)
        if i is None:
            i = len(self._to_val)
            self._to_id[value] = i
            self._to_val.append(value)
        return i

    def get(self, value: Hashable) -> int:
        """Return id or -1 without interning (for read-only lookups)."""
        return self._to_id.get(value, -1)

    def value(self, i: int) -> Hashable:
        return self._to_val[i]

    def ids(self, values: Iterable[Hashable]) -> list[int]:
        return [self.id(v) for v in values]

    def __len__(self) -> int:
        return len(self._to_val)

    def __contains__(self, value: Hashable) -> bool:
        return value in self._to_id


class InternTable:
    """All vocabularies the snapshot/feature builders share.

    - ``label_keys``:   label key → id (for Exists/DoesNotExist ops)
    - ``label_pairs``:  (key, value) → id (for In/NotIn/equality ops)
    - ``taints``:       (key, value, effect) → id
    - ``topo_keys``:    topology key → per-key slot index (bounded by schema.TK)
    - ``topo_vals[k]``: per-topology-key value vocab (node's zone id, etc.)
    - ``namespaces``:   namespace → id
    - ``groups``:       (namespace_id, frozenset(labels.items())) → pod group id
    - ``ports``:        (protocol, hostIP, port) → id
    - ``images``:       image name → id
    - ``node_names``:   node name → id (== snapshot row index is NOT guaranteed;
                        row index mapping lives in the cache)
    """

    def __init__(self) -> None:
        self.label_keys = Vocab("label_keys")
        self.label_pairs = Vocab("label_pairs")
        self.taints = Vocab("taints")
        self.topo_keys = Vocab("topo_keys")
        self.topo_vals: list[Vocab] = []
        self.namespaces = Vocab("namespaces")
        self.groups = Vocab("groups")
        self.terms = Vocab("terms")  # existing-pod (anti-)affinity terms
        self.devices = Vocab("devices")  # in-tree device-volume ids
        self.drivers = Vocab("drivers")  # CSI driver names
        # CSI volume unique names (nodevolumelimits/csi.go volumeUniqueName:
        # bound → driver/volumeHandle; unbound → driver/claim-uid), so a
        # volume shared by several pods on a node attaches — and counts —
        # once.
        self.csivols = Vocab("csivols")
        self.device_classes = Vocab("device_classes")  # DRA device classes
        self.dra_claims = Vocab("dra_claims")  # DRA claim uids
        self.ports = Vocab("ports")
        self.images = Vocab("images")
        self.node_names = Vocab("node_names")

    def topo_key_slot(self, key: str) -> int:
        slot = self.topo_keys.id(key)
        while len(self.topo_vals) <= slot:
            self.topo_vals.append(Vocab(f"topo_vals[{len(self.topo_vals)}]"))
        return slot

    def topo_value_id(self, key: str, value: str) -> int:
        return self.topo_vals[self.topo_key_slot(key)].id(value)

    HOSTNAME_KEY = "kubernetes.io/hostname"

    def max_topo_vocab(self) -> int:
        """Largest per-key domain vocabulary EXCLUDING the hostname key
        (drives Schema.DV).  Hostname domains are one-node domains and every
        device op takes a per-node fast path for them, so their huge
        vocabulary must not inflate the segment tables."""
        host_slot = self.topo_keys.get(self.HOSTNAME_KEY)
        return max(
            (len(v) for i, v in enumerate(self.topo_vals) if i != host_slot),
            default=0,
        )

    def term_id(self, category: int, weight: int, term, namespace: str) -> int:
        """Intern a pod (anti-)affinity term of an existing pod.

        ``category``: 0 required-affinity, 1 required-anti-affinity,
        2 preferred-affinity, 3 preferred-anti-affinity."""
        return self.terms.id(term_key(category, weight, term, namespace))

    def group_id(self, namespace: str, labels: dict[str, str]) -> int:
        """Pod label-group id: pods with identical (namespace, labels) share a
        group.  Affinity/spread counting then becomes per-group arithmetic —
        the device never sees individual pod labels."""
        key = (self.namespaces.id(namespace), frozenset(labels.items()))
        return self.groups.id(key)

    def group_labels(self, gid: int) -> tuple[str, dict[str, str]]:
        ns_id, fs = self.groups.value(gid)  # type: ignore[misc]
        return str(self.namespaces.value(ns_id)), dict(fs)


class GroupIndex:
    """Vectorized label-selector evaluation over pod label-GROUPS.

    The reference matches selectors against individual pods in the hot loop
    (labels.Selector.Matches per pod); here pods collapse into (namespace,
    labels) groups, and selector evaluation becomes boolean column algebra
    over two incrementally-maintained membership matrices —

      ``gp`` (G, LP): group g carries label pair p
      ``gk`` (G, LK): group g carries label key k

    — so matching one selector against EVERY group is a handful of numpy
    column reductions instead of an O(G) Python loop (the featurization
    hot-path cost VERDICT r2 measured on the affinity-heavy configs)."""

    def __init__(self, interns: InternTable) -> None:
        self.it = interns
        self._np = np
        self._n_groups = 0
        self.group_ns = np.zeros(0, np.int32)
        self.gp = np.zeros((0, 0), np.bool_)
        self.gk = np.zeros((0, 0), np.bool_)

    @staticmethod
    def _grow(np, arr, rows: int, cols: int):
        r = max(rows, arr.shape[0])
        c = max(cols, arr.shape[1])
        if (r, c) == arr.shape:
            return arr
        out = np.zeros((_cap(r), _cap(c)), np.bool_)
        out[: arr.shape[0], : arr.shape[1]] = arr
        return out

    def sync(self) -> None:
        """Absorb newly-interned groups (grow-only; ids are stable)."""
        it, np = self.it, self._np
        n = len(it.groups)
        if n == self._n_groups:
            return
        # Intern the new groups' pairs/keys first so column capacity is known.
        new = range(self._n_groups, n)
        pairs: list[tuple[int, int]] = []
        keys: list[tuple[int, int]] = []
        ns_ids = []
        for gid in new:
            ns_id, fs = it.groups.value(gid)  # type: ignore[misc]
            ns_ids.append(ns_id)
            for k, v in fs:
                pairs.append((gid, it.label_pairs.id((k, v))))
                keys.append((gid, it.label_keys.id(k)))
        self.gp = self._grow(np, self.gp, n, len(it.label_pairs))
        self.gk = self._grow(np, self.gk, n, len(it.label_keys))
        if self.group_ns.shape[0] < n:
            g2 = np.zeros(_cap(n), np.int32)
            g2[: self._n_groups] = self.group_ns[: self._n_groups]
            self.group_ns = g2
        self.group_ns[self._n_groups : n] = ns_ids
        for gid, pid in pairs:
            self.gp[gid, pid] = True
        for gid, kid in keys:
            self.gk[gid, kid] = True
        self._n_groups = n

    def match_selector(self, sel, ns_ids=None):
        """(G,) bool — label_selector_matches(sel, group labels) for every
        group, optionally restricted to a namespace-id set.  None selects
        nothing, empty selects everything (metav1 semantics)."""
        self.sync()
        it, np = self.it, self._np
        n = self._n_groups
        if sel is None:
            return np.zeros(n, np.bool_)
        ok = np.ones(n, np.bool_)
        gp, gk = self.gp, self.gk
        # Ids at or past the matrix width were interned AFTER the last group
        # sync (by term encoding, node rows, …): no group carries them.
        for k, v in sel.match_labels:
            pid = it.label_pairs.get((k, v))
            if pid < 0 or pid >= gp.shape[1]:
                return np.zeros(n, np.bool_)
            ok &= gp[:n, pid]
        for req in sel.match_expressions:
            kid = it.label_keys.get(req.key)
            has = (
                gk[:n, kid]
                if 0 <= kid < gk.shape[1]
                else np.zeros(n, np.bool_)
            )
            pids = [
                p
                for p in (it.label_pairs.get((req.key, v)) for v in req.values)
                if 0 <= p < gp.shape[1]
            ]
            anyp = (
                gp[:n, pids].any(axis=1) if pids else np.zeros(n, np.bool_)
            )
            op = req.operator
            if op == "In":
                ok &= anyp
            elif op == "NotIn":
                ok &= ~anyp  # key-missing groups pass (anyp implies has)
            elif op == "Exists":
                ok &= has
            elif op == "DoesNotExist":
                ok &= ~has
            else:
                raise ValueError(f"bad label selector operator {op}")
        if ns_ids is not None:
            ok = ok & np.isin(self.group_ns[:n], list(ns_ids))
        return ok


def _cap(n: int) -> int:
    c = 64
    while c < n:
        c *= 2
    return c


class TermIndex:
    """Incremental (ET, G) matrix: does interned existing-pod term t match
    pod group g (namespace AND label selector)?

    Featurization reads one COLUMN per pod (its group) — replacing the
    O(ET) per-pod Python loop that dominated the affinity-heavy configs.
    Growth is amortized on both axes:

      * new term → one row, vectorized over all groups (GroupIndex);
      * new group → one column, vectorized over all terms via a
        simple-selector encoding (match_labels conjunction + at most one
        In-disjunction covers the overwhelming share of real selectors);
        terms outside that shape fall back to per-term evaluation.

    Namespace matching rides a small (T, NS) matrix (namespace counts are
    tiny); namespaceSelector terms re-evaluate when namespace labels change
    (``ns_epoch``)."""

    def __init__(self, interns: InternTable, group_index: GroupIndex, namespace_labels: dict) -> None:
        self._np = np
        self._t = t
        self.it = interns
        self.gi = group_index
        self.namespace_labels = namespace_labels  # live reference
        self.mat = np.zeros((0, 0), np.bool_)  # (T, G)
        self.cats = np.zeros(0, np.int8)
        self.weights = np.zeros(0, np.int64)
        self.ml_pairs = np.zeros((0, 0), np.bool_)  # (T, LP) AND-pairs
        self.in_pairs = np.zeros((0, 0), np.bool_)  # (T, LP) OR-pairs
        self.has_in = np.zeros(0, np.bool_)
        self.complex_sel = np.zeros(0, np.bool_)
        self.term_ns = np.zeros((0, 0), np.bool_)  # (T, NS)
        self._nt = 0
        self._ng = 0
        self._nns = 0
        self._ns_epoch = -1

    def _grow2(self, arr, rows: int, cols: int):
        np = self._np
        if arr.shape[0] >= rows and arr.shape[1] >= cols:
            return arr
        out = np.zeros((_cap(max(rows, arr.shape[0])), _cap(max(cols, arr.shape[1]))), np.bool_)
        out[: arr.shape[0], : arr.shape[1]] = arr
        return out

    def _grow1(self, arr, n: int, dtype=None):
        np = self._np
        if arr.shape[0] >= n:
            return arr
        out = np.zeros(_cap(n), dtype or arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def _ns_sel_of(self, tid: int):
        return self.it.terms.value(tid)[4]

    def _ns_match(self, tid: int, ns_id: int) -> bool:
        t = self._t
        _cat, _w, _topo, ns_tuple, ns_sel, _sel = self.it.terms.value(tid)
        name = self.it.namespaces.value(ns_id)
        if name in ns_tuple:
            return True
        return ns_sel is not None and t.label_selector_matches(
            ns_sel, self.namespace_labels.get(name, {})
        )

    def _encode_term(self, tid: int) -> None:
        """Simple-selector encoding for vectorized column fills."""
        it, np = self.it, self._np
        _cat, _w, _topo, _ns, _ns_sel, sel = it.terms.value(tid)
        if sel is None:
            self.complex_sel[tid] = True  # matches nothing; handled per group
            return
        in_reqs = [r for r in sel.match_expressions if r.operator == "In"]
        other = [r for r in sel.match_expressions if r.operator != "In"]
        if other or len(in_reqs) > 1:
            self.complex_sel[tid] = True
            return
        if in_reqs and not in_reqs[0].values:
            # In with an empty value set matches nothing; has_in must still
            # be True so the column path rejects every group (the scalar
            # reference does).
            self.has_in[tid] = True
            return
        pair_ids = [it.label_pairs.id((k, v)) for k, v in sel.match_labels]
        in_ids = [
            it.label_pairs.id((in_reqs[0].key, v)) for v in in_reqs[0].values
        ] if in_reqs else []
        self.ml_pairs = self._grow2(self.ml_pairs, self._cap_t(), len(it.label_pairs))
        self.in_pairs = self._grow2(self.in_pairs, self._cap_t(), len(it.label_pairs))
        for p in pair_ids:
            self.ml_pairs[tid, p] = True
        for p in in_ids:
            self.in_pairs[tid, p] = True
        self.has_in[tid] = bool(in_ids)

    def _cap_t(self) -> int:
        return max(self._nt, len(self.it.terms))

    def sync(self, ns_epoch: int = 0) -> None:
        """Absorb new terms / groups / namespaces; cheap when nothing grew."""
        it, np, t = self.it, self._np, self._t
        nt, ng, nns = len(it.terms), len(it.groups), len(it.namespaces)
        if (nt, ng, nns, ns_epoch) == (self._nt, self._ng, self._nns, self._ns_epoch):
            return
        self.gi.sync()
        if ns_epoch != self._ns_epoch and self._nt:
            # Namespace labels changed: re-evaluate namespaceSelector terms'
            # ns matrix (and rows below via the recompute flag).
            for tid in range(self._nt):
                if self._ns_sel_of(tid) is not None:
                    for nid in range(self._nns):
                        self.term_ns[tid, nid] = self._ns_match(tid, nid)
                    row = self.gi.match_selector(self.it.terms.value(tid)[5])
                    ns_ok = self.term_ns[tid, self.gi.group_ns[: self._ng]]
                    self.mat[tid, : self._ng] = row[: self._ng] & ns_ok
        # -- grow storage --
        self.mat = self._grow2(self.mat, nt, ng)
        self.cats = self._grow1(self.cats, nt)
        self.weights = self._grow1(self.weights, nt)
        self.has_in = self._grow1(self.has_in, nt)
        self.complex_sel = self._grow1(self.complex_sel, nt)
        self.term_ns = self._grow2(self.term_ns, nt, nns)
        self.ml_pairs = self._grow2(self.ml_pairs, nt, len(it.label_pairs))
        self.in_pairs = self._grow2(self.in_pairs, nt, len(it.label_pairs))
        # -- new namespaces: one column in term_ns per namespace --
        for nid in range(self._nns, nns):
            for tid in range(self._nt):
                self.term_ns[tid, nid] = self._ns_match(tid, nid)
        self._nns = nns
        # -- new groups: one matrix column each, vectorized over terms --
        old_nt = self._nt
        for gid in range(self._ng, ng):
            ns_id, _fs = it.groups.value(gid)
            gvec = self.gi.gp[gid]  # (LP_cap,)
            lp = gvec.shape[0]
            T = old_nt
            if T:
                ml = self.ml_pairs[:T, :lp]
                ok = ~((ml & ~gvec[None, :lp]).any(axis=1))
                # Required pairs beyond the group matrix width are pairs no
                # group carries yet — the conjunction fails for them.
                if self.ml_pairs.shape[1] > lp:
                    ok &= ~self.ml_pairs[:T, lp:].any(axis=1)
                inp = self.in_pairs[:T, :lp]
                ok &= ~self.has_in[:T] | (inp & gvec[None, :lp]).any(axis=1)
                complex_ids = np.nonzero(self.complex_sel[:T])[0]
                if complex_ids.size:
                    _ns_name, labels = it.group_labels(gid)
                    for tid in complex_ids:
                        sel = it.terms.value(int(tid))[5]
                        ok[tid] = t.label_selector_matches(sel, labels)
                ok &= self.term_ns[:T, ns_id]
                self.mat[:T, gid] = ok
        self._ng = ng
        # -- new terms: one row each, vectorized over groups --
        for tid in range(old_nt, nt):
            cat, w, _topo, ns_tuple, ns_sel, sel = it.terms.value(tid)
            self.cats[tid] = cat
            self.weights[tid] = w
            for nid in range(nns):
                self.term_ns[tid, nid] = self._ns_match(tid, nid)
            self._encode_term(tid)
            row = self.gi.match_selector(sel)
            ns_ok = self.term_ns[tid, self.gi.group_ns[:ng]]
            self.mat[tid, :ng] = row[:ng] & ns_ok
        self._nt = nt
        self._ns_epoch = ns_epoch

    def column(self, gid: int) -> "tuple":
        """(match (T,), cats (T,), weights (T,)) for one pod group."""
        nt = self._nt
        return self.mat[:nt, gid], self.cats[:nt], self.weights[:nt]
