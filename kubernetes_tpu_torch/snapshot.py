"""Device tensor schema and the host→device snapshot engine, on torch.

The counterpart of ``kubernetes_tpu/snapshot.py``: the cluster is a
struct-of-arrays (one row per node, padded to a bucketed capacity) mirrored
between host numpy staging arrays and device tensors.

  * Host-driven changes (node add/update/remove, informer pod adds and
    removals) dirty individual rows; ``state()`` ships only the dirty rows
    and writes them with the ``scatter_rows`` kernel — the analog of the
    generation-diff copy in the reference's UpdateSnapshot (cache.go:186).
  * Device-driven changes (the batch pass commits pods on the card) already
    live on the device; the host applies the same deltas to its staging
    arrays after each batch so the mirrors stay equal without re-upload.

Unlike the JAX package, the device state is updated IN PLACE by the batch
pass (torch tensors are mutable): ``absorb_device_state`` adopts the
returned object, which is the same tensors.  ``state_from_numpy`` /
``state_to_numpy`` carry a ClusterState across from (and back to) the JAX
builder's arrays field by field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .api import types as t
from .intern import GroupIndex, InternTable, TermIndex
from .volumes import VolumeCatalog

# Sentinel for "label value is not an integer" (Gt/Lt operators).
INT_SENTINEL = np.int64(-(2**62))

# Host-port slots per pod (the JAX package's static device shape; kept so
# the port rejects the same pods at delta time).
POD_PORT_SLOTS = 8

# Fixed resource columns; scalar/extended resources are interned after these.
FIXED_RESOURCES = (t.CPU, t.MEMORY, t.EPHEMERAL_STORAGE)


def _bucket(n: int, floor: int = 8) -> int:
    """Smallest power-of-two capacity ≥ n (min floor)."""
    c = floor
    while c < n:
        c *= 2
    return c


@dataclass(frozen=True)
class Schema:
    """Static capacities of the device tensors."""

    N: int = 64  # node rows
    R: int = 4  # resource columns (fixed 3 + scalars)
    LS: int = 16  # label slots per node
    TS: int = 8  # taint slots per node
    TV: int = 8  # taint vocabulary size (pod intolerable-taint bitmasks)
    TK: int = 4  # topology-key slots
    DV: int = 8  # max domain (topology-value) vocabulary across topo keys
    G: int = 8  # pod label-group rows
    ET: int = 8  # existing-pod (anti-)affinity term rows
    VD: int = 8  # in-tree device-volume vocabulary rows
    DR: int = 8  # CSI driver vocabulary rows
    CV: int = 8  # CSI volume unique-name vocabulary rows
    DC: int = 4  # DRA device-class vocabulary rows
    CLM: int = 8  # DRA claim vocabulary rows
    P: int = 8  # host-port (proto,ip,port) triple rows
    PK: int = 8  # host-port (proto,port) key rows
    IM: int = 8  # image slots per node

    def grown(self, **mins: int) -> "Schema":
        """Return a schema with each named capacity grown to cover its min."""
        changes = {}
        for name, need in mins.items():
            cur = getattr(self, name)
            if need > cur:
                changes[name] = _bucket(need, cur)
        return dataclasses.replace(self, **changes) if changes else self


@dataclass
class ClusterState:
    """The device-resident cluster: one row per node (axis sized Schema.N).
    Same 27 fields, dtypes and node axes as the JAX package's ClusterState
    (kubernetes_tpu/snapshot.py:88-140)."""

    valid: torch.Tensor  # (N,) bool — row holds a live node
    name_id: torch.Tensor  # (N,) i32 — interned node name
    unschedulable: torch.Tensor  # (N,) bool — node.Spec.Unschedulable
    num_pods: torch.Tensor  # (N,) i32 — len(NodeInfo.Pods)
    allowed_pods: torch.Tensor  # (N,) i32 — Allocatable.AllowedPodNumber
    alloc: torch.Tensor  # (N, R) i64 — NodeInfo.Allocatable
    req: torch.Tensor  # (N, R) i64 — NodeInfo.Requested
    nonzero_req: torch.Tensor  # (N, 2) i64 — NonZeroRequested (cpu, mem)
    label_key_ids: torch.Tensor  # (N, LS) i32, -1 pad
    label_pair_ids: torch.Tensor  # (N, LS) i32, -1 pad
    label_int_vals: torch.Tensor  # (N, LS) i64, INT_SENTINEL if not integral
    topo_vals: torch.Tensor  # (N, TK) i32 — per topo-key-slot value id
    taint_ids: torch.Tensor  # (N, TS) i32, -1 pad
    port_counts: torch.Tensor  # (P, N) i32
    portkey_counts: torch.Tensor  # (PK, N) i32
    group_counts: torch.Tensor  # (G, N) i32 — pods of label-group g on node n
    et_counts: torch.Tensor  # (ET, N) i32 — pods carrying interned term e
    dev_counts: torch.Tensor  # (VD, N) i32
    dev_rw_counts: torch.Tensor  # (VD, N) i32
    csi_used: torch.Tensor  # (DR, N) i32
    csi_limit: torch.Tensor  # (DR, N) i32
    csivol_counts: torch.Tensor  # (CV, N) i32
    dra_cap: torch.Tensor  # (DC, N) i32
    dra_alloc: torch.Tensor  # (DC, N) i32
    dra_claim_counts: torch.Tensor  # (CLM, N) i32
    image_ids: torch.Tensor  # (N, IM) i32, -1 pad
    image_sizes: torch.Tensor  # (N, IM) i64

    def clone(self) -> "ClusterState":
        """A deep copy (the pass commits in place)."""
        return ClusterState(
            **{f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)}
        )


# Field → which axis indexes nodes (0 = leading, 1 = trailing).
_NODE_AXIS: dict[str, int] = {
    "valid": 0,
    "name_id": 0,
    "unschedulable": 0,
    "num_pods": 0,
    "allowed_pods": 0,
    "alloc": 0,
    "req": 0,
    "nonzero_req": 0,
    "label_key_ids": 0,
    "label_pair_ids": 0,
    "label_int_vals": 0,
    "topo_vals": 0,
    "taint_ids": 0,
    "port_counts": 1,
    "portkey_counts": 1,
    "group_counts": 1,
    "et_counts": 1,
    "dev_counts": 1,
    "dev_rw_counts": 1,
    "csi_used": 1,
    "csi_limit": 1,
    "csivol_counts": 1,
    "dra_cap": 1,
    "dra_alloc": 1,
    "dra_claim_counts": 1,
    "image_ids": 0,
    "image_sizes": 0,
}


def _host_arrays(s: Schema) -> dict[str, np.ndarray]:
    return {
        "valid": np.zeros(s.N, np.bool_),
        "name_id": np.full(s.N, -1, np.int32),
        "unschedulable": np.zeros(s.N, np.bool_),
        "num_pods": np.zeros(s.N, np.int32),
        "allowed_pods": np.zeros(s.N, np.int32),
        "alloc": np.zeros((s.N, s.R), np.int64),
        "req": np.zeros((s.N, s.R), np.int64),
        "nonzero_req": np.zeros((s.N, 2), np.int64),
        "label_key_ids": np.full((s.N, s.LS), -1, np.int32),
        "label_pair_ids": np.full((s.N, s.LS), -1, np.int32),
        "label_int_vals": np.full((s.N, s.LS), INT_SENTINEL, np.int64),
        "topo_vals": np.full((s.N, s.TK), -1, np.int32),
        "taint_ids": np.full((s.N, s.TS), -1, np.int32),
        "port_counts": np.zeros((s.P, s.N), np.int32),
        "portkey_counts": np.zeros((s.PK, s.N), np.int32),
        "group_counts": np.zeros((s.G, s.N), np.int32),
        "et_counts": np.zeros((s.ET, s.N), np.int32),
        "dev_counts": np.zeros((s.VD, s.N), np.int32),
        "dev_rw_counts": np.zeros((s.VD, s.N), np.int32),
        "csi_used": np.zeros((s.DR, s.N), np.int32),
        "csi_limit": np.full((s.DR, s.N), 2**31 - 1, np.int32),
        "csivol_counts": np.zeros((s.CV, s.N), np.int32),
        "dra_cap": np.zeros((s.DC, s.N), np.int32),
        "dra_alloc": np.zeros((s.DC, s.N), np.int32),
        "dra_claim_counts": np.zeros((s.CLM, s.N), np.int32),
        "image_ids": np.full((s.N, s.IM), -1, np.int32),
        "image_sizes": np.zeros((s.N, s.IM), np.int64),
    }


_FIELD_DTYPES: dict[str, np.dtype] = {
    k: v.dtype for k, v in _host_arrays(Schema(N=1)).items()
}


def state_from_numpy(fields: dict[str, np.ndarray], device) -> ClusterState:
    """A ClusterState on ``device`` from per-field numpy arrays — e.g. the
    JAX builder's state, ``{f: np.asarray(getattr(state, f))}``.  Every
    field must be present with the reference dtype; arrays are copied, so
    the result shares no memory with ``fields``."""
    missing = set(_NODE_AXIS) - set(fields)
    extra = set(fields) - set(_NODE_AXIS)
    if missing or extra:
        raise ValueError(f"ClusterState fields: missing {sorted(missing)}, extra {sorted(extra)}")
    out = {}
    for k, want in _FIELD_DTYPES.items():
        a = np.asarray(fields[k])
        if a.dtype != want:
            raise TypeError(f"ClusterState.{k}: dtype {a.dtype}, want {want}")
        out[k] = torch.tensor(a, device=device)
    return ClusterState(**out)


def state_to_numpy(state: ClusterState) -> dict[str, np.ndarray]:
    """The inverse of state_from_numpy: every field copied to a host numpy array."""
    return {
        f.name: getattr(state, f.name).to("cpu", copy=True).numpy()
        for f in dataclasses.fields(state)
    }


def parse_label_int(v: str) -> int:
    """Value of a label as int for Gt/Lt, or INT_SENTINEL."""
    try:
        return int(v)
    except ValueError:
        return int(INT_SENTINEL)


class _DirtyRows(set):
    """Dirty-row set that bumps the builder's mutation epoch on add — the
    one funnel every host-side row mutation goes through."""

    def __init__(self, builder: "SnapshotBuilder"):
        super().__init__()
        self._builder = builder

    def add(self, row: int) -> None:
        self._builder.mutation_epoch += 1
        super().add(row)


class SnapshotBuilder:
    """Owns the host staging arrays, the intern table, and the device mirror.

    The cache calls ``set_node_row`` / ``clear_node_row`` /
    ``apply_pod_delta`` as cluster events arrive; the engine calls
    ``state()`` before each pass to get an up-to-date ClusterState (flushing
    dirty rows), and ``absorb_device_state`` after the pass."""

    def __init__(
        self,
        interns: InternTable | None = None,
        schema: Schema | None = None,
        device: torch.device | str = "cpu",
    ):
        self.interns = interns or InternTable()
        self.schema = schema or Schema()
        self.device = torch.device(device)
        # Vectorized selector↔group matching and the incremental (ET, G)
        # term↔group match matrix of inter-pod affinity's featurization.
        self.group_index = GroupIndex(self.interns)
        # Namespace → labels, for namespaceSelector matching in affinity
        # terms (interpodaffinity/plugin.go GetNamespaceLabelsSnapshot).
        # Update via set_namespace_labels, which bumps ns_epoch for the
        # featurization cache.
        self.namespace_labels: dict[str, dict[str, str]] = {}
        self.ns_epoch = 0
        self.term_index = TermIndex(self.interns, self.group_index, self.namespace_labels)
        # PV/PVC/StorageClass/CSINode catalog (the volume plugins' host half).
        self.volumes = VolumeCatalog()
        self.host = _host_arrays(self.schema)
        self._device: ClusterState | None = None
        # Monotonic host-mutation counter: the validity token of derived
        # device-side caches (the scheduler's carried domain tables).
        self.mutation_epoch = 0
        self._dirty_rows: _DirtyRows = _DirtyRows(self)
        self._dirty_all = True  # device needs a full (re)build
        self.res_col: dict[str, int] = {r: i for i, r in enumerate(FIXED_RESOURCES)}
        # Featurization cache (engine/features.py): version token → entries.
        self.feat_cache: tuple[tuple, dict] | None = None
        # Feature gates the featurizers read (framework/features.py); None
        # means the defaults.
        self.feature_gates = None
        # "plain" flushes dirty rows with the plain version of scatter_rows
        # (set by a scheduler built with _impl="plain", for comparisons).
        self._impl = "kernel"
        # Whole-state uploads state() made (schema growth, invalidation):
        # each copies every field, csivol_counts (CV x N) included.
        self.full_uploads = 0

    @property
    def _dirty_all(self) -> bool:
        return self._dirty_all_flag

    @_dirty_all.setter
    def _dirty_all(self, value: bool) -> None:
        # Setting (not clearing) the full-rebuild flag is a host mutation.
        if value:
            self.mutation_epoch += 1
        self._dirty_all_flag = value

    # -- capacity management -------------------------------------------------

    def _ensure(self, **mins: int) -> None:
        grown = self.schema.grown(**mins)
        if grown is self.schema:
            return
        old = self.host
        self.schema = grown
        self.host = _host_arrays(grown)
        for k, a in old.items():
            sl = tuple(slice(0, d) for d in a.shape)
            self.host[k][sl] = a
        self._dirty_all = True

    def resource_column(self, name: str) -> int:
        col = self.res_col.get(name)
        if col is None:
            col = len(self.res_col)
            self._ensure(R=col + 1)
            self.res_col[name] = col
        return col

    # -- node rows -------------------------------------------------------------

    def set_node_row(self, row: int, node: t.Node) -> None:
        """(Re)write a node's static attributes into its row. Pod-derived
        state (req, counts) is managed separately via apply_pod_delta."""
        it = self.interns
        labels = node.metadata.labels
        self._ensure(
            N=row + 1,
            LS=len(labels),
            TS=len(node.spec.taints),
            IM=sum(len(img.names) for img in node.status.images),
        )
        for rname in node.status.allocatable:
            if rname != t.PODS:
                self.resource_column(rname)
        h = self.host
        h["valid"][row] = True
        h["name_id"][row] = it.node_names.id(node.name)
        h["unschedulable"][row] = node.spec.unschedulable
        h["allowed_pods"][row] = node.status.allocatable.get(t.PODS, 110)
        h["alloc"][row] = 0
        for rname, v in node.status.allocatable.items():
            if rname == t.PODS:
                continue
            h["alloc"][row, self.resource_column(rname)] = v
        h["label_key_ids"][row] = -1
        h["label_pair_ids"][row] = -1
        h["label_int_vals"][row] = INT_SENTINEL
        for i, (k, v) in enumerate(labels.items()):
            h["label_key_ids"][row, i] = it.label_keys.id(k)
            h["label_pair_ids"][row, i] = it.label_pairs.id((k, v))
            h["label_int_vals"][row, i] = parse_label_int(v)
        h["topo_vals"][row] = -1
        for k, v in labels.items():
            if k in it.topo_keys:
                slot = it.topo_key_slot(k)
                if slot < self.schema.TK:
                    h["topo_vals"][row, slot] = it.topo_value_id(k, v)
        h["taint_ids"][row] = -1
        for i, taint in enumerate(node.spec.taints):
            h["taint_ids"][row, i] = it.taints.id((taint.key, taint.value, taint.effect))
        h["image_ids"][row] = -1
        h["image_sizes"][row] = 0
        slot = 0
        for img in node.status.images:
            for alias in img.names:
                h["image_ids"][row, slot] = it.images.id(alias)
                h["image_sizes"][row, slot] = img.size_bytes
                slot += 1
        # Last: growth swaps self.host for fresh copies, so every write via
        # the local alias above must land before it.
        self._ensure(DV=it.max_topo_vocab())
        self._dirty_rows.add(row)

    def ensure_topo_key(self, key: str) -> int:
        """Intern a topology key and backfill topo_vals for existing nodes.
        Returns the key's slot."""
        known = key in self.interns.topo_keys
        slot = self.interns.topo_key_slot(key)
        self._ensure(TK=slot + 1)
        if not known:
            pair_col = self.host["label_key_ids"]
            key_id = self.interns.label_keys.get(key)
            if key_id >= 0:
                rows = np.nonzero((pair_col == key_id).any(axis=1))[0]
                for row in rows:
                    s = int(np.nonzero(pair_col[row] == key_id)[0][0])
                    pair = self.interns.label_pairs.value(int(self.host["label_pair_ids"][row, s]))
                    self.host["topo_vals"][row, slot] = self.interns.topo_value_id(key, pair[1])
                    self._dirty_rows.add(row)
            self._ensure(DV=self.interns.max_topo_vocab())
        return slot

    def batch_invariants(self) -> dict[str, np.ndarray]:
        """Batch-invariant inputs of the domain tables: every interned
        (anti-)affinity term's topology slot and hostname flag."""
        it = self.interns
        self._ensure(ET=max(len(it.terms), 1))
        for tid in range(len(it.terms)):
            self.ensure_topo_key(it.terms.value(tid)[2])
        et_slot = np.zeros(self.schema.ET, np.int32)
        et_host = np.zeros(self.schema.ET, np.bool_)
        for tid in range(len(it.terms)):
            topo_key = it.terms.value(tid)[2]
            et_slot[tid] = it.topo_keys.get(topo_key)
            et_host[tid] = topo_key == it.HOSTNAME_KEY
        return {"et_slot": et_slot, "et_host": et_host}

    def set_namespace_labels(self, namespace: str, labels: dict[str, str]) -> None:
        """Namespace label updates (the namespace informer feeding
        namespaceSelector matching).  Mutate ONLY through this method: the
        featurization cache keys on ns_epoch."""
        self.namespace_labels[namespace] = dict(labels)
        self.ns_epoch += 1

    def set_csinode_limits(self, row: int, csinode) -> None:
        """Apply CSINode.spec.drivers allocatable counts to a node row
        (nodevolumelimits/csi.go reads CSINode for the attach limit)."""
        for driver, limit in csinode.driver_limits.items():
            did = self.interns.drivers.id(driver)
            self._ensure(DR=did + 1)
            self.host["csi_limit"][did, row] = limit
        self._dirty_rows.add(row)

    def feature_version(self) -> tuple:
        """Token identifying everything pod featurization can read besides
        the pod itself (the JAX builder's, snapshot.py:520-535, minus the
        DRA catalog's): a catalog mutation (a PV added or provisioned, a
        claim's user count moved) bumps ``volumes.epoch``."""
        it = self.interns
        return (
            self.schema,
            len(it.terms),
            len(it.groups),
            len(it.namespaces),
            len(it.taints),
            len(it.devices),
            len(it.drivers),
            self.volumes.epoch,
            self.ns_epoch,
        )

    def clear_node_row(self, row: int) -> None:
        h = self.host
        for k, a in _host_arrays(dataclasses.replace(self.schema, N=1)).items():
            if _NODE_AXIS[k] == 0:
                h[k][row] = a[0]
            else:
                h[k][:, row] = a[:, 0]
        self._dirty_rows.add(row)

    # -- pod deltas ------------------------------------------------------------

    def pod_delta_vectors(self, pod: t.Pod) -> dict:
        """Precompute the row-delta a pod applies when (un)assigned to a node.
        Mirrors NodeInfo.AddPodInfo / RemovePod (types.go:990,1022).

        Resource claims belong to a later slice: a pod that carries one
        raises rather than being accounted without it."""
        if pod.spec.resource_claims:
            raise NotImplementedError("DynamicResources claims are not yet ported")
        request = pod.resource_request()
        cols = {r: self.resource_column(r) for r in request if r != t.PODS}
        req_vec = np.zeros(self.schema.R, np.int64)
        for rname, col in cols.items():
            req_vec[col] = request[rname]
        cpu, mem = pod.non_zero_request()
        gid = self.interns.group_id(pod.namespace, pod.metadata.labels)
        self._ensure(G=gid + 1)
        # The pod's own (anti-)affinity terms: assigning it bumps et_counts.
        own_terms: list[int] = []
        aff = pod.spec.affinity
        if aff is not None:
            pa, paa = aff.pod_affinity, aff.pod_anti_affinity
            for cat, terms in ((0, pa.required if pa else ()), (1, paa.required if paa else ())):
                for term in terms:
                    own_terms.append(self.interns.term_id(cat, 0, term, pod.namespace))
            for cat, wterms in ((2, pa.preferred if pa else ()), (3, paa.preferred if paa else ())):
                for wt in wterms:
                    own_terms.append(self.interns.term_id(cat, wt.weight, wt.term, pod.namespace))
        self._ensure(ET=len(self.interns.terms))
        # Volumes (snapshot.py:576-625): in-tree device uses, CSI volume
        # attachments, PVC refs.  CSI attachments are keyed by claim and
        # deduped within the pod (nodevolumelimits/csi.go:219 — a claim
        # referenced twice, or shared with pods already on the node,
        # attaches once; the presence check against csivol_counts happens
        # at filter and commit time).
        devices: list[tuple[int, bool]] = []
        pvc_uids: list[str] = []
        csivols: dict[int, int] = {}  # volume id → driver id
        # Any claim whose driver has a finite attach limit somewhere: such
        # pods defer behind same-node chunk-mates (shared per-driver budget).
        vol_csi_lim = False
        # Any claim bound at PreBind over a finite static-PV pool: only
        # those race against other pods' PreBinds (engine _conflict_pairs).
        vol_unbound = False
        if pod.spec.volumes:
            for vol in pod.spec.volumes:
                if vol.device_id:
                    devices.append((self.interns.devices.id(vol.device_id), not vol.read_only))
                if vol.pvc:
                    uid = f"{pod.namespace}/{vol.pvc}"
                    pvc_uids.append(uid)
                    pvc = self.volumes.pvcs.get(uid)
                    if pvc is None:
                        continue
                    if not pvc.volume_name and self.volumes.class_has_static_candidates(pvc.storage_class):
                        vol_unbound = True
                    driver = self.volumes.pvc_driver(pvc)
                    if driver:
                        did = self.interns.drivers.id(driver)
                        # Keyed by claim uid: stable across the unbound→bound
                        # transition (the PV name is not).
                        csivols[self.interns.csivols.id(f"{driver}^{uid}")] = did
                        if did < self.schema.DR and (self.host["csi_limit"][did] < 2**31 - 1).any():
                            vol_csi_lim = True
            self._ensure(
                VD=len(self.interns.devices),
                DR=len(self.interns.drivers),
                CV=len(self.interns.csivols),
            )
        host_ports = pod.host_ports()
        if len(host_ports) > POD_PORT_SLOTS:
            raise ValueError(
                f"pod {pod.uid} has {len(host_ports)} host ports (max {POD_PORT_SLOTS})"
            )
        ports = []
        for proto, ip, port in host_ports:
            triple = self.interns.ports.id((proto, ip, port))
            wild = self.interns.ports.id((proto, "0.0.0.0", port))
            pk = self.interns.ports.id((proto, None, port))  # key-level row
            self._ensure(P=max(triple, wild) + 1, PK=pk + 1)
            ports.append((triple, pk))
        return {
            "req": req_vec,
            "nonzero": np.array([cpu, mem], np.int64),
            "group": gid,
            "ports": ports,
            "own_terms": own_terms,
            "devices": devices,
            "csivols": sorted(csivols.items()),
            "pvcs": pvc_uids,
            "vol_unbound": vol_unbound,
            "vol_csi_lim": vol_csi_lim,
        }

    def apply_pod_delta(self, row: int, delta: dict, sign: int, device_already: bool) -> None:
        """Apply a pod's delta to host staging.  ``device_already=True`` when
        the device applied the same commit inside the pass (no re-upload).
        The delta may predate resource-column growth; re-pad it."""
        h = self.host
        if delta["req"].shape[0] < self.schema.R:
            delta["req"] = np.pad(delta["req"], (0, self.schema.R - delta["req"].shape[0]))
        h["req"][row] += sign * delta["req"]
        h["nonzero_req"][row] += sign * delta["nonzero"]
        h["num_pods"][row] += sign
        h["group_counts"][delta["group"], row] += sign
        for triple, pk in delta["ports"]:
            h["port_counts"][triple, row] += sign
            h["portkey_counts"][pk, row] += sign
        for tid in delta["own_terms"]:
            h["et_counts"][tid, row] += sign
        for vid, rw in delta["devices"]:
            h["dev_counts"][vid, row] += sign
            if rw:
                h["dev_rw_counts"][vid, row] += sign
        for vid, did in delta["csivols"]:
            # Distinct-volume accounting: csi_used counts volumes whose
            # per-node pod count crosses 0↔1, not pod references.
            prev = h["csivol_counts"][vid, row]
            h["csivol_counts"][vid, row] = prev + sign
            if (sign > 0 and prev == 0) or (sign < 0 and prev == 1):
                h["csi_used"][did, row] += sign
        if delta["pvcs"]:
            self.volumes.adjust_pvc_users(delta["pvcs"], sign)
        if not device_already:
            self._dirty_rows.add(row)

    # -- device mirror ---------------------------------------------------------

    def state(self) -> ClusterState:
        """Return the device ClusterState, flushing pending host changes."""
        if self._dirty_all or self._device is None:
            self._device = ClusterState(
                **{k: torch.tensor(v, device=self.device) for k, v in self.host.items()}
            )
            self.full_uploads += 1
            self._dirty_all = False
            self._dirty_rows.clear()
            return self._device
        if self._dirty_rows:
            from .kernels import plain, scatter_rows  # kernels → ops → snapshot: import at use

            if self._impl == "plain":
                scatter_rows = plain.scatter_rows

            rows = np.fromiter(sorted(self._dirty_rows), np.int64)
            idx = torch.from_numpy(rows).to(self.device)
            for k, ax in _NODE_AXIS.items():
                src = self.host[k][rows] if ax == 0 else self.host[k][:, rows]
                scatter_rows(
                    getattr(self._device, k), ax, idx,
                    torch.from_numpy(np.ascontiguousarray(src)).to(self.device),
                )
            self._dirty_rows.clear()
        return self._device

    def absorb_device_state(self, state: ClusterState) -> None:
        """Adopt the post-pass device tensors as the current device mirror."""
        self._device = state

    def invalidate_device(self) -> None:
        """Drop the device mirror (and the featurization cache) so the next
        state() rebuilds everything from host staging."""
        self._dirty_all = True
        self.feat_cache = None

    def host_mirror_equal(self) -> bool:
        """Consistency check host staging vs device: True iff every field's
        values agree (compared through numpy)."""
        if self._device is None:
            return True
        st = self.state()
        for k, hv in self.host.items():
            if not np.array_equal(hv, getattr(st, k).cpu().numpy()):
                return False
        return True
