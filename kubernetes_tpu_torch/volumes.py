"""Volume catalog: host-side PV/PVC/StorageClass/CSINode state and binding.

The port's own copy of ``kubernetes_tpu/volumes.py`` (VolumeCatalog,
:31-280): the host half of the volume plugins (reference:
plugins/volumebinding/binder.go FindPodVolumes/AssumePodVolumes,
volumezone, nodevolumelimits).  String and object matching stay on the
host; the device ops consume compiled requirement programs and per-node
count tensors produced from this catalog.

Dynamic provisioning runs in the reference package's "sync" mode: the
PreBind step creates the PV in-process.  Its "wait" mode (the PreBind wait
room that parks a pod until an external provisioner delivers the PV,
kubernetes_tpu/scheduler.py:2159-2200) is not ported: selecting it raises
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .api import types as t

# Zone/region label keys a PV may carry (volumezone/volume_zone.go
# topologyLabels; both GA and legacy beta names).
ZONE_KEYS = (
    "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
)
REGION_KEYS = (
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/region",
)

NO_PROVISIONER = "kubernetes.io/no-provisioner"


@dataclass
class VolumeCatalog:
    pvs: dict[str, t.PersistentVolume] = field(default_factory=dict)
    pvcs: dict[str, t.PersistentVolumeClaim] = field(default_factory=dict)
    classes: dict[str, t.StorageClass] = field(default_factory=dict)
    csinodes: dict[str, t.CSINode] = field(default_factory=dict)
    # PVC uid → number of pods using it (for ReadWriteOncePod conflicts,
    # volumerestrictions/volume_restrictions.go).
    pvc_users: dict[str, int] = field(default_factory=dict)
    # Bumped on every catalog mutation; the featurization cache keys on it
    # so a PV/PVC/class change invalidates cached pod features.
    epoch: int = 0
    # storage class → {pv name: pv} of UNBOUND static PVs, maintained at the
    # claim_ref mutation sites: the candidate index, and the chunk-conflict
    # gate (only a finite static-PV pool makes same-batch PreBinds race).
    unbound: dict[str, dict[str, t.PersistentVolume]] = field(default_factory=dict)
    _provisioning: str = field(default="sync", repr=False)

    @property
    def wffc_provisioning(self) -> str:
        """WaitForFirstConsumer dynamic provisioning mode: "sync" (the
        PreBind creates the PV in-process) is the only one ported."""
        return self._provisioning

    @wffc_provisioning.setter
    def wffc_provisioning(self, mode: str) -> None:
        if mode != "sync":
            raise NotImplementedError(
                f"wffc_provisioning={mode!r}: the PreBind wait room for an external "
                "provisioner is not yet ported (only 'sync')"
            )
        self._provisioning = mode

    # -- object events -------------------------------------------------------

    def add_pv(self, pv: t.PersistentVolume) -> None:
        """Upsert a PV (informer)."""
        old = self.pvs.get(pv.name)
        if old is not None and not old.claim_ref:
            self.unbound.get(old.storage_class, {}).pop(old.name, None)
        self.pvs[pv.name] = pv
        if not pv.claim_ref:
            self.unbound.setdefault(pv.storage_class, {})[pv.name] = pv
        self.epoch += 1

    def class_has_static_candidates(self, storage_class: str) -> bool:
        """Any unclaimed static PV in this class?"""
        return bool(self.unbound.get(storage_class))

    def add_pvc(self, pvc: t.PersistentVolumeClaim) -> None:
        self.pvcs[pvc.uid] = pvc
        self.epoch += 1

    def add_class(self, sc: t.StorageClass) -> None:
        self.classes[sc.name] = sc
        self.epoch += 1

    def add_csinode(self, csinode: t.CSINode) -> None:
        self.csinodes[csinode.name] = csinode
        self.epoch += 1

    def adjust_pvc_users(self, pvc_uids: list[str], delta: int) -> None:
        for uid in pvc_uids:
            self.pvc_users[uid] = self.pvc_users.get(uid, 0) + delta
        if pvc_uids:
            self.epoch += 1

    # -- pod classification --------------------------------------------------

    def pod_pvcs(self, pod: t.Pod) -> list[t.PersistentVolumeClaim | None]:
        """The pod's claims (None for dangling references)."""
        return [self.pvcs.get(f"{pod.namespace}/{vol.pvc}") for vol in pod.spec.volumes if vol.pvc]

    def classify(self, pvc: t.PersistentVolumeClaim):
        """→ ("bound", pv) | ("delayed", candidates, sc) |
        ("unbound_immediate", None) | ("lost", None).

        Mirrors volume_binding.go: bound claims resolve their PV; unbound
        claims with a WaitForFirstConsumer class bind at schedule time
        (candidates = matching unbound PVs, dynamic provisioning as
        fallback); unbound Immediate claims are UnschedulableAndUnresolvable
        until the PV controller binds them."""
        if pvc.volume_name:
            pv = self.pvs.get(pvc.volume_name)
            return ("bound", pv) if pv is not None else ("lost", None)
        sc = self.classes.get(pvc.storage_class)
        if sc is not None and sc.binding_mode == t.BINDING_WAIT_FOR_FIRST_CONSUMER:
            return ("delayed", self.candidates_for(pvc), sc)
        return ("unbound_immediate", None)

    def candidates_for(self, pvc: t.PersistentVolumeClaim) -> list[t.PersistentVolume]:
        """Static PVs this claim could bind (class, access modes, size —
        volumebinding's PV matching, persistentvolume/util.go FindMatchingVolume)."""
        out = []
        for pv in self.unbound.get(pvc.storage_class, {}).values():
            if not set(pvc.access_modes) <= set(pv.access_modes):
                continue
            if pv.capacity < pvc.request:
                continue
            out.append(pv)
        return out

    def pvc_driver(self, pvc: t.PersistentVolumeClaim) -> str:
        """CSI driver for attach-limit counting (nodevolumelimits/csi.go):
        bound → PV's driver; unbound → the class's provisioner."""
        if pvc.volume_name:
            pv = self.pvs.get(pvc.volume_name)
            if pv is not None and pv.csi_driver:
                return pv.csi_driver
            return ""
        sc = self.classes.get(pvc.storage_class)
        if sc is not None and sc.provisioner != NO_PROVISIONER:
            return sc.provisioner
        return ""

    # -- zone requirements (VolumeZone) -------------------------------------

    @staticmethod
    def zone_requirements(pv: t.PersistentVolume) -> list[t.NodeSelectorRequirement]:
        """A bound PV's zone/region labels as node requirements.  Label
        values may be ``__``-separated sets (volumehelpers.LabelZonesToSet)."""
        reqs = []
        for key in ZONE_KEYS + REGION_KEYS:
            v = pv.labels.get(key)
            if v is not None:
                reqs.append(t.NodeSelectorRequirement(key, t.OP_IN, tuple(v.split("__"))))
        return reqs

    # -- bind (the PreBind step) --------------------------------------------

    def bind_pod_volumes(self, pod: t.Pod, node: t.Node) -> list | None:
        """Bind the pod's delayed claims on the chosen node (the in-process
        analog of volumebinding PreBind, volume_binding.go:521).  Returns
        None when a claim can no longer be satisfied there (a same-batch
        race lost) — the caller forgets the pod (assume/forget protocol) —
        else a list of undo records for ``unbind_pod_volumes``."""
        chosen: list[tuple[t.PersistentVolumeClaim, t.PersistentVolume | None]] = []
        own_refs: dict[str, int] = {}
        for vol in pod.spec.volumes:
            if vol.pvc:
                uid = f"{pod.namespace}/{vol.pvc}"
                own_refs[uid] = own_refs.get(uid, 0) + 1
        for pvc in self.pod_pvcs(pod):
            if pvc is None:
                return None
            # Re-check ReadWriteOncePod here: a same-batch peer may have
            # assumed the claim after this pod was featurized (the pod's own
            # assume already counted its references).
            if t.RWOP in pvc.access_modes:
                others = self.pvc_users.get(pvc.uid, 0) - own_refs.get(pvc.uid, 0)
                if others > 0:
                    return None
            kind, *_rest = self.classify(pvc)
            if kind == "bound":
                continue
            if kind in ("lost", "unbound_immediate"):
                return None
            sc = self.classes.get(pvc.storage_class)
            cands = [
                pv
                for pv in self.candidates_for(pvc)
                if t.node_selector_matches(pv.node_affinity, node.metadata.labels, node.name)
            ]
            if cands:
                # Smallest satisfying PV (FindMatchingVolume picks the
                # smallest that fits).
                chosen.append((pvc, min(cands, key=lambda p: p.capacity)))
            elif sc is not None and sc.provisioner != NO_PROVISIONER:
                ok = sc.allowed_topologies is None or t.node_selector_matches(
                    sc.allowed_topologies, node.metadata.labels, node.name
                )
                if not ok:
                    return None
                chosen.append((pvc, None))  # dynamically provisioned
            else:
                return None
        undo: list[tuple[str, t.PersistentVolumeClaim, str]] = []
        for pvc, pv in chosen:
            if pv is None:
                name = f"provisioned-{pvc.namespace}-{pvc.name}"
                self.add_pv(
                    t.PersistentVolume(
                        name=name,
                        capacity=pvc.request,
                        access_modes=pvc.access_modes,
                        storage_class=pvc.storage_class,
                        claim_ref=pvc.uid,
                        csi_driver=self.pvc_driver(pvc),
                    )
                )
                pvc.volume_name = name
                undo.append(("provisioned", pvc, name))
            else:
                pv.claim_ref = pvc.uid
                pvc.volume_name = pv.name
                self.unbound.get(pv.storage_class, {}).pop(pv.name, None)
                self.epoch += 1
                undo.append(("static", pvc, pv.name))
        return undo

    def unbind_pod_volumes(self, undo: list) -> None:
        """Revert a bind_pod_volumes: release static PVs, delete the
        provisioned ones."""
        for kind, pvc, pv_name in undo:
            pvc.volume_name = ""
            if kind == "provisioned":
                self.pvs.pop(pv_name, None)
            else:
                pv = self.pvs.get(pv_name)
                if pv is not None:
                    pv.claim_ref = None
                    self.unbound.setdefault(pv.storage_class, {})[pv.name] = pv
        if undo:
            self.epoch += 1
