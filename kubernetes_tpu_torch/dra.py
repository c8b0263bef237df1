"""Dynamic Resource Allocation: host-side claim catalog + allocation.

The port's own copy of ``kubernetes_tpu/dra.py``.  The device half (the
count columns ``dra_cap``/``dra_alloc``/``dra_claim_counts`` of the torch
ClusterState) is filled by snapshot.py and read by
ops/dynamicresources.py and the kernels.

The host half of the DynamicResources plugin
(pkg/scheduler/framework/plugins/dynamicresources/, wired at
scheduler.go:298–302 through the claim assume-cache) with STRUCTURED
PARAMETERS (staging/src/k8s.io/dynamic-resource-allocation/structured/
allocator.go): ResourceSlices publish named devices with typed attributes;
claims carry device requests narrowed by CEL selectors (the vectorizable
subset, dra_cel.py).  Allocation is delayed (the scheduler allocates at
Reserve/PreBind, like WaitForFirstConsumer volume binding), pins the claim
to one node and names the chosen devices; deallocation happens when the
last reserving pod goes away.

TPU-first split: requests intern into SELECTOR POOLS — one pool per
distinct (class, canonical-selector) — and the device tensors carry
per-pool per-node cap/alloc count columns (ClusterState.dra_cap/dra_alloc),
so the compiled pass filters ``alloc + need ≤ cap`` per pool exactly like
the counted form (ops/dynamicresources.py).  Pool counts OVER-approximate
feasibility when pools overlap on devices (a device taken under pool A
still counts free under an overlapping pool B until the host re-check);
this catalog's exact named-device allocator is authoritative at Reserve —
a lost race forgets the pod and retries, the same assume-cache pattern as
volumes.VolumeCatalog.bind_pod_volumes."""

from __future__ import annotations

from dataclasses import dataclass, field

from .api import types as t
from . import dra_cel


def pool_sig(device_class: str, selectors: tuple[str, ...]) -> str:
    """Pool signature: the class itself for selector-less requests, else
    class + canonical selector form (equivalent spellings share a pool)."""
    if not selectors:
        return device_class
    return f"{device_class}|{dra_cel.canonical(selectors)}"


@dataclass
class ClaimCatalog:
    claims: dict[str, t.ResourceClaim] = field(default_factory=dict)
    # (node, device_class) → published device count.
    slices: dict[tuple[str, str], int] = field(default_factory=dict)
    # (node, device_class) → devices consumed by allocated claims
    # (named local allocations + count-only external charges).
    allocated: dict[tuple[str, str], int] = field(default_factory=dict)
    # (node, device_class) → {device name → attributes} (ResourceSlice
    # devices; counted slices synthesize anonymous attribute-less ones).
    devices: dict[tuple[str, str], dict[str, dict]] = field(default_factory=dict)
    # (node, device_class) → {device name → owning claim uid}.
    device_owner: dict[tuple[str, str], dict[str, str]] = field(default_factory=dict)
    # Selector pools: sig → (device_class, compiled requirements).  Bare
    # class pools have empty requirements.
    pools: dict[str, tuple[str, tuple]] = field(default_factory=dict)
    pools_by_class: dict[str, list[str]] = field(default_factory=dict)
    # Pools registered since the scheduler last collected them (their cap
    # columns need backfilling for existing nodes).
    new_pools: list[str] = field(default_factory=list)
    epoch: int = 0  # featurization cache token
    # External-allocation row charges (see add_claim): claims whose phantom
    # reservation is applied to node rows, and those waiting for their
    # node to appear (the claim-before-node informer race — the same one
    # add_node replays CSINode/ResourceSlices for).  Values are per-request
    # charge lists [(node, pool sig, count)].
    row_charged: dict[str, list[tuple[str, str, int]]] = field(default_factory=dict)
    pending_external: dict[str, list[tuple[str, str, int]]] = field(default_factory=dict)
    # claim uid → pod uids reserved IN-PROCESS (allocate_pod_claims).  The
    # assume-cache stale-echo guard keys off these, not off the informer's
    # status.reservedFor — external consumers releasing a claim is a real
    # deallocation, not an echo.
    local_reserved: dict[str, set[str]] = field(default_factory=dict)
    # Pool-overlap CORRECTIONS.  A claim's reservation transition charges
    # its REQUEST pools; once allocation names the devices, every OTHER
    # pool those devices match must charge too (a device taken under
    # "bigmem" is no longer free under the bare class pool).  corrections
    # holds each allocated claim's extra per-pool charges (reversed at
    # deallocation); corr_events queues (node, [(sig, cnt)], ±1) row
    # adjustments for the scheduler to apply (TPUScheduler.
    # _drain_dra_corrections).  Within one batch the scan still sees the
    # uncorrected counts — same-batch overlap races lose the host Reserve
    # re-check and retry against the corrected state.
    corrections: dict[str, list[tuple[str, int]]] = field(default_factory=dict)
    corr_events: list[tuple[str, list[tuple[str, int]], int]] = field(default_factory=list)
    # Corrections whose applied row charges died with a removed node —
    # parked like pending_external, replayed when the node returns (for
    # external claims, whose base charges replay too; a local claim's stay
    # parked until deallocation clears them, matching its vaporized pods).
    pending_corr: dict[str, list[tuple[str, int]]] = field(default_factory=dict)

    # -- pools ---------------------------------------------------------------

    def ensure_pool(self, device_class: str, selectors: tuple[str, ...]) -> str:
        """Intern a (class, selectors) pool; compile errors propagate (the
        reference fails allocation on CEL compile errors, allocator.go:159)."""
        sig = pool_sig(device_class, selectors)
        if sig not in self.pools:
            # DNF: a union of requirement-conjunction branches (`||` maps
            # onto the pool machinery as branch union — one pool, one
            # count column, matching = any branch holds).
            self.pools[sig] = (
                device_class, dra_cel.compile_selectors(tuple(selectors))
            )
            self.pools_by_class.setdefault(device_class, []).append(sig)
            self.new_pools.append(sig)
        return sig

    def request_pools(self, claim: t.ResourceClaim) -> list[tuple[str, int, t.DeviceRequest]]:
        """[(pool sig, count, request)] for the claim's device requests."""
        return [
            (self.ensure_pool(r.device_class, r.selectors), r.count, r)
            for r in claim.device_requests()
        ]

    def charge_pools(self, claim: t.ResourceClaim) -> list[tuple[str, int]]:
        """The pools a claim's transition charges: each request's own pool
        PLUS the bare class pool for selector requests — every selector
        pool is a subset of its class pool, so charging both keeps
        bare-vs-selector availability exact on device (only
        selector-vs-selector overlap is left to the corrections)."""
        out: list[tuple[str, int]] = []
        for sig, cnt, req in self.request_pools(claim):
            out.append((sig, cnt))
            if req.selectors:
                self.ensure_pool(req.device_class, ())
                out.append((req.device_class, cnt))
        return out

    def pool_cap(self, node: str, sig: str) -> int:
        """Devices on ``node`` matching the pool (allocated or not)."""
        cls, reqs = self.pools[sig]
        if not reqs or reqs == ((),):
            # Selector-less pool (compile_selectors(()) is the vacuous
            # single empty branch): every device matches — O(1) count.
            return self.slices.get((node, cls), 0)
        devs = self.devices.get((node, cls), {})
        return sum(1 for attrs in devs.values() if dra_cel.matches(reqs, attrs))

    def new_pool_alloc(self, node: str, sig: str) -> int:
        """The alloc value for a JUST-registered pool's column on ``node``:
        per owning claim, max(devices actually matching, what the claim's
        own transition already charges this pool) — corrections record only
        the EXCESS over the transition charge, so deallocation (transition
        discharge + correction reversal) nets to exactly this value.
        Count-only external charges keep their recorded per-pool amounts
        (devices unknown — the host re-check covers the slack)."""
        cls, reqs = self.pools[sig]
        owners = self.device_owner.get((node, cls), {})
        attrs_of = self.devices.get((node, cls), {})
        actual_by_uid: dict[str, int] = {}
        for dev, uid in owners.items():
            if dra_cel.matches(reqs, attrs_of.get(dev, {})):
                actual_by_uid[uid] = actual_by_uid.get(uid, 0) + 1
        total = 0
        seen_uids = set(actual_by_uid)
        for uid, actual in actual_by_uid.items():
            claim = self.claims.get(uid)
            charged = (
                sum(c for s2, c in self.charge_pools(claim) if s2 == sig)
                if claim is not None
                else 0
            )
            charged += sum(
                c for s2, c in self.corrections.get(uid, ()) if s2 == sig
            )
            contribution = max(actual, charged)
            if contribution > charged:
                self.corrections.setdefault(uid, []).append(
                    (sig, contribution - charged)
                )
            total += contribution
        # External claims charged on this node for this pool whose devices
        # did not land in actual_by_uid (count-only, or named but
        # non-matching) keep their applied charge in the column.
        for uid, charges in self.row_charged.items():
            if uid in seen_uids:
                continue
            total += sum(
                c for n2, s2, c in charges if n2 == node and s2 == sig
            )
        return total

    # -- object events -------------------------------------------------------

    def add_claim(
        self, claim: t.ResourceClaim
    ) -> list[tuple[str, str, int, int]]:
        """Upsert a claim (informer).  Returns row-charge deltas
        [(node, pool sig, count, ±1)] for EXTERNAL allocation changes — an
        allocation written by another scheduler (or a restart replay)
        consumes devices the moment it arrives, exactly as the reference's
        claim assume-cache sees it.  The charge rides a PHANTOM
        reservation (SnapshotBuilder.apply_external_claim) so a local pod
        later reserving the same claim cannot double-charge.

        Assume-cache semantics (the reference accepts only informer
        objects newer than its assumed version): an upsert that would
        DE-allocate a claim with live local reservations is a stale watch
        echo of the pre-allocation object and is dropped; an upsert whose
        allocation matches the current record replaces the object without
        touching accounting (local reservations carry over)."""
        # Register the claim's selector pools up front (compile errors
        # surface at the informer edge, not mid-featurize) — the scheduler
        # backfills new pools' cap columns right after this call.
        for r in claim.device_requests():
            self.ensure_pool(r.device_class, r.selectors)
        old = self.claims.get(claim.uid)
        if old is not None:
            local = self.local_reserved.get(claim.uid, ())
            if local and not claim.allocated_node:
                return []  # stale echo: local truth wins until released
            # Local reservations survive the object replacement; an
            # external consumer vanishing from status.reservedFor does not
            # get resurrected from the old object.
            merged = tuple(dict.fromkeys(
                claim.reserved_for
                + tuple(u for u in old.reserved_for if u in local)
            ))
            claim.reserved_for = merged
        deltas: list[tuple[str, str, int, int]] = []
        old_key = (
            (old.allocated_node, tuple(old.device_requests()))
            if old is not None and old.allocated_node
            else None
        )
        new_key = (
            (claim.allocated_node, tuple(claim.device_requests()))
            if claim.allocated_node
            else None
        )
        if old_key != new_key:
            if old_key is not None:
                deltas += self._external_charge(old, -1)
            if new_key is not None:
                self.claims[claim.uid] = claim  # request_pools needs it
                deltas += self._external_charge(claim, +1)
        self.claims[claim.uid] = claim
        self.epoch += 1
        return deltas

    def _external_charge(self, claim: t.ResourceClaim, sign: int):
        """Counter + named-device bookkeeping for an externally-allocated
        claim; returns the per-request row deltas."""
        node = claim.allocated_node
        for req in claim.device_requests():
            key = (node, req.device_class)
            self.allocated[key] = self.allocated.get(key, 0) + sign * req.count
        out = [
            (node, sig, cnt, sign) for sig, cnt in self.charge_pools(claim)
        ]
        if sign < 0:
            # Corrections recorded for this claim (new-pool backfill over
            # its named devices) reverse with the external deallocation;
            # node-removal-parked ones die unapplied (their charges went
            # with the row) — never replay them against a later allocation.
            corr = self.corrections.pop(claim.uid, None)
            if corr:
                self.corr_events.append((node, corr, -1))
            self.pending_corr.pop(claim.uid, None)
        if claim.allocated_devices:
            # The allocation result names its devices: own/free them so
            # selector pools see exact availability.
            for _rname, dev in claim.allocated_devices:
                owners = self.device_owner.setdefault(
                    (node, self._device_class_of(claim, _rname)), {}
                )
                if sign > 0:
                    owners[dev] = claim.uid
                elif owners.get(dev) == claim.uid:
                    del owners[dev]
        return out

    @staticmethod
    def _device_class_of(claim: t.ResourceClaim, request_name: str) -> str:
        for r in claim.device_requests():
            if r.name == request_name:
                return r.device_class
        return claim.device_requests()[0].device_class

    def add_slice(self, s: t.ResourceSlice) -> None:
        key = (s.node_name, s.device_class)
        devs = self.devices.setdefault(key, {})
        if s.devices:
            for d in s.devices:
                # Capacity quantities live beside the attributes under
                # reserved "capacity://" keys (dra_cel.CAPACITY_PREFIX),
                # so capacity terms reuse the requirement machinery.
                attrs = d.attributes
                if d.capacity:
                    attrs = dict(attrs)
                    for ck, cv in d.capacity.items():
                        # Normalize quantity strings ("40Gi") to canonical
                        # ints here — a raw string would silently fail
                        # every capacity comparison (ordered ops require
                        # numbers), the exact silent-mismatch class this
                        # subsystem turns into loud errors.
                        attrs[dra_cel.CAPACITY_PREFIX + ck] = (
                            cv
                            if isinstance(cv, int) and not isinstance(cv, bool)
                            else t.parse_quantity(cv)
                        )
                devs[d.name] = attrs
        else:
            base = len(devs)
            for i in range(s.count):
                devs[f"{s.device_class}-{base + i}"] = {}
        self.slices[key] = len(devs)
        self.epoch += 1

    def pod_claims(self, pod: t.Pod) -> list[t.ResourceClaim | None]:
        return [
            self.claims.get(f"{pod.namespace}/{name}")
            for name in pod.spec.resource_claims
        ]

    def free(self, node: str, device_class: str) -> int:
        key = (node, device_class)
        return self.slices.get(key, 0) - self.allocated.get(key, 0)

    def _free_matching(self, node: str, req: t.DeviceRequest) -> list[str]:
        """Unowned device names on ``node`` matching the request's
        selectors, in sorted order (deterministic pick — the scalar oracle
        mirrors it)."""
        key = (node, req.device_class)
        owners = self.device_owner.get(key, {})
        # The interned pool holds the compiled requirements — no re-parse.
        _cls, reqs = self.pools[self.ensure_pool(req.device_class, req.selectors)]
        return sorted(
            name
            for name, attrs in self.devices.get(key, {}).items()
            if name not in owners and dra_cel.matches(reqs, attrs)
        )

    def allocate_pod_claims(self, pod: t.Pod, node: str) -> list | None:
        """Allocate/reserve the pod's claims on ``node`` (the Reserve step,
        dynamicresources' claim assume + API write; the exact named-device
        allocator, structured/allocator.go).  Returns undo records, or None
        when a claim can no longer be satisfied there (allocation race
        lost — the caller forgets the pod and retries)."""
        # Validate first (all-or-nothing): pick devices for every request
        # of every still-unallocated claim against a working owner view.
        taken: dict[tuple[str, str], set[str]] = {}
        need_counter: dict[str, int] = {}
        picks: dict[str, list[tuple[str, str, str]]] = {}  # claim → [(req, cls, dev)]
        seen_claims: set[str] = set()
        for claim in self.pod_claims(pod):
            if claim is None:
                return None
            if claim.uid in seen_claims:
                continue  # a pod may reference the same claim twice
            seen_claims.add(claim.uid)
            if claim.allocated_node:
                if claim.allocated_node != node:
                    return None
                continue
            for req in claim.device_requests():
                free_names = [
                    n
                    for n in self._free_matching(node, req)
                    if n not in taken.get((node, req.device_class), set())
                ]
                if len(free_names) < req.count:
                    return None
                chosen = free_names[: req.count]
                taken.setdefault((node, req.device_class), set()).update(chosen)
                picks.setdefault(claim.uid, []).extend(
                    (req.name, req.device_class, d) for d in chosen
                )
                need_counter[req.device_class] = (
                    need_counter.get(req.device_class, 0) + req.count
                )
        # Counter guard: count-only EXTERNAL charges consume capacity
        # without naming devices, so named availability over-states.
        for cls, cnt in need_counter.items():
            if self.free(node, cls) < cnt:
                return None
        undo: list[tuple[str, t.ResourceClaim, str]] = []
        committed: set[str] = set()
        for claim in self.pod_claims(pod):
            if claim.uid in committed:
                continue
            committed.add(claim.uid)
            if not claim.allocated_node:
                claim.allocated_node = node
                claim.allocated_devices = tuple(
                    (rname, dev) for rname, _cls, dev in picks.get(claim.uid, ())
                )
                for rname, cls, dev in picks.get(claim.uid, ()):
                    self.device_owner.setdefault((node, cls), {})[dev] = claim.uid
                for req in claim.device_requests():
                    key = (node, req.device_class)
                    self.allocated[key] = self.allocated.get(key, 0) + req.count
                self._record_corrections(claim, node, picks.get(claim.uid, ()))
                undo.append(("allocated", claim, ""))
            if pod.uid not in claim.reserved_for:
                claim.reserved_for += (pod.uid,)
                self.local_reserved.setdefault(claim.uid, set()).add(pod.uid)
                undo.append(("reserved", claim, pod.uid))
        if undo:
            self.epoch += 1
        return undo

    def _record_corrections(self, claim, node: str, picks) -> None:
        """Per-pool overlap charges for a freshly-named allocation: for
        every pool of the devices' classes, (devices actually matching) −
        (what the claim's request-pool transitions charge)."""
        by_class: dict[str, list[str]] = {}
        for _rname, cls, dev in picks:
            by_class.setdefault(cls, []).append(dev)
        charged: dict[str, int] = {}
        for sig, cnt in self.charge_pools(claim):
            charged[sig] = charged.get(sig, 0) + cnt
        corr: list[tuple[str, int]] = []
        for cls, devs in by_class.items():
            attrs_of = self.devices.get((node, cls), {})
            for sig in self.pools_by_class.get(cls, ()):
                _c, reqs = self.pools[sig]
                actual = sum(
                    1 for d in devs if dra_cel.matches(reqs, attrs_of.get(d, {}))
                )
                delta = actual - charged.get(sig, 0)
                if delta:
                    corr.append((sig, delta))
        if corr:
            self.corrections[claim.uid] = corr
            self.corr_events.append((node, corr, +1))

    def _deallocate(self, claim: t.ResourceClaim) -> None:
        node = claim.allocated_node
        for req in claim.device_requests():
            key = (node, req.device_class)
            self.allocated[key] = self.allocated.get(key, 0) - req.count
        for rname, dev in claim.allocated_devices:
            owners = self.device_owner.get(
                (node, self._device_class_of(claim, rname)), {}
            )
            if owners.get(dev) == claim.uid:
                del owners[dev]
        corr = self.corrections.pop(claim.uid, None)
        if corr:
            self.corr_events.append((node, corr, -1))
        self.pending_corr.pop(claim.uid, None)  # never re-applied: no event
        claim.allocated_node = ""
        claim.allocated_devices = ()

    def unallocate(self, undo: list) -> None:
        """Revert allocate_pod_claims (gang rollback)."""
        for kind, claim, uid in undo:
            if kind == "reserved":
                claim.reserved_for = tuple(
                    u for u in claim.reserved_for if u != uid
                )
                self.local_reserved.get(claim.uid, set()).discard(uid)
            else:
                self._deallocate(claim)
        if undo:
            self.epoch += 1

    def release_pod(self, pod_uid: str) -> list[tuple[str, str, str, int]]:
        """Drop the pod's reservations; deallocate claims nobody reserves
        (the resourceclaim controller's cleanup, in-process).  Returns row
        discharges [(uid, node, pool sig, count)] for deallocated claims
        whose charge was EXTERNAL (row_charged) — locally-charged claims
        discharge through the removing pod's own delta transition."""
        changed = False
        discharges: list[tuple[str, str, str, int]] = []
        for claim in self.claims.values():
            if pod_uid in claim.reserved_for:
                claim.reserved_for = tuple(
                    u for u in claim.reserved_for if u != pod_uid
                )
                self.local_reserved.get(claim.uid, set()).discard(pod_uid)
                changed = True
                if not claim.reserved_for and claim.allocated_node:
                    node = claim.allocated_node
                    charged = self.row_charged.pop(claim.uid, None)
                    self.pending_external.pop(claim.uid, None)
                    if charged is not None:
                        discharges.extend(
                            (claim.uid, n, sig, cnt) for n, sig, cnt in charged
                        )
                    self._deallocate(claim)
        if changed:
            self.epoch += 1
        return discharges
