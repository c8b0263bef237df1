"""Object model: the subset of the Kubernetes API the scheduler consumes.

The port's own copy of ``kubernetes_tpu/api/types.py``, trimmed to what the
first port slice reads: quantities, pods, nodes, the affinity/spread/taint
specs (read by the not-yet-ported ops' ``is_active`` predicates so such
pods fail loudly), the volume objects the volume plugins read (pod
volume references, PersistentVolume, PersistentVolumeClaim, StorageClass,
CSINode) with the node-selector evaluator their PreBind step matches PV
affinities with, the label-selector evaluator that inter-pod affinity
matches terms with, and the PodDisruptionBudget that preemption counts
victims against.  DRA objects and Leases come with their slices.

These are plain Python dataclasses, not a port of the generated Go types
(reference: staging/src/k8s.io/api/core/v1/types.go).  Quantities are
canonicalized at parse time — CPU to integer millicores, everything else to
integer base units (bytes / counts) — matching how the reference's scheduler
consumes them after `resource.Quantity.MilliValue()` / `.Value()`
(pkg/scheduler/framework/types.go:1055 calculateResource).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Resource quantities
# ---------------------------------------------------------------------------

# Canonical resource names (mirrors v1.ResourceCPU etc.).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

_BINARY_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIX = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}

_QTY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]*)$")


def parse_quantity(value: str | int | float, resource: str = "") -> int:
    """Parse a Kubernetes quantity string to canonical integer units.

    CPU → millicores (``100m`` → 100, ``2`` → 2000); all other resources →
    base units, rounding up fractional values the way resource.Quantity does
    for scheduling purposes (``1.5Gi`` → 1610612736 bytes).
    """
    is_cpu = resource == CPU
    # Exact integer paths first: int64 quantities must not round-trip through
    # float (2^53+1 would silently lose precision).
    if isinstance(value, int):
        return value * 1000 if is_cpu else value
    if isinstance(value, float):
        num, suffix = value, ""
    else:
        m = _QTY_RE.match(value.strip())
        if not m:
            raise ValueError(f"cannot parse quantity {value!r}")
        mantissa, suffix = m.group(1), m.group(2)
        try:
            imant = int(mantissa)
        except ValueError:
            imant = None
        if imant is not None:
            # Integer mantissa: keep the arithmetic in exact ints wherever the
            # multiplier is integral.
            if suffix in _BINARY_SUFFIX:
                base_i = imant * _BINARY_SUFFIX[suffix]
                return base_i * 1000 if is_cpu else base_i
            mult = _DECIMAL_SUFFIX.get(suffix)
            if mult is None:
                raise ValueError(f"unknown quantity suffix {suffix!r} in {value!r}")
            if mult >= 1.0:
                base_i = imant * int(mult)
                return base_i * 1000 if is_cpu else base_i
            if is_cpu and suffix == "m":
                return imant  # millicores exactly
            num = float(imant)
        else:
            num = float(mantissa)
    if suffix in _BINARY_SUFFIX:
        base = num * _BINARY_SUFFIX[suffix]
    elif suffix in _DECIMAL_SUFFIX:
        base = num * _DECIMAL_SUFFIX[suffix]
    else:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {value!r}")
    if is_cpu:
        base *= 1000.0
    # Round up: a request of 0.5 byte must still reserve 1.
    scaled = int(base)
    if base > scaled:
        scaled += 1
    return scaled


def parse_resource_list(d: dict[str, str | int | float] | None) -> dict[str, int]:
    """Parse {"cpu": "2", "memory": "4Gi", ...} to canonical integer units."""
    if not d:
        return {}
    return {k: parse_quantity(v, k) for k, v in d.items()}


# Defaults used for NonZeroRequested (reference:
# pkg/scheduler/util/pod_resources.go — DefaultMilliCPURequest / DefaultMemoryRequest).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


# ---------------------------------------------------------------------------
# Selectors / affinity
# ---------------------------------------------------------------------------

# NodeSelectorOperator values (staging/src/k8s.io/api/core/v1/types.go).
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str
    values: tuple[str, ...] = ()


@dataclass(frozen=True)
class NodeSelectorTerm:
    # Requirements are ANDed; terms are ORed.
    match_expressions: tuple[NodeSelectorRequirement, ...] = ()
    match_fields: tuple[NodeSelectorRequirement, ...] = ()


@dataclass(frozen=True)
class NodeSelector:
    terms: tuple[NodeSelectorTerm, ...] = ()


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: tuple[PreferredSchedulingTerm, ...] = ()


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    """A label selector; None means "match nothing", empty means "match all"."""

    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[LabelSelectorRequirement, ...] = ()


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: Optional[LabelSelector]
    topology_key: str
    namespaces: tuple[str, ...] = ()
    namespace_selector: Optional[LabelSelector] = None


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class PodAntiAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# TopologySpreadConstraint.whenUnsatisfiable
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

# Node inclusion policies.
POLICY_HONOR = "Honor"
POLICY_IGNORE = "Ignore"


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    node_affinity_policy: str = POLICY_HONOR
    node_taints_policy: str = POLICY_IGNORE
    # matchLabelKeys (gated by MatchLabelKeysInPodTopologySpread): the
    # pod's values for these keys merge into the effective selector, so
    # spreading counts only pods of the same rollout generation
    # (podtopologyspread/filtering.go mergeLabelSetWithSelector).
    match_label_keys: tuple[str, ...] = ()


def spread_effective_selector(
    c: "TopologySpreadConstraint", pod_labels
) -> Optional[LabelSelector]:
    """The constraint's selector with matchLabelKeys merged in: each listed
    key present on the pod adds an exact-match requirement with the pod's
    value; absent keys are skipped (filtering.go mergeLabelSetWithSelector)."""
    if not c.match_label_keys:
        return c.label_selector
    extra = tuple((k, pod_labels[k]) for k in c.match_label_keys if k in pod_labels)
    if not extra:
        return c.label_selector
    base = c.label_selector or LabelSelector()
    return LabelSelector(
        match_labels=base.match_labels + extra,
        match_expressions=base.match_expressions,
    )


# ---------------------------------------------------------------------------

EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = EFFECT_NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty matches all effects
    # NoExecute grace (v1.Toleration.TolerationSeconds): None = tolerate
    # forever; N = the taint-eviction controller evicts after N seconds.
    toleration_seconds: Optional[float] = None

    def tolerates(self, taint: Taint) -> bool:
        """Mirror of v1helper.TolerationsTolerateTaint single-taint check
        (staging/src/k8s.io/api/core/v1/toleration.go ToleratesTaint)."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        return self.value == taint.value


# ---------------------------------------------------------------------------
# Pods
# ---------------------------------------------------------------------------

RESTART_POLICY_ALWAYS = "Always"


@dataclass(frozen=True)
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    requests: dict[str, int] = field(default_factory=dict)  # canonical units
    limits: dict[str, int] = field(default_factory=dict)
    ports: tuple[ContainerPort, ...] = ()
    restart_policy: Optional[str] = None  # init containers: "Always" = sidecar
    images: tuple[str, ...] = ()


@dataclass(frozen=True)
class PodSchedulingGate:
    name: str


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)


PREEMPT_LOWER_PRIORITY = "PreemptLowerPriority"
PREEMPT_NEVER = "Never"


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    overhead: dict[str, int] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: tuple[Toleration, ...] = ()
    topology_spread_constraints: tuple[TopologySpreadConstraint, ...] = ()
    priority: int = 0
    preemption_policy: str = PREEMPT_LOWER_PRIORITY
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    scheduling_gates: tuple[PodSchedulingGate, ...] = ()
    # NB: no quotes around Volume — the module's lazy annotations resolve
    # the whole string at get_type_hints time, but a QUOTED name inside a
    # PEP-585 generic stays a plain str forever (3.10 never converts it
    # to a ForwardRef), which made the generated dumper emit raw Volume
    # objects and broke every JSON path that serialized a volume pod.
    volumes: tuple[Volume, ...] = ()
    # Gang scheduling (coscheduling-style): name of the pod's PodGroup.
    pod_group: str = ""
    # ResourceClaim names in the pod's namespace (spec.resourceClaims).
    resource_claims: tuple[str, ...] = ()


@dataclass
class PodStatus:
    nominated_node_name: str = ""
    phase: str = "Pending"
    start_time: float = 0.0  # pod start timestamp (preemption tie-break)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        # Memoized: the uid is read on every queue/cache/commit touch
        # (~17 reads per scheduled pod) and informer deliveries always
        # arrive as NEW objects, so the identity can never change under a
        # live instance.
        u = self.__dict__.get("_uid")
        if u is None:
            u = (
                self.metadata.uid
                or f"{self.metadata.namespace}/{self.metadata.name}"
            )
            self.__dict__["_uid"] = u
        return u

    def resource_request(self) -> dict[str, int]:
        """Effective scheduling request.

        Mirrors resourcehelper.PodRequests as the scheduler uses it
        (pkg/scheduler/framework/types.go:1055 calculateResource):
        max(sum of app containers + sidecars, peak init container) + overhead.
        """
        total: dict[str, int] = {}

        def add(into: dict[str, int], frm: dict[str, int]) -> None:
            for k, v in frm.items():
                into[k] = into.get(k, 0) + v

        def maxof(into: dict[str, int], frm: dict[str, int]) -> None:
            for k, v in frm.items():
                if v > into.get(k, 0):
                    into[k] = v

        for c in self.spec.containers:
            add(total, c.requests)
        sidecar_sum: dict[str, int] = {}
        init_peak: dict[str, int] = {}
        for c in self.spec.init_containers:
            if c.restart_policy == RESTART_POLICY_ALWAYS:
                add(sidecar_sum, c.requests)
                # A sidecar's own request plus all earlier sidecars is a peak too.
                maxof(init_peak, dict(sidecar_sum))
            else:
                peak = dict(sidecar_sum)
                add(peak, c.requests)
                maxof(init_peak, peak)
        add(total, sidecar_sum)
        maxof(total, init_peak)
        if self.spec.overhead:
            add(total, self.spec.overhead)
        return total

    def non_zero_request(self) -> tuple[int, int]:
        """(milliCPU, memory) with per-container scheduler defaults for missing
        requests (reference: NonMissingContainerRequests in
        noderesources/resource_allocation.go:123 and
        pkg/scheduler/util/pod_resources.go GetNonzeroRequests)."""

        def defaulted(c: Container, res: str, dflt: int) -> int:
            v = c.requests.get(res)
            return dflt if v is None else v

        cpu = sum(defaulted(c, CPU, DEFAULT_MILLI_CPU_REQUEST) for c in self.spec.containers)
        mem = sum(defaulted(c, MEMORY, DEFAULT_MEMORY_REQUEST) for c in self.spec.containers)
        # Init-container peak with the same defaulting.
        init_cpu = max(
            (defaulted(c, CPU, DEFAULT_MILLI_CPU_REQUEST) for c in self.spec.init_containers),
            default=0,
        )
        init_mem = max(
            (defaulted(c, MEMORY, DEFAULT_MEMORY_REQUEST) for c in self.spec.init_containers),
            default=0,
        )
        cpu, mem = max(cpu, init_cpu), max(mem, init_mem)
        cpu += self.spec.overhead.get(CPU, 0)
        mem += self.spec.overhead.get(MEMORY, 0)
        return cpu, mem

    def host_ports(self) -> list[tuple[str, str, int]]:
        """(protocol, hostIP, hostPort) triples with hostPort != 0."""
        out = []
        for c in self.spec.containers:
            for p in c.ports:
                if p.host_port:
                    out.append((p.protocol or "TCP", p.host_ip or "0.0.0.0", p.host_port))
        return out


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContainerImage:
    names: tuple[str, ...]
    size_bytes: int = 0


@dataclass
class NodeSpec:
    taints: tuple[Taint, ...] = ()
    unschedulable: bool = False


@dataclass
class NodeStatus:
    capacity: dict[str, int] = field(default_factory=dict)
    allocatable: dict[str, int] = field(default_factory=dict)
    images: tuple[ContainerImage, ...] = ()


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass(frozen=True)
class Volume:
    """One pod volume: a PVC reference or an in-tree device volume
    (GCE PD / AWS EBS / AzureDisk / ISCSI modeled uniformly as a device id
    with the reference's both-read-only exemption)."""

    name: str = ""
    pvc: str = ""  # PVC name (pod's namespace)
    device_id: str = ""  # in-tree volume unique device id
    read_only: bool = False


# ---------------------------------------------------------------------------
# Volumes (PV / PVC / StorageClass / CSINode): the subset the scheduler's
# volume plugins consume (kubernetes_tpu/api/types.py:632-696; reference:
# pkg/scheduler/framework/plugins/volumebinding, volumezone,
# volumerestrictions, nodevolumelimits).
# ---------------------------------------------------------------------------

BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

RWO = "ReadWriteOnce"
ROX = "ReadOnlyMany"
RWX = "ReadWriteMany"
RWOP = "ReadWriteOncePod"


@dataclass
class StorageClass:
    name: str
    provisioner: str = "kubernetes.io/no-provisioner"
    binding_mode: str = BINDING_IMMEDIATE
    # Topology restriction for dynamically provisioned volumes
    # (StorageClass.allowedTopologies): OR of terms like a NodeSelector.
    allowed_topologies: Optional[NodeSelector] = None


@dataclass
class PersistentVolume:
    name: str
    capacity: int = 0  # bytes
    access_modes: tuple[str, ...] = (RWO,)
    storage_class: str = ""
    # PV.spec.nodeAffinity.required — where this volume is reachable.
    node_affinity: Optional[NodeSelector] = None
    labels: dict[str, str] = field(default_factory=dict)  # incl. zone/region
    claim_ref: Optional[str] = None  # "ns/name" of the bound PVC
    csi_driver: str = ""  # CSI driver name (for attach limits)


@dataclass
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    storage_class: str = ""
    access_modes: tuple[str, ...] = (RWO,)
    request: int = 0  # bytes
    volume_name: str = ""  # bound PV, "" = unbound

    @property
    def uid(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class CSINode:
    """CSINode.spec.drivers[*].allocatable.count per driver."""

    name: str  # node name
    driver_limits: dict[str, int] = field(default_factory=dict)


@dataclass
class PodDisruptionBudget:
    """policy/v1 PodDisruptionBudget, reduced to what preemption reads: the
    selector and the live status.disruptionsAllowed count
    (preemption.go filterPodsWithPDBViolation).  The spec fields are kept
    so a budget that carries them is recognised; recomputing the status
    from them (the disruption controller) is not ported."""

    name: str
    selector: Optional[LabelSelector] = None
    disruptions_allowed: int = 0
    namespace: str = "default"
    min_available: Optional[int | str] = None
    max_unavailable: Optional[int | str] = None


# ---------------------------------------------------------------------------
# Scalar (host-side) selector evaluation: the reference semantics the
# vectorized group index (intern.GroupIndex) reproduces.
# ---------------------------------------------------------------------------


def label_selector_matches(sel: Optional[LabelSelector], labels: dict[str, str]) -> bool:
    """Mirror of metav1.LabelSelectorAsSelector + Matches
    (staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/helpers.go).
    None selects nothing; empty selects everything."""
    if sel is None:
        return False
    for k, v in sel.match_labels:
        if labels.get(k) != v:
            return False
    for req in sel.match_expressions:
        has = req.key in labels
        val = labels.get(req.key)
        if req.operator == OP_IN:
            if not has or val not in req.values:
                return False
        elif req.operator == OP_NOT_IN:
            if has and val in req.values:
                return False
        elif req.operator == OP_EXISTS:
            if not has:
                return False
        elif req.operator == OP_DOES_NOT_EXIST:
            if has:
                return False
        else:
            raise ValueError(f"bad label selector operator {req.operator}")
    return True


def _as_int(s: Optional[str]) -> Optional[int]:
    try:
        return int(s)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return None


def node_selector_requirement_matches(
    req: NodeSelectorRequirement, labels: dict[str, str]
) -> bool:
    """Mirror of nodeaffinity.nodeSelectorRequirementsAsSelector semantics
    (staging/src/k8s.io/component-helpers/scheduling/corev1/nodeaffinity/nodeaffinity.go)."""
    has = req.key in labels
    val = labels.get(req.key)
    if req.operator == OP_IN:
        return has and val in req.values
    if req.operator == OP_NOT_IN:
        return not has or val not in req.values
    if req.operator == OP_EXISTS:
        return has
    if req.operator == OP_DOES_NOT_EXIST:
        return not has
    if req.operator in (OP_GT, OP_LT):
        if not has or len(req.values) != 1:
            return False
        lhs, rhs = _as_int(val), _as_int(req.values[0])
        if lhs is None or rhs is None:
            return False
        return lhs > rhs if req.operator == OP_GT else lhs < rhs
    raise ValueError(f"bad node selector operator {req.operator}")


def node_selector_term_matches(
    term: NodeSelectorTerm, labels: dict[str, str], node_name: str = ""
) -> bool:
    if not term.match_expressions and not term.match_fields:
        return False  # empty term matches nothing (nodeaffinity.go:nodeSelectorTermsMatch)
    for req in term.match_expressions:
        if not node_selector_requirement_matches(req, labels):
            return False
    for req in term.match_fields:
        # Only supported field is metadata.name.
        if req.key != "metadata.name":
            return False
        if not node_selector_requirement_matches(
            NodeSelectorRequirement("metadata.name", req.operator, req.values),
            {"metadata.name": node_name},
        ):
            return False
    return True


def node_selector_matches(
    sel: Optional[NodeSelector], labels: dict[str, str], node_name: str = ""
) -> bool:
    """A required node selector (OR of terms) against one node; None
    matches every node, a selector without terms none."""
    if sel is None:
        return True
    if not sel.terms:
        return False
    return any(node_selector_term_matches(t, labels, node_name) for t in sel.terms)
