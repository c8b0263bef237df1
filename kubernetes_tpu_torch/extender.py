"""Scheduler extenders: out-of-process filter/prioritize/bind webhooks.

Counterpart of ``kubernetes_tpu/extender.py`` (the whole module).  It
mirrors upstream's HTTP extender (pkg/scheduler/extender.go) and its wire
types (staging/src/k8s.io/kube-scheduler/extender/v1/types.go:73–124): an
extender is an external service consulted AFTER the in-process filter pass
(findNodesThatPassExtenders, schedule_one.go:704) and alongside score
aggregation (prioritizeNodes, schedule_one.go:799–857).  Extender scores
are 0..MaxExtenderPriority (10) and are rescaled by weight onto the
node-score range.

Extenders serialize a host round trip per pod, so a scheduler with
extenders schedules through the eval-only device pass
(engine/pass_.build_eval_pass): the per-node filter verdicts and scores
come back to the host, the extender chain runs, and the host commits the
pick.  That is the position upstream is in — its extender calls are
synchronous HTTP inside the cycle; schedulers without extenders keep the
batch pass.
"""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass, field
from typing import Protocol

from .api import types as t

MAX_EXTENDER_PRIORITY = 10  # extender/v1/types.go:29
MAX_NODE_SCORE = 100


@dataclass
class ExtenderArgs:
    """extender/v1 ExtenderArgs (types.go:73)."""

    pod: t.Pod
    node_names: list[str]

    def to_json(self) -> dict:
        return {
            "Pod": {
                "metadata": {
                    "name": self.pod.metadata.name,
                    "namespace": self.pod.namespace,
                    "labels": dict(self.pod.metadata.labels),
                },
                "spec": {"priority": self.pod.spec.priority},
            },
            "NodeNames": self.node_names,
        }


@dataclass
class ExtenderFilterResult:
    """extender/v1 ExtenderFilterResult (types.go:88)."""

    node_names: list[str] = field(default_factory=list)
    failed_nodes: dict[str, str] = field(default_factory=dict)
    failed_and_unresolvable_nodes: dict[str, str] = field(default_factory=dict)
    error: str = ""


@dataclass
class HostPriority:
    """extender/v1 HostPriority (types.go:124)."""

    host: str
    score: int


class Extender(Protocol):
    """The scheduler-side extender surface (framework.Extender)."""

    name: str
    weight: int
    ignorable: bool  # errors don't fail the cycle (extender.go IsIgnorable)

    def filter(self, pod: t.Pod, nodes: list[str]) -> ExtenderFilterResult: ...

    def prioritize(self, pod: t.Pod, nodes: list[str]) -> list[HostPriority]: ...

    def bind(self, pod: t.Pod, node: str) -> bool: ...

    def is_interested(self, pod: t.Pod) -> bool: ...


@dataclass
class HTTPExtender:
    """HTTP+JSON extender client (pkg/scheduler/extender.go HTTPExtender):
    POSTs ExtenderArgs to url_prefix/<verb>."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    ignorable: bool = False
    timeout_s: float = 5.0
    # Pods with no resource request in managed_resources skip this extender
    # (extender.go IsInterested).
    managed_resources: tuple[str, ...] = ()

    @property
    def name(self) -> str:
        return self.url_prefix

    def _post(self, verb: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.url_prefix.rstrip('/')}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.load(resp)

    def is_interested(self, pod: t.Pod) -> bool:
        if not self.managed_resources:
            return True
        req = pod.resource_request()
        return any(req.get(r, 0) > 0 for r in self.managed_resources)

    def filter(self, pod: t.Pod, nodes: list[str]) -> ExtenderFilterResult:
        if not self.filter_verb:
            return ExtenderFilterResult(node_names=list(nodes))
        out = self._post(self.filter_verb, ExtenderArgs(pod, nodes).to_json())
        return ExtenderFilterResult(
            node_names=list(out.get("NodeNames") or []),
            failed_nodes=dict(out.get("FailedNodes") or {}),
            failed_and_unresolvable_nodes=dict(
                out.get("FailedAndUnresolvableNodes") or {}
            ),
            error=out.get("Error") or "",
        )

    def prioritize(self, pod: t.Pod, nodes: list[str]) -> list[HostPriority]:
        if not self.prioritize_verb:
            return []
        out = self._post(self.prioritize_verb, ExtenderArgs(pod, nodes).to_json())
        return [
            HostPriority(h["Host"], int(h["Score"])) for h in out or []
        ]

    def bind(self, pod: t.Pod, node: str) -> bool:
        if not self.bind_verb:
            return True
        out = self._post(
            self.bind_verb,
            {"PodName": pod.metadata.name, "PodNamespace": pod.namespace, "Node": node},
        )
        return not (out or {}).get("Error")

    @property
    def supports_preemption(self) -> bool:
        # extender.go SupportsPreemption: declared by a preempt verb.
        return bool(self.preempt_verb)

    def process_preemption(
        self, pod: t.Pod, node_to_victims: dict[str, list[t.Pod]]
    ) -> dict[str, list[str]]:
        """ProcessPreemption (extender.go, wire types extender/v1
        ExtenderPreemptionArgs/Result): POST the candidate victim map as
        NodeNameToMetaVictims ({node: {Pods: [{UID}]}}), get back the
        subset of nodes (with victim uids) the extender accepts."""
        payload = {
            "Pod": ExtenderArgs(pod, []).to_json()["Pod"],
            "NodeNameToMetaVictims": {
                node: {"Pods": [{"UID": v.uid} for v in victims]}
                for node, victims in node_to_victims.items()
            },
        }
        out = self._post(self.preempt_verb, payload)
        result = out.get("NodeNameToMetaVictims") or {}
        return {
            node: [p.get("UID", "") for p in (meta or {}).get("Pods", [])]
            for node, meta in result.items()
        }


def run_extender_chain(
    extenders: list, pod: t.Pod, feasible: list[str], scores: dict[str, int]
) -> tuple[list[str], dict[str, int], set[str]]:
    """Filter + prioritize through the chain.

    Filtering is sequential and shrinking (findNodesThatPassExtenders);
    prioritize results are weighted and ADDED to the in-process scores
    (prioritizeNodes: extender scores × weight on top of plugin scores).
    Returns (surviving nodes, combined scores, unresolvable nodes)."""
    nodes = list(feasible)
    unresolvable: set[str] = set()
    for ex in extenders:
        if not nodes:
            break
        if not ex.is_interested(pod):
            continue
        try:
            res = ex.filter(pod, nodes)
        except Exception:
            if ex.ignorable:
                continue
            raise
        if res.error and not ex.ignorable:
            raise RuntimeError(f"extender {ex.name}: {res.error}")
        unresolvable |= set(res.failed_and_unresolvable_nodes)
        nodes = [n for n in res.node_names if n not in unresolvable]
    combined = {n: scores.get(n, 0) for n in nodes}
    for ex in extenders:
        if not ex.is_interested(pod):
            continue
        try:
            prios = ex.prioritize(pod, nodes)
        except Exception:
            if ex.ignorable:
                continue
            raise
        for hp in prios:
            if hp.host in combined:
                # Extender scores are 0..10, rescaled by weight
                # (prioritizeNodes: score * weight; the reference adds the
                # raw product to the MaxNodeScore-normalized plugin sum).
                combined[hp.host] += hp.score * ex.weight
    return nodes, combined, unresolvable
