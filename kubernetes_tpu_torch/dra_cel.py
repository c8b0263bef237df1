"""CEL device-selector compilation — the vectorizable subset, in DNF.

The port's own copy of ``kubernetes_tpu/dra_cel.py`` (host-only; no line
of it touches a tensor).

The reference evaluates request selectors as CEL programs over
``device.attributes`` / ``device.capacity``
(staging/src/k8s.io/dynamic-resource-allocation/cel/compile.go;
expressions like ``device.attributes["gpu.example.com/memory"].int >= 40``
or ``device.capacity["mem"].isGreaterThan(quantity("10Gi"))`` — see
cel/compile_test.go and dynamicresources_test.go:117).  Full CEL cannot
run on device; this build takes the NodeAffinity playbook (compiled
requirement programs): the selector grammar below compiles once into a
DISJUNCTIVE NORMAL FORM — a union of conjunction branches — evaluated
host-side per DEVICE when selector POOLS are (re)computed, so the
per-pod/per-node hot path only reads pool count columns.  ``||`` maps
onto the pool machinery as the union of compilable branches (a device
matches when ANY branch's requirements all hold); parentheses group.

Grammar:

    or_expr  := and_expr ("||" and_expr)*
    and_expr := unit ("&&" unit)*
    unit     := "(" or_expr ")" | term
    term     := attr [accessor] op literal
              | attr [".bool"]                  (truthy)
              | "!" attr [".bool"]
              | STRING "in" "device.attributes"
              | "!(" STRING "in device.attributes" ")"
              | cap ".isGreaterThan(" qty ")"   (likewise isLessThan,
                                                 isEqualTo)
              | cap op qty                      (==, !=, >=, <=, >, <)
              | STRING "in" "device.capacity"
              | "!(" STRING "in device.capacity" ")"
    attr     := device.attributes["KEY"]
    cap      := device.capacity["KEY"]
    qty      := quantity("QUANTITY")
    accessor := .bool | .int | .string
    op       := == | != | >= | <= | > | < | in
    literal  := int | "string" | true | false | [literal, ...]

Capacity values are canonical integers (types.parse_quantity units — the
same canonicalization every quantity in the object model gets), stored
beside attributes under reserved ``capacity://KEY`` keys ("//" never
appears in attribute names), so capacity terms reuse the ordered
requirement machinery unchanged.

Residue — still hard config errors, deliberately (the reference
likewise fails allocation on CEL compile errors, allocator.go:159):
``semver()`` comparisons, string functions (startsWith/endsWith/matches),
``cel.bind``, ``device.driver``, nested domain access
(``device.attributes["domain"].field``), and arithmetic.  These do not
appear in the scheduler-perf/dynamicresources test workloads; the common
capacity/attribute/disjunction forms above all compile.

CEL semantics note: a missing attribute makes the reference's expression
error, which the allocator treats as the device not matching; here a term
over a missing key evaluates false, the same observable outcome."""

from __future__ import annotations

import re
from dataclasses import dataclass

from .api.types import parse_quantity

_ATTR = r'device\.attributes\["(?P<key>[^"\]]+)"\](?:\.(?P<acc>bool|int|string))?'
_LIT = r"""(?P<num>-?\d+)|"(?P<str>[^"]*)"|(?P<bool>true|false)|(?P<list>\[[^\]]*\])"""
_TERM_CMP = re.compile(
    rf"^{_ATTR}\s*(?P<op>==|!=|>=|<=|>|<|\bin\b)\s*(?:{_LIT})$"
)
_TERM_TRUTHY = re.compile(rf"^(?P<neg>!\s*)?{_ATTR}$")
_TERM_EXISTS = re.compile(
    r'^(?P<neg>!\s*\(\s*)?"(?P<key>[^"]+)"\s+in\s+device\.attributes\s*(?(neg)\))$'
)
_CAP = r'device\.capacity\["(?P<key>[^"\]]+)"\]'
_QTY = r'quantity\(\s*"(?P<qty>[^"]+)"\s*\)'
_TERM_CAP_CMP = re.compile(
    rf"^{_CAP}\s*(?P<op>==|!=|>=|<=|>|<)\s*{_QTY}$"
)
_TERM_CAP_FN2 = re.compile(
    rf"^{_CAP}\.(?P<fn>isGreaterThan|isLessThan|isEqualTo)\(\s*{_QTY}\s*\)$"
)
_TERM_CAP_EXISTS = re.compile(
    r'^(?P<neg>!\s*\(\s*)?"(?P<key>[^"]+)"\s+in\s+device\.capacity\s*(?(neg)\))$'
)

# Reserved key prefix for capacity entries in the merged per-device dict
# (dra.py add_slice): attribute names never contain "//".
CAPACITY_PREFIX = "capacity://"

# DNF expansion bound: branches multiply across &&-joined groups; past
# this the expression is adversarial, not a workload.
MAX_BRANCHES = 64


def _same_kind(a, b) -> bool:
    """bool and int are distinct CEL types (True must not equal 1)."""
    return isinstance(a, bool) == isinstance(b, bool)


@dataclass(frozen=True)
class Requirement:
    """One compiled term: ``key op value`` over a device's attributes
    (capacity terms carry the ``capacity://`` key prefix)."""

    key: str
    op: str  # Eq | Ne | Ge | Le | Gt | Lt | In | Exists | DoesNotExist | Truthy | Falsy
    values: tuple = ()

    def matches(self, attrs: dict) -> bool:
        present = self.key in attrs
        if self.op == "Exists":
            return present
        if self.op == "DoesNotExist":
            return not present
        if not present:
            return False  # CEL errors on missing attrs → device no-match
        v = attrs[self.key]
        if self.op == "Truthy":
            return v is True
        if self.op == "Falsy":
            return v is False
        # CEL is type-strict: bool-vs-int comparisons type-error, which the
        # allocator reads as no-match (Python's True == 1 must not leak in,
        # and a type-error makes Ne false too, not true).
        if self.op == "Eq":
            return _same_kind(v, self.values[0]) and v == self.values[0]
        if self.op == "Ne":
            return _same_kind(v, self.values[0]) and v != self.values[0]
        if self.op == "In":
            return any(_same_kind(v, w) and v == w for w in self.values)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return False  # ordered ops need numbers
        w = self.values[0]
        return (
            v >= w if self.op == "Ge"
            else v <= w if self.op == "Le"
            else v > w if self.op == "Gt"
            else v < w
        )


def _parse_literal(m: re.Match):
    if m.group("num") is not None:
        return int(m.group("num"))
    if m.group("str") is not None:
        return m.group("str")
    if m.group("bool") is not None:
        return m.group("bool") == "true"
    inner = m.group("list")[1:-1].strip()
    vals = []
    for part in re.findall(r'-?\d+|"[^"]*"', inner):
        vals.append(part[1:-1] if part.startswith('"') else int(part))
    return tuple(vals)


_OPS = {"==": "Eq", "!=": "Ne", ">=": "Ge", "<=": "Le", ">": "Gt", "<": "Lt", "in": "In"}
_CAP_FNS = {"isGreaterThan": "Gt", "isLessThan": "Lt", "isEqualTo": "Eq"}

Branch = tuple  # tuple[Requirement, ...]


def _compile_term(term: str) -> Requirement:
    m = _TERM_CMP.match(term)
    if m:
        lit = _parse_literal(m)
        op = _OPS[m.group("op")]
        if op == "In":
            if not isinstance(lit, tuple):
                raise ValueError(f"'in' needs a list literal: {term!r}")
            return Requirement(m.group("key"), "In", lit)
        acc = m.group("acc")
        if acc == "int" and not isinstance(lit, int):
            raise ValueError(f".int compared to non-int: {term!r}")
        if acc == "string" and not isinstance(lit, str):
            raise ValueError(f".string compared to non-string: {term!r}")
        if acc == "bool" and not isinstance(lit, bool):
            raise ValueError(f".bool compared to non-bool: {term!r}")
        if op in ("Ge", "Le", "Gt", "Lt") and not isinstance(lit, int):
            raise ValueError(f"ordered compare needs an int: {term!r}")
        return Requirement(m.group("key"), op, (lit,))
    m = _TERM_CAP_FN2.match(term)
    if m:
        q = parse_quantity(m.group("qty"))
        return Requirement(
            CAPACITY_PREFIX + m.group("key"), _CAP_FNS[m.group("fn")], (q,)
        )
    m = _TERM_CAP_CMP.match(term)
    if m:
        q = parse_quantity(m.group("qty"))
        return Requirement(CAPACITY_PREFIX + m.group("key"), _OPS[m.group("op")], (q,))
    m = _TERM_CAP_EXISTS.match(term)
    if m:
        return Requirement(
            CAPACITY_PREFIX + m.group("key"),
            "DoesNotExist" if m.group("neg") else "Exists",
        )
    m = _TERM_EXISTS.match(term)
    if m:
        return Requirement(
            m.group("key"), "DoesNotExist" if m.group("neg") else "Exists"
        )
    m = _TERM_TRUTHY.match(term)
    if m:
        if m.group("acc") not in (None, "bool"):
            raise ValueError(f"bare attribute term must be bool: {term!r}")
        return Requirement(m.group("key"), "Falsy" if m.group("neg") else "Truthy")
    raise ValueError(
        f"CEL selector term outside the vectorizable subset: {term!r}"
    )


def _split_top(expr: str, sep: str) -> list[str]:
    """Split on ``sep`` (&& or ||) outside quotes/brackets/parens."""
    parts, depth, quote, start = [], 0, False, 0
    i = 0
    while i < len(expr):
        c = expr[i]
        if c == '"':
            quote = not quote
        elif not quote and c in "([":
            depth += 1
        elif not quote and c in ")]":
            depth -= 1
        elif not quote and depth == 0 and expr.startswith(sep, i):
            parts.append(expr[start:i])
            i += 2
            start = i
            continue
        i += 1
    parts.append(expr[start:])
    return parts


def _is_group(s: str) -> bool:
    """True when ``s`` is one parenthesized group: "(...)" with the
    opening paren matching the final char."""
    if not (s.startswith("(") and s.endswith(")")):
        return False
    depth, quote = 0, False
    for i, c in enumerate(s):
        if c == '"':
            quote = not quote
        elif not quote and c == "(":
            depth += 1
        elif not quote and c == ")":
            depth -= 1
            if depth == 0:
                return i == len(s) - 1
    return False


def _parse_or(expr: str) -> tuple[Branch, ...]:
    branches: list[Branch] = []
    for part in _split_top(expr, "||"):
        branches.extend(_parse_and(part.strip()))
    return tuple(branches)


def _parse_and(expr: str) -> tuple[Branch, ...]:
    branches: list[Branch] = [()]
    for part in _split_top(expr, "&&"):
        unit = part.strip()
        if not unit:
            raise ValueError(f"empty term in CEL selector: {expr!r}")
        sub = (
            _parse_or(unit[1:-1].strip())
            if _is_group(unit)
            else ((_compile_term(unit),),)
        )
        branches = [b1 + b2 for b1 in branches for b2 in sub]
        if len(branches) > MAX_BRANCHES:
            raise ValueError(
                f"CEL selector expands past {MAX_BRANCHES} DNF branches: {expr!r}"
            )
    return tuple(branches)


def _req_key(r: Requirement):
    # Values can mix int and str across requirements (e.g. an int-vs-str
    # disjunction on one attribute); tag by type so sorting never
    # compares across types.
    return (r.key, r.op, tuple((type(v).__name__, repr(v)) for v in r.values))


def _canonical_branch(b: Branch) -> Branch:
    return tuple(sorted(set(b), key=_req_key))


def compile_selector(expr: str) -> tuple[Branch, ...]:
    """Compile one CEL selector expression into DNF: a union of
    requirement-conjunction branches (a device matches when any branch's
    requirements all hold).  Raises ValueError outside the supported
    subset."""
    if not expr.strip():
        raise ValueError("empty CEL selector")
    branches = _parse_or(expr.strip())
    # Canonical: sorted, duplicate branches collapsed.
    seen: dict[Branch, None] = {}
    for b in branches:
        seen.setdefault(_canonical_branch(b))
    return tuple(sorted(seen, key=lambda b: tuple(_req_key(r) for r in b)))


def compile_selectors(selectors: tuple[str, ...]) -> tuple[Branch, ...]:
    """DNF of the CONJUNCTION of several selector expressions (a request's
    ``selectors`` list ANDs them, allocator.go selectorsMatch)."""
    branches: tuple[Branch, ...] = ((),)
    for s in selectors:
        sub = compile_selector(s)
        merged = [b1 + b2 for b1 in branches for b2 in sub]
        if len(merged) > MAX_BRANCHES:
            raise ValueError(
                f"CEL selector set expands past {MAX_BRANCHES} DNF branches"
            )
        branches = tuple(merged)
    seen: dict[Branch, None] = {}
    for b in branches:
        seen.setdefault(_canonical_branch(b))
    return tuple(sorted(seen, key=lambda b: tuple(_req_key(r) for r in b)))


def canonical(selectors: tuple[str, ...]) -> str:
    """Canonical signature of a selector set for pool interning: the sorted
    DNF, so differently-written equivalent selectors share a pool."""
    return "|".join(
        ";".join(
            f"{r.key}\x00{r.op}\x00{','.join(map(repr, r.values))}" for r in b
        )
        for b in compile_selectors(tuple(selectors))
    )


def matches(branches: tuple[Branch, ...], attrs: dict) -> bool:
    """True when any DNF branch's requirements all hold for the device
    (attrs carries capacity entries under CAPACITY_PREFIX keys)."""
    return any(all(r.matches(attrs) for r in b) for b in branches)
