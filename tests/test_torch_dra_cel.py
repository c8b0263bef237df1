"""The port's CEL subset compiler (kubernetes_tpu_torch/dra_cel.py) against
the JAX package's, exactly: for every selector of the cases of
tests/test_dra_structured.py:24-201 and :639 (comparisons, conjunctions
and typed accessors, ``in``, existence and truthiness, disjunctions with
parentheses and nesting, capacity quantities, the DNF bound, the residue
that must stay a compile error, mixed-type branches, canonical signatures
and the strict bool/int typing), the compiled branches (as their repr),
the canonical signature and the match verdict on each attribute set must
be equal, and a selector one side refuses must be refused by both.
Tolerance: none (exact)."""

import pytest

from kubernetes_tpu import dra_cel as jcel
from kubernetes_tpu_torch import dra_cel as tcel

GI40 = 40 * 1024**3
ATTRS = (
    {}, {"gpu.example.com/memory": 80}, {"gpu.example.com/memory": 16},
    {"arch": "hopper", "nvlink": True}, {"arch": "hopper", "nvlink": False}, {"arch": "ada", "nvlink": True},
    {"arch": "b"}, {"cc": 9}, {"nvlink": True}, {"nvlink": False}, {"nvlink": 1}, {"x": True}, {"x": 1},
    {"x": 2}, {"x": "a"}, {"arch": "hopper", "mem": 16}, {"arch": "ada", "mem": 80}, {"arch": "ada", "mem": 16},
    {"arch": "blackwell", "nvlink": True}, {"arch": "blackwell", "nvlink": False},
    {"a": 1, "b": 2}, {"a": 1, "b": 0, "c": True, "d": -1}, {"a": 1, "b": 0, "c": True, "d": 0}, {"a": 0, "b": 2},
    {"capacity://memory": GI40}, {"arch": "hopper", "nvlink": True, "capacity://memory": GI40},
    {"arch": "hopper", "nvlink": False, "capacity://memory": 2 * GI40},
    {"arch": "hopper", "nvlink": False, "capacity://memory": GI40},
)
SELECTORS = (
    'device.attributes["gpu.example.com/memory"].int >= 40',
    'device.attributes["arch"].string == "hopper" && device.attributes["nvlink"].bool == true',
    'device.attributes["arch"] in ["a", "b"]',
    '"cc" in device.attributes',
    '!("cc" in device.attributes)',
    'device.attributes["nvlink"]',
    '!device.attributes["nvlink"]',
    'device.attributes["arch"].string == "hopper" || device.attributes["mem"].int >= 80',
    '(device.attributes["arch"].string == "hopper" || device.attributes["arch"].string == "blackwell") && '
    'device.attributes["nvlink"].bool == true',
    'device.attributes["a"].int >= 1 && (device.attributes["b"].int >= 2 || '
    '("c" in device.attributes && device.attributes["d"].int < 0))',
    'device.capacity["memory"].isGreaterThan(quantity("10Gi"))',
    'device.capacity["memory"].isGreaterThan(quantity("40Gi"))',
    'device.capacity["memory"].isLessThan(quantity("1Ti"))',
    'device.capacity["memory"].isEqualTo(quantity("40Gi"))',
    'device.capacity["memory"] >= quantity("40Gi")',
    'device.capacity["memory"] != quantity("39Gi")',
    'device.capacity["memory"] < quantity("40Gi")',
    '"memory" in device.capacity',
    '"hugepages" in device.capacity',
    '!("hugepages" in device.capacity)',
    'device.capacity["hugepages"] > quantity("1")',
    'device.attributes["arch"].string == "hopper" && (device.capacity["memory"] >= quantity("80Gi") || '
    'device.attributes["nvlink"].bool == true)',
    # Residue: a compile error on both sides.
    'device.attributes["x"].matches("re.*")',
    'device.attributes["v"].isGreaterThan(semver("1.0.0"))',
    'cel.bind(dra, device.attributes["d"], dra.x)',
    'device.driver == "dra.example.com"',
    "",
    " && ".join(f'(device.attributes["a{i}"].int >= 1 || device.attributes["b{i}"].int >= 1)' for i in range(8)),
    'device.attributes["x"].int == 1 || device.attributes["x"].string == "a"',
    'device.attributes["x"].int == 1 && device.attributes["x"].string == "a"',
    'device.attributes["x"].int >= 1 || device.attributes["y"].int >= 2',
    'device.attributes["y"].int >= 2 || device.attributes["x"].int >= 1',
    'device.attributes["x"].int >= 1 || device.attributes["x"].int >= 1',
    'device.attributes["nvlink"].bool == true',
    'device.attributes["nvlink"].bool != true',
    'device.attributes["x"] in [1, 2]',
)
# Multi-selector (ANDed) signatures: equivalent spellings share a pool.
SELECTOR_SETS = (
    ('device.attributes["m"].int >= 40 && device.attributes["a"].string == "x"',),
    ('device.attributes["a"].string == "x"', 'device.attributes["m"].int >= 40'),
)


def _outcome(cel, fn):
    try:
        return ("ok", fn(cel))
    except ValueError as e:
        return ("ValueError", type(e).__name__)


@pytest.mark.parametrize("case", list(range(len(SELECTORS) + len(SELECTOR_SETS))))
def test_cel_matches_jax(case):
    if case < len(SELECTORS):
        sels = (SELECTORS[case],)
        compile_ = lambda cel: cel.compile_selector(sels[0])  # noqa: E731
    else:
        sels = SELECTOR_SETS[case - len(SELECTORS)]
        compile_ = lambda cel: cel.compile_selectors(sels)  # noqa: E731
    want = _outcome(jcel, lambda cel: repr(compile_(cel)))
    assert _outcome(tcel, lambda cel: repr(compile_(cel))) == want
    assert _outcome(tcel, lambda cel: cel.canonical(sels)) == _outcome(jcel, lambda cel: cel.canonical(sels))
    if want[0] != "ok":
        return
    jbr, tbr = compile_(jcel), compile_(tcel)
    assert [tcel.matches(tbr, a) for a in ATTRS] == [jcel.matches(jbr, a) for a in ATTRS]


def test_equivalent_spellings_share_a_signature():
    a, b = (tcel.canonical(s) for s in SELECTOR_SETS)
    assert a == b == jcel.canonical(SELECTOR_SETS[0])
    x_or_y = 'device.attributes["x"].int >= 1 || device.attributes["y"].int >= 2'
    y_or_x = 'device.attributes["y"].int >= 2 || device.attributes["x"].int >= 1'
    assert tcel.canonical((x_or_y,)) == tcel.canonical((y_or_x,))
