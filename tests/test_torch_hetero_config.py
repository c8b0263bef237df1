"""The heterogeneity config of the port against the reference's rules:
``load_weights`` refuses every bad artifact tests/test_heterogeneity.py
checks, ``validate_profile`` reports the same heterogeneity and
RequestedToCapacityRatio errors as the JAX package's, the shipped
profiles validate clean, and the port's ``learned_weights.json`` is the
reference's byte for byte."""

import json

import pytest

from kubernetes_tpu.framework import config as jcfg
from kubernetes_tpu.ops import learned as jlearned
from kubernetes_tpu.ops import throughput as jthroughput
from kubernetes_tpu_torch.framework import config as tcfg
from kubernetes_tpu_torch.ops import learned as tlearned
from kubernetes_tpu_torch.ops import throughput as tthroughput


def test_learned_weights_artifact_is_the_references_byte_for_byte():
    with open(jlearned.DEFAULT_WEIGHTS_PATH, "rb") as f, open(tlearned.DEFAULT_WEIGHTS_PATH, "rb") as g:
        assert f.read() == g.read()
    assert tlearned.load_weights() == jlearned.load_weights()


@pytest.mark.parametrize(
    "change,match",
    [
        ({"version": 2}, "version"),
        ({"w1": "drop_row"}, "feature rows"),
        ({"w2": "add_entry"}, "entries"),
        ({"b2": float("nan")}, "non-finite"),
        ({"b1": []}, "empty hidden layer"),
        ({"w1": "short_col"}, "cols"),
        ({"b1": "inf"}, "non-finite"),
    ],
)
def test_load_weights_refuses_bad_artifacts_like_the_reference(tmp_path, change, match):
    good = json.load(open(tlearned.DEFAULT_WEIGHTS_PATH))
    doc = dict(good)
    key, value = next(iter(change.items()))
    if value == "drop_row":
        doc["w1"] = good["w1"][:-1]
    elif value == "add_entry":
        doc["w2"] = good["w2"] + [0.1]
    elif value == "short_col":
        doc["w1"] = [row[:-1] if i == 2 else row for i, row in enumerate(good["w1"])]
    elif value == "inf":
        doc["b1"] = [float("inf")] + good["b1"][1:]
    else:
        doc[key] = value
    path = tmp_path / "w.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match=match):
        jlearned.load_weights(str(path))
    with pytest.raises(ValueError, match=match):
        tlearned.load_weights(str(path))
    good_path = tmp_path / "good.json"
    good_path.write_text(json.dumps(good))
    assert tlearned.load_weights(str(good_path)) == jlearned.load_weights(str(good_path))


def _pair(**kw):
    jkw, tkw = dict(kw), dict(kw)
    if "strategy" in kw:
        typ, res, shape = kw.pop("strategy")
        jkw.pop("strategy"), tkw.pop("strategy")
        jkw["scoring_strategy"] = jcfg.ScoringStrategy(typ, res, shape)
        tkw["scoring_strategy"] = tcfg.ScoringStrategy(typ, res, shape)
    return jcfg.Profile(name="x", **jkw), tcfg.Profile(name="x", **tkw)


HETERO_CASES = {
    "tp without matrix": dict(scorers=(("ThroughputAware", 1),)),
    "ls without weights": dict(scorers=(("LearnedScorer", 1),)),
    "empty row": dict(throughput_matrix=(("a", ()),)),
    "negative": dict(throughput_matrix=(("a", (("v4", -1),)),)),
    "all zero": dict(throughput_matrix=(("a", (("v4", 0), ("v5e", 0))),)),
    "duplicate class": dict(throughput_matrix=(("a", (("v4", 1),)), ("a", (("v4", 2),)))),
    "duplicate accel": dict(throughput_matrix=(("a", (("v4", 1), ("v4", 2))),)),
    "float throughput": dict(throughput_matrix=(("a", (("v4", 1.5),)),)),
    "bad weights": dict(learned_weights=((), (0.1,), (0.2,), 0.0)),
    "ragged weights": dict(learned_weights=(((0.1, 0.2),) * 5, (0.1,), (0.2,), 0.0)),
    "rtcr one point": dict(strategy=(jcfg.REQUESTED_TO_CAPACITY_RATIO, (("cpu", 1),), ((0, 0),))),
    "rtcr decreasing util": dict(strategy=(jcfg.REQUESTED_TO_CAPACITY_RATIO, (("cpu", 1),), ((50, 0), (10, 10)))),
    "rtcr out of range": dict(strategy=(jcfg.REQUESTED_TO_CAPACITY_RATIO, (("cpu", 1),), ((0, 0), (120, 11)))),
    "strategy unknown": dict(strategy=("Spread", (("cpu", 1),), ((0, 0), (100, 10)))),
    "resource weight": dict(strategy=(jcfg.LEAST_ALLOCATED, (("cpu", 0),), ((0, 0), (100, 10)))),
    "no resources": dict(strategy=(jcfg.MOST_ALLOCATED, (), ((0, 0), (100, 10)))),
    "scorer weight": dict(scorers=(("NodeResourcesFit", 0),)),
    "duplicate scorer": dict(scorers=(("NodeResourcesFit", 1), ("NodeResourcesFit", 2))),
    "percentage": dict(percentage_of_nodes_to_score=120),
}


@pytest.mark.parametrize("case", sorted(HETERO_CASES))
def test_validate_profile_reports_the_references_errors(case):
    jp, tp = _pair(**HETERO_CASES[case])
    want = jcfg.validate_profile(jp)
    assert want, case
    assert tcfg.validate_profile(tp) == want


def test_validate_profile_catches_hetero_config_errors():
    """tests/test_heterogeneity.py:205 on the port's validate_profile."""
    p = tcfg.Profile(name="x", scorers=(("ThroughputAware", 1),))
    assert any("throughput_matrix is empty" in e for e in tcfg.validate_profile(p))
    p = tcfg.Profile(name="x", scorers=(("LearnedScorer", 1),))
    assert any("learned_weights is empty" in e for e in tcfg.validate_profile(p))
    p = tcfg.Profile(name="x", throughput_matrix=(("a", ()),))
    assert any("empty accelerator row" in e for e in tcfg.validate_profile(p))
    p = tcfg.Profile(name="x", throughput_matrix=(("a", (("v4", -1),)),))
    assert any("non-negative" in e for e in tcfg.validate_profile(p))
    assert tcfg.validate_profile(tthroughput.throughput_aware_profile()) == []
    assert tcfg.validate_profile(tlearned.learned_scorer_profile()) == []
    assert tcfg.validate_profile(tcfg.DEFAULT_PROFILE) == []


def test_profiles_and_matrix_equal_the_references():
    assert tthroughput.DEFAULT_THROUGHPUT_MATRIX == jthroughput.DEFAULT_THROUGHPUT_MATRIX
    assert tthroughput.matrix_accel_classes(tthroughput.DEFAULT_THROUGHPUT_MATRIX) == \
        jthroughput.matrix_accel_classes(jthroughput.DEFAULT_THROUGHPUT_MATRIX)
    for tp, jp in ((tthroughput.throughput_aware_profile(), jthroughput.throughput_aware_profile()),
                   (tlearned.learned_scorer_profile(), jlearned.learned_scorer_profile())):
        for field in ("name", "filters", "scorers", "throughput_matrix", "learned_weights",
                      "percentage_of_nodes_to_score", "tie_break_seed"):
            assert getattr(tp, field) == getattr(jp, field), field
