"""The plain references against small hand-made cases."""

import os
import sys
import types

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(BENCH, "reference"))

import ref_approx  # noqa: E402
import ref_lines  # noqa: E402


def _text(s: bytes):
    return np.frombuffer(s, dtype=np.uint8)


def _edits(a: bytes, b: bytes) -> int:
    """Least edits that turn some substring of b into a (plain DP)."""
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return min(prev)


LINES = [b"matching", b"matchng", b"atching", b"matchingg", b"mtaching",
         b"xx matc hing", b"match", b"", b"m", b"machine", b"matcihng",
         b"hello world matching", b"MATCHING"]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_literal_matches_edit_distance(k):
    text = _text(b"".join(x + b"\n" for x in LINES))
    st, nl, hit = ref_lines.verdicts(text, b"matching", k)
    want = [_edits(b"matching", x) <= k for x in LINES]
    assert hit.tolist() == want


@pytest.mark.parametrize("line,k,want", [
    (b"approximate", 0, True), (b"approximation", 0, True),
    (b"appromate", 0, True), (b"approximat", 0, False),
    (b"approximat", 1, True), (b"aproximat", 1, False),
    (b"aproximat", 2, True), (b"Approximate", 1, True),
    (b"apprximatin", 2, True), (b"apprximatin", 1, False),
    (b"the lazy dog", 2, False), (b"xx approxmation yy", 0, True),
])
def test_regex_with_errors(line, k, want):
    st, nl, hit = ref_lines.verdicts(_text(line + b"\n"),
                                     b"appro[a-z]*mat(e|ion)", k)
    assert bool(hit[0]) == want


def test_regex_parser_positions():
    rx = ref_approx.Regex(b"appro[a-z]*mat(e|ion)")
    assert rx.n == 14                   # the start and 13 positions
    assert not ref_approx.matches_empty(b"appro[a-z]*mat(e|ion)", 2)
    assert ref_approx.matches_empty(b"ab", 2)


def _inputs(text, spans):
    return types.SimpleNamespace(text=text, spans=spans)


def test_buffer_print_counts_lines_from_the_span():
    text = _text(b"x\nmatching\ny\nmatching z\n")
    cfg = {"pattern": "matching", "k": 0, "argv": ["-n", "matching"]}
    out = ref_lines.expected(cfg, _inputs(text, {"a": (2, 24), "b": (0, 11)}))
    assert out["a"] == (b"1: matching\n3: matching z\n", 2)
    assert out["b"] == (b"2: matching\n", 1)
    cfg["argv"] = ["matching"]
    out = ref_lines.expected(cfg, _inputs(text, {"a": (2, 24)}))
    assert out["a"] == (b"matching\nmatching z\n", 2)


def test_buffer_must_be_whole_lines():
    text = _text(b"x\nmatching\n")
    with pytest.raises(ValueError):
        ref_lines.expected({"pattern": "matching", "k": 0, "argv": []},
                           _inputs(text, {"a": (1, 11)}))
