"""Expected output of an approximate search of newline records in
in-memory buffers, as agrep 3.41's memagrep prints it
(Query.search_buffer: each buffer starts with a newline, which `-n`
does not count as a line; `-n` puts "N: " before each record; no
total line).

Every line of the text is judged once (ref_approx.line_matches); each
buffer is a span of whole lines of the text, so its answer is read off
the same verdicts.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ref_approx  # noqa: E402


def verdicts(text: np.ndarray, pattern: bytes, k: int):
    """(line starts, newline positions, a verdict a line) of a text
    that ends in a newline."""
    nl = np.flatnonzero(text == 0x0A)
    if len(text) and text[-1] != 0x0A:
        raise ValueError("the text must end in a newline")
    st = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
    return st, nl, ref_approx.line_matches(text, st, nl - st, pattern, k)


def _print(text, st, nl, rows, linenum: bool, first_ordinal: int) -> bytes:
    out = []
    for i in rows:
        if linenum:
            out.append(b"%d: " % (i + first_ordinal))
        out.append(text[st[i]:nl[i] + 1].tobytes())
    return b"".join(out)


def expected(config: dict, inputs) -> dict:
    """{key: (output bytes, returned count)} of every distinct input."""
    pattern = config["pattern"].encode("latin-1")
    linenum = "-n" in config["argv"]
    st, nl, hit = verdicts(inputs.text, pattern, config["k"])
    if ref_approx.matches_empty(pattern, config["k"]):
        raise ValueError("a pattern that matches the empty line")
    out = {}
    for key, (s, e) in inputs.spans.items():
        i0, i1 = np.searchsorted(st, [s, e])
        if st[i0] != s or (i1 < len(st) and st[i1] != e) or nl[i1 - 1] + 1 != e:
            raise ValueError("buffer %s is not whole lines" % key)
        rows = i0 + np.flatnonzero(hit[i0:i1])
        # the buffer's own line numbers: its leading newline opens no
        # line of its own, so the span's first line is line 1
        out[key] = (_print(inputs.text, st, nl, rows, linenum, 1 - i0),
                    len(rows))
    return out
