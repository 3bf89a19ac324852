"""Whether the searches of a window gave the right answers: each
search's printed bytes (by their sha256) and returned count against the
plain reference's, for the input it searched."""

from __future__ import annotations

import hashlib
import os
import zlib
from collections import Counter

# The numbers compared and their limits: every search's bytes and count
# are exact, so no wrong search, no record off and no failed search.
LIMITS = {"searches_wrong": 0, "records_off": 0, "searches_failed": 0}


def records_off(got: bytes, want: bytes) -> int:
    """Lines in one output and not in the other, counted with their
    repeats."""
    a, b = Counter(got.split(b"\n")), Counter(want.split(b"\n"))
    return sum(((a - b) + (b - a)).values())


def judge(searches: list, kept: list, expected: dict, workdir: str) -> dict:
    """{name: number} of LIMITS' numbers.  searches: the window's search
    records (key, digest, count, error); kept: the clients' kept outputs
    ({key, digest, file} in workdir); expected: {key: (bytes, count)}."""
    digests = {k: hashlib.sha256(v[0]).hexdigest()
               for k, v in expected.items()}
    wrong = failed = 0
    bad = set()
    for s in searches:
        if s["error"] is not None or s["count"] is None:
            failed += 1
            continue
        want = expected.get(s["key"])
        if (want is None or s["digest"] != digests[s["key"]]
                or s["count"] != want[1]):
            wrong += 1
            bad.add((s["key"], s["digest"]))
    off = 0
    for k in kept:
        if (k["key"], k["digest"]) in bad and k["key"] in expected:
            with open(os.path.join(workdir, k["file"]), "rb") as fh:
                got = zlib.decompress(fh.read())
            off = max(off, records_off(got, expected[k["key"]][0]))
    return {"searches_wrong": wrong, "records_off": off,
            "searches_failed": failed}


def line(numbers: dict) -> str:
    return " ".join("%s=%s (limit %s)" % (k, numbers[k], LIMITS[k])
                    for k in LIMITS)


def correct(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
