"""Simple-pattern classification (reference checksg.c:19-165).

Decides whether a pattern can take the "sgrep" fast path (dense exact /
fragment-filter engines with the always-folding TR table) or must go
through the full mask machine (bitap class).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..options import AgrepError, Options, PROGNAME

# characters that end simplicity immediately (checksg.c:45-102)
_COMPLEX_CHARS = set(";,.*-[]()<>|#{}~")


@dataclass
class Classification:
    simple: bool          # SIMPLEPATTERN
    sgrep: bool           # fast path selected
    dna: bool             # pure acgt, length >= 16 (checksg.c:138-144)


def classify(pattern: str, opts: Options) -> Classification:
    m = len(pattern)
    if (opts.pat_file is None and opts.pat_buffer is None
            and m <= opts.D
            and not getattr(opts, "_bestmatch_rescan", False)):
        # the -B rescans never re-run checksg (agrep.c:3607 reuses the
        # stale SGREP state), so their size guard cannot fire -- a
        # regex escalated to D=5 dies on MaxRerror instead
        raise AgrepError(
            "%s: size of pattern '%s' must be > #of errors %d"
            % (PROGNAME, pattern, opts.D))

    simple = True
    not_sgrep = False
    i = 0
    while i < m:
        c = pattern[i]
        if c in _COMPLEX_CHARS:
            simple = False
            break
        if c in ("^", "$"):
            not_sgrep = True
            if opts.D > 0:
                simple = False
            break
        if c == "\\":
            i += 1  # skip escaped char
        i += 1

    if opts.constant:
        simple = True
    if not simple:
        return Classification(False, False, False)

    # conditions that keep the pattern notionally simple but bar the
    # fast path (checksg.c:127-135)
    if opts.bestmatch:
        return Classification(True, False, False)
    if opts.nocase is not None and opts.D > 0:
        return Classification(True, False, False)
    if opts.jump:
        return Classification(True, False, False)
    if opts.cost_insert == 0:
        return Classification(True, False, False)
    if opts.linenum:
        return Classification(True, False, False)
    if opts.wordbound and opts.D > 0:
        return Classification(True, False, False)
    if opts.wholeline and opts.D > 0:
        return Classification(True, False, False)
    if opts.silent:
        # "dont care output, so dont care pat" -- stays simple, sgrep off?
        # checksg.c:135 returns 1 *without* setting SGREP; replicate.
        return Classification(True, False, False)

    sgrep = (not not_sgrep) or opts.constant
    dna = m >= 16 and all(ch in "acgt" for ch in pattern)
    return Classification(True, sgrep, dna)
