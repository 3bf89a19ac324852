"""Pattern rewrite: user syntax -> internal meta-byte form.

Reproduces reference preproce.c:54-396.  The user pattern is augmented
with the record-delimiter prefix and optional -w/-x guard zones, then
every syntactic construct is rewritten to a one-byte internal metasymbol
(values from codepage; agrep.h:66-85) that the mask generator
understands.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import codepage as cp
from ..options import AgrepError, MAXDELIM, Options, PROGNAME


@dataclass
class Rewritten:
    pattern: bytes        # meta-byte pattern: delim part + ANDPAT + body
    old_d_pat: bytes      # delimiter bytes (may still hold ^/$; see bitap.c:93)
    d_length: int         # number of positions in delim part incl. ANDPAT
    regex: bool = False
    fastregex: bool = False
    r_pat: str | None = None   # regex source for the position automaton
    head: bool = False
    tail: bool = False


def default_d_pattern(opts: Options) -> str:
    """The augmented delimiter pattern "<delim>; " (agrep.c:2287-2309).

    _d_pattern_override: the -B rescan re-preprocesses with D_pattern
    already REDUCED by pass one (the processed delimiter bytes + "; ",
    agrep.c:3584-3589) -- the corrupted recompile supplies it."""
    ov = getattr(opts, "_d_pattern_override", None)
    if ov is not None:
        return ov
    if opts.delimiter is None:
        return "\n; "
    return "<" + opts.delimiter + ">; "


def rewrite(pattern: str, opts: Options) -> Rewritten:
    d_pattern = default_d_pattern(opts)

    # REGEX detection: unescaped | or * anywhere (preproce.c:139-142)
    regex = False
    i = 0
    while i < len(pattern):
        if pattern[i] == "\\":
            i += 1
        elif pattern[i] in "|*":
            regex = True
        i += 1

    # augment with guards
    temp: list[int] = [ord(c) & 0xFF for c in d_pattern]
    d_end = len(temp)
    if opts.wholeline:
        temp += [cp.LANGLE, cp.NNLINE, cp.RANGLE]
        temp += [ord(c) & 0xFF for c in pattern]
        temp += [cp.LANGLE, ord("\n"), cp.RANGLE]
    else:
        if opts.wordbound:
            temp += [cp.LANGLE, cp.WORDB, cp.RANGLE]
        temp += [ord(c) & 0xFF for c in pattern]
        if opts.wordbound:
            temp += [cp.LANGLE, cp.WORDB, cp.RANGLE]

    out: list[int] = []
    old_d: list[int] = []

    # delimiter part (preproce.c:181-210); excludes the trailing "; "
    i = 0
    while i < d_end - 2:
        c = temp[i]
        ch = chr(c)
        if ch == "\\":
            i += 1
            out.append(temp[i])
            old_d.append(temp[i])
        elif ch == "<":
            out.append(cp.LANGLE)
        elif ch == ">":
            out.append(cp.RANGLE)
        elif ch in ("^", "$"):
            out.append(ord("\n"))
            old_d.append(c)
        else:
            out.append(c)
            old_d.append(c)
        i += 1
    if len(old_d) > MAXDELIM:
        raise AgrepError("%s: delimiter pattern too long (has > %d chars)"
                         % (PROGNAME, MAXDELIM))
    out.append(cp.ANDPAT)
    d_length = len(old_d) + 1

    # main pattern part (preproce.c:238-332)
    r_pat: list[str] = []
    head = tail = False
    fastregex = False
    re_err = False
    and_on = False
    in_range = False
    if regex:
        r_pat += [".", "("]
        out.append(cp.NOCARE)
        head = True

    i = d_end
    m = len(temp)
    while i < m:
        c = temp[i]
        ch = chr(c)
        if ch == "\\":
            i += 1
            out.append(temp[i])
            r_pat.append("o")  # literal placeholder; symbol irrelevant
        elif ch == "#":
            fastregex = True
            if regex:
                out.append(cp.NOCARE)
                r_pat += [".", "*"]
            else:
                out.append(cp.WILDCD)
        elif ch == "(":
            out.append(cp.LPARENT)
            r_pat.append("(")
        elif ch == ")":
            out.append(cp.RPARENT)
            r_pat.append(")")
        elif ch == "[":
            out.append(cp.LRANGE)
            r_pat.append("[")
            in_range = True
        elif ch == "]":
            out.append(cp.RRANGE)
            r_pat.append("]")
            in_range = False
        elif ch == "<":
            out.append(cp.LANGLE)
        elif ch == ">":
            out.append(cp.RANGLE)
        elif ch == "^":
            if i > 0 and temp[i - 1] == ord("["):
                out.append(cp.NOTSYM)
            else:
                out.append(ord("\n"))
            r_pat.append("^")
        elif ch == "$":
            out.append(ord("\n"))
            r_pat.append("$")
        elif ch == ".":
            out.append(cp.NOCARE)
            r_pat.append(".")
        elif ch == "*":
            out.append(cp.STAR)
            r_pat.append("*")
        elif ch == "|":
            out.append(cp.ORSYM)
            r_pat.append("|")
        elif ch == ",":
            out.append(cp.ORPAT)
            re_err = True
        elif ch == ";":
            if and_on:
                re_err = True
            out.append(cp.ANDPAT)
            and_on = True
        elif ch == "-":
            if in_range:
                out.append(cp.HYPHEN)
                r_pat.append("-")
            else:
                out.append(c)
                r_pat.append(ch)
        else:
            out.append(c)
            r_pat.append("N" if c == cp.NNLINE else ch)
        i += 1

    if regex:
        r_pat += [")", "."]
        out.append(cp.NOCARE)
        tail = True
        if opts.delimiter is not None or opts.wordbound:
            raise AgrepError(
                "%s: -d or -w option is not supported for this pattern"
                % PROGNAME)
        if re_err:
            raise AgrepError("%s: illegal regular expression" % PROGNAME)

    return Rewritten(
        pattern=bytes(out),
        old_d_pat=bytes(old_d),
        d_length=d_length,
        regex=regex,
        fastregex=fastregex,
        r_pat="".join(r_pat) if regex else None,
        head=head,
        tail=tail,
    )


def delimiter_bytes(rw: Rewritten) -> bytes:
    """The actual delimiter byte string used for record scanning.

    bitap.c:93 converts remaining ^/$ to newline before scanning.
    """
    return bytes(ord("\n") if b in (ord("^"), ord("$")) else b
                 for b in rw.old_d_pat)
