"""CompiledQuery: the immutable compiled form of one search.

Replaces the reference's global-variable soup (agrep.c:107-220) with an
explicit object; engine selection follows the dispatch tree in
SURVEY.md section 2.2 (agrep_search:3168-3194, bitap:96-121,
sgrep PROCESS_PATTERN:311-320).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import codepage as cp
from ..options import AgrepError, Options, PROGNAME
from ..ops import bitword
from . import boolean, classify, masks, pattern as patmod


@dataclass
class CompiledQuery:
    opts: Options
    pattern: str
    engine_class: str              # 'sgrep' | 'bitap' | 'mgrep' | 'regex'
    D: int
    lut: np.ndarray                # scan LUT (identity if no -i)

    # record delimiter
    delim: bytes = b"\n"
    delimiter_opt: bool = False    # -d given
    outtail: bool = False

    # bitap class
    tables: object = None          # masks.MaskTables
    folded_mask: np.ndarray | None = None
    consts: dict | None = None
    part_bits: list = field(default_factory=list)
    and_flag: bool = False
    costs: tuple | None = None     # (I, S, DD) when JUMP

    # sgrep class
    sg_pattern: bytes = b""        # escape-stripped pattern bytes
    sg_mask: np.ndarray | None = None
    sg_consts: dict | None = None
    sg_m: int = 0
    sg_sub: str = "bm"             # bm|monkey|agrep|a_monkey|monkey4

    # mgrep class
    terminals: list = field(default_factory=list)
    bool_tree: object = None
    bool_op: str = "or"


def _strip_escapes(p: str) -> bytes:
    """PROCESS_PATTERN escape interpretation (sgrep.c:295-300)."""
    out = bytearray()
    i = 0
    while i < len(p):
        if p[i] == "\\":
            i += 1
            if i < len(p):
                out.append(ord(p[i]) & 0xFF)
                i += 1
        else:
            out.append(ord(p[i]) & 0xFF)
            i += 1
    return bytes(out)


def compile_query(pattern: str | None, opts: Options) -> CompiledQuery:
    lut = cp.build_lut(cp.resolve_codepage(opts.codepage),
                       opts.nocase)

    # multi-pattern file/buffer searches
    if opts.pat_file is not None or opts.pat_buffer is not None:
        return _compile_multi(pattern, opts, lut)

    assert pattern is not None
    cls = classify.classify(pattern, opts)

    if cls.sgrep:
        return _compile_sgrep(pattern, opts, lut, cls)

    # boolean split (preproce.c:86-133): a;b / a,b and {..}~ expressions
    # become the multi-pattern engine -- but only when D == 0 and no
    # fast-path-blocking option is set (checksg with set=0, asplit.c:384)
    if _boolean_split_allowed(opts):
        split = boolean.split_pattern(pattern)
        if split is not None and (split.complex
                                  or len(split.terminals) >= 2):
            q = CompiledQuery(
                opts=opts, pattern=pattern, engine_class="mgrep",
                D=opts.D, lut=lut, terminals=split.terminals,
                bool_tree=split.tree, bool_op=split.op)
            _setup_delim_for_multi(q, opts)
            return q

    return _compile_bitap(pattern, opts, lut)


def _boolean_split_allowed(opts: Options) -> bool:
    """asplit_terminal runs checksg(term, D, 0) which rejects the split
    whenever D > 0 or any of the fast-path-blocking flags is set
    (checksg.c:127-134 with set==0)."""
    if opts.D > 0:
        return False
    if opts.bestmatch or opts.jump or opts.cost_insert == 0:
        return False
    if opts.linenum:
        return False
    # SILENT does NOT bar the split: checksg's `if (SILENT) return 1`
    # (checksg.c:135) sits after the blocking-flag rejections, so a
    # silent term still splits ("dont care output, so dont care pat")
    return True


def _setup_delim_for_multi(q: CompiledQuery, opts: Options) -> None:
    if opts.delimiter is not None:
        q.delimiter_opt = True
        q.delim = _preprocess_delimiter(opts.delimiter)
        q.outtail = opts.outtail
    else:
        q.delim = b"\n"
        q.outtail = opts.outtail


def _preprocess_delimiter(src: str) -> bytes:
    """delim.c preprocess_delimiter:8-28 (^ and $ become newline)."""
    out = bytearray()
    i = 0
    while i < len(src):
        c = src[i]
        if c == "\\":
            i += 1
            if i < len(src):
                out.append(ord(src[i]) & 0xFF)
                # reference quirk: the backslash branch has no `else`,
                # so the SAME char falls into the ^/$/else chain and is
                # written AGAIN (delim.c:17-24): `\^` -> "^\n",
                # `\n` -> "nn", `\x` -> "xx"
                if src[i] in "^$":
                    out.append(ord("\n"))
                else:
                    out.append(ord(src[i]) & 0xFF)
        elif c in "^$":
            out.append(ord("\n"))
        else:
            out.append(ord(c) & 0xFF)
        i += 1
    return bytes(out)


def _compile_sgrep(pattern: str, opts: Options, lut, cls) -> CompiledQuery:
    p = pattern
    if not opts.constant:
        # leading/trailing anchors become newline chars (sgrep.c:291-292)
        if p and p[0] in "^$":
            p = "\n" + p[1:]
        if len(p) > 1 and p[-1] in "^$" and p[-2] != "\\":
            p = p[:-1] + "\n"
    sg = _strip_escapes(p)
    if opts.wholeline:
        sg = b"\n" + sg + b"\n"
    m = len(sg)

    # mask with the always-folding TR for D == 0 (char_tr, sgrep.c:226),
    # raw bytes for D > 0 (initmask folds nothing)
    if opts.D == 0:
        tr = cp.build_tr()
        mask_arr = np.zeros(256, dtype=np.uint32)
        sgf = bytes(tr[np.frombuffer(sg, dtype=np.uint8)])
        base = bitword.sgrep_mask(sgf)
        for c in range(256):
            mask_arr[c] = base[tr[c]]
    else:
        mask_arr = np.asarray(bitword.sgrep_mask(sg), dtype=np.uint32)

    consts = {"endpos": (0x80000000 >> (m - 1)) & 0xFFFFFFFF, "m": m}
    # sub-engine selection (sgrep.c PROCESS_PATTERN:311-320)
    if opts.D == 0:
        sub = "monkey" if m > 20 else "bm"
    elif cls.dna:
        sub = "monkey4"
    elif m >= 24:
        sub = "a_monkey"
    else:
        sub = "agrep"
    q = CompiledQuery(
        opts=opts, pattern=pattern, engine_class="sgrep", D=opts.D,
        lut=lut, sg_pattern=sg, sg_mask=mask_arr, sg_consts=consts, sg_m=m)
    q.sg_sub = sub
    if opts.delimiter is not None:
        q.delimiter_opt = True
        q.delim = _preprocess_delimiter(opts.delimiter)
    q.outtail = opts.outtail
    return q


def _compile_bitap(pattern: str, opts: Options, lut) -> CompiledQuery:
    rw = patmod.rewrite(pattern, opts)
    if rw.regex:
        return _compile_regex(pattern, rw, opts, lut)
    t = masks.maskgen(rw.pattern, opts.D, rw.d_length,
                      nocase=opts.nocase is not None, regex=False)
    consts = bitword.machine_constants(t, opts.D)
    folded = masks.fold_mask_with_lut(t, lut)
    part_bits = _decompose_bits(t.endposition)
    costs = None
    if opts.jump:
        D1 = opts.D + 1
        costs = (min(opts.cost_insert, D1), min(opts.cost_subst, D1),
                 min(opts.cost_delete, D1))
    q = CompiledQuery(
        opts=opts, pattern=pattern, engine_class="bitap", D=opts.D,
        lut=lut, tables=t, folded_mask=folded, consts=consts,
        part_bits=part_bits, and_flag=t.and_flag, costs=costs,
        delim=patmod.delimiter_bytes(rw),
        delimiter_opt=opts.delimiter is not None,
        outtail=opts.outtail)
    return q


def _compile_regex(pattern, rw, opts, lut) -> CompiledQuery:
    from . import regex as remod
    from ..ops import renfa

    if opts.D > 4:
        # bitap.c:97-104 (typo preserved); the check fires inside the
        # engine, so exec still prints the Grand Total (late error)
        raise AgrepError(
            "%s: the maximum number of erorrs allowed for full regular "
            "expressions is 4" % PROGNAME, late=True,
            verbose=opts.verbose)
    # maskgen runs on the meta pattern trimmed to the head NOCARE
    # (preproce.c:366); the delimiter part is excluded for regex.
    meta = rw.pattern
    idx = meta.index(bytes([cp.NOCARE]))
    trimmed = meta[idx:]
    t = masks.maskgen(trimmed, opts.D, d_length=rw.d_length,
                      nocase=opts.nocase is not None, regex=True)
    # bit base uses maskgen's M even when it disagrees with the parser
    # (a '?' in the pattern -- see build_automaton's m_override note)
    auto = remod.build_automaton(rw.r_pat, m_override=t.m)
    # re/re1 never apply the codepage LUT to text (agrep.c:528,804);
    # case folding happens only through maskgen's ASCII mask-row fold.
    mc = renfa.machine_from_automaton(
        auto, t.mask, t.no_err_mask, opts.D, head_on=rw.head,
        tail_on=rw.tail)
    q = CompiledQuery(
        opts=opts, pattern=pattern, engine_class="regex", D=opts.D,
        lut=lut, tables=t)
    q.re_mc = mc
    q.re_auto = auto
    return q


def _compile_multi(pattern, opts, lut) -> CompiledQuery:
    from . import multi as multi_mod

    cap = (multi_mod.MAXPATFILE + 2 * multi_mod.MAX_NUM) // 2

    def _file_err(first_line: str):
        # prepf failure flow (newmgrep.c:215-232 + agrep.c:2855-2862):
        # prepf's own stderr line, then agrep_init's trailer naming the
        # first remaining argv entry (the first input file, or the
        # pattern file itself when no files follow)
        hint = getattr(opts, "pat_errfile_hint", None) or opts.pat_file
        raise AgrepError("%s\n%s: error in processing pattern file: %s"
                         % (first_line, PROGNAME, hint))

    if opts.pat_file is not None:
        import os
        import stat as statmod
        try:
            st = os.stat(opts.pat_file)
        except OSError:
            _file_err("%s: cannot stat file: %s"
                      % (PROGNAME, opts.pat_file))
        if not statmod.S_ISREG(st.st_mode):
            _file_err("%s: pattern file not regular file: %s"
                      % (PROGNAME, opts.pat_file))
        if st.st_size * 2 > multi_mod.MAXPATFILE + 2 * multi_mod.MAX_NUM:
            _file_err("%s: pattern file too large (> %d B): %s"
                      % (PROGNAME, cap, opts.pat_file))
        with open(opts.pat_file, "rb") as f:
            raw = f.read()
        segs = raw.split(b"\n")
        if not segs[-1]:
            segs = segs[:-1]   # prepf appends the final '\n' itself
        # interior empty lines DO consume pattern slots (observable in
        # -P indices; prepf's split loop, newmgrep.c:276-281)
        terms = [t.decode("latin-1") for t in segs]
        if len(terms) + 1 > multi_mod.MAX_NUM:
            # newmgrep.c:284-293 as WRITTEN; the compiled reference
            # UB-optimizes this check away (gcc deduces p < max_num
            # from the patt[p] OOB write) and corrupts memory past
            # 40,000 patterns -- we keep the intended diagnostic
            # (documented divergence, docs/CONFORMANCE.md)
            _file_err("%s: maximum number of patterns is %d"
                      % (PROGNAME, multi_mod.MAX_NUM))
    else:
        braw = opts.pat_buffer.encode("latin-1")
        if len(braw) * 2 > multi_mod.MAXPATFILE + 2 * multi_mod.MAX_NUM:
            raise AgrepError(
                "%s: pattern buffer too large (> %d B)\n"
                "%s: error in processing pattern buffer"
                % (PROGNAME, cap, PROGNAME))
        segs = braw.split(b"\n")
        if segs and not segs[-1]:
            segs = segs[:-1]
        terms = [t.decode("latin-1") for t in segs]
        if len(terms) + 1 > multi_mod.MAX_NUM:
            raise AgrepError(
                "%s: maximum number of patterns is %d\n"
                "%s: error in processing pattern buffer"
                % (PROGNAME, multi_mod.MAX_NUM, PROGNAME))
    q = CompiledQuery(
        opts=opts, pattern=pattern or "", engine_class="mgrep", D=opts.D,
        lut=lut, terminals=terms, bool_tree=None, bool_op="or")
    _setup_delim_for_multi(q, opts)
    if q.delimiter_opt and _sgrep_off_for_empty(opts):
        # With -f/-m the pattern is empty and preprocess() returns
        # before touching the delimiter (preproce.c:68-70); the
        # conversion then only happens on agrep_search's SGREP branch
        # (agrep.c:3182-3189).  Any checksg condition that keeps SGREP
        # off -- JUMP costs, SILENT (returns 1 *without* setting
        # SGREP, checksg.c:135), zero insert cost, best-match, or
        # errors with -i/-w/-x -- leaves D_pattern as the RAW
        # "<PAT>; " buffer with D_length = 1 + len(PAT): the
        # effective record delimiter is '<' plus the undecoded
        # user text.
        q.delim = b"<" + opts.delimiter.encode("latin-1")
    return q


def _sgrep_off_for_empty(opts: Options) -> bool:
    """checksg('', D, 1) leaves SGREP off (so the -f/-m delimiter
    stays raw) for these flags -- checksg.c:127-141."""
    if opts.jump or opts.cost_insert == 0 or opts.bestmatch:
        return True
    if opts.silent or opts.linenum:
        # -n survives as a flag under -c (only its output is
        # "ignored"), and checksg's LINENUM check still bars SGREP
        return True
    if opts.D > 0 and (opts.nocase is not None or opts.wordbound
                       or opts.wholeline):
        return True
    return False


def _decompose_bits(word: int) -> list[int]:
    out = []
    b = 1
    while b <= 0xFFFFFFFF:
        if word & b:
            out.append(b)
        b <<= 1
    return out
